"""The port's model zoo, part 2c, HRNet (vitcap_tpu_torch/models/
hrnet.py), vs the JAX package's on the CPU: f32 forwards at real channel
widths on 64-px seeded images (B=2), the feature map and the logits,
within 1e-4, one case a distinct block path; the zoo_params_from_jax key
set and a torch state-dict load; and every registered name's spec, field
by field, built and run by create_model.

The port's seeded weights (norms, running statistics and biases redrawn
from a seed, then each BN's running statistics calibrated on four other
seeded images, as in test_torch_zoo_2b_res.py) reach the JAX tree through
the JAX package's own load_*_checkpoint on a skeleton of its init traced
by jax.eval_shape.  Deep cases are cut by patching, alike in both
packages, a module table the JAX code reads at call time.  The helpers
serve the other test_torch_zoo_2c_*.py files.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2c_hrnet.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import hrnet as JH
from vitcap_tpu.models import registry as JR

from vitcap_tpu_torch.models import hrnet as TH
from vitcap_tpu_torch.models import registry as TR
from vitcap_tpu_torch.models.backbones import apply_backbone

from test_torch_zoo_2b_res import cut_blocks, state_keys
from test_torch_zoo_effnet import (  # noqa: F401 (one_torch_thread: autouse)
    CONV_TOL, _np_tree, check_spec_and_build, family_names, imgs,
    jax_spec, one_torch_thread, perturb_)

# spec class name -> the JAX registry's family word (init_<w>_params,
# <w>_forward, load_<w>_checkpoint)
FAMILY = {"HrNetModelSpec": "hrnet", "InceptionV3ModelSpec": "inception_v3",
          "InceptionV4ModelSpec": "inception_v4",
          "InceptionResnetV2ModelSpec": "inception_resnet_v2",
          "XceptionModelSpec": "xception",
          "XcepAlignedModelSpec": "xception_aligned",
          "GluonXceptionModelSpec": "gluon_xception",
          "NASNetModelSpec": "nasnet", "PNASNetModelSpec": "pnasnet"}


def family(spec) -> str:
    return FAMILY[type(spec).__name__]


@torch.no_grad()
def seeded_model(spec, size, seed=2, calibrate=True):
    """The port model of spec, perturbed; calibrated: each BatchNorm's
    running statistics set to its batch statistics on 4 seeded `size`-px
    images (one train-mode forward at momentum 1), the variance plus
    one."""
    model = perturb_(TR.init_pooled_cnn_params(
        spec, torch.Generator().manual_seed(seed), "cpu"))
    if not calibrate:
        return model
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    moms = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    model.train()
    apply_backbone(model, torch.from_numpy(imgs(size, seed=9, n=4)))
    model.eval()
    for m, mom in zip(bns, moms):
        m.momentum = mom
        m.running_var.add_(1.0)
    return model


def jax_load(spec, path):
    """The JAX tree of a torch state-dict file, by the JAX package's own
    load_*_checkpoint, on the skeleton of its init (jax.eval_shape)."""
    jspec = jax_spec(spec)
    init = getattr(JR, f"init_{family(spec)}_params")
    skel = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jspec))
    return getattr(JR, f"load_{family(spec)}_checkpoint")(skel, path, jspec)


def port_and_jax(name, tmp_path, size, seed=2, calibrate=True, **over):
    """The port model of `name` (seeded, perturbed, calibrated) and the
    JAX tree that holds its values; its zoo_params_from_jax key set is the
    model's."""
    spec = TR.model_spec(name, **over)
    model = seeded_model(spec, size, seed, calibrate)
    path = str(tmp_path / f"{name}.pth")
    torch.save(model.state_dict(), path)
    jp = jax_load(spec, path)
    assert TR.zoo_params_from_jax(_np_tree(jp), spec).keys() == \
        state_keys(model)
    return spec, model, jp


def check_forward(name, tmp_path, size=64):
    """The feature map and the logits of both packages on the same seeded
    `size`-px images, within CONV_TOL."""
    x = imgs(size)
    spec, model, jp = port_and_jax(name, tmp_path, size, num_classes=10)
    jspec = jax_spec(spec)
    fwd = getattr(JR, f"{family(spec)}_forward")
    want = jax.jit(lambda p, a: [fwd(p, a, jspec, head=h)
                                 for h in (False, True)])(jp, jnp.asarray(x))
    with torch.no_grad():
        got = [TR.pooled_cnn_forward(model, torch.from_numpy(x), spec,
                                     head=h) for h in (False, True)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(w).max() > 1e-2         # a signal, not vanishing
        np.testing.assert_allclose(g.numpy(), w, **CONV_TOL)


def loaded_equal(tmp_path, name):
    """A state-dict file of `name`'s port model (every value redrawn)
    through create_model(checkpoint_path=...) and the JAX package's loader:
    equal parameter for parameter."""
    spec = TR.model_spec(name, num_classes=10)
    src = TR.create_model(name, device="cpu", num_classes=10).params
    g = torch.Generator().manual_seed(11)
    sd = {}
    for k, v in src.state_dict().items():
        if v.is_floating_point():
            v = torch.randn(v.shape, generator=g) * 0.1 + (
                1.0 if "running_var" in k else 0.0)
            v = v.abs() if "running_var" in k else v
        sd[k] = v
    path = str(tmp_path / f"{name}.pth")
    torch.save(sd, path)
    m = TR.create_model(name, checkpoint_path=path, device="cpu",
                        num_classes=10)
    want = TR.zoo_params_from_jax(_np_tree(jax_load(spec, path)), spec)
    got = m.params.state_dict()
    assert set(want) == state_keys(m.params)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy(),
                                      err_msg=k)


def cut_hrnet(monkeypatch, name):
    """hrnet_w64 with 2 layer1 blocks, (1, 2, 1) modules and 2 blocks a
    branch: every fuse path and a module feeding a module."""
    if name == "hrnet_w64":
        cut_blocks(monkeypatch, (JH, TH), "HRNETS", name,
                   lambda c: (2, c[1], (1, 2, 1), 2, c[4]))


# (name, what it covers)
FORWARD_CASES = [
    ("hrnet_w18_small", "one module a stage, one layer1 bottleneck that "
                        "widens 64 -> 128"),
    ("hrnet_w18_small_v2", "several modules a stage, basic blocks, the "
                           "upsample and stride-2 fuse chains"),
    ("hrnet_w64", "the widest branches (cut: 2 layer1 blocks, (1, 2, 1) "
                  "modules, 2 blocks a branch)"),
]


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, monkeypatch, name):
    cut_hrnet(monkeypatch, name)
    check_forward(name, tmp_path)


@pytest.mark.parametrize("name", ["hrnet_w18_small_v2"])
def test_torch_checkpoint_load_matches_jax(tmp_path, name):
    """timm's names (transition{t}.{i}[.{j}].{0,1}, the fuse_layers mesh,
    incre / downsamp modules with their conv biases, classifier) load into
    equal parameters through both packages' loaders."""
    loaded_equal(tmp_path, name)


def test_upsample_repeats_every_pixel():
    """The fuse mesh's nearest upsample is jnp.repeat on both axes."""
    x = torch.arange(2 * 3 * 2 * 3, dtype=torch.float32).view(2, 3, 2, 3)
    want = np.repeat(np.repeat(x.numpy(), 4, axis=2), 4, axis=3)
    np.testing.assert_array_equal(TH._upsample_nearest(x, 4).numpy(), want)


@pytest.mark.parametrize("name", family_names(("HrNetModelSpec",)))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name)
