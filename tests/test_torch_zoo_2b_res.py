"""The port's model zoo, part 2b, its ResNet-like families (legacy SENet,
SKNet, ResNeSt, TResNet and SelecSLS: vitcap_tpu_torch/models/senet.py,
sknet.py, resnest.py, tresnet.py, selecsls.py), vs the JAX package's on
the CPU: f32 forwards at real channel widths on 64-px seeded images
(B=2), the feature map and the logits, within 1e-4, one case a distinct
block path; each family's zoo_params_from_jax key set and a torch
state-dict load; and every registered name's spec, field by field, built
and run by create_model.

The port's seeded weights (norms, running statistics and biases redrawn
from a seed; then each BN's running mean set to its batch mean on four
other seeded images and its running variance to their batch variance
plus one, so that deep concatenating nets keep activations of order one
and no channel divides by a vanishing variance) reach the JAX tree through the JAX package's own load_*_checkpoint,
on a skeleton of its init traced by jax.eval_shape.  The helpers serve
test_torch_zoo_2b_agg.py and test_torch_zoo_2b_train.py too.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_2b_res.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import registry as JR
from vitcap_tpu.models import senet as JSE

from vitcap_tpu_torch.models import registry as TR
from vitcap_tpu_torch.models import senet as TSE
from vitcap_tpu_torch.models.backbones import apply_backbone
from vitcap_tpu_torch.models.vovnet import EvoNormS0

from test_torch_zoo_effnet import (  # noqa: F401 (one_torch_thread: autouse)
    CONV_TOL, _np_tree, check_spec_and_build, family_names, imgs,
    jax_spec, one_torch_thread, perturb_)

# spec class name -> the JAX registry's family word (init_<w>_params,
# <w>_forward, load_<w>_checkpoint)
FAMILY = {"SelecSlsModelSpec": "selecsls", "SeNetModelSpec": "senet",
          "SkNetModelSpec": "sknet", "ResNestModelSpec": "resnest",
          "TResNetModelSpec": "tresnet", "CspNetModelSpec": "cspnet",
          "DpnModelSpec": "dpn", "DenseNetModelSpec": "densenet",
          "DlaModelSpec": "dla", "VovNetModelSpec": "vovnet"}


def family(spec) -> str:
    return FAMILY[type(spec).__name__]


@torch.no_grad()
def calibrate_(model, size=64) -> None:
    """Every BatchNorm's running statistics set to its batch statistics on
    4 seeded images (one train-mode forward at momentum 1), the variance
    plus one."""
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


@torch.no_grad()
def seeded_model(spec, seed=2, calibrate=True):
    """The port model of spec, perturbed (EvoNorm's weight and v too) and
    calibrated."""
    model = perturb_(TR.init_pooled_cnn_params(
        spec, torch.Generator().manual_seed(seed), "cpu"))
    g = torch.Generator().manual_seed(seed + 7)
    for m in model.modules():
        if isinstance(m, EvoNormS0):
            for t in (m.weight, m.v):
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
    if calibrate:
        calibrate_(model)
    return model


def jax_load(spec, path):
    """The JAX tree of a torch state-dict file, by the JAX package's own
    load_*_checkpoint, on the skeleton of its init (jax.eval_shape)."""
    jspec = jax_spec(spec)
    init = getattr(JR, f"init_{family(spec)}_params")
    skel = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jspec))
    return getattr(JR, f"load_{family(spec)}_checkpoint")(skel, path, jspec)


def state_keys(model):
    return {k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")}


def port_and_jax(name, tmp_path, seed=2, **over):
    """The port model of `name` (seeded, perturbed, calibrated) and the
    JAX tree that holds its values; its zoo_params_from_jax key set is the
    model's."""
    spec = TR.model_spec(name, **over)
    model = seeded_model(spec, seed)
    path = str(tmp_path / f"{name}.pth")
    torch.save(model.state_dict(), path)
    jp = jax_load(spec, path)
    assert TR.zoo_params_from_jax(_np_tree(jp), spec).keys() == \
        state_keys(model)
    return spec, model, jp


def check_forward(name, tmp_path):
    """The feature map and the logits of both packages on the same seeded
    images, within CONV_TOL."""
    x = imgs(64)
    spec, model, jp = port_and_jax(name, tmp_path, num_classes=10)
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
    through both packages' loaders: equal parameter for parameter."""
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


def cut_blocks(monkeypatch, mods, table, name, cut):
    """Both packages' config tables cut alike (fewer blocks a stage)."""
    for mod in mods:
        t = getattr(mod, table)
        monkeypatch.setitem(t, name, cut(t[name]))


FAMILIES = ("SelecSlsModelSpec", "SeNetModelSpec", "SkNetModelSpec",
            "ResNestModelSpec", "TResNetModelSpec")

# (name, what it covers)
FORWARD_CASES = [
    ("selecsls42b", "SelecSLS blocks, the stage skip, the head convs"),
    ("legacy_seresnet18", "basic blocks, relu before the SE"),
    ("legacy_seresnet50", "res bottleneck, the stride on conv1"),
    ("legacy_seresnext26_32x4d", "next: grouped conv2 with the stride"),
    ("legacy_senet154", "se154: 3x3 x 3 stem, 3x3 downsample, "
                        "cardinality 64 (1-2 blocks a layer)"),
    ("skresnet18", "SK basic: split input, dilated path, pooled BN"),
    ("skresnet50d", "SK bottleneck, deep stem, avg-pool downsample"),
    ("skresnext50_32x4d", "SK grouped, the whole input on both paths"),
    ("resnest14d", "radix 2, avd after the split conv"),
    ("resnest50d_4s2x40d", "radix 4 x cardinality 2, avd first"),
    ("resnest50d_1s4x24d", "radix 1: the sigmoid gate, cardinality 4"),
    ("tresnet_m", "space-to-depth, IABN slopes, blur pool, SE"),
    ("tresnet_l_448", "width 1.2, the _448 name"),
]


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, monkeypatch, name):
    if name == "legacy_senet154":
        cut_blocks(monkeypatch, (JSE, TSE), "SENETS", name,
                   lambda c: c[:1] + ((1, 2, 2, 1),) + c[2:])
    check_forward(name, tmp_path)


@pytest.mark.parametrize("name", ["selecsls60b", "legacy_senet154",
                                  "skresnext50_32x4d", "resnest50d_4s2x40d",
                                  "tresnet_m"])
def test_torch_checkpoint_load_matches_jax(tmp_path, monkeypatch, name):
    """timm's names (features.{i}.conv{j}.{0,1}, layer0 and se_module,
    paths / attn, conv2.fc1 as a grouped conv, body.layerN with the
    anti-aliased convs' extra level) load into equal parameters through
    both packages' loaders."""
    if name == "legacy_senet154":
        cut_blocks(monkeypatch, (JSE, TSE), "SENETS", name,
                   lambda c: c[:1] + ((1, 2, 2, 1),) + c[2:])
    loaded_equal(tmp_path, name)


@pytest.mark.parametrize("name", family_names(FAMILIES))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name)
