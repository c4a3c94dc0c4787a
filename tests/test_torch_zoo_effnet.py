"""The port's model zoo, part 2a, the EfficientNet builder's families
(vitcap_tpu_torch/models/efficientnet.py, mobilenetv3.py, mixnet.py,
rexnet.py), vs the JAX package's on the CPU: f32 forwards at real channel
widths on 64-px seeded images (B=2), the feature map and the head, within
1e-4; each family's zoo_params_from_jax key set and a torch state-dict
load; and every registered name's spec, field by field, built and run by
create_model.  The port's seeded weights (norms, running statistics and
biases redrawn from a seed) reach the JAX tree through the JAX package's
own torch loaders, since tracing its zoo init op by op takes minutes.
RegNet, NFNet and BiT are in test_torch_zoo_nets.py.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_effnet.py -q
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from vitcap_tpu.models import registry as JR

from vitcap_tpu_torch.models import registry as TR

CONV_TOL = dict(rtol=0, atol=1e-4)   # f32 convs: another summation order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's large models run: the
    suite runs several workers on the machine's cores, where torch's
    thread pool would wait on its own oversubscribed threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FAMILIES = ("EffNetModelSpec", "Mn3ModelSpec", "MixNetModelSpec",
            "RexNetModelSpec")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def imgs(size=64, seed=4, n=2):
    return np.random.RandomState(seed).randn(n, size, size,
                                             3).astype(np.float32)


@torch.no_grad()
def perturb_(model: nn.Module, seed: int = 3) -> nn.Module:
    """Redraw every norm's affine and running statistics, every bias and
    NFNet gain from a seed (the convolutions keep their init): no
    identity norm or zero-initialised branch hides a fault."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        norm = isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm))
        for name, t in [*mod.named_parameters(recurse=False),
                        *mod.named_buffers(recurse=False)]:
            if not t.is_floating_point():
                continue
            r = torch.randn(t.shape, generator=g)
            if name == "running_var":
                t.copy_(1.0 + 0.2 * r.abs())
            elif name == "running_mean" or name == "bias":
                t.copy_(0.1 * r)
            elif name == "gain" or (norm and name == "weight"):
                t.copy_(1.0 + 0.1 * r)
    return model


def jax_spec(spec):
    return getattr(JR, type(spec).__name__)(**dataclasses.asdict(spec))


def skeleton(model) -> dict:
    """The part of the JAX tree its torch loaders read: ReXNet's expand
    convs and SE, NFNet's projections and final conv, whether there is a
    head."""
    bb = {}
    if isinstance(model, TR.ReXNet):
        bb["blocks"] = [{k: 0 for k in ("conv_exp", "se") if hasattr(m, k)}
                        for m in model.features[:-1]]
    if isinstance(model, TR.NfNet):
        bb["stages"] = [[{"down_conv": 0} if hasattr(m, "downsample")
                         else {} for m in st] for st in model.stages]
        if hasattr(model, "final_conv"):
            bb["final_conv"] = 0
    tree = {"backbone": bb}
    if model.num_features and any(hasattr(model, h) for h in
                                  ("classifier", "head")):
        tree["head"] = 0
    return tree


def jax_load(model, spec, path):
    """The JAX tree of a torch state-dict file, by the JAX package's own
    load_*_checkpoint for the spec's family."""
    load = {"EffNetModelSpec": JR.load_effnet_checkpoint,
            "Mn3ModelSpec": JR.load_mn3_checkpoint,
            "MixNetModelSpec": JR.load_mixnet_checkpoint,
            "RexNetModelSpec": JR.load_rexnet_checkpoint,
            "RegNetModelSpec": JR.load_regnet_checkpoint,
            "NfNetModelSpec": JR.load_nfnet_checkpoint,
            "ResNetV2ModelSpec": JR.load_resnetv2_checkpoint,
            }[type(spec).__name__]
    return load(skeleton(model), path, jax_spec(spec))


def port_and_jax(name, tmp_path, seed=2, n_stages=0, **over):
    """The port model of `name` (seeded, perturbed) and the JAX tree that
    holds its values; its zoo_params_from_jax key set is the model's."""
    spec = TR.model_spec(name, **over)
    model = perturb_(TR.init_pooled_cnn_params(
        spec, torch.Generator().manual_seed(seed), "cpu", n_stages))
    path = str(tmp_path / f"{name}.pth")
    torch.save(model.state_dict(), path)
    jp = jax_load(model, spec, path)
    assert TR.zoo_params_from_jax(_np_tree(jp), spec).keys() == {
        k for k in model.state_dict()
        if not k.endswith("num_batches_tracked")}
    return spec, model, jp


def check_forward(spec, model, jp, size=64):
    """The feature map and (with a head) the logits of both packages on
    the same seeded images, within CONV_TOL."""
    jspec = jax_spec(spec)
    fwd = getattr(JR, {"EffNetModelSpec": "effnet_forward",
                       "Mn3ModelSpec": "mn3_forward",
                       "MixNetModelSpec": "mixnet_forward",
                       "RexNetModelSpec": "rexnet_forward",
                       "RegNetModelSpec": "regnet_forward",
                       "NfNetModelSpec": "nfnet_forward",
                       "ResNetV2ModelSpec": "resnetv2_forward",
                       }[type(spec).__name__])
    x = imgs(size)
    heads = (False, True) if spec.num_classes else (False,)
    want = jax.jit(lambda p, a: [fwd(p, a, jspec, head=h) for h in heads])(
        jp, jnp.asarray(x))
    with torch.no_grad():
        got = [TR.pooled_cnn_forward(model, torch.from_numpy(x), spec,
                                     head=h) for h in heads]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(w).max() > 1e-2         # a signal, not vanishing
        np.testing.assert_allclose(g.numpy(), w, **CONV_TOL)


# (name, what it covers)
FORWARD_CASES = [
    ("efficientnet_b0", "ds + ir blocks, SE, swish"),
    ("efficientnet_lite0", "relu6, no SE, the pinned first and last stage"),
    ("efficientnet_cc_b0_4e", "CondConv: routing, mixed 1x1 and dw"),
    ("efficientnet_es", "EdgeResidual blocks (EdgeTPU)"),
    ("efficientnet_b1_pruned", "the pruned widths, the parent's skips"),
    ("tf_efficientnet_b0", "TF-'SAME' padding, BN eps 1e-3"),
    ("fbnetc_100", "several entries a stage, expansion-1 ir"),
    ("mobilenetv3_large_100", "hard_swish, gated SE, cn stage, head"),
    ("mobilenetv3_small_075", "a strided ds with SE, width 0.75"),
    ("mobilenetv3_rw", "SE divisor 1, block-act SE, no head bias"),
    ("mixnet_s", "mixed dw / pw convs over channel chunks"),
    ("tf_mixnet_s", "mixed convs each padded TF-'SAME'"),
    ("rexnet_100", "SE with BN, partial residual"),
]


@pytest.mark.parametrize("name", [c[0] for c in FORWARD_CASES])
def test_forward_matches_jax(tmp_path, name):
    spec, model, jp = port_and_jax(name, tmp_path, num_classes=10)
    check_forward(spec, model, jp)


def loaded_equal(tmp_path, name, **over):
    """A state-dict file of `name`'s port model (every value redrawn)
    through both packages' loaders: equal parameter for parameter."""
    spec = TR.model_spec(name, **over)
    src = TR.create_model(name, device="cpu", **over).params
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
    m = TR.create_model(name, checkpoint_path=path, device="cpu", **over)
    want = TR.zoo_params_from_jax(_np_tree(jax_load(m.params, spec, path)),
                                  spec)
    got = m.params.state_dict()
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["efficientnet_cc_b0_4e", "mobilenetv3_rw",
                                  "mixnet_s", "rexnet_100"])
def test_torch_checkpoint_load_matches_jax(tmp_path, name):
    """timm's names (CondConv's flat experts, the mixed convs' .{j},
    ReXNet's features.{i}) load into equal parameters through both
    packages' loaders."""
    loaded_equal(tmp_path, name, num_classes=10)


def family_names(families):
    return sorted(n for n in JR.list_models()
                  if type(JR.model_spec(n)).__name__ in families)


def check_spec_and_build(name, size=64):
    """The spec equals the JAX package's field by field (and its
    feature_channels); create_model builds it on the CPU and runs a
    `size`-px image (64 by default) to the logits."""
    j, t = JR.model_spec(name), TR.model_spec(name)
    assert type(t).__name__ == type(j).__name__ and TR.is_model(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.feature_channels == j.feature_channels
    m = TR.create_model(name, device="cpu")
    assert not m.params.training
    with torch.no_grad():
        feats = m.apply(m.params, torch.from_numpy(imgs(size, n=1)))
        # apply(head=True)'s pooled head, on this forward's map
        logits = m.params.classify(feats.mean(dim=(1, 2)))
    # mobilenetv3's feature_channels are its head conv's, past the map
    if not isinstance(t, TR.Mn3ModelSpec):
        assert feats.shape[-1] == t.feature_channels
    assert logits.shape == (1, t.num_classes)
    assert torch.isfinite(feats).all() and torch.isfinite(logits).all()


@pytest.mark.parametrize("name", family_names(FAMILIES))
def test_spec_matches_jax_and_builds(name):
    check_spec_and_build(name)
