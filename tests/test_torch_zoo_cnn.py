"""The port's model zoo, ResNet family and T2T-ViT (vitcap_tpu_torch/
models/backbones.py, t2t_vit.py, registry.py), vs the JAX package's on
the CPU: f32 forwards at real channel widths (64-px images, B=2; some at
their first two stages), the R50 hybrid stem block by block, T2T's two
tokeniser kinds and its qk_scale rule (F5), and the torch state-dict
loaders.  The JAX parameters are carried across by zoo_params_from_jax;
inputs are seeded numpy arrays.  The ViT family is in
test_torch_zoo_vit.py.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_cnn.py -q
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import backbones as JB
from vitcap_tpu.models import registry as JR

from vitcap_tpu_torch.models import backbones as TB
from vitcap_tpu_torch.models import registry as TR
from vitcap_tpu_torch.models.t2t_vit import T2TViT


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


CONV_TOL = dict(rtol=0, atol=1e-4)   # f32 convs: another summation order
TOL = dict(rtol=1e-5, atol=1e-5)


def _imgs(size, seed=4):
    return np.random.RandomState(seed).randn(2, size, size,
                                             3).astype(np.float32)


# (variant, stages): 4 = the whole classifier, head included; 2 = its
# first two stages (the feature map), where the whole net is large for a
# CPU test
RESNET_CASES = [
    ("resnetblur18", 4),             # basic blocks, 7x7 stem, BlurPool
    ("seresnext26d_32x4d", 4),       # SE, grouped (ResNeXt) convs, deep
                                     # stem, avg-pool downsample
    ("ecaresnetlight", 4),           # ECA, 7x7 stem with avg-down
    ("seresnext26tn_32x4d", 2),      # the tiered-narrow stem
    ("ecaresnet50d_pruned", 2),      # the pruned widths and ECA kernels
    ("resnetblur50", 2),             # bottlenecks, 7x7 stem, conv-down,
                                     # BlurPool
    ("res2net50_48w_2s", 2),         # Bottle2neck, scale 2
    ("res2next50", 2),               # Bottle2neck, cardinality 8
    ("gluon_resnet50_v1c", 2),       # deep stem, conv downsample
    ("gluon_resnet50_v1s", 2),       # the 64-wide deep stem
    ("senet154", 2),                 # 3x3 downsample, halved first conv
]


def _skeleton(model):
    """The part of the JAX param tree its torch loaders read (which blocks
    downsample or carry SE/ECA, the res2 branch counts, T2T's block count,
    whether there is a head): the JAX side of a test then holds the port's
    seeded weights through the JAX package's own loader, with no JAX init
    to trace."""
    if isinstance(model, T2TViT):
        tree = {"backbone": {"blocks": [0] * len(model.blocks)}}
    else:
        tree = {"backbone": {"stages": [
            [dict({"se": 0} if hasattr(blk, "se") else {},
                  **({"down_conv": 0} if hasattr(blk, "downsample") else {}),
                  **({"convs": [0] * len(blk.convs),
                      "bns": [0] * len(blk.bns)}
                     if hasattr(blk, "convs") else {}))
             for blk in stage] for stage in model.stages()]}}
    if hasattr(model, "fc") or hasattr(model, "head"):
        tree["head"] = 0
    return tree


@pytest.mark.parametrize("variant,stages", RESNET_CASES,
                         ids=[c[0] for c in RESNET_CASES])
def test_resnet_forward_matches_jax(variant, stages):
    """Seeded port weights, carried into the JAX tree by the JAX package's
    own torch loader (load_resnet), through both forwards."""
    imgs = _imgs(64)
    spec = TR.model_spec(variant, num_classes=10 if stages == 4 else 0)
    jspec = JR.CnnModelSpec(**dataclasses.asdict(spec))
    model = TR.init_cnn_params(spec, torch.Generator().manual_seed(2), "cpu",
                               n_stages=stages)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jp = {"backbone": JB.load_resnet(_skeleton(model)["backbone"], sd,
                                     variant, "")}
    if stages == 4:
        jp["head"] = {"kernel": jnp.asarray(sd["fc.weight"].T),
                      "bias": jnp.asarray(sd["fc.bias"])}
    assert TR.zoo_params_from_jax(_np_tree(jp), spec).keys() == {
        k for k in sd if not k.endswith("num_batches_tracked")}
    for head in ((False, True) if stages == 4 else (False,)):
        want = np.asarray(jax.jit(lambda p, x: JR.cnn_forward(
            p, x, jspec, head=head))(jp, jnp.asarray(imgs)))
        got = TR.cnn_forward(model, torch.from_numpy(imgs), spec,
                             head=head).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **CONV_TOL)


def test_r50_v2_blocks_match_jax():
    """The R50 hybrid stem (StdConv 'SAME' + GroupNorm): the stem, then
    each block fed the JAX block's input, within 1e-5; the whole stem
    within 1e-4 of its output's scale (GroupNorm carries each block's
    rounding on to the next)."""
    m = TR._build(TB.ResNetV2R50, "cpu", torch.Generator().manual_seed(0))
    jp = JB.load_resnetv2_r50(
        {"stages": [[{"down_conv": 0} if hasattr(blk, "downsample") else {}
                     for blk in st.blocks] for st in m.stages]},
        {k: v.numpy() for k, v in m.state_dict().items()}, "")
    assert TB.resnetv2_r50_from_jax(_np_tree(jp)).keys() == \
        m.state_dict().keys()
    imgs = _imgs(64)

    def nchw(a):
        return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)

    def nhwc(t):
        return t.permute(0, 2, 3, 1).numpy()

    xj = JB._max_pool(JB._group_norm(JB._std_conv(
        jnp.asarray(imgs), jp["stem"]["conv"], 2, "SAME"),
        jp["stem"]["norm"]), 3, 2, "SAME")
    xt = TB._max_pool_same(TB._group_norm(TB._std_conv(
        nchw(imgs), m.stem.conv.weight, 2), m.stem.norm))
    np.testing.assert_allclose(nhwc(xt), np.asarray(xj), **TOL)
    for si, blocks in enumerate(jp["stages"]):
        for bi, blk in enumerate(blocks):
            s = (1 if si == 0 else 2) if bi == 0 else 1
            tb = m.stages[si].blocks[bi]
            sj, st = xj, nchw(xj)
            if "down_conv" in blk:
                sj = JB._group_norm(JB._std_conv(xj, blk["down_conv"], s),
                                    blk["down_norm"], act=False)
                st = TB._group_norm(TB._std_conv(
                    nchw(xj), tb.downsample.conv.weight, s),
                    tb.downsample.norm, act=False)
            yj = JB._group_norm(JB._std_conv(xj, blk["conv1"]), blk["norm1"])
            yj = JB._group_norm(JB._std_conv(yj, blk["conv2"], s),
                                blk["norm2"])
            yj = JB._group_norm(JB._std_conv(yj, blk["conv3"]), blk["norm3"],
                                act=False)
            yt = TB._group_norm(TB._std_conv(nchw(xj), tb.conv1.weight),
                                tb.norm1)
            yt = TB._group_norm(TB._std_conv(yt, tb.conv2.weight, s),
                                tb.norm2)
            yt = TB._group_norm(TB._std_conv(yt, tb.conv3.weight), tb.norm3,
                                act=False)
            xj = jax.nn.relu(yj + sj)
            np.testing.assert_allclose(nhwc(torch.relu(yt + st)),
                                       np.asarray(xj), **TOL)
    want = np.asarray(JB.apply_resnetv2_r50(jp, jnp.asarray(imgs)))
    got = TB.apply_backbone(m, torch.from_numpy(imgs)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", ["t2t_vit_t_14", "T2t_vit_7"],
                         ids=["transformer", "performer"])
def test_t2t_forward_matches_jax(tmp_path, name):
    """Seeded port weights, carried into the JAX tree by the JAX package's
    own loader, through both forwards."""
    spec = TR.model_spec(name, num_classes=10)
    jspec = JR.T2tVitModelSpec(**dataclasses.asdict(spec))
    model = TR.init_t2t_vit_params(spec, torch.Generator().manual_seed(5),
                                   "cpu")
    path = str(tmp_path / "t2t.pth")
    torch.save(model.state_dict(), path)
    jp = JR.load_t2t_vit_checkpoint(_skeleton(model), path, jspec)
    imgs = _imgs(224, seed=6)
    for head in (False, True):
        want = np.asarray(jax.jit(lambda p, x: JR.t2t_vit_forward(
            p, x, jspec, head=head))(jp, jnp.asarray(imgs)))
        got = TR.t2t_vit_forward(model, torch.from_numpy(imgs), spec,
                                 head=head).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def _save(model, path, prefix=""):
    """The port model's tensors, every value redrawn from a seed, as a
    torch state dict file."""
    g = torch.Generator().manual_seed(11)
    sd = {}
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            v = torch.randn(v.shape, generator=g) * 0.1 + (
                1.0 if "running_var" in k else 0.0)
            v = v.abs() if "running_var" in k else v
        sd[prefix + k] = v
    torch.save(sd, path)


def _loaded_equal(tmp_path, name, over, jax_load=None):
    """A state dict file of `name`'s port model through both packages'
    loaders, equal parameter for parameter.  jax_load(path) -> the JAX
    model (default: the JAX package's loader into the tree's skeleton).
    -> (the JAX tree or model, the port model)."""
    spec = dataclasses.replace(TR.model_spec(name), **over)
    path = str(tmp_path / f"{name}.pth")
    _save(TR.create_model(name, device="cpu", **over).params, path)
    m = TR.create_model(name, checkpoint_path=path, device="cpu", **over)
    if jax_load is None:
        jspec = dataclasses.replace(JR.model_spec(name), **over)
        load = (JR.load_cnn_checkpoint if isinstance(jspec, JR.CnnModelSpec)
                else JR.load_t2t_vit_checkpoint)
        jm = jp = load(_skeleton(m.params), path, jspec)
    else:
        jm = jax_load(path)
        jp = jm.params
    got = m.params.state_dict()
    want = TR.zoo_params_from_jax(_np_tree(jp), spec)
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    return jm, m


@pytest.mark.parametrize("name", ["seresnext26d_32x4d", "res2net50_48w_2s",
                                  "t2t_vit_t_14"],
                         ids=["se_resnext", "res2", "t2t_transformer"])
def test_torch_checkpoint_load_matches_jax(tmp_path, name):
    """A torch state dict of the reference's names (BatchNorm running
    statistics, SE and res2 branches, T2T's tokenisers) loads into equal
    parameters through both packages' loaders."""
    _loaded_equal(tmp_path, name, dict(num_classes=10))


@pytest.fixture
def jax_t2t_init_traced(monkeypatch):
    """The JAX package's create_model with its T2T init traced once (jit),
    not run op by op: the same values, in seconds."""
    monkeypatch.setattr(JR, "init_t2t_vit_params",
                        jax.jit(JR.init_t2t_vit_params, static_argnums=1))


@pytest.mark.usefixtures("jax_t2t_init_traced")
def test_t2t_checkpoint_load_keeps_head_dim_scale(tmp_path):
    """F5: loading a checkpoint keeps qk_scale 0 (head_dim ** -0.5) on
    both sides, and the outputs agree."""
    jm, m = _loaded_equal(tmp_path, "t2t_vit_7", dict(num_classes=10),
                          lambda path: JR.create_model(
                              "t2t_vit_7", checkpoint_path=path,
                              num_classes=10))
    assert jm.spec.qk_scale == m.spec.qk_scale == 0.0
    imgs = _imgs(224, seed=7)
    want = np.asarray(jm.apply(jm.params, jnp.asarray(imgs), True))
    got = m.apply(m.params, torch.from_numpy(imgs), head=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    hd = 256 // 4
    explicit = TR.t2t_vit_forward(
        m.params, torch.from_numpy(imgs),
        dataclasses.replace(m.spec, qk_scale=hd ** -0.5), head=True)
    np.testing.assert_allclose(explicit.numpy(), got.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.usefixtures("jax_t2t_init_traced")
def test_t2t_explicit_qk_scale_overrides(tmp_path):
    """F5: qk_scale= (the released weights' embed ** -0.5) overrides the
    head-dim scale after a load, as in the JAX package."""
    path = str(tmp_path / "t2t.pth")
    _save(TR.create_model("t2t_vit_7", device="cpu", num_classes=10).params,
          path)
    scale = 256 ** -0.5
    jm = JR.create_model("t2t_vit_7", checkpoint_path=path, num_classes=10,
                         qk_scale=scale)
    m = TR.create_model("t2t_vit_7", checkpoint_path=path, device="cpu",
                        num_classes=10, qk_scale=scale)
    assert m.spec.qk_scale == jm.spec.qk_scale == scale
    imgs = _imgs(224, seed=8)
    want = np.asarray(jm.apply(jm.params, jnp.asarray(imgs), True))
    got = m.apply(m.params, torch.from_numpy(imgs), head=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    default = TR.t2t_vit_forward(m.params, torch.from_numpy(imgs),
                                 dataclasses.replace(m.spec, qk_scale=0.0),
                                 head=True).numpy()
    assert np.abs(default - got).max() > 1e-5
