"""The port's model zoo, ViT family (vitcap_tpu_torch/models/registry.py),
vs the JAX package's (vitcap_tpu/models/registry.py) on the CPU: the
names and specs of the three ported families, the ViT forward in f32 at
tiny widths (hidden 32, 2 blocks, 4 heads) for each of its options, the
timm checkpoint loader, pruning, and the pipeline's trunk resolution.  The
JAX parameters are carried across by zoo_params_from_jax; inputs are
seeded numpy arrays.  The ResNet family and T2T are in
test_torch_zoo_cnn.py.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_vit.py -q
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import registry as JR
from vitcap_tpu.pipelines import caption_pipeline as JCP

from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models import registry as TR
from vitcap_tpu_torch.pipelines import caption_pipeline as TCP

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(hidden_size=32, depth=2, num_heads=4)
FAMILIES = (("vit", JR.VisionModelSpec, TR.VisionModelSpec,
             ("intermediate_size", "num_lead_tokens", "grid")),
            ("cnn", JR.CnnModelSpec, TR.CnnModelSpec, ("feature_channels",)),
            ("t2t", JR.T2tVitModelSpec, TR.T2tVitModelSpec,
             ("feature_channels",)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(jspec, jparams):
    """The port's model of jspec, holding the JAX parameters."""
    spec = getattr(TR, type(jspec).__name__)(**dataclasses.asdict(jspec))
    init = {TR.VisionModelSpec: TR.init_vision_params,
            TR.CnnModelSpec: TR.init_cnn_params,
            TR.T2tVitModelSpec: TR.init_t2t_vit_params}[type(spec)]
    model = init(spec, torch.Generator().manual_seed(1), device="cpu")
    TR.load_zoo_state(model, TR.zoo_params_from_jax(_np_tree(jparams), spec))
    return spec, model


# the spec classes of part 2a (tests/test_torch_zoo_effnet.py and
# test_torch_zoo_nets.py hold their specs and models to the JAX package's)
# and of parts 2b (tests/test_torch_zoo_2b_res.py and _2b_agg.py) and 2c
# (tests/test_torch_zoo_2c_*.py)
PART2A = ("EffNetModelSpec", "Mn3ModelSpec", "MixNetModelSpec",
          "RexNetModelSpec", "RegNetModelSpec", "NfNetModelSpec",
          "ResNetV2ModelSpec")
PART2B = ("SelecSlsModelSpec", "SeNetModelSpec", "SkNetModelSpec",
          "ResNestModelSpec", "TResNetModelSpec", "CspNetModelSpec",
          "DpnModelSpec", "DenseNetModelSpec", "DlaModelSpec",
          "VovNetModelSpec")
PART2C = ("HrNetModelSpec", "InceptionV3ModelSpec", "InceptionV4ModelSpec",
          "InceptionResnetV2ModelSpec", "XceptionModelSpec",
          "XcepAlignedModelSpec", "GluonXceptionModelSpec",
          "NASNetModelSpec", "PNASNetModelSpec")


@pytest.mark.parametrize("family", [f[0] for f in FAMILIES])
def test_registry_names_and_specs_match_jax(family):
    """The port registers exactly the JAX names of its twenty-nine
    families, all 422, every spec field and property of part 1's three
    equal; no JAX name is left unported (create_model builds part 2c's
    hrnet_w18), an unknown name raises ValueError."""
    _, jcls, tcls, props = next(f for f in FAMILIES if f[0] == family)
    jax_names = JR.list_models()
    kinds = tuple(f[1] for f in FAMILIES) + tuple(
        getattr(JR, k) for k in PART2A + PART2B + PART2C)
    ported = sorted(n for n in jax_names
                    if isinstance(JR.model_spec(n), kinds))
    assert len(ported) == 422 and TR.list_models() == ported
    mine = [n for n in ported if isinstance(JR.model_spec(n), jcls)]
    assert len(mine) == {"vit": 34, "cnn": 103, "t2t": 22}[family]
    for name in mine:
        j, t = JR.model_spec(name), TR.model_spec(name)
        assert type(t) is tcls and TR.is_model(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        for prop in props:
            assert getattr(t, prop) == getattr(j, prop), (name, prop)
    rest = sorted(set(jax_names) - set(ported))
    assert rest == [] and not hasattr(TR, "PART2_NAMES")
    m = TR.create_model("hrnet_w18", device="cpu")
    assert type(m.spec).__name__ == "HrNetModelSpec"
    assert isinstance(m.params, TR.HrNet)
    with pytest.raises(ValueError):
        TR.model_spec("nope_model")


# (case, name, spec overrides, image size, forward options)
VIT_CASES = [
    ("plain", "vit_base_patch16_224", dict(img_size=32, num_classes=10),
     32, {}),
    ("old_small", "vit_small_patch16_224", dict(img_size=32, num_classes=10),
     32, {}),
    ("distilled", "vit_deit_tiny_distilled_patch16_224",
     dict(img_size=32, num_classes=10), 32, {}),
    ("in21k", "vit_base_patch16_224_in21k",
     dict(img_size=32, num_classes=10, representation_size=24), 32, {}),
    ("hybrid_r50_v2", "vit_base_resnet50_384",
     dict(img_size=64, num_classes=10), 64, {}),
    ("hybrid_resnet26d", "vit_small_resnet26d_224",
     dict(img_size=64, num_classes=10), 64, {}),
    ("hybrid_resnet50d_s3", "vit_small_resnet50d_s3_224",
     dict(img_size=64, num_classes=10), 64, {}),
    # 32-px weights on 128-px images: the pos-embed resized to 8 x 8, 65
    # tokens: the fused block's route (its plain versions on the CPU)
    ("pos_resize", "vit_base_patch16_224", dict(img_size=32, num_classes=10),
     128, {}),
    ("pos_resize_distilled", "vit_deit_base_distilled_patch16_384",
     dict(img_size=32, num_classes=10), 128, {}),
    ("return_attn", "vit_base_patch16_224", dict(img_size=64, num_classes=10),
     64, dict(return_attn=True)),
    ("token_drop", "vit_base_patch16_224", dict(img_size=64, num_classes=10),
     64, dict(token_drop=0.5)),
]


def _close(case, got, want):
    """TOL; the R50 hybrid's stem (16 GroupNorm blocks of StdConvs) moves
    the conv rounding (each block within 1e-6 relative of the JAX one,
    test_torch_zoo_cnn.py test_r50_v2_blocks_match_jax) up to about 5e-5
    of the output's scale, so it is held there to 1e-4 of that scale, the
    ResNet family's conv tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    if case == "hybrid_r50_v2":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case,name,over,img,opts", VIT_CASES,
                         ids=[c[0] for c in VIT_CASES])
def test_vit_forward_matches_jax(case, name, over, img, opts):
    jm = JR.create_model(name, rng=jax.random.PRNGKey(3), **TINY, **over)
    spec, model = port_model(jm.spec, jm.params)
    imgs = np.random.RandomState(4).randn(2, img, img, 3).astype(np.float32)
    jkw, tkw = dict(opts), dict(opts)
    if "token_drop" in opts:
        # both sides drop by the same uniform draws (F3: the noise comes
        # from jax.random there, from a torch.Generator here)
        key = jax.random.PRNGKey(9)
        L = spec.grid ** 2
        jkw["rng"] = key
        tkw["noise"] = torch.from_numpy(np.asarray(
            jax.random.uniform(key, (2, L))))
    for head in (False, True):
        want = JR.vit_forward(jm.params, jnp.asarray(imgs), jm.spec,
                              head=head, **jkw)
        got = TR.vit_forward(model, torch.from_numpy(imgs), spec,
                             head=head, **tkw)
        if opts.get("return_attn"):
            (want, wa), (got, ga) = want, got
            assert ga.shape == (2, 2, 4, 17, 17)
            _close(case, ga.numpy(), wa)
        assert got.shape == want.shape
        _close(case, got.numpy(), want)


def _timm_state_dict(model, spec, grid_old, drop_qkv_bias=False):
    """The port model's (timm-named) tensors as a DDP checkpoint: a
    'module.' prefix, the pos-embed made for grid_old x grid_old."""
    g = torch.Generator().manual_seed(5)
    sd = {"module." + k: v.clone() for k, v in model.state_dict().items()
          if not (drop_qkv_bias and k.endswith("attn.qkv.bias"))}
    H = spec.hidden_size
    sd["module.pos_embed"] = torch.randn(
        1, spec.num_lead_tokens + grid_old ** 2, H, generator=g)
    return sd


@pytest.mark.parametrize("name,over", [
    ("vit_small_patch16_224", dict(img_size=64, num_classes=10)),
    ("vit_deit_tiny_distilled_patch16_224", dict(img_size=64,
                                                 num_classes=10)),
    ("vit_base_resnet50_224_in21k", dict(img_size=64, num_classes=10,
                                         representation_size=24)),
], ids=["old_small", "distilled", "hybrid_in21k"])
def test_timm_checkpoint_load_matches_jax(tmp_path, name, over):
    """A timm-layout state dict (module. prefix, pos-embed of another grid,
    the old small's absent qkv bias) loads into equal parameters through
    both packages' loaders."""
    spec = dataclasses.replace(TR.model_spec(name), **TINY, **over)
    src = TR.init_vision_params(spec, torch.Generator().manual_seed(6),
                                "cpu")
    with torch.no_grad():
        for p in src.parameters():
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    path = tmp_path / "vit.pth"
    torch.save(_timm_state_dict(src, spec, spec.grid + 3,
                                drop_qkv_bias=not spec.qkv_bias), path)
    jspec = dataclasses.replace(JR.model_spec(name), **TINY, **over)
    jl = JR.load_timm_checkpoint(
        JR.init_vision_params(jax.random.PRNGKey(0), jspec), str(path), jspec)
    m = TR.create_model(name, checkpoint_path=str(path), device="cpu",
                        **TINY, **over)
    got = m.params.state_dict()
    want = TR.zoo_params_from_jax(_np_tree(jl), spec)
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    if not spec.qkv_bias:
        assert not got["blocks.0.attn.qkv.bias"].any()


def test_prune_dense_and_heads_match_jax():
    rs = np.random.RandomState(0)
    kernel = rs.randn(8, 12).astype(np.float32)          # (in, out)
    bias = rs.randn(12).astype(np.float32)
    lin = torch.nn.Linear(8, 12)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T))
        lin.bias.copy_(torch.from_numpy(bias))
    jp = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    for index, dim in (([0, 3, 7], 0), ([1, 2], 1)):
        want = JL.prune_dense(jp, index, dim)
        got = TL.prune_dense(lin, index, dim)
        np.testing.assert_array_equal(got.weight.detach().numpy().T,
                                      np.asarray(want["kernel"]))
        np.testing.assert_array_equal(got.bias.detach().numpy(),
                                      np.asarray(want["bias"]))
    H, nh, hd = 8, 4, 2
    attn = TL._Group(**{n: torch.nn.Linear(H, H)
                        for n in ("query", "key", "value")},
                     note=torch.nn.Identity())
    jattn = {n: {"kernel": jnp.asarray(getattr(attn, n).weight.detach()
                                       .numpy().T),
                 "bias": jnp.asarray(getattr(attn, n).bias.detach().numpy())}
             for n in ("query", "key", "value")}
    want = JL.prune_attention_heads(jattn, [1, 3], nh, hd)
    got = TL.prune_attention_heads(attn, [1, 3], nh, hd)
    assert got.note is attn.note
    for n in ("query", "key", "value"):
        np.testing.assert_array_equal(
            getattr(got, n).weight.detach().numpy().T,
            np.asarray(want[n]["kernel"]))
        np.testing.assert_array_equal(getattr(got, n).bias.detach().numpy(),
                                      np.asarray(want[n]["bias"]))


@pytest.mark.parametrize("name", ["deit_base_patch16_384",
                                  "vit_base_patch32_384",
                                  "vit_large_patch16_384"])
def test_pipeline_trunk_resolves_through_registry(name):
    """model_cfg of a VitEmb_<name> pipeline at the shipped 768-wide json:
    the patch from the spec, the depth from it only where its width is
    the json's, as the JAX pipeline resolves it."""
    kw = dict(image_encoder_type=f"VitEmb_{name}", train_crop_size=384)
    j = JCP.CaptionUniPipeline(**kw).model_cfg
    t = TCP.CaptionUniPipeline(device="cpu", **kw).model_cfg
    want = dict(j.__dict__)
    got = {k: v for k, v in t.__dict__.items() if k in want}
    assert got == {k: v for k, v in want.items() if k in got}
    spec = TR.model_spec(name)
    assert t.patch_size == spec.patch_size
    assert t.num_hidden_layers == (spec.depth if spec.hidden_size == 768
                                   else 12)
