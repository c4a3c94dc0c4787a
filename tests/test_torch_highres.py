"""vitcap_tpu_torch at 512 px vs the JAX package, on the CPU.

The weights are made for 384 px (tiny_config(img_size=384): a 24 x 24
pos-embed grid) and the images are 512 x 512 uint8, so both packages resize
the pos-embed to 32 x 32 and run 1025 visual tokens, padded to 1152: past
1024, where the JAX package's monolithic q-tiled kernels (K10:
_block_kernel, _bert_kernel) take the trunk, the tag branch and the prefill
(10 od + 1 tag CLS + 1025 visual = 1036 tokens).  The JAX side runs with
VITCAP_PALLAS=interpret (and VITCAP_DECODE_FUSED=interpret for its fused
decode engine), so those kernels run in interpret mode.  The JAX results
are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import decode as JD
from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.ops import fused_block as JF
from vitcap_tpu.ops import inference_mode

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops import fused_block as TF
from vitcap_tpu_torch.solver.checkpoint_bridge import load_jax_params

KW = dict(img_size=384)
IMG = 512
B = 2
ENGINES = {"heads": "0", "flat": "interpret"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def mp():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("VITCAP_PALLAS", "interpret")
        yield m


@pytest.fixture(scope="module")
def setup(mp):
    jcfg = jax_tiny_config(**KW)
    cfg = TC.tiny_config(**KW)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(TM.ViTCAP(cfg),
                            jax.tree_util.tree_map(np.asarray, params))
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    od = rs.randint(1, cfg.vocab_size, (B, od_len)).astype(np.int32)
    sl = np.array([cfg.max_seq_a_len + 2, cfg.max_seq_a_len + od_len],
                  np.int32)
    # TokenSample subset: CLS + 299 distinct patch tokens in a random order
    vti = np.stack([np.concatenate([[0], rs.permutation(1024)[:299] + 1])
                    for _ in range(B)]).astype(np.int32)
    kw = dict(max_length=cfg.max_gen_length,
              od_labels_start_posid=cfg.max_seq_a_len)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, imgs=imgs,
                od=od, sl=sl, vti=vti, opts_j=JD.DecodeOptions(**kw),
                opts_t=TD.DecodeOptions(**kw))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _encode_both(s, jcfg, cfg, vti=None):
    with inference_mode():
        ref = JM.encode_images(s["params"], jnp.asarray(s["imgs"]), jcfg,
                               None if vti is None else jnp.asarray(vti))
    out = TM.encode_images(s["model"], torch.from_numpy(s["imgs"]), cfg,
                           None if vti is None else torch.from_numpy(vti))
    return ref, out


def _assert_encode_same(ref, out):
    for key in ("visual", "tag_cls", "tag_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(out["pred_topk"].numpy(),
                                  np.asarray(ref["pred_topk"]))


def _assert_generate_same(ref, out):
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    np.testing.assert_allclose(out["logprobs"].numpy(),
                               np.asarray(ref["logprobs"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["step_scores"].numpy(),
                               np.asarray(ref["step_scores"]), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# pos-embed interpolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old,new", [(24, 32), (24, 8), (2, 4)])
def test_interpolate_pos_embed_matches_jax(old, new):
    """torch's bicubic F.interpolate vs the JAX package's rebuild of it
    (A = -0.75, half-pixel centres, clamped borders, no antialias), f32."""
    pe = np.random.RandomState(old * new).randn(1, old * old + 1, 48) \
        .astype(np.float32)
    ref = JL.interpolate_pos_embed(jnp.asarray(pe), (new, new), (old, old))
    out = TL.interpolate_pos_embed(_t(pe), (new, new), (old, old))
    assert out.shape == (1, new * new + 1, 48) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(out[:, 0].numpy(), pe[:, 0])


def test_vision_embed_resizes_once_per_load(setup):
    """The resized table is cached on the module and remade when the
    parameter changes in place (a checkpoint load)."""
    vis = TM.ViTCAP(setup["cfg"]).image_encoder.module.requires_grad_(False)
    vis.load_state_dict(setup["model"].image_encoder.module.state_dict())
    img = torch.from_numpy(setup["imgs"][:1])
    first = TL.vision_embed(vis, img, 16)
    cached = vis.__dict__["_pos_embed_resized"][1]
    TL.vision_embed(vis, img, 16)
    assert vis.__dict__["_pos_embed_resized"][1] is cached
    with torch.no_grad():
        vis.pos_embed.mul_(2.0)
    again = TL.vision_embed(vis, img, 16)
    assert vis.__dict__["_pos_embed_resized"][1] is not cached
    assert not torch.equal(again, first)


# ---------------------------------------------------------------------------
# K10: the blocks past 1024 padded tokens
# ---------------------------------------------------------------------------

def _bf16_close(out, ref):
    """bf16 outputs vs the JAX kernel's: within 2e-2 of the output's scale
    and at least 99% of the elements bit-equal (the same rounding
    points)."""
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
    assert (out == ref).mean() >= 0.99, (out == ref).mean()


def _prefill_bias(L, od_len=10):
    """The prefill's mask at L context tokens: od rows see 6 valid od
    slots and the rest; the other rows never see od."""
    allow = np.ones((B, 1, L, L), bool)
    allow[:, :, :od_len, 6:od_len] = False
    allow[:, :, od_len:, :od_len] = False
    return np.where(allow, 0.0, -10000.0).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_vit_block_long_matches_jax_k10(setup, dtype):
    """fused_vit_block at L = 1025 (Lp 1152) vs JAX's _block_kernel in
    interpret mode: f32 within 2e-5, bf16 at least 99% bit-equal."""
    s = setup
    jcfg = s["jcfg"]
    x = np.random.RandomState(7).randn(B, 1025, jcfg.hidden_size) \
        .astype(np.float32)
    nh, eps = jcfg.num_attention_heads, jcfg.vit_layer_norm_eps
    ref = JF.fused_vit_block(s["params"]["encoder"]["blocks"][0],
                             jnp.asarray(x, dtype), nh, eps, True)
    out = TF.fused_vit_block(s["model"].bert.encoder.blocks[0],
                             _t(x).to(getattr(torch, dtype)), nh, eps)
    assert out.shape == (B, 1025, jcfg.hidden_size)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    else:
        _bf16_close(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bert_block_long_matches_jax_k10(setup, dtype):
    """fused_bert_block at L = 1076 (the flagship's prefill length at
    512 px, Lp 1152) with a prefill mask vs JAX's _bert_kernel."""
    s = setup
    jcfg = s["jcfg"]
    L = 1076
    x = np.random.RandomState(8).randn(B, L, jcfg.hidden_size) \
        .astype(np.float32)
    bias = _prefill_bias(L)
    nh, eps = jcfg.num_attention_heads, jcfg.bert_layer_norm_eps
    ref = JF.fused_bert_block(s["params"]["decoder"]["layer"][0],
                              jnp.asarray(x, dtype), jnp.asarray(bias), nh,
                              eps, True)
    out = TF.fused_bert_block(s["model"].bert.decoder.layer[0],
                              _t(x).to(getattr(torch, dtype)), _t(bias), nh,
                              eps)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    else:
        _bf16_close(out, ref)


# ---------------------------------------------------------------------------
# the encode path and generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoded(setup):
    return _encode_both(setup, setup["jcfg"], setup["cfg"])


def test_encode_images_512_matches_jax(encoded):
    """384-grid weights on 512 px images: the interpolated pos-embed and
    the long trunk and tag blocks."""
    ref, out = encoded
    assert out["visual"].shape[1] == 1025
    _assert_encode_same(ref, out)


@pytest.fixture(scope="module")
def generated(setup):
    s = setup
    res = {}
    for engine, flag in ENGINES.items():
        s_mp = pytest.MonkeyPatch()
        s_mp.setenv("VITCAP_DECODE_FUSED", flag)
        try:
            ref = JD.generate(s["params"], jnp.asarray(s["imgs"]),
                              jnp.asarray(s["od"]), None,
                              jnp.asarray(s["sl"]), s["jcfg"], s["opts_j"])
            out = TD.generate(s["model"], torch.from_numpy(s["imgs"]),
                              torch.from_numpy(s["od"]).long(), None,
                              torch.from_numpy(s["sl"]).long(), s["cfg"],
                              s["opts_t"])
        finally:
            s_mp.undo()
        res[engine] = (ref, out)
    return res


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_generate_512_matches_jax(generated, engine):
    """Greedy ids exact and logprobs within 1e-4 on both engines; the
    prefill runs K10 (1036 context tokens, Lp 1152)."""
    ref, out = generated[engine]
    np.testing.assert_array_equal(out["pred_topk"].numpy(),
                                  np.asarray(ref["pred_topk"]))
    _assert_generate_same(ref, out)


@pytest.mark.parametrize("block", [2, 3])
def test_token_filter_matches_jax(setup, block):
    """token_filter_keep=0.5 keeps CLS + 512 of the 1024 patch tokens
    before trunk block `block`: the trunk goes from Lp 1152 to Lp 528.
    Block 2 is the fork (the tag branch starts filtered); block 3 filters
    after it (the tag branch keeps its 1025 tokens).  The port used to
    ignore the knob and return all 1025 tokens."""
    s = setup
    jcfg = s["jcfg"].replace(token_filter_keep=0.5, token_filter_block=block)
    cfg = s["cfg"].replace(token_filter_keep=0.5, token_filter_block=block)
    ref, out = _encode_both(s, jcfg, cfg)
    assert out["visual"].shape[1] == 513
    _assert_encode_same(ref, out)


def test_visual_token_idx_encode_and_generate_match_jax(setup):
    """An explicit TokenSample subset (CLS + 299 tokens, a random order)
    through encode_images and generate, vs the JAX package's encode_images
    and its generate over build_decode_context(visual_token_idx)."""
    s = setup
    vti = s["vti"]
    ref, out = _encode_both(s, s["jcfg"], s["cfg"], vti)
    assert out["visual"].shape[1] == 300
    _assert_encode_same(ref, out)
    ctx = JD.build_decode_context(s["params"], jnp.asarray(s["imgs"]),
                                  jnp.asarray(s["od"]), None,
                                  jnp.asarray(s["sl"]), s["jcfg"],
                                  s["opts_j"], jnp.asarray(vti))
    ref = JD.generate_greedy(s["params"], None, None, None, None, s["jcfg"],
                             s["opts_j"], ctx=ctx)
    out = TD.generate(s["model"], torch.from_numpy(s["imgs"]),
                      torch.from_numpy(s["od"]).long(), None,
                      torch.from_numpy(s["sl"]).long(), s["cfg"],
                      s["opts_t"], visual_token_idx=torch.from_numpy(vti))
    _assert_generate_same(ref, out)


def test_sample_visual_token_idx():
    """CLS first, distinct indices in range, reproducible per generator
    seed, another seed another subset."""
    def draw(seed):
        return TM.sample_visual_token_idx(
            torch.Generator().manual_seed(seed), 3, 1025, 700)
    a = draw(0)
    assert a.shape == (3, 700) and a.dtype == torch.int64
    assert (a[:, 0] == 0).all()
    assert ((a[:, 1:] >= 1) & (a[:, 1:] < 1025)).all()
    for row in a:
        assert len(set(row.tolist())) == 700
    assert torch.equal(a, draw(0))
    assert not torch.equal(a, draw(1))
