"""vitcap_tpu_torch kernels and fused blocks vs the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those versions, and the fused block compositions built from them,
against the JAX math (the JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them).  tests/test_torch_cuda.py holds the CUDA
kernels against these plain versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import layers as JL
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.ops import fused_block as JF
from vitcap_tpu.ops.flash_attention import _xla_attention

from vitcap_tpu_torch import ops
from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops import fused_block as TF
from vitcap_tpu_torch.ops.attention import attention
from vitcap_tpu_torch.ops.decode_step import decode_attention
from vitcap_tpu_torch.ops.gemm import gemm
from vitcap_tpu_torch.ops.layer_norm import layer_norm
from vitcap_tpu_torch.solver.checkpoint_bridge import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _models(**kw):
    """The same random weights as a JAX param tree and a port ViTCAP."""
    jcfg = jax_tiny_config(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    model = load_jax_params(TM.ViTCAP(TC.tiny_config(**kw)), params)
    return jcfg, params, model


# ---------------------------------------------------------------------------
# plain kernel versions vs the JAX math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_layer_norm_plain_matches_jax(eps):
    rs = np.random.RandomState(0)
    x = rs.randn(37, 48).astype(np.float32) * 3 + 1
    g = rs.randn(48).astype(np.float32)
    b = rs.randn(48).astype(np.float32)
    ref = JL.layer_norm({"scale": g, "bias": b}, jnp.asarray(x), eps)
    out = layer_norm(_t(x), _t(g), _t(b), eps, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("gelu_on,residual", [(False, False), (True, False),
                                              (False, True)])
def test_gemm_plain_matches_jax_dense(gelu_on, residual):
    rs = np.random.RandomState(1)
    a = rs.randn(50, 24).astype(np.float32)
    w = rs.randn(24, 40).astype(np.float32) * 0.2      # JAX (in, out)
    b = rs.randn(40).astype(np.float32)
    r = rs.randn(50, 40).astype(np.float32)
    ref = JL.dense({"kernel": w, "bias": b}, jnp.asarray(a))
    if gelu_on:
        ref = JL.gelu(ref)
    if residual:
        ref = ref + r
    out = gemm(_t(a), _t(w.T), _t(b), gelu=gelu_on,
               residual=_t(r) if residual else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_plain_matches_jax(with_bias):
    rs = np.random.RandomState(2)
    B, L, Lp, nh, hd = 2, 70, 80, 4, 8
    H = nh * hd
    slab = rs.randn(B, Lp, 3 * H).astype(np.float32)
    bias = np.where(rs.rand(B, 1, Lp, Lp) > 0.3, 0.0,
                    -10000.0).astype(np.float32)
    out = attention(_t(slab), nh, L, _t(bias) if with_bias else None)

    def heads(a):
        return jnp.asarray(a[:, :L]).reshape(B, L, nh, hd).transpose(0, 2, 1, 3)
    q, k, v = (heads(slab[..., i * H:(i + 1) * H]) for i in range(3))
    jb = jnp.asarray(bias[:, :, :L, :L]) if with_bias else None
    ref = _xla_attention(q, k, v, jb).transpose(0, 2, 1, 3).reshape(B, L, H)
    np.testing.assert_allclose(out.numpy()[:, :L], np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers run the plain versions and count nothing."""
    ops.reset_counts()
    x = torch.randn(4, 16)
    gemm(x, torch.randn(8, 16))
    layer_norm(x, torch.ones(16), torch.zeros(16), 1e-6, torch.float32)
    attention(torch.randn(1, 4, 24), 2, 4)
    decode_attention(torch.randn(2, 2, 24), torch.zeros(2, 3, 8),
                     torch.zeros(2, 3, 8), torch.randn(1, 5, 8),
                     torch.randn(1, 5, 8), torch.zeros(1, 5),
                     torch.tensor(1, dtype=torch.int32), 2)
    assert ops.launch_counts() == {"gemm": 0, "layer_norm": 0,
                                   "attention": 0, "attention_bwd": 0,
                                   "decode_attention": 0}


def test_pad_len_rule():
    for L in (5, 65, 70, 130, 577, 628, 1024, 1100):
        assert TF.pad_len(L) == JF.pad_len(L)
    assert TF.pad_len(577) == 592 and TF.pad_len(628) == 640


# ---------------------------------------------------------------------------
# fused blocks vs the JAX split-block kernels (interpret mode)
# ---------------------------------------------------------------------------

WIDTHS = {
    "tiny": {},                                               # hd = 8
    "hd64": dict(hidden_size=128, num_attention_heads=2,       # pairbd
                 intermediate_size=512),
}


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("L", [70, 130])
def test_fused_vit_block_matches_jax(width, L):
    jcfg, params, model = _models(**WIDTHS[width])
    blk = params["encoder"]["blocks"][0]
    x = np.random.RandomState(1).randn(2, L, jcfg.hidden_size) \
        .astype(np.float32)
    nh, eps = jcfg.num_attention_heads, jcfg.vit_layer_norm_eps
    ref = JF.fused_vit_block(blk, jnp.asarray(x), nh, eps, True)
    out = TF.fused_vit_block(model.bert.encoder.blocks[0], _t(x), nh, eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("L", [70, 130])
def test_fused_bert_block_matches_jax(width, L):
    jcfg, params, model = _models(**WIDTHS[width])
    layer = params["decoder"]["layer"][0]
    rs = np.random.RandomState(0)
    x = rs.randn(2, L, jcfg.hidden_size).astype(np.float32)
    bias = np.where(rs.rand(2, 1, L, L) > 0.3, 0.0,
                    -10000.0).astype(np.float32)
    nh, eps = jcfg.num_attention_heads, jcfg.bert_layer_norm_eps
    ref = JF.fused_bert_block(layer, jnp.asarray(x), jnp.asarray(bias), nh,
                              eps, True)
    out = TF.fused_bert_block(model.bert.decoder.layer[0], _t(x), _t(bias),
                              nh, eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def _bf16_close(out, ref):
    """bf16 outputs vs the JAX kernels' bf16 outputs: within 2e-2 of the
    output's scale, and at least 99% of the elements bit-equal, which only
    the same rounding order gives (rounding the epilogue once from f32
    leaves 91-98% equal here; the f32 sums may still round apart in a
    few)."""
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.isfinite(out).all()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 2e-2 * scale
    assert (out == ref).mean() >= 0.99, (out == ref).mean()


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_fused_vit_block_matches_jax_bf16(width):
    jcfg, params, model = _models(**WIDTHS[width])
    x = np.random.RandomState(5).randn(2, 70, jcfg.hidden_size) \
        .astype(np.float32)
    nh, eps = jcfg.num_attention_heads, jcfg.vit_layer_norm_eps
    ref = JF.fused_vit_block(params["encoder"]["blocks"][0],
                             jnp.asarray(x, jnp.bfloat16), nh, eps, True)
    out = TF.fused_vit_block(model.bert.encoder.blocks[0],
                             _t(x).bfloat16(), nh, eps)
    _bf16_close(out, ref)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_fused_bert_block_matches_jax_bf16(width):
    jcfg, params, model = _models(**WIDTHS[width])
    rs = np.random.RandomState(6)
    x = rs.randn(2, 70, jcfg.hidden_size).astype(np.float32)
    bias = np.where(rs.rand(2, 1, 70, 70) > 0.3, 0.0,
                    -10000.0).astype(np.float32)
    nh, eps = jcfg.num_attention_heads, jcfg.bert_layer_norm_eps
    ref = JF.fused_bert_block(params["decoder"]["layer"][0],
                              jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias),
                              nh, eps, True)
    out = TF.fused_bert_block(model.bert.decoder.layer[0], _t(x).bfloat16(),
                              _t(bias), nh, eps)
    _bf16_close(out, ref)


def test_fused_block_weight_cache_follows_loads():
    """bf16 weights are cast once per module; loading new weights into the
    module remakes them."""
    _, _, model = _models()
    blk = model.bert.encoder.blocks[0]
    x = torch.randn(2, 70, 32, generator=torch.Generator().manual_seed(0)) \
        .bfloat16()
    before = TF.fused_vit_block(blk, x, 4, 1e-6)
    cached = TF._block_weights(blk, torch.bfloat16, TF._vit_weights)
    assert TF._block_weights(blk, torch.bfloat16, TF._vit_weights) is cached
    sd = blk.state_dict()
    sd["mlp.fc2.weight"] = sd["mlp.fc2.weight"] * 3
    blk.load_state_dict(sd)
    after = TF.fused_vit_block(blk, x, 4, 1e-6)
    assert not torch.equal(after, before)
    ref = TL._vit_block_plain(blk, x, 4, 1e-6).float()
    assert (after.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_fused_blocks_refuse_long_inputs():
    """Only the split train blocks stop at 1024 padded tokens (a train call
    past it takes the plain chain); a pre-padded long input
    must be 128-aligned, as the TPU package's q-tiled kernels need."""
    _, _, model = _models()
    blk = model.bert.encoder.blocks[0]
    with pytest.raises(NotImplementedError):
        TF.split_vit_block_train(blk, torch.zeros(1, 1152, 32), 4, 1e-6)
    assert not TF.takes_split_train(1152)
    with pytest.raises(ValueError):
        TF.fused_vit_block(blk, torch.zeros(1, 1040, 32), 4, 1e-6,
                           l_actual=1030)


def test_fused_blocks_accept_long_inputs():
    """The inference blocks at L = 1100 (Lp 1152) equal the plain blocks."""
    _, _, model = _models()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 1100, 32, generator=g)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    out = TF.fused_vit_block(blk, x, 4, 1e-6)
    ref = TL._vit_block_plain(blk, x, 4, 1e-6)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    pre = TF.fused_vit_block(blk, torch.nn.functional.pad(x, (0, 0, 0, 52)),
                             4, 1e-6, l_actual=1100)
    np.testing.assert_allclose(pre[:, :1100].numpy(), ref.numpy(),
                               rtol=2e-5, atol=2e-5)
    bias = torch.where(torch.rand(1, 1, 1100, 1100, generator=g) > 0.3, 0.0,
                       -10000.0)
    out = TF.fused_bert_block(layer, x, bias, 4, 1e-12)
    ref = TL._bert_layer_plain(layer, x, bias, 4, 1e-12)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# tie-stable top-k
# ---------------------------------------------------------------------------

def test_exact_top_k_ties_go_to_lower_index():
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5],
                      [0.2, 0.2, 0.2, 0.2, 0.2, 0.2]])
    v, i = TD.exact_top_k(x, 4)
    assert i.tolist() == [[1, 3, 0, 2], [0, 1, 2, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_exact_top_k_matches_lax_on_quantised_values():
    rs = np.random.RandomState(3)
    x = np.round(rs.rand(8, 3000) * 50) / 50          # many ties
    v, i = TD.exact_top_k(torch.from_numpy(x).float(), 50)
    jv, ji = jax.lax.top_k(jnp.asarray(x, jnp.float32), 50)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
