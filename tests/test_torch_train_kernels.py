"""vitcap_tpu_torch train kernels and train blocks vs the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those versions, and the train blocks built from them, against the JAX
package's train kernels run in interpret mode (as its own
TestSplitBlockTrain / TestSplitBertLayerTrain run them).  The dropout masks
are the same counter-hash bits on both sides, so dropout-active runs are
held at deterministic tolerances given the same int32 seeds.
tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.ops import flash_attention as JFA
from vitcap_tpu.ops import fused_block as JF

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops import dropout as TD
from vitcap_tpu_torch.ops import fused_block as TF
from vitcap_tpu_torch.ops.attention import attention
from vitcap_tpu_torch.ops.attention_bwd import attention_bwd
from vitcap_tpu_torch.solver import checkpoint_bridge as TB

B, L, LP = 2, 77, 80


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _j2t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _bias(seed=9, Lp=LP):
    rs = np.random.RandomState(seed)
    return np.where(rs.rand(B, 1, Lp, Lp) > 0.25, 0.0,
                    -10000.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the dropout hash
# ---------------------------------------------------------------------------

SEEDS = [0, 17, -5, 2 ** 31 - 1, -2 ** 31, 123456789]


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_dropout_keep_bit_equal_to_jax(rate):
    """(Lp, LG) lattice of the pair kernels, salt a global head, and the
    (B, L, H) lattice with dims=(1, 2) and a per-image salt."""
    for seed in SEEDS:
        su = jnp.int32(seed).astype(jnp.uint32)
        ref = np.asarray(JFA._dropout_keep(su, jnp.int32(7), rate,
                                           (80, 128)))
        out = TD.keep_mask(torch.arange(80).view(80, 1),
                           torch.arange(128).view(1, 128), seed, 7, rate)
        np.testing.assert_array_equal(out.numpy(), ref)
        shape = (3, 40, 48)
        img = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
        ref = np.asarray(JFA._dropout_keep(su, img * 2 + 1, rate, shape,
                                           dims=(1, 2)))
        out = TD.hidden_keep(seed, 1, rate, *shape)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert abs(out.float().mean().item() - (1 - rate)) < 0.05


# ---------------------------------------------------------------------------
# K8 forward and backward
# ---------------------------------------------------------------------------

def _slab(nh, hd, dtype, seed=1):
    rs = np.random.RandomState(seed)
    s = rs.randn(B, LP, 3 * nh * hd).astype(np.float32)
    g = rs.randn(B, LP, nh * hd).astype(np.float32)
    g[:, L:] = 0.0              # the caller's slice: padded rows get none
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return (jnp.asarray(s, jdt), jnp.asarray(g, jdt),
            torch.from_numpy(s).to(dtype), torch.from_numpy(g).to(dtype))


def _agree(out, ref, dtype, tol=2e-5):
    """f32: within tol of the output's scale; bf16: at least 99% of the
    values bit-equal (the roundings are the TPU kernels'; only f32 sums
    taken in another order can split a rare value by one ulp)."""
    ref = _j2t(ref, dtype)
    if dtype == torch.float32:
        scale = max(1.0, ref.abs().max().item())
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                                   atol=tol * scale)
    else:
        eq = (out == ref).float().mean().item()
        assert eq >= 0.99, eq
        np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                                   rtol=0, atol=2e-2 * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,hd", [(2, 64), (4, 32)])
@pytest.mark.parametrize("with_bias,rate", [(False, 0.0), (True, 0.0),
                                            (True, 0.1), (False, 0.1)])
def test_packed_attention_fwd_bwd_match_jax(dtype, nh, hd, with_bias, rate):
    """flash_fwd_packed_slab / flash_bwd_packed_slab (pair kernels at
    hd=64, per-head at hd=32) vs the port's attention / attention_bwd,
    l_actual < Lp, the same seed."""
    js, jg, ts, tg = _slab(nh, hd, dtype)
    seed = -123457
    jb = tb = None
    if with_bias:
        jb = jnp.asarray(_bias())
        tb = torch.from_numpy(_bias())
    ref = JFA.flash_fwd_packed_slab(js, jb, jnp.int32(seed), nh, True, rate,
                                    L)
    out = attention(ts, nh, L, tb, rate, seed)
    _agree(out[:, :L], np.asarray(ref, np.float32)[:, :L], dtype)
    rq, rk, rv = JFA.flash_bwd_packed_slab(js, jnp.int32(seed), jg, nh,
                                           True, rate, L, jb)
    dq, dk, dv = attention_bwd(ts, tg, nh, L, tb, rate, seed)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        _agree(got, np.asarray(want, np.float32), dtype)
    # padded query rows with a zero upstream gradient get none; padded
    # keys take none
    assert not dq[:, L:].float().abs().any()
    assert not dk[:, L:].float().abs().any()
    assert not dv[:, L:].float().abs().any()


# ---------------------------------------------------------------------------
# the train blocks
# ---------------------------------------------------------------------------

def _models(nh, hd):
    """A JAX param tree and the port model holding the same weights."""
    H = nh * hd
    kw = dict(hidden_size=H, intermediate_size=4 * H, num_attention_heads=nh)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0),
                                   jax_tiny_config(**kw)))
    # non-zero biases and LayerNorm shifts, so their gradients are tested
    rs = np.random.RandomState(11)
    flat = TB.flatten_params(params)
    for path, a in flat.items():
        if path.endswith("bias"):
            a[...] = rs.randn(*a.shape).astype(np.float32) * 0.05
    model = TB.load_jax_params(TM.ViTCAP(TC.tiny_config(**kw)), params)
    return params, model.requires_grad_(True)


def _assert_grads(model, prefix, jgrads, rtol, atol):
    """Every parameter gradient of the port under `prefix` (a JAX path)
    against the JAX gradient tree, through the bridge's naming/layout."""
    named = dict(model.named_parameters())
    flat = TB.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert flat
    for path, ref in flat.items():
        name, transform = TB.jax_path_to_torch_name(prefix + path)
        want = TB._apply_transform(np.asarray(ref, np.float32), transform)
        got = named[name].grad
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("nh,hd", [(2, 64), (4, 32)])
def test_split_vit_block_train_matches_jax(nh, hd):
    params, model = _models(nh, hd)
    jblk = params["encoder"]["blocks"][0]
    blk = model.bert.encoder.blocks[0]
    H, eps = nh * hd, 1e-6
    x = np.random.RandomState(3).randn(B, LP, H).astype(np.float32)
    x[:, L:] = np.random.RandomState(4).randn(B, LP - L, H)   # garbage rows

    def jloss(p, xx):
        o = JF.split_vit_block_train(p, xx, nh, eps, True, L)
        return jnp.sum(o[:, :L] ** 2), o
    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(jblk,
                                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TF.split_vit_block_train(blk, xt, nh, eps, L)
    np.testing.assert_allclose(out.detach().numpy()[:, :L],
                               np.asarray(jout)[:, :L], rtol=2e-5, atol=2e-5)
    (out[:, :L] ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=2e-4,
                               atol=2e-4)
    assert not xt.grad[:, L:].abs().any()
    _assert_grads(model, "encoder/blocks/0/", jgp, 2e-4, 2e-4)


@pytest.mark.parametrize("nh,hd,h_rate,a_rate", [(2, 64, 0.2, 0.1),
                                                 (4, 32, 0.2, 0.1),
                                                 (4, 32, 0.0, 0.0)])
def test_split_bert_layer_train_matches_jax(nh, hd, h_rate, a_rate):
    """Hidden and prob dropout with the same seeds: the masks are the same
    bits, so the deterministic tolerances of the JAX tests hold."""
    params, model = _models(nh, hd)
    jl = params["decoder"]["layer"][0]
    layer = model.bert.decoder.layer[0]
    H, eps = nh * hd, 1e-12
    x = np.random.RandomState(4).randn(B, LP, H).astype(np.float32)
    bias = _bias(13)
    seeds = (-7654321, 918273645)

    def jloss(p, xx):
        o = JF.split_bert_layer_train(p, xx, jnp.asarray(bias), nh, eps,
                                      True, L, h_rate, a_rate,
                                      jnp.asarray(seeds, jnp.int32))
        return jnp.sum(o[:, :L] ** 2), o
    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(jl,
                                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TF.split_bert_layer_train(layer, xt, torch.from_numpy(bias), nh,
                                    eps, L, h_rate, a_rate, seeds)
    np.testing.assert_allclose(out.detach().numpy()[:, :L],
                               np.asarray(jout)[:, :L], rtol=3e-5, atol=3e-5)
    (out[:, :L] ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy()[:, :L],
                               np.asarray(jgx)[:, :L], rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(xt.grad.numpy()[:, L:], 0.0, atol=1e-6)
    _assert_grads(model, "decoder/layer/0/", jgp, 3e-4, 3e-4)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_bias_requiring_grad_raises():
    """The attention bias is a mask: the TPU package returns a zero
    cotangent for it; the port refuses a bias that requires grad."""
    _, model = _models(2, 16)
    x = torch.randn(B, 64, 32)
    bias = torch.zeros(B, 1, 64, 64, requires_grad=True)
    with pytest.raises(ValueError, match="bias"):
        TF.split_bert_layer_train(model.bert.decoder.layer[0], x, bias, 2,
                                  1e-12)


def test_lp_past_1024_takes_the_plain_chain(monkeypatch):
    """takes_split_train routes a train call: the split train blocks up to
    1024 padded tokens, the plain chain past it, whose attention is
    flash_attention_packed on the pre-padded rows (the TPU package's
    vit_block / bert_layer gates).  fusion_decoder pads a train call to a
    multiple of 16 at any length (1100 -> 1104).  The split blocks called
    directly past 1024 still raise."""
    assert TF.pad_len(577) == 592 and TF.pad_len(1025) == 1152
    assert TF.takes_split_train(592) and TF.takes_split_train(1024)
    assert not any(TF.takes_split_train(L) for L in (48, 63, 577, 1040,
                                                     1104, 1152))
    calls = []
    packed = TL.flash_attention_packed

    def counting(q, k, v, bias, seed, nh, rate=0.0, l_actual=0,
                 salt_heads=(0, 0)):
        calls.append((tuple(q.shape), bias is not None, l_actual))
        return packed(q, k, v, bias, seed, nh, rate, l_actual, salt_heads)
    monkeypatch.setattr(TL, "flash_attention_packed", counting)
    _, model = _models(2, 16)
    blk = model.bert.encoder.blocks[0]
    x = torch.randn(1, 1040, 32, requires_grad=True)
    out = TL.vit_block(blk, x, 2, 1e-6, l_actual=1030)
    assert calls == [((1, 1040, 32), False, 1030)]
    (out[:, :1030] ** 2).sum().backward()
    assert blk.attn.qkv.weight.grad is not None
    assert not x.grad[:, 1030:].abs().any()
    calls.clear()
    cfg = TC.tiny_config(hidden_size=32, num_attention_heads=2,
                         intermediate_size=128)
    seq = torch.randn(1, 1100, 32)
    bias = torch.zeros(1, 1, 1100, 1100)
    hidden = TM.fusion_decoder(model, seq, bias, cfg)
    assert hidden.shape == (1, 1100, 32)
    assert calls == [((1, 1104, 32), True, 1100)] * cfg.decoder_layers
    with pytest.raises(NotImplementedError):
        TF.split_vit_block_train(blk, torch.randn(1, 1040, 32), 2, 1e-6)
    with pytest.raises(NotImplementedError):
        TF.split_bert_layer_train(model.bert.decoder.layer[0],
                                  torch.randn(1, 1104, 32),
                                  torch.zeros(1, 1, 1104, 1104), 2, 1e-12,
                                  1100)


def test_inference_blocks_raise_under_grad():
    """fused_vit_block / fused_bert_block launch kernels with no backward:
    under grad with parameters or input requiring grad they raise instead
    of dropping the gradients; without grad they run."""
    _, model = _models(2, 16)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    x = torch.randn(B, 64, 32)
    bias = torch.zeros(B, 1, 64, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        TF.fused_vit_block(blk, x, 2, 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        TF.fused_bert_block(layer, x, bias, 2, 1e-12)
    model.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        TF.fused_vit_block(blk, x.clone().requires_grad_(True), 2, 1e-6)
    with torch.no_grad():
        model.requires_grad_(True)
        assert TF.fused_vit_block(blk, x, 2, 1e-6).shape == x.shape
        assert TF.fused_bert_block(layer, x, bias, 2, 1e-12).shape == x.shape
