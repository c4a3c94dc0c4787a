"""vitcap_tpu_torch flash_attention (K9) and mha's routing vs the JAX package.

flash_attention is the port of vitcap_tpu/ops/flash_attention.py:846
flash_attention: per-head (B, nH, L, dh) attention with a bias that is
None, (B, 1, L, L) or per head (B, nH, L, L).  The JAX side runs its
Pallas kernels in interpret mode (interpret=True, or VITCAP_PALLAS=
interpret for mha); the port's CPU tensors run the kernels' plain
versions.  Up to 1024 padded tokens (round_up(L, 128)) the JAX forward is
its one-pass kernel and the backward its one-pass kernel with a zero bias
cotangent; past 1024 the forward is its q-tiled online softmax (q
pre-scaled in its dtype) and the backward the VJP of the f32 XLA attention,
with the true bias gradient.  Both lengths are held here.

Tolerances: f32 within 1e-4 of the reference's scale; bf16 within 2e-2 of
it and, where both sides round at the same points, at least 99% of the
values bit-equal (only f32 sums taken in another order can split a value
by one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import layers as JL
from vitcap_tpu.ops import flash_attention as JFA

from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.ops import flash_attention as TFA
from vitcap_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_plain,
                                                  takes_online)

B = 2


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _j2t(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _agree(out, ref, dtype, bits=True):
    """f32: within 1e-4 of ref's scale (at least 1e-4); bf16: within 2e-2
    of it and, with `bits`, at least 99% of the values bit-equal."""
    ref = _j2t(ref, dtype)
    out = out.detach()
    assert out.shape == ref.shape
    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        tol = 1e-4 * max(1.0, scale)
    else:
        tol = 2e-2 * scale
        if bits:
            eq = (out == ref).float().mean().item()
            assert eq >= 0.99, eq
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)


def _inputs(L, nh, hd, bias_kind, seed):
    """q, k, v (B, nh, L, hd) and a bias: None, 'bcast' (B, 1, L, L) or
    'head' (B, nh, L, L), a -10000 mask mixed with small values, every row
    keeping key 0."""
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(B, nh, L, hd).astype(np.float32)
                  for _ in range(4))
    bias = None
    if bias_kind is not None:
        heads = 1 if bias_kind == "bcast" else nh
        bias = np.where(rs.rand(B, heads, L, L) > 0.2, 0.0, -10000.0)
        bias = (bias + rs.randn(B, heads, L, L) * 0.5).astype(np.float32)
        bias[..., 0] = 0.0
    return q, k, v, g, bias


def test_takes_online_is_the_tpu_padded_length_rule():
    """K9 pads L to round_up(L, 128) and takes its q-tiled kernel past
    1024: L 1024 is one-pass, 1025 online."""
    assert not takes_online(72) and not takes_online(1024)
    assert takes_online(1025) and takes_online(1030)


# (L, head dim): one-pass at L 72 and 577 (padded to 128 and 640 on the
# TPU), the online kernel at 1030 (padded to 1152); head dim 32 past 1024
# pins the q pre-scale's bf16 rounding (2^-2.5 is not a power of two)
FWD_CASES = [(72, 64), (577, 32), (1030, 32), (1030, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_kind", [None, "bcast", "head"])
@pytest.mark.parametrize("L,hd", FWD_CASES)
def test_flash_attention_forward_matches_jax(L, hd, bias_kind, dtype):
    nh = 2
    q, k, v, _, bias = _inputs(L, nh, hd, bias_kind, L + hd)
    jdt = _jdt(dtype)
    ref = JFA.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              None if bias is None else jnp.asarray(bias),
                              True)
    tb = None if bias is None else torch.from_numpy(bias)
    out = flash_attention(*(torch.from_numpy(a).to(dtype)
                            for a in (q, k, v)), tb)
    assert out.dtype == dtype
    _agree(out, ref, dtype)


def test_online_mode_is_not_the_one_pass_function():
    """Past 1024 in bf16 at head dim 32 the online function (pre-scaled
    q, per-tile rounded probabilities) and the one-pass function differ,
    so the forward test above pins which one the port computes."""
    from vitcap_tpu_torch.ops.attention import attention_heads_plain
    q, k, v, _, _ = _inputs(1030, 2, 32, None, 5)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    online = attention_heads_plain(*args, 1030, online=True)
    one_pass = attention_heads_plain(*args, 1030)
    assert (online != one_pass).float().mean().item() > 0.05


# (L, head dim, bias kind): the one-pass backward (zero bias cotangent)
# and, past 1024, the f32 VJP with the true bias gradient
BWD_CASES = [(72, 64, "bcast"), (577, 32, "head"), (577, 64, None),
             (1030, 32, "head"), (1030, 64, "bcast"), (1030, 64, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,hd,bias_kind", BWD_CASES)
def test_flash_attention_grads_match_jax(L, hd, bias_kind, dtype):
    """dq, dk, dv and the bias gradient against jax.vjp of
    flash_attention(interpret=True): the bias gradient is exactly zero up
    to 1024 padded tokens and the true gradient past it (the TPU
    function's length-dependent rule)."""
    nh = 2
    q, k, v, g, bias = _inputs(L, nh, hd, bias_kind, 3 * L + hd)
    jdt = _jdt(dtype)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    if bias is None:
        _, vjp = jax.vjp(lambda a, b, c: JFA.flash_attention(a, b, c, None,
                                                             True), *jargs)
    else:
        _, vjp = jax.vjp(lambda a, b, c, d: JFA.flash_attention(a, b, c, d,
                                                                True),
                         *jargs, jnp.asarray(bias))
    jgrads = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (q, k, v)]
    tb = None
    if bias is not None:
        tb = torch.from_numpy(bias).requires_grad_(True)
    out = flash_attention(*leaves, tb)
    out.backward(torch.from_numpy(g).to(dtype))
    # past 1024 both sides differentiate the f32 attention, which rounds
    # nowhere the kernels round: hold bf16 to the scale only there
    bits = not takes_online(L)
    for t, want in zip(leaves, jgrads):
        _agree(t.grad, want, dtype, bits)
    if bias is not None:
        if takes_online(L):
            assert np.abs(np.asarray(jgrads[3])).max() > 0
            _agree(tb.grad, jgrads[3], torch.float32)
        else:
            assert not np.asarray(jgrads[3]).any()
            assert tb.grad is not None and not tb.grad.any()


def test_flash_attention_on_cpu_is_its_plain_version():
    """CPU tensors run the plain versions: flash_attention and
    flash_attention_plain agree bit for bit, forward and backward, at both
    lengths; a (1, 1, L, L) bias broadcasts over the batch; a bias of the
    wrong shape raises."""
    for L in (80, 1030):
        q, k, v, g, bias = _inputs(L, 2, 32, "bcast", L)
        outs = []
        for fn in (flash_attention, flash_attention_plain):
            leaves = [torch.from_numpy(a).bfloat16().requires_grad_(True)
                      for a in (q, k, v)]
            o = fn(*leaves, torch.from_numpy(bias[:1]))
            o.backward(torch.from_numpy(g).bfloat16())
            outs.append([o] + [t.grad for t in leaves])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bias"):
        flash_attention(*(torch.zeros(B, 2, 80, 32) for _ in range(3)),
                        torch.zeros(B, 3, 80, 80))


# ---------------------------------------------------------------------------
# mha: which route each call takes
# ---------------------------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    """Counts mha's calls of flash_attention and flash_attention_packed."""
    seen = {"flash": 0, "packed": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(TL, "flash_attention",
                        spy("flash", TFA.flash_attention))
    monkeypatch.setattr(TL, "flash_attention_packed",
                        spy("packed", TFA.flash_attention_packed))
    return seen


def test_mha_routes_like_the_tpu_package(routes):
    """A self-attention with no gradient (Lq == Lk >= 64, no dropout) takes
    flash_attention with any bias; a train call with no bias or a
    head-broadcast one the packed route; a train call with a per-head bias,
    fewer than 64 tokens, cross-attention and generator dropout the plain
    attention."""
    nh, H = 2, 64
    rs = np.random.RandomState(0)

    def qkv(L, Lk=None, grad=False):
        return [torch.from_numpy(rs.randn(B, n, H).astype(np.float32))
                .requires_grad_(grad) for n in (L, Lk or L, Lk or L)]

    def bias(L, heads):
        return torch.zeros(B, heads, L, L)

    def expect(flash, packed):
        assert (routes["flash"], routes["packed"]) == (flash, packed)
        routes["flash"] = routes["packed"] = 0

    for b in (None, bias(72, 1), bias(72, nh)):
        TL.mha(*qkv(72), nh, b)
        expect(1, 0)
    TL.mha(*qkv(1030), nh, bias(1030, nh))
    expect(1, 0)
    with torch.no_grad():                     # grad mode off: inference
        TL.mha(*qkv(72, grad=True), nh)
    expect(1, 0)
    TL.mha(*qkv(72, grad=True), nh)
    expect(0, 1)
    TL.mha(*qkv(72, grad=True), nh, bias(72, 1))
    expect(0, 1)
    TL.mha(*qkv(72, grad=True), nh, bias(72, nh))        # per-head bias
    expect(0, 0)
    TL.mha(*qkv(48), nh)                                 # L < 64
    expect(0, 0)
    TL.mha(*qkv(1, 72), nh)                              # Lq != Lk
    expect(0, 0)
    TL.mha(*qkv(72), nh, dropout_rate=0.1,
           generator=torch.Generator().manual_seed(0))
    expect(0, 0)
    TL.mha(*qkv(72), nh, dropout_rate=0.1)      # no generator: no dropout
    expect(1, 0)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's kernel routes (VITCAP_PALLAS=interpret): its mha
    sends a self-attention without dropout to flash_attention."""
    monkeypatch.setenv("VITCAP_PALLAS", "interpret")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,bias_kind", [(80, "head"), (1030, "bcast")])
def test_mha_inference_matches_jax_flash_route(jax_kernels, routes, L,
                                               bias_kind, dtype):
    """Non-train mha against JAX's mha with its kernels engaged, on both
    sides of 1024: one flash_attention call, the JAX values (bf16 at
    least 99% bit-equal)."""
    nh, hd = 2, 32
    q, k, v, _, bias = _inputs(L, nh, hd, bias_kind, 7 * L)

    def packed(a):                      # (B, nh, L, hd) -> (B, L, H)
        return np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(
            B, L, nh * hd)
    jdt = _jdt(dtype)
    ref = JL.mha(*(jnp.asarray(packed(a), jdt) for a in (q, k, v)), nh,
                 jnp.asarray(bias))
    out = TL.mha(*(torch.from_numpy(packed(a)).to(dtype)
                   for a in (q, k, v)), nh, torch.from_numpy(bias))
    assert routes["flash"] == 1 and routes["packed"] == 0
    _agree(out, ref, dtype)


def test_blocks_route_inference_attention_to_flash(jax_kernels, routes):
    """The two model callers of mha's inference route: a vit_block called
    with a bias and a bert_layer called without one, with no gradient,
    each make exactly one flash_attention call and match the JAX blocks
    under their kernel routes (f32, 2 heads of 64, L 80)."""
    from vitcap_tpu.models import vitcap as JM
    from vitcap_tpu.models.config import tiny_config as jax_tiny_config
    from vitcap_tpu_torch.models import config as TC
    from vitcap_tpu_torch.models import vitcap as TM
    from vitcap_tpu_torch.solver.checkpoint_bridge import load_jax_params
    kw = dict(hidden_size=128, intermediate_size=512, num_attention_heads=2)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                   jax_tiny_config(**kw)))
    model = load_jax_params(TM.ViTCAP(TC.tiny_config(**kw)), params)
    rs = np.random.RandomState(9)
    L = 80
    x = rs.randn(B, L, 128).astype(np.float32)
    _, _, _, _, bias = _inputs(L, 2, 64, "head", 11)
    ref = JL.vit_block(params["encoder"]["blocks"][0], jnp.asarray(x), 2,
                       1e-6, jnp.asarray(bias))
    with torch.no_grad():
        out = TL.vit_block(model.bert.encoder.blocks[0], torch.from_numpy(x),
                           2, 1e-6, torch.from_numpy(bias))
    assert routes["flash"] == 1 and routes["packed"] == 0
    _agree(out, ref, torch.float32)
    ref = JL.bert_layer(params["decoder"]["layer"][0], jnp.asarray(x), None,
                        2, 1e-12)
    with torch.no_grad():
        out = TL.bert_layer(model.bert.decoder.layer[0], torch.from_numpy(x),
                            None, 2, 1e-12)
    assert routes["flash"] == 2 and routes["packed"] == 0
    _agree(out, ref, torch.float32)
