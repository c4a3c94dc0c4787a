"""decode_attention's cluster plan and order of sums, and the LayerNorm
kernel's paths, on the CPU.

ops.decode_step.plan(S, nb, hd, A) picks, from the shape alone, the bf16
kernel (csrc/decode_attention.cu): decode_attention_cluster_kernel with
clusters of `ranks` blocks along the context (rank q the keys [q kpr,
(q + 1) kpr), the last rank the rest and the caption), or the simple kernel.
split_order() renders the cluster kernel's arithmetic in torch, lane by
lane: each score a chain of f32 adds per lane over its 16-byte units of
the head dim, the four lanes joined as the two shuffles join them; every
probability exp(s - m) against the global max of the row, rounded once;
per rank an f32 partial P.V and denominator; the partials and
denominators summed in rank order.  Its scores and bf16 probabilities
must be bit-equal to decode_attention_plain's, at least 99% of its bf16
outputs too (the f32 outputs within 1e-5 of their scale), and a fused
decode step built on it must agree with the JAX package's
fused_decode_step (interpret mode) within tests/test_torch_decode.py's
tolerance.  The CUDA kernels themselves are
held to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

layer_norm: ops.layer_norm.vector_path(H, ...) chooses between the
kernel's registers-and-16-byte-accesses loop and its scalar loop;
ln_order() renders the vector loop's order of f32 sums (a lane's chunks,
then the warp's butterfly) against layer_norm_plain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.ops import decode_step as JDS

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops import decode_step as TDS
from vitcap_tpu_torch.ops import layer_norm as TLN
from vitcap_tpu_torch.ops.gemm import gemm_plain
from vitcap_tpu_torch.solver import checkpoint_bridge as TB

A = 20                                   # the flagship's caption slots
FLAGSHIP_RANKS = {(628, 1): 5, (628, 3): 5, (628, 8): 6,
                  (1076, 1): 8, (1076, 3): 8, (1076, 8): 8}


def _rank_ranges(S, p):
    """[(lo, hi)] of each rank's context keys."""
    ranges = []
    for q in range(p.ranks):
        lo = min(S, q * p.keys_per_rank)
        hi = S if q == p.ranks - 1 else min(S, lo + p.keys_per_rank)
        ranges.append((lo, hi))
    return ranges


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,nb", sorted(FLAGSHIP_RANKS))
def test_plan_at_flagship_shapes(S, nb, hd):
    """4-6 ranks at 384 px (S 628), 8 at 512 px (S 1076); every rank
    near 144 keys; the ranges cover the context once; the caption sits on
    the last rank; the shared buffers hold every rank's keys and fit."""
    p = TDS.plan(S, nb, hd, A)
    assert p.ranks == FLAGSHIP_RANKS[S, nb]
    ranges = _rank_ranges(S, p)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    counts = [hi - lo for lo, hi in ranges]
    counts[-1] += nb * A
    assert max(counts) <= p.keys_max and p.keys_max % TDS.KEY_GROUP == 0
    assert p.keys_max - max(counts) < TDS.KEY_GROUP
    assert 100 <= p.keys_per_rank <= 160
    assert (p.smem == TDS.cluster_smem(hd, nb, p.keys_max, p.ranks)
            <= TDS.SMEM_LIMIT)
    # 4 blocks of the flagship's shape share an SM (1 KB reserved each)
    if hd == 64 and nb <= 3:
        assert 4 * (p.smem + 1024) <= 233472


def test_plan_edges():
    """Short contexts take one or two ranks; more than 4 beams more tiles
    of 8 rows; more than 16 beams groups of at most 16; f32, the small head
    dims and contexts past the block's shared memory the simple kernel."""
    assert TDS.plan(13, 3, 64, 6).ranks == 1             # S < 64
    assert TDS.plan(40, 1, 128, 6).ranks == 1
    p = TDS.plan(70, 10, 64, 6)                          # 20 window rows
    assert p.ranks == 1
    assert p.smem == TDS.cluster_smem(64, 10, p.keys_max, p.ranks)
    assert [TDS.row_tiles(nb) for nb in (1, 4, 5, 8, 9, 16, 17)] == [
        1, 1, 2, 2, 4, 4, 0]
    assert TDS.cluster_smem(64, 10, 144, 5) > TDS.cluster_smem(64, 8, 144, 5)
    # more than 16 beams: groups of the largest divisor up to 16, each a
    # launch row of the cluster kernel (a prime count: groups of one)
    p = TDS.plan(100, 17, 64, 6)
    assert p.ranks == 1 and p.groups == 17
    assert p.smem == TDS.cluster_smem(64, 1, p.keys_max, p.ranks)
    assert TDS.plan(628, 160, 64, A)[:4] == TDS.plan(628, 16, 64, A)[:4]
    assert TDS.plan(628, 160, 64, A).groups == 10
    assert TDS.plan(2000, 4, 64, A).ranks == 8           # 260 keys a rank
    assert TDS.plan(628, 3, 64, A, torch.float32).ranks == 0
    for hd in (8, 16, 32):
        assert TDS.plan(628, 3, hd, A).ranks == 0
    assert TDS.plan(6000, 1, 64, A).ranks == 0
    # the layout's size by hand: K, V rows of 72 elements, 8 f32 q rows
    # and the MASK rows' k and v, 144 biases, 8 rows of 148 f32 scores, 16 of
    # 152 bf16 probabilities, 16 statistics a row, two mbarriers; the K
    # rows' bytes hold the 7 other ranks' pushed partials (6 x 64 outputs
    # and 6 sums each), more bytes than the K rows when they outgrow them
    assert TDS.cluster_smem(64, 3, 144, 8) == (2 * 144 * 72 * 2 + 8 * 64 * 4
                                               + 8 * 64 * 2 + 144 * 4
                                               + 8 * 148 * 4 + 16 * 152 * 2
                                               + 8 * 16 * 4 + 16)
    assert 7 * 6 * 65 * 4 <= 144 * 72 * 2
    assert (TDS.cluster_smem(128, 16, 16, 8) - TDS.cluster_smem(128, 16, 16, 1)
            == 7 * 32 * 129 * 4 - 16 * 136 * 2)


def test_plan_is_monotone_in_the_context():
    """More context never takes fewer ranks (until the cap of 8), and the
    caption's slots count as keys."""
    last = 0
    for S in range(1, 2200, 37):
        p = TDS.plan(S, 3, 64, A)
        assert p.ranks >= last
        last = p.ranks
    assert TDS.plan(600, 8, 64, A).ranks > TDS.plan(600, 1, 64, A).ranks


# ---------------------------------------------------------------------------
# the cluster kernel's order of sums
# ---------------------------------------------------------------------------

def lane_dot(a, b, rounded=None):
    """decode_attention_cluster_kernel's score of every a row (..., M, hd)
    against every b row (..., N, hd) -> (..., M, N) f32: lane j of the
    four a key takes the 16-byte units j, j + 4, ... of the head dim and
    chains f32 FMAs from 0 over their products (exact for bf16 values, so
    an add of the product); the shuffle over lanes 8 apart adds the
    partner's sum to its own, then over lanes 16 apart.  rounded: a dtype
    the products are rounded to first (the MASK row's own score; M = N
    and the rows taken pairwise)."""
    hd = a.shape[-1]
    lanes = []
    for j in range(4):
        acc = torch.zeros(())
        for u in range(j, hd // 8, 4):
            for e in range(8):
                d = 8 * u + e
                if rounded is not None:
                    x = (a[..., d] * b[..., d]).to(rounded).float()
                else:
                    x = a[..., :, None, d].float() * b[..., None, :, d].float()
                acc = acc + x
        lanes.append(acc)
    x8 = [lanes[j] + lanes[j ^ 1] for j in range(4)]     # lanes 8 apart
    return x8[0] + x8[2]                                 # lanes 16 apart


def split_scores(qkv, cap_k, ctx_k, ctx_bias, t, num_heads):
    """The cluster kernel's scores (s_cap, s_self, s_ctx) in the shapes of
    decode_scores_plain, cap_k holding slot t-1."""
    Bb, W, H3 = qkv.shape
    H = H3 // 3
    B, S, _ = ctx_k.shape
    nb = Bb // B
    hd = H // num_heads
    q, kw, _ = qkv.split(H, dim=-1)

    def heads(a):                                  # (N, L, H) -> (N, h, L, d)
        return a.reshape(a.shape[0], a.shape[1], num_heads, hd).transpose(1, 2)

    qs = heads(q) * torch.tensor(hd ** -0.5, dtype=qkv.dtype)
    s_cap = lane_dot(qs, heads(cap_k[:, :t]))
    s_self = lane_dot(qs, heads(kw[:, 1:2]).expand_as(qs),
                      rounded=qkv.dtype)
    s_self = s_self[..., None].clone()
    s_self[:, :, 0] = float("-inf")
    kx = heads(ctx_k)
    s_ctx = torch.stack([lane_dot(qs[i], kx[i // nb]) for i in range(Bb)])
    s_ctx = s_ctx + ctx_bias.repeat_interleave(nb, 0)[:, None, None, :]
    return s_cap, s_self, s_ctx


def split_order(qkv, cap_k, cap_v, ctx_k, ctx_v, ctx_bias, t, num_heads,
                p=None, parts=None):
    """decode_attention_plain's function in decode_attention_cluster_
    kernel's order: its scores (split_scores); one global max a row over
    the caption, the MASK row's own term and the context; per rank the f32
    partial P.V of its rounded probabilities and the sum of their f32
    values (the last rank with the caption and the MASK term); partials
    and sums added in rank order.  p: the plan (default: plan() at hd 64,
    whatever the head dim).  parts: a dict that receives the scores and
    the unrounded f32 probabilities."""
    Bb, W, H3 = qkv.shape
    H = H3 // 3
    B, S, _ = ctx_k.shape
    nb = Bb // B
    hd = H // num_heads
    A_ = cap_k.shape[1]
    t = int(t)
    dt = qkv.dtype
    p = p or TDS.plan(S, nb, 64, A_)
    q, kw, vw = qkv.split(H, dim=-1)
    cap_k[:, t - 1] = kw[:, 0]
    cap_v[:, t - 1] = vw[:, 0]

    def heads(a):                                  # (N, L, H) -> (N, h, L, d)
        return a.reshape(a.shape[0], a.shape[1], num_heads, hd).transpose(1, 2)

    s_cap, s_self, s_ctx = split_scores(qkv, cap_k, ctx_k, ctx_bias, t,
                                        num_heads)
    vx = heads(ctx_v).float()
    m = torch.maximum(torch.maximum(s_cap.amax(-1, keepdim=True),
                                    s_ctx.amax(-1, keepdim=True)), s_self)
    if parts is not None:
        parts.update(s_cap=s_cap, s_self=s_self, s_ctx=s_ctx,
                     p_cap=torch.exp(s_cap - m), p_self=torch.exp(s_self - m),
                     p_ctx=torch.exp(s_ctx - m))
    o_sum = l_sum = None
    for q_, (lo, hi) in enumerate(_rank_ranges(S, p)):
        pc = torch.exp(s_ctx[..., lo:hi] - m)
        o = torch.einsum("bjhws,bhsd->bjhwd",
                         pc.to(dt).float().reshape(B, nb, num_heads, W,
                                                   hi - lo),
                         vx[:, :, lo:hi]).reshape(Bb, num_heads, W, hd)
        l = pc.sum(-1, keepdim=True)
        if q_ == p.ranks - 1:
            pa = torch.exp(s_cap - m)
            pe = torch.exp(s_self - m)
            o = o + pa.to(dt).float() @ heads(cap_v[:, :t]).float()
            o = o + pe * heads(vw[:, 1:2]).float()
            l = l + pa.sum(-1, keepdim=True) + pe
        o_sum = o if o_sum is None else o_sum + o
        l_sum = l if l_sum is None else l_sum + l
    out = (o_sum / l_sum).to(dt)
    return out.transpose(1, 2).reshape(Bb, W, H)


def _inputs(dtype, B, nb, nh, hd, S, A_, seed):
    rs = np.random.RandomState(seed)
    H = nh * hd

    def rnd(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    valid = rs.rand(B, S) > 0.3
    valid[:, -1] = True
    bias = torch.where(torch.from_numpy(valid), 0.0,
                       TDS.NEG_MASK_VALUE).float()
    return dict(qkv=rnd(B * nb, 2, 3 * H), cap_k=rnd(B * nb, A_, H),
                cap_v=rnd(B * nb, A_, H), ctx_k=rnd(B, S, H),
                ctx_v=rnd(B, S, H), bias=bias)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,nb", [(70, 1), (70, 10), (628, 3), (1076, 1),
                                  (2000, 4)])
def test_split_order_matches_plain(dtype, hd, S, nb):
    """The rank-order sums against decode_attention_plain at every rank
    count plan() takes here (1, 2, 5, 8), one to ten beams, t at both ends
    and between: bf16 at least 99% bit-equal, f32 within 1e-5 of the
    output's scale; the caption caches equal."""
    B, nh = 2, 2
    ranks = TDS.plan(S, nb, hd, A).ranks
    assert ranks >= 1
    for t in (1, 7, A):
        d = _inputs(dtype, B, nb, nh, hd, S, A, seed=S + nb + t)
        caps = [d["cap_k"].clone(), d["cap_v"].clone()]
        args = (d["ctx_k"], d["ctx_v"], d["bias"], t, nh)
        ref = TDS.decode_attention_plain(d["qkv"], d["cap_k"], d["cap_v"],
                                         *args)
        out = split_order(d["qkv"], *caps, *args,
                          p=TDS.plan(S, nb, hd, A))
        assert torch.equal(caps[0], d["cap_k"])
        assert torch.equal(caps[1], d["cap_v"])
        assert torch.isfinite(out.float()).all()
        if dtype == torch.bfloat16:
            same = (out == ref).float().mean().item()
            assert same >= 0.99, (t, same)
        else:
            scale = ref.abs().max().item()
            err = (out - ref).abs().max().item()
            assert err <= 1e-5 * scale, (t, err, scale)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,nb,t", [(70, 1, 1), (70, 3, 6), (628, 3, 20),
                                    (300, 10, 7)])
def test_split_order_scores_and_probabilities_bit_equal(hd, S, nb, t):
    """bf16: the cluster kernel's scores (caption, the MASK row's own,
    context) and its bf16 probabilities, rendered lane by lane, are
    bit-equal to decode_attention_plain's (decode_scores_plain, then
    torch.exp against the row max), every call size and t: F9's
    precondition that the two round each probability alike."""
    B, nh = 3, 2
    d = _inputs(torch.bfloat16, B, nb, nh, hd, S, A, seed=S + nb + t + hd)
    H = nh * hd
    q, kw, vw = d["qkv"].split(H, dim=-1)
    cap_k = d["cap_k"].clone()
    cap_k[:, t - 1] = kw[:, 0]
    plain = TDS.decode_scores_plain(q, kw, cap_k, d["ctx_k"], d["bias"], t,
                                    nh)
    parts = {}
    split_order(d["qkv"], d["cap_k"].clone(), d["cap_v"].clone(),
                d["ctx_k"], d["ctx_v"], d["bias"], t, nh,
                p=TDS.plan(S, nb, hd, A), parts=parts)
    for name, ref in zip(("s_cap", "s_self", "s_ctx"), plain):
        assert torch.equal(parts[name], ref), name
    m = torch.maximum(torch.maximum(plain[0].amax(-1, keepdim=True),
                                    plain[2].amax(-1, keepdim=True)),
                      plain[1])
    for name, s in zip(("p_cap", "p_self", "p_ctx"), plain):
        ref = torch.exp(s - m)
        assert torch.equal(parts[name], ref), name
        assert torch.equal(parts[name].to(torch.bfloat16),
                           ref.to(torch.bfloat16)), name


@pytest.fixture(scope="module", params=[64, 128], ids=["hd64", "hd128"])
def models(request):
    """JAX and port weights of a tiny config with 2 heads of hd."""
    hd = request.param
    kw = dict(hidden_size=2 * hd, num_attention_heads=2,
              intermediate_size=4 * hd)
    jcfg = jax_tiny_config(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    model = TB.load_jax_params(TM.ViTCAP(TC.tiny_config(**kw)), params)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_order_step_matches_jax(models, dtype):
    """One fused step of both decoder layers with the attention in the
    cluster kernel's order (the gemm and LayerNorm plain) vs the JAX
    package's fused_decode_step in interpret mode: nb=3 beams, a context
    split over two ranks, history in the caption caches; f32 within 1e-5,
    bf16 within 2e-2 of the scale (tests/test_torch_decode.py)."""
    jcfg, params, model = models
    H, nL, nh = jcfg.hidden_size, jcfg.decoder_layers, jcfg.num_attention_heads
    B, nb, S, A_, t = 2, 3, 300, 6, 4
    Bb = B * nb
    assert TDS.plan(S, nb, H // nh, A_).ranks == 3
    rs = np.random.RandomState(1)
    x = rs.randn(Bb, 2, H).astype(np.float32)
    ck = [rs.randn(B, S, H).astype(np.float32) for _ in range(nL)]
    cv = [rs.randn(B, S, H).astype(np.float32) for _ in range(nL)]
    valid = rs.rand(B, S) > 0.3
    valid[:, -1] = True
    cap_k = rs.randn(nL, Bb, A_, H).astype(np.float32)
    cap_v = rs.randn(nL, Bb, A_, H).astype(np.float32)

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    kp, vp, cb = JDS.pack_decode_context(
        [jnp.asarray(a, jdt) for a in ck], [jnp.asarray(a, jdt) for a in cv],
        jnp.asarray(valid))
    rx, rk, rv = JDS.fused_decode_step(
        JDS.pack_decode_layers(params, jdt), kp, vp, cb,
        jnp.asarray(cap_k, jdt), jnp.asarray(cap_v, jdt),
        jnp.asarray(x, jdt), jnp.int32(t), num_heads=nh,
        eps=jcfg.bert_layer_norm_eps, interpret=True)

    def tt(a):
        return torch.from_numpy(a).to(tdt)
    k, v, bias = TDS.pack_decode_context([tt(a) for a in ck],
                                         [tt(a) for a in cv],
                                         torch.from_numpy(valid))
    tk, tv = tt(cap_k), tt(cap_v)
    out = TDS._step((gemm_plain, split_order, TLN.layer_norm_plain),
                    TDS.pack_decode_layers(model, tdt), k, v, bias, tk, tv,
                    tt(x), t, nh, jcfg.bert_layer_norm_eps)
    for name, got, ref in (("x", out, rx), ("cap_k", tk, rk),
                           ("cap_v", tv, rv)):
        got = got.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                       err_msg=name)
        else:
            scale = np.abs(ref).max()
            err = np.abs(got - ref).max()
            assert err <= 2e-2 * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# layer_norm
# ---------------------------------------------------------------------------

def test_layer_norm_vector_path_by_width():
    """The registers-and-16-byte-accesses loop takes H a multiple of 8 up
    to 1024 on 16-byte aligned tensors (the port's 768 and the tests'
    small widths); any other H or an unaligned view the scalar loop."""
    def t(n):
        return torch.zeros(n)
    for H in (8, 32, 128, 136, 768, 1024):
        assert TLN.vector_path(H, t(H), t(H))
    for H in (1, 7, 12, 100, 770, 1032, 2048):
        assert not TLN.vector_path(H, t(H), t(H))
    x = torch.zeros(4, 769)
    assert not TLN.vector_path(768, x[:, 1:], t(768))     # 4 bytes off


def test_layer_norm_argument_errors():
    """check_args: x (rows, H) contiguous f32 or bf16, scale and shift
    (H,); the CUDA wrapper raises ValueError for anything else, and a
    device without a kernel raises RuntimeError."""
    w = torch.ones(16)
    assert TLN.check_args(torch.zeros(5, 16), w, w) == (5, 16)
    assert TLN.check_args(torch.zeros(3, 16, dtype=torch.bfloat16), w,
                          w) == (3, 16)
    for x, g in ((torch.zeros(2, 5, 16), w),               # not 2-D
                 (torch.zeros(16, 5).t(), torch.ones(5)),  # not contiguous
                 (torch.zeros(5, 16, dtype=torch.float16), w),
                 (torch.zeros(5, 16), torch.ones(15))):
        with pytest.raises(ValueError):
            TLN.check_args(x, g, torch.zeros(g.shape))
    with pytest.raises(RuntimeError):
        TLN.layer_norm(torch.empty(4, 16, device="meta"), w, w, 1e-6,
                       torch.float32)


def ln_order(x, weight, bias, eps, out_dtype):
    """layer_norm_kernel's vector loop in torch: lane l holds the V-value
    chunks l, l + 32, ... (V = 8 when input and output are bf16, else 4);
    its sums run over its chunks in order, then a butterfly over the warp
    (xor 16, 8, 4, 2, 1); the variance the same over (x - mean)^2."""
    rows, H = x.shape
    V = 8 if x.dtype == out_dtype == torch.bfloat16 else 4
    xf = x.float()
    chunks = xf.view(rows, H // V, V)

    def warp_sum(v):                         # v: (rows, H // V, V)
        lanes = torch.zeros(rows, 32)
        for c in range(H // V):
            for e in range(V):
                lanes[:, c % 32] = lanes[:, c % 32] + v[:, c, e]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, torch.arange(32) ^ o]
        return lanes[:, :1]
    mean = warp_sum(chunks) / H
    var = warp_sum((chunks - mean[..., None]).square()) / H
    rstd = 1.0 / torch.sqrt(var + eps)
    return ((xf - mean) * rstd * weight + bias).to(out_dtype)


@pytest.mark.parametrize("H", [64, 136, 768])
@pytest.mark.parametrize("in_dt,out_dt",
                         [(torch.float32, torch.float32),
                          (torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.bfloat16),
                          (torch.bfloat16, torch.float32)])
def test_layer_norm_vector_order_matches_plain(H, in_dt, out_dt):
    """The vector loop's order of f32 sums against layer_norm_plain:
    bf16 outputs at least 99% bit-equal, f32 within 1e-5 of the scale."""
    rs = np.random.RandomState(H)
    x = torch.from_numpy((rs.randn(37, H) * 3 + 1).astype(np.float32)) \
        .to(in_dt)
    w = torch.from_numpy(rs.randn(H).astype(np.float32)) + 1
    b = torch.from_numpy(rs.randn(H).astype(np.float32))
    assert TLN.vector_path(H, x, w, b)
    out = ln_order(x, w, b, 1e-6, out_dt)
    ref = TLN.layer_norm(x, w, b, 1e-6, out_dt)            # CPU: plain
    if out_dt == torch.bfloat16:
        assert (out == ref).float().mean().item() >= 0.99
    else:
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item()
