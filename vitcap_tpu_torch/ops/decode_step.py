"""The cached decode step over flat caches: decode_attention and
fused_decode_step, the port of vitcap_tpu/ops/decode_step.py.

Kernel: csrc/decode_attention.cu, the attention half of the TPU kernel
_kernel (vitcap_tpu/ops/decode_step.py:115, reached through
fused_decode_step); the source note there says what bounds it on the H100.
An image's beams run as beam groups of at most 16 (plan(): the largest
divisor of nb up to MAX_CLUSTER_BEAMS), one launch row each, so any beam
count launches: greedy and beam-3 are one group, constrained beam
search's 160 beams ten of 16.  bf16 at head dims 64 and 128 runs
decode_attention_cluster_kernel: the context of each (head, beam group)
split over a thread-block cluster, whose size and key ranges plan() picks
from the shape alone (never from t, so a step's launch can be captured in
a CUDA graph); f32, the other head dims and contexts too long for its
shared memory run decode_attention_simple_kernel.  kernel_info() reads
both kernels' launch configuration on the card.
The dense products of that TPU kernel run on the port's gemm kernel and its
post-LNs on layer_norm, rounded where it rounds:
- qkv: the f32 product plus the f32 bias, rounded to the compute dtype;
- out-projection: the f32 product plus the f32 bias plus the residual, in
  f32; the post-LN reads that f32 sum;
- fc1: the f32 product plus the bias, rounded, then exact GELU;
- fc2: the f32 product plus the bias plus the residual, in f32; post-LN.
So one layer is 7 launches (gemm, decode_attention, gemm, layer_norm, gemm,
gemm, layer_norm) and one step of 4 layers 28.  Under tensor parallelism
(tp, the decoder layers' TPShard) each rank runs the same 7 launches on
its heads: qkv and fc1 on its rows, decode_attention over its heads'
caches, the out-projection and fc2 as f32 partial sums summed over the
model axis before the bias and residual (gemm.row_gemm).

Layouts (the 'flat' layout of models/decode.py):
- caption caches (nL, Bb, A, Hl) in the compute dtype; Bb = B * nb rows,
  the beams of an image adjacent; updated in place at slot t-1; Hl is the
  width of the rank's heads (H unsplit);
- context K/V (nL, B, S, Hl) in the compute dtype, one copy per image,
  shared by its beams; S is the context length itself (no padding);
- context bias (B, S) f32: 0 on valid slots, -10000 on invalid od slots;
- t: the MASK row's position, a one-element int32 tensor on the tensors'
  device (the kernel reads it there, so the launch needs no host value).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import _build
from ..parallel.tensor_parallel import TPShard
from .gemm import gemm, gemm_plain, row_gemm
from .layer_norm import layer_norm, layer_norm_plain

NEG_MASK_VALUE = -10000.0     # the reference's mask value on invalid slots
launches = 0
# launches of the cluster kernel over more than one beam group an image
mode_launches = {"groups": 0}

CLUSTER_HD = (64, 128)        # head dims of decode_attention_cluster_kernel
MAX_RANKS = 8                 # the portable thread-block cluster size
KEYS_PER_RANK = 144           # the keys a rank aims at
KEY_GROUP = 16                # keys per tensor-core group
ROW_TILE = 8                  # window rows per tensor-core tile (mma's N)
MAX_CLUSTER_BEAMS = 16        # beams of one launch row (a beam group)
CLUSTER_WARPS = 4
SMEM_LIMIT = 232448           # shared bytes a block can have on the H100


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_decode_layers(model, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The decoder layers' weights stacked into (nL, ...) tensors in the
    torch (out, in) layout: q/k/v merged into one (3H, H) matrix, matrices
    in the compute dtype, biases and LayerNorm parameters f32."""
    layers = model.bert.decoder.layer

    def stack(get, dt):
        return torch.stack([get(layer) for layer in layers]).to(dt) \
            .contiguous()

    def qkv(part):
        def get(layer):
            ps = layer.attention.self
            return torch.cat([getattr(ps.query, part), getattr(ps.key, part),
                              getattr(ps.value, part)])
        return get

    f32 = torch.float32
    return {
        "wqkv": stack(qkv("weight"), dtype),                 # (nL, 3H, H)
        "bqkv": stack(qkv("bias"), f32),                     # (nL, 3H)
        "wo": stack(lambda m: m.attention.output.dense.weight, dtype),
        "bo": stack(lambda m: m.attention.output.dense.bias, f32),
        "ln1w": stack(lambda m: m.attention.output.LayerNorm.weight, f32),
        "ln1b": stack(lambda m: m.attention.output.LayerNorm.bias, f32),
        "wfc1": stack(lambda m: m.intermediate.dense.weight, dtype),
        "bfc1": stack(lambda m: m.intermediate.dense.bias, f32),
        "wfc2": stack(lambda m: m.output.dense.weight, dtype),
        "bfc2": stack(lambda m: m.output.dense.bias, f32),
        "ln2w": stack(lambda m: m.output.LayerNorm.weight, f32),
        "ln2b": stack(lambda m: m.output.LayerNorm.bias, f32),
    }


def pack_decode_context(ctx_k: List[torch.Tensor], ctx_v: List[torch.Tensor],
                        ctx_valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-layer (B, S, H) context K/V and the (B, S) validity ->
    ((nL, B, S, H), (nL, B, S, H), (B, S) additive f32 bias)."""
    bias = torch.where(ctx_valid, 0.0, NEG_MASK_VALUE).float().contiguous()
    return torch.stack(ctx_k), torch.stack(ctx_v), bias


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """groups: the beam groups of an image, one launch row each.
    ranks 0: decode_attention_simple_kernel.  Else clusters of `ranks`
    blocks, rank q taking the context keys [q kpr, (q + 1) kpr), the last
    rank the rest of the context and the caption; keys_max the keys its
    shared buffers hold, smem their bytes."""
    ranks: int
    keys_per_rank: int = 0
    keys_max: int = 0
    smem: int = 0
    groups: int = 1


def row_tiles(nb: int) -> int:
    """decode_attention_cluster_kernel's tiles of 8 window rows for nb
    beams (2 nb rows): 1, 2 or 4; 0 past MAX_CLUSTER_BEAMS."""
    R = 2 * nb
    return next((n for n in (1, 2, 4) if R <= 8 * n), 0)


def cluster_smem(hd: int, nb: int, keys_max: int, ranks: int) -> int:
    """Shared bytes of one decode_attention_cluster_kernel block of a
    cluster of `ranks` (csrc/decode_attention.cu DcLayout): K rows (on the
    last rank later the partials the other ranks push) and V rows of
    keys_max keys, the f32 q rows, the MASK rows' own k and v, a bias per
    key, the f32 scores (then partial outputs), the bf16 probabilities (at
    least 16 rows), per-row statistics and every rank's maxes, two
    mbarriers; K/V/P rows padded by 16 bytes."""
    rows = ROW_TILE * row_tiles(nb)
    kst, sst, pst = hd + 8, keys_max + 4, keys_max + 8
    kbytes = keys_max * kst * 2
    recv = (ranks - 1) * 2 * nb * (hd + 1) * 4
    return (max(kbytes, recv) + kbytes + rows * hd * 4 + rows * hd * 2
            + keys_max * 4 + rows * max(sst, hd) * 4
            + max(16, rows) * pst * 2
            + rows * (CLUSTER_WARPS + 4 + MAX_RANKS) * 4 + 16)


def group_beams(nb: int) -> int:
    """The beams of one launch row: the largest divisor of nb that is at
    most MAX_CLUSTER_BEAMS."""
    return next(g for g in range(min(nb, MAX_CLUSTER_BEAMS), 0, -1)
                if nb % g == 0)


@functools.lru_cache(maxsize=None)
def plan(S: int, nb: int, hd: int, A: int = 20,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The decode_attention kernel and its cluster for S context keys, nb
    beams per image, head dim hd and A caption slots.  The beams run as
    nb / g groups of g = group_beams(nb) beams.  bf16 at hd 64 or 128
    takes the cluster kernel, with ranks = ceil((S + g A) / 144) (1 to 8)
    sharing the context and the group's g A caption slots about equally
    (the last rank's range ends the context, then the caption); everything
    else, or a plan past the block's shared memory, the simple kernel.
    From the shape alone: t never enters."""
    g = group_beams(nb)
    groups = nb // g
    if dtype != torch.bfloat16 or hd not in CLUSTER_HD:
        return Plan(0, groups=groups)
    total = S + g * A
    ranks = min(MAX_RANKS, max(1, _cdiv(total, KEYS_PER_RANK)))
    kpr = _cdiv(total, ranks)
    last = max(0, S - (ranks - 1) * kpr) + g * A
    kmax = _cdiv(max(kpr, last), KEY_GROUP) * KEY_GROUP
    smem = cluster_smem(hd, g, kmax, ranks)
    if smem > SMEM_LIMIT:
        return Plan(0, groups=groups)
    return Plan(ranks, kpr, kmax, smem, groups)


def kernel_info(S: int = 628, nb: int = 3, A: int = 20) -> list:
    """The launch configuration of decode_attention_cluster_kernel (hd 64
    and 128) and decode_attention_simple_kernel (bf16 and f32, hd 64) at
    the geometry (S, nb, A) on the current CUDA device, with the plan at
    hd 64 (ops._build.launch_info)."""
    p = plan(S, nb, 64, A)
    info = _build.launch_info("vc_decode_attention_kernel_info",
                              nb // p.groups, S, A, p.ranks, p.keys_max)
    for k in info:
        k.update(S=S, nb=nb, groups=p.groups, ranks=p.ranks,
                 keys_per_rank=p.keys_per_rank, keys_max=p.keys_max)
    return info


SCORE_LANES = 4   # lanes a key in the cluster kernel's score loop
SCORE_UNIT = 8    # bf16 elements of a lane's 16-byte unit


def _lane_order(x: torch.Tensor) -> torch.Tensor:
    """(..., hd) -> (..., SCORE_LANES, E) f32: lane j's elements of a key
    in the cluster kernel's score loop, in its chain order (the 8-element
    units j, j + 4, ... of the head dim); hd is padded with zeros to a
    multiple of 32 first (a zero only adds +0)."""
    x = x.float()
    pad = -x.shape[-1] % (SCORE_LANES * SCORE_UNIT)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.unflatten(-1, (-1, SCORE_LANES, SCORE_UNIT)) \
        .transpose(-3, -2).flatten(-2)


def _lane_tree(p: torch.Tensor) -> torch.Tensor:
    """(..., 4) lane partial sums -> (p0 + p1) + (p2 + p3)."""
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def ordered_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, hd) . b (..., N, hd)^T -> (..., M, N) f32 in the cluster
    kernel's order (batch dims broadcast): per lane a chain of f32 adds
    from 0 over its elements' products (_lane_order), then _lane_tree.
    For operands that hold bf16 values each product is exact in f32, so
    the kernel's FMA chain rounds as these adds do."""
    a = _lane_order(a).unsqueeze(-3)               # (..., M, 1, 4, E)
    b = _lane_order(b).unsqueeze(-4)               # (..., 1, N, 4, E)
    acc = torch.zeros((), device=a.device)
    for e in range(a.shape[-1]):
        acc = acc + a[..., e] * b[..., e]
    return _lane_tree(acc)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., hd) -> (...,) f32: ordered_dot's order over given terms."""
    x = _lane_order(x)
    acc = torch.zeros((), device=x.device)
    for e in range(x.shape[-1]):
        acc = acc + x[..., e]
    return _lane_tree(acc)


def decode_scores_plain(q: torch.Tensor, kw: torch.Tensor,
                        cap_k: torch.Tensor, ctx_k: torch.Tensor,
                        ctx_bias: torch.Tensor, t: int, num_heads: int):
    """The scores of decode_attention_plain: q, kw (Bb, 2, H) the window's
    q and k, cap_k (Bb, >= t, H) with slot t-1 written, ctx_k (B, S, H),
    ctx_bias (B, S) f32 -> f32 (s_cap (Bb, h, 2, t), s_self (Bb, h, 2, 1),
    s_ctx (Bb, h, 2, S)), q scaled in its dtype first.  s_cap and s_ctx:
    ordered_dot of the scaled q and the keys, s_ctx plus the bias;
    s_self: ordered_sum of the products rounded to the compute dtype, -inf
    on the prev row (it does not see the MASK key)."""
    Bb, W, H = q.shape
    B, S, _ = ctx_k.shape
    nb = Bb // B
    hd = H // num_heads

    def heads(a):                                  # (N, L, H) -> (N, h, L, d)
        return a.reshape(a.shape[0], a.shape[1], num_heads, hd).transpose(1, 2)

    qs = heads(q) * torch.tensor(hd ** -0.5, dtype=q.dtype)  # rounded in dt
    s_cap = ordered_dot(qs, heads(cap_k[:, :t]))               # (Bb,h,2,t)
    s_self = ordered_sum(qs * heads(kw[:, 1:2]))[..., None]
    s_self[:, :, 0] = float("-inf")
    s_ctx = ordered_dot(qs.reshape(B, nb, num_heads, W, hd),
                        heads(ctx_k)[:, None])             # (B,nb,h,2,S)
    s_ctx = (s_ctx + ctx_bias[:, None, None, None, :].float()) \
        .reshape(Bb, num_heads, W, S)
    return s_cap, s_self, s_ctx


def decode_attention_plain(qkv: torch.Tensor, cap_k: torch.Tensor,
                           cap_v: torch.Tensor, ctx_k: torch.Tensor,
                           ctx_v: torch.Tensor, ctx_bias: torch.Tensor, t,
                           num_heads: int) -> torch.Tensor:
    """Plain PyTorch version.  qkv (Bb, 2, 3H): the window's q/k/v;
    cap_k/v (Bb, A, H), written in place at slot t-1; ctx_k/v (B, S, H);
    ctx_bias (B, S) f32; t an int or a one-element tensor.  -> (Bb, 2, H).

    Everything up to the rounding of each probability is the bf16 cluster
    kernel's arithmetic, operation for operation (decode_scores_plain): the
    scores' f32 adds in the kernel's fixed order (ordered_dot), one max a
    row over the three sources, each probability torch.exp(s - m), which
    on a CUDA tensor is the kernel's expf; the caption and context
    probabilities rounded to the compute dtype for the product with v, the
    MASK row's own term f32; the denominator sums the f32 values.  The
    P.V sums and the denominator keep their own order (an f32 difference
    there moves an output only through its single rounding)."""
    Bb, W, H3 = qkv.shape
    H = H3 // 3
    B, S, _ = ctx_k.shape
    nb = Bb // B
    hd = H // num_heads
    t = int(t)
    dt = qkv.dtype
    q, kw, vw = qkv.split(H, dim=-1)
    cap_k[:, t - 1] = kw[:, 0]                     # the prev slot
    cap_v[:, t - 1] = vw[:, 0]

    def heads(a):                                  # (N, L, H) -> (N, h, L, d)
        return a.reshape(a.shape[0], a.shape[1], num_heads, hd).transpose(1, 2)

    s_cap, s_self, s_ctx = decode_scores_plain(q, kw, cap_k, ctx_k, ctx_bias,
                                               t, num_heads)
    m = torch.maximum(torch.maximum(s_cap.amax(-1, keepdim=True),
                                    s_ctx.amax(-1, keepdim=True)), s_self)
    p_cap = torch.exp(s_cap - m)
    p_self = torch.exp(s_self - m)
    p_ctx = torch.exp(s_ctx - m)
    den = p_cap.sum(-1, keepdim=True) + p_self + p_ctx.sum(-1, keepdim=True)
    o = p_cap.to(dt).float() @ heads(cap_v[:, :t]).float()
    o = o + p_self * heads(vw[:, 1:2]).float()
    o_ctx = torch.einsum("bjhws,bhsd->bjhwd",
                         p_ctx.to(dt).float().reshape(B, nb, num_heads, W, S),
                         heads(ctx_v).float())
    o = ((o + o_ctx.reshape(Bb, num_heads, W, hd)) / den).to(dt)
    return o.transpose(1, 2).reshape(Bb, W, H)


def decode_attention(qkv: torch.Tensor, cap_k: torch.Tensor,
                     cap_v: torch.Tensor, ctx_k: torch.Tensor,
                     ctx_v: torch.Tensor, ctx_bias: torch.Tensor,
                     t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """See decode_attention_plain; on a CUDA device t must be a one-element
    int32 tensor there, with 1 <= t <= A."""
    if qkv.device.type == "cpu":
        return decode_attention_plain(qkv, cap_k, cap_v, ctx_k, ctx_v,
                                      ctx_bias, t, num_heads)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for device "
                           f"{qkv.device}")
    Bb, W, H3 = qkv.shape
    H = H3 // 3
    B, S, _ = ctx_k.shape
    A = cap_k.shape[1]
    nb = Bb // B
    dt = qkv.dtype
    if W != 2 or H3 != 3 * H or nb < 1 or Bb != B * nb:
        raise ValueError(f"decode_attention: qkv {tuple(qkv.shape)} against "
                         f"ctx_k {tuple(ctx_k.shape)}")
    hd = H // num_heads
    if H % num_heads or hd not in (8, 16, 32, 64, 128):
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"8/16/32/64/128")
    for name, a, shape in (("cap_k", cap_k, (Bb, A, H)),
                           ("cap_v", cap_v, (Bb, A, H)),
                           ("ctx_k", ctx_k, (B, S, H)),
                           ("ctx_v", ctx_v, (B, S, H))):
        if (a.shape != shape or a.dtype != dt or a.device != qkv.device
                or not a.is_contiguous() or a.data_ptr() % 16):
            raise ValueError(f"decode_attention: {name} must be contiguous, "
                             f"16-byte aligned {shape} {dt}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("decode_attention: qkv must be contiguous and "
                         "16-byte aligned")
    if (ctx_bias.shape != (B, S) or ctx_bias.dtype != torch.float32
            or ctx_bias.device != qkv.device or not ctx_bias.is_contiguous()):
        raise ValueError(f"decode_attention: ctx_bias must be contiguous f32 "
                         f"({B}, {S}), got {tuple(ctx_bias.shape)}")
    if (not isinstance(t, torch.Tensor) or t.numel() != 1
            or t.dtype != torch.int32 or t.device != qkv.device):
        raise ValueError("decode_attention: t must be a one-element int32 "
                         "tensor on the kernel's device")
    out = torch.empty((Bb, W, H), dtype=dt, device=qkv.device)
    p = plan(S, nb, hd, A, dt)
    lib = _build.library()
    rc = lib.vc_decode_attention(
        qkv.data_ptr(), cap_k.data_ptr(), cap_v.data_ptr(), ctx_k.data_ptr(),
        ctx_v.data_ptr(), ctx_bias.data_ptr(), t.data_ptr(), out.data_ptr(),
        B, nb, p.groups, S, A, H, num_heads, float(hd ** -0.5),
        _build.dtype_code(dt), p.ranks, p.keys_per_rank, p.keys_max,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, "decode_attention")
    global launches
    launches += 1
    if p.ranks and p.groups > 1:
        mode_launches["groups"] += 1
    return out


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------

def _step(kernels, packed: Dict[str, torch.Tensor], ctx_k: torch.Tensor,
          ctx_v: torch.Tensor, ctx_bias: torch.Tensor, cap_k: torch.Tensor,
          cap_v: torch.Tensor, x_win: torch.Tensor, t, num_heads: int,
          eps: float, tp: Optional[TPShard] = None) -> torch.Tensor:
    mm, attn, ln = kernels
    Bb, W, H = x_win.shape
    dt = x_win.dtype
    x = x_win.reshape(Bb * W, H).contiguous()
    for li in range(ctx_k.shape[0]):
        p = {k: v[li] for k, v in packed.items()}
        qkv = mm(x, p["wqkv"], p["bqkv"], f32_sum=True)
        o = attn(qkv.view(Bb, W, qkv.shape[1]), cap_k[li], cap_v[li],
                 ctx_k[li], ctx_v[li], ctx_bias, t, num_heads)
        y = row_gemm(mm, tp, o.view(Bb * W, -1), p["wo"], p["bo"],
                     residual=x, f32_sum=True, out_f32=True)
        x = ln(y, p["ln1w"], p["ln1b"], eps, dt)
        h = mm(x, p["wfc1"], p["bfc1"], gelu=True, f32_sum=True)
        y = row_gemm(mm, tp, h, p["wfc2"], p["bfc2"], residual=x,
                     f32_sum=True, out_f32=True)
        x = ln(y, p["ln2w"], p["ln2b"], eps, dt)
    return x.view(Bb, W, H)


def fused_decode_step_plain(packed: Dict[str, torch.Tensor],
                            ctx_k: torch.Tensor, ctx_v: torch.Tensor,
                            ctx_bias: torch.Tensor, cap_k: torch.Tensor,
                            cap_v: torch.Tensor, x_win: torch.Tensor, t, *,
                            num_heads: int, eps: float,
                            tp: Optional[TPShard] = None) -> torch.Tensor:
    """Plain PyTorch version of fused_decode_step (the plain gemm,
    decode_attention and layer_norm versions, on any device)."""
    return _step((gemm_plain, decode_attention_plain, layer_norm_plain),
                 packed, ctx_k, ctx_v, ctx_bias, cap_k, cap_v, x_win, t,
                 num_heads, eps, tp)


def fused_decode_step(packed: Dict[str, torch.Tensor], ctx_k: torch.Tensor,
                      ctx_v: torch.Tensor, ctx_bias: torch.Tensor,
                      cap_k: torch.Tensor, cap_v: torch.Tensor,
                      x_win: torch.Tensor, t, *, num_heads: int,
                      eps: float, tp: Optional[TPShard] = None
                      ) -> torch.Tensor:
    """One step of every decoder layer: x_win (Bb, 2, H) in the compute
    dtype -> (Bb, 2, H); the caption caches are updated in place.
    packed: pack_decode_layers; ctx_k/v, ctx_bias: pack_decode_context.
    tp: the decoder layers' TPShard (num_heads then the rank's heads, the
    caches its heads' width).  CPU tensors run fused_decode_step_plain;
    CUDA tensors the kernels."""
    if x_win.device.type == "cpu":
        return fused_decode_step_plain(packed, ctx_k, ctx_v, ctx_bias, cap_k,
                                       cap_v, x_win, t, num_heads=num_heads,
                                       eps=eps, tp=tp)
    return _step((gemm, decode_attention, layer_norm), packed, ctx_k, ctx_v,
                 ctx_bias, cap_k, cap_v, x_win, t, num_heads, eps, tp)
