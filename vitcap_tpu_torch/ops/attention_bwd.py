"""attention_bwd: dq, dk, dv of attention over q, k, v read by stride.

Kernel: csrc/attention_bwd.cu (two launches per call: a query-major kernel
for dq and the f32 row statistics, then a key-major kernel for dk and dv;
in bf16 both on wgmma).
It replaces the backward of K8, vitcap_tpu/ops/flash_attention.py:882
flash_bwd_packed_slab (the slab) and :734 _flash_bwd_packed (separate q,
k, v), kernels :530 _bwd_packed_pair_kernel / :600 _bwd_packed_kernel, and
the one-pass backward of K9 up to 1024 padded tokens, :372
_flash_bwd_onepass (kernel :324 _bwd_onepass_kernel, the same math at rate
0); the source note in csrc/attention_bwd.cu says what bounds it on the
H100 and what its design does about that.  As for the forward
(ops/attention.py), attention_bwd() takes the fused slab,
attention_bwd_qkv() separate (B, Lp, H) q, k, v and attention_bwd_heads()
per-head (B, nH, L, dh) ones; all read q, k, v and g by base pointer and
strides, and the outputs are contiguous.

Semantics of the TPU kernels (the plain version below, line for line):
f32 scores times hd^-0.5 plus the optional (B, 1 | nH, Lp, Lp) f32 bias,
keys at or past l_actual masked; p the f32 softmax; with dropout the
forward's keep bits regenerated (ops/dropout.py); dv from the dropped p
rounded to the operands' dtype; dp = g v^T, dropped; r = sum(dp p); ds =
p (dp - r) rounded to that dtype; dq = ds k * scale, dk = ds^T q * scale.
A padded query row with a zero upstream gradient contributes nothing.
kernel_info() reads the bf16 kernels' launch configuration on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, dropout
from ._build import launch_info
from .attention import (MAX_LP, bias_args, check_head_dim, check_heads,
                        heads_view, merge_heads, operand_args, split_slab)

NEG = -1e30
launches = 0              # kernel launches (two per CUDA call)
mode_launches = {"dropout": 0,    # launches with prob dropout
                 "long": 0,       # launches with Lp > MAX_LP
                 "non_slab": 0,   # launches through attention_bwd_qkv
                 "heads": 0,      # launches through attention_bwd_heads
                 "tp": 0}         # launches on a tensor-parallel head slice


Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def attention_bwd_heads_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor,
                              l_actual: int,
                              bias: Optional[torch.Tensor] = None,
                              rate: float = 0.0, seed: int = 0,
                              nh_total: int = 0,
                              head_offset: int = 0) -> Grads:
    """Plain PyTorch version over per-head q, k, v, g (B, nH, Lp, hd) ->
    dq, dk, dv, each (B, nH, Lp, hd) in q's dtype; nh_total, head_offset:
    the dropout salt's global heads (ops/attention.py)."""
    B, nh, Lp, hd = q.shape
    dt = q.dtype
    scale = hd ** -0.5
    qh, kh, vh, gh = q.float(), k.float(), v.float(), g.to(dt).float()
    s = (qh @ kh.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if l_actual < Lp:
        s = s.masked_fill(torch.arange(Lp, device=q.device) >= l_actual,
                          NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    dp = gh @ vh.transpose(-1, -2)
    pd = p
    if rate > 0.0:
        keep = dropout.attention_keep(seed, rate, B, nh, Lp, q.device,
                                      nh_total, head_offset)
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = pd.to(dt).float().transpose(-1, -2) @ gh
    r = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - r)).to(dt).float()
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_bwd_qkv_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor, num_heads: int,
                            l_actual: int,
                            bias: Optional[torch.Tensor] = None,
                            rate: float = 0.0, seed: int = 0,
                            nh_total: int = 0, head_offset: int = 0) -> Grads:
    """Plain PyTorch version: q, k, v, g (B, Lp, H) -> dq, dk, dv, each
    (B, Lp, H) in q's dtype."""
    return tuple(merge_heads(t) for t in attention_bwd_heads_plain(
        *(heads_view(t, num_heads) for t in (q, k, v, g)), l_actual, bias,
        rate, seed, nh_total, head_offset))


def attention_bwd_plain(slab: torch.Tensor, g: torch.Tensor, num_heads: int,
                        l_actual: int, bias: Optional[torch.Tensor] = None,
                        rate: float = 0.0, seed: int = 0, nh_total: int = 0,
                        head_offset: int = 0) -> Grads:
    """Plain PyTorch version: slab (B, Lp, 3H), g (B, Lp, H) -> dq, dk, dv,
    each (B, Lp, H) in the slab's dtype."""
    return attention_bwd_qkv_plain(*split_slab(slab), g, num_heads,
                                   l_actual, bias, rate, seed, nh_total,
                                   head_offset)


def _attention_bwd(q, k, v, g, l_actual, bias, rate, seed, mode,
                   nh_total=0, head_offset=0) -> Grads:
    """Per-head (B, nH, Lp, hd) q, k, v, g -> per-head dq, dk, dv: the
    plain version for CPU tensors, else the kernels, whose (B, Lp, H)
    outputs are returned as their per-head views."""
    drop = dropout.kernel_args(rate, seed)
    nh_total = dropout.heads_total(q.shape[1], nh_total, head_offset)
    if q.device.type == "cpu":
        return attention_bwd_heads_plain(q, k, v, g, l_actual, bias, rate,
                                         seed, nh_total, head_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_bwd: no kernel for device "
                           f"{q.device}")
    B, nh, Lp, hd = q.shape
    check_head_dim("attention_bwd", hd, 64)
    args = [a for name, t in (("q", q), ("k", k), ("v", v), ("g", g))
            for a in operand_args(f"attention_bwd: {name}", t,
                                  (B, nh, Lp, hd), q.dtype, q.device)]
    if not 1 <= l_actual <= Lp:
        raise ValueError(f"attention_bwd: l_actual={l_actual} outside "
                         f"[1, {Lp}]")
    H = nh * hd
    dq, dk, dv = (torch.empty((B, Lp, H), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    mlr = torch.empty((3, B, nh, Lp), dtype=torch.float32,
                      device=q.device)
    lib = _build.library()
    rc = lib.vc_attention_bwd(
        *args, *bias_args("attention_bwd", bias, B, nh, Lp, q.device),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), mlr.data_ptr(), B, Lp,
        H, nh, int(l_actual), float(hd ** -0.5), *drop, nh_total,
        int(head_offset), _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "attention_bwd")
    global launches
    launches += 2
    mode_launches["dropout"] += 2 * (rate > 0.0)
    mode_launches["long"] += 2 * (Lp > MAX_LP)
    mode_launches["tp"] += 2 * (nh_total != nh)
    if mode != "slab":
        mode_launches[mode] += 2
    return tuple(heads_view(t, nh) for t in (dq, dk, dv))


def kernel_info() -> list:
    """The bf16 attention_bwd kernels' launch configuration on the current
    CUDA device (ops._build.launch_info)."""
    return launch_info("vc_attention_bwd_kernel_info")


def attention_bwd(slab: torch.Tensor, g: torch.Tensor, num_heads: int,
                  l_actual: int, bias: Optional[torch.Tensor] = None,
                  rate: float = 0.0, seed: int = 0, nh_total: int = 0,
                  head_offset: int = 0) -> Grads:
    """slab (B, Lp, 3H), g (B, Lp, H) in the slab's dtype, bias None or
    contiguous f32 (B, 1 | nH, Lp, Lp), the forward's rate, int32 seed and
    salt heads (nh_total, head_offset: ops/attention.py attention) -> (dq,
    dk, dv).  CUDA: head dims multiple of 8 up to 64."""
    if slab.dim() != 3 or slab.shape[-1] % 3:
        raise ValueError(f"attention_bwd: slab must be (B, Lp, 3H), got "
                         f"{tuple(slab.shape)}")
    check_heads("attention_bwd", slab.shape[-1] // 3, num_heads)
    return tuple(merge_heads(t) for t in _attention_bwd(
        *(heads_view(t, num_heads) for t in (*split_slab(slab), g)),
        l_actual, bias, rate, seed, "slab", nh_total, head_offset))


def attention_bwd_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, num_heads: int, l_actual: int,
                      bias: Optional[torch.Tensor] = None, rate: float = 0.0,
                      seed: int = 0, nh_total: int = 0,
                      head_offset: int = 0) -> Grads:
    """q, k, v, g (B, Lp, H), each any layout the kernels read by stride
    (ops.attention.operand_args) -> contiguous (dq, dk, dv)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t.dim() != 3:
            raise ValueError(f"attention_bwd: {name} must be (B, Lp, H), "
                             f"got {tuple(t.shape)}")
    check_heads("attention_bwd", q.shape[-1], num_heads)
    return tuple(merge_heads(t) for t in _attention_bwd(
        *(heads_view(t, num_heads) for t in (q, k, v, g)), l_actual, bias,
        rate, seed, "non_slab", nh_total, head_offset))


def attention_bwd_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> Grads:
    """K9's one-pass backward: per-head q, k, v, g (B, nH, L, dh), each any
    layout the kernels read by stride, bias None or f32 (B, 1 | nH, L, L)
    -> dq, dk, dv (B, nH, L, dh), on CUDA per-head views of contiguous (B,
    L, nH * dh) tensors.  CUDA: head dims multiple of 8 up to 64."""
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"attention_bwd: {name} must be (B, nH, L, dh) "
                             f"like q, got {tuple(t.shape)}")
    return _attention_bwd(q, k, v, g, q.shape[2], bias, 0.0, 0, "heads")
