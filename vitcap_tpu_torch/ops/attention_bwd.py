"""attention_bwd: dq, dk, dv of attention over q, k, v read by stride.

Kernel: csrc/attention_bwd.cu (two launches per call: a query-major kernel
for dq and the f32 row statistics, then a key-major kernel for dk and dv).
It replaces the backward of K8, vitcap_tpu/ops/flash_attention.py:882
flash_bwd_packed_slab (the slab) and :734 _flash_bwd_packed (separate q,
k, v), kernels :530 _bwd_packed_pair_kernel / :600 _bwd_packed_kernel; the
source note in csrc/attention_bwd.cu says what bounds it on the H100 and
what its design does about that.  As for the forward (ops/attention.py),
attention_bwd() takes the fused slab and attention_bwd_qkv() separate q,
k, v; both read q, k, v and g by base pointer and strides, and the outputs
are contiguous.

Semantics of the TPU kernels (the plain version below, line for line):
f32 scores times hd^-0.5 plus the optional (B, 1, Lp, Lp) f32 bias, keys
at or past l_actual masked; p the f32 softmax; with dropout the forward's
keep bits regenerated (ops/dropout.py); dv from the dropped p rounded to
the operands' dtype; dp = g v^T, dropped; r = sum(dp p); ds = p (dp - r)
rounded to that dtype; dq = ds k * scale, dk = ds^T q * scale.  A padded
query row with a zero upstream gradient contributes nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, dropout
from .attention import (MAX_LP, check_bias, check_heads, operand_args,
                        split_slab)

NEG = -1e30
launches = 0              # kernel launches (two per CUDA call)
mode_launches = {"dropout": 0,    # launches with prob dropout
                 "long": 0,       # launches with Lp > MAX_LP
                 "non_slab": 0}   # launches through attention_bwd_qkv


def attention_bwd_qkv_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor, num_heads: int,
                            l_actual: int,
                            bias: Optional[torch.Tensor] = None,
                            rate: float = 0.0, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version: q, k, v, g (B, Lp, H) -> dq, dk, dv, each
    (B, Lp, H) in q's dtype."""
    B, Lp, H = q.shape
    hd = H // num_heads
    dt = q.dtype
    scale = hd ** -0.5

    def heads(a):
        return a.reshape(B, Lp, num_heads, hd).transpose(1, 2).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    gh = heads(g.to(dt))
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
        keep = dropout.attention_keep(seed, rate, B, num_heads, Lp,
                                      q.device)
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = pd.to(dt).float().transpose(-1, -2) @ gh
    r = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - r)).to(dt).float()
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale

    def merge(a):
        return a.transpose(1, 2).reshape(B, Lp, H).to(dt)
    return merge(dq), merge(dk), merge(dv)


def attention_bwd_plain(slab: torch.Tensor, g: torch.Tensor, num_heads: int,
                        l_actual: int, bias: Optional[torch.Tensor] = None,
                        rate: float = 0.0, seed: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: slab (B, Lp, 3H), g (B, Lp, H) -> dq, dk, dv,
    each (B, Lp, H) in the slab's dtype."""
    return attention_bwd_qkv_plain(*split_slab(slab), g, num_heads,
                                   l_actual, bias, rate, seed)


def _attention_bwd(q, k, v, g, num_heads, l_actual, bias, rate, seed,
                   non_slab):
    drop = dropout.kernel_args(rate, seed)
    if q.device.type == "cpu":
        return attention_bwd_qkv_plain(q, k, v, g, num_heads, l_actual, bias,
                                       rate, seed)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_bwd: no kernel for device "
                           f"{q.device}")
    if q.dim() != 3:
        raise ValueError(f"attention_bwd: q must be (B, Lp, H), got "
                         f"{tuple(q.shape)}")
    B, Lp, H = q.shape
    hd = check_heads("attention_bwd", H, num_heads, 64)
    args = [a for name, t in (("q", q), ("k", k), ("v", v), ("g", g))
            for a in operand_args(f"attention_bwd: {name}", t, (B, Lp, H),
                                  q.dtype, q.device)]
    if not 1 <= l_actual <= Lp:
        raise ValueError(f"attention_bwd: l_actual={l_actual} outside "
                         f"[1, {Lp}]")
    check_bias("attention_bwd", bias, B, Lp, q.device)
    dq, dk, dv = (torch.empty((B, Lp, H), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    mlr = torch.empty((3, B, num_heads, Lp), dtype=torch.float32,
                      device=q.device)
    lib = _build.library()
    rc = lib.vc_attention_bwd(
        *args, bias.data_ptr() if bias is not None else None, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), mlr.data_ptr(), B, Lp, H, num_heads,
        int(l_actual), float(hd ** -0.5), *drop, _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "attention_bwd")
    global launches
    launches += 2
    mode_launches["dropout"] += 2 * (rate > 0.0)
    mode_launches["long"] += 2 * (Lp > MAX_LP)
    mode_launches["non_slab"] += 2 * non_slab
    return dq, dk, dv


def attention_bwd(slab: torch.Tensor, g: torch.Tensor, num_heads: int,
                  l_actual: int, bias: Optional[torch.Tensor] = None,
                  rate: float = 0.0, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """slab (B, Lp, 3H), g (B, Lp, H) in the slab's dtype, bias None or
    contiguous f32 (B, 1, Lp, Lp), the forward's rate and int32 seed ->
    (dq, dk, dv).  CUDA: head dims multiple of 8 up to 64."""
    if slab.dim() != 3 or slab.shape[-1] % 3:
        raise ValueError(f"attention_bwd: slab must be (B, Lp, 3H), got "
                         f"{tuple(slab.shape)}")
    return _attention_bwd(*split_slab(slab), g, num_heads, l_actual, bias,
                          rate, seed, False)


def attention_bwd_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, num_heads: int, l_actual: int,
                      bias: Optional[torch.Tensor] = None, rate: float = 0.0,
                      seed: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v, g (B, Lp, H), each any layout the kernels read by stride
    (ops.attention.operand_args) -> contiguous (dq, dk, dv)."""
    return _attention_bwd(q, k, v, g, num_heads, l_actual, bias, rate, seed,
                          True)
