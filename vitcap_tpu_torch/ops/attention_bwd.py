"""attention_bwd: dq, dk, dv of attention over a fused (B, Lp, 3H) slab.

Kernel: csrc/attention_bwd.cu (two launches per call: a query-major kernel
for dq and the f32 row statistics, then a key-major kernel for dk and dv).
It replaces the backward of K8, vitcap_tpu/ops/flash_attention.py:882
flash_bwd_packed_slab (kernels :530 _bwd_packed_pair_kernel / :600
_bwd_packed_kernel); the source note in csrc/attention_bwd.cu says what
bounds it on the H100 and what its design does about that.

Semantics of the TPU kernels (the plain version below, line for line):
f32 scores times hd^-0.5 plus the optional (B, 1, Lp, Lp) f32 bias, keys
at or past l_actual masked; p the f32 softmax; with dropout the forward's
keep bits regenerated (ops/dropout.py); dv from the dropped p rounded to
the slab's dtype; dp = g v^T, dropped; r = sum(dp p); ds = p (dp - r)
rounded to the slab's dtype; dq = ds k * scale, dk = ds^T q * scale.  A
padded query row with a zero upstream gradient contributes nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, dropout

NEG = -1e30
launches = 0              # kernel launches (two per CUDA call)


def attention_bwd_plain(slab: torch.Tensor, g: torch.Tensor, num_heads: int,
                        l_actual: int, bias: Optional[torch.Tensor] = None,
                        rate: float = 0.0, seed: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: slab (B, Lp, 3H), g (B, Lp, H) -> dq, dk, dv,
    each (B, Lp, H) in the slab's dtype."""
    B, Lp, H3 = slab.shape
    H = H3 // 3
    hd = H // num_heads
    dt = slab.dtype
    scale = hd ** -0.5

    def heads(a):
        return a.reshape(B, Lp, num_heads, hd).transpose(1, 2).float()

    q, k, v = (heads(t) for t in slab.split(H, dim=-1))
    gh = heads(g.to(dt))
    s = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if l_actual < Lp:
        s = s.masked_fill(torch.arange(Lp, device=slab.device) >= l_actual,
                          NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    dp = gh @ v.transpose(-1, -2)
    pd = p
    if rate > 0.0:
        keep = dropout.attention_keep(seed, rate, B, num_heads, Lp,
                                      slab.device)
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = pd.to(dt).float().transpose(-1, -2) @ gh
    r = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - r)).to(dt).float()
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale

    def merge(a):
        return a.transpose(1, 2).reshape(B, Lp, H).to(dt)
    return merge(dq), merge(dk), merge(dv)


def attention_bwd(slab: torch.Tensor, g: torch.Tensor, num_heads: int,
                  l_actual: int, bias: Optional[torch.Tensor] = None,
                  rate: float = 0.0, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """slab (B, Lp, 3H), g (B, Lp, H) in the slab's dtype, bias None or
    contiguous f32 (B, 1, Lp, Lp), the forward's rate and int32 seed ->
    (dq, dk, dv).  CUDA: head dims multiple of 8 up to 64."""
    drop = dropout.kernel_args(rate, seed)
    if slab.device.type == "cpu":
        return attention_bwd_plain(slab, g, num_heads, l_actual, bias, rate,
                                   seed)
    if slab.device.type != "cuda":
        raise RuntimeError(f"attention_bwd: no kernel for device "
                           f"{slab.device}")
    if slab.dim() != 3 or slab.shape[-1] % 3 or not slab.is_contiguous():
        raise ValueError(f"attention_bwd: slab must be contiguous "
                         f"(B, Lp, 3H), got {tuple(slab.shape)}")
    B, Lp, H3 = slab.shape
    H = H3 // 3
    if H % num_heads or (H // num_heads) % 8 or H // num_heads > 64:
        raise ValueError(f"attention_bwd: head dim of H={H} over "
                         f"{num_heads} heads must be a multiple of 8 up to 64")
    if (g.shape != (B, Lp, H) or g.dtype != slab.dtype
            or g.device != slab.device or not g.is_contiguous()):
        raise ValueError(f"attention_bwd: g must be contiguous ({B}, {Lp}, "
                         f"{H}) {slab.dtype}, got {tuple(g.shape)} {g.dtype}")
    if not 1 <= l_actual <= Lp:
        raise ValueError(f"attention_bwd: l_actual={l_actual} outside "
                         f"[1, {Lp}]")
    if bias is not None and (bias.shape != (B, 1, Lp, Lp)
                             or bias.dtype != torch.float32
                             or bias.device != slab.device
                             or not bias.is_contiguous()):
        raise ValueError(f"attention_bwd: bias must be contiguous f32 "
                         f"({B}, 1, {Lp}, {Lp}), got {tuple(bias.shape)}")
    if slab.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("attention_bwd: slab and g must be 16-byte aligned")
    dq, dk, dv = (torch.empty((B, Lp, H), dtype=slab.dtype,
                              device=slab.device) for _ in range(3))
    mlr = torch.empty((3, B, num_heads, Lp), dtype=torch.float32,
                      device=slab.device)
    lib = _build.library()
    rc = lib.vc_attention_bwd(
        slab.data_ptr(), g.data_ptr(),
        bias.data_ptr() if bias is not None else None, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), mlr.data_ptr(), B, Lp, H, num_heads,
        int(l_actual), float((H // num_heads) ** -0.5), *drop,
        _build.dtype_code(slab.dtype),
        torch.cuda.current_stream(slab.device).cuda_stream)
    _build.check(rc, "attention_bwd")
    global launches
    launches += 2
    return dq, dk, dv
