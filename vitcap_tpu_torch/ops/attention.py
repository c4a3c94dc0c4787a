"""attention: multi-head softmax attention over a fused (B, Lp, 3H) qkv slab.

Kernel: csrc/attention.cu.  It replaces _attn_pairbd_kernel /
_attn_perhead_kernel and _bert_attn_pairbd_kernel /
_bert_attn_perhead_kernel of vitcap_tpu/ops/fused_block.py; the source note
in csrc/attention.cu says what bounds it on the H100.

Semantics of the TPU kernels: q, k, v are the three H-wide column blocks of
the slab, head h at columns [h*hd, (h+1)*hd) of each; f32 scores times
hd^-0.5, plus the optional additive (B, 1, Lp, Lp) f32 bias; keys with
index >= l_actual masked with -1e30; f32 softmax statistics; the
unnormalised probabilities rounded to the slab's dtype for the product with
v; the output divided by max(l, 1e-30) and stored in the slab's dtype.
Padded query rows are computed like any other and are the caller's to
discard.

With ``rate`` > 0 it is also the train forward of K8
(vitcap_tpu/ops/flash_attention.py:949 flash_fwd_packed_slab, kernels
:452 _fwd_packed_kernel / :484 _fwd_packed_pair_kernel): attention-prob
dropout on the unnormalised exp(s - m), keep bits from ops/dropout.py
(lattice (query row, key column), salt b * nh + h), kept values times
1 / (1 - rate) in f32 before the rounding; l stays the undropped sum.

Past 1024 padded tokens it is also the attention of K10 (vitcap_tpu/ops/
fused_block.py:125 _block_kernel and :470 _bert_kernel, whose q-tiled
softmax is the same function); mode_launches["long"] counts those launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, dropout

NEG = -1e30
launches = 0
MAX_LP = 1024       # the TPU package's longest single-q-tile length;
                    # longer slabs are K10's (its q-tiled kernels)
mode_launches = {"dropout": 0,    # launches with prob dropout
                 "long": 0}       # launches with Lp > MAX_LP


def attention_plain(slab: torch.Tensor, num_heads: int, l_actual: int,
                    bias: Optional[torch.Tensor] = None, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version: slab (B, Lp, 3H) -> (B, Lp, H)."""
    B, Lp, H3 = slab.shape
    H = H3 // 3
    hd = H // num_heads

    def heads(a):
        return a.reshape(B, Lp, num_heads, hd).transpose(1, 2).float()

    q, k, v = (heads(t) for t in slab.split(H, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    if bias is not None:
        s = s + bias.float()
    if l_actual < Lp:
        s = s.masked_fill(torch.arange(Lp, device=slab.device) >= l_actual,
                          NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if rate > 0.0:
        keep = dropout.attention_keep(seed, rate, B, num_heads, Lp,
                                      slab.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    # probabilities rounded to the compute dtype for the product with v,
    # as the TPU kernels do
    o = (p.to(slab.dtype).float() @ v) / l.clamp_min(1e-30)
    return o.transpose(1, 2).reshape(B, Lp, H).to(slab.dtype)


def attention(slab: torch.Tensor, num_heads: int, l_actual: int,
              bias: Optional[torch.Tensor] = None, rate: float = 0.0,
              seed: int = 0) -> torch.Tensor:
    """slab (B, Lp, 3H) -> (B, Lp, H); rate > 0 drops probabilities with
    the int32 `seed` (ignored at rate 0)."""
    drop = dropout.kernel_args(rate, seed)
    if slab.device.type == "cpu":
        return attention_plain(slab, num_heads, l_actual, bias, rate, seed)
    if slab.device.type != "cuda":
        raise RuntimeError(f"attention: no kernel for device {slab.device}")
    if slab.dim() != 3 or slab.shape[-1] % 3 or not slab.is_contiguous():
        raise ValueError(f"attention: slab must be contiguous (B, Lp, 3H), "
                         f"got {tuple(slab.shape)}")
    B, Lp, H3 = slab.shape
    H = H3 // 3
    if H % num_heads:
        raise ValueError(f"attention: H={H} not divisible by {num_heads}")
    hd = H // num_heads
    if hd % 8 or hd > 128:
        raise ValueError(f"attention: head dim {hd} must be a multiple of 8 "
                         f"up to 128")
    if not 1 <= l_actual <= Lp:
        raise ValueError(f"attention: l_actual={l_actual} outside [1, {Lp}]")
    if bias is not None:
        if (bias.shape != (B, 1, Lp, Lp) or bias.dtype != torch.float32
                or bias.device != slab.device or not bias.is_contiguous()):
            raise ValueError(f"attention: bias must be contiguous f32 "
                             f"({B}, 1, {Lp}, {Lp}), got {tuple(bias.shape)} "
                             f"{bias.dtype}")
    if slab.data_ptr() % 16:
        raise ValueError("attention: slab must be 16-byte aligned")
    out = torch.empty((B, Lp, H), dtype=slab.dtype, device=slab.device)
    lib = _build.library()
    rc = lib.vc_attention(slab.data_ptr(),
                          bias.data_ptr() if bias is not None else None,
                          out.data_ptr(), B, Lp, H, num_heads, int(l_actual),
                          float(hd ** -0.5), *drop,
                          _build.dtype_code(slab.dtype),
                          torch.cuda.current_stream(slab.device).cuda_stream)
    _build.check(rc, "attention")
    global launches
    launches += 1
    mode_launches["dropout"] += rate > 0.0
    mode_launches["long"] += Lp > MAX_LP
    return out
