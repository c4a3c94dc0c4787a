"""attention: multi-head softmax attention over q, k, v read by stride.

Kernel: csrc/attention.cu.  It replaces _attn_pairbd_kernel /
_attn_perhead_kernel and _bert_attn_pairbd_kernel /
_bert_attn_perhead_kernel of vitcap_tpu/ops/fused_block.py; the source note
in csrc/attention.cu says what bounds it on the H100.

Two entry points launch the one kernel: attention() over a fused (B, Lp,
3H) qkv slab (the blocks; q, k, v are its three H-wide column blocks), and
attention_qkv() over separate (B, Lp, H) q, k, v (the packed train route,
ops/flash_attention.py), each read by base pointer, batch stride and row
stride.  The kernel takes any such layout whose base pointers are 16-byte
aligned and whose strides are multiples of 16 bytes with unit column
stride; the wrapper raises on any other and never copies.

Semantics of the TPU kernels: head h at columns [h*hd, (h+1)*hd) of each
operand; f32 scores times hd^-0.5, plus the optional additive (B, 1, Lp,
Lp) f32 bias; keys with index >= l_actual masked with -1e30; f32 softmax
statistics; the unnormalised probabilities rounded to the operands' dtype
for the product with v; the output divided by max(l, 1e-30) and stored in
that dtype.  Padded query rows are computed like any other and are the
caller's to discard.

With ``rate`` > 0 it is also the train forward of K8
(vitcap_tpu/ops/flash_attention.py:949 flash_fwd_packed_slab on the slab,
:670 _flash_fwd_packed on separate q, k, v; kernels :452
_fwd_packed_kernel / :484 _fwd_packed_pair_kernel): attention-prob dropout
on the unnormalised exp(s - m), keep bits from ops/dropout.py (lattice
(query row, key column), salt b * nh + h), kept values times 1 / (1 -
rate) in f32 before the rounding; l stays the undropped sum.

Past 1024 padded tokens it is also the attention of K10 (vitcap_tpu/ops/
fused_block.py:125 _block_kernel and :470 _bert_kernel, whose q-tiled
softmax is the same function) and of 512-px training.
mode_launches counts the launches with dropout, past MAX_LP, and through
attention_qkv ("non_slab").
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
                 "long": 0,       # launches with Lp > MAX_LP
                 "non_slab": 0}   # launches through attention_qkv


def split_slab(slab: torch.Tensor):
    """The q, k, v column blocks of a (B, Lp, 3H) slab, as views."""
    return slab.split(slab.shape[-1] // 3, dim=-1)


def attention_qkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, l_actual: int,
                        bias: Optional[torch.Tensor] = None,
                        rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version: q, k, v (B, Lp, H) -> (B, Lp, H)."""
    B, Lp, H = q.shape
    hd = H // num_heads

    def heads(a):
        return a.reshape(B, Lp, num_heads, hd).transpose(1, 2).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = (qh @ kh.transpose(-1, -2)) * (hd ** -0.5)
    if bias is not None:
        s = s + bias.float()
    if l_actual < Lp:
        s = s.masked_fill(torch.arange(Lp, device=q.device) >= l_actual,
                          NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if rate > 0.0:
        keep = dropout.attention_keep(seed, rate, B, num_heads, Lp,
                                      q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    # probabilities rounded to the compute dtype for the product with v,
    # as the TPU kernels do
    o = (p.to(q.dtype).float() @ vh) / l.clamp_min(1e-30)
    return o.transpose(1, 2).reshape(B, Lp, H).to(q.dtype)


def attention_plain(slab: torch.Tensor, num_heads: int, l_actual: int,
                    bias: Optional[torch.Tensor] = None, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version: slab (B, Lp, 3H) -> (B, Lp, H)."""
    return attention_qkv_plain(*split_slab(slab), num_heads, l_actual, bias,
                               rate, seed)


def operand_args(name: str, t: torch.Tensor, shape, dtype, device):
    """(pointer, batch stride, row stride) of a (B, Lp, H) operand as the
    kernels read it; ValueError on a layout they do not take."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    sb, sr, sc = t.stride()
    unit = 16 // t.element_size()        # 16 bytes: 8 bf16 or 4 f32
    if sc != 1 or sr % unit or sb % unit or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides {t.stride()} at address "
                         f"{t.data_ptr():#x}: the kernels need a unit column "
                         f"stride, batch and row strides in multiples of "
                         f"{unit} elements and a 16-byte aligned base")
    return t.data_ptr(), sb, sr


def check_bias(name: str, bias: Optional[torch.Tensor], B: int, Lp: int,
               device) -> None:
    if bias is not None and (bias.shape != (B, 1, Lp, Lp)
                             or bias.dtype != torch.float32
                             or bias.device != device
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous f32 ({B}, 1, "
                         f"{Lp}, {Lp}), got {tuple(bias.shape)} {bias.dtype}")


def check_heads(name: str, H: int, num_heads: int, max_hd: int) -> int:
    if num_heads <= 0 or H % num_heads:
        raise ValueError(f"{name}: H={H} not divisible by {num_heads}")
    hd = H // num_heads
    if hd % 8 or hd > max_hd:
        raise ValueError(f"{name}: head dim {hd} must be a multiple of 8 "
                         f"up to {max_hd}")
    return hd


def _attention(q, k, v, num_heads, l_actual, bias, rate, seed, non_slab):
    drop = dropout.kernel_args(rate, seed)
    if q.device.type == "cpu":
        return attention_qkv_plain(q, k, v, num_heads, l_actual, bias, rate,
                                   seed)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention: no kernel for device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"attention: q must be (B, Lp, H), got "
                         f"{tuple(q.shape)}")
    B, Lp, H = q.shape
    hd = check_heads("attention", H, num_heads, 128)
    args = [a for name, t in (("q", q), ("k", k), ("v", v))
            for a in operand_args(f"attention: {name}", t, (B, Lp, H),
                                  q.dtype, q.device)]
    if not 1 <= l_actual <= Lp:
        raise ValueError(f"attention: l_actual={l_actual} outside [1, {Lp}]")
    check_bias("attention", bias, B, Lp, q.device)
    out = torch.empty((B, Lp, H), dtype=q.dtype, device=q.device)
    lib = _build.library()
    rc = lib.vc_attention(*args,
                          bias.data_ptr() if bias is not None else None,
                          out.data_ptr(), B, Lp, H, num_heads, int(l_actual),
                          float(hd ** -0.5), *drop,
                          _build.dtype_code(q.dtype),
                          torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "attention")
    global launches
    launches += 1
    mode_launches["dropout"] += rate > 0.0
    mode_launches["long"] += Lp > MAX_LP
    mode_launches["non_slab"] += non_slab
    return out


def attention(slab: torch.Tensor, num_heads: int, l_actual: int,
              bias: Optional[torch.Tensor] = None, rate: float = 0.0,
              seed: int = 0) -> torch.Tensor:
    """slab (B, Lp, 3H) -> (B, Lp, H); rate > 0 drops probabilities with
    the int32 `seed` (ignored at rate 0)."""
    if slab.dim() != 3 or slab.shape[-1] % 3:
        raise ValueError(f"attention: slab must be (B, Lp, 3H), got "
                         f"{tuple(slab.shape)}")
    return _attention(*split_slab(slab), num_heads, l_actual, bias, rate,
                      seed, False)


def attention_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int, l_actual: int,
                  bias: Optional[torch.Tensor] = None, rate: float = 0.0,
                  seed: int = 0) -> torch.Tensor:
    """q, k, v (B, Lp, H), each any layout the kernel reads by stride (see
    operand_args) -> contiguous (B, Lp, H); bias, rate and seed as for
    attention()."""
    return _attention(q, k, v, num_heads, l_actual, bias, rate, seed, True)
