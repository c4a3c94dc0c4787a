"""attention: multi-head softmax attention over q, k, v read by stride.

Kernel: csrc/attention.cu.  It replaces _attn_pairbd_kernel /
_attn_perhead_kernel and _bert_attn_pairbd_kernel /
_bert_attn_perhead_kernel of vitcap_tpu/ops/fused_block.py, and is the
forward of K9 (vitcap_tpu/ops/flash_attention.py:846 flash_attention); the
source note in csrc/attention.cu says what bounds it on the H100.

Three entry points launch the one kernel: attention() over a fused (B, Lp,
3H) qkv slab (the blocks; q, k, v are its three H-wide column blocks),
attention_qkv() over separate (B, Lp, H) q, k, v (the packed train route,
ops/flash_attention.py), and attention_heads() over per-head (B, nH, L,
dh) q, k, v (K9, ops/flash_attention.py flash_attention).  The kernel reads
each operand by base pointer and batch, head and row strides; it takes any
layout whose base pointers are 16-byte aligned and whose strides are
multiples of 16 bytes with unit column stride, and the wrapper raises on
any other and never copies.

Semantics of the TPU kernels: f32 scores times hd^-0.5, plus the optional
additive f32 bias, (B, 1, Lp, Lp) or per head (B, nH, Lp, Lp); keys with
index >= l_actual masked with -1e30; f32 softmax statistics; the
unnormalised probabilities rounded to the operands' dtype for the product
with v; the output divided by max(l, 1e-30) and stored in that dtype.
Padded query rows are computed like any other and are the caller's to
discard.

With ``rate`` > 0 it is also the train forward of K8
(vitcap_tpu/ops/flash_attention.py:949 flash_fwd_packed_slab on the slab,
:670 _flash_fwd_packed on separate q, k, v; kernels :452
_fwd_packed_kernel / :484 _fwd_packed_pair_kernel): attention-prob dropout
on the unnormalised exp(s - m), keep bits from ops/dropout.py (lattice
(query row, key column), salt the global head b * nh + h), kept values
times 1 / (1 - rate) in f32 before the rounding; l stays the undropped
sum.  Under tensor parallelism a call runs heads [head_offset, head_offset
+ nh) of nh_total and salts with b * nh_total + head_offset + h, so each
rank drops what the unsplit model drops for its heads.

Past 1024 padded tokens it is also the attention of K10 (vitcap_tpu/ops/
fused_block.py:125 _block_kernel and :470 _bert_kernel, whose q-tiled
softmax is the same function) and of 512-px training.  K9 past 1024
(:129 _kernel) computes another function, the ``online`` mode: q
pre-scaled in its own dtype, and a softmax that runs online over key tiles
of ONLINE_TK with each tile's probabilities rounded against that tile's
running max (attention_heads_plain says it line for line).
The bf16 kernels are built per head width: plan(hd) picks the instance,
the fewest of HD_INSTANCES columns (64, 80, 96, 128) that hold hd, whose
tiles keep the head dim at that width in shared memory (hd padded with
zeros up to it): the model zoo's ViT-H/14 at 80 and old ViT-S/16 at 96
each run an instance of their own width.  mode_launches counts the
launches with dropout, past MAX_LP, through attention_qkv ("non_slab"),
through attention_heads ("heads"), in the online mode, at a head dim past
64 ("hd>64": the 80-, 96- and 128-column instances) and on a
tensor-parallel rank's head slice with the global salt ("tp": nh_total
past the call's heads).  kernel_info() reads the bf16 kernels' launch
configuration (registers, spills, shared memory, resident blocks per SM)
on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, dropout
from ._build import launch_info

NEG = -1e30
launches = 0
MAX_LP = 1024       # the TPU package's longest single-q-tile length;
                    # longer slabs are K10's (its q-tiled kernels)
ONLINE_TK = 128     # K9's key tile past MAX_LP (flash_attention.py TK)
mode_launches = {"dropout": 0,    # launches with prob dropout
                 "long": 0,       # launches with Lp > MAX_LP
                 "non_slab": 0,   # launches through attention_qkv
                 "heads": 0,      # launches through attention_heads (K9)
                 "online": 0,     # launches in the online mode (K9 > 1024)
                 "hd>64": 0,      # launches at a head dim past 64
                 "tp": 0}         # launches on a tensor-parallel head slice
HD_INSTANCES = (64, 80, 96, 128)  # the bf16 kernels' head columns
WG_Q = 128          # query rows of a bf16 block (two warpgroups)
WG_KT = 64          # keys of a bf16 K or V tile (ONLINE_TK in the online mode)
SMEM_LIMIT = 232448  # shared bytes a block can have on the H100


def plan(hd: int) -> int:
    """The bf16 kernels' instance for head dim hd, the one place the choice
    is made: the fewest head columns of HD_INSTANCES that hold hd (the
    tiles zero-filled past it).  64: one panel of 64 columns in the
    128-byte swizzle; 80 and 96: that panel and a tail panel of 16 or 32
    columns in the 32- or 64-byte swizzle (q . k^T in 5 or 6 k-steps of
    16, p . v with N = 64 + 16 or 32); 128: two panels."""
    check_head_dim("attention", hd, max(HD_INSTANCES))
    return next(w for w in HD_INSTANCES if hd <= w)


def instance_smem(hdp: int, online: bool = False) -> int:
    """Dynamic shared bytes of a bf16 block of instance hdp
    (csrc/attention.cu WgSmem): the WG_Q q rows, two stages of K and of V
    tiles (WG_KT keys, ONLINE_TK in the online mode), 1024 bytes to align
    the base."""
    kt = ONLINE_TK if online else WG_KT
    return WG_Q * hdp * 2 + 4 * kt * hdp * 2 + 1024


def split_slab(slab: torch.Tensor):
    """The q, k, v column blocks of a (B, Lp, 3H) slab, as views."""
    return slab.split(slab.shape[-1] // 3, dim=-1)


def heads_view(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H) -> its (B, nH, L, H / nH) per-head view (no copy)."""
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads)) \
        .transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, nH, L, dh) -> (B, L, nH * dh); a view when t is heads_view of a
    contiguous tensor."""
    B, nh, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, nh * hd)


def _online_plain(q, k, v, l_actual, bias):
    """K9's q-tiled kernel past 1024 (vitcap_tpu/ops/flash_attention.py:129
    _kernel), per-head (B, nH, Lp, hd) -> f32 (B, nH, Lp, hd) before the
    final rounding."""
    dt = q.dtype
    qs = (q * torch.tensor(q.shape[-1] ** -0.5, dtype=dt)).float()
    m = torch.full(q.shape[:-1] + (1,), NEG, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, l_actual, ONLINE_TK):
        cols = slice(k0, k0 + ONLINE_TK)
        s = qs @ k[:, :, cols].float().transpose(-1, -2)
        if bias is not None:
            s = s + bias[..., cols].float()
        kidx = torch.arange(k0, k0 + s.shape[-1], device=q.device)
        s = s.masked_fill(kidx >= l_actual, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(dt).float() @ v[:, :, cols].float()
        m = m_new
    return acc / l.clamp_min(1e-30)


def attention_heads_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          l_actual: int, bias: Optional[torch.Tensor] = None,
                          rate: float = 0.0, seed: int = 0,
                          online: bool = False, nh_total: int = 0,
                          head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version over per-head q, k, v (B, nH, Lp, hd) -> (B,
    nH, Lp, hd) in q's dtype; bias (B, 1 | nH, Lp, Lp) or None; online:
    K9's q-tiled function (no dropout); nh_total, head_offset: the dropout
    salt's global heads (module docstring)."""
    B, nh, Lp, hd = q.shape
    if online:
        return _online_plain(q, k, v, l_actual, bias).to(q.dtype)
    s = (q.float() @ k.float().transpose(-1, -2)) * (hd ** -0.5)
    if bias is not None:
        s = s + bias.float()
    if l_actual < Lp:
        s = s.masked_fill(torch.arange(Lp, device=q.device) >= l_actual,
                          NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if rate > 0.0:
        keep = dropout.attention_keep(seed, rate, B, nh, Lp, q.device,
                                      nh_total, head_offset)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    # probabilities rounded to the compute dtype for the product with v,
    # as the TPU kernels do
    o = (p.to(q.dtype).float() @ v.float()) / l.clamp_min(1e-30)
    return o.to(q.dtype)


def attention_qkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, l_actual: int,
                        bias: Optional[torch.Tensor] = None,
                        rate: float = 0.0, seed: int = 0, nh_total: int = 0,
                        head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: q, k, v (B, Lp, H) -> (B, Lp, H)."""
    return merge_heads(attention_heads_plain(
        *(heads_view(t, num_heads) for t in (q, k, v)), l_actual, bias,
        rate, seed, False, nh_total, head_offset))


def attention_plain(slab: torch.Tensor, num_heads: int, l_actual: int,
                    bias: Optional[torch.Tensor] = None, rate: float = 0.0,
                    seed: int = 0, nh_total: int = 0,
                    head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: slab (B, Lp, 3H) -> (B, Lp, H)."""
    return attention_qkv_plain(*split_slab(slab), num_heads, l_actual, bias,
                               rate, seed, nh_total, head_offset)


def operand_args(name: str, t: torch.Tensor, shape, dtype, device):
    """(pointer, batch, head and row strides) of a per-head (B, nH, Lp,
    hd) operand as the kernels read it; ValueError on a layout they do not
    take."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    sb, sh, sr, sc = t.stride()
    unit = 16 // t.element_size()        # 16 bytes: 8 bf16 or 4 f32
    if sc != 1 or sr % unit or sb % unit or sh % unit or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides {t.stride()} at address "
                         f"{t.data_ptr():#x}: the kernels need a unit column "
                         f"stride, batch, head and row strides in multiples "
                         f"of {unit} elements and a 16-byte aligned base")
    return t.data_ptr(), sb, sh, sr


def bias_args(name: str, bias: Optional[torch.Tensor], B: int, nh: int,
              Lp: int, device):
    """(pointer or None, batch stride, head stride) of a contiguous f32
    (B, 1 | nH, Lp, Lp) bias; head stride 0 broadcasts it over the
    heads."""
    if bias is None:
        return None, 0, 0
    if (bias.dim() != 4 or bias.shape[0] != B or bias.shape[1] not in (1, nh)
            or bias.shape[2:] != (Lp, Lp) or bias.dtype != torch.float32
            or bias.device != device or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous f32 ({B}, 1 or "
                         f"{nh}, {Lp}, {Lp}), got {tuple(bias.shape)} "
                         f"{bias.dtype}")
    return (bias.data_ptr(), bias.stride(0),
            bias.stride(1) if bias.shape[1] > 1 else 0)


def check_head_dim(name: str, hd: int, max_hd: int) -> None:
    if hd % 8 or not 8 <= hd <= max_hd:
        raise ValueError(f"{name}: head dim {hd} must be a multiple of 8 "
                         f"up to {max_hd}")


def _attention(q, k, v, l_actual, bias, rate, seed, online, mode,
               nh_total=0, head_offset=0):
    """q, k, v per-head (B, nH, Lp, hd) -> (B, nH, Lp, hd): the plain
    version for CPU tensors, else the kernel, whose (B, Lp, H) output is
    returned as its per-head view.  mode: 'slab', 'non_slab' or 'heads'
    (which entry point launched it)."""
    drop = dropout.kernel_args(rate, seed)
    if online and rate > 0.0:
        raise ValueError("attention: the online mode takes no dropout")
    nh_total = dropout.heads_total(q.shape[1], nh_total, head_offset)
    if q.device.type == "cpu":
        return attention_heads_plain(q, k, v, l_actual, bias, rate, seed,
                                     online, nh_total, head_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention: no kernel for device {q.device}")
    B, nh, Lp, hd = q.shape
    hdp = plan(hd)
    args = [a for name, t in (("q", q), ("k", k), ("v", v))
            for a in operand_args(f"attention: {name}", t, (B, nh, Lp, hd),
                                  q.dtype, q.device)]
    if not 1 <= l_actual <= Lp:
        raise ValueError(f"attention: l_actual={l_actual} outside [1, {Lp}]")
    out = torch.empty((B, Lp, nh * hd), dtype=q.dtype, device=q.device)
    lib = _build.library()
    rc = lib.vc_attention(*args, *bias_args("attention", bias, B, nh, Lp,
                                            q.device),
                          out.data_ptr(), B, Lp, nh * hd, nh, int(l_actual),
                          float(hd ** -0.5), *drop, nh_total,
                          int(head_offset), int(online), hdp,
                          _build.dtype_code(q.dtype),
                          torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "attention")
    global launches
    launches += 1
    mode_launches["dropout"] += rate > 0.0
    mode_launches["long"] += Lp > MAX_LP
    mode_launches["online"] += bool(online)
    mode_launches["hd>64"] += hd > 64
    mode_launches["tp"] += nh_total != nh
    if mode != "slab":
        mode_launches[mode] += 1
    return heads_view(out, nh)


def kernel_info() -> list:
    """The bf16 attention kernels' launch configuration on the current
    CUDA device (ops._build.launch_info)."""
    return launch_info("vc_attention_kernel_info")


def check_heads(name: str, H: int, num_heads: int) -> None:
    if num_heads <= 0 or H % num_heads:
        raise ValueError(f"{name}: H={H} not divisible by {num_heads}")


def attention(slab: torch.Tensor, num_heads: int, l_actual: int,
              bias: Optional[torch.Tensor] = None, rate: float = 0.0,
              seed: int = 0, nh_total: int = 0,
              head_offset: int = 0) -> torch.Tensor:
    """slab (B, Lp, 3H) -> (B, Lp, H); bias None or (B, 1 | nH, Lp, Lp);
    rate > 0 drops probabilities with the int32 `seed` (ignored at rate
    0); the slab's heads are [head_offset, head_offset + num_heads) of
    nh_total for the dropout salt (nh_total 0: num_heads, offset 0)."""
    if slab.dim() != 3 or slab.shape[-1] % 3:
        raise ValueError(f"attention: slab must be (B, Lp, 3H), got "
                         f"{tuple(slab.shape)}")
    check_heads("attention", slab.shape[-1] // 3, num_heads)
    return merge_heads(_attention(
        *(heads_view(t, num_heads) for t in split_slab(slab)), l_actual,
        bias, rate, seed, False, "slab", nh_total, head_offset))


def attention_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int, l_actual: int,
                  bias: Optional[torch.Tensor] = None, rate: float = 0.0,
                  seed: int = 0, nh_total: int = 0,
                  head_offset: int = 0) -> torch.Tensor:
    """q, k, v (B, Lp, H), each any layout the kernel reads by stride (see
    operand_args) -> contiguous (B, Lp, H); bias, rate, seed, nh_total and
    head_offset as for attention()."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"attention: {name} must be (B, Lp, H), got "
                             f"{tuple(t.shape)}")
    check_heads("attention", q.shape[-1], num_heads)
    return merge_heads(_attention(
        *(heads_view(t, num_heads) for t in (q, k, v)), l_actual, bias,
        rate, seed, False, "non_slab", nh_total, head_offset))


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    online: bool = False) -> torch.Tensor:
    """K9's forward: per-head q, k, v (B, nH, L, dh), each any layout the
    kernel reads by stride (see operand_args), bias None or f32 (B, 1 | nH,
    L, L) -> (B, nH, L, dh), on CUDA the per-head view of a contiguous (B,
    L, nH * dh) tensor.  online: the q-tiled function K9 computes past
    1024 padded tokens."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"attention: {name} must be (B, nH, L, dh) "
                             f"like q, got {tuple(t.shape)}")
    return _attention(q, k, v, q.shape[2], bias, 0.0, 0, online, "heads")
