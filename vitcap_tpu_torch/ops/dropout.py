"""Counter-hash dropout masks, bit for bit those of the TPU kernels.

vitcap_tpu/ops/flash_attention.py:40 ``_dropout_keep`` hashes a (row, col)
lattice coordinate with a seed and a salt through murmur3-fmix32 and keeps
an element when the hash is at least ``rate * 2^32``.  Attention-prob
dropout uses the (query row, key column) lattice with salt = global head
``b * nh + h``; a tensor-parallel rank that runs heads [head_offset,
head_offset + nh) of nh_total salts with ``b * nh_total + head_offset +
h``, the bits the unsplit model draws for its heads.  The BERT tail's
hidden dropout the (token, feature) lattice
with salt ``2 * image + which`` (0: after the out-dense, 1: after fc2).
The same function runs as ``vc_dropout_keep`` in csrc/common.cuh inside
every kernel that drops, so a backward regenerates the forward's mask from
the seed alone and no mask tensor is stored.

Here it is plain PyTorch over int64 tensors kept to 32 bits, for the CPU
and for the regeneration of hidden masks in the BERT train backward.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def threshold(rate: float) -> int:
    """The keep threshold: keep iff hash >= min(int(rate * 2^32), 2^32-1)."""
    return min(int(rate * 4294967296.0), 4294967295)


def seed_u32(seed: int) -> int:
    """An int32 seed bit-cast to uint32 (Python ints of either sign)."""
    return int(seed) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32, in two 16-bit halves of c so no
    int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def kernel_args(rate: float, seed: int):
    """(seed, thresh, inv) as the kernels take them (csrc/common.cuh
    Dropout, whose salt fields the attention wrappers pass apart): rate 0
    is thresh 0 and inv 1, which the kernels read as off."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate == 0.0:
        return seed_u32(seed), 0, 1.0
    return seed_u32(seed), threshold(rate), 1.0 / (1.0 - rate)


def keep_mask(rows: torch.Tensor, cols: torch.Tensor, seed: int, salt,
              rate: float) -> torch.Tensor:
    """Keep bits at broadcast (rows, cols) lattice points; salt an int or
    an int tensor broadcasting against them."""
    r = rows.to(torch.int64) & _M32
    c = cols.to(torch.int64) & _M32
    if not torch.is_tensor(salt):
        salt = torch.tensor(int(salt), dtype=torch.int64, device=r.device)
    s = salt.to(torch.int64) & _M32
    x = (_mul32(r, 0x9E3779B9) + _mul32(c, 0x85EBCA6B) + seed_u32(seed)
         + _mul32(s, 0xC2B2AE35)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= threshold(rate)


def heads_total(nh: int, nh_total: int = 0, head_offset: int = 0) -> int:
    """The global head count of a call over heads [head_offset, head_offset
    + nh) (nh_total 0: the call's own nh); ValueError if they do not fit."""
    total = nh_total or nh
    if head_offset < 0 or head_offset + nh > total:
        raise ValueError(f"heads [{head_offset}, {head_offset + nh}) outside "
                         f"the {total} heads")
    return total


def attention_keep(seed: int, rate: float, B: int, nh: int, Lp: int,
                   device=None, nh_total: int = 0,
                   head_offset: int = 0) -> torch.Tensor:
    """(B, nh, Lp, Lp) attention-prob keep bits: lattice (query, key),
    salt the global head b * nh_total + head_offset + h (nh_total 0: nh),
    so heads [head_offset, head_offset + nh) of a tensor-parallel rank get
    their slice of the unsplit model's bits."""
    total = heads_total(nh, nh_total, head_offset)
    i = torch.arange(Lp, device=device)
    salt = (torch.arange(B, device=device).view(B, 1, 1, 1) * total
            + head_offset + torch.arange(nh, device=device).view(1, nh, 1, 1))
    return keep_mask(i.view(Lp, 1), i.view(1, Lp), seed, salt, rate)


def hidden_keep(seed: int, which: int, rate: float, B: int, L: int, H: int,
                device=None) -> torch.Tensor:
    """(B, L, H) hidden-dropout keep bits of the BERT tail: lattice
    (token, feature), salt 2 * image + which."""
    salt = (torch.arange(B, device=device) * 2 + which).view(B, 1, 1)
    return keep_mask(torch.arange(L, device=device).view(L, 1),
                     torch.arange(H, device=device).view(1, H), seed, salt,
                     rate)
