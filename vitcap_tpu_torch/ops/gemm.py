"""gemm: out = a @ w.T with f32 accumulation and a fused epilogue.

Kernels: csrc/gemm.cu.  bf16 runs on the tensor cores through wgmma in one
of two kernels that plan() picks per call from (M, N, K):
gemm_wide_kernel (persistent, 128 x 128 tiles, a TMA-fed ring, two
consumer warpgroups taking alternate tiles) for the large-M products of
the encoder, the prefill and the train forward, and gemm_split_kernel (64
x 128 tiles, K split over a thread-block cluster, partials added in rank
order) for the small-M products of the decode step; f32 runs on the CUDA
cores with no TF32.  It replaces the matrix products inside the TPU
kernels of vitcap_tpu/ops/fused_block.py (_qkv_kernel, _tail_kernel,
_bert_qkv_kernel, _bert_tail_kernel and the train kernels K6, K7) and of
vitcap_tpu/ops/decode_step.py (K5); the source note in csrc/gemm.cu says
what bounds each regime on the H100 and what the design does about it.
kernel_info() reads the bf16 kernels' launch configuration on the card.

The epilogue rounds where those TPU kernels round:
- default (_qkv_kernel, _tail_kernel, _bert_qkv_kernel): the product is
  rounded to the compute dtype; the residual, then the bias (rounded), are
  added in the compute dtype; GELU (exact erf) reads that value;
- ``f32_sum`` (_bert_tail_kernel): the bias, then the residual, are added to
  the f32 product; GELU reads the sum rounded to the compute dtype;
  ``out_f32`` stores the f32 sum that a post-norm LayerNorm reads;
- ``dropout=(rate, seed, which, rows_per_image)`` (_bert_tail_train_kernel,
  K7, vitcap_tpu/ops/fused_block.py:1095): the product and the bias are
  each rounded and added in the compute dtype, then hidden dropout in the
  compute dtype (kept values times 1 / (1 - rate) rounded to it; keep bits
  of ops/dropout.py over (token = row % rows_per_image, column), salt
  2 * image + which), then the residual; at rate 0 the same order with no
  mask.

``pre_out`` (an (M, N) tensor of the compute dtype) also receives the value
GELU reads, the pre-GELU fc1 output the train backwards keep (K6 and K7).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, dropout as _dropout
from ..parallel.tensor_parallel import TPShard, all_reduce_tp

launches = 0
# launches of the train epilogues (a subset of `launches`)
mode_launches = {"pre_out": 0, "dropout": 0}


Dropout = Tuple[float, int, int, int]   # rate, seed, which, rows_per_image

WIDE_TILE = (128, 128)    # a gemm_wide_kernel consumer's tile (rows, columns)
SPLIT_TILE = (64, 128)    # gemm_split_kernel's
K_STEP = 64               # both kernels' k-step
MAX_RANKS = 8             # the portable thread-block cluster size
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, N: int, K: int, sms: int = H100_SMS) -> int:
    """The bf16 kernel of an (M, K) . (N, K)^T product on a card of `sms`
    SMs, the one place the choice is made: 0 is gemm_wide_kernel, taken
    when its 128 x 128 tiles give both consumer warpgroups of every SM at
    least one; otherwise the number of blocks (1-8) of gemm_split_kernel's
    thread-block clusters, each rank summing an equal share of the 64-deep
    k-steps: at most one block per SM in all (more ranks, or a second
    block per SM, measured slower at the decode shapes), every rank with
    at least one k-step."""
    if _cdiv(M, WIDE_TILE[0]) * _cdiv(N, WIDE_TILE[1]) >= 2 * sms:
        return 0
    tiles = _cdiv(M, SPLIT_TILE[0]) * _cdiv(N, SPLIT_TILE[1])
    nk = max(1, _cdiv(K, K_STEP))
    ranks = min(MAX_RANKS, nk, max(1, sms // tiles))
    return _cdiv(nk, _cdiv(nk, ranks))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_info() -> list:
    """The bf16 gemm kernels' launch configuration on the current CUDA
    device (ops._build.launch_info)."""
    return _build.launch_info("vc_gemm_kernel_info")


def gemm_plain(a: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, gelu: bool = False,
               residual: Optional[torch.Tensor] = None,
               f32_sum: bool = False, out_f32: bool = False,
               pre_out: Optional[torch.Tensor] = None,
               dropout: Optional[Dropout] = None) -> torch.Tensor:
    """Plain PyTorch version: a (M, K), w (N, K) -> (M, N)."""
    return epilogue_plain(a.float() @ w.float().t(), a.dtype, bias, gelu,
                          residual, f32_sum, out_f32, pre_out, dropout)


def epilogue_plain(acc: torch.Tensor, dt: torch.dtype,
                   bias: Optional[torch.Tensor] = None, gelu: bool = False,
                   residual: Optional[torch.Tensor] = None,
                   f32_sum: bool = False, out_f32: bool = False,
                   pre_out: Optional[torch.Tensor] = None,
                   dropout: Optional[Dropout] = None) -> torch.Tensor:
    """gemm_plain's epilogue on an f32 product `acc` (M, N), rounding to the
    compute dtype `dt` where the kernels round."""
    if dropout is not None:
        rate, seed, which, rows = dropout
        y = acc.to(dt)
        if bias is not None:
            y = y + bias.to(dt)
        if rate > 0.0:
            M, N = y.shape
            keep = _dropout.hidden_keep(seed, which, rate, M // rows, rows,
                                        N, y.device).view(M, N)
            inv = torch.tensor(1.0 / (1.0 - rate), dtype=dt)
            y = torch.where(keep, y * inv.to(y.device), 0.0).to(dt)
        if residual is not None:
            y = residual + y
        return y.float() if out_f32 else y
    if f32_sum:
        if bias is not None:
            acc = acc + bias.float()
        if gelu:
            acc = F.gelu(acc.to(dt).float())
        if residual is not None:
            acc = acc + residual.float()
        return acc if out_f32 else acc.to(dt)
    y = acc.to(dt)
    if residual is not None:
        y = y + residual
    if bias is not None:
        y = y + bias.to(dt)
    if pre_out is not None:
        pre_out.copy_(y)
    if gelu:
        y = F.gelu(y.float()).to(dt)
    return y.float() if out_f32 else y


def gemm(a: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None, gelu: bool = False,
         residual: Optional[torch.Tensor] = None, f32_sum: bool = False,
         out_f32: bool = False, pre_out: Optional[torch.Tensor] = None,
         dropout: Optional[Dropout] = None) -> torch.Tensor:
    """a (M, K) and w (N, K) in the compute dtype; bias (N,) any float type
    (used as f32); residual (M, N) in the compute dtype; pre_out (M, N) in
    the compute dtype, default epilogue only; dropout (rate, seed, which,
    rows_per_image) selects the K7 epilogue, without GELU or f32 sums."""
    if (pre_out is not None or dropout is not None) and f32_sum:
        raise ValueError("gemm: pre_out and dropout take the rounded "
                         "epilogues, not f32_sum")
    if dropout is not None and (gelu or pre_out is not None
                                or a.shape[0] % dropout[3]):
        raise ValueError("gemm: the dropout epilogue takes no GELU and "
                         "whole images of rows_per_image rows")
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, gelu, residual, f32_sum, out_f32,
                          pre_out, dropout)
    if a.device.type != "cuda":
        raise RuntimeError(f"gemm: no kernel for device {a.device}")
    M, K = a.shape
    N = w.shape[0]
    if w.shape != (N, K) or w.dtype != a.dtype or w.device != a.device:
        raise ValueError(f"gemm: w {tuple(w.shape)} {w.dtype} does not match "
                         f"a {tuple(a.shape)} {a.dtype}")
    if K % 8:
        raise ValueError(f"gemm: K={K} must be a multiple of 8 (16-byte rows)")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm: a and w must be contiguous")
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (N,) or bias.device != a.device:
            raise ValueError(f"gemm: bias {tuple(bias.shape)} for N={N}")
    if residual is not None:
        if (residual.shape != (M, N) or residual.dtype != a.dtype
                or residual.device != a.device
                or not residual.is_contiguous()):
            raise ValueError(f"gemm: residual {tuple(residual.shape)} "
                             f"{residual.dtype} for ({M}, {N}) {a.dtype}")
    if pre_out is not None and (pre_out.shape != (M, N)
                                or pre_out.dtype != a.dtype
                                or pre_out.device != a.device
                                or not pre_out.is_contiguous()):
        raise ValueError(f"gemm: pre_out must be contiguous ({M}, {N}) "
                         f"{a.dtype}")
    rate, seed, which, rows = dropout if dropout is not None else (0.0, 0,
                                                                   0, 1)
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else a.dtype,
                      device=a.device)
    index = a.device.index
    split = plan(M, N, K, _sm_count(torch.cuda.current_device()
                                    if index is None else index))
    lib = _build.library()
    rc = lib.vc_gemm(a.data_ptr(), w.data_ptr(),
                     bias.data_ptr() if bias is not None else None,
                     residual.data_ptr() if residual is not None else None,
                     out.data_ptr(),
                     pre_out.data_ptr() if pre_out is not None else None,
                     M, N, K, _build.dtype_code(a.dtype),
                     int(gelu), int(f32_sum), int(out_f32),
                     int(dropout is not None),
                     *_dropout.kernel_args(rate, seed), int(which), int(rows),
                     split, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "gemm")
    global launches
    launches += 1
    mode_launches["pre_out"] += pre_out is not None
    mode_launches["dropout"] += dropout is not None
    return out


def row_gemm(gemm_, tp: Optional[TPShard], a: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None, **epilogue) -> torch.Tensor:
    """A row-split product (proj / out-dense, fc2) under tensor
    parallelism: gemm_ (gemm or gemm_plain) of this rank's slice of the
    input and of w's columns as an f32 partial sum with no bias and no
    residual, the partials summed over the model axis, then the epilogue
    once, as epilogue_plain on the full sum (the kernels' rounding; the
    bias added once).  Without a shard: gemm_(a, w, bias, **epilogue)."""
    if tp is None:
        return gemm_(a, w, bias, **epilogue)
    acc = all_reduce_tp(gemm_(a, w, f32_sum=True, out_f32=True), tp)
    return epilogue_plain(acc, a.dtype, bias, **epilogue)
