"""gemm: out = a @ w.T with f32 accumulation and a fused epilogue.

Kernel: csrc/gemm.cu (bf16 on the tensor cores through WMMA, f32 on the
CUDA cores with no TF32).  It replaces the matrix products inside the TPU
kernels of vitcap_tpu/ops/fused_block.py (_qkv_kernel, _tail_kernel,
_bert_qkv_kernel, _bert_tail_kernel); the source note in csrc/gemm.cu says
what bounds it on the H100 and what its design does about that.

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

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, dropout as _dropout

launches = 0
# launches of the train epilogues (a subset of `launches`)
mode_launches = {"pre_out": 0, "dropout": 0}


Dropout = Tuple[float, int, int, int]   # rate, seed, which, rows_per_image


def gemm_plain(a: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, gelu: bool = False,
               residual: Optional[torch.Tensor] = None,
               f32_sum: bool = False, out_f32: bool = False,
               pre_out: Optional[torch.Tensor] = None,
               dropout: Optional[Dropout] = None) -> torch.Tensor:
    """Plain PyTorch version: a (M, K), w (N, K) -> (M, N)."""
    dt = a.dtype
    acc = a.float() @ w.float().t()
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
                     torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "gemm")
    global launches
    launches += 1
    mode_launches["pre_out"] += pre_out is not None
    mode_launches["dropout"] += dropout is not None
    return out
