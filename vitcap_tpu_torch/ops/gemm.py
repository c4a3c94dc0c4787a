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
  ``out_f32`` stores the f32 sum that a post-norm LayerNorm reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

launches = 0


def gemm_plain(a: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, gelu: bool = False,
               residual: Optional[torch.Tensor] = None,
               f32_sum: bool = False, out_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch version: a (M, K), w (N, K) -> (M, N)."""
    dt = a.dtype
    acc = a.float() @ w.float().t()
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
    if gelu:
        y = F.gelu(y.float()).to(dt)
    return y.float() if out_f32 else y


def gemm(a: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None, gelu: bool = False,
         residual: Optional[torch.Tensor] = None, f32_sum: bool = False,
         out_f32: bool = False) -> torch.Tensor:
    """a (M, K) and w (N, K) in the compute dtype; bias (N,) any float type
    (used as f32); residual (M, N) in the compute dtype."""
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, gelu, residual, f32_sum, out_f32)
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
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else a.dtype,
                      device=a.device)
    lib = _build.library()
    rc = lib.vc_gemm(a.data_ptr(), w.data_ptr(),
                     bias.data_ptr() if bias is not None else None,
                     residual.data_ptr() if residual is not None else None,
                     out.data_ptr(), M, N, K, _build.dtype_code(a.dtype),
                     int(gelu), int(f32_sum), int(out_f32),
                     torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "gemm")
    global launches
    launches += 1
    return out
