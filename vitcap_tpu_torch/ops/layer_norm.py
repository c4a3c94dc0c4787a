"""layer_norm: f32 row statistics, scale and shift, store in a chosen dtype.

Kernel: csrc/layer_norm.cu.  It replaces the LayerNorm sections of the TPU
kernels in vitcap_tpu/ops/fused_block.py (LN1 of _qkv_kernel, LN2 of
_tail_kernel, the post-LNs of _bert_tail_kernel); the source note in
csrc/layer_norm.cu says what bounds it on the H100.  vector_path() is the
wrapper's choice between the kernel's two loops: each row held in registers
with 16-byte accesses (H a multiple of 8, at most 1024, aligned tensors: the
port's 768) or the scalar loop (any other H).  kernel_info() reads the
kernel's launch configuration on the card.

``stats=True`` (the train forwards: LN1/LN2 of K6, the post-LNs of K7) also
returns each row's f32 mean and rsig = 1 / sqrt(var + eps), which the
analytic backwards read instead of recomputing them.
"""

from __future__ import annotations

import torch

from typing import Tuple, Union

from . import _build

launches = 0
mode_launches = {"stats": 0}      # launches with row statistics
VEC = 8                           # values per 16-byte chunk of the row
MAX_VEC_H = 1024                  # the widest row held in registers


Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     out_dtype: torch.dtype, stats: bool = False) -> Out:
    """Plain PyTorch version, the math of vitcap_tpu.models.layers.layer_norm
    (statistics in f32 whatever the input dtype)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rsig = torch.rsqrt(var + eps)
    y = ((xf - mean) * rsig * weight.float() + bias.float()).to(out_dtype)
    return (y, mean[..., 0], rsig[..., 0]) if stats else y


def vector_path(H: int, *tensors: torch.Tensor) -> bool:
    """True when rows of H values take the kernel's registers and 16-byte
    accesses: H a multiple of VEC, at most MAX_VEC_H, every tensor's data
    16-byte aligned; else the scalar loop."""
    return (H % VEC == 0 and H <= MAX_VEC_H
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def check_args(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> Tuple[int, int]:
    """The kernel's argument rules: x contiguous (rows, H) f32 or bf16,
    scale and shift (H,).  -> (rows, H); raises ValueError otherwise."""
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] < 1:
        raise ValueError(f"layer_norm: x must be contiguous (rows, H), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layer_norm: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    rows, H = x.shape
    if weight.shape != (H,) or bias.shape != (H,):
        raise ValueError(f"layer_norm: scale/shift must be ({H},), got "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    return rows, H


def kernel_info() -> list:
    """The four layer_norm_kernel instances' launch configuration on the
    current CUDA device (ops._build.launch_info)."""
    return _build.launch_info("vc_layer_norm_kernel_info")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype: torch.dtype, stats: bool = False
               ) -> Out:
    """x (rows, H) f32 or bf16 -> (rows, H) in out_dtype; with stats also
    the (rows,) f32 mean and rsig."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, out_dtype, stats)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm: no kernel for device {x.device}")
    rows, H = check_args(x, weight, bias)
    weight = weight.float().contiguous()
    bias = bias.float().contiguous()
    y = torch.empty((rows, H), dtype=out_dtype, device=x.device)
    st = (torch.empty((2, rows), dtype=torch.float32, device=x.device)
          if stats else None)
    lib = _build.library()
    rc = lib.vc_layer_norm(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                           y.data_ptr(),
                           st.data_ptr() if stats else None,
                           st.data_ptr() + 4 * rows if stats else None,
                           rows, H, float(eps),
                           _build.dtype_code(x.dtype),
                           _build.dtype_code(out_dtype),
                           int(vector_path(H, x, weight, bias, y)),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "layer_norm")
    global launches
    launches += 1
    mode_launches["stats"] += stats
    return (y, st[0], st[1]) if stats else y
