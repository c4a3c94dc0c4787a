"""layer_norm: f32 row statistics, scale and shift, store in a chosen dtype.

Kernel: csrc/layer_norm.cu.  It replaces the LayerNorm sections of the TPU
kernels in vitcap_tpu/ops/fused_block.py (LN1 of _qkv_kernel, LN2 of
_tail_kernel, the post-LNs of _bert_tail_kernel); the source note in
csrc/layer_norm.cu says what bounds it on the H100.

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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype: torch.dtype, stats: bool = False
               ) -> Out:
    """x (rows, H) f32 or bf16 -> (rows, H) in out_dtype; with stats also
    the (rows,) f32 mean and rsig."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, out_dtype, stats)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm: no kernel for device {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"layer_norm: x must be contiguous (rows, H), got "
                         f"{tuple(x.shape)}")
    rows, H = x.shape
    weight = weight.float().contiguous()
    bias = bias.float().contiguous()
    if weight.shape != (H,) or bias.shape != (H,):
        raise ValueError(f"layer_norm: scale/shift must be ({H},)")
    y = torch.empty((rows, H), dtype=out_dtype, device=x.device)
    st = (torch.empty((2, rows), dtype=torch.float32, device=x.device)
          if stats else None)
    lib = _build.library()
    rc = lib.vc_layer_norm(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                           y.data_ptr(),
                           st[0].data_ptr() if stats else None,
                           st[1].data_ptr() if stats else None,
                           rows, H, float(eps),
                           _build.dtype_code(x.dtype),
                           _build.dtype_code(out_dtype),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "layer_norm")
    global launches
    launches += 1
    mode_launches["stats"] += stats
    return (y, st[0], st[1]) if stats else y
