"""layer_norm: f32 row statistics, scale and shift, store in a chosen dtype.

Kernel: csrc/layer_norm.cu.  It replaces the LayerNorm sections of the TPU
kernels in vitcap_tpu/ops/fused_block.py (LN1 of _qkv_kernel, LN2 of
_tail_kernel, the post-LNs of _bert_tail_kernel); the source note in
csrc/layer_norm.cu says what bounds it on the H100.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version, the math of vitcap_tpu.models.layers.layer_norm
    (statistics in f32 whatever the input dtype)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(out_dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """x (rows, H) f32 or bf16 -> (rows, H) in out_dtype."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, out_dtype)
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
    lib = _build.library()
    rc = lib.vc_layer_norm(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                           y.data_ptr(), rows, H, float(eps),
                           _build.dtype_code(x.dtype),
                           _build.dtype_code(out_dtype),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "layer_norm")
    global launches
    launches += 1
    return y
