"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel has its wrappers (gemm, layer_norm, attention, attention_qkv
and attention_heads, attention_bwd.attention_bwd, attention_bwd_qkv and
attention_bwd_heads, decode_step.decode_attention;
flash_attention.flash_attention_packed and flash_attention.flash_attention
are the autograd Functions over the two attention kernels).  A wrapper
runs the plain PyTorch version for tensors on the CPU and launches the CUDA
kernel for tensors on a CUDA device; there is no switch and no fallback.
Each wrapper counts its kernel launches in a plain int, so a run can show
that the main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from . import (attention, attention_bwd, decode_step, fused_block, gemm,
               layer_norm)

# each kernel's name and the module whose `launches` counts it
KERNELS = {"gemm": gemm, "layer_norm": layer_norm, "attention": attention,
           "attention_bwd": attention_bwd, "decode_attention": decode_step}


def reset_counts() -> None:
    for m in KERNELS.values():
        m.launches = 0
        for k in getattr(m, "mode_launches", {}):
            m.mode_launches[k] = 0
    for k in fused_block.calls:
        fused_block.calls[k] = 0


def launch_counts() -> Dict[str, int]:
    return {name: m.launches for name, m in KERNELS.items()}


def mode_counts() -> Dict[str, int]:
    """Launches of the kernels' modes, as 'kernel[mode]': gemm's and
    layer_norm's K6 / K7 extensions; attention's and attention_bwd's prob
    dropout, lengths past 1024 padded tokens (K10, 512-px training),
    launches on separate q, k, v (K8 non-slab) and on per-head q, k, v
    (K9, with its online mode past 1024) and at head dims past 64
    (attention[hdp128]); layer_norm's rows wider than 1024
    (layer_norm[wide]); decode_attention's cluster launches over more
    than one beam group an image (constrained beam search)."""
    return {f"{name}[{k}]": n for name, m in KERNELS.items()
            for k, n in getattr(m, "mode_launches", {}).items()}


def call_counts() -> Dict[str, int]:
    """CUDA calls of the compositions that stand for one TPU kernel each:
    fused_block.fused_vit_attn (K11) and fused_block.tail_train (K12),
    each four launches of the kernels above."""
    return dict(fused_block.calls)
