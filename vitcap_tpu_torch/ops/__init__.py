"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel has one wrapper (gemm, layer_norm, attention,
attention_bwd.attention_bwd and decode_step.decode_attention).  The wrapper runs the plain PyTorch version for tensors on the CPU and launches
the CUDA kernel for tensors on a CUDA device; there is no switch and no
fallback.  Each wrapper counts its kernel launches in a plain int, so a run
can show that the main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from . import attention, attention_bwd, decode_step, gemm, layer_norm

# each kernel's name and the module whose `launches` counts it
KERNELS = {"gemm": gemm, "layer_norm": layer_norm, "attention": attention,
           "attention_bwd": attention_bwd, "decode_attention": decode_step}


def reset_counts() -> None:
    for m in KERNELS.values():
        m.launches = 0
        for k in getattr(m, "mode_launches", {}):
            m.mode_launches[k] = 0


def launch_counts() -> Dict[str, int]:
    return {name: m.launches for name, m in KERNELS.items()}


def mode_counts() -> Dict[str, int]:
    """Launches of the modes of gemm, layer_norm and attention (the K6 / K7
    / K8-forward extensions, and attention past 1024 padded tokens for
    K10), as 'kernel[mode]'."""
    return {f"{name}[{k}]": n for name, m in KERNELS.items()
            for k, n in getattr(m, "mode_launches", {}).items()}
