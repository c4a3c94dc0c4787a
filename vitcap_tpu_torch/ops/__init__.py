"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module (gemm, layer_norm, attention) exposes one wrapper.  The
wrapper runs the plain PyTorch version for tensors on the CPU and launches
the CUDA kernel for tensors on a CUDA device; there is no switch and no
fallback.  Each wrapper counts its kernel launches in a plain int, so a run
can show that the main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from . import attention, gemm, layer_norm

KERNEL_MODULES = (gemm, layer_norm, attention)


def reset_counts() -> None:
    for m in KERNEL_MODULES:
        m.launches = 0


def launch_counts() -> Dict[str, int]:
    return {m.__name__.rsplit(".", 1)[-1]: m.launches for m in KERNEL_MODULES}
