"""Load a vitcap_tpu JAX param tree into the port's ViTCAP module.

The TPU package's bridge (vitcap_tpu.solver.checkpoint_bridge, numpy only)
already turns its param tree into the reference's torch state dict: names
like 'module.bert.encoder.blocks.0.attn.qkv.weight' and torch layouts
(dense (out, in), conv OIHW).  The port's modules carry exactly those names
without the leading 'module.', and its kernels read the (out, in) layout
directly, so the layout is converted once here and never per call.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def load_jax_params(model: torch.nn.Module, params_np: Dict[str, Any]
                    ) -> torch.nn.Module:
    """Strictly load `params_np` (the JAX param tree with numpy leaves) into
    `model`, in place; returns the model with gradients off (the port is
    inference-only so far)."""
    from vitcap_tpu.solver.checkpoint_bridge import params_to_torch_state_dict
    sd = {}
    for name, arr in params_to_torch_state_dict(params_np).items():
        if name.startswith("module."):
            name = name[len("module."):]
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    model.load_state_dict(sd, strict=True)
    return model.requires_grad_(False)
