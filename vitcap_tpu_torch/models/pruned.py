"""Pruned-variant shape manifests: the port of vitcap_tpu/models/pruned.py.

Each manifest maps the torch state-dict keys of a pruned architecture's
convs (and ECA kernels) to their weight shapes (the pruning of arxiv
2002.08258, timm's pruned/*.txt); backbones.ResNet reads the widths of
ecaresnet50d_pruned and ecaresnet101d_pruned from them, and
efficientnet.effnet_plan those of efficientnet_b1/b2/b3_pruned.  The JSON
files are the data files the JAX package ships
(vitcap_tpu/assets/pruned/), read by path through
utils.common.asset_path.
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Dict, List

from ..utils.common import asset_path

PRUNED_VARIANTS = (
    "efficientnet_b1_pruned", "efficientnet_b2_pruned",
    "efficientnet_b3_pruned", "ecaresnet50d_pruned",
    "ecaresnet101d_pruned",
)


@lru_cache(maxsize=None)
def pruned_shapes(variant: str) -> Dict[str, List[int]]:
    """{torch state-dict key: weight shape} of the pruned variant."""
    with open(asset_path("pruned", variant + ".json")) as f:
        return json.load(f)
