"""ResNetV2 / Big Transfer (BiT, resnetv2_*_bitm[_in21k]) of the model zoo:
the port of vitcap_tpu/models/resnetv2.py.

Pre-activation bottlenecks with weight-standardised convs (models/
backbones.py _std_conv: divide by the biased std + 1e-5) at torch's
symmetric k // 2 padding, and GroupNorm(32) + ReLU (_group_norm).  The
stem: a 7x7/2 conv, then BiT's fixed pool (zero padding 1, a 3x3/2 max
pool; the padding can win the max, there being no ReLU before it).  A
block: x_pre = GN + ReLU(x); the shortcut a 1x1 conv of x_pre where the
block projects (the first of each stage); conv1 1x1 -> GN + ReLU -> conv2
3x3 (stride) -> GN + ReLU -> conv3 1x1; add.  Widths (256, 512, 1024,
2048) and the stem's 64 times the width factor; stage 0 stride 1, the
others 2.  A final GN + ReLU; the head a 1x1 conv on the pooled map.

State-dict names: stem.conv, stages.{i}.blocks.{j}.{norm1, conv1, norm2,
conv2, norm3, conv3, downsample.conv}, norm, head.fc (a 1x1 conv).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (_EPS, PooledHead, _cv, _group_norm, _norm_sd, _oihw,
                        _std_conv)
from .efficientnet import make_divisible
from .layers import _Group

# name -> (per-stage block counts, width factor, default num_classes)
RESNETV2S = {}
for _layers, _lname in (((3, 4, 6, 3), "50"), ((3, 4, 23, 3), "101"),
                        ((3, 8, 36, 3), "152")):
    for _wf in (1, 2, 3, 4):
        _n = f"resnetv2_{_lname}x{_wf}_bitm"
        if (_lname, _wf) in (("50", 1), ("50", 3), ("101", 1), ("101", 3),
                             ("152", 2), ("152", 4)):
            RESNETV2S[_n] = (_layers, _wf, 1000)
            RESNETV2S[_n + "_in21k"] = (_layers, _wf, 21843)

_CHANNELS = (256, 512, 1024, 2048)


def resnetv2_plan(variant: str) -> Tuple[int, List[dict]]:
    """(stem channels, stage dicts {depth, out, mid, stride})."""
    layers, wf, _ = RESNETV2S[variant]
    stem = make_divisible(64 * wf)
    stages = []
    for si, (d, c) in enumerate(zip(layers, _CHANNELS)):
        out = make_divisible(c * wf)
        stages.append({"depth": d, "out": out,
                       "mid": make_divisible(out * 0.25),
                       "stride": 1 if si == 0 else 2})
    return stem, stages


def resnetv2_feature_channels(variant: str) -> int:
    return resnetv2_plan(variant)[1][-1]["out"]


def _gn(c: int, device) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=_EPS, device=device)


class ResNetV2(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, C, H / 32, W / 32), post-norm; `head.fc` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages stages (a
    reduced-depth check)."""
    head_name = "head.fc"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        stem, stages = resnetv2_plan(variant)
        self.plan = stages[:n_stages or None]
        self.stem = _Group(conv=_cv(3, stem, 7, device))
        mods, prev = [], stem
        for st in self.plan:
            mid, out = st["mid"], st["out"]
            blocks = []
            for bi in range(st["depth"]):
                blk = _Group(norm1=_gn(prev, device),
                             conv1=_cv(prev, mid, 1, device),
                             norm2=_gn(mid, device),
                             conv2=_cv(mid, mid, 3, device),
                             norm3=_gn(mid, device),
                             conv3=_cv(mid, out, 1, device))
                if bi == 0:
                    blk.downsample = _Group(conv=_cv(prev, out, 1, device))
                blocks.append(blk)
                prev = out
            mods.append(_Group(blocks=nn.ModuleList(blocks)))
        self.stages = nn.ModuleList(mods)
        self.norm = _gn(prev, device)
        self.num_features = prev
        if num_classes:
            self.head = _Group(fc=_cv(prev, num_classes, 1, device,
                                      bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def conv(y, w, stride=1):
            return _std_conv(y, w, stride, w.shape[-1] // 2)

        x = conv(x, self.stem.conv.weight, 2)
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        for st, stage in zip(self.plan, self.stages):
            for bi, blk in enumerate(stage.blocks):
                s = st["stride"] if bi == 0 else 1
                x_pre = _group_norm(x, blk.norm1)
                shortcut = (conv(x_pre, blk.downsample.conv.weight, s)
                            if hasattr(blk, "downsample") else x)
                y = conv(x_pre, blk.conv1.weight)
                y = conv(_group_norm(y, blk.norm2), blk.conv2.weight, s)
                y = conv(_group_norm(y, blk.norm3), blk.conv3.weight)
                x = y + shortcut
        return _group_norm(x, self.norm)


def resnetv2_from_jax(p) -> dict:
    """The JAX package's init_resnetv2 tree -> ResNetV2 names."""
    sd = {"stem.conv.weight": _oihw(p["stem"]["conv"]),
          **_norm_sd(p["norm"], "norm.")}
    for si, blocks in enumerate(p["stages"]):
        for bi, bp in enumerate(blocks):
            base = f"stages.{si}.blocks.{bi}."
            for i in (1, 2, 3):
                sd[f"{base}conv{i}.weight"] = _oihw(bp[f"conv{i}"])
                sd.update(_norm_sd(bp[f"norm{i}"], f"{base}norm{i}."))
            if "down_conv" in bp:
                sd[base + "downsample.conv.weight"] = _oihw(bp["down_conv"])
    return sd

