"""RegNetX / RegNetY of the model zoo: the port of
vitcap_tpu/models/regnet.py.

Per-block widths from the quantised linear rule u_j = w0 + wa * j,
snapped to w0 * wm^round(log(u / w0) / log(wm)) and rounded to multiples
of 8; each distinct width is a stage.  The group width is capped at the
stage width and the width snapped to a multiple of it.  A block: 1x1 conv
+ BN + relu, 3x3 grouped conv (stride) + BN + relu, SE for regnety
(round(block in * 0.25) channels, relu, sigmoid gate), 1x1 conv + BN; a
1x1 conv + BN projection where the shape changes; add, relu.  The stem is
3x3/2 to 32 + BN + relu; the head a linear layer on the pooled map.

State-dict names: stem.{conv, bn}, s{k}.b{j}.{conv1, conv2, conv3}.{conv,
bn}, .se.{fc1, fc2}, .downsample.{conv, bn}, head.fc.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (_batch_norm, _cb, _conv, _cv, _norm_sd, _oihw,
                        _se_apply, head_dropout, train_opts)
from .efficientnet import _se_sd
from .layers import _Group, dense

# name -> (w0, wa, wm, group_w, depth, se_ratio)
REGNETS = {
    "regnetx_002": (24, 36.44, 2.49, 8, 13, 0.0),
    "regnetx_004": (24, 24.48, 2.54, 16, 22, 0.0),
    "regnetx_006": (48, 36.97, 2.24, 24, 16, 0.0),
    "regnetx_008": (56, 35.73, 2.28, 16, 16, 0.0),
    "regnetx_016": (80, 34.01, 2.25, 24, 18, 0.0),
    "regnetx_032": (88, 26.31, 2.25, 48, 25, 0.0),
    "regnetx_040": (96, 38.65, 2.43, 40, 23, 0.0),
    "regnetx_064": (184, 60.83, 2.07, 56, 17, 0.0),
    "regnetx_080": (80, 49.56, 2.88, 120, 23, 0.0),
    "regnetx_120": (168, 73.36, 2.37, 112, 19, 0.0),
    "regnetx_160": (216, 55.59, 2.1, 128, 22, 0.0),
    "regnetx_320": (320, 69.86, 2.0, 168, 23, 0.0),
    "regnety_002": (24, 36.44, 2.49, 8, 13, 0.25),
    "regnety_004": (48, 27.89, 2.09, 8, 16, 0.25),
    "regnety_006": (48, 32.54, 2.32, 16, 15, 0.25),
    "regnety_008": (56, 38.84, 2.4, 16, 14, 0.25),
    "regnety_016": (48, 20.71, 2.65, 24, 27, 0.25),
    "regnety_032": (80, 42.63, 2.66, 24, 21, 0.25),
    "regnety_040": (96, 31.41, 2.24, 64, 22, 0.25),
    "regnety_064": (112, 33.22, 2.27, 72, 25, 0.25),
    "regnety_080": (192, 76.82, 2.19, 56, 17, 0.25),
    "regnety_120": (168, 73.36, 2.37, 112, 19, 0.25),
    "regnety_160": (200, 106.23, 2.48, 112, 18, 0.25),
    "regnety_320": (232, 115.89, 2.53, 232, 20, 0.25),
}

STEM_WIDTH = 32


def _generate_widths(w0: int, wa: float, wm: float, depth: int,
                     q: int = 8) -> List[int]:
    widths_cont = np.arange(depth) * wa + w0
    width_exps = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, width_exps)
    widths = np.round(np.divide(widths, q)) * q
    return widths.astype(int).tolist()


def regnet_plan(variant: str) -> List[List[dict]]:
    """Stages of block dicts {in, out, stride, group (width), se}."""
    w0, wa, wm, group_w, depth, se_ratio = REGNETS[variant]
    widths = _generate_widths(w0, wa, wm, depth)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    stage_widths = stage_widths.tolist()
    stage_depths = stage_depths.tolist()
    groups = [min(group_w, w) for w in stage_widths]
    stage_widths = [int(round(w / g) * g) for w, g in
                    zip(stage_widths, groups)]
    stages = []
    in_c = STEM_WIDTH
    for out, d, g in zip(stage_widths, stage_depths, groups):
        blocks = []
        for bi in range(d):
            blk_in = in_c if bi == 0 else out
            blocks.append({
                "in": blk_in, "out": out, "stride": 2 if bi == 0 else 1,
                "group": g,
                "se": int(round(blk_in * se_ratio)) if se_ratio else 0,
            })
        in_c = out
        stages.append(blocks)
    return stages


def regnet_feature_channels(variant: str) -> int:
    return regnet_plan(variant)[-1][-1]["out"]


class RegNet(nn.Module):
    """(B, 3, H, W) -> (B, C_last, H / 32, W / 32); `head.fc` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages stages (a
    reduced-depth check).  Each block's last BN scale starts at zero."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        self.plan = regnet_plan(variant)[:n_stages or None]
        self.stem = _cb(3, STEM_WIDTH, 3, device)
        for si, blocks in enumerate(self.plan):
            stage = _Group()
            for bi, b in enumerate(blocks):
                cin, out = b["in"], b["out"]
                m = _Group(conv1=_cb(cin, out, 1, device),
                           conv2=_cb(out, out, 3, device,
                                     out // b["group"]),
                           conv3=_cb(out, out, 1, device, zero_init=True))
                if b["se"]:
                    m.se = _Group(fc1=_cv(out, b["se"], 1, device, bias=True),
                                  fc2=_cv(b["se"], out, 1, device, bias=True))
                if cin != out or b["stride"] != 1:
                    m.downsample = _cb(cin, out, 1, device)
                setattr(stage, f"b{bi + 1}", m)
            setattr(self, f"s{si + 1}", stage)
        self.num_features = self.plan[-1][-1]["out"]
        if num_classes:
            self.head = _Group(fc=nn.Linear(self.num_features, num_classes,
                                            device=device))

    def _blocks(self):
        for si, blocks in enumerate(self.plan):
            for bi, b in enumerate(blocks):
                yield b, getattr(getattr(self, f"s{si + 1}"), f"b{bi + 1}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def cba(y, m, stride=1, groups=1, act=True):
            k = m.conv.weight.shape[-1]
            return _batch_norm(_conv(y, m.conv.weight, stride, k // 2,
                                     groups), m.bn, act)

        x = cba(x, self.stem, 2)
        for b, m in self._blocks():
            y = cba(x, m.conv1)
            y = cba(y, m.conv2, b["stride"], b["out"] // b["group"])
            if b["se"]:
                y = _se_apply(y, m.se)
            y = cba(y, m.conv3, act=False)
            shortcut = (cba(x, m.downsample, b["stride"], act=False)
                        if hasattr(m, "downsample") else x)
            x = F.relu(y + shortcut)
        return x

    def classify(self, pooled: torch.Tensor) -> torch.Tensor:
        return dense(self.head.fc, head_dropout(pooled, train_opts(self)))


def regnet_from_jax(p) -> dict:
    """The JAX package's init_regnet tree -> RegNet names."""
    sd = {"stem.conv.weight": _oihw(p["stem"]["conv"]),
          **_norm_sd(p["stem"]["bn"], "stem.bn.")}
    for si, blocks in enumerate(p["stages"]):
        for bi, bp in enumerate(blocks):
            base = f"s{si + 1}.b{bi + 1}."
            for i in (1, 2, 3):
                sd[f"{base}conv{i}.conv.weight"] = _oihw(bp[f"conv{i}"])
                sd.update(_norm_sd(bp[f"bn{i}"], f"{base}conv{i}.bn."))
            if "se_p" in bp:
                sd.update(_se_sd(bp["se_p"], base + "se.", ("fc1", "fc2")))
            if "down_conv" in bp:
                sd[base + "downsample.conv.weight"] = _oihw(bp["down_conv"])
                sd.update(_norm_sd(bp["down_bn"], base + "downsample.bn."))
    return sd
