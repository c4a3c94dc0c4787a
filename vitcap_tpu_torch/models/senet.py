"""The legacy SENets of the model zoo (the Cadene-layout SENet-154,
SE-ResNet and SE-ResNeXt): the port of vitcap_tpu/models/senet.py.

- SE module: channel means, a 1x1 fc1 (bias) + relu, a 1x1 fc2 (bias),
  a sigmoid gate, reduce = channels // 16; on the block's output before
  the residual add.
- Blocks: se154 (1x1 to 2 * planes, grouped 3x3 to 4 * planes, 1x1),
  res (the stride on conv1), next (width floor(planes * 4 / 64) *
  groups, the stride on conv2), basic (two 3x3s, relu after bn2, then
  the SE).
- layer0: a 7x7/2 conv, or SENet-154's three 3x3 convs; then
  MaxPool2d(3, 2, ceil_mode=True).  SENet-154's downsample convs are 3x3
  (padding 1) on layers 2-4.
- The classifier is a linear layer, last_linear, on the pooled map.

State-dict names: layer0.conv{i}, layer0.bn{i},
layer{k}.{i}.{conv,bn}{1,2,3}, .se_module.{fc1,fc2}, .downsample.{0,1},
last_linear.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _cb_sd, _conv, _cv,
                        _maxpool_ceil, _norm_sd, _oihw, _se_apply, _t)
from .layers import _Group

# name -> (block, layers, groups, inplanes, input_3x3, down_k)
SENETS = {
    "legacy_seresnet18": ("basic", (2, 2, 2, 2), 1, 64, False, 1),
    "legacy_seresnet34": ("basic", (3, 4, 6, 3), 1, 64, False, 1),
    "legacy_seresnet50": ("res", (3, 4, 6, 3), 1, 64, False, 1),
    "legacy_seresnet101": ("res", (3, 4, 23, 3), 1, 64, False, 1),
    "legacy_seresnet152": ("res", (3, 8, 36, 3), 1, 64, False, 1),
    "legacy_senet154": ("se154", (3, 8, 36, 3), 64, 128, True, 3),
    "legacy_seresnext26_32x4d": ("next", (2, 2, 2, 2), 32, 64, False, 1),
    "legacy_seresnext50_32x4d": ("next", (3, 4, 6, 3), 32, 64, False, 1),
    "legacy_seresnext101_32x4d": ("next", (3, 4, 23, 3), 32, 64, False, 1),
}
_PLANES = (64, 128, 256, 512)


def senet_feature_channels(variant: str) -> int:
    return _PLANES[-1] * (1 if SENETS[variant][0] == "basic" else 4)


def _block_widths(block: str, planes: int, groups: int):
    """(conv1 out, conv2 out) of a block."""
    if block == "se154":
        return planes * 2, planes * 4
    if block == "next":
        w = math.floor(planes * (4 / 64)) * groups
        return w, w
    return planes, planes


def _cbr(x, w, bn, stride=1, groups=1, act=True):
    """conv (padding k // 2) -> BN (-> relu)."""
    return _batch_norm(_conv(x, w, stride, w.shape[-1] // 2, groups), bn, act)


class SeNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, C, ~H / 32, ~W / 32); `last_linear` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages layers."""
    head_name = "last_linear"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        block, layers, groups, inplanes, input_3x3, down_k = SENETS[variant]
        self.block, self.groups = block, groups
        if input_3x3:
            self.layer0 = _Group(
                conv1=_cv(3, 64, 3, device), bn1=_bn(64, device),
                conv2=_cv(64, 64, 3, device), bn2=_bn(64, device),
                conv3=_cv(64, inplanes, 3, device), bn3=_bn(inplanes, device))
        else:
            self.layer0 = _Group(conv1=_cv(3, inplanes, 7, device),
                                 bn1=_bn(inplanes, device))
        prev = inplanes
        exp = 1 if block == "basic" else 4
        self.n_stages = len(layers[:n_stages or None])
        for si, depth in enumerate(layers[:self.n_stages]):
            planes = _PLANES[si]
            out = planes * exp
            c1, c2 = _block_widths(block, planes, groups)
            blocks = []
            for b in range(depth):
                s = (1 if si == 0 else 2) if b == 0 else 1
                if block == "basic":
                    blk = _Group(conv1=_cv(prev, planes, 3, device),
                                 bn1=_bn(planes, device),
                                 conv2=_cv(planes, planes, 3, device, groups),
                                 bn2=_bn(planes, device))
                else:
                    blk = _Group(conv1=_cv(prev, c1, 1, device),
                                 bn1=_bn(c1, device),
                                 conv2=_cv(c1, c2, 3, device, groups),
                                 bn2=_bn(c2, device),
                                 conv3=_cv(c2, out, 1, device),
                                 bn3=_bn(out, device))
                red = out // 16
                blk.se_module = _Group(
                    fc1=_cv(out, red, 1, device, bias=True),
                    fc2=_cv(red, out, 1, device, bias=True))
                if b == 0 and (s != 1 or prev != out):
                    dk = 1 if si == 0 else down_k
                    blk.downsample = _Group(**{"0": _cv(prev, out, dk, device),
                                               "1": _bn(out, device)})
                blocks.append(blk)
                prev = out
            setattr(self, f"layer{si + 1}", nn.ModuleList(blocks))
        self.num_features = prev
        if num_classes:
            self.last_linear = nn.Linear(prev, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = self.layer0
        x = _cbr(x, st.conv1.weight, st.bn1, 2)
        if hasattr(st, "conv3"):
            x = _cbr(x, st.conv2.weight, st.bn2)
            x = _cbr(x, st.conv3.weight, st.bn3)
        x = _maxpool_ceil(x)
        g = self.groups
        for si in range(self.n_stages):
            for bi, blk in enumerate(getattr(self, f"layer{si + 1}")):
                s = (1 if si == 0 else 2) if bi == 0 else 1
                residual = x
                if hasattr(blk, "downsample"):
                    residual = _cbr(x, getattr(blk.downsample, "0").weight,
                                    getattr(blk.downsample, "1"), s, act=False)
                if self.block == "basic":
                    y = _cbr(x, blk.conv1.weight, blk.bn1, s)
                    y = _cbr(y, blk.conv2.weight, blk.bn2, 1, g)
                else:
                    # the res blocks stride conv1 (the Caffe layout)
                    s1, s2 = (s, 1) if self.block == "res" else (1, s)
                    y = _cbr(x, blk.conv1.weight, blk.bn1, s1)
                    y = _cbr(y, blk.conv2.weight, blk.bn2, s2, g)
                    y = _cbr(y, blk.conv3.weight, blk.bn3, act=False)
                x = F.relu(_se_apply(y, blk.se_module) + residual)
        return x


def senet_from_jax(p) -> dict:
    """The JAX package's init_senet tree -> SeNet names."""
    st = p["layer0"]
    sd = {}
    for i in (1, 2, 3):
        if f"conv{i}" in st:
            sd.update(_cb_sd(st[f"conv{i}"], st[f"bn{i}"],
                             f"layer0.conv{i}.weight", f"layer0.bn{i}."))
    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            base = f"layer{si + 1}.{bi}."
            for i in (1, 2, 3):
                if f"conv{i}" in blk:
                    sd.update(_cb_sd(blk[f"conv{i}"], blk[f"bn{i}"],
                                     f"{base}conv{i}.weight", f"{base}bn{i}."))
            se = blk["se"]
            for fc in ("fc1", "fc2"):
                sd[f"{base}se_module.{fc}.weight"] = _t(
                    np.asarray(se[fc + "_w"]).T)[:, :, None, None]
                sd[f"{base}se_module.{fc}.bias"] = _t(se[fc + "_b"])
            if "down_conv" in blk:
                sd[base + "downsample.0.weight"] = _oihw(blk["down_conv"])
                sd.update(_norm_sd(blk["down_bn"], base + "downsample.1."))
    return sd
