"""ResNeSt of the model zoo: the port of vitcap_tpu/models/resnest.py.

- The ResNet shell with a deep stem (width 32 for the 'd' nets, 64 for
  the 'e' nets) and the avg-pool downsample.
- A block: 1x1 conv + BN + relu, the split-attention 3x3 conv, an
  AvgPool2d(3, s, padding 1) with count_include_pad on strided blocks
  ('avd': before the split conv when avd_first, else after), 1x1 conv +
  BN (scale zero-initialised), the residual add, relu.
- Split attention: a 3x3 conv with groups = card * radix to gw * radix
  channels, BN + relu (bn0), the sum over the radix, the channel means,
  a grouped 1x1 fc1 (attn = max(gw * radix / 4, 32) channels), BN + relu
  (bn1) on that pooled (B, C, 1, 1) vector, a grouped 1x1 fc2, a softmax
  over the radix within each cardinal group (a sigmoid at radix 1), the
  radix's weighted sum.
- A linear `fc` on the pooled map.

State-dict names: timm's ResNet layout, the split-attention conv's
layer{k}.{i}.conv2.{conv,bn0,fc1,bn1,fc2}.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _avg_pool2, _batch_norm, _bn, _cb_sd,
                        _conv, _cv, _norm_sd, _oihw, _t)
from .layers import _Group

# name -> (layers, stem_width, radix, cardinality, base_width, avd_first)
RESNESTS = {
    "resnest14d": ((1, 1, 1, 1), 32, 2, 1, 64, False),
    "resnest26d": ((2, 2, 2, 2), 32, 2, 1, 64, False),
    "resnest50d": ((3, 4, 6, 3), 32, 2, 1, 64, False),
    "resnest101e": ((3, 4, 23, 3), 64, 2, 1, 64, False),
    "resnest200e": ((3, 24, 36, 3), 64, 2, 1, 64, False),
    "resnest269e": ((3, 30, 48, 8), 64, 2, 1, 64, False),
    "resnest50d_4s2x40d": ((3, 4, 6, 3), 32, 4, 2, 40, True),
    "resnest50d_1s4x24d": ((3, 4, 6, 3), 32, 1, 4, 24, True),
}
_PLANES = (64, 128, 256, 512)


def resnest_feature_channels(variant: str) -> int:
    return _PLANES[-1] * 4


def _conv_b(x: torch.Tensor, m: nn.Conv2d) -> torch.Tensor:
    """A grouped 1x1 conv with its bias, in x's dtype."""
    return F.conv2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), 1, 0, 1,
                    m.groups)


def _split_attn(x: torch.Tensor, m, radix: int) -> torch.Tensor:
    """SplitAttn past its grouped 3x3 conv: x is that conv's output, (B,
    gw * radix, H, W)."""
    x = _batch_norm(x, m.bn0)
    B = x.shape[0]
    if radix > 1:
        xr = x.unflatten(1, (radix, -1))                  # (B, r, gw, H, W)
        gap = xr.sum(dim=1).mean(dim=(2, 3), keepdim=True)
    else:
        gap = x.mean(dim=(2, 3), keepdim=True)
    a = _batch_norm(_conv_b(gap, m.fc1), m.bn1)
    a = _conv_b(a, m.fc2).flatten(1)                      # (B, gw * r)
    if radix == 1:
        return x * torch.sigmoid(a)[:, :, None, None]
    card = m.fc1.groups
    a = torch.softmax(a.view(B, card, radix, -1), dim=2)
    a = a.transpose(1, 2).reshape(B, radix, -1)
    return (xr * a[..., None, None]).sum(dim=1)


class ResNest(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 2048, H / 32, W / 32); `fc` with num_classes >
    0.  n_stages > 0 keeps the first n_stages layers."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        layers, sw, radix, card, bw, avd_first = RESNESTS[variant]
        self.radix, self.card, self.avd_first = radix, card, avd_first
        self.conv1 = _Group(**{"0": _cv(3, sw, 3, device),
                               "1": _bn(sw, device),
                               "3": _cv(sw, sw, 3, device),
                               "4": _bn(sw, device),
                               "6": _cv(sw, 2 * sw, 3, device)})
        self.bn1 = _bn(2 * sw, device)
        prev = 2 * sw
        self.n_stages = len(layers[:n_stages or None])
        for si, depth in enumerate(layers[:self.n_stages]):
            planes = _PLANES[si]
            gw = int(planes * bw / 64) * card
            out = planes * 4
            attn = max(gw * radix // 4, 32)
            blocks = []
            for b in range(depth):
                blk = _Group(
                    conv1=_cv(prev, gw, 1, device), bn1=_bn(gw, device),
                    conv2=_Group(
                        conv=_cv(gw, gw * radix, 3, device, card * radix),
                        bn0=_bn(gw * radix, device),
                        fc1=_cv(gw, attn, 1, device, card, bias=True),
                        bn1=_bn(attn, device),
                        fc2=_cv(attn, gw * radix, 1, device, card,
                                bias=True)),
                    conv3=_cv(gw, out, 1, device),
                    bn3=_bn(out, device, zero_init=True))
                s = (1 if si == 0 else 2) if b == 0 else 1
                if b == 0 and (s != 1 or prev != out):
                    # the avg-down Sequential is [pool, conv, bn]
                    blk.downsample = _Group(**{"1": _cv(prev, out, 1, device),
                                               "2": _bn(out, device)})
                blocks.append(blk)
                prev = out
            setattr(self, f"layer{si + 1}", nn.ModuleList(blocks))
        self.num_features = prev
        if num_classes:
            self.fc = nn.Linear(prev, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = self.conv1
        x = _batch_norm(_conv(x, getattr(st, "0").weight, 2, 1),
                        getattr(st, "1"))
        x = _batch_norm(_conv(x, getattr(st, "3").weight, 1, 1),
                        getattr(st, "4"))
        x = _batch_norm(_conv(x, getattr(st, "6").weight, 1, 1), self.bn1)
        x = F.max_pool2d(x, 3, 2, 1)
        for si in range(self.n_stages):
            for bi, blk in enumerate(getattr(self, f"layer{si + 1}")):
                s = (1 if si == 0 else 2) if bi == 0 else 1
                avd = s > 1
                shortcut = x
                if hasattr(blk, "downsample"):
                    d = _avg_pool2(x) if s == 2 else x
                    shortcut = _batch_norm(
                        _conv(d, getattr(blk.downsample, "1").weight),
                        getattr(blk.downsample, "2"), act=False)
                y = _batch_norm(_conv(x, blk.conv1.weight), blk.bn1)
                if avd and self.avd_first:
                    y = F.avg_pool2d(y, 3, s, 1)
                y = _conv(y, blk.conv2.conv.weight, 1 if avd else s, 1,
                          self.card * self.radix)
                y = _split_attn(y, blk.conv2, self.radix)
                if avd and not self.avd_first:
                    y = F.avg_pool2d(y, 3, s, 1)
                y = _batch_norm(_conv(y, blk.conv3.weight), blk.bn3,
                                act=False)
                x = F.relu(y + shortcut)
        return x


def _grouped_fc_sd(w, b, key: str) -> dict:
    """A JAX grouped fc (card, in / card, out / card) -> a grouped 1x1
    conv's (out, in / card, 1, 1) weight, group g's outputs at rows
    g * out / card onwards."""
    w = np.asarray(w, np.float32)
    rows = np.concatenate([w[g].T for g in range(w.shape[0])], axis=0)
    return {key + ".weight": _t(rows)[:, :, None, None].contiguous(),
            key + ".bias": _t(b)}


def resnest_from_jax(p) -> dict:
    """The JAX package's init_resnest tree -> ResNest names."""
    st = p["stem"]
    sd = {"conv1.0.weight": _oihw(st["conv1"]),
          **_norm_sd(st["bn1"], "conv1.1."),
          "conv1.3.weight": _oihw(st["conv2"]),
          **_norm_sd(st["bn2"], "conv1.4."),
          "conv1.6.weight": _oihw(st["conv3"]),
          **_norm_sd(st["bn3"], "bn1.")}
    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            base = f"layer{si + 1}.{bi}."
            c2 = blk["conv2"]
            sd.update({**_cb_sd(blk["conv1"], blk["bn1"],
                                base + "conv1.weight", base + "bn1."),
                       **_cb_sd(c2["conv"], c2["bn0"],
                                base + "conv2.conv.weight",
                                base + "conv2.bn0."),
                       **_grouped_fc_sd(c2["fc1_w"], c2["fc1_b"],
                                        base + "conv2.fc1"),
                       **_norm_sd(c2["bn1"], base + "conv2.bn1."),
                       **_grouped_fc_sd(c2["fc2_w"], c2["fc2_b"],
                                        base + "conv2.fc2"),
                       **_cb_sd(blk["conv3"], blk["bn3"],
                                base + "conv3.weight", base + "bn3.")})
            if "down_conv" in blk:
                sd.update(_cb_sd(blk["down_conv"], blk["down_bn"],
                                 base + "downsample.1.weight",
                                 base + "downsample.2."))
    return sd
