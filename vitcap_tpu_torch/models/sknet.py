"""The Selective-Kernel ResNets of the model zoo: the port of
vitcap_tpu/models/sknet.py.

- SelectiveKernelConv: two 3x3 paths at dilations 1 and 2 (the 3 and 5
  kernels with keep_3x3), each conv + BN + relu; split_input halves the
  input channels over the paths.  Attention: the channel means of the
  paths' sum, a 1x1 fc_reduce (no bias), BN + relu on that pooled
  (B, C, 1, 1) vector, a 1x1 fc_select to 2 * C, a softmax over the
  paths, the paths' weighted sum.  attn channels = max(out /
  attn_reduction, min_attn_channels).
- Blocks: basic = SK conv + 3x3 conv + BN; bottleneck = 1x1 + SK conv
  (groups = cardinality) + 1x1 + BN; the residual add, relu.
- The ResNet shell: the 7x7 stem, or skresnet50d's deep stem with the
  avg-pool downsample; a linear `fc` on the pooled map.

State-dict names: timm's ResNet layout, the SK conv's
convN.paths.{0,1}.{conv,bn} and convN.attn.{fc_reduce,bn,fc_select}.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _avg_pool2, _batch_norm, _bn, _cb,
                        _cb_sd, _conv, _cv, _norm_sd, _oihw, _t)
from .layers import _Group

# name -> (layers, block, stem, down, card, bw, attn_red, attn_min, split)
SKNETS = {
    "skresnet18": ((2, 2, 2, 2), "basic", "7x7", "conv", 1, 64, 8, 16,
                   True),
    "skresnet34": ((3, 4, 6, 3), "basic", "7x7", "conv", 1, 64, 8, 16,
                   True),
    "skresnet50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv", 1, 64, 16,
                   32, True),
    "skresnet50d": ((3, 4, 6, 3), "bottleneck", "deep", "avg", 1, 64, 16,
                    32, True),
    "skresnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv", 32,
                          4, 16, 32, False),
}
_PLANES = (64, 128, 256, 512)
_DILATIONS = (1, 2)          # keep_3x3 on the [3, 5] default kernel list


def sknet_feature_channels(variant: str) -> int:
    return _PLANES[-1] * (1 if SKNETS[variant][1] == "basic" else 4)


def _sk(cin: int, cout: int, card: int, red: int, amin: int, split: bool,
        device) -> _Group:
    attn = max(int(cout / red), amin)
    pin = cin // 2 if split else cin
    return _Group(
        paths=nn.ModuleList(_cb(pin, cout, 3, device, card)
                            for _ in _DILATIONS),
        attn=_Group(fc_reduce=_cv(cout, attn, 1, device),
                    bn=_bn(attn, device),
                    fc_select=_cv(attn, 2 * cout, 1, device)))


def _sk_conv(x: torch.Tensor, m, stride: int, groups: int, split: bool
             ) -> torch.Tensor:
    xs = x.chunk(2, dim=1) if split else (x, x)
    paths = [_batch_norm(_conv(xp, p.conv.weight, stride, d, groups, d),
                         p.bn)
             for xp, p, d in zip(xs, m.paths, _DILATIONS)]
    gap = (paths[0] + paths[1]).mean(dim=(2, 3), keepdim=True)
    a = _batch_norm(_conv(gap, m.attn.fc_reduce.weight), m.attn.bn)
    a = _conv(a, m.attn.fc_select.weight)                # (B, 2C, 1, 1)
    a = torch.softmax(a.unflatten(1, (2, -1)), dim=1)    # over the paths
    return paths[0] * a[:, 0] + paths[1] * a[:, 1]


class SkNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, C, H / 32, W / 32); `fc` with num_classes > 0.
    n_stages > 0 keeps the first n_stages layers."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        layers, block, stem, down, card, bw, red, amin, split = \
            SKNETS[variant]
        self.cfg = SKNETS[variant]
        if stem == "deep":
            self.conv1 = _Group(**{"0": _cv(3, 32, 3, device),
                                   "1": _bn(32, device),
                                   "3": _cv(32, 32, 3, device),
                                   "4": _bn(32, device),
                                   "6": _cv(32, 64, 3, device)})
        else:
            self.conv1 = _cv(3, 64, 7, device)
        self.bn1 = _bn(64, device)
        prev = 64
        dci = 1 if down == "avg" else 0
        self.n_stages = len(layers[:n_stages or None])
        for si, depth in enumerate(layers[:self.n_stages]):
            planes = _PLANES[si]
            width = int(planes * bw / 64) * card
            out = planes * (1 if block == "basic" else 4)
            blocks = []
            for b in range(depth):
                if block == "bottleneck":
                    blk = _Group(conv1=_cb(prev, width, 1, device),
                                 conv2=_sk(width, width, card, red, amin,
                                           split, device),
                                 conv3=_cb(width, out, 1, device))
                else:
                    blk = _Group(conv1=_sk(prev, planes, card, red, amin,
                                           split, device),
                                 conv2=_cb(planes, out, 3, device))
                s = (1 if si == 0 else 2) if b == 0 else 1
                if b == 0 and (s != 1 or prev != out):
                    blk.downsample = _Group(**{
                        str(dci): _cv(prev, out, 1, device),
                        str(dci + 1): _bn(out, device)})
                blocks.append(blk)
                prev = out
            setattr(self, f"layer{si + 1}", nn.ModuleList(blocks))
        self.num_features = prev
        if num_classes:
            self.fc = nn.Linear(prev, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, block, stem, down, card, _, _, _, split = self.cfg
        if stem == "deep":
            st = self.conv1
            x = _batch_norm(_conv(x, getattr(st, "0").weight, 2, 1),
                            getattr(st, "1"))
            x = _batch_norm(_conv(x, getattr(st, "3").weight, 1, 1),
                            getattr(st, "4"))
            x = _batch_norm(_conv(x, getattr(st, "6").weight, 1, 1),
                            self.bn1)
        else:
            x = _batch_norm(_conv(x, self.conv1.weight, 2, 3), self.bn1)
        # after a relu, zero padding equals -inf padding
        x = F.max_pool2d(x, 3, 2, 1)
        dci = 1 if down == "avg" else 0
        for si in range(self.n_stages):
            for bi, blk in enumerate(getattr(self, f"layer{si + 1}")):
                s = (1 if si == 0 else 2) if bi == 0 else 1
                shortcut = x
                if hasattr(blk, "downsample"):
                    w = getattr(blk.downsample, str(dci)).weight
                    d = (_conv(_avg_pool2(x) if s == 2 else x, w)
                         if down == "avg" else _conv(x, w, s))
                    shortcut = _batch_norm(
                        d, getattr(blk.downsample, str(dci + 1)), act=False)
                if block == "bottleneck":
                    y = _batch_norm(_conv(x, blk.conv1.conv.weight),
                                    blk.conv1.bn)
                    y = _sk_conv(y, blk.conv2, s, card, split)
                    y = _batch_norm(_conv(y, blk.conv3.conv.weight),
                                    blk.conv3.bn, act=False)
                else:
                    y = _sk_conv(x, blk.conv1, s, card, split)
                    y = _batch_norm(_conv(y, blk.conv2.conv.weight, 1, 1),
                                    blk.conv2.bn, act=False)
                x = F.relu(y + shortcut)
        return x


def sknet_from_jax(p) -> dict:
    """The JAX package's init_sknet tree -> SkNet names."""
    st = p["stem"]
    if "conv2" in st:
        sd = {"conv1.0.weight": _oihw(st["conv1"]),
              **_norm_sd(st["bn1"], "conv1.1."),
              "conv1.3.weight": _oihw(st["conv2"]),
              **_norm_sd(st["bn2"], "conv1.4."),
              "conv1.6.weight": _oihw(st["conv3"]),
              **_norm_sd(st["bn3"], "bn1.")}
        dci = 1
    else:
        sd = _cb_sd(st["conv1"], st["bn1"], "conv1.weight", "bn1.")
        dci = 0

    def sk(q, base):
        out = {}
        for i, pq in enumerate(q["paths"]):
            out.update(_cb_sd(pq["conv"], pq["bn"],
                              f"{base}.paths.{i}.conv.weight",
                              f"{base}.paths.{i}.bn."))
        a = q["attn"]
        out[base + ".attn.fc_reduce.weight"] = _t(a["reduce_w"]).t()[
            :, :, None, None].contiguous()
        out.update(_norm_sd(a["bn"], base + ".attn.bn."))
        out[base + ".attn.fc_select.weight"] = _t(a["select_w"]).t()[
            :, :, None, None].contiguous()
        return out

    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            base = f"layer{si + 1}.{bi}."
            if "conv1" in blk:
                sd.update(_cb_sd(blk["conv1"], blk["bn1"],
                                 base + "conv1.conv.weight", base + "conv1.bn."))
                sd.update(sk(blk["sk"], base + "conv2"))
                sd.update(_cb_sd(blk["conv3"], blk["bn3"],
                                 base + "conv3.conv.weight", base + "conv3.bn."))
            else:
                sd.update(sk(blk["sk"], base + "conv1"))
                sd.update(_cb_sd(blk["conv2"], blk["bn2"],
                                 base + "conv2.conv.weight", base + "conv2.bn."))
            if "down_conv" in blk:
                sd.update(_cb_sd(blk["down_conv"], blk["down_bn"],
                                 f"{base}downsample.{dci}.weight",
                                 f"{base}downsample.{dci + 1}."))
    return sd
