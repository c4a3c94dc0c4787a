"""MixNet S / M / L / XL / XXL and the tf_ twins of the model zoo: the
port of vitcap_tpu/models/mixnet.py.

The effnet builder's ds and ir blocks with mixed convs: a MixedConv2d
splits the channels over its kernel list (the first chunk takes the
remainder), convolves each chunk with its own kernel (depthwise for
conv_dw, 1x1 for the expand and project convs, whose out channels split
likewise) and concatenates them.  Per-block relu or swish, SE from the
block's in channels (ratio .5 / .25, the block's act inside), the deeper
nets scaled by round(repeats * dm) shared out over a stage's entries; a
1x1 conv_head to 1536, BN, relu; the classifier on the pooled map.  The
tf_ twins pad TF-'SAME' with BatchNorm eps 1e-3.

State-dict names: conv_stem, bn1, blocks.{s}.{i}.{conv_dw, conv_pw,
conv_pwl}[.{j}].weight (.{j} where the conv mixes kernels), se.*, bn1-3,
conv_head, bn2, classifier.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _conv, _cv, _norm_sd,
                        _oihw)
from .efficientnet import (BN_EPS_TF, _dw, _pad, _se, _se_module,
                           blocks_from_jax, make_divisible, round_channels,
                           scale_stage_repeats)
from .layers import _Group


def _split_channels(c: int, n: int) -> List[int]:
    split = [c // n] * n
    split[0] += c - sum(split)
    return split


def _b(t, r, ks, ek, pk, s, e, c, se=0.0, a="re"):
    """(type, repeats, dw kernels, expand kernels, project kernels,
    stride, expand, out, se, act)."""
    return (t, r, ks, ek, pk, s, e, c, se, a)


_ARCH_S = (
    (_b("ds", 1, (3,), (1,), (1,), 1, 1, 16),),
    (_b("ir", 1, (3,), (1, 1), (1, 1), 2, 6, 24),
     _b("ir", 1, (3,), (1, 1), (1, 1), 1, 3, 24)),
    (_b("ir", 1, (3, 5, 7), (1,), (1,), 2, 6, 40, 0.5, "sw"),
     _b("ir", 3, (3, 5), (1, 1), (1, 1), 1, 6, 40, 0.5, "sw")),
    (_b("ir", 1, (3, 5, 7), (1,), (1, 1), 2, 6, 80, 0.25, "sw"),
     _b("ir", 2, (3, 5), (1,), (1, 1), 1, 6, 80, 0.25, "sw")),
    (_b("ir", 1, (3, 5, 7), (1, 1), (1, 1), 1, 6, 120, 0.5, "sw"),
     _b("ir", 2, (3, 5, 7, 9), (1, 1), (1, 1), 1, 3, 120, 0.5, "sw")),
    (_b("ir", 1, (3, 5, 7, 9, 11), (1,), (1,), 2, 6, 200, 0.5, "sw"),
     _b("ir", 2, (3, 5, 7, 9), (1,), (1, 1), 1, 6, 200, 0.5, "sw")),
)
_ARCH_M = (
    (_b("ds", 1, (3,), (1,), (1,), 1, 1, 24),),
    (_b("ir", 1, (3, 5, 7), (1, 1), (1, 1), 2, 6, 32),
     _b("ir", 1, (3,), (1, 1), (1, 1), 1, 3, 32)),
    (_b("ir", 1, (3, 5, 7, 9), (1,), (1,), 2, 6, 40, 0.5, "sw"),
     _b("ir", 3, (3, 5), (1, 1), (1, 1), 1, 6, 40, 0.5, "sw")),
    (_b("ir", 1, (3, 5, 7), (1,), (1,), 2, 6, 80, 0.25, "sw"),
     _b("ir", 3, (3, 5, 7, 9), (1, 1), (1, 1), 1, 6, 80, 0.25, "sw")),
    (_b("ir", 1, (3,), (1,), (1,), 1, 6, 120, 0.5, "sw"),
     _b("ir", 3, (3, 5, 7, 9), (1, 1), (1, 1), 1, 3, 120, 0.5, "sw")),
    (_b("ir", 1, (3, 5, 7, 9), (1,), (1,), 2, 6, 200, 0.5, "sw"),
     _b("ir", 3, (3, 5, 7, 9), (1,), (1, 1), 1, 6, 200, 0.5, "sw")),
)

# name -> (arch, cm, dm, stem)
MIXNETS = {
    "mixnet_s": (_ARCH_S, 1.0, 1.0, 16),
    "mixnet_m": (_ARCH_M, 1.0, 1.0, 24),
    "mixnet_l": (_ARCH_M, 1.3, 1.0, 24),
    "mixnet_xl": (_ARCH_M, 1.6, 1.2, 24),
    "mixnet_xxl": (_ARCH_M, 2.4, 1.3, 24),
}
TF_MIXNETS = {"tf_mixnet_s": "mixnet_s", "tf_mixnet_m": "mixnet_m",
              "tf_mixnet_l": "mixnet_l"}
MIXNET_FEATURES = 1536


def _resolve(variant: str):
    """-> (the base variant, TF-'SAME' padding and BN eps 1e-3)."""
    if variant in TF_MIXNETS:
        return TF_MIXNETS[variant], True
    return variant, False


def mixnet_plan(variant: str):
    variant, _ = _resolve(variant)
    arch, cm, dm, stem0 = MIXNETS[variant]
    stem = round_channels(stem0, cm)
    in_c = stem
    stages = []
    for row in arch:
        reps_row = scale_stage_repeats([b[1] for b in row], dm, "round") \
            if dm != 1.0 else [b[1] for b in row]
        blocks = []
        for (bt, r, ks, ek, pk, s, e, c, se, a), reps in zip(row, reps_row):
            out = round_channels(c, cm)
            for bi in range(reps):
                blocks.append({
                    "type": bt, "ks": ks, "ek": ek, "pk": pk,
                    "stride": s if bi == 0 else 1,
                    "in": in_c, "mid": make_divisible(in_c * e), "out": out,
                    "se": make_divisible(in_c * se, 1) if se > 0 else 0,
                    "act": a,
                })
                in_c = out
        stages.append(blocks)
    return stem, stages, MIXNET_FEATURES


def mixnet_feature_channels(variant: str) -> int:
    return MIXNET_FEATURES


def _act(kind: str):
    return F.relu if kind == "re" else F.silu


def _mixed(cin: int, cout: int, kernels, device, dw: bool = False):
    """timm's conv (one kernel) or MixedConv2d (a ModuleDict .0, .1, ...)."""
    if len(kernels) == 1:
        return _cv(cin, cout, kernels[0], device, cin if dw else 1)
    si, so = _split_channels(cin, len(kernels)), \
        _split_channels(cout, len(kernels))
    return _Group(**{str(j): _cv(i, o, k, device, i if dw else 1)
                     for j, (k, i, o) in enumerate(zip(kernels, si, so))})


def _mixed_apply(x: torch.Tensor, m, stride: int = 1, same: bool = False,
                 dw: bool = False) -> torch.Tensor:
    """Each channel chunk through its own kernel, padded for it alone."""
    if isinstance(m, nn.Conv2d):
        return (_dw(x, m.weight, stride, same) if dw
                else _conv(x, m.weight))
    convs = list(m.children())
    chunks = torch.split(x, _split_channels(x.shape[1], len(convs)), dim=1)
    return torch.cat([_dw(c, cv.weight, stride, same) if dw
                      else _conv(c, cv.weight)
                      for c, cv in zip(chunks, convs)], dim=1)


class MixNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 1536, H / 32, W / 32); `classifier` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages stages (a
    reduced-depth check)."""
    head_name = "classifier"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        stem, stages, pen = mixnet_plan(variant)
        self.plan = stages[:n_stages or None]
        _, self.same = _resolve(variant)
        eps = BN_EPS_TF if self.same else 1e-5

        def bn(c):
            return _bn(c, device, eps)
        self.conv_stem = _cv(3, stem, 3, device)
        self.bn1 = bn(stem)
        blocks = []
        for row in self.plan:
            mods = []
            for b in row:
                cin, mid, out = b["in"], b["mid"], b["out"]
                if b["type"] == "ds":
                    m = _Group(conv_dw=_mixed(cin, cin, b["ks"], device, True),
                               bn1=bn(cin),
                               conv_pw=_mixed(cin, out, b["pk"], device),
                               bn2=bn(out))
                    mid = cin
                else:
                    m = _Group(conv_pw=_mixed(cin, mid, b["ek"], device),
                               bn1=bn(mid),
                               conv_dw=_mixed(mid, mid, b["ks"], device, True),
                               bn2=bn(mid),
                               conv_pwl=_mixed(mid, out, b["pk"], device),
                               bn3=bn(out))
                if b["se"]:
                    m.se = _se_module(mid, b["se"], device)
                mods.append(m)
            blocks.append(nn.ModuleList(mods))
        self.blocks = nn.ModuleList(blocks)
        self.conv_head = _cv(self.plan[-1][-1]["out"], pen, 1, device)
        self.bn2 = bn(pen)
        self.num_features = pen
        if num_classes:
            self.classifier = nn.Linear(pen, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        same = self.same

        def bn(y, norm):
            return _batch_norm(y, norm, act=False)
        x = F.relu(bn(_conv(x, self.conv_stem.weight, 2, _pad(3, same)),
                      self.bn1))
        for blocks, mods in zip(self.plan, self.blocks):
            for blk, m in zip(blocks, mods):
                act = _act(blk["act"])
                s = blk["stride"]
                if blk["type"] == "ds":
                    y = act(bn(_mixed_apply(x, m.conv_dw, s, same, True),
                               m.bn1))
                    if blk["se"]:
                        y = _se(y, m.se, act)
                    y = bn(_mixed_apply(y, m.conv_pw), m.bn2)
                else:
                    y = act(bn(_mixed_apply(x, m.conv_pw), m.bn1))
                    y = act(bn(_mixed_apply(y, m.conv_dw, s, same, True),
                               m.bn2))
                    if blk["se"]:
                        y = _se(y, m.se, act)
                    y = bn(_mixed_apply(y, m.conv_pwl), m.bn3)
                x = y + x if s == 1 and blk["in"] == blk["out"] else y
        return F.relu(bn(_conv(x, self.conv_head.weight), self.bn2))


def mixnet_from_jax(p) -> dict:
    """The JAX package's init_mixnet tree -> MixNet names."""
    return {"conv_stem.weight": _oihw(p["stem"]["conv"]),
            **_norm_sd(p["stem"]["bn"], "bn1."),
            **blocks_from_jax(p["stages"]),
            "conv_head.weight": _oihw(p["pen"]["conv"]),
            **_norm_sd(p["pen"]["bn"], "bn2.")}
