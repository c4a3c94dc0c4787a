"""Xception of the model zoo: the port of vitcap_tpu/models/xception.py.

- Entry: a 3x3/2 conv and a 3x3 conv, both VALID (no padding), each BN +
  relu.
- 12 blocks (XCEPTION_BLOCKS): reps of [relu, separable conv (a 3x3
  depthwise conv, padding 1, then a 1x1 pointwise conv), BN], block 1
  without the first relu; a strided block ends in MaxPool2d(3, stride,
  1) (padding by -inf); a 1x1 conv + BN skip where the shape changes,
  else the block's input itself, taken before any relu; the residual
  add.  grow_first=False (block 12) widens on its LAST rep.
- Exit: separable convs 1024 -> 1536 and 1536 -> 2048, each BN + relu;
  a linear `fc` on the pooled map.

State-dict names: conv1, bn1, conv2, bn2,
block{n}.rep.{i}.{conv1,pointwise} (the separable conv) and
block{n}.rep.{i + 1} (its BN), block{n}.{skip,skipbn},
conv{3,4}.{conv1,pointwise}, bn3, bn4, fc.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import PooledHead, _batch_norm, _bn, _cb_sd, _conv, _cv, \
    _norm_sd, _oihw
from .layers import _Group

# (in, out, reps, stride, start_relu, grow_first)
XCEPTION_BLOCKS = (
    (64, 128, 2, 2, False, True),
    (128, 256, 2, 2, True, True),
    (256, 728, 2, 2, True, True),
    (728, 728, 3, 1, True, True),
    (728, 728, 3, 1, True, True),
    (728, 728, 3, 1, True, True),
    (728, 728, 3, 1, True, True),
    (728, 728, 3, 1, True, True),
    (728, 728, 3, 1, True, True),
    (728, 728, 3, 1, True, True),
    (728, 728, 3, 1, True, True),
    (728, 1024, 2, 2, True, False),
)
XCEPTION_FEATURES = 2048
_MIDDLE = (728, 728, 3, 1, True, True)


def xception_feature_channels(variant: str) -> int:
    return XCEPTION_FEATURES


def _rep_channels(cin, cout, reps, grow_first):
    """Per-rep (in, out) channel pairs."""
    if grow_first:
        return [(cin if i == 0 else cout, cout) for i in range(reps)]
    return [(cin, cin if i < reps - 1 else cout) for i in range(reps)]


def _sep_p(cin: int, cout: int, device) -> _Group:
    return _Group(conv1=_cv(cin, cin, 3, device, cin),
                  pointwise=_cv(cin, cout, 1, device))


def _sep(x: torch.Tensor, m) -> torch.Tensor:
    """SeparableConv2d: the 3x3 depthwise conv (padding 1), the 1x1."""
    return _conv(_conv(x, m.conv1.weight, 1, 1, x.shape[1]),
                 m.pointwise.weight)


def middle_cut(blocks, middle, n_stages: int):
    """blocks without the middle-flow entries (== middle) past the first
    n_stages (all kept at 0)."""
    mids = [i for i, b in enumerate(blocks) if b == middle]
    drop = set(mids[n_stages:]) if n_stages else set()
    return [b for i, b in enumerate(blocks) if i not in drop]


class Xception(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 2048, ~H / 32, ~W / 32) after the last relu; a
    linear `fc` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages of the middle flow's 728-wide blocks (renumbered)."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        self.cfg = middle_cut(XCEPTION_BLOCKS, _MIDDLE, n_stages)
        self.conv1, self.bn1 = _cv(3, 32, 3, device), _bn(32, device)
        self.conv2, self.bn2 = _cv(32, 64, 3, device), _bn(64, device)
        for bi, (cin, cout, reps, stride, start_relu, grow) in \
                enumerate(self.cfg):
            first = 1 if start_relu else 0
            rep = {}
            for i, (ri, ro) in enumerate(_rep_channels(cin, cout, reps,
                                                       grow)):
                rep[str(first + 3 * i)] = _sep_p(ri, ro, device)
                rep[str(first + 3 * i + 1)] = _bn(ro, device)
            blk = _Group(rep=_Group(**rep))
            if cin != cout or stride != 1:
                blk.skip = _cv(cin, cout, 1, device)
                blk.skipbn = _bn(cout, device)
            setattr(self, f"block{bi + 1}", blk)
        self.conv3, self.bn3 = _sep_p(1024, 1536, device), _bn(1536, device)
        self.conv4 = _sep_p(1536, XCEPTION_FEATURES, device)
        self.bn4 = _bn(XCEPTION_FEATURES, device)
        self.num_features = XCEPTION_FEATURES
        if num_classes:
            self.fc = nn.Linear(XCEPTION_FEATURES, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _batch_norm(_conv(x, self.conv1.weight, 2), self.bn1)
        x = _batch_norm(_conv(x, self.conv2.weight), self.bn2)
        for bi, (_, _, reps, stride, start_relu, _) in enumerate(self.cfg):
            blk = getattr(self, f"block{bi + 1}")
            first = 1 if start_relu else 0
            y = x
            for i in range(reps):
                if i > 0 or start_relu:
                    y = F.relu(y)
                y = _sep(y, getattr(blk.rep, str(first + 3 * i)))
                y = _batch_norm(y, getattr(blk.rep, str(first + 3 * i + 1)),
                                act=False)
            if stride != 1:
                y = F.max_pool2d(y, 3, stride, 1)
            skip = x
            if hasattr(blk, "skip"):
                skip = _batch_norm(_conv(x, blk.skip.weight, stride),
                                   blk.skipbn, act=False)
            x = y + skip
        x = _batch_norm(_sep(x, self.conv3), self.bn3)
        return _batch_norm(_sep(x, self.conv4), self.bn4)


def _sep_sd(q, base: str) -> Dict[str, torch.Tensor]:
    """A JAX {dw, pw} pair -> base.conv1 (depthwise), base.pointwise."""
    return {base + ".conv1.weight": _oihw(q["dw"]),
            base + ".pointwise.weight": _oihw(q["pw"])}


def xception_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_xception tree -> Xception names."""
    sd = {**_cb_sd(p["conv1"], p["bn1"], "conv1.weight", "bn1."),
          **_cb_sd(p["conv2"], p["bn2"], "conv2.weight", "bn2.")}
    for bi, bp in enumerate(p["blocks"]):
        base = f"block{bi + 1}."
        # block 1 starts without a relu: its first separable conv at 0
        first = 0 if bi == 0 else 1
        for i, sp in enumerate(bp["seps"]):
            si = first + 3 * i
            sd.update(_sep_sd(sp, f"{base}rep.{si}"))
            sd.update(_norm_sd(sp["bn"], f"{base}rep.{si + 1}."))
        if "skip" in bp:
            sd.update(_cb_sd(bp["skip"], bp["skipbn"], base + "skip.weight",
                             base + "skipbn."))
    for i in (3, 4):
        sd.update(_sep_sd(p[f"conv{i}"], f"conv{i}"))
        sd.update(_norm_sd(p[f"bn{i}"], f"bn{i}."))
    return sd
