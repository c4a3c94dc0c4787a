"""SelecSLS of the model zoo: the port of vitcap_tpu/models/selecsls.py.

conv_bn is a conv (no bias, padding k // 2), BN and relu.  A block runs
three conv pairs (3x3 then 1x1 + 3x3 twice) and concatenates their
outputs, with the stage's skip on blocks that are not a stage's first,
into a 1x1 conv6; a stage's first block starts the skip.  Four plain
conv_bns make the head; the classifier is a linear layer on the pooled
map.

State-dict names: stem.{0,1}, features.{i}.conv{1..6}.{0,1},
head.{i}.{0,1}, fc.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .backbones import PooledHead, _batch_norm, _cb, _cb_sd, _conv
from .layers import _Group

# (in, skip, mid, out, is_first, stride)
_F42 = ((32, 0, 64, 64, True, 2), (64, 64, 64, 128, False, 1),
        (128, 0, 144, 144, True, 2), (144, 144, 144, 288, False, 1),
        (288, 0, 304, 304, True, 2), (304, 304, 304, 480, False, 1))
_F60 = ((32, 0, 64, 64, True, 2), (64, 64, 64, 128, False, 1),
        (128, 0, 128, 128, True, 2), (128, 128, 128, 128, False, 1),
        (128, 128, 128, 288, False, 1), (288, 0, 288, 288, True, 2),
        (288, 288, 288, 288, False, 1), (288, 288, 288, 288, False, 1),
        (288, 288, 288, 416, False, 1))
_F84 = ((32, 0, 64, 64, True, 2), (64, 64, 64, 144, False, 1),
        (144, 0, 144, 144, True, 2), (144, 144, 144, 144, False, 1),
        (144, 144, 144, 144, False, 1), (144, 144, 144, 144, False, 1),
        (144, 144, 144, 304, False, 1), (304, 0, 304, 304, True, 2),
        (304, 304, 304, 304, False, 1), (304, 304, 304, 304, False, 1),
        (304, 304, 304, 304, False, 1), (304, 304, 304, 304, False, 1),
        (304, 304, 304, 512, False, 1))

# name -> (features, head convs (in, out, k, stride), num_features)
SELECSLS = {
    "selecsls42": (_F42, ((480, 960, 3, 2), (960, 1024, 3, 1),
                          (1024, 1024, 3, 2), (1024, 1280, 1, 1)), 1280),
    "selecsls42b": (_F42, ((480, 960, 3, 2), (960, 1024, 3, 1),
                           (1024, 1280, 3, 2), (1280, 1024, 1, 1)), 1024),
    "selecsls60": (_F60, ((416, 756, 3, 2), (756, 1024, 3, 1),
                          (1024, 1024, 3, 2), (1024, 1280, 1, 1)), 1280),
    "selecsls60b": (_F60, ((416, 756, 3, 2), (756, 1024, 3, 1),
                           (1024, 1280, 3, 2), (1280, 1024, 1, 1)), 1024),
    "selecsls84": (_F84, ((512, 960, 3, 2), (960, 1024, 3, 1),
                          (1024, 1024, 3, 2), (1024, 1280, 3, 1)), 1280),
}


def selecsls_feature_channels(variant: str) -> int:
    return SELECSLS[variant][2]


def _seq_cb(cin, cout, k, device):
    return _cb(cin, cout, k, device, names=("0", "1"))


def _cbr(x: torch.Tensor, m, stride: int = 1) -> torch.Tensor:
    w = getattr(m, "0").weight
    return _batch_norm(_conv(x, w, stride, w.shape[-1] // 2), getattr(m, "1"))


class SelecSls(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, num_features, H / 32, W / 32).  n_stages > 0
    keeps the blocks of the first n_stages stages (a stage starts at an
    is_first block) and no head convs (a reduced-depth check)."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        feats, head, nf = SELECSLS[variant]
        if n_stages:
            firsts = [i for i, f in enumerate(feats) if f[4]] + [len(feats)]
            feats, head = feats[:firsts[n_stages]], ()
            nf = feats[-1][3]
        self.feats = feats
        self.stem = _seq_cb(3, 32, 3, device)
        self.features = nn.ModuleList(_Group(
            conv1=_seq_cb(cin, mid, 3, device),
            conv2=_seq_cb(mid, mid, 1, device),
            conv3=_seq_cb(mid, mid // 2, 3, device),
            conv4=_seq_cb(mid // 2, mid, 1, device),
            conv5=_seq_cb(mid, mid // 2, 3, device),
            conv6=_seq_cb(2 * mid + (0 if first else skc), out, 1, device))
            for cin, skc, mid, out, first, _ in feats)
        self.head_strides = [h[3] for h in head]
        self.head = nn.ModuleList(_seq_cb(cin, cout, k, device)
                                  for cin, cout, k, _ in head)
        self.num_features = nf
        if num_classes:
            self.fc = nn.Linear(nf, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cbr(x, self.stem, 2)
        skip = None
        for f, m in zip(self.feats, self.features):
            d1 = _cbr(x, m.conv1, f[5])
            d2 = _cbr(_cbr(d1, m.conv2), m.conv3)
            d3 = _cbr(_cbr(d2, m.conv4), m.conv5)
            x = _cbr(torch.cat([d1, d2, d3] + ([] if f[4] else [skip]), 1),
                     m.conv6)
            if f[4]:
                skip = x
        for s, m in zip(self.head_strides, self.head):
            x = _cbr(x, m, s)
        return x


def selecsls_from_jax(p) -> dict:
    """The JAX package's init_selecsls tree -> SelecSls names."""
    def cb(q, base):
        return _cb_sd(q["conv"], q["bn"], base + ".0.weight", base + ".1.")

    sd = cb(p["stem"], "stem")
    for i, bp in enumerate(p["features"]):
        for c in range(1, 7):
            sd.update(cb(bp[f"conv{c}"], f"features.{i}.conv{c}"))
    for i, hp in enumerate(p["head"]):
        sd.update(cb(hp, f"head.{i}"))
    return sd
