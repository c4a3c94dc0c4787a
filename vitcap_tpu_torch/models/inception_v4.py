"""Inception-V4 of the model zoo: the port of
vitcap_tpu/models/inception_v4.py.

- BasicConv2d as in models/inception_v3.py (conv without bias, BN eps
  1e-3, relu).
- The stem's Mixed3a / 4a / 5a concatenating reductions (a VALID 3x3/2
  max pool beside a stride-2 conv), 4 InceptionA + ReductionA, 7
  InceptionB + ReductionB, 3 InceptionC; the avg-pool branches EXCLUDE
  the padding (AvgPool2d(3, 1, 1, count_include_pad=False), unlike
  Inception-V3's).
- A linear `last_linear` on the pooled 1536-channel map.

The VALID stride-2 reductions shrink the map to nothing below 75 px.

State-dict names: features.{i} (timm's Sequential index) with its
branches, each BasicConv2d .{conv,bn}; last_linear.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .inception_v3 import BasicConvNet, ConvSpecs, _max32

INCEPTION_V4_FEATURES = 1536
_REPEATS = {"a": 4, "b": 7, "c": 3}


def inception_v4_feature_channels(variant: str) -> int:
    return INCEPTION_V4_FEATURES


def _avg3_excl(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 1, 1), the padding excluded from each mean."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _block_specs(c: ConvSpecs, kind: str, b: str) -> None:
    if kind == "a":
        c(b + "branch0", 384, 96, 1)
        c(b + "branch1.0", 384, 64, 1)
        c(b + "branch1.1", 64, 96, 3, 1)
        c(b + "branch2.0", 384, 64, 1)
        c(b + "branch2.1", 64, 96, 3, 1)
        c(b + "branch2.2", 96, 96, 3, 1)
        c(b + "branch3.1", 384, 96, 1)
    elif kind == "red_a":
        c(b + "branch0", 384, 384, 3, 0, 2)
        c(b + "branch1.0", 384, 192, 1)
        c(b + "branch1.1", 192, 224, 3, 1)
        c(b + "branch1.2", 224, 256, 3, 0, 2)
    elif kind == "b":
        c(b + "branch0", 1024, 384, 1)
        c(b + "branch1.0", 1024, 192, 1)
        c(b + "branch1.1", 192, 224, (1, 7), (0, 3))
        c(b + "branch1.2", 224, 256, (7, 1), (3, 0))
        c(b + "branch2.0", 1024, 192, 1)
        c(b + "branch2.1", 192, 192, (7, 1), (3, 0))
        c(b + "branch2.2", 192, 224, (1, 7), (0, 3))
        c(b + "branch2.3", 224, 224, (7, 1), (3, 0))
        c(b + "branch2.4", 224, 256, (1, 7), (0, 3))
        c(b + "branch3.1", 1024, 128, 1)
    elif kind == "red_b":
        c(b + "branch0.0", 1024, 192, 1)
        c(b + "branch0.1", 192, 192, 3, 0, 2)
        c(b + "branch1.0", 1024, 256, 1)
        c(b + "branch1.1", 256, 256, (1, 7), (0, 3))
        c(b + "branch1.2", 256, 320, (7, 1), (3, 0))
        c(b + "branch1.3", 320, 320, 3, 0, 2)
    else:
        c(b + "branch0", 1536, 256, 1)
        c(b + "branch1_0", 1536, 384, 1)
        c(b + "branch1_1a", 384, 256, (1, 3), (0, 1))
        c(b + "branch1_1b", 384, 256, (3, 1), (1, 0))
        c(b + "branch2_0", 1536, 384, 1)
        c(b + "branch2_1", 384, 448, (3, 1), (1, 0))
        c(b + "branch2_2", 448, 512, (1, 3), (0, 1))
        c(b + "branch2_3a", 512, 256, (1, 3), (0, 1))
        c(b + "branch2_3b", 512, 256, (3, 1), (1, 0))
        c(b + "branch3.1", 1536, 256, 1)


class InceptionV4(BasicConvNet):
    """(B, 3, H, W) -> (B, 1536, h, w) after the last InceptionC; a linear
    `last_linear` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages blocks of each run of InceptionA, B and C (features renumbered
    in order)."""
    head_name = "last_linear"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        n = {k: min(v, n_stages or v) for k, v in _REPEATS.items()}
        kinds = ["a"] * n["a"] + ["red_a"] + ["b"] * n["b"] + ["red_b"] + \
            ["c"] * n["c"]
        self.blocks = [(k, f"features.{i + 6}.") for i, k in enumerate(kinds)]
        c = ConvSpecs()
        c("features.0", 3, 32, 3, 0, 2)
        c("features.1", 32, 32, 3)
        c("features.2", 32, 64, 3, 1)
        c("features.3.conv", 64, 96, 3, 0, 2)              # Mixed3a
        c("features.4.branch0.0", 160, 64, 1)              # Mixed4a
        c("features.4.branch0.1", 64, 96, 3)
        c("features.4.branch1.0", 160, 64, 1)
        c("features.4.branch1.1", 64, 64, (1, 7), (0, 3))
        c("features.4.branch1.2", 64, 64, (7, 1), (3, 0))
        c("features.4.branch1.3", 64, 96, 3)
        c("features.5.conv", 192, 192, 3, 0, 2)            # Mixed5a
        for kind, b in self.blocks:
            _block_specs(c, kind, b)
        self._add_convs(c.specs, device, trunc_std=0.1)
        self.num_features = INCEPTION_V4_FEATURES
        if num_classes:
            self.last_linear = nn.Linear(INCEPTION_V4_FEATURES, num_classes,
                                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.chain(x, "features.0", "features.1", "features.2")
        x = torch.cat([_max32(x), self.bca("features.3.conv", x)], dim=1)
        x = torch.cat([
            self.chain(x, "features.4.branch0.0", "features.4.branch0.1"),
            self.chain(x, *(f"features.4.branch1.{j}" for j in range(4)))],
            dim=1)
        x = torch.cat([self.bca("features.5.conv", x), _max32(x)], dim=1)
        for kind, b in self.blocks:
            x = getattr(self, "_block_" + kind)(b, x)
        return x

    def _block_a(self, b, x):
        return torch.cat([
            self.bca(b + "branch0", x),
            self.chain(x, b + "branch1.0", b + "branch1.1"),
            self.chain(x, *(b + f"branch2.{j}" for j in range(3))),
            self.bca(b + "branch3.1", _avg3_excl(x))], dim=1)

    def _block_red_a(self, b, x):
        return torch.cat([
            self.bca(b + "branch0", x),
            self.chain(x, *(b + f"branch1.{j}" for j in range(3))),
            _max32(x)], dim=1)

    def _block_b(self, b, x):
        return torch.cat([
            self.bca(b + "branch0", x),
            self.chain(x, *(b + f"branch1.{j}" for j in range(3))),
            self.chain(x, *(b + f"branch2.{j}" for j in range(5))),
            self.bca(b + "branch3.1", _avg3_excl(x))], dim=1)

    def _block_red_b(self, b, x):
        return torch.cat([
            self.chain(x, b + "branch0.0", b + "branch0.1"),
            self.chain(x, *(b + f"branch1.{j}" for j in range(4))),
            _max32(x)], dim=1)

    def _block_c(self, b, x):
        x1 = self.bca(b + "branch1_0", x)
        x2 = self.chain(x, b + "branch2_0", b + "branch2_1", b + "branch2_2")
        return torch.cat([
            self.bca(b + "branch0", x),
            self.bca(b + "branch1_1a", x1), self.bca(b + "branch1_1b", x1),
            self.bca(b + "branch2_3a", x2), self.bca(b + "branch2_3b", x2),
            self.bca(b + "branch3.1", _avg3_excl(x))], dim=1)
