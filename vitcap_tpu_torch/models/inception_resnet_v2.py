"""Inception-ResNet-V2 of the model zoo (inception_resnet_v2,
ens_adv_inception_resnet_v2: one graph under two weight flavours): the
port of vitcap_tpu/models/inception_resnet_v2.py.

- BasicConv2d as in models/inception_v3.py (conv without bias, BN eps
  1e-3, relu), here with kaiming-normal (fan out) kernels.
- Stem as Inception-V3's; Mixed_5b (its avg-pool branch excludes the
  padding); 10 Block35, Mixed_6a, 20 Block17, Mixed_7a, 9 Block8 and a
  last Block8 without its relu; conv2d_7b to 1536 channels.
- A scaled-residual block: its branches concatenated, a biased 1x1
  `conv2d` back to the block's width, scaled by 0.17 / 0.10 / 0.20
  (_REPEATS; 1.0 for the last Block8) and added to its input, then relu.
- A linear `classif` on the pooled map.

The VALID stride-2 reductions shrink the map to nothing below 75 px.

State-dict names: conv2d_1a ... conv2d_7b, mixed_5b / 6a / 7a
.branch{k}[.{j}], repeat / repeat_1 / repeat_2.{i}.branch{k}[.{j}] and
.conv2d, block8.*, each BasicConv2d .{conv,bn}; classif.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import _conv, _t
from .inception_v3 import BasicConvNet, ConvSpecs, basic_convs_from_jax
from .inception_v4 import _avg3_excl, _max32

INCEPTION_RESNET_V2_FEATURES = 1536
INCEPTION_RESNET_V2_NAMES = ("inception_resnet_v2",
                             "ens_adv_inception_resnet_v2")

# scaled-residual towers: (name, blocks, scale, conv2d in, conv2d out)
_REPEATS = (("repeat", 10, 0.17, 128, 320),
            ("repeat_1", 20, 0.10, 384, 1088),
            ("repeat_2", 9, 0.20, 448, 2080))


def inception_resnet_v2_feature_channels(variant: str) -> int:
    return INCEPTION_RESNET_V2_FEATURES


def _tower_specs(c: ConvSpecs, tower: str, b: str) -> None:
    if tower == "repeat":
        c(b + "branch0", 320, 32, 1)
        c(b + "branch1.0", 320, 32, 1)
        c(b + "branch1.1", 32, 32, 3, 1)
        c(b + "branch2.0", 320, 32, 1)
        c(b + "branch2.1", 32, 48, 3, 1)
        c(b + "branch2.2", 48, 64, 3, 1)
    elif tower == "repeat_1":
        c(b + "branch0", 1088, 192, 1)
        c(b + "branch1.0", 1088, 128, 1)
        c(b + "branch1.1", 128, 160, (1, 7), (0, 3))
        c(b + "branch1.2", 160, 192, (7, 1), (3, 0))
    else:
        c(b + "branch0", 2080, 192, 1)
        c(b + "branch1.0", 2080, 192, 1)
        c(b + "branch1.1", 192, 224, (1, 3), (0, 1))
        c(b + "branch1.2", 224, 256, (3, 1), (1, 0))


class InceptionResnetV2(BasicConvNet):
    """(B, 3, H, W) -> (B, 1536, h, w) after conv2d_7b; a linear `classif`
    with num_classes > 0.  n_stages > 0 keeps the first n_stages blocks
    of each tower."""
    head_name = "classif"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        self.towers = [(name, min(n, n_stages or n), scale)
                       for name, n, scale, _, _ in _REPEATS]
        c = ConvSpecs()
        c("conv2d_1a", 3, 32, 3, 0, 2)
        c("conv2d_2a", 32, 32, 3)
        c("conv2d_2b", 32, 64, 3, 1)
        c("conv2d_3b", 64, 80, 1)
        c("conv2d_4a", 80, 192, 3)
        c("mixed_5b.branch0", 192, 96, 1)
        c("mixed_5b.branch1.0", 192, 48, 1)
        c("mixed_5b.branch1.1", 48, 64, 5, 2)
        c("mixed_5b.branch2.0", 192, 64, 1)
        c("mixed_5b.branch2.1", 64, 96, 3, 1)
        c("mixed_5b.branch2.2", 96, 96, 3, 1)
        c("mixed_5b.branch3.1", 192, 64, 1)
        scale_convs = []
        for (tower, n, _), (_, _, _, cin, cout) in zip(self.towers,
                                                       _REPEATS):
            for i in range(n):
                _tower_specs(c, tower, f"{tower}.{i}.")
                scale_convs.append((f"{tower}.{i}", cin, cout))
            if tower == "repeat":
                c("mixed_6a.branch0", 320, 384, 3, 0, 2)
                c("mixed_6a.branch1.0", 320, 256, 1)
                c("mixed_6a.branch1.1", 256, 256, 3, 1)
                c("mixed_6a.branch1.2", 256, 384, 3, 0, 2)
            elif tower == "repeat_1":
                c("mixed_7a.branch0.0", 1088, 256, 1)
                c("mixed_7a.branch0.1", 256, 384, 3, 0, 2)
                c("mixed_7a.branch1.0", 1088, 256, 1)
                c("mixed_7a.branch1.1", 256, 288, 3, 0, 2)
                c("mixed_7a.branch2.0", 1088, 256, 1)
                c("mixed_7a.branch2.1", 256, 288, 3, 1)
                c("mixed_7a.branch2.2", 288, 320, 3, 0, 2)
        _tower_specs(c, "repeat_2", "block8.")
        scale_convs.append(("block8", 448, 2080))
        c("conv2d_7b", 2080, 1536, 1)
        self._add_convs(c.specs, device)
        for key, cin, cout in scale_convs:
            # the JAX package draws these normal with std sqrt(1 / cin)
            conv = nn.Conv2d(cin, cout, 1, device=device)
            conv.init_std = math.sqrt(1.0 / cin)
            self.get_submodule(key).conv2d = conv
        self.num_features = INCEPTION_RESNET_V2_FEATURES
        if num_classes:
            self.classif = nn.Linear(INCEPTION_RESNET_V2_FEATURES,
                                     num_classes, device=device)

    def _res(self, b: str, x: torch.Tensor, scale: float, branches,
             relu: bool = True) -> torch.Tensor:
        sc = self.get_submodule(b + "conv2d")
        y = _conv(torch.cat(branches, dim=1), sc.weight)
        y = (y + sc.bias.to(y.dtype)[:, None, None]) * scale + x
        return F.relu(y) if relu else y

    def _tower_block(self, b: str, x: torch.Tensor, scale: float,
                     relu: bool = True) -> torch.Tensor:
        if b.startswith("repeat."):
            branches = [self.bca(b + "branch0", x),
                        self.chain(x, b + "branch1.0", b + "branch1.1"),
                        self.chain(x, *(b + f"branch2.{j}"
                                        for j in range(3)))]
        else:
            branches = [self.bca(b + "branch0", x),
                        self.chain(x, *(b + f"branch1.{j}"
                                        for j in range(3)))]
        return self._res(b, x, scale, branches, relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.chain(x, "conv2d_1a", "conv2d_2a", "conv2d_2b")
        x = _max32(x)
        x = _max32(self.chain(x, "conv2d_3b", "conv2d_4a"))
        x = torch.cat([
            self.bca("mixed_5b.branch0", x),
            self.chain(x, "mixed_5b.branch1.0", "mixed_5b.branch1.1"),
            self.chain(x, *(f"mixed_5b.branch2.{j}" for j in range(3))),
            self.bca("mixed_5b.branch3.1", _avg3_excl(x))], dim=1)
        for tower, n, scale in self.towers:
            for i in range(n):
                x = self._tower_block(f"{tower}.{i}.", x, scale)
            if tower == "repeat":
                x = torch.cat([
                    self.bca("mixed_6a.branch0", x),
                    self.chain(x, *(f"mixed_6a.branch1.{j}"
                                    for j in range(3))),
                    _max32(x)], dim=1)
            elif tower == "repeat_1":
                x = torch.cat([
                    self.chain(x, "mixed_7a.branch0.0", "mixed_7a.branch0.1"),
                    self.chain(x, "mixed_7a.branch1.0", "mixed_7a.branch1.1"),
                    self.chain(x, *(f"mixed_7a.branch2.{j}"
                                    for j in range(3))),
                    _max32(x)], dim=1)
        x = self._tower_block("block8.", x, 1.0, relu=False)
        return self.bca("conv2d_7b", x)


def inception_resnet_v2_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_inception_resnet_v2 tree -> its names: the
    BasicConv2d entries, and each scaled block's conv2d {w (in, out), b}."""
    sd = basic_convs_from_jax({k: q for k, q in p.items()
                               if not k.endswith("conv2d")})
    for key, q in p.items():
        if key.endswith("conv2d"):
            sd[key + ".weight"] = _t(q["w"]).t()[:, :, None, None].contiguous()
            sd[key + ".bias"] = _t(q["b"])
    return sd
