"""Inception-V3 of the model zoo (inception_v3, tf_inception_v3,
adv_inception_v3, gluon_inception_v3: one graph under four weight
flavours): the port of vitcap_tpu/models/inception_v3.py.

- BasicConv2d: a conv (no bias, symmetric padding per axis), BN (eps
  1e-3), relu; the asymmetric 1x7 / 7x1 / 1x3 / 3x1 kernels pad only
  their long axis.
- Stem Conv2d_1a-4a with two VALID 3x3/2 max pools; mixed blocks A (the
  avg-pool branch counts the padding: AvgPool2d(3, 1, 1)), B (the 3x3/2
  reduction with a max-pool branch), C (factorised 7x7), D (the 7x7x3
  reduction), E (the split 1x3 / 3x1 branches); no aux head.  The
  branches concatenate along the channels in the JAX order.
- A linear `fc` on the pooled 2048-channel map.

The VALID stride-2 reductions shrink the map to nothing below 75 px.

State-dict names: {Conv2d_1a_3x3, ..., Mixed_7c.branch_pool}.{conv,bn},
fc (timm's InceptionV3).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import PooledHead, _batch_norm, _bn, _conv, _norm_sd, _oihw
from .layers import _Group

_BN_EPS = 1e-3

INCEPTION_V3_FEATURES = 2048
INCEPTION_V3_NAMES = ("inception_v3", "tf_inception_v3",
                      "adv_inception_v3", "gluon_inception_v3")

# (key, cin, cout, (kh, kw), (ph, pw), stride) of a BasicConv2d
ConvSpec = Tuple[str, int, int, Tuple[int, int], Tuple[int, int], int]

# the mixed blocks: (kind, name, cin, the pool branch's width or c7)
_BLOCKS = (("a", "Mixed_5b", 192, 32), ("a", "Mixed_5c", 256, 64),
           ("a", "Mixed_5d", 288, 64), ("b", "Mixed_6a", 288, 0),
           ("c", "Mixed_6b", 768, 128), ("c", "Mixed_6c", 768, 160),
           ("c", "Mixed_6d", 768, 160), ("c", "Mixed_6e", 768, 192),
           ("d", "Mixed_7a", 768, 0), ("e", "Mixed_7b", 1280, 0),
           ("e", "Mixed_7c", 2048, 0))


def inception_v3_feature_channels(variant: str) -> int:
    return INCEPTION_V3_FEATURES


class ConvSpecs:
    """Collects BasicConv2d specs: c(key, cin, cout, k, p, s) with k and p
    an int or an (h, w) pair."""

    def __init__(self):
        self.specs: List[ConvSpec] = []

    def __call__(self, key, cin, cout, k, p=0, s=1):
        kk = (k, k) if isinstance(k, int) else k
        pp = (p, p) if isinstance(p, int) else p
        self.specs.append((key, cin, cout, kk, pp, s))


def _block_specs(c: ConvSpecs, kind: str, n: str, cin: int, w: int) -> None:
    if kind == "a":
        c(f"{n}.branch1x1", cin, 64, 1)
        c(f"{n}.branch5x5_1", cin, 48, 1)
        c(f"{n}.branch5x5_2", 48, 64, 5, 2)
        c(f"{n}.branch3x3dbl_1", cin, 64, 1)
        c(f"{n}.branch3x3dbl_2", 64, 96, 3, 1)
        c(f"{n}.branch3x3dbl_3", 96, 96, 3, 1)
        c(f"{n}.branch_pool", cin, w, 1)
    elif kind == "b":
        c(f"{n}.branch3x3", cin, 384, 3, 0, 2)
        c(f"{n}.branch3x3dbl_1", cin, 64, 1)
        c(f"{n}.branch3x3dbl_2", 64, 96, 3, 1)
        c(f"{n}.branch3x3dbl_3", 96, 96, 3, 0, 2)
    elif kind == "c":
        c(f"{n}.branch1x1", cin, 192, 1)
        c(f"{n}.branch7x7_1", cin, w, 1)
        c(f"{n}.branch7x7_2", w, w, (1, 7), (0, 3))
        c(f"{n}.branch7x7_3", w, 192, (7, 1), (3, 0))
        c(f"{n}.branch7x7dbl_1", cin, w, 1)
        c(f"{n}.branch7x7dbl_2", w, w, (7, 1), (3, 0))
        c(f"{n}.branch7x7dbl_3", w, w, (1, 7), (0, 3))
        c(f"{n}.branch7x7dbl_4", w, w, (7, 1), (3, 0))
        c(f"{n}.branch7x7dbl_5", w, 192, (1, 7), (0, 3))
        c(f"{n}.branch_pool", cin, 192, 1)
    elif kind == "d":
        c(f"{n}.branch3x3_1", cin, 192, 1)
        c(f"{n}.branch3x3_2", 192, 320, 3, 0, 2)
        c(f"{n}.branch7x7x3_1", cin, 192, 1)
        c(f"{n}.branch7x7x3_2", 192, 192, (1, 7), (0, 3))
        c(f"{n}.branch7x7x3_3", 192, 192, (7, 1), (3, 0))
        c(f"{n}.branch7x7x3_4", 192, 192, 3, 0, 2)
    else:
        c(f"{n}.branch1x1", cin, 320, 1)
        c(f"{n}.branch3x3_1", cin, 384, 1)
        c(f"{n}.branch3x3_2a", 384, 384, (1, 3), (0, 1))
        c(f"{n}.branch3x3_2b", 384, 384, (3, 1), (1, 0))
        c(f"{n}.branch3x3dbl_1", cin, 448, 1)
        c(f"{n}.branch3x3dbl_2", 448, 384, 3, 1)
        c(f"{n}.branch3x3dbl_3a", 384, 384, (1, 3), (0, 1))
        c(f"{n}.branch3x3dbl_3b", 384, 384, (3, 1), (1, 0))
        c(f"{n}.branch_pool", cin, 192, 1)


def _max32(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2), VALID."""
    return F.max_pool2d(x, 3, 2)


class BasicConvNet(PooledHead, nn.Module):
    """A net of BasicConv2d modules (conv without bias, BN, relu) under
    their dotted timm paths, each with its padding and stride: the
    inceptions' shell."""

    def _add_convs(self, specs: List[ConvSpec], device,
                   trunc_std: float = 0.0) -> None:
        """trunc_std > 0: the zoo's init draws each kernel truncated normal
        of that std (the inceptions'), else kaiming-normal."""
        self.meta: Dict[str, Tuple[Tuple[int, int], int]] = {}
        for key, cin, cout, k, pad, stride in specs:
            *path, leaf = key.split(".")
            parent = self
            for part in path:
                if parent._modules.get(part) is None:
                    setattr(parent, part, _Group())
                parent = parent._modules[part]
            conv = nn.Conv2d(cin, cout, k, bias=False, device=device)
            if trunc_std:
                conv.trunc_std = trunc_std
            setattr(parent, leaf, _Group(conv=conv, bn=_bn(cout, device,
                                                           eps=_BN_EPS)))
            self.meta[key] = (pad, stride)

    def bca(self, key: str, x: torch.Tensor) -> torch.Tensor:
        pad, stride = self.meta[key]
        m = self.get_submodule(key)
        return _batch_norm(_conv(x, m.conv.weight, stride, pad), m.bn)

    def chain(self, x: torch.Tensor, *keys: str) -> torch.Tensor:
        for key in keys:
            x = self.bca(key, x)
        return x


class InceptionV3(BasicConvNet):
    """(B, 3, H, W) -> (B, 2048, h, w) after Mixed_7c; a linear `fc` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages of the four
    768-wide blocks Mixed_6b-6e."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        cut = [b for b in _BLOCKS if b[0] == "c"][n_stages or 4:]
        self.blocks = [b for b in _BLOCKS if b not in cut]
        c = ConvSpecs()
        c("Conv2d_1a_3x3", 3, 32, 3, 0, 2)
        c("Conv2d_2a_3x3", 32, 32, 3)
        c("Conv2d_2b_3x3", 32, 64, 3, 1)
        c("Conv2d_3b_1x1", 64, 80, 1)
        c("Conv2d_4a_3x3", 80, 192, 3)
        for kind, n, cin, w in self.blocks:
            _block_specs(c, kind, n, cin, w)
        self._add_convs(c.specs, device, trunc_std=0.1)
        self.num_features = INCEPTION_V3_FEATURES
        if num_classes:
            self.fc = nn.Linear(INCEPTION_V3_FEATURES, num_classes,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.chain(x, "Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3")
        x = _max32(x)
        x = _max32(self.chain(x, "Conv2d_3b_1x1", "Conv2d_4a_3x3"))
        for kind, n, _, _ in self.blocks:
            x = getattr(self, "_block_" + kind)(n, x)
        return x

    def _pool_branch(self, n, x):
        """AvgPool2d(3, 1, 1) counting the padding, then branch_pool."""
        return self.bca(f"{n}.branch_pool", F.avg_pool2d(x, 3, 1, 1))

    def _block_a(self, n, x):
        return torch.cat([
            self.bca(f"{n}.branch1x1", x),
            self.chain(x, f"{n}.branch5x5_1", f"{n}.branch5x5_2"),
            self.chain(x, *(f"{n}.branch3x3dbl_{i}" for i in (1, 2, 3))),
            self._pool_branch(n, x)], dim=1)

    def _block_b(self, n, x):
        return torch.cat([
            self.bca(f"{n}.branch3x3", x),
            self.chain(x, *(f"{n}.branch3x3dbl_{i}" for i in (1, 2, 3))),
            _max32(x)], dim=1)

    def _block_c(self, n, x):
        return torch.cat([
            self.bca(f"{n}.branch1x1", x),
            self.chain(x, *(f"{n}.branch7x7_{i}" for i in (1, 2, 3))),
            self.chain(x, *(f"{n}.branch7x7dbl_{i}" for i in range(1, 6))),
            self._pool_branch(n, x)], dim=1)

    def _block_d(self, n, x):
        return torch.cat([
            self.chain(x, f"{n}.branch3x3_1", f"{n}.branch3x3_2"),
            self.chain(x, *(f"{n}.branch7x7x3_{i}" for i in range(1, 5))),
            _max32(x)], dim=1)

    def _block_e(self, n, x):
        b3 = self.bca(f"{n}.branch3x3_1", x)
        bd = self.chain(x, f"{n}.branch3x3dbl_1", f"{n}.branch3x3dbl_2")
        return torch.cat([
            self.bca(f"{n}.branch1x1", x),
            self.bca(f"{n}.branch3x3_2a", b3),
            self.bca(f"{n}.branch3x3_2b", b3),
            self.bca(f"{n}.branch3x3dbl_3a", bd),
            self.bca(f"{n}.branch3x3dbl_3b", bd),
            self._pool_branch(n, x)], dim=1)


def basic_convs_from_jax(p) -> Dict[str, torch.Tensor]:
    """A flat JAX tree of BasicConv2d {conv, bn} under dotted timm paths ->
    their state-dict names."""
    sd = {}
    for key, q in p.items():
        sd[key + ".conv.weight"] = _oihw(q["conv"])
        sd.update(_norm_sd(q["bn"], key + ".bn."))
    return sd
