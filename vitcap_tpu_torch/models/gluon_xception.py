"""Gluon's aligned Xception-65 of the model zoo: the port of
vitcap_tpu/models/gluon_xception.py.

- SeparableConv2d: a 3x3 depthwise conv (padding 1, the stride), a BN
  BETWEEN it and the 1x1 pointwise conv.
- Blocks (_BLOCKS): [relu, separable conv, BN] x 3 with the stride on the
  THIRD separable conv (blocks 1 and 2 without the first relu), a 1x1
  conv + BN skip where the shape changes, else the block's input; the
  residual add, then a relu after block 1 and block 20.
- Entry: a 3x3/2 conv and a 3x3 conv (padding 1), each BN + relu; blocks
  1-3, 16 middle 728-wide blocks, the exit block 20 (728, 1024, 1024);
  then separable convs to 1536, 1536 and 2048, each BN (bn3-bn5) +
  relu; a linear `fc` on the pooled map.

State-dict names: conv1, bn1, conv2, bn2,
{block1..3, mid.block4..19, block20}.rep.{conv,bn}{1,2,3} (a separable
conv's .{conv_dw,bn,conv_pw}), .skip.{conv1,bn1};
conv{3,4,5}.{conv_dw,bn,conv_pw}, bn3, bn4, bn5, fc.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import PooledHead, _batch_norm, _bn, _cb_sd, _conv, _cv, \
    _norm_sd, _oihw
from .layers import _Group

GLUON_XCEPTION_FEATURES = 2048

# (torch path, in, planes-triple, stride, start_relu)
_BLOCKS = ([("block1", 64, (128, 128, 128), 2, False),
            ("block2", 128, (256, 256, 256), 2, False),
            ("block3", 256, (728, 728, 728), 2, True)]
           + [(f"mid.block{i}", 728, (728, 728, 728), 1, True)
              for i in range(4, 20)]
           + [("block20", 728, (728, 1024, 1024), 2, True)])
_EXIT = ((1024, 1536), (1536, 1536), (1536, GLUON_XCEPTION_FEATURES))


def gluon_xception_feature_channels(variant: str) -> int:
    return GLUON_XCEPTION_FEATURES


def _sep_p(cin: int, cout: int, device) -> _Group:
    return _Group(conv_dw=_cv(cin, cin, 3, device, cin), bn=_bn(cin, device),
                  conv_pw=_cv(cin, cout, 1, device))


def _sep(x: torch.Tensor, m, stride: int = 1) -> torch.Tensor:
    """dw (padding 1) -> BN -> pw."""
    y = _batch_norm(_conv(x, m.conv_dw.weight, stride, 1, x.shape[1]), m.bn,
                    act=False)
    return _conv(y, m.conv_pw.weight)


class GluonXception(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 2048, H / 32, W / 32) after the last relu; a
    linear `fc` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages middle blocks."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        mids = [b for b in _BLOCKS if b[0].startswith("mid.")]
        cut = mids[n_stages:] if n_stages else []
        self.cfg = [b for b in _BLOCKS if b not in cut]
        self.conv1, self.bn1 = _cv(3, 32, 3, device), _bn(32, device)
        self.conv2, self.bn2 = _cv(32, 64, 3, device), _bn(64, device)
        self.mid = _Group()
        for name, cin, planes, stride, _ in self.cfg:
            rep, c = {}, cin
            for i, o in enumerate(planes):
                rep[f"conv{i + 1}"] = _sep_p(c, o, device)
                rep[f"bn{i + 1}"] = _bn(o, device)
                c = o
            blk = _Group(rep=_Group(**rep))
            if planes[-1] != cin or stride != 1:
                blk.skip = _Group(conv1=_cv(cin, planes[-1], 1, device),
                                  bn1=_bn(planes[-1], device))
            *parent, leaf = name.split(".")
            setattr(self.mid if parent else self, leaf, blk)
        for i, (cin, cout) in zip((3, 4, 5), _EXIT):
            setattr(self, f"conv{i}", _sep_p(cin, cout, device))
            setattr(self, f"bn{i}", _bn(cout, device))
        self.num_features = GLUON_XCEPTION_FEATURES
        if num_classes:
            self.fc = nn.Linear(GLUON_XCEPTION_FEATURES, num_classes,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _batch_norm(_conv(x, self.conv1.weight, 2, 1), self.bn1)
        x = _batch_norm(_conv(x, self.conv2.weight, 1, 1), self.bn2)
        for name, _, _, stride, start_relu in self.cfg:
            blk = self.get_submodule(name)
            skip = x
            if hasattr(blk, "skip"):
                skip = _batch_norm(_conv(x, blk.skip.conv1.weight, stride),
                                   blk.skip.bn1, act=False)
            y = x
            for i in range(3):
                if i > 0 or start_relu:
                    y = F.relu(y)
                y = _sep(y, getattr(blk.rep, f"conv{i + 1}"),
                         stride if i == 2 else 1)
                y = _batch_norm(y, getattr(blk.rep, f"bn{i + 1}"), act=False)
            x = y + skip
            if name in ("block1", "block20"):
                x = F.relu(x)
        for i in (3, 4, 5):
            x = _batch_norm(_sep(x, getattr(self, f"conv{i}")),
                            getattr(self, f"bn{i}"))
        return x


def _sep_sd(q, base: str) -> Dict[str, torch.Tensor]:
    return {**_cb_sd(q["dw"], q["bn"], base + ".conv_dw.weight",
                     base + ".bn."),
            base + ".conv_pw.weight": _oihw(q["pw"])}


def gluon_xception_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_gluon_xception tree -> GluonXception names."""
    sd = {**_cb_sd(p["conv1"], p["bn1"], "conv1.weight", "bn1."),
          **_cb_sd(p["conv2"], p["bn2"], "conv2.weight", "bn2.")}
    for name, bp in p.items():
        if not isinstance(bp, dict) or "seps" not in bp:
            continue
        for i, (q, bn) in enumerate(zip(bp["seps"], bp["bns"])):
            sd.update(_sep_sd(q, f"{name}.rep.conv{i + 1}"))
            sd.update(_norm_sd(bn, f"{name}.rep.bn{i + 1}."))
        if "skip_conv" in bp:
            sd.update(_cb_sd(bp["skip_conv"], bp["skip_bn"],
                             f"{name}.skip.conv1.weight", f"{name}.skip.bn1."))
    for i in (3, 4, 5):
        sd.update(_sep_sd(p[f"conv{i}"], f"conv{i}"))
        sd.update(_norm_sd(p[f"bn{i}"], f"bn{i}."))
    return sd
