"""Aligned Xception 41 / 65 / 71 of the model zoo: the port of
vitcap_tpu/models/xception_aligned.py.

- Every BN has eps 1e-3.  SeparableConv2d: a 3x3 depthwise conv
  (padding 1, the stride), BN, [relu], a 1x1 pointwise conv, BN, [relu];
  the inner relus only in the last module, the one without a skip
  (start_with_relu=False).
- XceptionModule: [relu, separable conv] x 3, the module's stride on the
  THIRD conv, a 1x1 conv + BN shortcut where the shape changes, else the
  module's input; the last module has no skip.
- Stem: two 3x3 ConvBnAct (stride 2, then 1); the entry flow (3 modules,
  5 for xception71), 8 or 16 middle 728-wide modules, the exit modules;
  a linear `head.fc` on the pooled map.

State-dict names: stem.{0,1}.{conv,bn},
blocks.{i}.stack.conv{1,2,3}.{conv_dw,bn_dw,conv_pw,bn_pw},
blocks.{i}.shortcut.{conv,bn}, head.fc.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import PooledHead, _batch_norm, _bn, _cb_sd, _conv, _cv, \
    _norm_sd, _oihw
from .layers import _Group
from .xception import middle_cut

_BN_EPS = 1e-3

XCEPTION_ALIGNED = ("xception41", "xception65", "xception71")
XCEPTION_ALIGNED_FEATURES = 2048


def _blocks_cfg(variant: str):
    """(in, (out1, out2, out3), stride, start_relu, no_skip) per module."""
    mid = {"xception41": 8, "xception65": 16, "xception71": 16}[variant]
    if variant == "xception71":
        entry = [(64, (128,) * 3, 2), (128, (256,) * 3, 1),
                 (256, (256,) * 3, 2), (256, (728,) * 3, 1),
                 (728, (728,) * 3, 2)]
    else:
        entry = [(64, (128,) * 3, 2), (128, (256,) * 3, 2),
                 (256, (728,) * 3, 2)]
    cfg = [(i, o, s, True, False) for i, o, s in entry]
    cfg += [_MIDDLE] * mid
    cfg += [(728, (728, 1024, 1024), 2, True, False),
            (1024, (1536, 1536, 2048), 1, False, True)]
    return cfg


_MIDDLE = (728, (728,) * 3, 1, True, False)


def xception_aligned_feature_channels(variant: str) -> int:
    return XCEPTION_ALIGNED_FEATURES


def _abn(c: int, device) -> nn.BatchNorm2d:
    return _bn(c, device, eps=_BN_EPS)


class XceptionAligned(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 2048, H / 32, W / 32) after the last module; a
    linear `head.fc` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages middle modules (renumbered)."""
    head_name = "head.fc"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        self.cfg = middle_cut(_blocks_cfg(variant), _MIDDLE, n_stages)
        self.stem = nn.ModuleList([
            _Group(conv=_cv(3, 32, 3, device), bn=_abn(32, device)),
            _Group(conv=_cv(32, 64, 3, device), bn=_abn(64, device))])
        blocks = []
        for cin, outs, stride, _, no_skip in self.cfg:
            convs, c = {}, cin
            for i, o in enumerate(outs):
                convs[f"conv{i + 1}"] = _Group(
                    conv_dw=_cv(c, c, 3, device, c), bn_dw=_abn(c, device),
                    conv_pw=_cv(c, o, 1, device), bn_pw=_abn(o, device))
                c = o
            blk = _Group(stack=_Group(**convs))
            if not no_skip and (outs[-1] != cin or stride != 1):
                blk.shortcut = _Group(conv=_cv(cin, outs[-1], 1, device),
                                      bn=_abn(outs[-1], device))
            blocks.append(blk)
        self.blocks = nn.ModuleList(blocks)
        self.num_features = XCEPTION_ALIGNED_FEATURES
        if num_classes:
            self.head = _Group(fc=nn.Linear(XCEPTION_ALIGNED_FEATURES,
                                            num_classes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s0, s1 = self.stem
        x = _batch_norm(_conv(x, s0.conv.weight, 2, 1), s0.bn)
        x = _batch_norm(_conv(x, s1.conv.weight, 1, 1), s1.bn)
        for blk, (_, _, stride, start_relu, no_skip) in zip(self.blocks,
                                                            self.cfg):
            y = x
            for i in range(3):
                if start_relu:
                    y = F.relu(y)
                m = getattr(blk.stack, f"conv{i + 1}")
                y = _batch_norm(_conv(y, m.conv_dw.weight,
                                      stride if i == 2 else 1, 1,
                                      y.shape[1]), m.bn_dw,
                                act=not start_relu)
                y = _batch_norm(_conv(y, m.conv_pw.weight), m.bn_pw,
                                act=not start_relu)
            if no_skip:
                x = y
            else:
                skip = x
                if hasattr(blk, "shortcut"):
                    skip = _batch_norm(_conv(x, blk.shortcut.conv.weight,
                                             stride), blk.shortcut.bn,
                                       act=False)
                x = y + skip
        return x


def xception_aligned_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_xception_aligned tree -> XceptionAligned
    names."""
    sd = {}
    for i, q in enumerate(p["stem"]):
        sd.update(_cb_sd(q["conv"], q["bn"], f"stem.{i}.conv.weight",
                         f"stem.{i}.bn."))
    for bi, bp in enumerate(p["blocks"]):
        base = f"blocks.{bi}."
        for i, q in enumerate(bp["seps"]):
            cb = f"{base}stack.conv{i + 1}."
            sd.update({**_cb_sd(q["dw"], q["bn_dw"], cb + "conv_dw.weight",
                                cb + "bn_dw."),
                       cb + "conv_pw.weight": _oihw(q["pw"]),
                       **_norm_sd(q["bn_pw"], cb + "bn_pw.")})
        if "shortcut" in bp:
            sd.update(_cb_sd(bp["shortcut"]["conv"], bp["shortcut"]["bn"],
                             base + "shortcut.conv.weight",
                             base + "shortcut.bn."))
    return sd
