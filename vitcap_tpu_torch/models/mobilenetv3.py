"""MobileNetV3 large / small / rw and the tf_ twins of the model zoo: the
port of vitcap_tpu/models/mobilenetv3.py.

The effnet builder's ds and ir blocks (models/efficientnet.py) with a
per-block activation (relu for `re` entries, hard_swish else), SE reduced
from the block's mid channels (divisor 8; 1 for rw) behind a hard-sigmoid
gate, fixed repeats, a trailing `cn` stage (1x1 conv + BN + act, no
residual; it counts in the drop-path schedule), and the "efficient head":
global average pool, then the 1x1 conv_head (with a bias unless rw) and
the act, then dropout and the classifier.  The tf_ twins pad TF-'SAME'
with BatchNorm eps 1e-3; the minimal archs are relu, 3x3 and SE-free.

State-dict names: conv_stem, bn1, blocks.{s}.{i}.{conv_dw, conv_pw,
conv_pwl, se.conv_reduce, se.conv_expand, bn1-3} (blocks.{last}.0.{conv,
bn1} for cn), conv_head (+ bias), classifier.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (_batch_norm, _bn, _conv, _cv, _norm_sd, _oihw, _t,
                        drop_path, head_dropout, train_opts)
from .efficientnet import (BN_EPS_TF, _dw, _effnet_block, _pad, _se,
                           blocks_from_jax, has_residual, make_divisible,
                           round_channels)
from .layers import _Group, dense


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6."""
    return F.hardswish(x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6."""
    return F.hardsigmoid(x)


_ACTS = {"re": F.relu, "hs": hard_swish}

# one tuple per stage (timm's arch rows), each of (type, repeats, k,
# stride, expand, out_c, se_ratio, act) entries
_ARCH_LARGE = (
    (("ds", 1, 3, 1, 1.0, 16, 0.0, "re"),),
    (("ir", 1, 3, 2, 4.0, 24, 0.0, "re"),
     ("ir", 1, 3, 1, 3.0, 24, 0.0, "re")),
    (("ir", 3, 5, 2, 3.0, 40, 0.25, "re"),),
    (("ir", 1, 3, 2, 6.0, 80, 0.0, "hs"),
     ("ir", 1, 3, 1, 2.5, 80, 0.0, "hs"),
     ("ir", 2, 3, 1, 2.3, 80, 0.0, "hs")),
    (("ir", 2, 3, 1, 6.0, 112, 0.25, "hs"),),
    (("ir", 3, 5, 2, 6.0, 160, 0.25, "hs"),),
    (("cn", 1, 1, 1, 0.0, 960, 0.0, "hs"),),
)
_ARCH_SMALL = (
    (("ds", 1, 3, 2, 1.0, 16, 0.25, "re"),),
    (("ir", 1, 3, 2, 4.5, 24, 0.0, "re"),
     ("ir", 1, 3, 1, 3.67, 24, 0.0, "re")),
    (("ir", 1, 5, 2, 4.0, 40, 0.25, "hs"),
     ("ir", 2, 5, 1, 6.0, 40, 0.25, "hs")),
    (("ir", 2, 5, 1, 3.0, 48, 0.25, "hs"),),
    (("ir", 3, 5, 2, 6.0, 96, 0.25, "hs"),),
    (("cn", 1, 1, 1, 0.0, 576, 0.0, "hs"),),
)
_ARCH_RW = _ARCH_LARGE     # rw differs in its SE, head and first noskip
_ARCH_LARGE_MIN = (
    (("ds", 1, 3, 1, 1.0, 16, 0.0, "re"),),
    (("ir", 1, 3, 2, 4.0, 24, 0.0, "re"),
     ("ir", 1, 3, 1, 3.0, 24, 0.0, "re")),
    (("ir", 3, 3, 2, 3.0, 40, 0.0, "re"),),
    (("ir", 1, 3, 2, 6.0, 80, 0.0, "re"),
     ("ir", 1, 3, 1, 2.5, 80, 0.0, "re"),
     ("ir", 2, 3, 1, 2.3, 80, 0.0, "re")),
    (("ir", 2, 3, 1, 6.0, 112, 0.0, "re"),),
    (("ir", 3, 3, 2, 6.0, 160, 0.0, "re"),),
    (("cn", 1, 1, 1, 0.0, 960, 0.0, "re"),),
)
_ARCH_SMALL_MIN = (
    (("ds", 1, 3, 2, 1.0, 16, 0.0, "re"),),
    (("ir", 1, 3, 2, 4.5, 24, 0.0, "re"),
     ("ir", 1, 3, 1, 3.67, 24, 0.0, "re")),
    (("ir", 1, 3, 2, 4.0, 40, 0.0, "re"),
     ("ir", 2, 3, 1, 6.0, 40, 0.0, "re")),
    (("ir", 2, 3, 1, 3.0, 48, 0.0, "re"),),
    (("ir", 3, 3, 2, 6.0, 96, 0.0, "re"),),
    (("cn", 1, 1, 1, 0.0, 576, 0.0, "re"),),
)

# name -> (channel_multiplier, default img, arch, num_features, head_bias,
#          se_divisor, se_act (None: the block's), stem and head act)
MOBILENETV3S = {
    "mobilenetv3_large_075": (0.75, 224, _ARCH_LARGE, 1280, True, 8, "re",
                              "hs"),
    "mobilenetv3_large_100": (1.0, 224, _ARCH_LARGE, 1280, True, 8, "re",
                              "hs"),
    "mobilenetv3_small_075": (0.75, 224, _ARCH_SMALL, 1024, True, 8, "re",
                              "hs"),
    "mobilenetv3_small_100": (1.0, 224, _ARCH_SMALL, 1024, True, 8, "re",
                              "hs"),
    "mobilenetv3_rw": (1.0, 224, _ARCH_RW, 1280, False, 1, None, "hs"),
}
for _cm, _sfx in ((0.75, "075"), (1.0, "100")):
    MOBILENETV3S[f"tf_mobilenetv3_large_{_sfx}"] = \
        (_cm, 224, _ARCH_LARGE, 1280, True, 8, "re", "hs")
    MOBILENETV3S[f"tf_mobilenetv3_small_{_sfx}"] = \
        (_cm, 224, _ARCH_SMALL, 1024, True, 8, "re", "hs")
MOBILENETV3S["tf_mobilenetv3_large_minimal_100"] = \
    (1.0, 224, _ARCH_LARGE_MIN, 1280, True, 8, "re", "re")
MOBILENETV3S["tf_mobilenetv3_small_minimal_100"] = \
    (1.0, 224, _ARCH_SMALL_MIN, 1024, True, 8, "re", "re")
TF_MN3 = frozenset(n for n in MOBILENETV3S if n.startswith("tf_"))


def mn3_plan(variant: str) -> Tuple[int, List[List[dict]], int, bool]:
    """(stem channels, stages of block dicts, num_features, head_bias)."""
    cm, _, arch, feats, head_bias, se_div, se_act, _ = MOBILENETV3S[variant]
    stem = round_channels(16, cm)
    in_c = stem
    stages: List[List[dict]] = []
    for row_i, row in enumerate(arch):
        blocks = []
        for bt, r, k, s, e, c, se, a in row:
            out = round_channels(c, cm)
            for bi in range(r):
                mid = make_divisible(in_c * e) if bt == "ir" else in_c
                blocks.append({
                    "type": bt, "k": k, "stride": s if bi == 0 else 1,
                    "in": in_c, "mid": mid, "out": out, "act": a,
                    "se": make_divisible(mid * se, se_div) if se > 0 else 0,
                    "se_act": se_act or a,
                    "noskip": variant == "mobilenetv3_rw" and row_i == 0,
                })
                in_c = out
        stages.append(blocks)
    return stem, stages, feats, head_bias


def mn3_feature_channels(variant: str) -> int:
    return mn3_plan(variant)[2]


class MobileNetV3(nn.Module):
    """(B, 3, H, W) -> (B, cn_out, H / 32, W / 32), the pre-pool map;
    `classify` runs the efficient head (conv_head, act) and the
    classifier on the pooled features.  n_stages > 0 keeps the first
    n_stages stages (a reduced-depth check)."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        stem, stages, feats, head_bias = mn3_plan(variant)
        self.plan = stages[:n_stages or None]
        self.same = variant in TF_MN3
        self.act = _ACTS[MOBILENETV3S[variant][7]]
        eps = BN_EPS_TF if self.same else 1e-5

        def bn(c):
            return _bn(c, device, eps)
        self.conv_stem = _cv(3, stem, 3, device)
        self.bn1 = bn(stem)
        self.blocks = nn.ModuleList(
            nn.ModuleList(_Group(conv=_cv(b["in"], b["out"], b["k"], device),
                                 bn1=bn(b["out"])) if b["type"] == "cn"
                          else _effnet_block(b, bn, device) for b in blocks)
            for blocks in self.plan)
        self.conv_head = _cv(self.plan[-1][-1]["out"], feats, 1, device,
                             bias=head_bias)
        self.num_features = feats
        if num_classes:
            self.classifier = nn.Linear(feats, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        same = self.same
        x = self.act(_batch_norm(_conv(x, self.conv_stem.weight, 2,
                                       _pad(3, same)), self.bn1, act=False))
        tm = train_opts(self)
        n = sum(len(b) for b in self.plan)
        i = 0
        for blocks, mods in zip(self.plan, self.blocks):
            for blk, m in zip(blocks, mods):
                act = _ACTS[blk["act"]]
                if blk["type"] == "cn":
                    x = act(_batch_norm(_conv(x, m.conv.weight,
                                              blk["stride"],
                                              _pad(blk["k"], same)),
                                        m.bn1, act=False))
                else:
                    y = _mn3_branch(m, blk, x, act, same)
                    x = (drop_path(y, tm, i / n) + x if has_residual(blk)
                         else y)
                i += 1
        return x

    def classify(self, pooled: torch.Tensor) -> torch.Tensor:
        w = self.conv_head.weight
        h = pooled @ w.flatten(1).to(pooled.dtype).t()
        if self.conv_head.bias is not None:
            h = h + self.conv_head.bias.to(pooled.dtype)
        return dense(self.classifier,
                     head_dropout(self.act(h), train_opts(self)))


def _mn3_branch(m, blk: dict, x: torch.Tensor, act, same: bool
                ) -> torch.Tensor:
    def bn(y, norm):
        return _batch_norm(y, norm, act=False)

    if blk["type"] == "ds":
        y = act(bn(_dw(x, m.conv_dw.weight, blk["stride"], same), m.bn1))
    else:
        y = act(bn(_conv(x, m.conv_pw.weight), m.bn1))
        y = act(bn(_dw(y, m.conv_dw.weight, blk["stride"], same), m.bn2))
    if blk["se"]:
        y = _se(y, m.se, _ACTS[blk["se_act"]], hard_sigmoid)
    if blk["type"] == "ds":
        return bn(_conv(y, m.conv_pw.weight), m.bn2)
    return bn(_conv(y, m.conv_pwl.weight), m.bn3)


def mn3_from_jax(p) -> dict:
    """The JAX package's init_mn3 tree -> MobileNetV3 names."""
    hw = p["head"]["conv"]                                  # (C, F)
    sd = {"conv_stem.weight": _oihw(p["stem"]["conv"]),
          **_norm_sd(p["stem"]["bn"], "bn1."),
          **blocks_from_jax(p["stages"]),
          "conv_head.weight": _t(hw).t()[:, :, None, None].contiguous()}
    if "bias" in p["head"]:
        sd["conv_head.bias"] = _t(p["head"]["bias"])
    return sd
