"""The EfficientNet builder's nets of the model zoo: the port of
vitcap_tpu/models/efficientnet.py.

EfficientNet B0-B8, L2, Lite0-4, CondConv (cc_*), EdgeTPU (es/em/el), the
pruned b1-b3, their tf_ twins (TF-'SAME' padding, BatchNorm eps 1e-3 and
train momentum 0.01), and the builder's other nets: mnasnet, semnasnet,
mobilenetv2, fbnetc, spnasnet.  The plans (stage repeats, channel
rounding, SE widths) are the JAX package's, copied: make_divisible with
its 0.9 guard, ceil depth scaling (lite pins the first and last stage).

Blocks: DepthwiseSeparable `ds` (dw -> BN + act -> SE -> pw -> BN),
InvertedResidual `ir` (pw -> BN + act -> dw -> BN + act -> SE -> pwl ->
BN), EdgeResidual `er` (k x k expand -> BN + act -> SE -> strided 1x1 pwl
-> BN) and CondConvResidual (the ir graph with each conv's kernel mixed
per sample from its experts by one sigmoid routing of the block input:
the 1x1s as batched products, the depthwise as one conv of B * C groups);
the residual (drop-path on the branch in train mode) where stride 1 and
in == out and the plan says no `noskip` (the pruned nets decide it on the
parent's widths).  Symmetric k // 2 padding unless TF-'SAME'.

The modules hold timm's torch state-dict names (conv_stem, bn1,
blocks.{stage}.{i}.{conv_dw, conv_pw, conv_pwl, conv_exp, routing_fn,
se.conv_reduce, se.conv_expand, bn1-3}, conv_head, bn2, classifier; a
CondConv's experts flat as (E, out * in * k * k)) and compute NCHW in the
input's dtype, convolutions by cuDNN on the card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (_batch_norm, _bn, _conv, _cv, _norm_sd, _oihw, _t,
                        drop_path, head_dropout, train_opts)
from .layers import _Group, dense


def make_divisible(v: float, divisor: int = 8, min_value=None) -> int:
    """Round v to a multiple of divisor, at least min_value (default the
    divisor), and not below 0.9 v."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def round_channels(channels: float, multiplier: float = 1.0,
                   divisor: int = 8) -> int:
    if not multiplier:
        return int(channels)
    return make_divisible(channels * multiplier, divisor)


def scale_stage_repeats(repeats: List[int], dm: float,
                        trunc: str = "ceil") -> List[int]:
    """Scale a stage's total repeat count by dm ('ceil' or 'round'), then
    share it out over the stage's entries from the last one back."""
    num = sum(repeats)
    scaled = max(1, round(num * dm)) if trunc == "round" \
        else int(math.ceil(num * dm))
    out: List[int] = []
    for r in repeats[::-1]:
        rs = max(1, round(r / num * scaled))
        out.append(rs)
        num -= r
        scaled -= rs
    return out[::-1]


# the base arch: (type, repeats, k, stride, expand, out_c, se_ratio); lite
# drops SE and takes relu6
_ARCH = (
    ("ds", 1, 3, 1, 1, 16, 0.25),
    ("ir", 2, 3, 2, 6, 24, 0.25),
    ("ir", 2, 5, 2, 6, 40, 0.25),
    ("ir", 3, 3, 2, 6, 80, 0.25),
    ("ir", 3, 5, 1, 6, 112, 0.25),
    ("ir", 4, 5, 2, 6, 192, 0.25),
    ("ir", 1, 3, 1, 6, 320, 0.25),
)

# name -> (channel_multiplier, depth_multiplier, default img, kind)
EFFICIENTNETS = {
    "efficientnet_b0": (1.0, 1.0, 224, "b"),
    "efficientnet_b1": (1.0, 1.1, 240, "b"),
    "efficientnet_b2": (1.1, 1.2, 260, "b"),
    "efficientnet_b3": (1.2, 1.4, 300, "b"),
    "efficientnet_b4": (1.4, 1.8, 380, "b"),
    "efficientnet_b5": (1.6, 2.2, 456, "b"),
    "efficientnet_b6": (1.8, 2.6, 528, "b"),
    "efficientnet_b7": (2.0, 3.1, 600, "b"),
    "efficientnet_b8": (2.2, 3.6, 672, "b"),
    "efficientnet_lite0": (1.0, 1.0, 224, "lite"),
    "efficientnet_lite1": (1.0, 1.1, 240, "lite"),
    "efficientnet_lite2": (1.1, 1.2, 260, "lite"),
    "efficientnet_lite3": (1.2, 1.4, 280, "lite"),
    "efficientnet_lite4": (1.4, 1.8, 300, "lite"),
    "efficientnet_b2a": (1.1, 1.2, 288, "b"),
    "efficientnet_b3a": (1.2, 1.4, 320, "b"),
    "efficientnet_l2": (4.3, 5.3, 800, "b"),
    # CondConv on the last three stages, 4 * multiplier experts
    "efficientnet_cc_b0_4e": (1.0, 1.0, 224, "cc4"),
    "efficientnet_cc_b0_8e": (1.0, 1.0, 224, "cc8"),
    "efficientnet_cc_b1_8e": (1.0, 1.1, 240, "cc8"),
    # pruned: the parent's multipliers, widths from models/pruned.py,
    # TF-'SAME' and eps 1e-3
    "efficientnet_b1_pruned": (1.0, 1.1, 240, "b"),
    "efficientnet_b2_pruned": (1.1, 1.2, 260, "b"),
    "efficientnet_b3_pruned": (1.2, 1.4, 300, "b"),
}
PRUNED_EFFNETS = {"efficientnet_b1_pruned", "efficientnet_b2_pruned",
                  "efficientnet_b3_pruned"}


def _B(t, r, k, s, e, c, se=0.0, ns=False, fc=0):
    """(type, repeats, k, stride, expand, out_c, se_ratio, noskip, the
    first block's expansion base)."""
    return (t, r, k, s, e, c, se, ns, fc)


# the builder's other nets; `rows` is the number of entries of each stage
# where a stage holds more than one
GENERIC_EFFNETS = {
    "mnasnet_050": dict(cm=0.5, act="relu", stem=32, head=1280, arch=(
        _B("ds", 1, 3, 1, 1, 16, ns=True), _B("ir", 3, 3, 2, 3, 24),
        _B("ir", 3, 5, 2, 3, 40), _B("ir", 3, 5, 2, 6, 80),
        _B("ir", 2, 3, 1, 6, 96), _B("ir", 4, 5, 2, 6, 192),
        _B("ir", 1, 3, 1, 6, 320, ns=True))),
    "semnasnet_050": dict(cm=0.5, act="relu", stem=32, head=1280, arch=(
        _B("ds", 1, 3, 1, 1, 16, ns=True), _B("ir", 2, 3, 2, 6, 24),
        _B("ir", 3, 5, 2, 3, 40, se=0.25), _B("ir", 4, 3, 2, 6, 80),
        _B("ir", 2, 3, 1, 6, 112, se=0.25),
        _B("ir", 3, 5, 2, 6, 160, se=0.25),
        _B("ir", 1, 3, 1, 6, 320, ns=True))),
    "mnasnet_small": dict(cm=1.0, act="relu", stem=8, head=1280, arch=(
        _B("ds", 1, 3, 1, 1, 8), _B("ir", 1, 3, 2, 3, 16),
        _B("ir", 2, 3, 2, 6, 16), _B("ir", 4, 5, 2, 6, 32, se=0.25),
        _B("ir", 3, 3, 1, 6, 32, se=0.25),
        _B("ir", 3, 5, 2, 6, 88, se=0.25), _B("ir", 1, 3, 1, 6, 144))),
    "mobilenetv2_100": dict(cm=1.0, act="relu6", stem=32, head=1280,
                            head_cm=True, arch=(
        _B("ds", 1, 3, 1, 1, 16), _B("ir", 2, 3, 2, 6, 24),
        _B("ir", 3, 3, 2, 6, 32), _B("ir", 4, 3, 2, 6, 64),
        _B("ir", 3, 3, 1, 6, 96), _B("ir", 3, 3, 2, 6, 160),
        _B("ir", 1, 3, 1, 6, 320))),
    "fbnetc_100": dict(cm=1.0, act="relu", stem=16, head=1984, arch=(
        _B("ir", 1, 3, 1, 1, 16), _B("ir", 1, 3, 2, 6, 24),
        _B("ir", 2, 3, 1, 1, 24),
        _B("ir", 1, 5, 2, 6, 32), _B("ir", 1, 5, 1, 3, 32),
        _B("ir", 1, 5, 1, 6, 32), _B("ir", 1, 3, 1, 6, 32),
        _B("ir", 1, 5, 2, 6, 64), _B("ir", 1, 5, 1, 3, 64),
        _B("ir", 2, 5, 1, 6, 64),
        _B("ir", 3, 5, 1, 6, 112), _B("ir", 1, 5, 1, 3, 112),
        _B("ir", 4, 5, 2, 6, 184), _B("ir", 1, 3, 1, 6, 352)),
        rows=(1, 2, 4, 3, 2, 1, 1)),
    "spnasnet_100": dict(cm=1.0, act="relu", stem=32, head=1280, arch=(
        _B("ds", 1, 3, 1, 1, 16, ns=True), _B("ir", 3, 3, 2, 3, 24),
        _B("ir", 1, 5, 2, 6, 40), _B("ir", 3, 3, 1, 3, 40),
        _B("ir", 1, 5, 2, 6, 80), _B("ir", 3, 3, 1, 3, 80),
        _B("ir", 1, 5, 1, 6, 96), _B("ir", 3, 5, 1, 3, 96),
        _B("ir", 4, 5, 2, 6, 192), _B("ir", 1, 3, 1, 6, 320, ns=True)),
        rows=(1, 1, 2, 2, 2, 1, 1)),
}
for _cm, _sfx in ((0.75, "075"), (1.0, "100"), (1.4, "140")):
    GENERIC_EFFNETS[f"mnasnet_{_sfx}"] = dict(
        GENERIC_EFFNETS["mnasnet_050"], cm=_cm)
    GENERIC_EFFNETS[f"semnasnet_{_sfx}"] = dict(
        GENERIC_EFFNETS["semnasnet_050"], cm=_cm)
GENERIC_EFFNETS["mnasnet_b1"] = GENERIC_EFFNETS["mnasnet_100"]
GENERIC_EFFNETS["mnasnet_a1"] = GENERIC_EFFNETS["semnasnet_100"]
GENERIC_EFFNETS["mobilenetv2_140"] = dict(
    GENERIC_EFFNETS["mobilenetv2_100"], cm=1.4)
GENERIC_EFFNETS["mobilenetv2_110d"] = dict(
    GENERIC_EFFNETS["mobilenetv2_100"], cm=1.1, dm=1.2, fix_stem_head=True)
GENERIC_EFFNETS["mobilenetv2_120d"] = dict(
    GENERIC_EFFNETS["mobilenetv2_100"], cm=1.2, dm=1.4, fix_stem_head=True)
# EfficientNet-EdgeTPU: EdgeResidual blocks, relu; the first block's
# expansion base is 24
_EDGE_ARCH = (
    _B("er", 1, 3, 1, 4, 24, ns=True, fc=24), _B("er", 2, 3, 2, 8, 32),
    _B("er", 4, 3, 2, 8, 48), _B("ir", 5, 5, 2, 8, 96),
    _B("ir", 4, 5, 1, 8, 144), _B("ir", 2, 5, 2, 8, 192))
GENERIC_EFFNETS["efficientnet_es"] = dict(
    cm=1.0, dm=1.0, act="relu", stem=32, head=1280, head_cm=True,
    arch=_EDGE_ARCH)
GENERIC_EFFNETS["efficientnet_em"] = dict(
    GENERIC_EFFNETS["efficientnet_es"], cm=1.0, dm=1.1)
GENERIC_EFFNETS["efficientnet_el"] = dict(
    GENERIC_EFFNETS["efficientnet_es"], cm=1.2, dm=1.4)

# the tf_ twins: the base variant's graph with TF-'SAME' padding and
# BatchNorm eps 1e-3 (the _ap and _ns names are recipes of the same
# graph); values (base variant, default img size)
BN_EPS_TF = 1e-3
TF_EFFNETS: Dict[str, Tuple[str, int]] = {}
for _i, _img in enumerate((224, 240, 260, 300, 380, 456, 528, 600, 672)):
    TF_EFFNETS[f"tf_efficientnet_b{_i}"] = (f"efficientnet_b{_i}", _img)
    TF_EFFNETS[f"tf_efficientnet_b{_i}_ap"] = (f"efficientnet_b{_i}", _img)
    if _i <= 7:
        TF_EFFNETS[f"tf_efficientnet_b{_i}_ns"] = \
            (f"efficientnet_b{_i}", _img)
TF_EFFNETS["tf_efficientnet_l2_ns"] = ("efficientnet_l2", 800)
TF_EFFNETS["tf_efficientnet_l2_ns_475"] = ("efficientnet_l2", 475)
for _i, _img in enumerate((224, 240, 260, 280, 300)):
    TF_EFFNETS[f"tf_efficientnet_lite{_i}"] = \
        (f"efficientnet_lite{_i}", _img)
for _sfx, _img in (("es", 224), ("em", 240), ("el", 300)):
    TF_EFFNETS[f"tf_efficientnet_{_sfx}"] = (f"efficientnet_{_sfx}", _img)
for _cc in ("cc_b0_4e", "cc_b0_8e", "cc_b1_8e"):
    TF_EFFNETS[f"tf_efficientnet_{_cc}"] = \
        (f"efficientnet_{_cc}", 240 if "b1" in _cc else 224)


def resolve_variant(variant: str) -> Tuple[str, bool]:
    """-> (the base arch variant, TF-'SAME' padding and BN eps 1e-3)."""
    if variant in TF_EFFNETS:
        return TF_EFFNETS[variant][0], True
    return variant, variant in PRUNED_EFFNETS


def effnet_bn_eps(variant: str) -> float:
    if variant in TF_EFFNETS or variant in PRUNED_EFFNETS:
        return BN_EPS_TF
    return 1e-5


def effnet_bn_momentum(variant: str) -> float:
    """The running statistics' train momentum: torch's 0.1; 0.01 for the
    TF-ported variants."""
    if variant in TF_EFFNETS or variant in PRUNED_EFFNETS:
        return 0.01
    return 0.1


def effnet_plan(variant: str) -> Tuple[int, List[List[dict]], int]:
    """(stem channels, stages of block dicts, head channels); the stages
    are timm's arch rows, so blocks.{stage}.{i} are its state-dict
    names."""
    variant, _ = resolve_variant(variant)
    if variant in GENERIC_EFFNETS:
        g = GENERIC_EFFNETS[variant]
        cm, dm = g["cm"], g.get("dm", 1.0)
        fix_sh = g.get("fix_stem_head", False)
        stem = g["stem"] if fix_sh else round_channels(g["stem"], cm)
        in_c = stem
        rows = g.get("rows") or (1,) * len(g["arch"])
        stages: List[List[dict]] = []
        ai = 0
        last_row = len(rows) - 1
        for ri, n_entries in enumerate(rows):
            blocks = []
            for _ in range(n_entries):
                bt, r, k, s, e, c, se, ns, fc = g["arch"][ai]
                ai += 1
                reps = r if (fix_sh and ri in (0, last_row)) \
                    else int(math.ceil(r * dm))
                out = round_channels(c, cm)
                for bi in range(reps):
                    base = fc if (fc and bi == 0) else in_c
                    blocks.append({
                        "type": bt, "k": k,
                        "stride": s if bi == 0 else 1,
                        "in": in_c, "mid": make_divisible(round(base * e)),
                        "out": out,
                        "se": make_divisible(in_c * se, 1) if se > 0
                        else 0,
                        "noskip": ns,
                    })
                    in_c = out
            stages.append(blocks)
        head = g["head"] if (fix_sh or not g.get("head_cm")) \
            else round_channels(g["head"], cm)
        return stem, stages, head
    cm, dm, _, kind = EFFICIENTNETS[variant]
    lite = kind == "lite"
    experts = int(kind[2:]) if kind.startswith("cc") else 0
    stem = 32 if lite else round_channels(32, cm)
    in_c = stem
    stages = []
    last = len(_ARCH) - 1
    for si, (bt, r, k, s, e, c, se) in enumerate(_ARCH):
        if lite:
            se = 0.0
            reps = r if si in (0, last) else int(math.ceil(r * dm))
        else:
            reps = int(math.ceil(r * dm))
        out = round_channels(c, cm)
        blocks = []
        for bi in range(reps):
            blocks.append({
                "type": bt, "k": k, "stride": s if bi == 0 else 1,
                "in": in_c, "mid": make_divisible(in_c * e), "out": out,
                "se": make_divisible(in_c * se, 1) if se > 0 else 0,
                "experts": experts if (experts and si >= 4) else 0,
            })
            in_c = out
        stages.append(blocks)
    head = 1280 if lite else round_channels(1280, cm)
    if variant in PRUNED_EFFNETS:
        return _pruned_effnet_plan(variant, stages)
    return stem, stages, head


def _pruned_effnet_plan(variant, stages):
    """The parent plan re-dimensioned by the pruned shape manifest; the
    residual follows the parent's stride and in == out (timm builds the
    module graph before it adapts the widths)."""
    from .pruned import pruned_shapes
    shapes = pruned_shapes(variant)
    stem = shapes["conv_stem.weight"][0]
    head = shapes["conv_head.weight"][0]
    for si, blocks in enumerate(stages):
        for bi, blk in enumerate(blocks):
            b = f"blocks.{si}.{bi}."
            parent_res = (blk["stride"] == 1 and blk["in"] == blk["out"]
                          and not blk.get("noskip"))
            if blk["type"] == "ds":
                blk["in"] = blk["mid"] = shapes[b + "conv_dw.weight"][0]
                blk["out"] = shapes[b + "conv_pw.weight"][0]
            else:
                blk["mid"] = shapes[b + "conv_pw.weight"][0]
                blk["in"] = shapes[b + "conv_pw.weight"][1]
                blk["out"] = shapes[b + "conv_pwl.weight"][0]
            if blk["se"]:
                blk["se"] = shapes[b + "se.conv_reduce.weight"][0]
            if not parent_res:
                blk["noskip"] = True
    return stem, stages, head


_ACT_FNS: Dict[str, Callable] = {"relu": F.relu, "relu6": F.relu6,
                                 "swish": F.silu}


def effnet_act(variant: str) -> Callable:
    variant, _ = resolve_variant(variant)
    if variant in GENERIC_EFFNETS:
        return _ACT_FNS[GENERIC_EFFNETS[variant]["act"]]
    return _ACT_FNS["relu6" if EFFICIENTNETS[variant][3] == "lite"
                    else "swish"]


def effnet_feature_channels(variant: str) -> int:
    return effnet_plan(variant)[2]


# ---------------------------------------------------------------------------
# primitives (NCHW, the input's dtype)
# ---------------------------------------------------------------------------

def _pad(k: int, same: bool):
    """Symmetric k // 2, or TF-'SAME'."""
    return "same" if same else k // 2


def _dw(x: torch.Tensor, w: torch.Tensor, stride: int, same: bool
        ) -> torch.Tensor:
    """Depthwise conv, w (C, 1, k, k)."""
    return _conv(x, w, stride, _pad(w.shape[-1], same), x.shape[1])


def _se(x: torch.Tensor, se, act: Callable, gate: Callable = torch.sigmoid
        ) -> torch.Tensor:
    """Squeeze-excite: channel means, 1x1 reduce + act, 1x1 expand, gate."""
    dt = x.dtype
    r, e = se.conv_reduce, se.conv_expand
    s = act(F.linear(x.mean(dim=(2, 3)), r.weight.flatten(1).to(dt),
                     r.bias.to(dt)))
    s = F.linear(s, e.weight.flatten(1).to(dt), e.bias.to(dt))
    return x * gate(s)[:, :, None, None]


class _Experts(nn.Module):
    """A CondConv's expert kernels in timm's flat layout: weight (E,
    prod(shape)), shape the conv's OIHW kernel; initialised normal with
    std sqrt(2 / fan_out)."""

    def __init__(self, experts: int, shape: Tuple[int, ...], fan_out: int,
                 device=None):
        super().__init__()
        self.shape = shape
        self.init_std = math.sqrt(2.0 / fan_out)
        self.weight = nn.Parameter(torch.empty(experts, math.prod(shape),
                                               device=device))


def _cc_mix(rw: torch.Tensor, ex: _Experts) -> torch.Tensor:
    """Each sample's kernel: the experts weighted by its routing, (B,
    *ex.shape)."""
    return (rw @ ex.weight.to(rw.dtype)).view(rw.shape[0], *ex.shape)


def _cc_pw(x: torch.Tensor, ex: _Experts, rw: torch.Tensor
           ) -> torch.Tensor:
    """Per-sample 1x1 conv as one batched product; NCHW contiguous out."""
    B, C, H, W = x.shape
    mix = _cc_mix(rw, ex).view(B, -1, C)
    return torch.bmm(mix, x.reshape(B, C, H * W)).view(B, -1, H, W)


def _cc_dw(x: torch.Tensor, ex: _Experts, rw: torch.Tensor, stride: int,
           same: bool) -> torch.Tensor:
    """Per-sample depthwise conv: one conv of B * C groups."""
    B, C, H, W = x.shape
    k = ex.shape[-1]
    w = _cc_mix(rw, ex).reshape(B * C, 1, k, k)
    y = _conv(x.reshape(1, B * C, H, W), w, stride, _pad(k, same), B * C)
    return y.view(B, C, y.shape[2], y.shape[3])


def _se_module(c: int, red: int, device) -> _Group:
    return _Group(conv_reduce=_cv(c, red, 1, device, bias=True),
                  conv_expand=_cv(red, c, 1, device, bias=True))


def _effnet_block(blk: dict, bn, device) -> _Group:
    k, cin, mid, out = blk["k"], blk["in"], blk["mid"], blk["out"]
    if blk["type"] == "er":
        m = _Group(conv_exp=_cv(cin, mid, k, device), bn1=bn(mid),
                   conv_pwl=_cv(mid, out, 1, device), bn2=bn(out))
    elif blk["type"] == "ds":
        m = _Group(conv_dw=_cv(cin, cin, k, device, cin), bn1=bn(cin),
                   conv_pw=_cv(cin, out, 1, device), bn2=bn(out))
        mid = cin
    elif blk.get("experts"):
        e = blk["experts"]
        m = _Group(routing_fn=nn.Linear(cin, e, device=device),
                   conv_pw=_Experts(e, (mid, cin, 1, 1), mid, device),
                   bn1=bn(mid),
                   conv_dw=_Experts(e, (mid, 1, k, k), k * k, device),
                   bn2=bn(mid),
                   conv_pwl=_Experts(e, (out, mid, 1, 1), out, device),
                   bn3=bn(out))
    else:
        m = _Group(conv_pw=_cv(cin, mid, 1, device), bn1=bn(mid),
                   conv_dw=_cv(mid, mid, k, device, mid), bn2=bn(mid),
                   conv_pwl=_cv(mid, out, 1, device), bn3=bn(out))
    if blk["se"]:
        m.se = _se_module(mid, blk["se"], device)
    return m


def _effnet_branch(m, blk: dict, x: torch.Tensor, act: Callable, same: bool
                   ) -> torch.Tensor:
    """A block's residual branch."""
    def bn(y, norm):
        return _batch_norm(y, norm, act=False)

    if blk["type"] == "er":
        y = act(bn(_conv(x, m.conv_exp.weight, 1, _pad(blk["k"], same)),
                   m.bn1))
        if blk["se"]:
            y = _se(y, m.se, act)
        return bn(_conv(y, m.conv_pwl.weight, blk["stride"], _pad(1, same)),
                  m.bn2)
    if blk["type"] == "ds":
        y = act(bn(_dw(x, m.conv_dw.weight, blk["stride"], same), m.bn1))
        if blk["se"]:
            y = _se(y, m.se, act)
        return bn(_conv(y, m.conv_pw.weight), m.bn2)
    if blk.get("experts"):
        dt = x.dtype
        rw = torch.sigmoid(F.linear(x.mean(dim=(2, 3)),
                                    m.routing_fn.weight.to(dt),
                                    m.routing_fn.bias.to(dt)))
        y = act(bn(_cc_pw(x, m.conv_pw, rw), m.bn1))
        y = act(bn(_cc_dw(y, m.conv_dw, rw, blk["stride"], same), m.bn2))
        if blk["se"]:
            y = _se(y, m.se, act)
        return bn(_cc_pw(y, m.conv_pwl, rw), m.bn3)
    y = act(bn(_conv(x, m.conv_pw.weight), m.bn1))
    y = act(bn(_dw(y, m.conv_dw.weight, blk["stride"], same), m.bn2))
    if blk["se"]:
        y = _se(y, m.se, act)
    return bn(_conv(y, m.conv_pwl.weight), m.bn3)


def has_residual(blk: dict) -> bool:
    return (blk["stride"] == 1 and blk["in"] == blk["out"]
            and not blk.get("noskip"))


class EfficientNet(nn.Module):
    """(B, 3, H, W) -> (B, head, H / 32, W / 32), the post-head-conv map
    (timm's forward_features); `classifier` with num_classes > 0.
    n_stages > 0 keeps the first n_stages stages (a reduced-depth
    check)."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        stem, stages, head = effnet_plan(variant)
        self.plan = stages[:n_stages or None]
        self.act = effnet_act(variant)
        _, self.same = resolve_variant(variant)
        eps, mom = effnet_bn_eps(variant), effnet_bn_momentum(variant)

        def bn(c):
            return _bn(c, device, eps, mom)
        self.conv_stem = _cv(3, stem, 3, device)
        self.bn1 = bn(stem)
        self.blocks = nn.ModuleList(
            nn.ModuleList(_effnet_block(b, bn, device) for b in blocks)
            for blocks in self.plan)
        self.conv_head = _cv(self.plan[-1][-1]["out"], head, 1, device)
        self.bn2 = bn(head)
        self.num_features = head
        if num_classes:
            self.classifier = nn.Linear(head, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act, same = self.act, self.same
        x = act(_batch_norm(_conv(x, self.conv_stem.weight, 2,
                                  _pad(3, same)), self.bn1, act=False))
        # stochastic depth: the rate scales with the flat block index over
        # the block count (train mode only)
        tm = train_opts(self)
        n = sum(len(b) for b in self.plan)
        i = 0
        for blocks, mods in zip(self.plan, self.blocks):
            for blk, m in zip(blocks, mods):
                y = _effnet_branch(m, blk, x, act, same)
                x = drop_path(y, tm, i / n) + x if has_residual(blk) else y
                i += 1
        x = _conv(x, self.conv_head.weight, 1, _pad(1, same))
        return act(_batch_norm(x, self.bn2, act=False))

    def classify(self, pooled: torch.Tensor) -> torch.Tensor:
        return dense(self.classifier, head_dropout(pooled, train_opts(self)))


# ---------------------------------------------------------------------------
# weights carried across from the JAX package's param tree
# ---------------------------------------------------------------------------

def _se_sd(p, prefix: str, names=("conv_reduce", "conv_expand")
           ) -> Dict[str, torch.Tensor]:
    """An SE dict {reduce_w (C, r), reduce_b, expand_w (r, C), expand_b}
    -> two 1x1 convs."""
    rw, ew = np.asarray(p["reduce_w"]), np.asarray(p["expand_w"])
    return {f"{prefix}{names[0]}.weight": _t(rw.T)[:, :, None, None],
            f"{prefix}{names[0]}.bias": _t(p["reduce_b"]),
            f"{prefix}{names[1]}.weight": _t(ew.T)[:, :, None, None],
            f"{prefix}{names[1]}.bias": _t(p["expand_b"])}


def blocks_from_jax(stages, prefix: str = "blocks."
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's effnet-builder block dicts (efficientnet,
    mobilenetv3, mixnet) -> blocks.{s}.{i}. names: HWIO convs to OIHW, a
    mixed conv's kernel list to .{j}., CondConv experts to their flat
    torch layout, SE (`se` or mixnet's `se_p`) to se.conv_reduce /
    se.conv_expand."""
    sd = {}
    for si, blocks in enumerate(stages):
        for bi, bp in enumerate(blocks):
            base = f"{prefix}{si}.{bi}."
            for name, v in bp.items():
                if name.startswith("bn"):
                    sd.update(_norm_sd(v, f"{base}{name}."))
                elif name in ("se", "se_p"):
                    sd.update(_se_sd(v, base + "se."))
                elif name == "routing_w":
                    sd[base + "routing_fn.weight"] = _t(np.asarray(v).T)
                elif name == "routing_b":
                    sd[base + "routing_fn.bias"] = _t(v)
                elif isinstance(v, (list, tuple)):
                    for j, w in enumerate(v):
                        key = (f"{base}{name}.weight" if len(v) == 1
                               else f"{base}{name}.{j}.weight")
                        sd[key] = _oihw(w)
                elif np.ndim(v) == 3:       # CondConv 1x1: (E, in, out)
                    w = np.asarray(v, np.float32).transpose(0, 2, 1)
                    sd[base + name + ".weight"] = _t(w.reshape(len(w), -1))
                elif np.ndim(v) == 5:       # CondConv dw: (E, k, k, 1, C)
                    w = np.asarray(v, np.float32).transpose(0, 4, 3, 1, 2)
                    sd[base + name + ".weight"] = _t(w.reshape(len(w), -1))
                else:
                    sd[base + name + ".weight"] = _oihw(v)
    return sd


def effnet_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_effnet tree -> EfficientNet names."""
    return {"conv_stem.weight": _oihw(p["stem"]["conv"]),
            **_norm_sd(p["stem"]["bn"], "bn1."),
            **blocks_from_jax(p["stages"]),
            "conv_head.weight": _oihw(p["head"]["conv"]),
            **_norm_sd(p["head"]["bn"], "bn2.")}
