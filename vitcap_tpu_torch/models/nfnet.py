"""Normalizer-Free ResNets and RegNets of the model zoo (nf_regnet_b*,
nf_resnet*, nf_seresnet*, nf_ecaresnet*): the port of
vitcap_tpu/models/nfnet.py.

ScaledStdConv2d: each output channel's kernel standardised over (in, kh,
kw) with the biased std (+ 1e-5), times gamma / sqrt(fan_in) and a
learned per-channel gain, plus a bias; gamma is the activation's variance
correction (_GAMMA), folded into every conv.  A pre-activation block: out
= act(x) * beta (beta from the expected-variance schedule, reset after a
stage's first block); the projection shortcut (a 2 x 2 average pool,
ceil mode, padding not counted, then a 1x1 conv) reads the activated
out; 1x1 -> act -> grouped 3x3 (stride) -> [2 * SE or ECA] -> act ->
1x1; x = branch * alpha + shortcut.  Stems: 3x3/2 (regnets) or 7x7/2 +
3x3/2 max pool (resnets); the regnets add a 1x1 final conv to their
feature width; the final act; a linear head on the pooled map.

State-dict names: stem.conv.{weight, gain, bias}, stages.{s}.{b}.{conv1,
conv2, conv3}.*, .attn.{fc1, fc2} (SE) or .attn.conv (ECA),
.downsample.conv.*, final_conv.*, head.fc.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _eca_apply, _oihw, _se_apply, _t,
                        eca_kernel_size)
from .efficientnet import make_divisible
from .layers import _Group

_GAMMA = {"silu": 1.0 / 0.5595,
          "relu": (0.5 * (1.0 - 1.0 / math.pi)) ** -0.5}

_REGNET = dict(stem="3x3", stem_chs=None, group_size=8, attn="se",
               attn_rr=0.5, attn_div=8, width=0.75, bottle=2.25,
               efficient=True, act="silu", alpha=0.2)
_RESNET = dict(stem="7x7_pool", stem_chs=64, group_size=None, attn=None,
               attn_rr=0.0, attn_div=1, width=1.0, bottle=0.25,
               efficient=False, act="relu", alpha=0.2, num_features=0)
NFNETS = {
    "nf_regnet_b0": dict(_REGNET, depths=(1, 3, 6, 6),
                         channels=(48, 104, 208, 440), num_features=1280),
    "nf_regnet_b1": dict(_REGNET, depths=(2, 4, 7, 7),
                         channels=(48, 104, 208, 440), num_features=1280),
    "nf_regnet_b2": dict(_REGNET, depths=(2, 4, 8, 8),
                         channels=(56, 112, 232, 488), num_features=1416),
    "nf_regnet_b3": dict(_REGNET, depths=(2, 5, 9, 9),
                         channels=(56, 128, 248, 528), num_features=1536),
    "nf_regnet_b4": dict(_REGNET, depths=(2, 6, 11, 11),
                         channels=(64, 144, 288, 616), num_features=1792),
    "nf_regnet_b5": dict(_REGNET, depths=(3, 7, 14, 14),
                         channels=(80, 168, 336, 704), num_features=2048),
    "nf_resnet26": dict(_RESNET, depths=(2, 2, 2, 2),
                        channels=(256, 512, 1024, 2048)),
    "nf_resnet50": dict(_RESNET, depths=(3, 4, 6, 3),
                        channels=(256, 512, 1024, 2048)),
    "nf_resnet101": dict(_RESNET, depths=(3, 4, 23, 3),
                         channels=(256, 512, 1024, 2048)),
    "nf_seresnet26": dict(_RESNET, depths=(2, 2, 2, 2),
                          channels=(256, 512, 1024, 2048), attn="se",
                          attn_rr=0.25, attn_div=1),
    "nf_seresnet50": dict(_RESNET, depths=(3, 4, 6, 3),
                          channels=(256, 512, 1024, 2048), attn="se",
                          attn_rr=0.25, attn_div=1),
    "nf_seresnet101": dict(_RESNET, depths=(3, 4, 23, 3),
                           channels=(256, 512, 1024, 2048), attn="se",
                           attn_rr=0.25, attn_div=1),
    "nf_ecaresnet26": dict(_RESNET, depths=(2, 2, 2, 2),
                           channels=(256, 512, 1024, 2048), attn="eca"),
    "nf_ecaresnet50": dict(_RESNET, depths=(3, 4, 6, 3),
                           channels=(256, 512, 1024, 2048), attn="eca"),
    "nf_ecaresnet101": dict(_RESNET, depths=(3, 4, 23, 3),
                            channels=(256, 512, 1024, 2048), attn="eca"),
}
_CH_DIV = 8
_ATTN_GAIN = 2.0


def nfnet_plan(variant: str):
    """(stem channels, stages of block dicts, feature channels)."""
    cfg = NFNETS[variant]
    stem_chs = make_divisible((cfg["stem_chs"] or cfg["channels"][0])
                              * cfg["width"], _CH_DIV)
    alpha = cfg["alpha"]
    stem_stride = 4 if "pool" in cfg["stem"] else 2
    prev = stem_chs
    expected_var = 1.0
    stages = []
    for si, depth in enumerate(cfg["depths"]):
        stride = 1 if si == 0 and stem_stride > 2 else 2
        blocks = []
        for bi in range(depth):
            first_block = bi == 0 and si == 0
            out = make_divisible(cfg["channels"][si] * cfg["width"],
                                 _CH_DIV)
            bottle = 1.0 if cfg["efficient"] and first_block \
                else cfg["bottle"]
            mid = make_divisible((prev if cfg["efficient"] else out)
                                 * bottle, _CH_DIV)
            gs = cfg["group_size"]
            groups = 1 if gs is None else mid // gs
            if gs and gs % _CH_DIV == 0:
                mid = gs * groups
            if cfg["attn"] == "se":
                attn_red = make_divisible(mid * cfg["attn_rr"],
                                          cfg["attn_div"], 8)
            elif cfg["attn"] == "eca":
                attn_red = eca_kernel_size(mid)
            else:
                attn_red = 0
            blocks.append(dict(
                in_chs=prev, out=out, mid=mid, groups=groups,
                stride=stride if bi == 0 else 1,
                beta=1.0 / expected_var ** 0.5, attn_red=attn_red))
            if bi == 0:
                expected_var = 1.0
            expected_var += alpha ** 2
            prev = out
        stages.append(blocks)
    if cfg["efficient"] and cfg["num_features"]:
        feats = make_divisible(cfg["width"] * cfg["num_features"], _CH_DIV)
    else:
        feats = prev
    return stem_chs, stages, feats


def nfnet_feature_channels(variant: str) -> int:
    return nfnet_plan(variant)[2]


class ScaledStdConv(nn.Conv2d):
    """ScaledStdConv2d's parameters: weight, bias and a per-output-channel
    gain (out, 1, 1, 1), initialised to ones."""

    def __init__(self, cin: int, cout: int, k: int, device=None,
                 groups: int = 1):
        super().__init__(cin, cout, k, groups=groups, device=device)
        self.gain = nn.Parameter(torch.ones(cout, 1, 1, 1, device=device))


def _std_conv(x: torch.Tensor, m: ScaledStdConv, stride: int = 1,
              gamma: float = 1.0) -> torch.Tensor:
    """The standardised kernel (f32) times gamma * fan_in^-0.5 * gain,
    symmetric k // 2 padding, plus the bias."""
    w = m.weight.float()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    std = w.std(dim=(1, 2, 3), unbiased=False, keepdim=True)
    w = (gamma * math.prod(w.shape[1:]) ** -0.5) * (w - mean) / (std + 1e-5) \
        * m.gain
    return F.conv2d(x, w.to(x.dtype), m.bias.to(x.dtype), stride,
                    w.shape[-1] // 2, 1, m.groups)


def _avg2_excl_ceil(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False)."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)


class NfNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> the post-final-act map; `head.fc` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages stages (a
    reduced-depth check; the regnets' final conv then reads their last
    width)."""
    head_name = "head.fc"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        cfg = self.cfg = NFNETS[variant]
        stem, stages, feats = nfnet_plan(variant)
        self.plan = stages[:n_stages or None]
        self.stem = _Group(conv=ScaledStdConv(
            3, stem, 7 if "7x7" in cfg["stem"] else 3, device))
        self.stages = nn.ModuleList()
        for blocks in self.plan:
            mods = []
            for b in blocks:
                cin, mid, out = b["in_chs"], b["mid"], b["out"]
                m = _Group(conv1=ScaledStdConv(cin, mid, 1, device),
                           conv2=ScaledStdConv(mid, mid, 3, device,
                                               b["groups"]),
                           conv3=ScaledStdConv(mid, out, 1, device))
                if cfg["attn"] == "se":
                    red = b["attn_red"]
                    m.attn = _Group(fc1=nn.Conv2d(mid, red, 1, device=device),
                                    fc2=nn.Conv2d(red, mid, 1, device=device))
                elif cfg["attn"] == "eca":
                    m.attn = _Group(conv=nn.Conv1d(1, 1, b["attn_red"],
                                                   bias=False, device=device))
                if cin != out or b["stride"] != 1:
                    m.downsample = _Group(conv=ScaledStdConv(cin, out, 1,
                                                             device))
                mods.append(m)
            self.stages.append(nn.ModuleList(mods))
        last = self.plan[-1][-1]["out"]
        if cfg["efficient"] and cfg["num_features"]:
            self.final_conv = ScaledStdConv(last, feats, 1, device)
        else:
            feats = last
        self.num_features = feats
        if num_classes:
            self.head = _Group(fc=nn.Linear(feats, num_classes,
                                            device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        gamma = _GAMMA[cfg["act"]]
        act = F.relu if cfg["act"] == "relu" else F.silu
        x = _std_conv(x, self.stem.conv, 2, gamma)
        if "pool" in cfg["stem"]:
            x = F.max_pool2d(x, 3, 2, 1)
        for blocks, mods in zip(self.plan, self.stages):
            for b, m in zip(blocks, mods):
                out_pre = act(x) * b["beta"]
                shortcut = x
                if hasattr(m, "downsample"):
                    d = _avg2_excl_ceil(out_pre) if b["stride"] > 1 \
                        else out_pre
                    shortcut = _std_conv(d, m.downsample.conv, 1, gamma)
                y = _std_conv(out_pre, m.conv1, 1, gamma)
                y = _std_conv(act(y), m.conv2, b["stride"], gamma)
                if cfg["attn"] == "se":
                    y = _ATTN_GAIN * _se_apply(y, m.attn)
                elif cfg["attn"] == "eca":
                    y = _ATTN_GAIN * _eca_apply(y, m.attn)
                y = _std_conv(act(y), m.conv3, 1, gamma)
                x = y * cfg["alpha"] + shortcut
        if hasattr(self, "final_conv"):
            x = _std_conv(x, self.final_conv, 1, gamma)
        return act(x)


def _sc_sd(p, prefix: str) -> dict:
    return {prefix + "weight": _oihw(p["w"]),
            prefix + "gain": _t(np.asarray(p["gain"]).reshape(-1, 1, 1, 1)),
            prefix + "bias": _t(p["b"])}


def nfnet_from_jax(p) -> dict:
    """The JAX package's init_nfnet tree -> NfNet names."""
    sd = _sc_sd(p["stem"]["conv"], "stem.conv.")
    for si, blocks in enumerate(p["stages"]):
        for bi, bp in enumerate(blocks):
            base = f"stages.{si}.{bi}."
            for name in ("conv1", "conv2", "conv3"):
                sd.update(_sc_sd(bp[name], f"{base}{name}."))
            attn = bp.get("attn", {})
            if "k" in attn:
                sd[base + "attn.conv.weight"] = _t(attn["k"]).view(1, 1, -1)
            for fc in ("fc1", "fc2") if "fc1_w" in attn else ():
                w = np.asarray(attn[fc + "_w"])
                sd[f"{base}attn.{fc}.weight"] = _t(w.T)[:, :, None, None]
                sd[f"{base}attn.{fc}.bias"] = _t(attn[fc + "_b"])
            if "down_conv" in bp:
                sd.update(_sc_sd(bp["down_conv"], base + "downsample.conv."))
    if "final_conv" in p:
        sd.update(_sc_sd(p["final_conv"], "final_conv."))
    return sd
