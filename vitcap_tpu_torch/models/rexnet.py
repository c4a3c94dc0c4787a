"""ReXNet V1 (rexnet_* and rexnetr_*) of the model zoo: the port of
vitcap_tpu/models/rexnet.py.

Channels ramp linearly from 16 toward 180 over 16 LinearBottlenecks
(layers 1, 2, 2, 3, 3, 5; strides 1, 2, 2, 2, 1, 2; expansion 1, then 6),
rounded by make_divisible (divisor 8 for the rexnetr names); SE from the
third stage on.  A block: an optional 1x1 expand (BN, swish), a 3x3
depthwise (BN, no act), SEWithNorm (fc1 -> BN -> relu -> fc2 -> sigmoid),
relu6, a 1x1 projection (BN), and the partial residual: only the first
in-channels take the shortcut.  The stem is 3x3/2 + BN + swish, the tail
a 1x1 ConvBnAct to make_divisible(1280 * width) with swish, the head a
linear layer on the pooled map.

State-dict names: stem.{conv, bn}, features.{i}.{conv_exp, conv_dw,
conv_pwl}.{conv, bn}, features.{i}.se.{fc1, bn, fc2}, features.{last}.
{conv, bn}, head.fc.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _conv, _cv, _norm_sd,
                        _oihw, _t)
from .efficientnet import _dw, make_divisible
from .layers import _Group

# name -> (width_mult, ch_div)
REXNETS = {
    "rexnet_100": (1.0, 1),
    "rexnet_130": (1.3, 1),
    "rexnet_150": (1.5, 1),
    "rexnet_200": (2.0, 1),
    "rexnetr_100": (1.0, 8),
    "rexnetr_130": (1.3, 8),
    "rexnetr_150": (1.5, 8),
    "rexnetr_200": (2.0, 8),
}
_LAYERS = (1, 2, 2, 3, 3, 5)


def rexnet_plan(variant: str):
    """(stem channels, [(out, exp, stride, se ratio)] a block, pen)."""
    wm, ch_div = REXNETS[variant]
    stem_base = 32 / wm if wm < 1.0 else 32
    stem_chs = make_divisible(round(stem_base * wm), ch_div)
    layers = [ceil(e * 1.0) for e in _LAYERS]
    strides = sum([[s] + [1] * (layers[i] - 1)
                   for i, s in enumerate((1, 2, 2, 2, 1, 2))], [])
    exp_ratios = [1] * layers[0] + [6] * sum(layers[1:])
    n = sum(layers)
    base = 16 / wm if wm < 1.0 else 16
    outs = []
    for _ in range(n):
        outs.append(make_divisible(round(base * wm), ch_div))
        base += 180 / n
    ses = [0.0] * (layers[0] + layers[1]) + [1 / 12.] * sum(layers[2:])
    pen = make_divisible(1280 * wm, ch_div)
    return stem_chs, list(zip(outs, exp_ratios, strides, ses)), pen


def rexnet_feature_channels(variant: str) -> int:
    return rexnet_plan(variant)[2]


def _cba(cin: int, cout: int, k: int, device, groups: int = 1) -> _Group:
    return _Group(conv=_cv(cin, cout, k, device, groups), bn=_bn(cout, device))


class ReXNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, pen, H / 32, W / 32); `head.fc` with
    num_classes > 0.  n_stages > 0 keeps the blocks of the first n_stages
    of the six stages (a reduced-depth check)."""
    head_name = "head.fc"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        wm, ch_div = REXNETS[variant]
        stem, plan, pen = rexnet_plan(variant)
        self.plan = plan[:sum(_LAYERS[:n_stages or None])]
        self.stem = _cba(3, stem, 3, device)
        feats, prev = [], stem
        for out, exp, _, se in self.plan:
            dw = prev if exp == 1 else make_divisible(round(prev * exp),
                                                      ch_div)
            m = _Group()
            if exp != 1:
                m.conv_exp = _cba(prev, dw, 1, device)
            m.conv_dw = _cba(dw, dw, 3, device, dw)
            if se > 0:
                red = make_divisible(int(dw * se), ch_div)
                m.se = _Group(fc1=_cv(dw, red, 1, device, bias=True),
                              bn=_bn(red, device),
                              fc2=_cv(red, dw, 1, device, bias=True))
            m.conv_pwl = _cba(dw, out, 1, device)
            feats.append(m)
            prev = out
        feats.append(_cba(prev, pen, 1, device))
        self.features = nn.ModuleList(feats)
        self.num_features = pen
        if num_classes:
            self.head = _Group(fc=nn.Linear(pen, num_classes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def cba(y, m, stride=1, groups=1, act=None):
            k = m.conv.weight.shape[-1]
            y = _batch_norm(_conv(y, m.conv.weight, stride, k // 2, groups),
                            m.bn, act=False)
            return act(y) if act else y

        x = cba(x, self.stem, 2, act=F.silu)
        for (out, _, stride, _), m in zip(self.plan, self.features):
            cin = x.shape[1]
            y = cba(x, m.conv_exp, act=F.silu) if hasattr(m, "conv_exp") \
                else x
            y = _batch_norm(_dw(y, m.conv_dw.conv.weight, stride, False),
                            m.conv_dw.bn, act=False)
            if hasattr(m, "se"):
                y = _se_norm(y, m.se)
            y = cba(F.relu6(y), m.conv_pwl)
            if stride == 1 and cin <= out:
                y = torch.cat([y[:, :cin] + x, y[:, cin:]], dim=1)
            x = y
        return cba(x, self.features[len(self.plan)], act=F.silu)


def _se_norm(x: torch.Tensor, se) -> torch.Tensor:
    """SEWithNorm: channel means, fc1, BN, relu, fc2, sigmoid gate."""
    dt = x.dtype
    s = F.linear(x.mean(dim=(2, 3)), se.fc1.weight.flatten(1).to(dt),
                 se.fc1.bias.to(dt))
    s = _batch_norm(s, se.bn)
    s = F.linear(s, se.fc2.weight.flatten(1).to(dt), se.fc2.bias.to(dt))
    return x * torch.sigmoid(s)[:, :, None, None]


def rexnet_from_jax(p) -> dict:
    """The JAX package's init_rexnet tree -> ReXNet names."""
    sd = {"stem.conv.weight": _oihw(p["stem"]["conv"]),
          **_norm_sd(p["stem"]["bn"], "stem.bn.")}
    for i, bp in enumerate(p["blocks"]):
        base = f"features.{i}."
        for name in ("exp", "dw", "pwl"):
            if "conv_" + name in bp:
                sd[f"{base}conv_{name}.conv.weight"] = _oihw(
                    bp["conv_" + name])
                sd.update(_norm_sd(bp["bn_" + name], f"{base}conv_{name}.bn."))
        if "se" in bp:
            se = bp["se"]
            for fc in ("fc1", "fc2"):
                w = np.asarray(se[fc + "_w"])
                sd[f"{base}se.{fc}.weight"] = _t(w.T)[:, :, None, None]
                sd[f"{base}se.{fc}.bias"] = _t(se[fc + "_b"])
            sd.update(_norm_sd(se["bn"], base + "se.bn."))
    last = f"features.{len(p['blocks'])}."
    sd[last + "conv.weight"] = _oihw(p["pen"]["conv"])
    sd.update(_norm_sd(p["pen"]["bn"], last + "bn."))
    return sd
