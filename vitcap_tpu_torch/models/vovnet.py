"""VoVNet (v1 and v2) of the model zoo: the port of
vitcap_tpu/models/vovnet.py.

- Stem: three 3x3 ConvBnAct (strides 2, 1, 2); the depthwise nets use
  SeparableConvBnAct (a depthwise 3x3, a 1x1, one norm + act) for stem
  convs 2 and 3.
- OSA block: a chain of layer_per_block 3x3 convs (separable on the dw
  nets, after a 1x1 conv_reduction where the input width differs), the
  concat of [input, every chain output], a 1x1 conv_concat, attention on
  the last block of a stage (ese: a 1x1 C -> C conv with bias and a
  hard-sigmoid gate; eca: the adaptive-kernel conv1d over the channel
  means and a sigmoid gate), the residual add on blocks past a stage's
  first (v2).
- Stages 2-4 start with MaxPool2d(3, 2, ceil_mode=True); a linear head.fc
  on the pooled map.
- Norms: BN + relu; ese_vovnet99b_iabn's InplaceABN, BN + leaky relu
  0.01; ese_vovnet39b_evos's EvoNorm-S0 (8 groups of torch's channel
  order, no running statistics: train and eval compute alike).

State-dict names: stem.{0,1,2}.{conv,conv_dw,conv_pw,bn},
stages.{i}.blocks.{j}.{conv_reduction,conv_mid.{k},conv_concat}.{...},
.attn.fc / .attn.conv, head.fc (EvoNorm: bn.{weight,bias,v}, each
(1, C, 1, 1)).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _conv, _cv,
                        _maxpool_ceil, _norm_sd, _oihw, _t, eca_kernel_size)
from .layers import _Group
from .mobilenetv3 import hard_sigmoid

_V2 = dict(stem=(64, 64, 128), conv=(128, 160, 192, 224),
           out=(256, 512, 768, 1024), residual=True, dw=False, attn="ese")
_V2_SLIM = dict(conv=(64, 80, 96, 112), out=(112, 256, 384, 512))
VOVNETS = {
    "vovnet39a": dict(_V2, lpb=5, bps=(1, 1, 2, 2), residual=False,
                      attn=""),
    "vovnet57a": dict(_V2, lpb=5, bps=(1, 1, 4, 3), residual=False,
                      attn=""),
    "ese_vovnet19b_slim_dw": dict(_V2, **_V2_SLIM, stem=(64, 64, 64),
                                  lpb=3, bps=(1, 1, 1, 1), dw=True),
    "ese_vovnet19b_dw": dict(_V2, stem=(64, 64, 64), lpb=3,
                             bps=(1, 1, 1, 1), dw=True),
    "ese_vovnet19b_slim": dict(_V2, **_V2_SLIM, lpb=3, bps=(1, 1, 1, 1)),
    "ese_vovnet19b": dict(_V2, lpb=3, bps=(1, 1, 1, 1)),
    "ese_vovnet39b": dict(_V2, lpb=5, bps=(1, 1, 2, 2)),
    "ese_vovnet57b": dict(_V2, lpb=5, bps=(1, 1, 4, 3)),
    "ese_vovnet99b": dict(_V2, lpb=5, bps=(1, 3, 9, 3)),
    "eca_vovnet39b": dict(_V2, lpb=5, bps=(1, 1, 2, 2), attn="eca"),
}
VOVNETS["ese_vovnet99b_iabn"] = dict(VOVNETS["ese_vovnet99b"], act="leaky")
VOVNETS["ese_vovnet39b_evos"] = dict(VOVNETS["ese_vovnet39b"], norm="evos")

_EVO_GROUPS = 8


def vovnet_feature_channels(variant: str) -> int:
    return VOVNETS[variant]["out"][-1]


class EvoNormS0(nn.Module):
    """EvoNorm-S0's parameters: weight, bias and v, each (1, C, 1, 1)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        for name in ("weight", "bias", "v"):
            setattr(self, name, nn.Parameter(torch.empty(1, c, 1, 1,
                                                         device=device)))


def _evo_norm_s(x: torch.Tensor, m: EvoNormS0, eps: float = 1e-5
                ) -> torch.Tensor:
    """x * sigmoid(v * x) over the per-sample, per-group standard
    deviation (the biased variance over (C / 8, H, W), in f32), then the
    affine."""
    dt = x.dtype
    n = x * torch.sigmoid(x * m.v.to(dt))
    xg = x.unflatten(1, (_EVO_GROUPS, -1)).float()
    d = torch.sqrt(xg.var(dim=(2, 3, 4), unbiased=False, keepdim=True) + eps)
    n = (n.unflatten(1, (_EVO_GROUPS, -1)) / d).flatten(1, 2).to(dt)
    return n * m.weight.to(dt) + m.bias.to(dt)


def _norm_act(x: torch.Tensor, m, leaky: bool) -> torch.Tensor:
    if isinstance(m, EvoNormS0):
        return _evo_norm_s(x, m)
    if leaky:
        return F.leaky_relu(_batch_norm(x, m, act=False), 0.01)
    return _batch_norm(x, m)


class VovNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, out[-1], H / 32, W / 32); `head.fc` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages stages."""
    head_name = "head.fc"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        cfg = self.cfg = VOVNETS[variant]
        stem, conv, out, lpb = cfg["stem"], cfg["conv"], cfg["out"], \
            cfg["lpb"]
        dw = cfg["dw"]
        self.leaky = cfg.get("act") == "leaky"

        def norm(c):
            return (EvoNormS0(c, device) if cfg.get("norm") == "evos"
                    else _bn(c, device))

        def cba(cin, cout, k=3):
            return _Group(conv=_cv(cin, cout, k, device), bn=norm(cout))

        def sep(cin, cout):
            return _Group(conv_dw=_cv(cin, cin, 3, device, cin),
                          conv_pw=_cv(cin, cout, 1, device), bn=norm(cout))

        mid_conv = sep if dw else cba
        self.stem = nn.ModuleList([cba(3, stem[0]),
                                   mid_conv(stem[0], stem[1]),
                                   mid_conv(stem[1], stem[2])])
        in_c = stem[2]
        stages = []
        for si in range(len(conv[:n_stages or None])):
            mid, oc = conv[si], out[si]
            blocks = []
            for bi in range(cfg["bps"][si]):
                bp = _Group()
                nxt = in_c
                if dw and nxt != mid:
                    bp.conv_reduction = cba(nxt, mid, 1)
                    nxt = mid
                bp.conv_mid = nn.ModuleList(
                    mid_conv(nxt if i == 0 else mid, mid) for i in range(lpb))
                bp.conv_concat = cba(in_c + lpb * mid, oc, 1)
                if cfg["attn"] == "ese" and bi == cfg["bps"][si] - 1:
                    bp.attn = _Group(fc=_cv(oc, oc, 1, device, bias=True))
                elif cfg["attn"] == "eca" and bi == cfg["bps"][si] - 1:
                    k = eca_kernel_size(oc)
                    bp.attn = _Group(conv=nn.Conv1d(1, 1, k, bias=False,
                                                    device=device))
                    bp.attn.conv.init_std = math.sqrt(2.0 / k)
                blocks.append(bp)
                in_c = oc
            stages.append(_Group(blocks=nn.ModuleList(blocks)))
        self.stages = nn.ModuleList(stages)
        self.num_features = in_c
        if num_classes:
            self.head = _Group(fc=nn.Linear(in_c, num_classes,
                                            device=device))

    def _conv(self, x: torch.Tensor, m, stride: int = 1) -> torch.Tensor:
        """ConvBnAct or SeparableConvBnAct (padding k // 2)."""
        if hasattr(m, "conv_dw"):
            y = _conv(x, m.conv_dw.weight, stride, 1, x.shape[1])
            y = _conv(y, m.conv_pw.weight)
        else:
            w = m.conv.weight
            y = _conv(x, w, stride, w.shape[-1] // 2)
        return _norm_act(y, m.bn, self.leaky)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        for m, s in zip(self.stem, (2, 1, 2)):
            x = self._conv(x, m, s)
        for si, stage in enumerate(self.stages):
            if si > 0:
                x = _maxpool_ceil(x)
            for bi, bp in enumerate(stage.blocks):
                inp = x
                if hasattr(bp, "conv_reduction"):
                    x = self._conv(x, bp.conv_reduction)
                outs = [inp]
                for m in bp.conv_mid:
                    x = self._conv(x, m)
                    outs.append(x)
                x = self._conv(torch.cat(outs, dim=1), bp.conv_concat)
                if hasattr(bp, "attn"):
                    s = x.mean(dim=(2, 3))
                    if hasattr(bp.attn, "fc"):
                        fc = bp.attn.fc
                        g = hard_sigmoid(F.linear(
                            s, fc.weight.flatten(1).to(s.dtype),
                            fc.bias.to(s.dtype)))
                    else:
                        w = bp.attn.conv.weight
                        g = torch.sigmoid(F.conv1d(
                            s[:, None], w.to(s.dtype), None, 1,
                            (w.shape[-1] - 1) // 2)[:, 0])
                    x = x * g[:, :, None, None]
                if cfg["residual"] and bi > 0:
                    x = x + inp
        return x


def vovnet_from_jax(p) -> dict:
    """The JAX package's init_vovnet tree -> VovNet names."""
    def norm(q, prefix):
        if "v" in q:
            return {prefix + k: _t(q[j]).view(1, -1, 1, 1)
                    for k, j in (("weight", "scale"), ("bias", "bias"),
                                 ("v", "v"))}
        return _norm_sd(q, prefix)

    def conv(q, base):
        sd = norm(q["bn"], base + ".bn.")
        for k in ("conv", "conv_dw", "conv_pw"):
            if k in q:
                sd[f"{base}.{k}.weight"] = _oihw(q[k])
        return sd

    sd = {}
    for i, q in enumerate(p["stem"]):
        sd.update(conv(q, f"stem.{i}"))
    for si, blocks in enumerate(p["stages"]):
        for bi, bp in enumerate(blocks):
            base = f"stages.{si}.blocks.{bi}."
            if "conv_reduction" in bp:
                sd.update(conv(bp["conv_reduction"], base + "conv_reduction"))
            for k, q in enumerate(bp["mid"]):
                sd.update(conv(q, f"{base}conv_mid.{k}"))
            sd.update(conv(bp["conv_concat"], base + "conv_concat"))
            a = bp.get("attn")
            if a is not None and "w" in a:
                sd[base + "attn.fc.weight"] = _t(np.asarray(a["w"]).T)[
                    :, :, None, None]
                sd[base + "attn.fc.bias"] = _t(a["b"])
            elif a is not None:
                sd[base + "attn.conv.weight"] = _t(a["k"]).view(1, 1, -1)
    return sd
