"""HRNet classifiers of the model zoo: the port of
vitcap_tpu/models/hrnet.py.

- Stem: two 3x3/2 convs, each BN + relu; layer1: bottlenecks (1x1, 3x3,
  1x1 to 4 * planes, a 1x1 conv + BN downsample where the width changes).
- Stages 2-4: modules of parallel branches of basic blocks, then the full
  fuse mesh: output i sums every branch j, branch j > i through a 1x1
  conv + BN and a nearest 2^(j - i) upsample (every pixel repeated, as
  jnp.repeat: an expand and a reshape, whose backward is an ordered sum),
  branch j < i through a chain of stride-2 3x3 convs + BN, a relu on
  every link but the last; each sum then a relu.
- Transitions between stages: a 3x3 conv + BN + relu on a branch whose
  width changes, and the new lowest branch from the previous stage's
  LAST branch through stride-2 3x3 convs + BN + relu.
- The classification head: a bottleneck incre module per branch, biased
  3x3/2 downsample convs + BN + relu summing toward the lowest
  resolution, a biased 1x1 conv + BN + relu to 2048; a linear
  `classifier` on the pooled map.

State-dict names: conv1, bn1, conv2, bn2, layer1.{i}.{conv,bn}{1,2,3}
(.downsample.{0,1}), transition{t}.{i}.{0,1} (.{j}.{0,1} for the new
branch), stage{s}.{m}.branches.{b}.{l}.{conv,bn}{1,2},
stage{s}.{m}.fuse_layers.{i}.{j}.{0,1} (.{k}.{0,1} for j < i),
incre_modules.{i}.0.*, downsamp_modules.{i}.{0,1}, final_layer.{0,1},
classifier.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _cb_sd, _conv, _cv,
                        _t)
from .layers import _Group

# name -> (s1_blocks, s1_chs, (modules s2, s3, s4), branch_blocks, widths)
HRNETS = {
    "hrnet_w18_small": (1, 32, (1, 1, 1), 2, (16, 32, 64, 128)),
    "hrnet_w18_small_v2": (2, 64, (1, 3, 2), 2, (18, 36, 72, 144)),
    "hrnet_w18": (4, 64, (1, 4, 3), 4, (18, 36, 72, 144)),
    "hrnet_w30": (4, 64, (1, 4, 3), 4, (30, 60, 120, 240)),
    "hrnet_w32": (4, 64, (1, 4, 3), 4, (32, 64, 128, 256)),
    "hrnet_w40": (4, 64, (1, 4, 3), 4, (40, 80, 160, 320)),
    "hrnet_w44": (4, 64, (1, 4, 3), 4, (44, 88, 176, 352)),
    "hrnet_w48": (4, 64, (1, 4, 3), 4, (48, 96, 192, 384)),
    "hrnet_w64": (4, 64, (1, 4, 3), 4, (64, 128, 256, 512)),
}
HRNET_FEATURES = 2048
_HEAD_CHS = (32, 64, 128, 256)


def hrnet_feature_channels(variant: str) -> int:
    return HRNET_FEATURES


def _seq(cin: int, cout: int, k: int, device, bias: bool = False) -> _Group:
    """A Sequential(conv, BN) under {0, 1}."""
    return _Group(**{"0": _cv(cin, cout, k, device, bias=bias),
                     "1": _bn(cout, device)})


def _block(cin: int, planes: int, device, bottleneck: bool) -> _Group:
    out = planes * 4 if bottleneck else planes
    if bottleneck:
        blk = _Group(conv1=_cv(cin, planes, 1, device), bn1=_bn(planes, device),
                     conv2=_cv(planes, planes, 3, device),
                     bn2=_bn(planes, device),
                     conv3=_cv(planes, out, 1, device), bn3=_bn(out, device))
    else:
        blk = _Group(conv1=_cv(cin, planes, 3, device), bn1=_bn(planes, device),
                     conv2=_cv(planes, planes, 3, device),
                     bn2=_bn(planes, device))
    if cin != out:
        blk.downsample = _seq(cin, out, 1, device)
    return blk


def _cbr(x: torch.Tensor, m, stride: int = 1, act: bool = True
         ) -> torch.Tensor:
    """A Sequential(conv [bias], BN) (padding k // 2), then relu."""
    cv = getattr(m, "0")
    w = cv.weight
    y = _conv(x, w, stride, w.shape[-1] // 2)
    if cv.bias is not None:
        y = y + cv.bias.to(y.dtype)[:, None, None]
    return _batch_norm(y, getattr(m, "1"), act)


def _block_apply(x: torch.Tensor, blk) -> torch.Tensor:
    residual = x
    if hasattr(blk, "downsample"):
        residual = _cbr(x, blk.downsample, act=False)
    if hasattr(blk, "conv3"):
        y = _batch_norm(_conv(x, blk.conv1.weight), blk.bn1)
        y = _batch_norm(_conv(y, blk.conv2.weight, 1, 1), blk.bn2)
        y = _batch_norm(_conv(y, blk.conv3.weight), blk.bn3, act=False)
    else:
        y = _batch_norm(_conv(x, blk.conv1.weight, 1, 1), blk.bn1)
        y = _batch_norm(_conv(y, blk.conv2.weight, 1, 1), blk.bn2, act=False)
    return F.relu(y + residual)


def _upsample_nearest(x: torch.Tensor, f: int) -> torch.Tensor:
    """Every pixel repeated f x f times (jnp.repeat on both axes)."""
    B, C, H, W = x.shape
    return x[:, :, :, None, :, None].expand(B, C, H, f, W, f).reshape(
        B, C, H * f, W * f)


class HrNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 2048, H / 32, W / 32) after the final layer; a
    linear `classifier` with num_classes > 0.  n_stages > 0 keeps the
    first n_stages modules of each stage."""
    head_name = "classifier"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        s1b, s1c, modules, bb, widths = HRNETS[variant]
        self.conv1, self.bn1 = _cv(3, 64, 3, device), _bn(64, device)
        self.conv2, self.bn2 = _cv(64, 64, 3, device), _bn(64, device)
        self.layer1 = nn.ModuleList(_block(64 if b == 0 else s1c * 4, s1c,
                                           device, True)
                                    for b in range(s1b))
        prev = [s1c * 4]
        for si, n_mod in enumerate(modules):
            nb = si + 2
            cur = list(widths[:nb])
            trans = {}
            for i in range(nb):
                if i < len(prev):
                    if prev[i] != cur[i]:
                        trans[str(i)] = _seq(prev[i], cur[i], 3, device)
                else:
                    trans[str(i)] = _Group(**{"0": _seq(prev[-1], cur[i], 3,
                                                        device)})
            setattr(self, f"transition{si + 1}", _Group(**trans))
            mods = []
            for _ in range(min(n_mod, n_stages or n_mod)):
                branches = nn.ModuleList(
                    nn.ModuleList(_block(c, c, device, False)
                                  for _ in range(bb)) for c in cur)
                fuse = nn.ModuleList()
                for i in range(nb):
                    row = {}
                    for j in range(nb):
                        if j > i:
                            row[str(j)] = _seq(cur[j], cur[i], 1, device)
                        elif j < i:
                            row[str(j)] = _Group(**{
                                str(k): _seq(cur[j], cur[i] if k == i - j - 1
                                             else cur[j], 3, device)
                                for k in range(i - j)})
                    fuse.append(_Group(**row))
                mods.append(_Group(branches=branches, fuse_layers=fuse))
            setattr(self, f"stage{si + 2}", nn.ModuleList(mods))
            prev = cur
        self.incre_modules = nn.ModuleList(
            nn.ModuleList([_block(prev[i], _HEAD_CHS[i], device, True)])
            for i in range(4))
        self.downsamp_modules = nn.ModuleList(
            _seq(_HEAD_CHS[i] * 4, _HEAD_CHS[i + 1] * 4, 3, device, True)
            for i in range(3))
        self.final_layer = _seq(_HEAD_CHS[3] * 4, HRNET_FEATURES, 1, device,
                                True)
        self.num_features = HRNET_FEATURES
        if num_classes:
            self.classifier = nn.Linear(HRNET_FEATURES, num_classes,
                                        device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _batch_norm(_conv(x, self.conv1.weight, 2, 1), self.bn1)
        x = _batch_norm(_conv(x, self.conv2.weight, 2, 1), self.bn2)
        for blk in self.layer1:
            x = _block_apply(x, blk)
        ys = [x]
        for si in range(3):
            trans = getattr(self, f"transition{si + 1}")
            xs = []
            for i in range(si + 2):
                t = getattr(trans, str(i), None)
                if t is None:
                    xs.append(ys[i])
                elif i < len(ys):
                    xs.append(_cbr(ys[i], t))
                else:
                    y = ys[-1]
                    for link in t.children():
                        y = _cbr(y, link, 2)
                    xs.append(y)
            for mod in getattr(self, f"stage{si + 2}"):
                xs = _module_apply(mod, xs)
            ys = xs
        y = None
        for i, yl in enumerate(ys):
            h = _block_apply(yl, self.incre_modules[i][0])
            y = h if i == 0 else h + _cbr(y, self.downsamp_modules[i - 1], 2)
        return _cbr(y, self.final_layer)


def _module_apply(mod, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A HighResolutionModule: the branches, then the fuse mesh."""
    xs = list(xs)
    for i, branch in enumerate(mod.branches):
        for blk in branch:
            xs[i] = _block_apply(xs[i], blk)
    outs = []
    for i, row in enumerate(mod.fuse_layers):
        y = None
        for j, xj in enumerate(xs):
            if j == i:
                p = xj
            elif j > i:
                p = _upsample_nearest(_cbr(xj, getattr(row, str(j)),
                                           act=False), 2 ** (j - i))
            else:
                p = xj
                for k, link in enumerate(getattr(row, str(j)).children()):
                    p = _cbr(p, link, 2, act=k != i - j - 1)
            y = p if y is None else y + p
        outs.append(F.relu(y))
    return outs


def hrnet_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_hrnet tree -> HrNet names."""
    def cbr(q, cbase, bbase):
        sd = _cb_sd(q["conv"], q["bn"], cbase + ".weight", bbase + ".")
        if "cb" in q:
            sd[cbase + ".bias"] = _t(q["cb"])
        return sd

    def seq(q, base):
        return cbr(q, base + ".0", base + ".1")

    def block(q, base):
        sd = {}
        for i in (1, 2, 3):
            if f"conv{i}" in q:
                sd.update(_cb_sd(q[f"conv{i}"], q[f"bn{i}"],
                                 f"{base}.conv{i}.weight", f"{base}.bn{i}."))
        if "down" in q:
            sd.update(seq(q["down"], base + ".downsample"))
        return sd

    sd = {**cbr(p["stem1"], "conv1", "bn1"), **cbr(p["stem2"], "conv2", "bn2")}
    for i, q in enumerate(p["layer1"]):
        sd.update(block(q, f"layer1.{i}"))
    for ti in (1, 2, 3):
        for i, t in enumerate(p[f"transition{ti}"]):
            base = f"transition{ti}.{i}"
            if isinstance(t, dict):
                sd.update(seq(t, base))
            elif t is not None:
                for j, c in enumerate(t):
                    sd.update(seq(c, f"{base}.{j}"))
    for si in (2, 3, 4):
        for mi, mp in enumerate(p[f"stage{si}"]):
            base = f"stage{si}.{mi}"
            for bi, blks in enumerate(mp["branches"]):
                for li, q in enumerate(blks):
                    sd.update(block(q, f"{base}.branches.{bi}.{li}"))
            for i, row in enumerate(mp["fuse"]):
                for j, f in enumerate(row):
                    fb = f"{base}.fuse_layers.{i}.{j}"
                    if isinstance(f, dict):
                        sd.update(seq(f, fb))
                    elif f is not None:
                        for k, c in enumerate(f):
                            sd.update(seq(c, f"{fb}.{k}"))
    for i, q in enumerate(p["incre"]):
        sd.update(block(q, f"incre_modules.{i}.0"))
    for i, q in enumerate(p["downsamp"]):
        sd.update(seq(q, f"downsamp_modules.{i}"))
    sd.update(seq(p["final"], "final_layer"))
    return sd
