"""Deep Layer Aggregation of the model zoo: the port of
vitcap_tpu/models/dla.py.

- Blocks: basic (two 3x3s), bottleneck (1x1, grouped 3x3, 1x1; mid =
  floor(out * bw / 64) * card // 2) and bottle2neck (the res2 split at
  scale 4, the last chunk average-pooled on strided blocks); each adds
  an explicit residual, then relu.
- The tree: two children aggregated recursively; a leaf level ends in a
  root, a 1x1 conv + BN over [tree2, tree1, *children] (plus tree2 when
  root_residual), relu.  A strided level max-pools its input (kernel =
  stride, no padding) for the projected shortcut and, on a level_root
  tree, as one more child.  As in the JAX package, only a leaf holds the
  projection (timm's inner trees hold one they never use).
- Stem: a 7x7/1 conv and the conv levels 0 and 1 (level 1 stride 2);
  the classifier is a 1x1 conv on the pooled map.

State-dict names follow the recursive modules: base_layer.{0,1},
level{0,1}.{3 i, 3 i + 1}, level{k}.tree1.tree2..., .root.{conv,bn},
.project.{0,1}, fc.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _cb, _cb_sd, _conv,
                        _cv, _norm_sd, _oihw)
from .layers import _Group

# name -> (levels, channels, block, cardinality, base_width, residual_root)
DLAS = {
    "dla34": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), "basic",
              1, 64, False),
    "dla46_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256),
                "bottleneck", 1, 64, False),
    "dla46x_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256),
                 "bottleneck", 32, 4, False),
    "dla60x_c": ((1, 1, 1, 2, 3, 1), (16, 32, 64, 64, 128, 256),
                 "bottleneck", 32, 4, False),
    "dla60": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024),
              "bottleneck", 1, 64, False),
    "dla60x": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024),
               "bottleneck", 32, 4, False),
    "dla102": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024),
               "bottleneck", 1, 64, True),
    "dla102x": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024),
                "bottleneck", 32, 4, True),
    "dla102x2": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024),
                 "bottleneck", 64, 4, True),
    "dla169": ((1, 1, 2, 3, 5, 1), (16, 32, 128, 256, 512, 1024),
               "bottleneck", 1, 64, True),
    "dla60_res2net": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024),
                      "bottle2neck", 1, 28, False),
    "dla60_res2next": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024),
                       "bottle2neck", 8, 4, False),
}
_SCALE = 4                       # the bottle2neck's scale


def dla_feature_channels(variant: str) -> int:
    return DLAS[variant][1][-1]


def _block(block: str, cin: int, out: int, card: int, bw: int, device
           ) -> _Group:
    mid = int(math.floor(out * (bw / 64)) * card) // 2
    if block == "basic":
        return _Group(conv1=_cv(cin, out, 3, device), bn1=_bn(out, device),
                      conv2=_cv(out, out, 3, device), bn2=_bn(out, device))
    if block == "bottleneck":
        return _Group(conv1=_cv(cin, mid, 1, device), bn1=_bn(mid, device),
                      conv2=_cv(mid, mid, 3, device, card),
                      bn2=_bn(mid, device),
                      conv3=_cv(mid, out, 1, device), bn3=_bn(out, device))
    return _Group(conv1=_cv(cin, mid * _SCALE, 1, device),
                  bn1=_bn(mid * _SCALE, device),
                  convs=nn.ModuleList(_cv(mid, mid, 3, device, card)
                                      for _ in range(_SCALE - 1)),
                  bns=nn.ModuleList(_bn(mid, device)
                                    for _ in range(_SCALE - 1)),
                  conv3=_cv(mid * _SCALE, out, 1, device),
                  bn3=_bn(out, device))


def _tree(levels: int, block: str, cin: int, out: int, card: int, bw: int,
          level_root: bool, root_dim: int, device) -> _Group:
    root_dim = (root_dim or 2 * out) + (cin if level_root else 0)
    if levels > 1:
        return _Group(tree1=_tree(levels - 1, block, cin, out, card, bw,
                                  False, 0, device),
                      tree2=_tree(levels - 1, block, out, out, card, bw,
                                  False, root_dim + out, device))
    t = _Group(tree1=_block(block, cin, out, card, bw, device),
               tree2=_block(block, out, out, card, bw, device))
    if cin != out:
        t.project = _cb(cin, out, 1, device, names=("0", "1"))
    t.root = _cb(root_dim, out, 1, device)
    return t


def _block_apply(m, x: torch.Tensor, residual: torch.Tensor, stride: int,
                 block: str, card: int) -> torch.Tensor:
    if block == "basic":
        y = _batch_norm(_conv(x, m.conv1.weight, stride, 1), m.bn1)
        y = _batch_norm(_conv(y, m.conv2.weight, 1, 1), m.bn2, act=False)
    elif block == "bottleneck":
        y = _batch_norm(_conv(x, m.conv1.weight), m.bn1)
        y = _batch_norm(_conv(y, m.conv2.weight, stride, 1, card), m.bn2)
        y = _batch_norm(_conv(y, m.conv3.weight), m.bn3, act=False)
    else:
        y = _batch_norm(_conv(x, m.conv1.weight), m.bn1)
        spx = y.chunk(_SCALE, dim=1)
        is_first = stride > 1
        spo = []
        for i, (cv, bn) in enumerate(zip(m.convs, m.bns)):
            sp = spx[i] if (i == 0 or is_first) else sp + spx[i]
            sp = _batch_norm(_conv(sp, cv.weight, stride, 1, card), bn)
            spo.append(sp)
        spo.append(F.avg_pool2d(spx[-1], 3, stride, 1) if is_first
                   else spx[-1])
        y = _batch_norm(_conv(torch.cat(spo, dim=1), m.conv3.weight), m.bn3,
                        act=False)
    return F.relu(y + residual)


def _tree_apply(t, x: torch.Tensor, levels: int, stride: int,
                level_root: bool, cfg, children=None) -> torch.Tensor:
    block, card, root_residual = cfg
    children = [] if children is None else children
    bottom = F.max_pool2d(x, stride, stride) if stride > 1 else x
    if level_root:
        children.append(bottom)
    if levels > 1:
        x1 = _tree_apply(t.tree1, x, levels - 1, stride, False, cfg)
        children.append(x1)
        return _tree_apply(t.tree2, x1, levels - 1, 1, False, cfg, children)
    residual = bottom
    if hasattr(t, "project"):
        residual = _batch_norm(_conv(bottom, getattr(t.project, "0").weight),
                               getattr(t.project, "1"), act=False)
    x1 = _block_apply(t.tree1, x, residual, stride, block, card)
    x2 = _block_apply(t.tree2, x1, x1, 1, block, card)
    r = _batch_norm(_conv(torch.cat([x2, x1] + children, dim=1),
                          t.root.conv.weight), t.root.bn, act=False)
    return F.relu(r + x2 if root_residual else r)


class Dla(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, channels[-1], H / 32, W / 32); a 1x1 conv `fc`
    with num_classes > 0.  n_stages > 0 keeps the first n_stages tree
    levels (level2 onwards)."""

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        levels, ch, block, card, bw, rr = DLAS[variant]
        self.levels, self.cfg = levels, (block, card, rr)
        self.base_layer = _cb(3, ch[0], 7, device, names=("0", "1"))
        for li in (0, 1):
            lv = _Group()
            for ci in range(levels[li]):
                cin = ch[li] if ci else ch[max(li - 1, 0)]
                setattr(lv, str(3 * ci), _cv(cin, ch[li], 3, device))
                setattr(lv, str(3 * ci + 1), _bn(ch[li], device))
            setattr(self, f"level{li}", lv)
        self.n_trees = len(range(2, 6)[:n_stages or None])
        for li in range(2, 2 + self.n_trees):
            setattr(self, f"level{li}", _tree(
                levels[li], block, ch[li - 1], ch[li], card, bw, li > 2, 0,
                device))
        self.num_features = ch[1 + self.n_trees]
        if num_classes:
            self.fc = _cv(self.num_features, num_classes, 1, device,
                          bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _batch_norm(_conv(x, getattr(self.base_layer, "0").weight, 1, 3),
                        getattr(self.base_layer, "1"))
        for li in (0, 1):
            lv = getattr(self, f"level{li}")
            for ci in range(self.levels[li]):
                x = _batch_norm(_conv(x, getattr(lv, str(3 * ci)).weight,
                                      li + 1 if ci == 0 else 1, 1),
                                getattr(lv, str(3 * ci + 1)))
        for li in range(2, 2 + self.n_trees):
            x = _tree_apply(getattr(self, f"level{li}"), x, self.levels[li],
                            2, li > 2, self.cfg)
        return x


def _block_sd(q, base: str) -> dict:
    sd = {}
    for key, v in q.items():
        if key == "convs":
            sd.update({f"{base}.convs.{i}.weight": _oihw(w)
                       for i, w in enumerate(v)})
        elif key == "bns":
            for i, bn in enumerate(v):
                sd.update(_norm_sd(bn, f"{base}.bns.{i}."))
        elif key.startswith("conv"):
            sd[f"{base}.{key}.weight"] = _oihw(v)
        else:
            sd.update(_norm_sd(v, f"{base}.{key}."))
    return sd


def _tree_sd(t, base: str) -> dict:
    if "root" not in t:
        return {**_tree_sd(t["tree1"], base + ".tree1"),
                **_tree_sd(t["tree2"], base + ".tree2")}
    sd = {**_block_sd(t["tree1"], base + ".tree1"),
          **_block_sd(t["tree2"], base + ".tree2"),
          **_cb_sd(t["root"]["conv"], t["root"]["bn"],
                   base + ".root.conv.weight", base + ".root.bn.")}
    if "project" in t:
        sd.update(_cb_sd(t["project"]["conv"], t["project"]["bn"],
                         base + ".project.0.weight", base + ".project.1."))
    return sd


def dla_from_jax(p) -> dict:
    """The JAX package's init_dla tree -> Dla names."""
    sd = _cb_sd(p["base"]["conv"], p["base"]["bn"], "base_layer.0.weight",
                "base_layer.1.")
    for li in (0, 1):
        for ci, cp in enumerate(p[f"level{li}"]):
            sd.update(_cb_sd(cp["conv"], cp["bn"],
                             f"level{li}.{3 * ci}.weight",
                             f"level{li}.{3 * ci + 1}."))
    for li in range(2, 6):
        if f"level{li}" in p:
            sd.update(_tree_sd(p[f"level{li}"], f"level{li}"))
    return sd
