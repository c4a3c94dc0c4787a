"""NASNet-A-Large (6 @ 4032) of the model zoo: the port of
vitcap_tpu/models/nasnet.py.

- Every conv and pool pads TF-'SAME' (asymmetric: the extra pixel after),
  every BN has eps 1e-3; conv0 is a VALID 3x3/2 conv + BN, no act.
- BranchSeparables: relu, a depthwise conv (the stride) and a 1x1, BN,
  relu, a depthwise conv and a 1x1, BN; ActConvBn: relu, a 1x1 conv, BN.
- The factorised reduction: relu; one 1x1 conv on the even pixels, one on
  the map shifted by a pixel (the top row and left column cropped, a zero
  row and column padded after) at its even pixels; concatenated, BN.
- The avg pool has two meanings (timm's create_pool2d): stride 2 pads
  with zeros and divides by 9 everywhere; stride 1 divides by the count
  of valid elements.  A max pool pads with -inf.
- Cells (NASNET_CELLS): the two stem cells, then six normal cells
  (a first cell, which factor-reduces its previous-previous input, and
  five), a reduction cell, six, a reduction cell, six; each takes (prev,
  prev-prev), except the first cell after a reduction, whose
  previous-previous input skips the reduction's (cell_6 sees cell_4).
  The normal cells concatenate [x_left, comb 0-4] (6-way), the
  reduction cells combs 1-4.
- The feature map is relu'd; a linear `last_linear` of 1001 classes
  (the Cadene checkpoints' background class) on the pooled map.

State-dict names: conv0.{conv,bn}; cell_stem_0 / cell_stem_1 / cell_{i}
/ reduction_cell_{0,1}.comb_iter_{k}_{left,right}.{separable_1,
separable_2}.{depthwise_conv2d,pointwise_conv2d} and .bn_sep_{1,2},
.conv_1x1 / .conv_prev_1x1.{conv,bn}, .path_{1,2}.conv, .final_path_bn;
last_linear.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _cb_sd, _conv, _cv,
                        _max_pool_same, _norm_sd, _oihw, _same_pads)
from .efficientnet import _dw
from .layers import _Group

_BN_EPS = 1e-3
NASNET_FEATURES = 4032
_C = NASNET_FEATURES // 24                     # 168

# name -> (kind, in_left, out_left, in_right, out_right, prev_offset)
NASNET_CELLS: List[Tuple[str, str, int, int, int, int, int]] = [
    ("cell_0", "first", _C, _C // 2, 2 * _C, _C, 2),
    ("cell_1", "normal", 2 * _C, _C, 6 * _C, _C, 2),
    ("cell_2", "normal", 6 * _C, _C, 6 * _C, _C, 2),
    ("cell_3", "normal", 6 * _C, _C, 6 * _C, _C, 2),
    ("cell_4", "normal", 6 * _C, _C, 6 * _C, _C, 2),
    ("cell_5", "normal", 6 * _C, _C, 6 * _C, _C, 2),
    ("reduction_cell_0", "reduction", 6 * _C, 2 * _C, 6 * _C, 2 * _C, 2),
    ("cell_6", "first", 6 * _C, _C, 8 * _C, 2 * _C, 3),
    ("cell_7", "normal", 8 * _C, 2 * _C, 12 * _C, 2 * _C, 2),
    ("cell_8", "normal", 12 * _C, 2 * _C, 12 * _C, 2 * _C, 2),
    ("cell_9", "normal", 12 * _C, 2 * _C, 12 * _C, 2 * _C, 2),
    ("cell_10", "normal", 12 * _C, 2 * _C, 12 * _C, 2 * _C, 2),
    ("cell_11", "normal", 12 * _C, 2 * _C, 12 * _C, 2 * _C, 2),
    ("reduction_cell_1", "reduction", 12 * _C, 4 * _C, 12 * _C, 4 * _C, 2),
    ("cell_12", "first", 12 * _C, 2 * _C, 16 * _C, 4 * _C, 3),
    ("cell_13", "normal", 16 * _C, 4 * _C, 24 * _C, 4 * _C, 2),
    ("cell_14", "normal", 24 * _C, 4 * _C, 24 * _C, 4 * _C, 2),
    ("cell_15", "normal", 24 * _C, 4 * _C, 24 * _C, 4 * _C, 2),
    ("cell_16", "normal", 24 * _C, 4 * _C, 24 * _C, 4 * _C, 2),
    ("cell_17", "normal", 24 * _C, 4 * _C, 24 * _C, 4 * _C, 2),
]


def nasnet_feature_channels(variant: str) -> int:
    return NASNET_FEATURES


def _nbn(c: int, device) -> nn.BatchNorm2d:
    return _bn(c, device, eps=_BN_EPS)


# ---------------------------------------------------------------------------
# the ops of both NAS nets (pnasnet.py shares them)
# ---------------------------------------------------------------------------

def sep_p(cin: int, mid: int, cout: int, k: int, device) -> _Group:
    """BranchSeparables: two separable convs of kernel k, each with its
    BN."""
    def sep(c, o):
        return _Group(depthwise_conv2d=_cv(c, c, k, device, c),
                      pointwise_conv2d=_cv(c, o, 1, device))
    return _Group(separable_1=sep(cin, mid), bn_sep_1=_nbn(mid, device),
                  separable_2=sep(mid, cout), bn_sep_2=_nbn(cout, device))


def acb_p(cin: int, cout: int, device) -> _Group:
    return _Group(conv=_cv(cin, cout, 1, device), bn=_nbn(cout, device))


def path_p(cin: int, cout: int, device) -> Dict[str, nn.Module]:
    """The factorised reduction's members: path_1, path_2, final_path_bn."""
    return dict(path_1=_Group(conv=_cv(cin, cout // 2, 1, device)),
                path_2=_Group(conv=_cv(cin, cout // 2, 1, device)),
                final_path_bn=_nbn(cout, device))


def branch_sep(x: torch.Tensor, m, stride: int) -> torch.Tensor:
    for i, s in ((1, stride), (2, 1)):
        sp = getattr(m, f"separable_{i}")
        x = _dw(F.relu(x), sp.depthwise_conv2d.weight, s, True)
        x = _batch_norm(_conv(x, sp.pointwise_conv2d.weight),
                        getattr(m, f"bn_sep_{i}"), act=False)
    return x


def act_conv_bn(x: torch.Tensor, m, stride: int = 1) -> torch.Tensor:
    return _batch_norm(_conv(F.relu(x), m.conv.weight, stride, "same"), m.bn,
                       act=False)


def fact_reduce(x: torch.Tensor, m) -> torch.Tensor:
    """relu; a 1x1 conv on the even pixels and one on the even pixels of
    the map shifted by one (cropped at the top and left, zero-padded at
    the bottom and right); concatenated, BN."""
    x = F.relu(x)
    p1 = _conv(x[:, :, ::2, ::2], m.path_1.conv.weight)
    sh = F.pad(x[:, :, 1:, 1:], (0, 1, 0, 1))
    p2 = _conv(sh[:, :, ::2, ::2], m.path_2.conv.weight)
    return _batch_norm(torch.cat([p1, p2], dim=1), m.final_path_bn,
                       act=False)


def max_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    return _max_pool_same(x, 3, stride)


def avg_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Stride 2: zero 'SAME' padding, every window divided by 9; stride
    1: symmetric padding 1, each window divided by its valid count."""
    if stride == 1:
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    (t, b), (l, r) = (_same_pads(x.shape[2], 3, stride),
                      _same_pads(x.shape[3], 3, stride))
    return F.avg_pool2d(F.pad(x, (l, r, t, b)), 3, stride)


def sep_from_jax(q, base: str) -> Dict[str, torch.Tensor]:
    """A JAX BranchSeparables {dw1, pw1, bn1, dw2, pw2, bn2} -> its names."""
    sd = {}
    for i in (1, 2):
        sp = f"{base}.separable_{i}."
        sd[sp + "depthwise_conv2d.weight"] = _oihw(q[f"dw{i}"])
        sd[sp + "pointwise_conv2d.weight"] = _oihw(q[f"pw{i}"])
        sd.update(_norm_sd(q[f"bn{i}"], f"{base}.bn_sep_{i}."))
    return sd


def acb_from_jax(q, base: str) -> Dict[str, torch.Tensor]:
    return _cb_sd(q["conv"], q["bn"], base + ".conv.weight", base + ".bn.")


def path_from_jax(q, base: str) -> Dict[str, torch.Tensor]:
    return {base + ".path_1.conv.weight": _oihw(q["conv1"]),
            base + ".path_2.conv.weight": _oihw(q["conv2"]),
            **_norm_sd(q["bn"], base + ".final_path_bn.")}


_COMB = {"c0_left": "comb_iter_0_left", "c0_right": "comb_iter_0_right",
         "c1_left": "comb_iter_1_left", "c1_right": "comb_iter_1_right",
         "c2_left": "comb_iter_2_left", "c2_right": "comb_iter_2_right",
         "c3_left": "comb_iter_3_left", "c4_left": "comb_iter_4_left",
         "c4_right": "comb_iter_4_right"}


def cell_from_jax(cp, base: str) -> Dict[str, torch.Tensor]:
    """A JAX cell dict -> its names: separables, ActConvBns (conv_1x1,
    conv_prev_1x1, a {conv, bn} comb) and factorised reductions ('path'
    on the cell itself, or a {conv1, conv2, bn} conv_prev_1x1)."""
    sd = {}
    for key, q in cp.items():
        if key == "path":
            sd.update(path_from_jax(q, base))
        elif not q:
            continue                          # a plain pool: no weights
        elif "dw1" in q:
            sd.update(sep_from_jax(q, f"{base}.{_COMB[key]}"))
        elif "conv1" in q:
            sd.update(path_from_jax(q, f"{base}.{key}"))
        else:
            sd.update(acb_from_jax(q, f"{base}.{_COMB.get(key, key)}"))
    return sd


# ---------------------------------------------------------------------------
# NASNet-A-Large
# ---------------------------------------------------------------------------

def _red_p(nl: int, nr: int, device, stem_in: int = 0) -> Dict:
    """A reduction comb's separables; stem_in builds the stem cell's right
    branches (middle = out) from the raw input."""
    rin = stem_in or nr
    mid = nr if stem_in else rin
    return dict(comb_iter_0_left=sep_p(nl, nl, nl, 5, device),
                comb_iter_0_right=sep_p(rin, mid, nr, 7, device),
                comb_iter_1_right=sep_p(rin, mid, nr, 7, device),
                comb_iter_2_right=sep_p(rin, mid, nr, 5, device),
                comb_iter_4_left=sep_p(nl, nl, nl, 3, device))


def _norm_p(out_l: int, out_r: int, device) -> Dict:
    return dict(comb_iter_0_left=sep_p(out_r, out_r, out_r, 5, device),
                comb_iter_0_right=sep_p(out_l, out_l, out_l, 3, device),
                comb_iter_1_left=sep_p(out_l, out_l, out_l, 5, device),
                comb_iter_1_right=sep_p(out_l, out_l, out_l, 3, device),
                comb_iter_4_left=sep_p(out_r, out_r, out_r, 3, device))


def _reduction_combs(m, x_left, x_right):
    """The stem / reduction comb topology (left ops on x_left)."""
    c0 = branch_sep(x_left, m.comb_iter_0_left, 2) \
        + branch_sep(x_right, m.comb_iter_0_right, 2)
    c1 = max_pool_same(x_left, 2) + branch_sep(x_right, m.comb_iter_1_right,
                                               2)
    c2 = avg_pool_same(x_left, 2) + branch_sep(x_right, m.comb_iter_2_right,
                                               2)
    c3 = avg_pool_same(c0, 1) + c1
    c4 = branch_sep(c0, m.comb_iter_4_left, 1) + max_pool_same(x_left, 2)
    return torch.cat([c1, c2, c3, c4], dim=1)


def _normal_combs(m, x_left, x_right):
    """The first / normal cells' topology: [x_left, comb 0-4]."""
    c0 = branch_sep(x_right, m.comb_iter_0_left, 1) \
        + branch_sep(x_left, m.comb_iter_0_right, 1)
    c1 = branch_sep(x_left, m.comb_iter_1_left, 1) \
        + branch_sep(x_left, m.comb_iter_1_right, 1)
    c2 = avg_pool_same(x_right, 1) + x_left
    a = avg_pool_same(x_left, 1)
    c4 = branch_sep(x_right, m.comb_iter_4_left, 1) + x_right
    return torch.cat([x_left, c0, c1, c2, a + a, c4], dim=1)


def nasnet_cells(n_stages: int = 0):
    """NASNET_CELLS, with n_stages > 0 only the first n_stages normal cells
    after each first cell."""
    out, run = [], 0
    for cell in NASNET_CELLS:
        run = run + 1 if cell[1] == "normal" else 0
        if not n_stages or run <= n_stages:
            out.append(cell)
    return out


class NasNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 4032, ~H / 32, ~W / 32), relu'd; a linear
    `last_linear` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages normal cells of each group (the names stay)."""
    head_name = "last_linear"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        self.cells = nasnet_cells(n_stages)
        self.conv0 = _Group(conv=_cv(3, 96, 3, device), bn=_nbn(96, device))
        c = _C // 4                                # 42
        self.cell_stem_0 = _Group(conv_1x1=acb_p(96, c, device),
                                  **_red_p(c, c, device, stem_in=96))
        self.cell_stem_1 = _Group(conv_1x1=acb_p(4 * c, 2 * c, device),
                                  **path_p(96, 2 * c, device),
                                  **_red_p(2 * c, 2 * c, device))
        for name, kind, in_l, out_l, in_r, out_r, _ in self.cells:
            if kind == "first":
                cell = _Group(conv_1x1=acb_p(in_r, out_r, device),
                              **path_p(in_l, 2 * out_l, device),
                              **_norm_p(2 * out_l, out_r, device))
            else:
                combs = (_norm_p(out_l, out_r, device) if kind == "normal"
                         else _red_p(out_r, out_l, device))
                cell = _Group(conv_prev_1x1=acb_p(in_l, out_l, device),
                              conv_1x1=acb_p(in_r, out_r, device), **combs)
            setattr(self, name, cell)
        self.num_features = NASNET_FEATURES
        if num_classes:
            self.last_linear = nn.Linear(NASNET_FEATURES, num_classes,
                                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_conv0 = _batch_norm(_conv(x, self.conv0.conv.weight, 2),
                              self.conv0.bn, act=False)
        s0, s1 = self.cell_stem_0, self.cell_stem_1
        x_stem_0 = _reduction_combs(s0, act_conv_bn(x_conv0, s0.conv_1x1),
                                    x_conv0)
        x_stem_1 = _reduction_combs(s1, act_conv_bn(x_stem_0, s1.conv_1x1),
                                    fact_reduce(x_conv0, s1))
        states = [x_stem_0, x_stem_1]
        for name, kind, _, _, _, _, poff in self.cells:
            m = getattr(self, name)
            x, x_prev = states[-1], states[-poff]
            if kind == "first":
                out = _normal_combs(m, fact_reduce(x_prev, m),
                                    act_conv_bn(x, m.conv_1x1))
            else:
                x_left = act_conv_bn(x_prev, m.conv_prev_1x1)
                x_right = act_conv_bn(x, m.conv_1x1)
                # a reduction cell runs its left ops on x_right
                out = (_normal_combs(m, x_left, x_right) if kind == "normal"
                       else _reduction_combs(m, x_right, x_left))
            states = (states + [out])[-3:]
        return F.relu(states[-1])


def nasnet_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_nasnet tree -> NasNet names."""
    sd = acb_from_jax(p["conv0"], "conv0")
    for name, cp in p.items():
        if name != "conv0":
            sd.update(cell_from_jax(cp, name))
    return sd
