"""PNASNet-5-Large of the model zoo: the port of
vitcap_tpu/models/pnasnet.py (the ops shared with models/nasnet.py).

- conv_0 is a VALID 3x3/2 conv + BN (eps 1e-3), no act; every other conv
  and pool pads TF-'SAME', every BN has eps 1e-3.
- A cell (PNASNET_CELLS; cell_stem_0 first): x_left through a factorised
  reduction where the spatial sizes must match, else an ActConvBn;
  x_right through an ActConvBn; five combs: (0) a separable on x_left
  plus a max pool of it (cell_stem_0: max pool, 1x1 conv, BN), (1) and
  (2) ops on x_right, (3) a separable on comb 2's OUTPUT plus a max pool
  of x_right, (4) a separable on x_left plus x_right (an ActConvBn of it
  in a reduction cell); concatenated.  Each cell takes (prev-prev,
  prev).
- The feature map is relu'd; a linear `last_linear` of 1001 classes on
  the pooled map.

State-dict names: conv_0.{conv,bn}; cell_stem_0 / cell_{i}
.comb_iter_{k}_{left,right} (separables as in nasnet.py; a {conv, bn}
for cell_stem_0's comb 0 right and a reduction's comb 4 right),
.conv_prev_1x1 (.{conv,bn}, or .path_{1,2}.conv and .final_path_bn),
.conv_1x1.{conv,bn}; last_linear.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import PooledHead, _batch_norm, _conv, _cv
from .layers import _Group
from .nasnet import (_nbn, acb_from_jax, acb_p, act_conv_bn, branch_sep,
                     cell_from_jax, fact_reduce, max_pool_same, path_p,
                     sep_p)

# cell name -> (in_left, out_left, in_right, out_right, reduction, match)
PNASNET_CELLS: List[Tuple[str, int, int, int, int, bool, bool]] = [
    ("cell_stem_1", 96, 108, 270, 108, True, True),
    ("cell_0", 270, 216, 540, 216, False, True),
    ("cell_1", 540, 216, 1080, 216, False, False),
    ("cell_2", 1080, 216, 1080, 216, False, False),
    ("cell_3", 1080, 216, 1080, 216, False, False),
    ("cell_4", 1080, 432, 1080, 432, True, False),
    ("cell_5", 1080, 432, 2160, 432, False, True),
    ("cell_6", 2160, 432, 2160, 432, False, False),
    ("cell_7", 2160, 432, 2160, 432, False, False),
    ("cell_8", 2160, 864, 2160, 864, True, False),
    ("cell_9", 2160, 864, 4320, 864, False, True),
    ("cell_10", 4320, 864, 4320, 864, False, False),
    ("cell_11", 4320, 864, 4320, 864, False, False),
]
PNASNET_FEATURES = 4320


def pnasnet_feature_channels(variant: str) -> int:
    return PNASNET_FEATURES


def _cell_p(in_l: int, out_l: int, out_r: int, reduction: bool, device,
            stem: bool = False) -> Dict:
    if stem:
        # the stem cell's separables widen in their first conv
        combs = dict(comb_iter_0_left=sep_p(in_l, out_l, out_l, 5, device),
                     comb_iter_0_right=acb_p(in_l, out_l, device),
                     comb_iter_4_left=sep_p(in_l, out_r, out_r, 3, device))
    else:
        combs = dict(comb_iter_0_left=sep_p(out_l, out_l, out_l, 5, device),
                     comb_iter_4_left=sep_p(out_l, out_l, out_l, 3, device))
    combs.update(comb_iter_1_left=sep_p(out_r, out_r, out_r, 7, device),
                 comb_iter_2_left=sep_p(out_r, out_r, out_r, 5, device),
                 comb_iter_2_right=sep_p(out_r, out_r, out_r, 3, device),
                 comb_iter_3_left=sep_p(out_r, out_r, out_r, 3, device))
    if reduction:
        combs["comb_iter_4_right"] = acb_p(out_r, out_r, device)
    return combs


def _cell_forward(m, x_left, x_right, stride: int) -> torch.Tensor:
    c0 = branch_sep(x_left, m.comb_iter_0_left, stride)
    right = getattr(m, "comb_iter_0_right", None)
    if right is not None:
        # cell_stem_0: max pool, 1x1 conv, BN
        c0 = c0 + _batch_norm(_conv(max_pool_same(x_left, stride),
                                    right.conv.weight), right.bn, act=False)
    else:
        c0 = c0 + max_pool_same(x_left, stride)
    c1 = branch_sep(x_right, m.comb_iter_1_left, stride) \
        + max_pool_same(x_right, stride)
    c2 = branch_sep(x_right, m.comb_iter_2_left, stride) \
        + branch_sep(x_right, m.comb_iter_2_right, stride)
    c3 = branch_sep(c2, m.comb_iter_3_left, 1) \
        + max_pool_same(x_right, stride)
    c4 = branch_sep(x_left, m.comb_iter_4_left, stride)
    right = getattr(m, "comb_iter_4_right", None)
    c4 = c4 + (act_conv_bn(x_right, right, stride) if right is not None
               else x_right)
    return torch.cat([c0, c1, c2, c3, c4], dim=1)


def pnasnet_cells(n_stages: int = 0):
    """PNASNET_CELLS, with n_stages > 0 only the first n_stages cells of
    each run of plain cells (no reduction, no factorised input)."""
    out, run = [], 0
    for cell in PNASNET_CELLS:
        run = run + 1 if not (cell[5] or cell[6]) else 0
        if not n_stages or run <= n_stages:
            out.append(cell)
    return out


class PnasNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 4320, ~H / 32, ~W / 32), relu'd; a linear
    `last_linear` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages plain cells of each group (the names stay)."""
    head_name = "last_linear"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        self.cells = pnasnet_cells(n_stages)
        self.conv_0 = _Group(conv=_cv(3, 96, 3, device), bn=_nbn(96, device))
        self.cell_stem_0 = _Group(conv_1x1=acb_p(96, 54, device),
                                  **_cell_p(96, 54, 54, True, device, True))
        for name, in_l, out_l, in_r, out_r, red, match in self.cells:
            prev = (_Group(**path_p(in_l, out_l, device)) if match
                    else acb_p(in_l, out_l, device))
            setattr(self, name, _Group(conv_prev_1x1=prev,
                                       conv_1x1=acb_p(in_r, out_r, device),
                                       **_cell_p(in_l, out_l, out_r, red,
                                                 device)))
        self.num_features = PNASNET_FEATURES
        if num_classes:
            self.last_linear = nn.Linear(PNASNET_FEATURES, num_classes,
                                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _batch_norm(_conv(x, self.conv_0.conv.weight, 2), self.conv_0.bn,
                        act=False)
        s0 = self.cell_stem_0
        states = [x, _cell_forward(s0, x, act_conv_bn(x, s0.conv_1x1), 2)]
        for name, _, _, _, _, red, match in self.cells:
            m = getattr(self, name)
            x_left, x_right = states
            x_left = (fact_reduce(x_left, m.conv_prev_1x1) if match
                      else act_conv_bn(x_left, m.conv_prev_1x1))
            states = [states[1], _cell_forward(
                m, x_left, act_conv_bn(x_right, m.conv_1x1),
                2 if red else 1)]
        return F.relu(states[-1])


def pnasnet_from_jax(p) -> Dict[str, torch.Tensor]:
    """The JAX package's init_pnasnet tree -> PnasNet names."""
    sd = acb_from_jax(p["conv_0"], "conv_0")
    for name, cp in p.items():
        if name != "conv_0":
            sd.update(cell_from_jax(cp, name))
    return sd
