"""Dual Path Networks of the model zoo: the port of
vitcap_tpu/models/dpn.py.

- Every BN has eps 1e-3.  Pre-activation blocks: BnActConv2d is BN +
  relu, then the conv.
- DualPathBlock: on a stage's first block a 1x1 projection (stride 2 on
  'down' blocks) splits into a residual part (bw channels) and a dense
  part (2 * inc); then 1x1, grouped 3x3 (stride), 1x1 to bw + inc (the b
  nets: BN + relu, then two 1x1 convs c1 / c2); the residual add on the
  first bw channels, the dense concat of the rest.  A block's input is
  the concat [residual, dense].
- Stem: a 3x3 ('small' nets) or 7x7 conv, stride 2, BN + relu, a max
  pool 3/2 (padding 1); the last BN is followed by an ELU; the
  classifier is a 1x1 conv on the pooled map.

State-dict names: features.conv1_1.{conv,bn},
features.conv{s}_{i}.{c1x1_w_s1,c1x1_w_s2,c1x1_a,c3x3_b,c1x1_c}.{bn,conv}
(c1x1_c.bn, c1x1_c1, c1x1_c2 on the b nets), features.conv5_bn_ac.bn,
classifier.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _bn, _cb_sd, _conv, _cv,
                        _norm_sd, _oihw)
from .layers import _Group

_BN_EPS = 1e-3

# name -> (small, init_features, k_r, groups, b, k_sec, inc_sec)
DPNS = {
    "dpn68": (True, 10, 128, 32, False, (3, 4, 12, 3), (16, 32, 32, 64)),
    "dpn68b": (True, 10, 128, 32, True, (3, 4, 12, 3), (16, 32, 32, 64)),
    "dpn92": (False, 64, 96, 32, False, (3, 4, 20, 3), (16, 32, 24, 128)),
    "dpn98": (False, 96, 160, 40, False, (3, 6, 20, 3), (16, 32, 32, 128)),
    "dpn131": (False, 128, 160, 40, False, (4, 8, 28, 3),
               (16, 32, 32, 128)),
    "dpn107": (False, 128, 200, 50, False, (4, 8, 20, 3),
               (20, 64, 64, 128)),
}


def dpn_plan(variant: str, n_stages: int = 4
             ) -> Tuple[int, List[List[dict]], int, bool, int]:
    """(init_features, stages of block dicts, num_features, b, stem_k)."""
    small, init_f, k_r, groups, b, k_sec, inc_sec = DPNS[variant]
    bwf = 1 if small else 4
    stages = []
    in_chs = init_f
    for si in range(n_stages):
        bw = 64 * (2 ** si) * bwf
        inc = inc_sec[si]
        r = (k_r * bw) // (64 * bwf)
        blocks = []
        for i in range(k_sec[si]):
            btype = ("proj" if si == 0 else "down") if i == 0 else "normal"
            blocks.append(dict(type=btype, in_chs=in_chs, r=r, bw=bw,
                               inc=inc, groups=groups))
            in_chs = (bw + 3 * inc) if i == 0 else in_chs + inc
        stages.append(blocks)
    return init_f, stages, in_chs, b, (3 if small else 7)


def dpn_feature_channels(variant: str) -> int:
    return dpn_plan(variant)[2]


def _dbn(c: int, device) -> nn.BatchNorm2d:
    return _bn(c, device, eps=_BN_EPS)


def _bac_p(cin: int, cout: int, k: int, device, groups: int = 1) -> _Group:
    return _Group(bn=_dbn(cin, device), conv=_cv(cin, cout, k, device, groups))


def _bac(x: torch.Tensor, m, stride: int = 1) -> torch.Tensor:
    """BnActConv2d: BN + relu, then the conv (padding k // 2)."""
    w = m.conv.weight
    return _conv(_batch_norm(x, m.bn), w, stride, w.shape[-1] // 2,
                 m.conv.groups)


class Dpn(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, C, H / 32, W / 32) after conv5_bn_ac; a 1x1 conv
    `classifier` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages stages."""
    head_name = "classifier"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        init_f, stages, feats, b, stem_k = dpn_plan(variant, n_stages or 4)
        self.stages, self.b = stages, b
        f = _Group(conv1_1=_Group(conv=_cv(3, init_f, stem_k, device),
                                  bn=_dbn(init_f, device)))
        for si, blocks in enumerate(stages):
            for bi, blk in enumerate(blocks):
                cin, r, bw, inc, g = (blk["in_chs"], blk["r"], blk["bw"],
                                      blk["inc"], blk["groups"])
                m = _Group()
                if blk["type"] != "normal":
                    key = "c1x1_w_s2" if blk["type"] == "down" else \
                        "c1x1_w_s1"
                    setattr(m, key, _bac_p(cin, bw + 2 * inc, 1, device))
                m.c1x1_a = _bac_p(cin, r, 1, device)
                m.c3x3_b = _bac_p(r, r, 3, device, g)
                if b:
                    m.c1x1_c = _Group(bn=_dbn(r, device))
                    m.c1x1_c1 = _cv(r, bw, 1, device)
                    m.c1x1_c2 = _cv(r, inc, 1, device)
                else:
                    m.c1x1_c = _bac_p(r, bw + inc, 1, device)
                setattr(f, f"conv{si + 2}_{bi + 1}", m)
        f.conv5_bn_ac = _Group(bn=_dbn(feats, device))
        self.features = f
        self.num_features = feats
        if num_classes:
            self.classifier = _cv(feats, num_classes, 1, device, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        w = f.conv1_1.conv.weight
        x = _batch_norm(_conv(x, w, 2, w.shape[-1] // 2), f.conv1_1.bn)
        x = F.max_pool2d(x, 3, 2, 1)
        resid, dense = x, None
        for si, blocks in enumerate(self.stages):
            for bi, blk in enumerate(blocks):
                m = getattr(f, f"conv{si + 2}_{bi + 1}")
                bw = blk["bw"]
                x_in = resid if dense is None else torch.cat([resid, dense],
                                                             dim=1)
                stride = 2 if blk["type"] == "down" else 1
                if blk["type"] != "normal":
                    proj = m.c1x1_w_s2 if stride == 2 else m.c1x1_w_s1
                    x_s = _bac(x_in, proj, stride)
                    x_s1, x_s2 = x_s[:, :bw], x_s[:, bw:]
                else:
                    x_s1, x_s2 = resid, dense
                y = _bac(_bac(x_in, m.c1x1_a), m.c3x3_b, stride)
                if self.b:
                    y = _batch_norm(y, m.c1x1_c.bn)
                    o1, o2 = _conv(y, m.c1x1_c1.weight), _conv(
                        y, m.c1x1_c2.weight)
                else:
                    y = _bac(y, m.c1x1_c)
                    o1, o2 = y[:, :bw], y[:, bw:]
                resid = x_s1 + o1
                dense = torch.cat([x_s2, o2], dim=1)
        return F.elu(_batch_norm(torch.cat([resid, dense], dim=1),
                                 f.conv5_bn_ac.bn, act=False))


def dpn_from_jax(p) -> dict:
    """The JAX package's init_dpn tree -> Dpn names."""
    def bac(q, base):
        return _cb_sd(q["conv"], q["bn"], base + ".conv.weight", base + ".bn.")

    sd = bac(p["stem"], "features.conv1_1")
    for si, blocks in enumerate(p["stages"]):
        for bi, bp in enumerate(blocks):
            base = f"features.conv{si + 2}_{bi + 1}."
            if "c1x1_w" in bp:
                key = "c1x1_w_s1" if si == 0 else "c1x1_w_s2"
                sd.update(bac(bp["c1x1_w"], base + key))
            sd.update({**bac(bp["c1x1_a"], base + "c1x1_a"),
                       **bac(bp["c3x3_b"], base + "c3x3_b")})
            if "c1x1_c1" in bp:
                sd.update(_norm_sd(bp["c1x1_c"]["bn"], base + "c1x1_c.bn."))
                sd[base + "c1x1_c1.weight"] = _oihw(bp["c1x1_c1"])
                sd[base + "c1x1_c2.weight"] = _oihw(bp["c1x1_c2"])
            else:
                sd.update(bac(bp["c1x1_c"], base + "c1x1_c"))
    sd.update(_norm_sd(p["final_bn"], "features.conv5_bn_ac.bn."))
    return sd
