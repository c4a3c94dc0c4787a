"""CSPNet / DarkNet of the model zoo: the port of
vitcap_tpu/models/cspnet.py.

- LeakyReLU(0.01) after every conv + BN but the linear ones.
- CrossStage: an optional grouped 3x3 conv_down (stride), a 1x1 conv_exp
  (linear when cross_linear), the channels split in two, the blocks on
  the second half, a 1x1 conv_transition_b on their output, the concat
  with the first half, a 1x1 conv_transition.  down_growth: conv_down
  already widens to the stage's out.
- ResBottleneck: 1x1, grouped 3x3, 1x1 (no act), the residual add, act;
  DarkBlock: 1x1, 3x3, the residual add.  Both zero-initialise their
  last BN's scale.
- Stems: a 7x7/2 conv and a max pool 3/2 (padding 1), the deep three
  3x3 convs and that pool, or darknet's 3x3/1 with no pool; darknet53's
  stages (no cross) are conv_down and the blocks.
- The _iabn names are compute-identical aliases (InplaceABN is BN +
  leaky relu 0.01 in eval, the act these nets use); a linear head.fc on
  the pooled map.

State-dict names: stem.conv{i}.{conv,bn},
stages.{i}.{conv_down,conv_exp,conv_transition_b,conv_transition}.{conv,bn},
stages.{i}.blocks.{j}.conv{1,2,3}.{conv,bn}, head.fc.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import PooledHead, _batch_norm, _cb, _cb_sd, _conv
from .layers import _Group

# name -> dict(stem=(chs, k, stride, pool), out, depth, stride, exp,
#              bottle, block, groups, cross_linear, down_growth, dark,
#              cross)
CSPNETS = {
    "cspresnet50": dict(stem=((64,), 7, 2, True), out=(128, 256, 512, 1024),
                        depth=(3, 3, 5, 2), stride=(1, 2, 2, 2),
                        exp=(2.,) * 4, bottle=(0.5,) * 4, block=(1.,) * 4,
                        groups=(1,) * 4, cross_linear=True,
                        down_growth=False, dark=False, cross=True),
    "cspresnet50d": dict(stem=((32, 32, 64), 3, 2, True),
                         out=(128, 256, 512, 1024), depth=(3, 3, 5, 2),
                         stride=(1, 2, 2, 2), exp=(2.,) * 4,
                         bottle=(0.5,) * 4, block=(1.,) * 4,
                         groups=(1,) * 4, cross_linear=True,
                         down_growth=False, dark=False, cross=True),
    "cspresnet50w": dict(stem=((32, 32, 64), 3, 2, True),
                         out=(256, 512, 1024, 2048), depth=(3, 3, 5, 2),
                         stride=(1, 2, 2, 2), exp=(1.,) * 4,
                         bottle=(0.25,) * 4, block=(0.5,) * 4,
                         groups=(1,) * 4, cross_linear=True,
                         down_growth=False, dark=False, cross=True),
    "cspresnext50": dict(stem=((64,), 7, 2, True),
                         out=(256, 512, 1024, 2048), depth=(3, 3, 5, 2),
                         stride=(1, 2, 2, 2), exp=(1.,) * 4,
                         bottle=(1.,) * 4, block=(0.5,) * 4,
                         groups=(32,) * 4, cross_linear=True,
                         down_growth=False, dark=False, cross=True),
    "cspdarknet53": dict(stem=((32,), 3, 1, False),
                         out=(64, 128, 256, 512, 1024),
                         depth=(1, 2, 8, 8, 4), stride=(2,) * 5,
                         exp=(2., 1., 1., 1., 1.),
                         bottle=(0.5, 1., 1., 1., 1.),
                         block=(1., 0.5, 0.5, 0.5, 0.5), groups=(1,) * 5,
                         cross_linear=False, down_growth=True, dark=True,
                         cross=True),
    "darknet53": dict(stem=((32,), 3, 1, False),
                      out=(64, 128, 256, 512, 1024), depth=(1, 2, 8, 8, 4),
                      stride=(2,) * 5, exp=(1.,) * 5, bottle=(0.5,) * 5,
                      block=(1.,) * 5, groups=(1,) * 5, cross_linear=False,
                      down_growth=False, dark=True, cross=False),
}
CSPNETS["cspresnext50_iabn"] = CSPNETS["cspresnext50"]
CSPNETS["cspdarknet53_iabn"] = CSPNETS["cspdarknet53"]


def cspnet_feature_channels(variant: str) -> int:
    return CSPNETS[variant]["out"][-1]


def _cba(x: torch.Tensor, m, stride: int = 1, act: bool = True
         ) -> torch.Tensor:
    """conv (padding k // 2, the module's groups) + BN (+ leaky 0.01)."""
    w = m.conv.weight
    y = _batch_norm(_conv(x, w, stride, w.shape[-1] // 2, m.conv.groups),
                    m.bn, act=False)
    return F.leaky_relu(y, 0.01) if act else y


class CspNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, out[-1], H / 32, W / 32); `head.fc` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages stages."""
    head_name = "head.fc"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        cfg = self.cfg = CSPNETS[variant]
        chs, k, _, _ = cfg["stem"]
        self.stem = _Group(**{f"conv{i + 1}": _cb(cin, c, k, device)
                              for i, (cin, c) in enumerate(
                                  zip((3,) + chs[:-1], chs))})
        prev = chs[-1]
        stages = []
        self.n_stages = len(cfg["out"][:n_stages or None])
        for si, out in enumerate(cfg["out"][:self.n_stages]):
            g = cfg["groups"][si]
            sp = _Group()
            if not cfg["cross"]:
                sp.conv_down = _cb(prev, out, 3, device)
                bprev = out
            else:
                down = out if cfg["down_growth"] else prev
                if cfg["stride"][si] != 1:
                    sp.conv_down = _cb(prev, down, 3, device, g)
                    prev = down
                exp = int(round(out * cfg["exp"][si]))
                sp.conv_exp = _cb(prev, exp, 1, device)
                bprev = exp // 2
            bout = int(round(out * cfg["block"][si]))
            mid = int(round(bout * cfg["bottle"][si]))
            blocks = []
            for _ in range(cfg["depth"][si]):
                if cfg["dark"]:
                    blk = _Group(conv1=_cb(bprev, mid, 1, device),
                                 conv2=_cb(mid, bout, 3, device, g,
                                           zero_init=True))
                else:
                    blk = _Group(conv1=_cb(bprev, mid, 1, device),
                                 conv2=_cb(mid, mid, 3, device, g),
                                 conv3=_cb(mid, bout, 1, device,
                                           zero_init=True))
                blocks.append(blk)
                bprev = bout
            sp.blocks = nn.ModuleList(blocks)
            if cfg["cross"]:
                sp.conv_transition_b = _cb(bout, exp // 2, 1, device)
                sp.conv_transition = _cb(exp, out, 1, device)
            stages.append(sp)
            prev = out
        self.stages = nn.ModuleList(stages)
        self.num_features = prev
        if num_classes:
            self.head = _Group(fc=nn.Linear(prev, num_classes,
                                            device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        _, _, s0, pool = cfg["stem"]
        for i, m in enumerate(self.stem.children()):
            x = _cba(x, m, s0 if i == 0 else 1)
        if pool:
            x = F.max_pool2d(x, 3, 2, 1)
        for si, sp in enumerate(self.stages):
            if hasattr(sp, "conv_down"):
                x = _cba(x, sp.conv_down, cfg["stride"][si])
            if cfg["cross"]:
                x = _cba(x, sp.conv_exp, act=not cfg["cross_linear"])
                xs, xb = x.chunk(2, dim=1)
            else:
                xb = x
            for blk in sp.blocks:
                y = _cba(_cba(xb, blk.conv1), blk.conv2)
                if cfg["dark"]:
                    xb = y + xb
                else:
                    xb = F.leaky_relu(_cba(y, blk.conv3, act=False) + xb,
                                      0.01)
            if cfg["cross"]:
                xb = _cba(xb, sp.conv_transition_b)
                x = _cba(torch.cat([xs, xb], dim=1), sp.conv_transition)
            else:
                x = xb
        return x


def cspnet_from_jax(p) -> dict:
    """The JAX package's init_cspnet tree -> CspNet names."""
    def cba(q, base):
        return _cb_sd(q["conv"], q["bn"], base + ".conv.weight", base + ".bn.")

    sd = {}
    for i, q in enumerate(p["stem"]):
        sd.update(cba(q, f"stem.conv{i + 1}"))
    for si, sp in enumerate(p["stages"]):
        base = f"stages.{si}."
        for name in ("conv_down", "conv_exp", "conv_transition_b",
                     "conv_transition"):
            if name in sp:
                sd.update(cba(sp[name], base + name))
        for bi, blk in enumerate(sp["blocks"]):
            for name, q in blk.items():
                sd.update(cba(q, f"{base}blocks.{bi}.{name}"))
    return sd
