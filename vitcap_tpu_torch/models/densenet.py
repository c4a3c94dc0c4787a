"""DenseNet of the model zoo: the port of vitcap_tpu/models/densenet.py.

- A dense layer (pre-activation): BN + relu, 1x1 conv to 4 * growth, BN
  + relu, 3x3 conv (padding 1) to growth; its input is the concat of the
  block's input and every earlier layer's output.
- A transition between blocks: BN + relu, 1x1 conv to half the
  channels, AvgPool2d(2, 2).
- Stem: a 7x7/2 conv + BN + relu and a max pool 3/2 (padding 1), or the
  deep stem of the d nets (three 3x3 convs, g -> g -> 2g channels).
  densenetblur121d pools with a 3x3 stride-1 max pool, then the blur
  pool of stride 2 (in the stem only).  densenet264d_iabn: InplaceABN,
  BN + leaky relu 0.01, for every BN + relu.  tv_densenet121 is
  densenet121 under torchvision's weights, the same names.
- The last norm5 BN + act, then a linear classifier on the pooled map.

State-dict names: features.{conv0,norm0[,conv1,norm1,conv2,norm2]},
features.denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2},
features.transition{i}.{norm,conv}, features.norm5, classifier.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _batch_norm, _blur_pool, _bn, _cb_sd,
                        _conv, _cv, _norm_sd)
from .layers import _Group

# name -> (growth_rate, block_config, deep_stem)
DENSENETS = {
    "densenet121": (32, (6, 12, 24, 16), False),
    "densenet121d": (32, (6, 12, 24, 16), True),
    "densenet169": (32, (6, 12, 32, 32), False),
    "densenet201": (32, (6, 12, 48, 32), False),
    "densenet161": (48, (6, 12, 36, 24), False),
    "densenet264": (48, (6, 12, 64, 48), False),
    "densenetblur121d": (32, (6, 12, 24, 16), True),
    "densenet264d_iabn": (48, (6, 12, 64, 48), True),
    "tv_densenet121": (32, (6, 12, 24, 16), False),
}
_BN_SIZE = 4
_LEAKY = {"densenet264d_iabn"}     # InplaceABN: BN + leaky relu 0.01
_BLUR = {"densenetblur121d"}       # stride-1 max pool + blur pool stem


def densenet_feature_channels(variant: str) -> int:
    g, cfg, _ = DENSENETS[variant]
    n = 2 * g
    for i, layers in enumerate(cfg):
        n += layers * g
        if i != len(cfg) - 1:
            n //= 2
    return n


class DenseNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, C, H / 32, W / 32) after norm5; a linear
    `classifier` with num_classes > 0.  n_stages > 0 keeps the first
    n_stages dense blocks (norm5 after the last)."""
    head_name = "classifier"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        g, cfg, deep = DENSENETS[variant]
        self.cfg = cfg = cfg[:n_stages or None]
        self.leaky, self.blur = variant in _LEAKY, variant in _BLUR
        init_c = 2 * g
        f = _Group()
        if deep:
            for i, (cin, c) in enumerate(((3, g), (g, g), (g, init_c))):
                setattr(f, f"conv{i}", _cv(cin, c, 3, device))
                setattr(f, f"norm{i}", _bn(c, device))
        else:
            f.conv0 = _cv(3, init_c, 7, device)
            f.norm0 = _bn(init_c, device)
        n = init_c
        for i, layers in enumerate(cfg):
            blk = _Group()
            for j in range(layers):
                cin = n + j * g
                setattr(blk, f"denselayer{j + 1}", _Group(
                    norm1=_bn(cin, device),
                    conv1=_cv(cin, _BN_SIZE * g, 1, device),
                    norm2=_bn(_BN_SIZE * g, device),
                    conv2=_cv(_BN_SIZE * g, g, 3, device)))
            setattr(f, f"denseblock{i + 1}", blk)
            n += layers * g
            if i != len(cfg) - 1:
                setattr(f, f"transition{i + 1}", _Group(
                    norm=_bn(n, device), conv=_cv(n, n // 2, 1, device)))
                n //= 2
        f.norm5 = _bn(n, device)
        self.features = f
        self.num_features = n
        if num_classes:
            self.classifier = nn.Linear(n, num_classes, device=device)

    def _act(self, x: torch.Tensor, bn) -> torch.Tensor:
        if self.leaky:
            return F.leaky_relu(_batch_norm(x, bn, act=False), 0.01)
        return _batch_norm(x, bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        x = self._act(_conv(x, f.conv0.weight, 2, f.conv0.weight.shape[-1]
                            // 2), f.norm0)
        if hasattr(f, "conv1"):
            x = self._act(_conv(x, f.conv1.weight, 1, 1), f.norm1)
            x = self._act(_conv(x, f.conv2.weight, 1, 1), f.norm2)
        if self.blur:
            x = _blur_pool(F.max_pool2d(x, 3, 1, 1), 2)
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(len(self.cfg)):
            feats = [x]
            for lp in getattr(f, f"denseblock{i + 1}").children():
                h = self._act(torch.cat(feats, dim=1), lp.norm1)
                h = self._act(_conv(h, lp.conv1.weight), lp.norm2)
                feats.append(_conv(h, lp.conv2.weight, 1, 1))
            x = torch.cat(feats, dim=1)
            if i != len(self.cfg) - 1:
                tp = getattr(f, f"transition{i + 1}")
                x = F.avg_pool2d(_conv(self._act(x, tp.norm), tp.conv.weight),
                                 2, 2)
        return self._act(x, f.norm5)


def densenet_from_jax(p) -> dict:
    """The JAX package's init_densenet tree -> DenseNet names."""
    st = p["stem"]
    sd = {}
    for i in range(3):
        if f"conv{i}" in st:
            sd.update(_cb_sd(st[f"conv{i}"], st[f"norm{i}"],
                             f"features.conv{i}.weight",
                             f"features.norm{i}."))
    for i, lps in enumerate(p["blocks"]):
        for j, lp in enumerate(lps):
            base = f"features.denseblock{i + 1}.denselayer{j + 1}."
            for k in ("1", "2"):
                sd.update(_cb_sd(lp["conv" + k], lp["norm" + k],
                                 f"{base}conv{k}.weight", f"{base}norm{k}."))
    for i, tp in enumerate(p["transitions"]):
        base = f"features.transition{i + 1}."
        sd.update(_cb_sd(tp["conv"], tp["norm"], base + "conv.weight",
                         base + "norm."))
    sd.update(_norm_sd(p["norm5"], "features.norm5."))
    return sd
