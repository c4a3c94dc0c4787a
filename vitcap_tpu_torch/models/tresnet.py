"""TResNet m / l / xl (and their _448 names, the same nets at 448 px) of
the model zoo: the port of vitcap_tpu/models/tresnet.py.

- Stem: SpaceToDepth with block 4 (channel order (h offset, w offset,
  c), torch's), a 3x3 conv on 48 channels, InplaceABN with leaky relu
  1e-2.
- InplaceABN is BN (eps 1e-5) then leaky relu: slope 1e-2 in the stem,
  1e-3 in the blocks, none on a branch's last norm and the downsample.
- BasicBlock (layers 1-2): 3x3 conv1 + IABN (a stride-2 block runs it at
  stride 1, then the anti-aliasing blur pool of stride 2), 3x3 conv2 +
  IABN with no activation, SE (max(planes // 4, 64) channels) on the
  branch, the residual add, relu.
- Bottleneck (layers 3-4): 1x1 + IABN, 3x3 + IABN (blur pool when stride
  2), SE (max(planes // 2, 64); none in layer 4), 1x1 + IABN with no
  activation, the residual add, relu.
- Downsample where the shape changes: AvgPool2d(2, 2), then a 1x1 conv +
  IABN with no activation.
- planes = int(64 * width factor), doubling per layer; a linear head.fc
  on the pooled map.

State-dict names: body.conv1.{0,1}, body.layer{1-4}.{j}.conv{1,2,3}.{0,1}
(a stride-2 conv wrapped once more with its blur pool: conv{i}.0.{0,1}),
.se.{fc1,fc2}, .downsample.1.{0,1}, head.fc.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import (PooledHead, _avg_pool2, _batch_norm, _blur_pool,
                        _cb, _cb_sd, _conv, _cv, _se_apply)
from .efficientnet import _se_sd
from .layers import _Group

# name -> (per-layer block counts, width factor)
TRESNETS = {
    "tresnet_m": ((3, 4, 11, 3), 1.0),
    "tresnet_l": ((4, 5, 18, 3), 1.2),
    "tresnet_xl": ((4, 5, 24, 3), 1.3),
}
for _n in ("tresnet_m", "tresnet_l", "tresnet_xl"):
    TRESNETS[_n + "_448"] = TRESNETS[_n]


def tresnet_feature_channels(variant: str) -> int:
    return int(64 * TRESNETS[variant][1]) * 8 * 4


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 16 C, H / 4, W / 4), channel (h_off, w_off, c)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 4, 4, W // 4, 4).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, 16 * C, H // 4, W // 4)


def _iabn(x: torch.Tensor, m, slope: float, stride: int = 1
          ) -> torch.Tensor:
    """conv (padding k // 2) + InplaceABN: BN then leaky relu(slope), the
    identity at slope 0."""
    w = getattr(m, "0").weight
    y = _batch_norm(_conv(x, w, stride, w.shape[-1] // 2), getattr(m, "1"),
                    act=False)
    return F.leaky_relu(y, slope) if slope else y


def _seq_cb(cin, cout, k, device, zero_init=False):
    return _cb(cin, cout, k, device, names=("0", "1"), zero_init=zero_init)


class TResNet(PooledHead, nn.Module):
    """(B, 3, H, W) -> (B, 32 * planes, H / 32, W / 32); `head.fc` with
    num_classes > 0.  n_stages > 0 keeps the first n_stages layers."""
    head_name = "head.fc"

    def __init__(self, variant: str, num_classes: int = 0,
                 n_stages: int = 0, device=None):
        super().__init__()
        layers, wf = TRESNETS[variant]
        planes = int(64 * wf)
        body = _Group(conv1=_seq_cb(48, planes, 3, device))
        prev = planes
        self.n_stages = len(layers[:n_stages or None])
        for li, depth in enumerate(layers[:self.n_stages]):
            pl = planes * (1 << li)
            basic = li < 2
            out = pl if basic else pl * 4
            blocks = []
            for bi in range(depth):
                s = (1 if li == 0 else 2) if bi == 0 else 1
                blk = _Group()
                if bi == 0 and (s != 1 or prev != out):
                    # the Sequential is [pool, (conv, iabn)]
                    blk.downsample = _Group(**{"1": _seq_cb(prev, out, 1,
                                                            device)})
                if basic:
                    convs = [_seq_cb(prev, pl, 3, device),
                             _seq_cb(pl, pl, 3, device, zero_init=True)]
                    se = max(pl // 4, 64) if li < 3 else 0
                else:
                    convs = [_seq_cb(prev, pl, 1, device),
                             _seq_cb(pl, pl, 3, device),
                             _seq_cb(pl, out, 1, device, zero_init=True)]
                    se = max(pl // 2, 64) if li < 3 else 0
                aa = 0 if basic else 1       # the conv that runs the stride
                for ci, cv in enumerate(convs):
                    if s == 2 and ci == aa:
                        cv = _Group(**{"0": cv})   # [(conv, iabn), blur]
                    setattr(blk, f"conv{ci + 1}", cv)
                if se:
                    blk.se = _Group(fc1=_cv(pl, se, 1, device, bias=True),
                                    fc2=_cv(se, pl, 1, device, bias=True))
                blocks.append(blk)
                prev = out
            setattr(body, f"layer{li + 1}", nn.ModuleList(blocks))
        self.body = body
        self.num_features = prev
        if num_classes:
            self.head = _Group(fc=nn.Linear(prev, num_classes,
                                            device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _iabn(_space_to_depth(x), self.body.conv1, 1e-2)
        for li in range(self.n_stages):
            for bi, blk in enumerate(getattr(self.body, f"layer{li + 1}")):
                s = (1 if li == 0 else 2) if bi == 0 else 1
                residual = x
                if hasattr(blk, "downsample"):
                    d = _avg_pool2(x) if s == 2 else x
                    residual = _iabn(d, getattr(blk.downsample, "1"), 0)

                def conv(y, m, slope):
                    if s == 2 and not hasattr(m, "1"):
                        return _blur_pool(_iabn(y, getattr(m, "0"), slope))
                    return _iabn(y, m, slope)
                if li < 2:
                    y = conv(x, blk.conv1, 1e-3)
                    y = conv(y, blk.conv2, 0)
                    if hasattr(blk, "se"):
                        y = _se_apply(y, blk.se)
                else:
                    y = conv(x, blk.conv1, 1e-3)
                    y = conv(y, blk.conv2, 1e-3)
                    if hasattr(blk, "se"):
                        y = _se_apply(y, blk.se)
                    y = conv(y, blk.conv3, 0)
                x = F.relu(y + residual)
        return x


def tresnet_from_jax(p) -> dict:
    """The JAX package's init_tresnet tree -> TResNet names."""
    sd = _cb_sd(p["conv1"]["conv"], p["conv1"]["bn"], "body.conv1.0.weight",
                "body.conv1.1.")
    for li, blocks in enumerate(p["layers"]):
        for bi, blk in enumerate(blocks):
            base = f"body.layer{li + 1}.{bi}."
            if "down_conv" in blk:
                sd.update(_cb_sd(blk["down_conv"], blk["down_bn"],
                                 base + "downsample.1.0.weight",
                                 base + "downsample.1.1."))
            aa = 1 if li < 2 else 2
            for ci in (1, 2, 3):
                if f"conv{ci}" not in blk:
                    continue
                sub = (f"conv{ci}.0." if li > 0 and bi == 0 and ci == aa
                       else f"conv{ci}.")
                sd.update(_cb_sd(blk[f"conv{ci}"], blk[f"bn{ci}"],
                                 f"{base}{sub}0.weight", f"{base}{sub}1."))
            if "se" in blk:
                sd.update(_se_sd(blk["se"], base + "se.", ("fc1", "fc2")))
    return sd
