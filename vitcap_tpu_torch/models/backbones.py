"""CNN stems of the hybrid ViTs, the ResNet family of the model zoo and
the zoo's train mode: the port of vitcap_tpu/models/backbones.py.

- ResNetV2R50 (the R50+ViT-B/16 hybrid stem): 3 stages of bottlenecks
  without pre-activation, weight-standardised convs with TF-'SAME'
  padding, GroupNorm(32) + ReLU (std_conv: divide by std + eps, not by
  sqrt(var + eps)).
- ResNet: BatchNorm basic, bottleneck and res2 (Bottle2neck) blocks, the
  7x7 or a deep 3-conv stem, conv or avg-pool downsample, SE or ECA
  attention, grouped (ResNeXt) convs, BlurPool anti-aliasing, the gluon
  variants and the pruned widths (models/pruned.py).  Torch's symmetric
  padding everywhere (TF-'SAME' aligns otherwise at stride 2).  The -d
  variants double as hybrid-ViT stems (HYBRIDS).

The modules hold parameters under the timm torch state-dict names
(`conv1.0.weight`, `layer1.0.bn1.running_mean`, `se.fc1.weight`,
`stages.0.blocks.0.downsample.conv.weight`, ...), so a timm checkpoint
loads by name; the math lives in their forward methods.  They take and
give NCHW tensors (the zoo's functions pass NHWC images as the
channels-last view, so nothing is copied) in the input's dtype;
parameters stay f32 and are cast per use, normalisation statistics are
f32.  The convolutions are PyTorch's (cuDNN on the card): the JAX package
computes them with lax.conv outside any Pallas kernel.

Train mode (the JAX package's zoo_train_mode): `model.train()` makes every
BatchNorm of the zoo normalise on the batch's statistics (biased
variance, f32 accumulation, gradients through them) and update its
running statistics in place (momentum blend, unbiased variance; torch's
_BatchNorm).  `with zoo_train_mode(model, generator, drop_path_rate,
drop_rate):` also drops the effnet and mobilenetv3 residual branches per
sample (the builder's linear depth schedule) and applies dropout before
the classifiers the JAX package wraps in _head_dropout (ResNet,
efficientnet, mobilenetv3, regnet), every mask drawn from `generator`.
In eval every path is the identity of these.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import _Group

_EPS = 1e-5


# ---------------------------------------------------------------------------
# primitives (NCHW, the input's dtype)
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF-'SAME' padding of one axis: (before, after), the extra one after."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad=0,
          groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """x NCHW, w OIHW (I = C_in / groups).  pad: an int (torch's symmetric
    zero padding) or 'same' (TF-'SAME')."""
    w = w.to(x.dtype)
    if pad == "same":
        (t, b), (l, r) = (_same_pads(x.shape[2], w.shape[2], stride),
                          _same_pads(x.shape[3], w.shape[3], stride))
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        pad = 0
    return F.conv2d(x, w, None, stride, pad, dilation, groups)


def _std_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pad="same") -> torch.Tensor:
    """Weight-standardised conv, per output channel over (in, kh, kw):
    (w - mean) / (std + eps), eps added to the STD (timm std_conv.py)."""
    wf = w.float()
    mean = wf.mean(dim=(1, 2, 3), keepdim=True)
    std = wf.std(dim=(1, 2, 3), unbiased=False, keepdim=True)
    return _conv(x, (wf - mean) / (std + _EPS), stride, pad)


def _group_norm(x: torch.Tensor, m: nn.GroupNorm, act: bool = True
                ) -> torch.Tensor:
    """GroupNorm(32) with f32 statistics, then ReLU."""
    y = F.group_norm(x.float(), m.num_groups, m.weight, m.bias,
                     _EPS).to(x.dtype)
    return F.relu(y) if act else y


def _batch_norm(x: torch.Tensor, m: nn.BatchNorm2d, act: bool = True
                ) -> torch.Tensor:
    """BatchNorm, then ReLU.  Eval: on the running statistics.  Train
    (m.training): on the batch's statistics over every axis but the
    channels (biased variance, accumulated in f32 for a bf16 input,
    gradients through them), the running statistics updated in place to
    (1 - momentum) * running + momentum * batch with the batch variance
    unbiased (the JAX package's bn_updated_params)."""
    y = F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                     m.training, m.momentum, m.eps)
    return F.relu(y) if act else y


# ---------------------------------------------------------------------------
# the zoo's train mode: stochastic depth and head dropout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ZooTrainMode:
    """The drop rates of a zoo_train_mode block and the generator its
    masks come from."""
    generator: Optional[torch.Generator] = None
    drop_path_rate: float = 0.0
    drop_rate: float = 0.0

    def uniform(self, shape, device) -> torch.Tensor:
        """U[0, 1) draws of `shape` from the generator, on `device`."""
        if self.generator is None:
            raise ValueError("zoo_train_mode needs a generator when "
                             "drop_path_rate or drop_rate > 0")
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device).to(device)


@contextlib.contextmanager
def zoo_train_mode(model: nn.Module,
                   generator: Optional[torch.Generator] = None,
                   drop_path_rate: float = 0.0, drop_rate: float = 0.0):
    """model.train() for the block, with stochastic depth (drop_path_rate,
    scaled by each residual block's flat index over the block count) and
    head dropout (drop_rate), masks from `generator`; the model's mode is
    restored after."""
    was = model.training
    model.train()
    model.zoo_train = ZooTrainMode(generator, drop_path_rate, drop_rate)
    try:
        yield model.zoo_train
    finally:
        del model.zoo_train
        model.train(was)


def train_opts(model: nn.Module) -> Optional[ZooTrainMode]:
    """The model's zoo_train_mode options while it trains, else None."""
    return getattr(model, "zoo_train", None) if model.training else None


def drop_path(x: torch.Tensor, tm: Optional[ZooTrainMode],
              rate_scale: float = 1.0) -> torch.Tensor:
    """Stochastic depth on a residual branch: each sample kept whole with
    probability keep = 1 - drop_path_rate * rate_scale (the mask
    floor(keep + U[0, 1))) and scaled by 1 / keep; the identity outside
    zoo_train_mode or at rate 0."""
    rate = tm.drop_path_rate * rate_scale if tm is not None else 0.0
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.floor(keep + tm.uniform(
        (x.shape[0],) + (1,) * (x.ndim - 1), x.device))
    return x * (mask / keep).to(x.dtype)


def head_dropout(x: torch.Tensor, tm: Optional[ZooTrainMode]
                 ) -> torch.Tensor:
    """Dropout before a classifier: each value kept with probability
    1 - drop_rate and scaled by its inverse; the identity outside
    zoo_train_mode or at rate 0."""
    if tm is None or tm.drop_rate == 0.0:
        return x
    keep = 1.0 - tm.drop_rate
    mask = tm.uniform(x.shape, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2
                   ) -> torch.Tensor:
    """Max pool with TF-'SAME' padding by -inf."""
    (t, b), (l, r) = (_same_pads(x.shape[2], k, stride),
                      _same_pads(x.shape[3], k, stride))
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), k, stride)


# BlurPool2d (timm layers/blur_pool.py): reflect-pad 1, the [1, 2, 1] / 4
# binomial filter's outer product, depthwise stride-2 conv
_BLUR_FILT = np.outer((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))


def _blur_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    c = x.shape[1]
    w = torch.as_tensor(_BLUR_FILT, dtype=x.dtype, device=x.device)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                    w.expand(c, 1, 3, 3).contiguous(), None, stride, 0, 1, c)


def _maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2, ceil_mode=True): the last window may hang past the
    bottom and right edges (vovnet, legacy senet)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2), the avg-pool downsample."""
    return F.avg_pool2d(x, 2, 2)


def _bn(c: int, device, eps: float = _EPS, momentum: float = 0.1,
        zero_init: bool = False) -> nn.BatchNorm2d:
    """zero_init: the JAX package starts this BN's scale at zero (a
    residual branch's last norm)."""
    bn = nn.BatchNorm2d(c, eps=eps, momentum=momentum, device=device)
    bn.zero_init = zero_init
    return bn


def _cb(cin: int, cout: int, k: int, device, groups: int = 1,
        names=("conv", "bn"), **bn_kw) -> "_Group":
    """A conv (no bias) and its BN under two names: {conv, bn} or a
    Sequential's {0, 1}."""
    return _Group(**{names[0]: _cv(cin, cout, k, device, groups),
                     names[1]: _bn(cout, device, **bn_kw)})


class PooledHead:
    """classify(pooled): the module at self.head_name, a Linear or a 1x1
    Conv2d (dpn, dla), on the globally pooled features, in their dtype."""
    head_name = "fc"

    def classify(self, pooled: torch.Tensor) -> torch.Tensor:
        fc = self.get_submodule(self.head_name)
        return F.linear(pooled, fc.weight.flatten(1).to(pooled.dtype),
                        fc.bias.to(pooled.dtype))


def _cv(cin: int, cout: int, k: int, device, groups: int = 1,
        bias: bool = False) -> nn.Conv2d:
    """A parameter holder of the timm conv's OIHW shape; _conv runs it."""
    return nn.Conv2d(cin, cout, k, groups=groups, bias=bias, device=device)


# ---------------------------------------------------------------------------
# ResNetV2 (the R50 hybrid stem): StdConv 'SAME' + GroupNorm, no pre-act
# ---------------------------------------------------------------------------

R50_LAYERS = (3, 4, 9)
R50_CHANNELS = (256, 512, 1024)


class ResNetV2R50(nn.Module):
    """(B, 3, H, W) -> (B, 1024, H / 16, W / 16)."""

    def __init__(self, device=None):
        super().__init__()

        def gn(c):
            return nn.GroupNorm(32, c, eps=_EPS, device=device)
        self.stem = _Group(conv=_cv(3, 64, 7, device), norm=gn(64))
        stages, prev = [], 64
        for depth, out in zip(R50_LAYERS, R50_CHANNELS):
            mid = out // 4
            blocks = []
            for b in range(depth):
                blk = _Group(conv1=_cv(prev, mid, 1, device), norm1=gn(mid),
                             conv2=_cv(mid, mid, 3, device), norm2=gn(mid),
                             conv3=_cv(mid, out, 1, device), norm3=gn(out))
                if b == 0:
                    blk.downsample = _Group(conv=_cv(prev, out, 1, device),
                                            norm=gn(out))
                blocks.append(blk)
                prev = out
            stages.append(_Group(blocks=nn.ModuleList(blocks)))
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _group_norm(_std_conv(x, self.stem.conv.weight, 2),
                        self.stem.norm)
        x = _max_pool_same(x, 3, 2)
        for si, stage in enumerate(self.stages):
            for bi, blk in enumerate(stage.blocks):
                s = (1 if si == 0 else 2) if bi == 0 else 1
                shortcut = x
                if hasattr(blk, "downsample"):
                    shortcut = _group_norm(
                        _std_conv(x, blk.downsample.conv.weight, s),
                        blk.downsample.norm, act=False)
                y = _group_norm(_std_conv(x, blk.conv1.weight), blk.norm1)
                y = _group_norm(_std_conv(y, blk.conv2.weight, s), blk.norm2)
                y = _group_norm(_std_conv(y, blk.conv3.weight), blk.norm3,
                                act=False)
                x = F.relu(y + shortcut)
        return x


# ---------------------------------------------------------------------------
# the ResNet family (timm resnet.py, res2net.py, gluon_resnet.py)
# ---------------------------------------------------------------------------

# variant -> (per-stage block counts, block type, stem type, downsample
# type[, extras]): vitcap_tpu/models/backbones.py RESNETS
RESNETS: Dict[str, tuple] = {
    "resnet18": ((2, 2, 2, 2), "basic", "7x7", "conv"),
    "resnet18d": ((2, 2, 2, 2), "basic", "deep", "avg"),
    "resnet34": ((3, 4, 6, 3), "basic", "7x7", "conv"),
    "resnet34d": ((3, 4, 6, 3), "basic", "deep", "avg"),
    "resnet26": ((2, 2, 2, 2), "bottleneck", "7x7", "conv"),
    "resnet26d": ((2, 2, 2, 2), "bottleneck", "deep", "avg"),
    "resnet50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv"),
    "resnet50d": ((3, 4, 6, 3), "bottleneck", "deep", "avg"),
    "resnet101": ((3, 4, 23, 3), "bottleneck", "7x7", "conv"),
    "resnet101d": ((3, 4, 23, 3), "bottleneck", "deep", "avg"),
    "resnet152": ((3, 8, 36, 3), "bottleneck", "7x7", "conv"),
    "resnet152d": ((3, 8, 36, 3), "bottleneck", "deep", "avg"),
    "resnet200": ((3, 24, 36, 3), "bottleneck", "7x7", "conv"),
    "resnet200d": ((3, 24, 36, 3), "bottleneck", "deep", "avg"),
    # resnext: grouped bottleneck, width = floor(planes * bw / 64) * card
    "resnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                        dict(card=32, bw=4)),
    "resnext50d_32x4d": ((3, 4, 6, 3), "bottleneck", "deep", "avg",
                         dict(card=32, bw=4)),
    "resnext101_32x4d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                         dict(card=32, bw=4)),
    "resnext101_32x8d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                         dict(card=32, bw=8)),
    "resnext101_64x4d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                         dict(card=64, bw=4)),
    # SEModule(out, reduction 16) after the last BN
    "seresnet18": ((2, 2, 2, 2), "basic", "7x7", "conv", dict(se=True)),
    "seresnet34": ((3, 4, 6, 3), "basic", "7x7", "conv", dict(se=True)),
    "seresnet50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                   dict(se=True)),
    "seresnet101": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                    dict(se=True)),
    "seresnet152": ((3, 8, 36, 3), "bottleneck", "7x7", "conv",
                    dict(se=True)),
    "seresnet152d": ((3, 8, 36, 3), "bottleneck", "deep", "avg",
                     dict(se=True)),
    "seresnet152d_320": ((3, 8, 36, 3), "bottleneck", "deep", "avg",
                         dict(se=True)),
    "seresnext26d_32x4d": ((2, 2, 2, 2), "bottleneck", "deep", "avg",
                           dict(card=32, bw=4, se=True)),
    "seresnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                          dict(card=32, bw=4, se=True)),
    "seresnext101_32x4d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                           dict(card=32, bw=4, se=True)),
    "seresnext101_32x8d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                           dict(card=32, bw=8, se=True)),
    # res2net / res2next: the scale-split Bottle2neck
    "res2net50_26w_4s": ((3, 4, 6, 3), "res2", "7x7", "conv",
                         dict(bw=26, scale=4)),
    "res2net101_26w_4s": ((3, 4, 23, 3), "res2", "7x7", "conv",
                          dict(bw=26, scale=4)),
    "res2net50_26w_6s": ((3, 4, 6, 3), "res2", "7x7", "conv",
                         dict(bw=26, scale=6)),
    "res2net50_26w_8s": ((3, 4, 6, 3), "res2", "7x7", "conv",
                         dict(bw=26, scale=8)),
    "res2net50_48w_2s": ((3, 4, 6, 3), "res2", "7x7", "conv",
                         dict(bw=48, scale=2)),
    "res2net50_14w_8s": ((3, 4, 6, 3), "res2", "7x7", "conv",
                         dict(bw=14, scale=8)),
    "res2next50": ((3, 4, 6, 3), "res2", "7x7", "conv",
                   dict(card=8, bw=4, scale=4)),
    # torchvision / ssl / swsl / ig re-registrations: the same graphs
    "tv_resnet34": ((3, 4, 6, 3), "basic", "7x7", "conv"),
    "tv_resnet50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv"),
    "tv_resnet101": ((3, 4, 23, 3), "bottleneck", "7x7", "conv"),
    "tv_resnet152": ((3, 8, 36, 3), "bottleneck", "7x7", "conv"),
    "tv_resnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                           dict(card=32, bw=4)),
    "ssl_resnet18": ((2, 2, 2, 2), "basic", "7x7", "conv"),
    "ssl_resnet50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv"),
    "ssl_resnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                            dict(card=32, bw=4)),
    "ssl_resnext101_32x4d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                             dict(card=32, bw=4)),
    "ssl_resnext101_32x8d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                             dict(card=32, bw=8)),
    "ssl_resnext101_32x16d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                              dict(card=32, bw=16)),
    "swsl_resnet18": ((2, 2, 2, 2), "basic", "7x7", "conv"),
    "swsl_resnet50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv"),
    "swsl_resnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                             dict(card=32, bw=4)),
    "swsl_resnext101_32x4d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                              dict(card=32, bw=4)),
    "swsl_resnext101_32x8d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                              dict(card=32, bw=8)),
    "swsl_resnext101_32x16d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                               dict(card=32, bw=16)),
    "ig_resnext101_32x8d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                            dict(card=32, bw=8)),
    "ig_resnext101_32x16d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                             dict(card=32, bw=16)),
    "ig_resnext101_32x32d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                             dict(card=32, bw=32)),
    "ig_resnext101_32x48d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                             dict(card=32, bw=48)),
    # wide resnets: 2x bottleneck width
    "wide_resnet50_2": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                        dict(bw=128)),
    "wide_resnet101_2": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                         dict(bw=128)),
    # 320x320 default-cfg duplicates of the -d models
    "resnet101d_320": ((3, 4, 23, 3), "bottleneck", "deep", "avg"),
    "resnet152d_320": ((3, 8, 36, 3), "bottleneck", "deep", "avg"),
    "resnet200d_320": ((3, 24, 36, 3), "bottleneck", "deep", "avg"),
    # deep SE models and tiered stems
    "seresnet200d": ((3, 24, 36, 3), "bottleneck", "deep", "avg",
                     dict(se=True)),
    "seresnet269d": ((3, 30, 48, 8), "bottleneck", "deep", "avg",
                     dict(se=True)),
    "seresnet50tn": ((3, 4, 6, 3), "bottleneck", "tiered_narrow", "avg",
                     dict(se=True)),
    "seresnext26_32x4d": ((2, 2, 2, 2), "bottleneck", "7x7", "conv",
                          dict(card=32, bw=4, se=True)),
    "seresnext26t_32x4d": ((2, 2, 2, 2), "bottleneck", "tiered", "avg",
                           dict(card=32, bw=4, se=True)),
    "seresnext26tn_32x4d": ((2, 2, 2, 2), "bottleneck", "tiered_narrow",
                            "avg", dict(card=32, bw=4, se=True)),
    # ECA attention: an adaptive 1-d conv over the channel-pooled vector
    "ecaresnet18": ((2, 2, 2, 2), "basic", "7x7", "conv",
                    dict(attn="eca")),
    "ecaresnet50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                    dict(attn="eca")),
    "ecaresnet50d": ((3, 4, 6, 3), "bottleneck", "deep", "avg",
                     dict(attn="eca")),
    "ecaresnetlight": ((1, 1, 11, 3), "bottleneck", "7x7", "avg",
                       dict(attn="eca")),
    "ecaresnet101d": ((3, 4, 23, 3), "bottleneck", "deep", "avg",
                      dict(attn="eca")),
    "ecaresnet200d": ((3, 24, 36, 3), "bottleneck", "deep", "avg",
                      dict(attn="eca")),
    "ecaresnet269d": ((3, 30, 48, 8), "bottleneck", "deep", "avg",
                      dict(attn="eca")),
    "ecaresnext26tn_32x4d": ((2, 2, 2, 2), "bottleneck", "tiered_narrow",
                             "avg", dict(card=32, bw=4, attn="eca")),
    # pruned eca-resnets: every block's widths from models/pruned.py
    "ecaresnet50d_pruned": ((3, 4, 6, 3), "bottleneck", "deep", "avg",
                            dict(attn="eca", pruned=True)),
    "ecaresnet101d_pruned": ((3, 4, 23, 3), "bottleneck", "deep", "avg",
                             dict(attn="eca", pruned=True)),
    # anti-aliased (BlurPool) resnets
    "resnetblur18": ((2, 2, 2, 2), "basic", "7x7", "conv",
                     dict(blur=True)),
    "resnetblur50": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                     dict(blur=True)),
    # SENet-154 in the ResNet shell: deep-64 stem, cardinality 64, the
    # first bottleneck conv halved, 3x3 downsample convs
    "senet154": ((3, 8, 36, 3), "bottleneck", "deep64", "conv",
                 dict(card=64, bw=4, se=True, rf=2, down_k=3)),
    "gluon_senet154": ((3, 8, 36, 3), "bottleneck", "deep64", "conv",
                       dict(card=64, bw=4, se=True, rf=2, down_k=3)),
    # the gluon model zoo's re-parameterisations: v1b standard, v1c deep
    # stem + conv-down, v1d deep stem + avg-down, v1s 64-wide deep stem
    "gluon_resnet18_v1b": ((2, 2, 2, 2), "basic", "7x7", "conv"),
    "gluon_resnet34_v1b": ((3, 4, 6, 3), "basic", "7x7", "conv"),
    "gluon_resnet50_v1b": ((3, 4, 6, 3), "bottleneck", "7x7", "conv"),
    "gluon_resnet101_v1b": ((3, 4, 23, 3), "bottleneck", "7x7", "conv"),
    "gluon_resnet152_v1b": ((3, 8, 36, 3), "bottleneck", "7x7", "conv"),
    "gluon_resnet50_v1c": ((3, 4, 6, 3), "bottleneck", "deep", "conv"),
    "gluon_resnet101_v1c": ((3, 4, 23, 3), "bottleneck", "deep", "conv"),
    "gluon_resnet152_v1c": ((3, 8, 36, 3), "bottleneck", "deep", "conv"),
    "gluon_resnet50_v1d": ((3, 4, 6, 3), "bottleneck", "deep", "avg"),
    "gluon_resnet101_v1d": ((3, 4, 23, 3), "bottleneck", "deep", "avg"),
    "gluon_resnet152_v1d": ((3, 8, 36, 3), "bottleneck", "deep", "avg"),
    "gluon_resnet50_v1s": ((3, 4, 6, 3), "bottleneck", "deep64", "conv"),
    "gluon_resnet101_v1s": ((3, 4, 23, 3), "bottleneck", "deep64", "conv"),
    "gluon_resnet152_v1s": ((3, 8, 36, 3), "bottleneck", "deep64", "conv"),
    "gluon_resnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                              dict(card=32, bw=4)),
    "gluon_resnext101_32x4d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                               dict(card=32, bw=4)),
    "gluon_resnext101_64x4d": ((3, 4, 23, 3), "bottleneck", "7x7", "conv",
                               dict(card=64, bw=4)),
    "gluon_seresnext50_32x4d": ((3, 4, 6, 3), "bottleneck", "7x7", "conv",
                                dict(card=32, bw=4, se=True)),
    "gluon_seresnext101_32x4d": ((3, 4, 23, 3), "bottleneck", "7x7",
                                 "conv", dict(card=32, bw=4, se=True)),
    "gluon_seresnext101_64x4d": ((3, 4, 23, 3), "bottleneck", "7x7",
                                 "conv", dict(card=64, bw=4, se=True)),
}
_PLANES = (64, 128, 256, 512)

# deep-stem per-conv output channels: 'deep' stem width 32, 'deep64' 64;
# the tiered stems narrow the first two convs
_STEM_CHS = {
    "deep": (32, 32, 64),
    "deep64": (64, 64, 128),
    "tiered": (24, 48, 64),
    "tiered_narrow": (24, 32, 64),
}


def resnet_cfg(variant: str) -> Dict[str, Any]:
    cfg = RESNETS[variant]
    extras = cfg[4] if len(cfg) > 4 else {}
    attn = extras.get("attn", "se" if extras.get("se") else None)
    return dict(layers=cfg[0], block=cfg[1], stem=cfg[2], down=cfg[3],
                card=extras.get("card", 1), bw=extras.get("bw", 64),
                attn=attn, scale=extras.get("scale", 4),
                rf=extras.get("rf", 1), down_k=extras.get("down_k", 1),
                blur=extras.get("blur", False),
                pruned=extras.get("pruned", False))


def resnet_feature_channels(variant: str, n_stages: int = 4) -> int:
    cfg = resnet_cfg(variant)
    if cfg["pruned"]:
        from .pruned import pruned_shapes
        last = cfg["layers"][n_stages - 1] - 1
        return pruned_shapes(variant)[
            f"layer{n_stages}.{last}.conv3.weight"][0]
    return _PLANES[n_stages - 1] * (1 if cfg["block"] == "basic" else 4)


def eca_kernel_size(channels: int) -> int:
    """The adaptive ECA 1-d kernel (timm layers/eca.py, gamma 2, beta 1)."""
    t = int(abs(math.log(channels, 2) + 1) / 2)
    return max(t if t % 2 else t + 1, 3)


def _se_apply(x: torch.Tensor, se) -> torch.Tensor:
    """SEModule: channel means, 1x1 reduce + ReLU, 1x1 expand, sigmoid gate."""
    c, red = se.fc1.weight.shape[1], se.fc1.weight.shape[0]
    dt = x.dtype
    s = x.mean(dim=(2, 3))
    s = F.relu(s @ se.fc1.weight.view(red, c).t().to(dt)
               + se.fc1.bias.to(dt))
    s = s @ se.fc2.weight.view(c, red).t().to(dt) + se.fc2.bias.to(dt)
    return x * torch.sigmoid(s)[:, :, None, None]


def _eca_apply(x: torch.Tensor, se) -> torch.Tensor:
    """EcaModule: a zero-padded 1-d conv over the channel means, sigmoid
    gate."""
    w = se.conv.weight
    k = w.shape[-1]
    y = F.conv1d(x.mean(dim=(2, 3))[:, None], w.to(x.dtype), None, 1,
                 (k - 1) // 2)[:, 0]
    return x * torch.sigmoid(y)[:, :, None, None]


class ResNet(nn.Module):
    """The timm ResNet shell: (B, 3, H, W) -> (B, C, H / 2^(1+n_stages),
    ...) features; with num_classes > 0 an `fc` head (cnn_forward in
    models/registry.py applies it)."""

    def __init__(self, variant: str, n_stages: int = 4, num_classes: int = 0,
                 device=None):
        super().__init__()
        cfg = resnet_cfg(variant)
        self.variant, self.cfg = variant, cfg
        block, card, bw, rf = cfg["block"], cfg["card"], cfg["bw"], cfg["rf"]
        scale = cfg["scale"]
        pshapes = None
        if cfg["pruned"]:
            from .pruned import pruned_shapes
            pshapes = pruned_shapes(variant)
        if cfg["stem"] in _STEM_CHS:
            c1, c2, c3 = _STEM_CHS[cfg["stem"]]
            self.conv1 = _Group(**{"0": _cv(3, c1, 3, device),
                                   "1": _bn(c1, device),
                                   "3": _cv(c1, c2, 3, device),
                                   "4": _bn(c2, device),
                                   "6": _cv(c2, c3, 3, device)})
            prev = c3
        else:
            self.conv1 = _cv(3, 64, 7, device)
            prev = 64
        self.bn1 = _bn(prev, device)
        # the avg-down Sequential is [pool, conv, bn], conv-down [conv, bn]
        dci = 1 if cfg["down"] == "avg" else 0
        for si, depth in enumerate(cfg["layers"][:n_stages]):
            planes = _PLANES[si]
            mid = int(planes * bw / 64) * card
            out = planes * (1 if block == "basic" else 4)
            blocks = []
            for b in range(depth):
                if block == "res2":
                    n = max(1, scale - 1)
                    blk = _Group(
                        conv1=_cv(prev, mid * scale, 1, device),
                        bn1=_bn(mid * scale, device),
                        convs=nn.ModuleList(_cv(mid, mid, 3, device, card)
                                            for _ in range(n)),
                        bns=nn.ModuleList(_bn(mid, device)
                                          for _ in range(n)),
                        conv3=_cv(mid * scale, out, 1, device),
                        bn3=_bn(out, device))
                elif block == "bottleneck":
                    first = mid // rf
                    if pshapes is not None:
                        base = f"layer{si + 1}.{b}."
                        first = pshapes[base + "conv1.weight"][0]
                        mid = pshapes[base + "conv2.weight"][0]
                        out = pshapes[base + "conv3.weight"][0]
                    blk = _Group(conv1=_cv(prev, first, 1, device),
                                 bn1=_bn(first, device),
                                 conv2=_cv(first, mid, 3, device, card),
                                 bn2=_bn(mid, device),
                                 conv3=_cv(mid, out, 1, device),
                                 bn3=_bn(out, device))
                else:
                    first = mid // rf
                    blk = _Group(conv1=_cv(prev, first, 3, device),
                                 bn1=_bn(first, device),
                                 conv2=_cv(first, out, 3, device),
                                 bn2=_bn(out, device))
                if cfg["attn"] == "eca":
                    # the pruned manifests fix each kernel size (it came
                    # from the unpruned widths)
                    k = (pshapes[f"layer{si + 1}.{b}.se.conv.weight"][2]
                         if pshapes is not None else eca_kernel_size(out))
                    blk.se = _Group(conv=nn.Conv1d(1, 1, k, bias=False,
                                                   device=device))
                elif cfg["attn"] == "se":
                    red = max(8, out // 16)
                    blk.se = _Group(fc1=_cv(out, red, 1, device, bias=True),
                                    fc2=_cv(red, out, 1, device, bias=True))
                s = (1 if si == 0 else 2) if b == 0 else 1
                if b == 0 and (s != 1 or prev != out):
                    # senets: 3x3 downsample convs, 1x1 where the stage is
                    # stride 1
                    dk = 1 if s == 1 else cfg["down_k"]
                    blk.downsample = _Group(**{
                        str(dci): _cv(prev, out, dk, device),
                        str(dci + 1): _bn(out, device)})
                blocks.append(blk)
                prev = out
            setattr(self, f"layer{si + 1}", nn.ModuleList(blocks))
        self.n_stages = len(cfg["layers"][:n_stages])
        self.num_features = prev
        if num_classes:
            self.fc = nn.Linear(prev, num_classes, device=device)

    def stages(self):
        return [getattr(self, f"layer{i + 1}") for i in range(self.n_stages)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        block, card, scale = cfg["block"], cfg["card"], cfg["scale"]
        blur = cfg["blur"]
        if cfg["stem"] in _STEM_CHS:
            st = self.conv1
            x = _batch_norm(_conv(x, getattr(st, "0").weight, 2, 1),
                            getattr(st, "1"))
            x = _batch_norm(_conv(x, getattr(st, "3").weight, 1, 1),
                            getattr(st, "4"))
            x = _batch_norm(_conv(x, getattr(st, "6").weight, 1, 1),
                            self.bn1)
        else:
            x = _batch_norm(_conv(x, self.conv1.weight, 2, 3), self.bn1)
        # the stem's pool follows a ReLU: zero padding equals -inf padding
        if blur:
            x = _blur_pool(F.max_pool2d(x, 3, 1, 1), 2)
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        dci = 1 if cfg["down"] == "avg" else 0
        for si, stage in enumerate(self.stages()):
            for bi, blk in enumerate(stage):
                s = (1 if si == 0 else 2) if bi == 0 else 1
                shortcut = x
                if hasattr(blk, "downsample"):
                    w = getattr(blk.downsample, str(dci)).weight
                    if cfg["down"] == "avg":
                        d = _conv(F.avg_pool2d(x, 2, 2) if s == 2 else x, w)
                    elif w.shape[-1] == 3:
                        d = _conv(x, w, s, 1)
                    else:
                        d = _conv(x, w, s)
                    shortcut = _batch_norm(
                        d, getattr(blk.downsample, str(dci + 1)), act=False)
                if block == "res2":
                    y = _res2(blk, x, s, card, scale,
                              hasattr(blk, "downsample"))
                elif block == "bottleneck":
                    # anti-aliased: the strided conv runs at stride 1 and a
                    # BlurPool of that stride follows its BN + ReLU
                    aa = blur and s == 2
                    y = _batch_norm(_conv(x, blk.conv1.weight), blk.bn1)
                    y = _batch_norm(_conv(y, blk.conv2.weight, 1 if aa else s,
                                          1, card), blk.bn2)
                    if aa:
                        y = _blur_pool(y, s)
                    y = _batch_norm(_conv(y, blk.conv3.weight), blk.bn3,
                                    act=False)
                else:
                    # BasicBlock: the stride on conv1
                    aa = blur and s == 2
                    y = _batch_norm(_conv(x, blk.conv1.weight,
                                          1 if aa else s, 1), blk.bn1)
                    if aa:
                        y = _blur_pool(y, s)
                    y = _batch_norm(_conv(y, blk.conv2.weight, 1, 1),
                                    blk.bn2, act=False)
                if cfg["attn"] == "se":
                    y = _se_apply(y, blk.se)
                elif cfg["attn"] == "eca":
                    y = _eca_apply(y, blk.se)
                x = F.relu(y + shortcut)
        return x


def _res2(blk, x: torch.Tensor, s: int, card: int, scale: int,
          is_first: bool) -> torch.Tensor:
    """Bottle2neck: a hierarchical residual conv over `scale` width chunks
    of the expanded features; the first block of a stage pools its last
    chunk (AvgPool2d(3, s, pad 1), count_include_pad) instead."""
    width = blk.convs[0].weight.shape[0]
    y = _batch_norm(_conv(x, blk.conv1.weight), blk.bn1)
    spx = torch.split(y, width, dim=1)
    spo = []
    sp = spx[0]
    for i, (cv, bn) in enumerate(zip(blk.convs, blk.bns)):
        sp = spx[i] if (i == 0 or is_first) else sp + spx[i]
        sp = _batch_norm(_conv(sp, cv.weight, s, 1, card), bn)
        spo.append(sp)
    if scale > 1:
        spo.append(F.avg_pool2d(spx[-1], 3, s, 1) if is_first else spx[-1])
    y = torch.cat(spo, dim=1)
    return _batch_norm(_conv(y, blk.conv3.weight), blk.bn3, act=False)


# hybrid name -> (module factory, feature channels, stride): the hybrid
# stems are the deep-stem bottleneck avg-down ResNets and the R50 V2
HYBRIDS = {
    "r50_v2": (lambda device: ResNetV2R50(device), 1024, 16),
    "resnet26d": (lambda device: ResNet("resnet26d", 4, device=device),
                  2048, 32),
    "resnet50d": (lambda device: ResNet("resnet50d", 4, device=device),
                  2048, 32),
    "resnet50d_s3": (lambda device: ResNet("resnet50d", 3, device=device),
                     1024, 16),
}


def apply_backbone(m: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """NHWC images (B, H, W, 3) in the compute dtype -> NHWC features: the
    NCHW modules run on the channels-last view, nothing is copied."""
    return m(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# weights carried across from the JAX package's param tree
# ---------------------------------------------------------------------------

def _oihw(w) -> torch.Tensor:
    """An HWIO numpy kernel -> an OIHW f32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cb_sd(w, bn, conv_key: str, bn_prefix: str
           ) -> Dict[str, torch.Tensor]:
    """An HWIO kernel and its BN dict -> {conv_key: OIHW, bn_prefix*}."""
    return {conv_key: _oihw(w), **_norm_sd(bn, bn_prefix)}


def _norm_sd(p, prefix: str) -> Dict[str, torch.Tensor]:
    out = {prefix + "weight": _t(p["scale"]), prefix + "bias": _t(p["bias"])}
    if "mean" in p:
        out[prefix + "running_mean"] = _t(p["mean"])
        out[prefix + "running_var"] = _t(p["var"])
    return out


def resnetv2_r50_from_jax(p, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX package's init_resnetv2_r50 tree -> ResNetV2R50 names."""
    sd = {prefix + "stem.conv.weight": _oihw(p["stem"]["conv"]),
          **_norm_sd(p["stem"]["norm"], prefix + "stem.norm.")}
    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            base = f"{prefix}stages.{si}.blocks.{bi}."
            for ci in (1, 2, 3):
                sd[base + f"conv{ci}.weight"] = _oihw(blk[f"conv{ci}"])
                sd.update(_norm_sd(blk[f"norm{ci}"], base + f"norm{ci}."))
            if "down_conv" in blk:
                sd[base + "downsample.conv.weight"] = _oihw(blk["down_conv"])
                sd.update(_norm_sd(blk["down_norm"],
                                   base + "downsample.norm."))
    return sd


def resnet_from_jax(p, variant: str, prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's init_resnet tree -> ResNet names (the inverse of
    its load_resnet)."""
    cfg = resnet_cfg(variant)
    st = p["stem"]
    if cfg["stem"] in _STEM_CHS:
        sd = {prefix + "conv1.0.weight": _oihw(st["conv1"]),
              **_norm_sd(st["bn1"], prefix + "conv1.1."),
              prefix + "conv1.3.weight": _oihw(st["conv2"]),
              **_norm_sd(st["bn2"], prefix + "conv1.4."),
              prefix + "conv1.6.weight": _oihw(st["conv3"]),
              **_norm_sd(st["bn3"], prefix + "bn1.")}
    else:
        sd = {prefix + "conv1.weight": _oihw(st["conv1"]),
              **_norm_sd(st["bn1"], prefix + "bn1.")}
    dci = 1 if cfg["down"] == "avg" else 0
    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            base = f"{prefix}layer{si + 1}.{bi}."
            for name in ("conv1", "conv2", "conv3"):
                if name in blk:
                    sd[base + name + ".weight"] = _oihw(blk[name])
            for name in ("bn1", "bn2", "bn3"):
                if name in blk:
                    sd.update(_norm_sd(blk[name], base + name + "."))
            for i, w in enumerate(blk.get("convs", [])):
                sd[base + f"convs.{i}.weight"] = _oihw(w)
            for i, bn in enumerate(blk.get("bns", [])):
                sd.update(_norm_sd(bn, base + f"bns.{i}."))
            se = blk.get("se")
            if se is not None and cfg["attn"] == "eca":
                sd[base + "se.conv.weight"] = _t(se["conv"]).view(1, 1, -1)
            elif se is not None:
                rw, ew = np.asarray(se["reduce_w"]), np.asarray(se["expand_w"])
                sd[base + "se.fc1.weight"] = _t(rw.T)[:, :, None, None]
                sd[base + "se.fc1.bias"] = _t(se["reduce_b"])
                sd[base + "se.fc2.weight"] = _t(ew.T)[:, :, None, None]
                sd[base + "se.fc2.bias"] = _t(se["expand_b"])
            if "down_conv" in blk:
                sd[base + f"downsample.{dci}.weight"] = _oihw(blk["down_conv"])
                sd.update(_norm_sd(blk["down_bn"],
                                   base + f"downsample.{dci + 1}."))
    return sd
