"""The model zoo's factory: the port of vitcap_tpu/models/registry.py for
its ViT family (ViT, DeiT, distilled DeiT, the in21k checkpoints and the
CNN-stem hybrids), the ResNet family (models/backbones.py), T2T-ViT
(models/t2t_vit.py), the CNN families of part 2a (the EfficientNet
builder's nets in models/efficientnet.py: efficientnet, tf_efficientnet,
lite, CondConv, EdgeTPU, pruned, mnasnet, mobilenetv2, fbnetc, spnasnet;
MobileNetV3, MixNet, ReXNet, RegNet, NFNet and BiT ResNetV2) and those of
part 2b (legacy SENet, SKNet, ResNeSt, TResNet, SelecSLS, CSPNet, DPN,
DenseNet, DLA and VoVNet) and those of part 2c (HRNet, Inception-V3,
Inception-V4, Inception-ResNet-V2, Xception, the aligned Xceptions, Gluon's
Xception-65, NASNet-A-Large and PNASNet-5-Large): all 422 of the JAX
package's registered names.

    spec = model_spec("vit_large_patch16_384")
    m = create_model("vit_large_patch16_384", dtype=torch.bfloat16)
    tokens = m.apply(m.params, images)            # NHWC in, (B, 1+N, H)
    logits = m.apply(m.params, images, head=True)

A name no registry knows raises ValueError, as there.

The models are nn.Modules holding f32 parameters under the timm torch
state-dict names, built on the card unless the caller passes device="cpu"
(from an explicit torch.Generator; default seed 0 on that device), with
gradients off; `apply` computes in `dtype` (create_model's; f32 by
default, as in the JAX package).  The ViT's blocks go through
models/layers.py vit_block: a call that carries no gradient takes the
fused block (ops/fused_block.py, the gemm, layer_norm and attention
kernels on the card; past 1024 padded tokens the same composition, K10)
and the token axis is padded once for all blocks.  The patch embedding,
the final norm, the heads, the CNN families' convolutions (cuDNN) and
T2T are plain PyTorch, as the JAX package computes them outside any
Pallas kernel.  The CNNs' forwards give the NHWC feature map, or with
head=True the logits of its global average pool.

Train mode: model.train() (BatchNorm on batch statistics, the running
statistics updated, those on a pooled vector in SKNet and ResNeSt too)
and models/backbones.py zoo_train_mode (stochastic depth, head dropout,
masks from a caller's generator), as the JAX package's zoo_train_mode;
its own tests hold resnet, efficientnet, mobilenetv3, regnet, the BN
hybrid stems, resnest, sknet, dpn, tresnet, vovnet's EvoNorm and part
2c's BN layouts (no drop path or head dropout there) to it.

Checkpoints: load_timm_checkpoint / load_cnn_checkpoint /
load_t2t_vit_checkpoint and part 2's families' load_*_checkpoint read
a timm-layout torch state dict through solver/checkpoint_bridge.py
load_torch_state_dict (the ViT loader strips a 'module.' prefix, resizes
a pos-embed of another grid bicubically and keeps a zero qkv bias where
the checkpoint has none; the conv weights stay OIHW, the torch layout the
modules hold).  zoo_params_from_jax carries the JAX package's param trees
across (the tests hold the port to it so).

T2T's qk_scale (F5): as in the JAX package, loading a checkpoint keeps the
head-dim scale; only an explicit qk_scale= (a spec field, e.g.
create_model(name, qk_scale=embed ** -0.5) for the released weights)
overrides it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_block import pad_len
from ..solver.checkpoint_bridge import load_torch_state_dict
from .backbones import (HYBRIDS, RESNETS, ResNet, apply_backbone,
                        head_dropout, resnet_feature_channels,
                        resnet_from_jax, resnetv2_r50_from_jax, train_opts)
from .cspnet import CSPNETS, CspNet, cspnet_feature_channels, cspnet_from_jax
from .densenet import (DENSENETS, DenseNet, densenet_feature_channels,
                       densenet_from_jax)
from .dla import DLAS, Dla, dla_feature_channels, dla_from_jax
from .dpn import DPNS, Dpn, dpn_feature_channels, dpn_from_jax
from .efficientnet import (EFFICIENTNETS, GENERIC_EFFNETS, TF_EFFNETS,
                           EfficientNet, effnet_feature_channels,
                           effnet_from_jax)
from .gluon_xception import (GluonXception, gluon_xception_feature_channels,
                             gluon_xception_from_jax)
from .hrnet import HRNETS, HrNet, hrnet_feature_channels, hrnet_from_jax
from .inception_resnet_v2 import (INCEPTION_RESNET_V2_NAMES,
                                  InceptionResnetV2,
                                  inception_resnet_v2_feature_channels,
                                  inception_resnet_v2_from_jax)
from .inception_v3 import (INCEPTION_V3_NAMES, InceptionV3,
                           basic_convs_from_jax,
                           inception_v3_feature_channels)
from .inception_v4 import InceptionV4, inception_v4_feature_channels
from .mixnet import (MIXNETS, TF_MIXNETS, MixNet, mixnet_feature_channels,
                     mixnet_from_jax)
from .mobilenetv3 import (MOBILENETV3S, MobileNetV3, mn3_feature_channels,
                          mn3_from_jax)
from .nasnet import NasNet, nasnet_feature_channels, nasnet_from_jax
from .nfnet import NFNETS, NfNet, ScaledStdConv, nfnet_feature_channels, \
    nfnet_from_jax
from .pnasnet import PnasNet, pnasnet_feature_channels, pnasnet_from_jax
from .regnet import REGNETS, RegNet, regnet_feature_channels, regnet_from_jax
from .resnest import (RESNESTS, ResNest, resnest_feature_channels,
                      resnest_from_jax)
from .resnetv2 import (RESNETV2S, ResNetV2, resnetv2_feature_channels,
                       resnetv2_from_jax)
from .rexnet import REXNETS, ReXNet, rexnet_feature_channels, rexnet_from_jax
from .selecsls import (SELECSLS, SelecSls, selecsls_feature_channels,
                       selecsls_from_jax)
from .senet import SENETS, SeNet, senet_feature_channels, senet_from_jax
from .sknet import SKNETS, SkNet, sknet_feature_channels, sknet_from_jax
from .tresnet import (TRESNETS, TResNet, tresnet_feature_channels,
                      tresnet_from_jax)
from .vovnet import (VOVNETS, EvoNormS0, VovNet, vovnet_feature_channels,
                     vovnet_from_jax)
from .xception import Xception, xception_feature_channels, xception_from_jax
from .xception_aligned import (XCEPTION_ALIGNED, XceptionAligned,
                               xception_aligned_feature_channels,
                               xception_aligned_from_jax)
from .layers import (ViTBlock, _Group, _pos_embed_for, dense,
                     interpolate_pos_embed, layer_norm, patch_embed,
                     vit_block)
from .t2t_vit import (T2T_VITS, T2TViT, TokenPerformer, sinusoid_pos_embed,
                      t2t_feature_dim, t2t_vit_from_jax)

_REGISTRY: Dict[str, Callable] = {}


@dataclasses.dataclass(frozen=True)
class VisionModelSpec:
    """Static ViT description (the ViT hyperparameter grid)."""
    name: str
    patch_size: int
    hidden_size: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    img_size: int = 224
    ln_eps: float = 1e-6
    num_classes: int = 1000
    distilled: bool = False        # DeiT distillation token after CLS, a
                                   # grid + 2 pos-embed, head_dist averaged
                                   # with head
    representation_size: int = 0   # in21k: pre_logits Linear + tanh
    qkv_bias: bool = True          # old-timm small has none: a zero bias
    hybrid: str = ""               # a CNN stem (a key of HYBRIDS)

    @property
    def intermediate_size(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def num_lead_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def grid(self) -> int:
        if self.hybrid:
            return self.img_size // HYBRIDS[self.hybrid][2]
        return self.img_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class CnnModelSpec:
    """A standalone ResNet-family classifier (global-avg-pool head)."""
    name: str
    variant: str                   # key of backbones.RESNETS
    num_classes: int = 1000
    img_size: int = 224            # default cfg only; any size runs

    @property
    def feature_channels(self) -> int:
        return resnet_feature_channels(self.variant)


@dataclasses.dataclass(frozen=True)
class T2tVitModelSpec:
    """A T2T-ViT classifier."""
    name: str
    variant: str                   # key of t2t_vit.T2T_VITS
    num_classes: int = 1000
    img_size: int = 224
    qk_scale: float = 0.0          # 0: head_dim ** -0.5 (F5: a checkpoint
                                   # load keeps it)

    @property
    def feature_channels(self) -> int:
        return t2t_feature_dim(self.variant)


@dataclasses.dataclass(frozen=True)
class _PooledCnnSpec:
    """A CNN classifier of part 2: its feature map, global-average pooled
    into the family's head."""
    name: str
    variant: str
    num_classes: int = 1000
    img_size: int = 224            # default cfg only; any size runs

    @property
    def feature_channels(self) -> int:
        return self._feature_channels(self.variant)


@dataclasses.dataclass(frozen=True)
class EffNetModelSpec(_PooledCnnSpec):
    """An EfficientNet-builder classifier (key of efficientnet.py's
    EFFICIENTNETS, GENERIC_EFFNETS or TF_EFFNETS)."""
    _feature_channels = staticmethod(effnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class Mn3ModelSpec(_PooledCnnSpec):
    """A MobileNetV3 classifier (key of mobilenetv3.MOBILENETV3S)."""
    _feature_channels = staticmethod(mn3_feature_channels)


@dataclasses.dataclass(frozen=True)
class MixNetModelSpec(_PooledCnnSpec):
    """A MixNet classifier (key of mixnet.MIXNETS or TF_MIXNETS)."""
    _feature_channels = staticmethod(mixnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class RexNetModelSpec(_PooledCnnSpec):
    """A ReXNetV1 classifier (key of rexnet.REXNETS)."""
    _feature_channels = staticmethod(rexnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class RegNetModelSpec(_PooledCnnSpec):
    """A RegNet classifier (key of regnet.REGNETS)."""
    _feature_channels = staticmethod(regnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class NfNetModelSpec(_PooledCnnSpec):
    """A Normalizer-Free classifier (key of nfnet.NFNETS)."""
    _feature_channels = staticmethod(nfnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class ResNetV2ModelSpec(_PooledCnnSpec):
    """A ResNetV2 / BiT classifier (key of resnetv2.RESNETV2S)."""
    img_size: int = 480
    _feature_channels = staticmethod(resnetv2_feature_channels)


@dataclasses.dataclass(frozen=True)
class SelecSlsModelSpec(_PooledCnnSpec):
    """A SelecSLS classifier (key of selecsls.SELECSLS)."""
    _feature_channels = staticmethod(selecsls_feature_channels)


@dataclasses.dataclass(frozen=True)
class SeNetModelSpec(_PooledCnnSpec):
    """A legacy SENet classifier (key of senet.SENETS)."""
    _feature_channels = staticmethod(senet_feature_channels)


@dataclasses.dataclass(frozen=True)
class SkNetModelSpec(_PooledCnnSpec):
    """A Selective-Kernel ResNet classifier (key of sknet.SKNETS)."""
    _feature_channels = staticmethod(sknet_feature_channels)


@dataclasses.dataclass(frozen=True)
class ResNestModelSpec(_PooledCnnSpec):
    """A ResNeSt classifier (key of resnest.RESNESTS)."""
    _feature_channels = staticmethod(resnest_feature_channels)


@dataclasses.dataclass(frozen=True)
class TResNetModelSpec(_PooledCnnSpec):
    """A TResNet classifier (key of tresnet.TRESNETS; the _448 names
    default to 448 px)."""
    _feature_channels = staticmethod(tresnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class CspNetModelSpec(_PooledCnnSpec):
    """A CSPNet / DarkNet classifier (key of cspnet.CSPNETS)."""
    img_size: int = 256
    _feature_channels = staticmethod(cspnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class DpnModelSpec(_PooledCnnSpec):
    """A Dual-Path-Network classifier (key of dpn.DPNS)."""
    _feature_channels = staticmethod(dpn_feature_channels)


@dataclasses.dataclass(frozen=True)
class DenseNetModelSpec(_PooledCnnSpec):
    """A DenseNet classifier (key of densenet.DENSENETS)."""
    _feature_channels = staticmethod(densenet_feature_channels)


@dataclasses.dataclass(frozen=True)
class DlaModelSpec(_PooledCnnSpec):
    """A Deep-Layer-Aggregation classifier (key of dla.DLAS)."""
    _feature_channels = staticmethod(dla_feature_channels)


@dataclasses.dataclass(frozen=True)
class VovNetModelSpec(_PooledCnnSpec):
    """A VoVNet classifier (key of vovnet.VOVNETS)."""
    _feature_channels = staticmethod(vovnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class HrNetModelSpec(_PooledCnnSpec):
    """An HRNet classifier (key of hrnet.HRNETS)."""
    _feature_channels = staticmethod(hrnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class XcepAlignedModelSpec(_PooledCnnSpec):
    """An aligned Xception 41 / 65 / 71 classifier (key of
    xception_aligned.XCEPTION_ALIGNED)."""
    img_size: int = 299
    _feature_channels = staticmethod(xception_aligned_feature_channels)


@dataclasses.dataclass(frozen=True)
class _GraphCnnSpec:
    """A CNN classifier of part 2c with one graph for all its names (the
    names are weight flavours): no variant field, as in the JAX package;
    the module is built from the name."""
    name: str
    num_classes: int = 1000
    img_size: int = 299

    @property
    def variant(self) -> str:
        return self.name

    @property
    def feature_channels(self) -> int:
        return self._feature_channels(self.name)


@dataclasses.dataclass(frozen=True)
class InceptionV3ModelSpec(_GraphCnnSpec):
    """An Inception-V3 classifier (inception_v3.INCEPTION_V3_NAMES)."""
    name: str = "inception_v3"
    _feature_channels = staticmethod(inception_v3_feature_channels)


@dataclasses.dataclass(frozen=True)
class InceptionV4ModelSpec(_GraphCnnSpec):
    """The Inception-V4 classifier."""
    name: str = "inception_v4"
    _feature_channels = staticmethod(inception_v4_feature_channels)


@dataclasses.dataclass(frozen=True)
class InceptionResnetV2ModelSpec(_GraphCnnSpec):
    """An Inception-ResNet-V2 classifier
    (inception_resnet_v2.INCEPTION_RESNET_V2_NAMES)."""
    name: str = "inception_resnet_v2"
    _feature_channels = staticmethod(inception_resnet_v2_feature_channels)


@dataclasses.dataclass(frozen=True)
class XceptionModelSpec(_GraphCnnSpec):
    """The Xception classifier."""
    name: str = "xception"
    _feature_channels = staticmethod(xception_feature_channels)


@dataclasses.dataclass(frozen=True)
class GluonXceptionModelSpec(_GraphCnnSpec):
    """Gluon's aligned Xception-65 classifier."""
    name: str = "gluon_xception65"
    _feature_channels = staticmethod(gluon_xception_feature_channels)


@dataclasses.dataclass(frozen=True)
class NASNetModelSpec(_GraphCnnSpec):
    """The NASNet-A-Large classifier (1001 classes: the Cadene
    checkpoints' background class)."""
    name: str = "nasnetalarge"
    num_classes: int = 1001
    img_size: int = 331
    _feature_channels = staticmethod(nasnet_feature_channels)


@dataclasses.dataclass(frozen=True)
class PNASNetModelSpec(_GraphCnnSpec):
    """The PNASNet-5-Large classifier (1001 classes)."""
    name: str = "pnasnet5large"
    num_classes: int = 1001
    img_size: int = 331
    _feature_channels = staticmethod(pnasnet_feature_channels)


# spec class -> (module class, JAX tree converter, head name, 1x1-conv
# head)
_POOLED = {
    EffNetModelSpec: (EfficientNet, effnet_from_jax, "classifier", False),
    Mn3ModelSpec: (MobileNetV3, mn3_from_jax, "classifier", False),
    MixNetModelSpec: (MixNet, mixnet_from_jax, "classifier", False),
    RexNetModelSpec: (ReXNet, rexnet_from_jax, "head.fc", False),
    RegNetModelSpec: (RegNet, regnet_from_jax, "head.fc", False),
    NfNetModelSpec: (NfNet, nfnet_from_jax, "head.fc", False),
    ResNetV2ModelSpec: (ResNetV2, resnetv2_from_jax, "head.fc", True),
    SelecSlsModelSpec: (SelecSls, selecsls_from_jax, "fc", False),
    SeNetModelSpec: (SeNet, senet_from_jax, "last_linear", False),
    SkNetModelSpec: (SkNet, sknet_from_jax, "fc", False),
    ResNestModelSpec: (ResNest, resnest_from_jax, "fc", False),
    TResNetModelSpec: (TResNet, tresnet_from_jax, "head.fc", False),
    CspNetModelSpec: (CspNet, cspnet_from_jax, "head.fc", False),
    DpnModelSpec: (Dpn, dpn_from_jax, "classifier", True),
    DenseNetModelSpec: (DenseNet, densenet_from_jax, "classifier", False),
    DlaModelSpec: (Dla, dla_from_jax, "fc", True),
    VovNetModelSpec: (VovNet, vovnet_from_jax, "head.fc", False),
    HrNetModelSpec: (HrNet, hrnet_from_jax, "classifier", False),
    InceptionV3ModelSpec: (InceptionV3, basic_convs_from_jax, "fc", False),
    InceptionV4ModelSpec: (InceptionV4, basic_convs_from_jax,
                           "last_linear", False),
    InceptionResnetV2ModelSpec: (InceptionResnetV2,
                                 inception_resnet_v2_from_jax, "classif",
                                 False),
    XceptionModelSpec: (Xception, xception_from_jax, "fc", False),
    XcepAlignedModelSpec: (XceptionAligned, xception_aligned_from_jax,
                           "head.fc", False),
    GluonXceptionModelSpec: (GluonXception, gluon_xception_from_jax, "fc",
                             False),
    NASNetModelSpec: (NasNet, nasnet_from_jax, "last_linear", False),
    PNASNetModelSpec: (PnasNet, pnasnet_from_jax, "last_linear", False),
}


def register_model(fn: Callable):
    """Registers fn.__name__ as a model name, fn(**kw) making its spec (timm's
    @register_model)."""
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models() -> list:
    return sorted(_REGISTRY)


def is_model(name: str) -> bool:
    return name in _REGISTRY


def model_spec(name: str, **kw):
    if name in _REGISTRY:
        return _REGISTRY[name](**kw)
    raise ValueError(f"unknown model '{name}'; known: "
                     f"{', '.join(list_models())}")


# ---------------------------------------------------------------------------
# the ViT / DeiT grid
# ---------------------------------------------------------------------------

_VITS = {  # name: (patch, hidden, depth, heads, {img and other fields})
    "vit_tiny_patch16_224": (16, 192, 12, 3, {}),
    # the old-timm "small": embed 768, depth 8, heads 8, mlp 3, no qkv
    # bias, LayerNorm eps 1e-5
    "vit_small_patch16_224": (16, 768, 8, 8, dict(
        mlp_ratio=3.0, qkv_bias=False, ln_eps=1e-5)),
    "vit_small_patch16_384": (16, 384, 12, 6, dict(img=384)),
    "vit_base_patch16_224": (16, 768, 12, 12, {}),
    "vit_base_patch16_384": (16, 768, 12, 12, dict(img=384)),
    "vit_base_patch32_224": (32, 768, 12, 12, {}),
    "vit_base_patch32_384": (32, 768, 12, 12, dict(img=384)),
    "vit_large_patch16_224": (16, 1024, 24, 16, {}),
    "vit_large_patch16_384": (16, 1024, 24, 16, dict(img=384)),
    "vit_large_patch32_384": (32, 1024, 24, 16, dict(img=384)),
    "vit_large_patch32_224": (32, 1024, 24, 16, {}),
    "deit_tiny_patch16_224": (16, 192, 12, 3, {}),
    "deit_small_patch16_224": (16, 384, 12, 6, {}),
    "deit_base_patch16_224": (16, 768, 12, 12, {}),
    "deit_base_patch16_384": (16, 768, 12, 12, dict(img=384)),
    # ImageNet-21k checkpoints: the pre_logits representation head
    "vit_base_patch16_224_in21k": (16, 768, 12, 12, dict(
        representation_size=768, num_classes=21843)),
    "vit_base_patch32_224_in21k": (32, 768, 12, 12, dict(
        representation_size=768, num_classes=21843)),
    "vit_large_patch16_224_in21k": (16, 1024, 24, 16, dict(
        representation_size=1024, num_classes=21843)),
    "vit_large_patch32_224_in21k": (32, 1024, 24, 16, dict(
        representation_size=1024, num_classes=21843)),
    "vit_huge_patch14_224_in21k": (14, 1280, 32, 16, dict(
        representation_size=1280, num_classes=21843)),
    # hybrid CNN-stem ViTs (stems in models/backbones.py)
    "vit_base_resnet50_224_in21k": (16, 768, 12, 12, dict(
        hybrid="r50_v2", representation_size=768, num_classes=21843)),
    "vit_base_resnet50_384": (16, 768, 12, 12, dict(img=384,
                                                     hybrid="r50_v2")),
    "vit_small_resnet26d_224": (32, 768, 8, 8, dict(mlp_ratio=3.0,
                                                    hybrid="resnet26d")),
    "vit_small_resnet50d_s3_224": (16, 768, 8, 8, dict(
        mlp_ratio=3.0, hybrid="resnet50d_s3")),
    "vit_base_resnet26d_224": (32, 768, 12, 12, dict(hybrid="resnet26d")),
    "vit_base_resnet50d_224": (32, 768, 12, 12, dict(hybrid="resnet50d")),
    # the reference zoo's deit names, distilled ones included
    "vit_deit_tiny_patch16_224": (16, 192, 12, 3, {}),
    "vit_deit_small_patch16_224": (16, 384, 12, 6, {}),
    "vit_deit_base_patch16_224": (16, 768, 12, 12, {}),
    "vit_deit_base_patch16_384": (16, 768, 12, 12, dict(img=384)),
    "vit_deit_tiny_distilled_patch16_224": (16, 192, 12, 3, dict(
        distilled=True)),
    "vit_deit_small_distilled_patch16_224": (16, 384, 12, 6, dict(
        distilled=True)),
    "vit_deit_base_distilled_patch16_224": (16, 768, 12, 12, dict(
        distilled=True)),
    "vit_deit_base_distilled_patch16_384": (16, 768, 12, 12, dict(
        img=384, distilled=True)),
}


def _register_family(names, make):
    for name in names:
        spec_fn = make(name)
        spec_fn.__name__ = name
        register_model(spec_fn)


def _vit_spec_fn(name):
    patch, hidden, depth, heads, extra = _VITS[name]
    fields = dict(extra)
    img = fields.pop("img", 224)

    def spec_fn(**kw):
        return VisionModelSpec(name=name, patch_size=patch,
                               hidden_size=hidden, depth=depth,
                               num_heads=heads, img_size=img,
                               **{**fields, **kw})
    return spec_fn


def _cnn_spec_fn(name):
    def spec_fn(**kw):
        return CnnModelSpec(name=name, variant=name, **kw)
    return spec_fn


def _t2t_spec_fn(name):
    # the reference registers capitalised names (T2t_vit_t_14) too
    variant = "t2t" + name[3:]

    def spec_fn(**kw):
        kw.setdefault("img_size", 224)
        return T2tVitModelSpec(name=variant, variant=variant, **kw)
    return spec_fn


def _pooled_spec_fn(cls, img, **defaults):
    def make(name):
        def spec_fn(**kw):
            kw.setdefault("img_size", img)
            for k, v in defaults.items():
                kw.setdefault(k, v)
            return cls(name=name, variant=name, **kw)
        return spec_fn
    return make


def _graph_spec_fn(cls):
    """The spec class's own defaults (image size, classes) stand."""
    def make(name):
        def spec_fn(**kw):
            return cls(name=name, **kw)
        return spec_fn
    return make


_register_family(_VITS, _vit_spec_fn)
_register_family(RESNETS, _cnn_spec_fn)
_register_family([n for v in T2T_VITS for n in (v, "T2t" + v[3:])],
                 _t2t_spec_fn)
for _name, _cfg in EFFICIENTNETS.items():
    _register_family([_name], _pooled_spec_fn(EffNetModelSpec, _cfg[2]))
_register_family(GENERIC_EFFNETS, _pooled_spec_fn(EffNetModelSpec, 224))
for _name, (_, _img) in TF_EFFNETS.items():
    _register_family([_name], _pooled_spec_fn(EffNetModelSpec, _img))
for _name, _cfg in MOBILENETV3S.items():
    _register_family([_name], _pooled_spec_fn(Mn3ModelSpec, _cfg[1]))
_register_family([*MIXNETS, *TF_MIXNETS],
                 _pooled_spec_fn(MixNetModelSpec, 224))
_register_family(REXNETS, _pooled_spec_fn(RexNetModelSpec, 224))
_register_family(REGNETS, _pooled_spec_fn(RegNetModelSpec, 224))
_register_family(NFNETS, _pooled_spec_fn(NfNetModelSpec, 224))
for _name, (_, _, _nc) in RESNETV2S.items():
    _register_family([_name], _pooled_spec_fn(ResNetV2ModelSpec, 480,
                                              num_classes=_nc))
for _names, _cls in ((SELECSLS, SelecSlsModelSpec), (SENETS, SeNetModelSpec),
                     (SKNETS, SkNetModelSpec), (RESNESTS, ResNestModelSpec),
                     (DPNS, DpnModelSpec), (DENSENETS, DenseNetModelSpec),
                     (DLAS, DlaModelSpec), (VOVNETS, VovNetModelSpec)):
    _register_family(_names, _pooled_spec_fn(_cls, 224))
_register_family(CSPNETS, _pooled_spec_fn(CspNetModelSpec, 256))
for _name in TRESNETS:
    _register_family([_name], _pooled_spec_fn(
        TResNetModelSpec, 448 if _name.endswith("_448") else 224))
_register_family(HRNETS, _pooled_spec_fn(HrNetModelSpec, 224))
_register_family(XCEPTION_ALIGNED, _pooled_spec_fn(XcepAlignedModelSpec, 299))
for _names, _cls in ((INCEPTION_V3_NAMES, InceptionV3ModelSpec),
                     (("inception_v4",), InceptionV4ModelSpec),
                     (INCEPTION_RESNET_V2_NAMES, InceptionResnetV2ModelSpec),
                     (("xception",), XceptionModelSpec),
                     (("gluon_xception65",), GluonXceptionModelSpec),
                     (("nasnetalarge",), NASNetModelSpec),
                     (("pnasnet5large",), PNASNetModelSpec)):
    _register_family(_names, _graph_spec_fn(_cls))


# ---------------------------------------------------------------------------
# modules and their initialisation
# ---------------------------------------------------------------------------

class VisionModel(NamedTuple):
    spec: object
    params: nn.Module
    apply: Callable[..., torch.Tensor]


class VisionTransformer(nn.Module):
    """The timm ViT's parameters: patch_embed (.proj, and .backbone for a
    hybrid), cls_token (dist_token), pos_embed, blocks, norm (pre_logits.fc,
    head, head_dist)."""

    def __init__(self, spec: VisionModelSpec, device=None):
        super().__init__()
        h, p = spec.hidden_size, spec.patch_size
        if spec.hybrid:
            make, feat_c, _ = HYBRIDS[spec.hybrid]
            self.patch_embed = _Group(backbone=make(device),
                                      proj=nn.Conv2d(feat_c, h, 1,
                                                     device=device))
        else:
            self.patch_embed = _Group(proj=nn.Conv2d(3, h, p, stride=p,
                                                     device=device))
        self.cls_token = nn.Parameter(torch.empty(1, 1, h, device=device))
        if spec.distilled:
            self.dist_token = nn.Parameter(torch.empty(1, 1, h,
                                                       device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            1, spec.grid ** 2 + spec.num_lead_tokens, h, device=device))
        self.blocks = nn.ModuleList(ViTBlock(h, spec.intermediate_size,
                                             device)
                                    for _ in range(spec.depth))
        self.norm = nn.LayerNorm(h, eps=spec.ln_eps, device=device)
        if spec.representation_size:
            self.pre_logits = _Group(fc=nn.Linear(
                h, spec.representation_size, device=device))
        if spec.num_classes:
            self.head = nn.Linear(spec.representation_size or h,
                                  spec.num_classes, device=device)
            if spec.distilled:
                self.head_dist = nn.Linear(h, spec.num_classes,
                                           device=device)


def _fill_(t: torch.Tensor, generator: torch.Generator, kind: str,
           std: float = 0.0) -> None:
    """Fill t from generator (values drawn on the generator's device):
    'trunc_normal' std `std` (0.02 by default) cut at +-2 sigma, 'kaiming'
    normal with std
    sqrt(2 / fan_out) (an OIHW kernel), 'normal' with std `std`,
    'uniform' in +-1 / sqrt(k) (a 1-d conv of width k)."""
    v = (t if t.device == generator.device
         else torch.empty(t.shape, device=generator.device))
    if kind == "trunc_normal":
        std = std or 0.02
        nn.init.trunc_normal_(v, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    elif kind == "kaiming":
        fan_out = t.shape[0] * math.prod(t.shape[2:])
        v.normal_(generator=generator).mul_(math.sqrt(2.0 / fan_out))
    elif kind == "normal":
        v.normal_(generator=generator).mul_(std)
    else:
        bound = 1.0 / math.sqrt(t.shape[-1])
        v.uniform_(-bound, bound, generator=generator)
    if v is not t:
        t.copy_(v)


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d, EvoNormS0)


@torch.no_grad()
def _init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init rules (its init_vision_params, init_resnet,
    init_t2t_vit and part 2's init_*): unit norms with zero shifts (zero
    scales where the JAX package zero-inits a block's last BN) and
    BatchNorm running statistics (0, 1); zero biases and unit NFNet
    gains; truncated normal linears, pos-embeds and the ViT's patch
    projection; kaiming-normal (fan out) convs, a depthwise one's fan out
    k * k; CondConv experts normal with their std; ECA kernels uniform;
    zero ViT cls/dist tokens, truncated normal T2T ones; T2T's sinusoid
    pos-embed and each performer's orthogonal w times sqrt(m); EvoNorm's
    v at one; the inceptions' BasicConv2d kernels truncated normal with
    their trunc_std, Inception-ResNet-V2's scale convs normal.  Random
    values come from `generator`, not the JAX streams."""
    vit_proj = (model.patch_embed.proj
                if isinstance(model, VisionTransformer) else None)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
        for name, prm in mod.named_parameters(recurse=False):
            if isinstance(mod, _NORMS):
                prm.fill_(1.0 if name in ("weight", "v") and not getattr(
                    mod, "zero_init", False) else 0.0)
            elif name == "gain" and isinstance(mod, ScaledStdConv):
                prm.fill_(1.0)
            elif name == "bias":
                prm.zero_()
            elif hasattr(mod, "init_std"):
                _fill_(prm, generator, "normal", mod.init_std)
            elif hasattr(mod, "trunc_std"):
                _fill_(prm, generator, "trunc_normal", mod.trunc_std)
            elif isinstance(mod, TokenPerformer) and name == "w":
                v = torch.empty(prm.shape, device=generator.device)
                nn.init.orthogonal_(v, generator=generator)
                prm.copy_(v * math.sqrt(prm.shape[0]))
            elif isinstance(mod, T2TViT) and name == "pos_embed":
                prm.copy_(sinusoid_pos_embed(prm.shape[1], prm.shape[2]))
            elif isinstance(mod, VisionTransformer) and name in (
                    "cls_token", "dist_token"):
                prm.zero_()
            elif isinstance(mod, nn.Conv1d):
                _fill_(prm, generator, "uniform")
            elif (isinstance(mod, nn.Conv2d) and mod.groups > 1
                  and mod.groups == mod.out_channels):
                # depthwise: fan_out k * k (the goog init divides by groups)
                _fill_(prm, generator, "normal",
                       math.sqrt(2.0 / math.prod(mod.kernel_size)))
            elif isinstance(mod, nn.Conv2d) and mod is not vit_proj:
                _fill_(prm, generator, "kaiming")
            else:
                _fill_(prm, generator, "trunc_normal")
    return model.requires_grad_(False).eval()


def _build(make: Callable[[object], nn.Module], device,
           generator: Optional[torch.Generator]) -> nn.Module:
    """make(device) on the meta device, moved to `device` and filled."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return _init_(make("meta").to_empty(device=device), generator)


def init_vision_params(spec: VisionModelSpec,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> VisionTransformer:
    return _build(lambda d: VisionTransformer(spec, d), device, generator)


def init_cnn_params(spec: CnnModelSpec,
                    generator: Optional[torch.Generator] = None,
                    device="cuda", n_stages: int = 4) -> ResNet:
    """A ResNet with an `fc` head of spec.num_classes (none at 0);
    n_stages < 4 cuts the stages (a reduced-depth check)."""
    return _build(lambda d: ResNet(spec.variant, n_stages, spec.num_classes,
                                   d), device, generator)


def init_t2t_vit_params(spec: T2tVitModelSpec,
                        generator: Optional[torch.Generator] = None,
                        device="cuda", depth: int = 0) -> T2TViT:
    """depth > 0 cuts the body's blocks (a reduced-depth check)."""
    return _build(lambda d: T2TViT(spec.variant, spec.num_classes, depth, d),
                  device, generator)


def init_pooled_cnn_params(spec,
                           generator: Optional[torch.Generator] = None,
                           device="cuda", n_stages: int = 0) -> nn.Module:
    """A part-2 CNN with its head of spec.num_classes (none at 0);
    n_stages > 0 keeps the first n_stages stages (a reduced-depth
    check)."""
    cls = _POOLED[type(spec)][0]
    return _build(lambda d: cls(spec.variant, spec.num_classes, n_stages,
                                d), device, generator)


init_effnet_params = init_mn3_params = init_mixnet_params = \
    init_rexnet_params = init_regnet_params = init_nfnet_params = \
    init_resnetv2_params = init_selecsls_params = init_senet_params = \
    init_sknet_params = init_resnest_params = init_tresnet_params = \
    init_cspnet_params = init_dpn_params = init_densenet_params = \
    init_dla_params = init_vovnet_params = init_hrnet_params = \
    init_inception_v3_params = init_inception_v4_params = \
    init_inception_resnet_v2_params = init_xception_params = \
    init_xception_aligned_params = init_gluon_xception_params = \
    init_nasnet_params = init_pnasnet_params = init_pooled_cnn_params


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def vit_forward(model: VisionTransformer, images: torch.Tensor,
                spec: VisionModelSpec, head: bool = False,
                return_attn: bool = False, dtype=torch.float32,
                token_drop: float = 0.0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
    """NHWC images -> patch tokens (the CNN stem and its 1x1 projection for
    a hybrid) -> lead tokens (CLS, the DeiT distillation token) + pos-embed
    (resized bicubically to another grid) -> blocks -> final norm; head=True
    pools CLS into logits (in21k: through pre_logits; distilled: the mean of
    head on CLS and head_dist on the distillation token), else all post-norm
    tokens.  return_attn=True also returns each block's softmax
    probabilities, (depth, B, heads, L, L) f32.  token_drop > 0 keeps
    ceil((L - lead) * (1 - token_drop)) patch tokens per image, in order:
    those of the smallest `noise` values ((B, L - lead) uniform draws,
    default from `generator`)."""
    lead = spec.num_lead_tokens
    x = images.to(dtype)
    if spec.hybrid:
        feats = apply_backbone(model.patch_embed.backbone, x)
        B, gh, gw, C = feats.shape
        proj = model.patch_embed.proj
        tokens = (feats.reshape(B, gh * gw, C)
                  @ proj.weight.view(-1, C).t().to(dtype) + proj.bias.to(dtype))
    else:
        tokens = patch_embed(model.patch_embed.proj, x)
    B, N, H = tokens.shape
    leads = [model.cls_token] + ([model.dist_token] if spec.distilled else [])
    x = torch.cat([t.to(tokens.dtype).expand(B, 1, H) for t in leads]
                  + [tokens], dim=1)
    x = x + _pos_embed_for(model, N, x.dtype, lead)
    if token_drop > 0.0:
        L = x.shape[1]
        n_keep = max(1, math.ceil((L - lead) * (1.0 - token_drop)))
        if noise is None:
            if generator is None:
                raise ValueError("token_drop needs a generator (or noise)")
            noise = torch.rand((B, L - lead), generator=generator,
                               device=generator.device)
        keep = torch.argsort(noise.to(x.device), dim=1,
                             stable=True)[:, :n_keep] + lead
        keep = keep.sort(dim=1).values
        x = torch.cat([x[:, :lead],
                       torch.gather(x, 1, keep[..., None].expand(-1, -1, H))],
                      dim=1)
    # the token axis padded once for every block (the fused blocks, the
    # split train blocks and the packed attention mask the padded keys)
    L = x.shape[1]
    pad = pad_len(L) - L if L >= 64 else 0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    attns = []
    for blk in model.blocks:
        if return_attn:
            attns.append(_block_attn_probs(blk, x[:, :L], spec))
        x = vit_block(blk, x, spec.num_heads, spec.ln_eps,
                      l_actual=L if pad else 0)
    x = layer_norm(model.norm, x[:, :L], spec.ln_eps)
    if head:
        if not spec.num_classes:
            raise ValueError(f"{spec.name}: head=True with num_classes=0")
        cls = x[:, 0]
        if spec.representation_size:
            cls = torch.tanh(dense(model.pre_logits.fc, cls))
        out = dense(model.head, cls)
        if spec.distilled:
            out = (out + dense(model.head_dist, x[:, 1])) / 2
    else:
        out = x
    if return_attn:
        return out, torch.stack(attns)
    return out


def _block_attn_probs(blk: ViTBlock, x: torch.Tensor,
                      spec: VisionModelSpec) -> torch.Tensor:
    """One block's softmax attention probabilities, (B, heads, L, L) f32
    (visualisation only: the forward never materialises them)."""
    B, L, H = x.shape
    nh = spec.num_heads
    hd = H // nh
    q, k, _ = dense(blk.attn.qkv, layer_norm(blk.norm1, x, spec.ln_eps)
                    ).chunk(3, dim=-1)
    qh = q.reshape(B, L, nh, hd).transpose(1, 2).float()
    kh = k.reshape(B, L, nh, hd).transpose(1, 2).float()
    return torch.softmax((qh @ kh.transpose(-1, -2)) * hd ** -0.5, dim=-1)


def cnn_forward(model: ResNet, images: torch.Tensor, spec: CnnModelSpec,
                head: bool = False, dtype=torch.float32) -> torch.Tensor:
    """head=False: the NHWC feature map; head=True: global average pool +
    fc logits (dropout before fc in train mode)."""
    x = apply_backbone(model, images.to(dtype))
    if not head:
        return x
    return dense(model.fc, head_dropout(x.mean(dim=(1, 2)),
                                        train_opts(model)))


def pooled_cnn_forward(model: nn.Module, images: torch.Tensor,
                       spec, head: bool = False,
                       dtype=torch.float32) -> torch.Tensor:
    """A part-2 CNN: head=False, the NHWC feature map (timm's
    forward_features); head=True, its global average pool through the
    family's head (mobilenetv3: conv_head and act first; dropout in train
    mode before the effnet, mobilenetv3 and regnet classifiers)."""
    x = apply_backbone(model, images.to(dtype))
    if not head:
        return x
    if not spec.num_classes:
        raise ValueError(f"{spec.name}: head=True with num_classes=0")
    return model.classify(x.mean(dim=(1, 2)))


effnet_forward = mn3_forward = mixnet_forward = rexnet_forward = \
    regnet_forward = nfnet_forward = resnetv2_forward = selecsls_forward = \
    senet_forward = sknet_forward = resnest_forward = tresnet_forward = \
    cspnet_forward = dpn_forward = densenet_forward = dla_forward = \
    vovnet_forward = hrnet_forward = inception_v3_forward = \
    inception_v4_forward = inception_resnet_v2_forward = \
    xception_forward = xception_aligned_forward = gluon_xception_forward = \
    nasnet_forward = pnasnet_forward = pooled_cnn_forward


def t2t_vit_forward(model: T2TViT, images: torch.Tensor,
                    spec: T2tVitModelSpec, head: bool = False,
                    dtype=torch.float32) -> torch.Tensor:
    """head=False: (B, 1 + N, D) post-norm tokens; head=True: CLS logits."""
    x = model(images.to(dtype).permute(0, 3, 1, 2), spec.qk_scale)
    if not head:
        return x
    return dense(model.head, x[:, 0])


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

def create_model(name: str, pretrained: bool = False,
                 checkpoint_path: Optional[str] = None,
                 img_size: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cuda", **spec_kw) -> VisionModel:
    """timm's factory: the named model with random weights from `generator`
    (default seed 0 on `device`), or a timm-layout torch checkpoint's
    (checkpoint_path; pretrained=True requires one: nothing is fetched).
    img_size, num_classes and any other spec field (spec_kw, e.g. T2T's
    qk_scale) override the spec.  Returns VisionModel(spec, params, apply):
    apply(params, images, head=False) computes in `dtype`."""
    spec = model_spec(name)
    if img_size is not None and img_size != spec.img_size:
        spec = dataclasses.replace(spec, img_size=img_size)
    if num_classes is not None:
        spec = dataclasses.replace(spec, num_classes=num_classes)
    if spec_kw:
        spec = dataclasses.replace(spec, **spec_kw)
    if pretrained and not checkpoint_path:
        raise ValueError("pretrained=True needs checkpoint_path (no "
                         "download)")
    if isinstance(spec, T2tVitModelSpec):
        init, load, fwd = (init_t2t_vit_params, load_t2t_vit_checkpoint,
                           t2t_vit_forward)
    elif type(spec) in _POOLED:
        init, load, fwd = (init_pooled_cnn_params,
                           load_pooled_cnn_checkpoint, pooled_cnn_forward)
    elif isinstance(spec, CnnModelSpec):
        init, load, fwd = init_cnn_params, load_cnn_checkpoint, cnn_forward
    else:
        init, load, fwd = init_vision_params, load_timm_checkpoint, vit_forward
    model = init(spec, generator, device)
    if checkpoint_path:
        load(model, checkpoint_path, spec)

    def apply(params, images, head=False):
        return fwd(params, images, spec, head=head, dtype=dtype)

    return VisionModel(spec=spec, params=model, apply=apply)


# ---------------------------------------------------------------------------
# timm torch checkpoints, and the JAX package's param trees
# ---------------------------------------------------------------------------

@torch.no_grad()
def load_zoo_state(model: nn.Module, sd: Dict[str, torch.Tensor],
                   optional=lambda name: False, convert=None) -> nn.Module:
    """Copy sd[name] (a state dict, or zoo_params_from_jax's) into each of
    model's parameters and buffers, in place (BatchNorm's
    num_batches_tracked aside).  A name missing from sd raises
    KeyError unless optional(name); convert(name, tensor, target) may
    reshape a tensor first; a shape that still differs raises ValueError."""
    for name, t in model.state_dict(keep_vars=True).items():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in sd:
            if optional(name):
                continue
            raise KeyError(f"checkpoint has no '{name}'")
        src = torch.as_tensor(sd[name])
        if convert is not None:
            src = convert(name, src, t)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"'{name}': checkpoint {tuple(src.shape)} vs "
                             f"model {tuple(t.shape)}")
        t.copy_(src)
    return model


def _resize_pos_embed(pe: torch.Tensor, lead: int, grid: int
                      ) -> torch.Tensor:
    """A (1, lead + g*g, H) pos-embed's grid resized to grid x grid."""
    old = int(round((pe.shape[1] - lead) ** 0.5))
    return interpolate_pos_embed(pe, (grid, grid), (old, old), lead)


def load_timm_checkpoint(model: VisionTransformer, path: str,
                         spec: VisionModelSpec) -> VisionTransformer:
    """A timm ViT torch state dict (hybrid stems under
    patch_embed.backbone.) into `model`, in place: a 'module.' prefix is
    stripped, a pos-embed of another grid is resized bicubically, an
    absent qkv bias (old-timm small) stays zero, absent heads (head,
    head_dist, pre_logits) keep their values."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in load_torch_state_dict(path).items()}

    def optional(name):
        return (name.split(".")[0] in ("head", "head_dist", "pre_logits")
                or name.endswith("attn.qkv.bias"))

    def convert(name, src, t):
        if name == "pos_embed" and src.shape != t.shape:
            return _resize_pos_embed(src.float(), spec.num_lead_tokens,
                                     spec.grid)
        return src

    return load_zoo_state(model, sd, optional, convert)


def load_cnn_checkpoint(model: ResNet, path: str,
                        spec: CnnModelSpec) -> ResNet:
    """A timm ResNet torch state dict (conv1..., layerN..., fc) into
    `model`, in place."""
    return load_zoo_state(model, load_torch_state_dict(path))


def load_pooled_cnn_checkpoint(model: nn.Module, path: str,
                               spec) -> nn.Module:
    """A timm torch state dict of a part-2 family (its forward_features'
    names, and its head's) into `model`, in place."""
    return load_zoo_state(model, load_torch_state_dict(path))


load_effnet_checkpoint = load_mn3_checkpoint = load_mixnet_checkpoint = \
    load_rexnet_checkpoint = load_regnet_checkpoint = \
    load_nfnet_checkpoint = load_resnetv2_checkpoint = \
    load_selecsls_checkpoint = load_senet_checkpoint = \
    load_sknet_checkpoint = load_resnest_checkpoint = \
    load_tresnet_checkpoint = load_cspnet_checkpoint = \
    load_dpn_checkpoint = load_densenet_checkpoint = load_dla_checkpoint = \
    load_vovnet_checkpoint = load_hrnet_checkpoint = \
    load_inception_v3_checkpoint = load_inception_v4_checkpoint = \
    load_inception_resnet_v2_checkpoint = load_xception_checkpoint = \
    load_xception_aligned_checkpoint = load_gluon_xception_checkpoint = \
    load_nasnet_checkpoint = load_pnasnet_checkpoint = \
    load_pooled_cnn_checkpoint


def load_t2t_vit_checkpoint(model: T2TViT, path: str,
                            spec: T2tVitModelSpec) -> T2TViT:
    """A T2T-ViT torch state dict into `model`, in place (the head only if
    the checkpoint has one).  The attention scale stays spec.qk_scale (F5:
    0, the head-dim scale, unless the caller asked for another)."""
    sd = load_torch_state_dict(path)
    return load_zoo_state(model, sd,
                       lambda n: n.startswith("head.") and "head.weight"
                       not in sd)


def zoo_params_from_jax(params_np, spec) -> Dict[str, torch.Tensor]:
    """The JAX package's param tree (numpy leaves) of a zoo model -> this
    port's state dict (f32 CPU tensors): linear kernels transposed to
    (out, in), HWIO kernels to OIHW, CondConv experts to their flat torch
    layout."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def lin(q, name):
        return {name + ".weight": t(np.asarray(q["kernel"]).T),
                name + ".bias": t(q["bias"])}

    def nrm(q, name):
        return {name + ".weight": t(q["scale"]), name + ".bias": t(q["bias"])}

    if type(spec) in _POOLED:
        _, from_jax, head, conv = _POOLED[type(spec)]
        sd = from_jax(params_np["backbone"])
        if "head" in params_np:
            sd.update(lin(params_np["head"], head))
            if conv:
                sd[head + ".weight"] = sd[head + ".weight"][:, :, None, None]
        return sd
    if isinstance(spec, CnnModelSpec):
        sd = resnet_from_jax(params_np["backbone"], spec.variant)
        if "head" in params_np:
            sd.update(lin(params_np["head"], "fc"))
        return sd
    if isinstance(spec, T2tVitModelSpec):
        sd = t2t_vit_from_jax(params_np["backbone"], spec.variant)
        if "head" in params_np:
            sd.update(lin(params_np["head"], "head"))
        return sd
    p = params_np
    kern = np.asarray(p["patch_proj"]["kernel"])
    sd = {"patch_embed.proj.weight": t(kern.transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": t(p["patch_proj"]["bias"]),
          "cls_token": t(p["cls_token"]), "pos_embed": t(p["pos_embed"]),
          **nrm(p["norm"], "norm")}
    for name in ("dist_token",):
        if name in p:
            sd[name] = t(p[name])
    for name, tname in (("pre_logits", "pre_logits.fc"), ("head", "head"),
                        ("head_dist", "head_dist")):
        if name in p:
            sd.update(lin(p[name], tname))
    for i, blk in enumerate(p["blocks"]):
        base = f"blocks.{i}."
        sd.update({**nrm(blk["norm1"], base + "norm1"),
                   **lin(blk["attn"]["qkv"], base + "attn.qkv"),
                   **lin(blk["attn"]["proj"], base + "attn.proj"),
                   **nrm(blk["norm2"], base + "norm2"),
                   **lin(blk["mlp"]["fc1"], base + "mlp.fc1"),
                   **lin(blk["mlp"]["fc2"], base + "mlp.fc2")})
    if spec.hybrid == "r50_v2":
        sd.update(resnetv2_r50_from_jax(p["backbone"],
                                        "patch_embed.backbone."))
    elif spec.hybrid:
        sd.update(resnet_from_jax(p["backbone"], "resnet26d",
                                  "patch_embed.backbone."))
    return sd

