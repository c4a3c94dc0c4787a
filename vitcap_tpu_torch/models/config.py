"""Static model configuration: the fields and defaults of
vitcap_tpu.models.config.ModelConfig, with the two dtype properties mapped
to torch dtypes.  `remat` has the TPU package's meaning (use_remat,
use_remat_fusion); train_fused_blocks trains the trunk through the
inference blocks with a recomputing backward, as there
(models/vitcap.py split_encoder, ops/fused_block.py
fused_vit_block_train).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # transformer dims (shared by ViT trunk and BERT decoder)
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_hidden_layers: int = 12          # ViT trunk depth
    decoder_layers: int = 4              # BERT multimodal decoder depth
    split_blocks: int = 4                # tag-branch fork size

    # vocab / embeddings
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    tag_vocab_size: int = 30522          # = vocab_size for category='bert'

    # image side
    img_size: int = 384
    patch_size: int = 16
    in_chans: int = 3

    # norms / activations
    bert_layer_norm_eps: float = 1e-12
    vit_layer_norm_eps: float = 1e-6

    # dropout
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.1

    # captioning specifics
    topk: int = 50                       # concept tokens kept
    max_seq_len: int = 70                # caption(20) + od/tag(50) at train
    max_seq_a_len: int = 20
    max_gen_length: int = 20
    max_masked_tokens: int = 3
    label_smoothing: float = 0.1
    sep_token_id: int = 102
    cls_token_id: int = 101
    pad_token_id: int = 0
    mask_token_id: int = 103
    tag_conf_threshold: float = 0.2      # tags with sigmoid>=0.2 counted

    # losses
    tag_loss: str = "focal"              # 'focal' | 'bce'
    focal_alpha: float = 0.5
    focal_gamma: float = 1.0
    tag_loss_weight: float = 0.0

    # attention-aware token filtering (opt-in): keep this share of the
    # patch tokens before trunk block token_filter_block
    token_filter_keep: float = 0.0
    token_filter_block: int = 2

    # wiring
    tagemb: str = "cls"                  # tag embeddings from tied weight
    tie_weights: bool = True
    tie_tag_weights: bool = False
    mask_type: str = "seq2seq"
    tag_attach: str = "raw"              # 'raw' | 'embedded'
    tag_pos_offset: int = 20

    # numerics
    dtype: str = "float32"               # compute dtype: 'float32' | 'bfloat16'
    scores_dtype: str = "auto"           # 'auto' = compute dtype, 'f32' = exact
    remat: Any = "auto"                  # True | False | 'auto' | 'fusion'
    train_fused_blocks: bool = False     # trunk: inference kernels + recompute
    kv_cache_quant: str = "none"         # 'none' | 'int8' (eager engine)

    def __post_init__(self):
        if self.split_blocks > self.num_hidden_layers:
            raise ValueError(
                f"split_blocks={self.split_blocks} exceeds trunk depth "
                f"{self.num_hidden_layers} (the tag branch forks off the "
                f"last split_blocks trunk layers)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def use_remat(self) -> bool:
        """Recompute each trunk block in the backward (and each fusion
        layer, see use_remat_fusion).  'auto' is False: the train blocks'
        attention backward recomputes the probabilities from the slab and
        never stores them, so the residuals of a flagship step fit the
        card, as on the TPU when its kernel backward is active.  'fusion'
        leaves the trunk alone."""
        if self.remat in ("auto", "fusion"):
            return False
        return bool(self.remat)

    @property
    def use_remat_fusion(self) -> bool:
        """Remat of the fusion decoder's layers: use_remat, or 'fusion'
        (the SCST scoring recipe)."""
        return self.use_remat or self.remat == "fusion"

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_visual_tokens(self) -> int:
        return self.num_patches + 1      # + CLS

    @property
    def decoder_seq_len(self) -> int:
        """text + tagger-CLS + visual."""
        return self.max_seq_len + 1 + self.num_visual_tokens

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def attention_scores_dtype(self) -> Optional[torch.dtype]:
        """None = f32/exact (the mha default); bf16 when opted in."""
        if self.scores_dtype == "auto":
            return torch.bfloat16 if self.dtype == "bfloat16" else None
        return None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def save_pretrained(self, save_directory: str) -> str:
        os.makedirs(save_directory, exist_ok=True)
        path = os.path.join(save_directory, "config.json")
        with open(path, "w") as f:
            f.write(self.to_json_string())
        return path

    @classmethod
    def from_pretrained(cls, path: str, **overrides) -> "ModelConfig":
        """`path` is a directory holding config.json or the file itself;
        unknown keys are ignored and `overrides` win over the file."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in known}
        kw.update(overrides)
        return cls(**kw)


def vit_trunk(image_encoder_type: str
              ) -> Tuple[int, Optional[int], Optional[int]]:
    """(patch_size, hidden_size, depth) of a 'VitEmb_<timm name>' trunk, by
    the JAX pipeline's rule (vitcap_tpu/pipelines/caption_pipeline.py
    model_cfg): a name of the model zoo (models/registry.py) gives its
    spec's patch, width and depth; any other name patch 32 if it says
    'patch32', else 16, and no width or depth (the json's stand).  A zoo
    name that is no ViT (a CNN of part 1 or 2) raises ValueError."""
    from . import registry as R
    name = image_encoder_type.split("VitEmb_")[-1]
    if R.is_model(name):
        spec = R.model_spec(name)
        if not isinstance(spec, R.VisionModelSpec):
            raise ValueError(f"image_encoder_type {image_encoder_type!r}: "
                             f"{name} is no ViT trunk")
        return spec.patch_size, spec.hidden_size, spec.depth
    return (32 if "patch32" in image_encoder_type else 16), None, None


def tiny_config(**kw) -> ModelConfig:
    """Small config for tests."""
    base = dict(
        hidden_size=32, num_attention_heads=4, intermediate_size=128,
        num_hidden_layers=4, decoder_layers=2, split_blocks=2,
        vocab_size=128, tag_vocab_size=128, max_position_embeddings=96,
        img_size=32, patch_size=16, topk=5, max_seq_len=16, max_seq_a_len=6,
        max_gen_length=6, attention_probs_dropout_prob=0.0,
    )
    base.update(kw)
    return ModelConfig(**base)
