"""ViTCAP model: split-ViT encoder + concept-token branch + BERT fusion
decoder, the inference half of vitcap_tpu/models/vitcap.py.

    PatchEmbed+CLS+pos -> ViTBlocks[0..12) ----------------------> caption tokens
                               \\-(fork at 12-split_blocks)-> TagBlocks[4) -> tagCLS
    tagCLS -> pooler -> tag_logit -> sigmoid top-K concept ids

ViTCAP is an nn.Module that only holds parameters; its state_dict() names
are those solver.checkpoint_bridge.params_to_torch_state_dict emits,
without the leading 'module.'.  The functions below are the forward
pieces, taking the model and tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_block import pad_len
from .config import ModelConfig
from .layers import (BertEmbeddings, BertLayer, LMPredictionHead, ViTBlock,
                     _Group, _linear, bert_pooler, lm_head, vision_embed,
                     vit_block, vit_block_cls_only)


class ViTCAP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        gh = cfg.img_size // cfg.patch_size
        p = cfg.patch_size
        vis = _Group(patch_embed=_Group(proj=nn.Conv2d(
            cfg.in_chans, h, p, stride=p, device=device)))
        vis.cls_token = nn.Parameter(torch.empty(1, 1, h, device=device))
        vis.pos_embed = nn.Parameter(
            torch.empty(1, gh * gh + 1, h, device=device))
        self.image_encoder = _Group(module=vis)

        def emb():
            return BertEmbeddings(cfg.vocab_size, cfg.max_position_embeddings,
                                  cfg.type_vocab_size, h, device)
        self.bert = _Group(
            encoder=_Group(
                blocks=nn.ModuleList(ViTBlock(h, i, device)
                                     for _ in range(cfg.num_hidden_layers)),
                tag_blocks=nn.ModuleList(ViTBlock(h, i, device)
                                         for _ in range(cfg.split_blocks))),
            embeddings=emb(), extra_embeddings=emb(),
            pooler=_Group(dense=_linear(h, h, device)),
            caption_pooler=_Group(dense=_linear(h, h, device)),
            tag_logit=_Group(predictions=LMPredictionHead(
                h, cfg.tag_vocab_size, cfg.tie_tag_weights, device)),
            decoder=_Group(layer=nn.ModuleList(
                BertLayer(h, i, device) for _ in range(cfg.decoder_layers))))
        self.cls = _Group(predictions=LMPredictionHead(
            h, cfg.vocab_size, cfg.tie_weights, device))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> ViTCAP:
    """Random ViTCAP weights, the rule of vitcap_tpu/models/vitcap.py
    init_params: truncated normal at +-2 sigma with std 0.02 for matrices,
    embeddings, cls_token and pos_embed; zero biases; LayerNorm ones and
    zeros.  Values are drawn on the CPU from `generator` (a CPU generator),
    parameter by parameter in state-dict order, then moved to `device`:
    the card unless the caller asks for another (device="cpu")."""
    model = ViTCAP(cfg, device="meta").to_empty(device=device)
    for mod in model.modules():
        for name, prm in mod.named_parameters(recurse=False):
            if name == "bias":
                prm.zero_()
            elif isinstance(mod, nn.LayerNorm):
                prm.fill_(1.0)
            else:
                t = torch.empty(prm.shape)
                nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
                prm.copy_(t)
    return model.requires_grad_(False)


def word_embedding_weight(model: ViTCAP) -> torch.Tensor:
    return model.bert.embeddings.word_embeddings.weight


def split_encoder(model: ViTCAP, visual_in: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trunk blocks; fork at depth - split_blocks into the tag branch,
    whose last block computes only the CLS row.  The token axis is padded
    once (pad_len) for the fused blocks and sliced back at the end.

    Returns (caption_hidden (B, V, H), tag_cls (B, 1, H))."""
    sd = cfg.attention_scores_dtype
    nh, eps = cfg.num_attention_heads, cfg.vit_layer_norm_eps
    L = visual_in.shape[1]
    pad = pad_len(L) - L
    l_actual = L if pad else 0
    x = F.pad(visual_in, (0, 0, 0, pad)) if pad else visual_in
    fork_at = cfg.num_hidden_layers - cfg.split_blocks
    enc = model.bert.encoder
    tag_x = None
    for idx, blk in enumerate(enc.blocks):
        if idx == fork_at:
            tag_x = x
        x = vit_block(blk, x, nh, eps, scores_dtype=sd, l_actual=l_actual)
    for blk in list(enc.tag_blocks)[:-1]:
        tag_x = vit_block(blk, tag_x, nh, eps, scores_dtype=sd,
                          l_actual=l_actual)
    if pad:
        x = x[:, :L]
        tag_x = tag_x[:, :L] if tag_x is not None else None
    if len(enc.tag_blocks):
        tag_cls = vit_block_cls_only(enc.tag_blocks[-1], tag_x, nh, eps, sd)
    else:
        tag_cls = tag_x[:, :1]
    return x, tag_cls


def tag_logits_from_hidden(model: ViTCAP, tag_hidden: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
    pooled = bert_pooler(model.bert.pooler, tag_hidden)
    tied = word_embedding_weight(model) if cfg.tie_tag_weights else None
    return lm_head(model.bert.tag_logit.predictions, pooled,
                   cfg.bert_layer_norm_eps, decoder_weight=tied)


def select_tags(tag_logits: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sigmoid top-K concept selection (ties to the lower index); the last
    slot is forced to SEP."""
    from .decode import exact_top_k
    probs = torch.sigmoid(tag_logits.float())
    top_prob, top_idx = exact_top_k(probs, cfg.topk)
    n_conf = (top_prob >= cfg.tag_conf_threshold).sum(-1)
    top_idx[:, -1] = cfg.sep_token_id
    return top_idx, top_prob, n_conf


@torch.inference_mode()
def encode_images(model: ViTCAP, images: torch.Tensor, cfg: ModelConfig
                  ) -> Dict[str, torch.Tensor]:
    """Vision once: patch embed -> split encoder -> tag logits + selection.
    uint8 images keep their bytes (the normalisation folds into the patch
    projection); float images are cast to the compute dtype."""
    dtype = cfg.compute_dtype
    if images.dtype != torch.uint8:
        images = images.to(dtype)
    visual_in = vision_embed(model.image_encoder.module, images,
                             cfg.patch_size, compute_dtype=dtype)
    cap_hidden, tag_cls = split_encoder(model, visual_in, cfg)
    tag_logits = tag_logits_from_hidden(model, tag_cls, cfg)
    pred_topk, tag_probs, n_conf = select_tags(tag_logits, cfg)
    return {"visual": cap_hidden, "tag_cls": tag_cls,
            "tag_logits": tag_logits, "pred_topk": pred_topk,
            "tag_probs": tag_probs, "n_conf_tags": n_conf}


def caption_logits(model: ViTCAP, hidden: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    tied = word_embedding_weight(model) if cfg.tie_weights else None
    return lm_head(model.cls.predictions, hidden, cfg.bert_layer_norm_eps,
                   decoder_weight=tied)
