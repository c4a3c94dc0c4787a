"""ViTCAP model: split-ViT encoder + concept-token branch + BERT fusion
decoder, the port of vitcap_tpu/models/vitcap.py: the encode path, and the
training and scoring forwards (forward_train, forward_score) with their
masks, fusion decoder and losses.

    PatchEmbed+CLS+pos -> ViTBlocks[0..12) ----------------------> caption tokens
                               \\-(fork at 12-split_blocks)-> TagBlocks[4) -> tagCLS
    tagCLS -> pooler -> tag_logit -> sigmoid top-K concept ids

ViTCAP is an nn.Module that only holds parameters; its state_dict() names
are those solver.checkpoint_bridge.params_to_torch_state_dict emits,
without the leading 'module.'.  The functions below are the forward
pieces, taking the model and tensors.  It keeps its config (`cfg`), which
parallel/mesh.py shard_params splits by: under tensor parallelism every
block it holds carries its TPShard (the model axis's group, the rank's
heads and their offset), so the forwards below hand each block the
model's head count and the block runs its own heads.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.fused_block import fused_vit_block_train, pad_len
from .config import ModelConfig
from .layers import (NEG_MASK_VALUE, BertEmbeddings, BertLayer,
                     LMPredictionHead, ViTBlock, _Group, _linear, _train_call,
                     bert_embeddings, bert_layer, bert_pooler,
                     cls_attention_scores, lm_head, vision_embed, vit_block,
                     vit_block_cls_only)
from .losses import focal_neg_loss


class ViTCAP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg      # what parallel/mesh.py shard_params splits by
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


@torch.no_grad()
def init_tag_blocks_from_encoder(model: ViTCAP, cfg: ModelConfig) -> ViTCAP:
    """Copy the last split_blocks trunk blocks into the tag branch
    (reference ...bertemb.py:265-267), as real copies: the tag blocks train
    apart from the trunk.  In place; returns the model."""
    src = model.bert.encoder.blocks[-cfg.split_blocks:]
    for dst, blk in zip(model.bert.encoder.tag_blocks, src):
        dst.load_state_dict({k: v.clone() for k, v in
                             blk.state_dict().items()})
    return model


@torch.no_grad()
def resize_word_embeddings(model: ViTCAP, new_size: int,
                           generator: Optional[torch.Generator] = None
                           ) -> ViTCAP:
    """Grow or shrink the (tied) word-embedding table to new_size rows,
    keeping the existing rows (reference
    PreTrainedModel.resize_token_embeddings, modeling_utils.py:245-315).
    New rows are truncated normal (std 0.02, +-2 sigma) from `generator`
    (a CPU generator), as init_params draws; the LM head's bias gets
    zeros, its untied decoder new rows.  In place; returns the model (its
    config's vocab_size is the caller's to update)."""
    emb = model.bert.embeddings.word_embeddings
    old = emb.weight
    old_n, h = old.shape
    if new_size == old_n:
        return model
    n = min(old_n, new_size)

    def grown(t: torch.Tensor, shape) -> torch.Tensor:
        new = torch.empty(shape)
        nn.init.trunc_normal_(new, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        new = new.to(device=t.device, dtype=t.dtype)
        new[:n] = t[:n]
        return new

    emb.weight = nn.Parameter(grown(old, (new_size, h)),
                              requires_grad=old.requires_grad)
    emb.num_embeddings = new_size
    head = model.cls.predictions
    bias = torch.zeros(new_size, dtype=head.bias.dtype,
                       device=head.bias.device)
    bias[:n] = head.bias[:n]
    head.bias = nn.Parameter(bias, requires_grad=head.bias.requires_grad)
    if hasattr(head, "decoder"):
        w = head.decoder.weight
        head.decoder.weight = nn.Parameter(grown(w, (new_size, h)),
                                           requires_grad=w.requires_grad)
        head.decoder.out_features = new_size
    return model


def word_embedding_weight(model: ViTCAP) -> torch.Tensor:
    return model.bert.embeddings.word_embeddings.weight


def split_encoder(model: ViTCAP, visual_in: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trunk blocks; fork at depth - split_blocks into the tag branch,
    whose last block computes only the CLS row.  The token axis is padded
    once (pad_len: 577 -> 592, 1025 -> 1152) for the fused blocks, the
    split train blocks or, past 1024, the plain chain's packed attention,
    all of which mask the padded keys, and sliced back at the end.  cfg.token_filter_keep > 0 keeps that share of the patch tokens
    (by CLS attention, _filter_tokens_by_attention) before trunk block
    cfg.token_filter_block; the pad is then redone for the new length, and
    the tag branch keeps the length it forked with.  cfg.use_remat
    recomputes each block in the backward (torch.utils.checkpoint) instead
    of keeping its residuals.  cfg.train_fused_blocks sends a
    gradient-carrying call's trunk and tag blocks (the CLS-only last one
    aside) through fused_vit_block_train, the inference kernels with a
    recomputing backward, which keeps only the block inputs: no remat
    wraps them, as in the TPU package (vitcap_tpu/models/vitcap.py:218-267).

    Returns (caption_hidden (B, V, H), tag_cls (B, 1, H))."""
    sd = cfg.attention_scores_dtype
    nh, eps = cfg.num_attention_heads, cfg.vit_layer_norm_eps

    def block(blk, x, l_actual):
        if cfg.train_fused_blocks and _train_call(blk, x):
            return fused_vit_block_train(blk, x, nh, eps, l_actual)
        if cfg.use_remat and _train_call(blk, x):
            return checkpoint(vit_block, blk, x, nh, eps, scores_dtype=sd,
                              l_actual=l_actual, use_reentrant=False)
        return vit_block(blk, x, nh, eps, scores_dtype=sd, l_actual=l_actual)

    def padded(x):
        """(x padded to pad_len, its true length, the pad)."""
        L = x.shape[1]
        pad = pad_len(L) - L
        return (F.pad(x, (0, 0, 0, pad)) if pad else x), L, pad

    x, L, pad = padded(visual_in)
    fork_at = cfg.num_hidden_layers - cfg.split_blocks
    enc = model.bert.encoder
    tag_x, tag_L, tag_pad = None, L, pad
    for idx, blk in enumerate(enc.blocks):
        if cfg.token_filter_keep and idx == cfg.token_filter_block:
            x, L, pad = padded(_filter_tokens_by_attention(blk, x[:, :L],
                                                            cfg))
        if idx == fork_at:
            tag_x, tag_L, tag_pad = x, L, pad
        x = block(blk, x, L if pad else 0)
    for blk in list(enc.tag_blocks)[:-1]:
        tag_x = block(blk, tag_x, tag_L if tag_pad else 0)
    if pad:
        x = x[:, :L]
    if tag_x is not None and tag_pad:
        tag_x = tag_x[:, :tag_L]
    if len(enc.tag_blocks):
        tag_cls = vit_block_cls_only(enc.tag_blocks[-1], tag_x, nh, eps, sd)
    else:
        tag_cls = tag_x[:, :1]
    return x, tag_cls


def _filter_tokens_by_attention(blk: ViTBlock, x: torch.Tensor,
                                cfg: ModelConfig) -> torch.Tensor:
    """Attention-aware token filtering: keep CLS and the
    ceil(keep * n_patch) patch tokens with the highest CLS attention mass
    under the upcoming block, in their original order.  Ties go to the
    lower index (exact_top_k), as lax.top_k sends them."""
    from .decode import exact_top_k
    B, L, H = x.shape
    scores = cls_attention_scores(blk, x, cfg.num_attention_heads,
                                  cfg.vit_layer_norm_eps)
    n_keep = int(math.ceil(cfg.token_filter_keep * (L - 1)))
    _, idx = exact_top_k(scores[:, 1:], n_keep)
    idx = torch.sort(idx, dim=1).values + 1
    idx = torch.cat([torch.zeros_like(idx[:, :1]), idx], dim=1)
    return x.gather(1, idx[..., None].expand(B, idx.shape[1], H))


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


def sample_visual_token_idx(generator: torch.Generator, batch: int,
                            n_tokens: int, keep: int) -> torch.Tensor:
    """TokenSample: a random subset of `keep` of the n_tokens visual tokens
    per row, token 0 (CLS) always first, the rest in the order of their
    uniform draws from `generator` (on its device), as the TPU package
    draws them from jax.random.  Returns (batch, keep) int64 indices."""
    from .decode import exact_top_k
    u = torch.rand((batch, n_tokens - 1), generator=generator,
                   device=generator.device)
    _, idx = exact_top_k(u, keep - 1)
    return torch.cat([torch.zeros_like(idx[:, :1]), idx + 1], dim=1)


def encode(model: ViTCAP, images: torch.Tensor, cfg: ModelConfig,
           visual_token_idx: Optional[torch.Tensor] = None
           ) -> Dict[str, torch.Tensor]:
    """Vision once: patch embed -> split encoder -> tag logits + selection.
    uint8 images keep their bytes (the normalisation folds into the patch
    projection); float images are cast to the compute dtype.
    visual_token_idx (B, keep): the token subset (TokenSample) the trunk
    runs on, taken after the pos-embed.  Gradients flow when the
    parameters require them (the training forward)."""
    dtype = cfg.compute_dtype
    if images.dtype != torch.uint8:
        images = images.to(dtype)
    visual_in = vision_embed(model.image_encoder.module, images,
                             cfg.patch_size, compute_dtype=dtype)
    if visual_token_idx is not None:
        idx = visual_token_idx.to(visual_in.device).long()
        visual_in = visual_in.gather(
            1, idx[..., None].expand(*idx.shape, visual_in.shape[-1]))
    cap_hidden, tag_cls = split_encoder(model, visual_in, cfg)
    tag_logits = tag_logits_from_hidden(model, tag_cls, cfg)
    pred_topk, tag_probs, n_conf = select_tags(tag_logits, cfg)
    return {"visual": cap_hidden, "tag_cls": tag_cls,
            "tag_logits": tag_logits, "pred_topk": pred_topk,
            "tag_probs": tag_probs, "n_conf_tags": n_conf}


@torch.inference_mode()
def encode_images(model: ViTCAP, images: torch.Tensor, cfg: ModelConfig,
                  visual_token_idx: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """encode() for serving, under inference mode."""
    return encode(model, images, cfg, visual_token_idx)


def caption_logits(model: ViTCAP, hidden: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    tied = word_embedding_weight(model) if cfg.tie_weights else None
    return lm_head(model.cls.predictions, hidden, cfg.bert_layer_norm_eps,
                   decoder_weight=tied)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def seq2seq_text_mask(seq_a_len: torch.Tensor, seq_len: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """(B, T, T) 0/1 mask over the text tokens: causal caption, full
    od-label block, caption -> od, no od -> caption."""
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    dev = seq_a_len.device
    i = torch.arange(T, device=dev)[None, :, None]
    j = torch.arange(T, device=dev)[None, None, :]
    a = seq_a_len[:, None, None]
    s = seq_len[:, None, None]
    cap_i, cap_j = i < a, j < a
    od_i = (i >= A) & (i < s)
    od_j = (j >= A) & (j < s)
    m = (cap_i & cap_j & (j <= i)) | (od_i & od_j) | (cap_i & od_j)
    return m.float()


def decoder_bias_from_text_mask(text_mask: torch.Tensor,
                                n_ctx: int) -> torch.Tensor:
    """(B, T, T) text mask -> (B, 1, L, L) additive f32 bias, L = T +
    n_ctx: the n_ctx trailing tokens (tag CLS + visual) form a block every
    token attends to and that never attends text."""
    B, T, _ = text_mask.shape
    L = T + n_ctx
    m = torch.zeros(B, L, L, device=text_mask.device)
    m[:, :T, :T] = text_mask
    m[:, :, T:] = 1.0
    return ((1.0 - m) * NEG_MASK_VALUE)[:, None]


# ---------------------------------------------------------------------------
# text side and fusion decoder
# ---------------------------------------------------------------------------

def embed_text_with_tags(model: ViTCAP, input_ids: torch.Tensor,
                         token_type_ids: Optional[torch.Tensor],
                         position_ids: Optional[torch.Tensor],
                         pred_topk: torch.Tensor, cfg: ModelConfig,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """BERT embeddings of the input ids (dropout from `generator`), with
    the trailing topk slots replaced by the raw tied-weight embeddings of
    the concept ids (no position, type or LayerNorm on the tags)."""
    dt = cfg.compute_dtype
    emb = bert_embeddings(model.bert.embeddings, input_ids, position_ids,
                          token_type_ids, cfg.bert_layer_norm_eps, dt,
                          cfg.hidden_dropout_prob, generator)
    tag_emb = word_embedding_weight(model)[pred_topk].to(dt)
    return torch.cat([emb[:, :-pred_topk.shape[1]], tag_emb], dim=1)


def fusion_decoder(model: ViTCAP, seq: torch.Tensor, bias: torch.Tensor,
                   cfg: ModelConfig,
                   layer_seeds: Optional[Sequence[Sequence[int]]] = None
                   ) -> torch.Tensor:
    """The BERT decoder layers over seq (B, L, H) under bias (B, 1, L, L).
    layer_seeds: per layer (attn seed, hidden seed), int32 values; dropout
    runs at the config's rates when given.  A train call of at least 64
    tokens pads the token axis once to a multiple of 16 (the rule of
    vitcap_tpu/models/vitcap.py:414-424: 648 -> 656 at 384 px, 1096 ->
    1104 at 512 px) and slices it back after the loop; bert_layer then
    takes the split train block up to 1024 padded tokens and the plain
    chain with the packed attention past it, both masking the padded keys.
    cfg.use_remat_fusion recomputes each layer in the backward."""
    nh, eps = cfg.num_attention_heads, cfg.bert_layer_norm_eps
    layers = model.bert.decoder.layer
    L = seq.shape[1]
    l_actual = 0
    if (len(layers) and L >= 64 and bias.shape[1] == 1
            and _train_call(layers[0], seq, layer_seeds)):
        Lp = (L + 15) // 16 * 16
        if Lp > L:
            seq = F.pad(seq, (0, 0, 0, Lp - L))
            bias = F.pad(bias, (0, Lp - L, 0, Lp - L))
            l_actual = L

    def layer_fn(layer, x, seeds):
        return bert_layer(layer, x, bias, nh, eps, cfg.attention_scores_dtype,
                          cfg.hidden_dropout_prob,
                          cfg.attention_probs_dropout_prob, seeds, l_actual)
    x = seq
    for li, layer in enumerate(layers):
        seeds = None if layer_seeds is None else tuple(layer_seeds[li])
        if cfg.use_remat_fusion and _train_call(layer, x, seeds):
            x = checkpoint(layer_fn, layer, x, seeds, use_reentrant=False)
        else:
            x = layer_fn(layer, x, seeds)
    return x[:, :L] if l_actual else x


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def label_smoothed_kl(logits: torch.Tensor, target: torch.Tensor,
                      weight: torch.Tensor, eps: float,
                      weight_total: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """KLDiv(log_softmax, smoothed one-hot) summed over the classes, the
    weighted mean over the tokens (the reference BertCaptioningLoss).
    weight_total: the mean's weight sum (default weight.sum()); under data
    parallelism the global batch's, so the ranks' losses sum to its mean."""
    logits = logits.float()
    n_class = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    off = eps / (n_class - 1)
    on = 1.0 - eps
    ent = (-(on * math.log(on) + (n_class - 1) * off * math.log(off))
           if eps > 0 else 0.0)
    logp_t = logp.gather(-1, target[..., None])[..., 0]
    cross = -(on * logp_t + off * (logp.sum(-1) - logp_t))
    denom = (weight.sum() if weight_total is None
             else weight_total).clamp_min(1.0)
    return ((cross - ent) * weight).sum() / denom


def focal_tag_loss(logits: torch.Tensor, label: torch.Tensor, alpha: float,
                   gamma: float) -> torch.Tensor:
    """FocalLossWithLogitsNegLoss summed over (B, V)."""
    return focal_neg_loss(logits.float(), label, alpha, gamma).sum()


def bce_tag_loss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    x = logits.float()
    loss = x.clamp_min(0) - x * label + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


# ---------------------------------------------------------------------------
# full forwards
# ---------------------------------------------------------------------------

def masked_slots(masked_pos: torch.Tensor, masked_ids: torch.Tensor,
                 max_masked: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) 0/1 masked_pos, (B, M) masked_ids -> the (B, M) indices of
    the masked positions in ascending order, then padding slots (a stable
    argsort of -masked_pos), and the slots' f32 loss weight: 1 where the
    slot is a masked position with a nonzero target id."""
    idx = torch.argsort(-masked_pos, dim=-1, stable=True)[:, :max_masked]
    valid = masked_pos.gather(-1, idx) > 0
    return idx, ((masked_ids != 0) & valid).float()


def draw_layer_seeds(generator: torch.Generator, n: int):
    """n (attn, hidden) pairs of int32 dropout seeds from `generator`."""
    return torch.randint(-2 ** 31, 2 ** 31, (n, 2), generator=generator,
                         device=generator.device).tolist()


def mix_gt_tags(pred_topk: torch.Tensor, label: torch.Tensor, ratio: float,
                cfg: ModelConfig, generator: torch.Generator) -> torch.Tensor:
    """The GT-tag curriculum: the first floor((1 - ratio) * min(n_gt, topk))
    concept slots take the sample's ground-truth tags in a random order
    (noise uniform in [0.1, 1) from `generator`), the rest keep the
    predicted tags, and the last slot is SEP.  ratio 1: the predictions."""
    from .decode import exact_top_k
    noise = torch.rand(label.shape, generator=generator,
                       device=generator.device).to(label.device)
    _, gt_rand = exact_top_k(label * (noise * 0.9 + 0.1), cfg.topk)
    n_gt = (label > 0).sum(-1)
    n_mix = torch.floor((1.0 - ratio)
                        * n_gt.clamp_max(cfg.topk).float()).long()
    slot = torch.arange(cfg.topk, device=label.device)[None]
    out = torch.where(slot < n_mix[:, None], gt_rand, pred_topk)
    out[:, -1] = cfg.sep_token_id
    return out


def forward_train(model: ViTCAP, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig,
                  generator: Optional[torch.Generator] = None,
                  layer_seeds: Optional[Sequence[Sequence[int]]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: (total loss, aux dict), the port of
    vitcap_tpu/models/vitcap.py forward_train.

    batch: image (B, H, W, 3) NHWC, input_ids (B, T), token_type_ids,
    seq_a_len (B,), seq_len (B,), masked_pos (B, T), masked_ids (B, M),
    label (B, tagV) multi-hot, optionally gen_tag_ratio (a float).

    Randomness is explicit: `generator` draws the per-layer decoder dropout
    seeds, the embedding dropout and the GT-tag curriculum's noise;
    `layer_seeds` (per decoder layer (attn, hidden)) overrides the drawn
    seeds, so a caller can hand the JAX package's seeds to both.  Neither
    given: deterministic.

    Data parallelism (solver/train_step.py) adds the global batch's
    masked_weight_total (the masked loss's weight sum) and rows_total (its
    rows), scalar tensors; the losses are then this rank's shares,
    which sum over the ranks to the global batch's losses."""
    deterministic = generator is None and layer_seeds is None
    enc = encode(model, batch["image"], cfg)
    pred_topk = enc["pred_topk"]
    if "gen_tag_ratio" in batch and generator is not None:
        pred_topk = mix_gt_tags(pred_topk, batch["label"],
                                float(batch["gen_tag_ratio"]), cfg,
                                generator)
    if not deterministic and layer_seeds is None:
        layer_seeds = draw_layer_seeds(generator, cfg.decoder_layers)
    text_emb = embed_text_with_tags(model, batch["input_ids"],
                                    batch.get("token_type_ids"), None,
                                    pred_topk, cfg, generator)
    dt = text_emb.dtype
    seq = torch.cat([text_emb, enc["tag_cls"].to(dt), enc["visual"].to(dt)],
                    dim=1)
    text_mask = seq2seq_text_mask(batch["seq_a_len"], batch["seq_len"], cfg)
    bias = decoder_bias_from_text_mask(text_mask,
                                       seq.shape[1] - cfg.max_seq_len)
    hidden = fusion_decoder(model, seq, bias, cfg, layer_seeds)

    midx, weight = masked_slots(batch["masked_pos"], batch["masked_ids"],
                                cfg.max_masked_tokens)
    gathered = hidden.gather(
        1, midx[..., None].expand(-1, -1, hidden.shape[-1]))
    class_logits = caption_logits(model, gathered, cfg)
    masked_loss = label_smoothed_kl(
        class_logits.reshape(-1, class_logits.shape[-1]),
        batch["masked_ids"].reshape(-1), weight.reshape(-1),
        cfg.label_smoothing, batch.get("masked_weight_total"))
    aux = {"masked_loss": masked_loss, "class_logits": class_logits,
           "tag_logits": enc["tag_logits"], "masked_weight": weight}
    total = masked_loss
    if cfg.tag_loss_weight > 0.0 and "label" in batch:
        if cfg.tag_loss == "focal":
            tl = focal_tag_loss(enc["tag_logits"], batch["label"],
                                cfg.focal_alpha, cfg.focal_gamma)
        else:
            tl = bce_tag_loss(enc["tag_logits"], batch["label"])
            if "rows_total" in batch:        # the mean over the global rows
                tl = tl * (batch["label"].shape[0] / batch["rows_total"])
        aux["tag_loss"] = tl
        total = total + cfg.tag_loss_weight * tl
    aux["loss"] = total
    return total, aux


def forward_score(model: ViTCAP, images: torch.Tensor,
                  input_ids: torch.Tensor,
                  token_type_ids: Optional[torch.Tensor],
                  position_ids: Optional[torch.Tensor],
                  text_mask: torch.Tensor, cfg: ModelConfig
                  ) -> Dict[str, torch.Tensor]:
    """Scoring forward: caption logits at every text position, with the
    encoder outputs.  text_mask (B, Tin, Tin) 0/1 over the given ids."""
    enc = encode(model, images, cfg)
    dt = cfg.compute_dtype
    emb = bert_embeddings(model.bert.embeddings, input_ids, position_ids,
                          token_type_ids, cfg.bert_layer_norm_eps, dt)
    k = enc["pred_topk"].shape[1]
    emb = torch.cat([emb[:, :-k],
                     word_embedding_weight(model)[enc["pred_topk"]].to(dt)],
                    dim=1)
    seq = torch.cat([emb, enc["tag_cls"].to(dt), enc["visual"].to(dt)],
                    dim=1)
    Tin = text_mask.shape[1]
    bias = decoder_bias_from_text_mask(text_mask.float(),
                                       seq.shape[1] - Tin)
    hidden = fusion_decoder(model, seq, bias, cfg)
    return {"class_logits": caption_logits(model, hidden[:, :Tin], cfg),
            **enc}
