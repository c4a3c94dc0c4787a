"""Transformer primitives: nn.Module parameter containers plus plain
functions on tensors, the port of vitcap_tpu/models/layers.py.

The modules only hold parameters (torch Linear layout: weight (out, in));
the math lives in the functions below, which take a module and tensors.
Routing is by shape, as in the TPU package: a bias-free ViT block or a
biased self-attention BERT layer with at least 64 tokens goes to the fused
block (ops/fused_block.py), on every device; the device of the tensors then
decides between the CUDA kernels and their plain versions.  A gradient-
carrying call (grad mode on and the input or a parameter requiring grad),
or one with dropout seeds, is a train call: it takes the split train blocks
(split_vit_block_train, split_bert_layer_train) where the token axis is
16-aligned and at most 1024 (ops.fused_block.takes_split_train), else the
plain chain below (_vit_block_plain, _bert_layer_plain).

mha routes as the TPU package's does (vitcap_tpu/models/layers.py:130-170
with its kernels engaged): a train self-attention (Lq == Lk >= 64) with no
bias or a head-broadcast (B, 1, L, L) one takes the packed route,
ops.flash_attention.flash_attention_packed (the attention and
attention_bwd kernels on separate q, k, v), at any length: 512-px
training past 1024 padded tokens and the plain layers at an unaligned
length.  Only that route takes a pre-padded input (l_actual > 0).  A
self-attention that carries no gradient (Lq == Lk >= 64, no dropout, any
bias) takes ops.flash_attention.flash_attention (K9) on the per-head view
of q, k, v, as the TPU package does inside ops.inference_mode(): a
vit_block with a bias, a bert_layer without one.  Every other call runs
the plain attention below (fewer than 64 tokens, cross-attention, a train
call with a per-head bias, generator dropout).

Dropout: the split train blocks and the packed route draw their masks
from int32 seeds through the counter hash (ops/dropout.py), the TPU
kernels' bits; the plain attention's and hidden dropout of the plain
layers, and the embeddings', draw Bernoulli masks from a torch.Generator
(the TPU package's jax.random.bernoulli there).

Tensor parallelism: a block split by parallel/mesh.py shard_params carries
a TPShard (`tp`) and runs its heads on every route.  The plain chains put
copy_to_tp before each column-split product and sum each row-split one
(row_dense: an f32 partial, reduce_from_tp, then the bias once), so their
autograd backward is the split model's.  The counter-hash dropouts salt
with the global head; the generator's attention dropout draws the mask of
every head and keeps the rank's (the generator advances as unsplit), and
the hidden and embedding dropouts run on replicated activations, so a
rank draws what the unsplit model draws.  vit_block_cls_only splits
likewise; cls_attention_scores gathers every head's scores.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import heads_view, merge_heads
from ..ops.flash_attention import flash_attention, flash_attention_packed
from ..ops.fused_block import (fused_bert_block, fused_vit_block, local_bias,
                               split_bert_layer_train, split_vit_block_train,
                               takes_split_train)
from ..ops.layer_norm import layer_norm_plain
from ..parallel.tensor_parallel import (TPShard, all_gather_tp, copy_to_tp,
                                        local_heads, reduce_from_tp,
                                        salt_heads, tp_of)

NEG_MASK_VALUE = -10000.0  # the reference's (1 - m) * -10000 mask value


# ---------------------------------------------------------------------------
# parameter containers (names = the reference's torch state-dict names)
# ---------------------------------------------------------------------------

def _linear(fan_in: int, fan_out: int, device, bias: bool = True):
    return nn.Linear(fan_in, fan_out, bias=bias, device=device)


def _norm(dim: int, device):
    return nn.LayerNorm(dim, device=device)


class _Group(nn.Module):
    """A named bag of submodules (keeps the state-dict names flat)."""

    def __init__(this, /, **children):   # BERT names a child 'self'
        super().__init__()
        for name, mod in children.items():
            setattr(this, name, mod)


class ViTBlock(nn.Module):
    def __init__(self, h: int, i: int, device=None):
        super().__init__()
        self.norm1 = _norm(h, device)
        self.attn = _Group(qkv=_linear(h, 3 * h, device),
                           proj=_linear(h, h, device))
        self.norm2 = _norm(h, device)
        self.mlp = _Group(fc1=_linear(h, i, device), fc2=_linear(i, h, device))


class BertLayer(nn.Module):
    def __init__(self, h: int, i: int, device=None):
        super().__init__()
        self.attention = _Group(
            self=_Group(query=_linear(h, h, device), key=_linear(h, h, device),
                        value=_linear(h, h, device)),
            output=_Group(dense=_linear(h, h, device),
                          LayerNorm=_norm(h, device)))
        self.intermediate = _Group(dense=_linear(h, i, device))
        self.output = _Group(dense=_linear(i, h, device),
                             LayerNorm=_norm(h, device))


class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, max_pos: int, n_types: int, h: int,
                 device=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, h, device=device)
        self.position_embeddings = nn.Embedding(max_pos, h, device=device)
        self.token_type_embeddings = nn.Embedding(n_types, h, device=device)
        self.LayerNorm = _norm(h, device)


class LMPredictionHead(nn.Module):
    """transform (dense, LayerNorm) + output bias, plus its own decoder
    weight when not tied to the word embeddings."""

    def __init__(self, h: int, out_dim: int, tied: bool, device=None):
        super().__init__()
        self.transform = _Group(dense=_linear(h, h, device),
                                LayerNorm=_norm(h, device))
        if not tied:
            self.decoder = _linear(h, out_dim, device, bias=False)
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))


# ---------------------------------------------------------------------------
# elementary ops
# ---------------------------------------------------------------------------

def dense(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W.T + b in x's dtype (weights stored f32, cast per use)."""
    y = x @ p.weight.to(x.dtype).t()
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def row_dense(p: nn.Linear, x: torch.Tensor,
              tp: Optional[TPShard]) -> torch.Tensor:
    """dense of a row-split Linear: this rank's f32 partial product summed
    over the model axis (reduce_from_tp), rounded to x's dtype once, then
    the bias, as dense rounds; dense itself without a shard."""
    if tp is None:
        return dense(p, x)
    y = reduce_from_tp(x.float() @ p.weight.float().t(), tp).to(x.dtype)
    return y + p.bias.to(x.dtype)


def layer_norm(p: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32 whatever the compute dtype (always the plain
    version: this is the LayerNorm outside the fused blocks)."""
    return layer_norm_plain(x, p.weight, p.bias, eps, x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)                     # exact (erf)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            heads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Inverted dropout with a Bernoulli mask from `generator`; the
    identity at rate 0 or without a generator (deterministic).  heads
    (nh_total, head_offset) with nh_total > 0: x is (B, nh, ...) of heads
    [head_offset, head_offset + nh); the mask is drawn over all nh_total
    heads and this slice kept, so the generator draws and advances as for
    the unsplit tensor."""
    if rate == 0.0 or generator is None:
        return x
    nh_total, off = heads
    shape = ((x.shape[0], nh_total, *x.shape[2:]) if nh_total else x.shape)
    keep = torch.rand(shape, generator=generator,
                      device=generator.device).to(x.device) >= rate
    if nh_total:
        keep = keep[:, off:off + x.shape[1]]
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def prune_dense(p: nn.Linear, index, dim: int) -> nn.Linear:
    """A new Linear keeping only the `index` entries of p along `dim`: the
    reference's prune_linear_layer (modeling_utils.py:1183-1196), the port
    of vitcap_tpu/models/layers.py prune_dense.  dim=0 prunes OUTPUT
    features (weight rows and the bias), dim=1 INPUT features (weight
    columns; the bias kept)."""
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")
    index = torch.as_tensor(index, dtype=torch.long,
                            device=p.weight.device)
    w = p.weight.detach().index_select(dim, index)
    out = nn.Linear(w.shape[1], w.shape[0], bias=p.bias is not None,
                    device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        if p.bias is not None:
            out.bias.copy_(p.bias.detach()[index] if dim == 0 else p.bias)
    return out.requires_grad_(p.weight.requires_grad)


def prune_attention_heads(attn, heads, num_heads: int, head_dim: int):
    """A new group of attn's children with whole heads removed from its
    query, key and value Linears (a BertSelfAttention group; the sibling
    output dense is the caller's, through prune_dense(dim=1)): the port of
    vitcap_tpu/models/layers.py prune_attention_heads.  The caller also
    shrinks its num_heads."""
    drop = {int(h) for h in heads}
    idx = [h * head_dim + d for h in range(num_heads) if h not in drop
           for d in range(head_dim)]
    return _Group(**{name: (prune_dense(child, idx, 0)
                            if name in ("query", "key", "value") else child)
                     for name, child in attn.named_children()})


def _seed_generator(seeds: Optional[Sequence[int]]):
    """The plain layers' generator for a layer's dropout seeds."""
    if seeds is None:
        return None
    return torch.Generator(device="cpu").manual_seed(
        (int(seeds[0]) & 0xFFFFFFFF) << 32 | (int(seeds[1]) & 0xFFFFFFFF))


def _train_call(p, x: torch.Tensor, seeds=None) -> bool:
    """Gradient-carrying (grad mode on, input or a parameter requiring
    grad) or dropout-active: the train route."""
    if seeds is not None:
        return True
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.parameters()))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
        bias: Optional[torch.Tensor] = None,
        scores_dtype: Optional[torch.dtype] = None,
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
        seed: Optional[int] = None, l_actual: int = 0,
        heads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """q (B, Lq, H), k/v (B, Lk, H), bias (B, 1|nh, Lq, Lk) additive ->
    (B, Lq, H).  seed (an int32 value): a dropout-active train call.  A
    train call (seed given, or q, k or v carrying a gradient) with Lq == Lk
    >= 64 and a bias that is None or (B, 1, L, L) takes the packed route
    (flash_attention_packed; dropout from `seed` at dropout_rate); a call
    that carries no gradient, with Lq == Lk >= 64 and no dropout, takes
    flash_attention (K9) with any bias; scores_dtype is ignored on both,
    as in the TPU package.  Any other call takes the plain attention below,
    with dropout from `generator` when given.
    l_actual > 0: q, k, v are pre-padded with that many valid rows, which
    only the packed route takes.  heads (nh_total, head_offset): q, k, v
    hold heads [head_offset, head_offset + num_heads) of nh_total (a
    tensor-parallel rank's), which both dropouts key on; (0, 0): all."""
    B, Lq, H = q.shape
    Lk = k.shape[1]
    hd = H // num_heads
    train = seed is not None or (torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)))
    if (train and Lq == Lk and Lq >= 64
            and (bias is None or bias.shape[1] == 1)):
        rate = dropout_rate if seed is not None else 0.0
        return flash_attention_packed(q, k, v, bias, seed or 0, num_heads,
                                      rate, l_actual, heads)
    if l_actual:
        raise ValueError("pre-padded mha (l_actual > 0) needs the packed "
                         "train route")
    if (not train and Lq == Lk and Lq >= 64
            and (dropout_rate == 0.0 or generator is None)):
        out = flash_attention(*(heads_view(t, num_heads) for t in (q, k, v)),
                              bias)
        return merge_heads(out)

    qh, kh, vh = (heads_view(t, num_heads) for t in (q, k, v))
    if scores_dtype is not None and scores_dtype != torch.float32:
        qh = qh * torch.tensor(hd ** -0.5, dtype=qh.dtype)
        scores = (qh.float() @ kh.float().transpose(-1, -2)).to(scores_dtype)
        if bias is not None:
            scores = scores + bias.to(scores.dtype)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    else:
        scores = (qh.float() @ kh.float().transpose(-1, -2)) * (hd ** -0.5)
        if bias is not None:
            scores = scores + bias.float()
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_rate, generator, heads)
    out = probs @ vh
    return out.transpose(1, 2).reshape(B, Lq, H)


# ---------------------------------------------------------------------------
# ViT (pre-norm)
# ---------------------------------------------------------------------------

def vit_mlp(p, x: torch.Tensor, tp: Optional[TPShard] = None
            ) -> torch.Tensor:
    """fc2(GELU(fc1(x))); under a shard fc1 is column-split and fc2
    row-split (x replicated, the output summed)."""
    return row_dense(p.fc2, gelu(dense(p.fc1, copy_to_tp(x, tp))), tp)


def _vit_block_plain(p: ViTBlock, x: torch.Tensor, num_heads: int,
                     ln_eps: float, bias: Optional[torch.Tensor] = None,
                     scores_dtype=None, l_actual: int = 0) -> torch.Tensor:
    """The plain chain (the TPU package's _vit_block_xla): the products on
    every row, the attention through mha's routing."""
    tp = tp_of(p)
    y = copy_to_tp(layer_norm(p.norm1, x, ln_eps), tp)
    q, k, v = dense(p.attn.qkv, y).chunk(3, dim=-1)
    x = x + row_dense(p.attn.proj, mha(
        q, k, v, local_heads(tp, num_heads), local_bias(bias, tp),
        scores_dtype, l_actual=l_actual, heads=salt_heads(tp)), tp)
    return x + vit_mlp(p.mlp, layer_norm(p.norm2, x, ln_eps), tp)


def vit_block(p: ViTBlock, x: torch.Tensor, num_heads: int, ln_eps: float,
              bias: Optional[torch.Tensor] = None, scores_dtype=None,
              l_actual: int = 0) -> torch.Tensor:
    """One pre-norm ViT block.  Bias-free with L >= 64 -> fused block (the
    gate of vitcap_tpu/models/layers.py vit_block); a train call takes the
    split train block when L is 16-aligned and at most 1024
    (takes_split_train), else the plain chain, whose attention is the
    packed route.  l_actual > 0: x is pre-padded with that many valid rows
    (the fused block, the split train block, or the plain chain's packed
    attention)."""
    if bias is None and x.shape[1] >= 64:
        if not _train_call(p, x):
            return fused_vit_block(p, x, num_heads, ln_eps, l_actual)
        if takes_split_train(x.shape[1]):
            return split_vit_block_train(p, x, num_heads, ln_eps, l_actual)
    return _vit_block_plain(p, x, num_heads, ln_eps, bias, scores_dtype,
                            l_actual)


def vit_block_cls_only(p: ViTBlock, x: torch.Tensor, num_heads: int,
                       ln_eps: float, scores_dtype=None) -> torch.Tensor:
    """Exact CLS-row output of vit_block, (B, L, H) -> (B, 1, H): q, proj
    and MLP run on one row, k/v on every row."""
    tp = tp_of(p)
    ln1 = copy_to_tp(layer_norm(p.norm1, x, ln_eps), tp)
    w = p.attn.qkv.weight.to(x.dtype)
    b = p.attn.qkv.bias.to(x.dtype)
    H = w.shape[0] // 3                  # the shard's heads' width
    q = ln1[:, :1] @ w[:H].t() + b[:H]
    kv = ln1 @ w[H:].t() + b[H:]
    k, v = kv.chunk(2, dim=-1)
    out = mha(q, k, v, local_heads(tp, num_heads), scores_dtype=scores_dtype)
    x0 = x[:, :1] + row_dense(p.attn.proj, out, tp)
    return x0 + vit_mlp(p.mlp, layer_norm(p.norm2, x0, ln_eps), tp)


def cls_attention_scores(p: ViTBlock, x: torch.Tensor, num_heads: int,
                         ln_eps: float) -> torch.Tensor:
    """CLS-row attention mass of a ViT block over its input, (B, L) f32,
    averaged over the heads: the token-importance signal of the
    attention-aware token filter (one query row, no value product).  A
    split block gathers every head's scores over the model axis first."""
    B, L, H = x.shape
    hd = H // num_heads
    tp = tp_of(p)
    y = layer_norm(p.norm1, x, ln_eps)
    w = p.attn.qkv.weight.to(x.dtype)
    b = p.attn.qkv.bias.to(x.dtype)
    Hl = w.shape[0] // 3                 # the shard's heads' width
    nh = Hl // hd
    q = y[:, :1] @ w[:Hl].t() + b[:Hl]
    k = y @ w[Hl:2 * Hl].t() + b[Hl:2 * Hl]
    qh = q.reshape(B, 1, nh, hd).transpose(1, 2).float()
    kh = k.reshape(B, L, nh, hd).transpose(1, 2).float()
    s = (qh @ kh.transpose(-1, -2)) * (hd ** -0.5)        # (B, h, 1, L)
    probs = all_gather_tp(torch.softmax(s, dim=-1), tp, dim=1)
    return probs.mean(1)[:, 0]


def patch_embed(p: nn.Conv2d, images: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """images (B, H, W, C) NHWC float or uint8, or (B, N, P*P*C)
    pre-patchified -> patch tokens (B, N, H).  A stride-patch conv computed
    as space-to-depth + matmul; for uint8 input the (x/255 - mean)/std
    normalisation is folded into the projection weights."""
    Hd, C, ph, pw = p.weight.shape
    w_mat = p.weight.permute(2, 3, 1, 0).reshape(ph * pw * C, Hd)  # HWIO rows
    if images.dtype == torch.uint8:
        dt = compute_dtype or torch.float32
        w32 = w_mat.float()
        w = (w32 / (255.0 * std)).to(dt)
        b = (p.bias.float() - (mean / std) * w32.sum(0)).to(dt)
    else:
        dt = images.dtype
        w = w_mat.to(dt)
        b = p.bias.to(dt)
    if images.dim() == 3:                       # already (B, N, ph*pw*C)
        x = images
    else:
        B, ih, iw, _ = images.shape
        gh, gw = ih // ph, iw // pw
        # conv-stride truncation: the sub-patch tail is ignored
        images = images[:, :gh * ph, :gw * pw]
        x = images.reshape(B, gh, ph, gw, pw, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, ph * pw * C)
    return x.to(dt) @ w + b


def patchify_host(image_hwc: np.ndarray, patch: int) -> np.ndarray:
    """Host-side space-to-depth: (H, W, C) numpy -> (N, patch*patch*C), the
    pre-patchified layout patch_embed consumes."""
    ih, iw, C = image_hwc.shape
    gh, gw = ih // patch, iw // patch
    x = image_hwc.reshape(gh, patch, gw, patch, C).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(x).reshape(gh * gw, patch * patch * C)


def interpolate_pos_embed(pos_embed: torch.Tensor,
                          new_grid: Tuple[int, int],
                          old_grid: Tuple[int, int],
                          lead: int = 1) -> torch.Tensor:
    """Bicubic resize of a (1, lead + gh*gw, H) pos-embed's grid part to
    new_grid, the lead slots (CLS, a DeiT distillation token) kept (the
    reference's vision_transformer.py:416-421, F.interpolate bicubic with
    align_corners=False), computed in f32."""
    if tuple(new_grid) == tuple(old_grid):
        return pos_embed
    H = pos_embed.shape[-1]
    grid = pos_embed[:, lead:].float().reshape(1, old_grid[0], old_grid[1],
                                               H)
    grid = F.interpolate(grid.permute(0, 3, 1, 2), size=tuple(new_grid),
                         mode="bicubic", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, new_grid[0] * new_grid[1], H)
    return torch.cat([pos_embed[:, :lead].float(), grid], dim=1)


def _square_grid(n: int, what: str) -> int:
    g = math.isqrt(n)
    if g * g != n:
        raise ValueError(f"pos-embed interpolation needs a square grid; "
                         f"{what} has {n} patches")
    return g


def _pos_embed_for(p, n_patches: int, dtype: torch.dtype,
                   lead: int = 1) -> torch.Tensor:
    """p.pos_embed (`lead` slots, then a square grid) resized to a square
    grid of n_patches (interpolated in f32, then cast to dtype).  Without a
    gradient to carry, the resized table is cached on p, keyed by the
    parameter's storage and version, the grid and the dtype, so serving
    resizes once per load."""
    pe = p.pos_embed
    old_n = pe.shape[1] - lead
    if old_n == n_patches:
        return pe.to(dtype)
    g_old = _square_grid(old_n, "the pos-embed")
    g_new = _square_grid(n_patches, "the input")
    if torch.is_grad_enabled() and pe.requires_grad:
        return interpolate_pos_embed(pe, (g_new, g_new), (g_old, g_old),
                                     lead).to(dtype)
    stamp = (pe.data_ptr(), pe._version, g_new, dtype)
    hit = p.__dict__.get("_pos_embed_resized")
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, interpolate_pos_embed(pe, (g_new, g_new),
                                                (g_old, g_old),
                                                lead).to(dtype))
        p.__dict__["_pos_embed_resized"] = hit
    return hit[1]


def vision_embed(p, images: torch.Tensor, patch_size: int,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """patch embed + CLS + pos-embed.  p holds patch_embed.proj, cls_token
    and pos_embed.  A pos-embed made for another square grid is resized
    bicubically to the input's (interpolate_pos_embed); a token count that
    is not a square raises ValueError."""
    tokens = patch_embed(p.patch_embed.proj, images, compute_dtype)
    B, N, H = tokens.shape
    cls_tok = p.cls_token.to(tokens.dtype).expand(B, 1, H)
    x = torch.cat([cls_tok, tokens], dim=1)
    return x + _pos_embed_for(p, N, x.dtype)


# ---------------------------------------------------------------------------
# BERT (post-norm)
# ---------------------------------------------------------------------------

def bert_embeddings(p: BertEmbeddings, input_ids: torch.Tensor,
                    position_ids: Optional[torch.Tensor],
                    token_type_ids: Optional[torch.Tensor], ln_eps: float,
                    dtype: torch.dtype = torch.float32,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """word + position + type embeddings -> LN -> dropout (from
    `generator`; none without one)."""
    B, L = input_ids.shape
    if position_ids is None:
        position_ids = torch.arange(L, device=input_ids.device).expand(B, L)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    emb = (p.word_embeddings.weight[input_ids]
           + p.position_embeddings.weight[position_ids]
           + p.token_type_embeddings.weight[token_type_ids]).to(dtype)
    return dropout(layer_norm(p.LayerNorm, emb, ln_eps), dropout_rate,
                   generator)


def _bert_layer_plain(p: BertLayer, x: torch.Tensor, bias: torch.Tensor,
                      num_heads: int, ln_eps: float, scores_dtype=None,
                      hidden_dropout: float = 0.0, attn_dropout: float = 0.0,
                      seeds: Optional[Sequence[int]] = None,
                      l_actual: int = 0) -> torch.Tensor:
    """The plain chain (the TPU package's _bert_layer_xla).  seeds (attn,
    hidden int32 values): dropout on; the packed attention draws its keep
    bits from seeds[0] through the counter hash, the other dropouts
    Bernoulli masks from a generator seeded by both (_seed_generator)."""
    ps = p.attention.self
    tp = tp_of(p)
    generator = _seed_generator(seeds)
    xs = copy_to_tp(x, tp)
    attn = mha(dense(ps.query, xs), dense(ps.key, xs), dense(ps.value, xs),
               local_heads(tp, num_heads), local_bias(bias, tp),
               scores_dtype, attn_dropout, generator,
               None if seeds is None else int(seeds[0]), l_actual,
               salt_heads(tp))
    attn = dropout(row_dense(p.attention.output.dense, attn, tp),
                   hidden_dropout, generator)
    x = layer_norm(p.attention.output.LayerNorm, attn + x, ln_eps)
    out = row_dense(p.output.dense, gelu(dense(p.intermediate.dense,
                                               copy_to_tp(x, tp))), tp)
    out = dropout(out, hidden_dropout, generator)
    return layer_norm(p.output.LayerNorm, out + x, ln_eps)


def bert_layer(p: BertLayer, x: torch.Tensor, bias: torch.Tensor,
               num_heads: int, ln_eps: float, scores_dtype=None,
               hidden_dropout: float = 0.0, attn_dropout: float = 0.0,
               seeds: Optional[Sequence[int]] = None,
               l_actual: int = 0) -> torch.Tensor:
    """Post-norm BERT self-attention layer.  Biased with L >= 64 -> fused
    block (the gate of vitcap_tpu/models/layers.py bert_layer); a train
    call with a head-broadcast bias takes the split train block when L is
    16-aligned and at most 1024 (takes_split_train, the gate of :526-528),
    else the plain chain, whose attention is the packed route.  seeds
    (attn, hidden int32 values): dropout on at the given rates; None:
    deterministic.  l_actual > 0: x and bias are pre-padded with that many
    valid rows (a train call only)."""
    if bias is not None and x.shape[1] >= 64:
        if not _train_call(p, x, seeds):
            if l_actual:
                raise ValueError("pre-padded input (l_actual > 0) needs "
                                 "a train call")
            return fused_bert_block(p, x, bias, num_heads, ln_eps)
        if bias.shape[1] == 1 and takes_split_train(x.shape[1]):
            rates = (0.0, 0.0) if seeds is None else (hidden_dropout,
                                                      attn_dropout)
            return split_bert_layer_train(p, x, bias, num_heads, ln_eps,
                                          l_actual, *rates,
                                          seeds or (0, 0))
    if seeds is None:
        hidden_dropout = attn_dropout = 0.0
    return _bert_layer_plain(p, x, bias, num_heads, ln_eps, scores_dtype,
                             hidden_dropout, attn_dropout, seeds, l_actual)


def bert_pooler(p, hidden: torch.Tensor) -> torch.Tensor:
    """tanh(dense(token 0)); p holds .dense."""
    return torch.tanh(dense(p.dense, hidden[:, 0]))


def lm_head_transform(p, x: torch.Tensor, ln_eps: float) -> torch.Tensor:
    """dense -> gelu -> LN; p holds .dense and .LayerNorm."""
    return layer_norm(p.LayerNorm, gelu(dense(p.dense, x)), ln_eps)


def lm_head(p: LMPredictionHead, x: torch.Tensor, ln_eps: float,
            decoder_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """transform -> tied (decoder_weight (V, H)) or own decoder + bias.
    Tied: the f32 bias promotes bf16 logits to f32, as in the TPU package."""
    h = lm_head_transform(p.transform, x, ln_eps)
    if decoder_weight is not None:
        return h @ decoder_weight.to(h.dtype).t() + p.bias
    return h @ p.decoder.weight.to(h.dtype).t() + p.bias.to(h.dtype)
