"""Greedy caption decoding with a prefilled context cache, the port of the
greedy half of vitcap_tpu/models/decode.py.

- the vision trunk + tag head run once per image (build_decode_context);
- the fusion decoder's static context (od/tag slots, tagger-CLS, visual
  tokens) is prefilled once into per-layer K/V caches: three fused BERT
  layers, plus the K/V projections of every layer (the last layer's body
  feeds nothing and is skipped);
- each step runs the decoder layers over the 2-token window
  [prev@t-1, MASK@t] against the caption cache, itself and the context,
  and writes prev's K/V into the caption cache (in place).

The step runs eagerly in PyTorch, as the TPU package runs it as plain XLA
by default.  Beam search, sampling, repetition penalty, several return
sequences and the int8 context cache are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.fused_block import pad_len
from . import vitcap as M
from .config import ModelConfig
from .layers import (NEG_MASK_VALUE, bert_embeddings, bert_layer, dense, gelu,
                     layer_norm, lm_head)


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Mirrors the reference `test_extra_input` dict."""
    max_length: int = 20
    num_beams: int = 1
    num_keep_best: int = 1
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    length_penalty: float = 1.0
    repetition_penalty: float = 1.0
    num_return_sequences: int = 1
    od_labels_start_posid: int = 20


# ---------------------------------------------------------------------------
# context build + prefill
# ---------------------------------------------------------------------------

def _tag_embeddings(model: M.ViTCAP, pred_topk: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Concept-token embeddings for the od/tag slots: 'raw' is the plain
    tied-weight lookup; 'embedded' adds position (from tag_pos_offset) and
    type-0 embeddings and the embedding LayerNorm."""
    emb = M.word_embedding_weight(model)[pred_topk]
    if cfg.tag_attach == "embedded":
        p = model.bert.embeddings
        pos = torch.arange(pred_topk.shape[1], device=pred_topk.device) \
            + cfg.tag_pos_offset
        emb = (emb + p.position_embeddings.weight[pos][None]
               + p.token_type_embeddings.weight[0][None, None])
        emb = layer_norm(p.LayerNorm, emb.to(cfg.compute_dtype),
                         cfg.bert_layer_norm_eps)
    return emb.to(cfg.compute_dtype)


def build_context_embeddings(model: M.ViTCAP, images: torch.Tensor,
                             od_ids: torch.Tensor,
                             od_token_type_ids: Optional[torch.Tensor],
                             seq_len: torch.Tensor, cfg: ModelConfig,
                             opts: DecodeOptions) -> Dict[str, Any]:
    """Vision + tag selection + the context embeddings [od/tag slots,
    tagCLS, visual] and their validity mask (B, S_ctx)."""
    B, od_len = od_ids.shape
    dtype = cfg.compute_dtype
    dev = od_ids.device
    enc = M.encode_images(model, images, cfg)
    pos0 = max(opts.od_labels_start_posid, opts.max_length)
    pos = (torch.arange(od_len, device=dev) + pos0).expand(B, od_len)
    if od_token_type_ids is None:
        od_token_type_ids = torch.ones_like(od_ids)
    od_emb = bert_embeddings(model.bert.embeddings, od_ids, pos,
                             od_token_type_ids, cfg.bert_layer_norm_eps,
                             dtype=dtype)
    topk = cfg.topk
    if topk > od_len:
        raise ValueError(f"topk={topk} concept slots must fit in the od "
                         f"region (od_len={od_len})")
    od_emb[:, -topk:] = _tag_embeddings(model, enc["pred_topk"], cfg)
    ctx = torch.cat([od_emb, enc["tag_cls"].to(dtype),
                     enc["visual"].to(dtype)], dim=1)      # (B, S_ctx, H)
    S_ctx = ctx.shape[1]
    od_j = torch.arange(od_len, device=dev) + opts.max_length
    od_valid = od_j[None] < seq_len[:, None]
    ctx_valid = torch.cat(
        [od_valid, torch.ones(B, S_ctx - od_len, dtype=torch.bool,
                              device=dev)], dim=1)
    return {"ctx": ctx, "ctx_valid": ctx_valid, "od_len": od_len,
            "tag_logits": enc["tag_logits"], "pred_topk": enc["pred_topk"]}


@torch.inference_mode()
def build_decode_context(model: M.ViTCAP, images: torch.Tensor,
                         od_ids: torch.Tensor,
                         od_token_type_ids: Optional[torch.Tensor],
                         seq_len: torch.Tensor, cfg: ModelConfig,
                         opts: DecodeOptions) -> Dict[str, Any]:
    """build_context_embeddings + the decoder K/V prefill over the static
    context, in the 'heads' layout: per-layer (B, nH, S_ctx, hd) lists.

    The prefill runs padded to pad_len(S_ctx): padded key columns get the
    reference's -10000 mask, padded query rows are garbage and are sliced
    off with the caches."""
    ce = build_context_embeddings(model, images, od_ids, od_token_type_ids,
                                  seq_len, cfg, opts)
    ctx, ctx_valid, od_len = ce["ctx"], ce["ctx_valid"], ce["od_len"]
    B, S_ctx, _ = ctx.shape
    dev = ctx.device

    # od rows attend valid od slots + tagCLS/visual; tagCLS/visual rows
    # attend only tagCLS/visual (visual never sees text)
    is_od_row = torch.arange(S_ctx, device=dev) < od_len
    allow = torch.where(is_od_row[None, :, None], ctx_valid[:, None, :],
                        (~is_od_row)[None, None, :].expand(B, 1, S_ctx))
    bias = torch.where(allow, 0.0, NEG_MASK_VALUE)[:, None].float()

    nH = cfg.num_attention_heads
    hd = cfg.hidden_size // nH
    pad = pad_len(S_ctx) - S_ctx
    x = F.pad(ctx, (0, 0, 0, pad))
    bias = F.pad(bias, (0, 0, 0, pad))
    bias = F.pad(bias, (0, pad), value=NEG_MASK_VALUE)

    def to_heads(a):
        return a.reshape(B, S_ctx, nH, hd).transpose(1, 2).contiguous()

    ctx_k: List[torch.Tensor] = []
    ctx_v: List[torch.Tensor] = []
    layers = model.bert.decoder.layer
    for li, layer in enumerate(layers):
        ps = layer.attention.self
        ctx_k.append(to_heads(dense(ps.key, x)[:, :S_ctx]))
        ctx_v.append(to_heads(dense(ps.value, x)[:, :S_ctx]))
        if li + 1 < len(layers):
            x = bert_layer(layer, x, bias, nH, cfg.bert_layer_norm_eps,
                           scores_dtype=cfg.attention_scores_dtype)
    return {"ctx_k": ctx_k, "ctx_v": ctx_v, "ctx_valid": ctx_valid,
            "tag_logits": ce["tag_logits"], "pred_topk": ce["pred_topk"]}


def _decode_params_cast(model: M.ViTCAP, cfg: ModelConfig) -> Dict[str, Any]:
    """The weights the decode step touches, cast to the compute dtype once
    (LayerNorms stay f32) and with q/k/v merged into one (3H, H) matrix per
    layer."""
    dt = cfg.compute_dtype
    layers = []
    for layer in model.bert.decoder.layer:
        ps, po = layer.attention.self, layer.attention.output
        layers.append({
            "qkv_w": torch.cat([ps.query.weight, ps.key.weight,
                                ps.value.weight]).to(dt),
            "qkv_b": torch.cat([ps.query.bias, ps.key.bias,
                                ps.value.bias]).to(dt),
            "out_w": po.dense.weight.to(dt), "out_b": po.dense.bias.to(dt),
            "ln1": po.LayerNorm,
            "inter_w": layer.intermediate.dense.weight.to(dt),
            "inter_b": layer.intermediate.dense.bias.to(dt),
            "out2_w": layer.output.dense.weight.to(dt),
            "out2_b": layer.output.dense.bias.to(dt),
            "ln2": layer.output.LayerNorm,
        })
    return {"layers": layers, "embeddings": model.bert.embeddings,
            "word": M.word_embedding_weight(model).to(dt),
            "head": model.cls.predictions}


# ---------------------------------------------------------------------------
# cached decode step
# ---------------------------------------------------------------------------

def _lin(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.t() + b


def _decode_attention(lw: Dict[str, Any], x_win: torch.Tensor,
                      cap_k: torch.Tensor, cap_v: torch.Tensor,
                      ctx_k: torch.Tensor, ctx_v: torch.Tensor,
                      ctx_valid: torch.Tensor, t: int, num_heads: int
                      ) -> torch.Tensor:
    """Window [prev@t-1, MASK@t] attention against the caption cache (slots
    <= t-1), the MASK row's own K/V, and the context cache (per od
    validity).  cap_* (Bb, h, A, d) are updated in place at slot t-1;
    ctx_* are per-image (B, h, S, d) f32 copies shared by the Bb rows."""
    Bb, W, H = x_win.shape
    B = ctx_k.shape[0]
    nb = Bb // B
    hd = H // num_heads
    A = cap_k.shape[2]
    S = ctx_k.shape[2]
    dt = x_win.dtype
    q, k_win, v_win = _lin(x_win, lw["qkv_w"], lw["qkv_b"]).split(H, dim=-1)

    def heads(a):
        return a.reshape(Bb, W, num_heads, hd).transpose(1, 2)

    kh_win, vh_win, qh = heads(k_win), heads(v_win), heads(q)
    cap_k[:, :, t - 1] = kh_win[:, :, 0]           # write the prev slot
    cap_v[:, :, t - 1] = vh_win[:, :, 0]

    qf = qh.float()
    s_cap = qf @ cap_k.float().transpose(-1, -2)                 # (Bb,h,W,A)
    s_self = (qf * kh_win[:, :, 1:2].float()).sum(-1, keepdim=True)
    s_ctx = torch.einsum("bnhqd,bhkd->bnhqk",
                         qf.reshape(B, nb, num_heads, W, hd), ctx_k)
    s_ctx = s_ctx.reshape(Bb, num_heads, W, S)

    scale = hd ** -0.5
    dev = x_win.device
    cap_allow = torch.arange(A, device=dev) <= (t - 1)
    s_cap = torch.where(cap_allow, s_cap * scale, NEG_MASK_VALUE)
    self_allow = torch.tensor([False, True], device=dev)[:, None]
    s_self = torch.where(self_allow, s_self * scale, NEG_MASK_VALUE)
    ctx_allow = ctx_valid.repeat_interleave(nb, dim=0)[:, None, None, :]
    s_ctx = torch.where(ctx_allow, s_ctx * scale, NEG_MASK_VALUE)

    m = torch.maximum(s_ctx.amax(-1, keepdim=True),
                      torch.maximum(s_cap.amax(-1, keepdim=True),
                                    s_self.amax(-1, keepdim=True)))
    e_cap = torch.exp(s_cap - m)
    e_self = torch.exp(s_self - m)
    e_ctx = torch.exp(s_ctx - m)
    inv = 1.0 / (e_cap.sum(-1, keepdim=True) + e_self
                 + e_ctx.sum(-1, keepdim=True))

    out = e_cap.to(dt).float() @ cap_v.float()
    out = out + e_self * vh_win[:, :, 1:2].float()
    o_ctx = torch.einsum(
        "bnhqk,bhkd->bnhqd",
        e_ctx.reshape(B, nb, num_heads, W, S).to(dt).float(), ctx_v)
    out = out + o_ctx.reshape(Bb, num_heads, W, hd)
    out = (out * inv).to(dt)
    return out.transpose(1, 2).reshape(Bb, W, H)


def _decode_layer(lw: Dict[str, Any], x_win: torch.Tensor, cap_k, cap_v,
                  ctx_k, ctx_v, ctx_valid, t: int, cfg: ModelConfig
                  ) -> torch.Tensor:
    eps = cfg.bert_layer_norm_eps
    attn = _decode_attention(lw, x_win, cap_k, cap_v, ctx_k, ctx_v,
                             ctx_valid, t, cfg.num_attention_heads)
    attn = _lin(attn, lw["out_w"], lw["out_b"])
    x = layer_norm(lw["ln1"], attn + x_win, eps)
    out = _lin(gelu(_lin(x, lw["inter_w"], lw["inter_b"])),
               lw["out2_w"], lw["out2_b"])
    return layer_norm(lw["ln2"], out + x, eps)


def _window_embeddings(dw: Dict[str, Any], prev_tok: torch.Tensor, t: int,
                       cfg: ModelConfig) -> torch.Tensor:
    """Embeddings for [prev@t-1, MASK@t] (segment 0, positions t-1, t)."""
    p = dw["embeddings"]
    ids = torch.stack([prev_tok, torch.full_like(prev_tok,
                                                 cfg.mask_token_id)], dim=1)
    pos = torch.tensor([t - 1, t], device=prev_tok.device)
    emb = (dw["word"][ids] + p.position_embeddings.weight[pos][None]
           + p.token_type_embeddings.weight[0])
    return layer_norm(p.LayerNorm, emb.to(cfg.compute_dtype),
                      cfg.bert_layer_norm_eps)


def decode_step(dw: Dict[str, Any], cap_k: List[torch.Tensor],
                cap_v: List[torch.Tensor], ctx: Dict[str, Any],
                prev_tok: torch.Tensor, t: int, cfg: ModelConfig
                ) -> torch.Tensor:
    """One MASK-probe step: f32 logits (Bb, V); the caches are updated in
    place.  ctx['ctx_k'/'ctx_v'] are the f32 copies made by the caller."""
    x = _window_embeddings(dw, prev_tok, t, cfg)
    for li, lw in enumerate(dw["layers"]):
        x = _decode_layer(lw, x, cap_k[li], cap_v[li], ctx["ctx_k"][li],
                          ctx["ctx_v"][li], ctx["ctx_valid"], t, cfg)
    tied = dw["word"] if cfg.tie_weights else None
    logits = lm_head(dw["head"], x[:, 1], cfg.bert_layer_norm_eps, tied)
    return logits.float()


def _init_caps(B: int, n_layers: int, A: int, H: int, dtype: torch.dtype,
               num_heads: int, device) -> Tuple[List[torch.Tensor],
                                                List[torch.Tensor]]:
    hd = H // num_heads

    def zeros():
        return [torch.zeros(B, num_heads, A, hd, dtype=dtype, device=device)
                for _ in range(n_layers)]
    return zeros(), zeros()


def exact_top_k(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, values descending, ties to the lower
    index (like lax.top_k).  torch.topk promises no tie order, so this is a
    stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# greedy
# ---------------------------------------------------------------------------

def check_supported(cfg: ModelConfig, opts: DecodeOptions) -> None:
    unsupported = []
    if opts.num_beams > 1:
        unsupported.append("beam search (num_beams > 1)")
    if opts.do_sample:
        unsupported.append("sampling (do_sample)")
    if opts.repetition_penalty != 1.0:
        unsupported.append("repetition_penalty != 1")
    if opts.num_return_sequences > 1:
        unsupported.append("num_return_sequences > 1")
    if cfg.kv_cache_quant != "none":
        unsupported.append(f"kv_cache_quant={cfg.kv_cache_quant}")
    if unsupported:
        raise NotImplementedError("not ported yet: " + ", ".join(unsupported))


@torch.inference_mode()
def generate_greedy(model: M.ViTCAP, images: torch.Tensor,
                    od_ids: torch.Tensor,
                    od_token_type_ids: Optional[torch.Tensor],
                    seq_len: torch.Tensor, cfg: ModelConfig,
                    opts: DecodeOptions,
                    ctx: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Greedy decode.  Returns ids (B, 1, max_length), logprobs (B, 1),
    per-step token logprobs (B, A-1), raw argmax tokens, tag logits and the
    selected concept ids."""
    check_supported(cfg, opts)
    A = opts.max_length
    if ctx is None:
        ctx = build_decode_context(model, images, od_ids, od_token_type_ids,
                                   seq_len, cfg, opts)
    dw = _decode_params_cast(model, cfg)
    # f32 context caches, made once: the step's context scores and outputs
    # accumulate in f32 over compute-dtype products, as on the TPU
    step_ctx = dict(ctx, ctx_k=[k.float() for k in ctx["ctx_k"]],
                    ctx_v=[v.float() for v in ctx["ctx_v"]])
    Bb = ctx["ctx_valid"].shape[0]
    dev = ctx["ctx_valid"].device
    cap_k, cap_v = _init_caps(Bb, cfg.decoder_layers, A, cfg.hidden_size,
                              cfg.compute_dtype, cfg.num_attention_heads, dev)

    tokens = torch.full((Bb, A), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = cfg.cls_token_id
    unfin = torch.ones(Bb, device=dev)
    sum_lp = torch.zeros(Bb, device=dev)
    cnt = torch.zeros(Bb, device=dev)
    scores, raw = [], []
    for t in range(1, A):
        logits = decode_step(dw, cap_k, cap_v, step_ctx, tokens[:, t - 1], t,
                             cfg)
        nxt = logits.argmax(-1)                      # first maximum
        # log_softmax at one index: (x - m) - log(sum(exp(x - m)))
        m = logits.amax(-1, keepdim=True)
        shifted = logits.gather(1, nxt[:, None]) - m
        lse = torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
        score = (shifted - lse)[:, 0]
        add = torch.where(unfin > 0, nxt, cfg.pad_token_id)
        tokens[:, t] = add
        sum_lp = sum_lp + score * unfin
        cnt = cnt + unfin
        unfin = unfin * (add != cfg.sep_token_id).float()
        scores.append(score)
        raw.append(nxt)
    # force EOS on rows unfinished at max length
    tokens[:, A - 1] = torch.where(unfin > 0, cfg.sep_token_id,
                                   tokens[:, A - 1])
    logprobs = sum_lp / cnt.clamp_min(1.0)
    return {"ids": tokens[:, None, :], "logprobs": logprobs[:, None],
            "step_scores": torch.stack(scores, dim=1),
            "raw_tokens": torch.stack(raw, dim=1),
            "tag_logits": ctx["tag_logits"], "pred_topk": ctx["pred_topk"]}


def generate(model: M.ViTCAP, images: torch.Tensor, od_ids: torch.Tensor,
             od_token_type_ids: Optional[torch.Tensor],
             seq_len: torch.Tensor, cfg: ModelConfig, opts: DecodeOptions,
             rng: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """Dispatch like the reference `generate`: greedy only so far.  `rng`
    is the generator sampling would draw from; greedy draws nothing."""
    check_supported(cfg, opts)
    return generate_greedy(model, images, od_ids, od_token_type_ids,
                           seq_len, cfg, opts)
