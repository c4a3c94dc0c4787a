"""Caption decoding with a prefilled context cache: greedy, sampling and
beam search, the port of vitcap_tpu/models/decode.py.

- the vision trunk + tag head run once per image (build_decode_context);
- the fusion decoder's static context (od/tag slots, tagger-CLS, visual
  tokens) is prefilled once into per-layer K/V caches: three fused BERT
  layers, plus the K/V projections of every layer (the last layer's body
  feeds nothing and is skipped); one copy per image, shared by its beams
  and return sequences;
- each step runs the decoder layers over the 2-token window
  [prev@t-1, MASK@t] against the caption cache, itself and the context,
  and writes prev's K/V into the caption cache (in place); beam reorder
  gathers only the small caption caches.

Two engines run the step behind one (init, step, reorder) interface,
selected as the TPU package selects them (_pick_layout):
- 'heads' (the default): the step in eager PyTorch over per-layer
  (B, nH, S, hd) caches, f32 context copies or the int8 context cache
  (cfg.kv_cache_quant='int8');
- 'flat' (VITCAP_DECODE_FUSED=1): ops/decode_step.fused_decode_step over
  (nL, B, S, H) caches, 28 kernel launches per step on a CUDA device, its
  plain version on the CPU.  int8 caches win over it, with a warning.

Sampling draws from explicit torch.Generators, whose streams differ from
the TPU package's jax.random streams (same distributions).

Tensor parallelism (parallel/mesh.py shard_params): both engines run the
decoder layers' shard (their TPShard, `tp`) on the rank's heads: the
context and caption caches hold those heads, the out-projection and fc2
partials are summed over the model axis at every layer and step, and the
tag head, the tag selection and the LM head are replicated, so every rank
picks the same tokens.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.decode_step import (fused_decode_step, pack_decode_context,
                               pack_decode_layers)
from ..ops.fused_block import pad_len
from ..parallel.tensor_parallel import all_reduce_tp, local_heads, tp_of
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
                             opts: DecodeOptions,
                             visual_token_idx: Optional[torch.Tensor] = None,
                             inference: bool = True) -> Dict[str, Any]:
    """Vision + tag selection + the context embeddings [od/tag slots,
    tagCLS, visual] and their validity mask (B, S_ctx).  visual_token_idx
    (B, keep): the visual tokens kept (TokenSample, see
    vitcap.encode).  inference=False runs vitcap.encode outside inference
    mode, so gradients flow into the context (SCST scoring); True runs
    encode_images, whose tensors cannot enter autograd."""
    B, od_len = od_ids.shape
    dtype = cfg.compute_dtype
    dev = od_ids.device
    enc = (M.encode_images if inference else M.encode)(
        model, images, cfg, visual_token_idx)
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
    ctx = torch.cat([od_emb[:, :od_len - topk],
                     _tag_embeddings(model, enc["pred_topk"], cfg),
                     enc["tag_cls"].to(dtype),
                     enc["visual"].to(dtype)], dim=1)      # (B, S_ctx, H)
    S_ctx = ctx.shape[1]
    od_j = torch.arange(od_len, device=dev) + opts.max_length
    od_valid = od_j[None] < seq_len[:, None]
    ctx_valid = torch.cat(
        [od_valid, torch.ones(B, S_ctx - od_len, dtype=torch.bool,
                              device=dev)], dim=1)
    return {"ctx": ctx, "ctx_valid": ctx_valid, "od_len": od_len,
            "tag_logits": enc["tag_logits"], "pred_topk": enc["pred_topk"]}


NEG_INF = -1e9  # beam bookkeeping sentinel (the reference uses -1e9 / -1e5)


def _use_fused_decode() -> bool:
    """The fused engine (ops/decode_step.py) is opt-in, as in the TPU
    package: VITCAP_DECODE_FUSED=1 (or =interpret, the TPU package's CPU
    spelling, which selects the same engine here)."""
    return os.environ.get("VITCAP_DECODE_FUSED", "0").lower() in (
        "1", "interpret")


def _pick_layout(cfg: ModelConfig) -> str:
    """'flat' when the fused engine is asked for, else 'heads'.  int8
    context caches exist only in the 'heads' layout: the int8 option wins
    over the fused engine, with a warning, rather than being dropped."""
    if _use_fused_decode():
        if cfg.kv_cache_quant != "none":
            logging.warning(
                "kv_cache_quant=%s is unsupported by the fused decode "
                "engine; using the eager engine with quantized caches",
                cfg.kv_cache_quant)
            return "heads"
        return "flat"
    return "heads"


def _quantize_cache_proj(a: torch.Tensor, nH: int, hd: int
                         ) -> Dict[str, torch.Tensor]:
    """Per-(image, head) absmax int8 quantization of a (B, S, nH*hd)
    projection -> {'q8': (B, nH, S, hd) int8, 'scale': (B, nH, 1, 1) f32}."""
    B, S, _ = a.shape
    a4 = a.reshape(B, S, nH, hd).float()
    absmax = a4.abs().amax(dim=(1, 3))                        # (B, nH)
    scale = absmax.clamp_min(1e-8) / 127.0
    q8 = torch.clamp(torch.round(a4 / scale[:, None, :, None]), -127, 127)
    return {"q8": q8.to(torch.int8).transpose(1, 2).contiguous(),
            "scale": scale[:, :, None, None]}


def _quantize_rows(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization over the last axis (the q and
    probability operands of the int8 products)."""
    scale = a.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q8 = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q8, scale


def _int8_sum_dtype(n: int) -> torch.dtype:
    """A float type whose sums of n int8 x int8 products are exact integers
    (f32 while n * 127^2 < 2^24), standing in for the int32 accumulator."""
    return torch.float32 if n * 127 * 127 < 2 ** 24 else torch.float64


@torch.inference_mode()
def build_decode_context(model: M.ViTCAP, images: torch.Tensor,
                         od_ids: torch.Tensor,
                         od_token_type_ids: Optional[torch.Tensor],
                         seq_len: torch.Tensor, cfg: ModelConfig,
                         opts: DecodeOptions,
                         visual_token_idx: Optional[torch.Tensor] = None,
                         layout: Optional[str] = None) -> Dict[str, Any]:
    """build_context_embeddings (with visual_token_idx) + the decoder K/V
    prefill over the static context.

    layout=None picks as _pick_layout(cfg) does.
    'heads': per-layer (B, nH, S_ctx, hd) lists (int8 dicts under
    kv_cache_quant='int8') for the eager engine.
    'flat': (nL, B, S_ctx, H) K/V and the (B, S_ctx) additive f32 context
    bias (ops/decode_step.pack_decode_context) for the fused engine.

    The prefill runs padded to pad_len(S_ctx): padded key columns get the
    reference's -10000 mask, padded query rows are garbage and are sliced
    off with the caches."""
    if layout is None:
        layout = _pick_layout(cfg)
    if layout not in ("heads", "flat"):
        raise ValueError(f"layout={layout!r}: 'heads' or 'flat'")
    if cfg.kv_cache_quant not in ("none", "int8"):
        raise ValueError(f"kv_cache_quant={cfg.kv_cache_quant!r}: 'none' or "
                         f"'int8'")
    quant = layout == "heads" and cfg.kv_cache_quant == "int8"
    ce = build_context_embeddings(model, images, od_ids, od_token_type_ids,
                                  seq_len, cfg, opts, visual_token_idx)
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
    layers = model.bert.decoder.layer
    nH_local = local_heads(_decoder_shard(model), nH)
    pad = pad_len(S_ctx) - S_ctx
    x = F.pad(ctx, (0, 0, 0, pad))
    bias = F.pad(bias, (0, 0, 0, pad))
    bias = F.pad(bias, (0, pad), value=NEG_MASK_VALUE)

    def cache(a):
        a = a[:, :S_ctx]
        if layout == "flat":
            return a.contiguous()
        if quant:
            return _quantize_cache_proj(a, nH_local, hd)
        return a.reshape(B, S_ctx, nH_local, hd).transpose(1, 2).contiguous()

    ctx_k: List[Any] = []
    ctx_v: List[Any] = []
    for li, layer in enumerate(layers):
        ps = layer.attention.self
        ctx_k.append(cache(dense(ps.key, x)))
        ctx_v.append(cache(dense(ps.value, x)))
        if li + 1 < len(layers):
            x = bert_layer(layer, x, bias, nH, cfg.bert_layer_norm_eps,
                           scores_dtype=cfg.attention_scores_dtype)
    out = {"ctx_valid": ctx_valid, "tag_logits": ce["tag_logits"],
           "pred_topk": ce["pred_topk"]}
    if layout == "flat":
        k, v, cbias = pack_decode_context(ctx_k, ctx_v, ctx_valid)
        out.update(ctx_k=k, ctx_v=v, ctx_bias=cbias)
    else:
        out.update(ctx_k=ctx_k, ctx_v=ctx_v)
    return out


def _decoder_shard(model: M.ViTCAP):
    """The decoder layers' TPShard (one for all layers), or None."""
    layers = model.bert.decoder.layer
    return tp_of(layers[0]) if len(layers) else None


def _ctx_layout(ctx: Dict[str, Any]) -> str:
    return "flat" if "ctx_bias" in ctx else "heads"


def _ctx_batch(ctx: Dict[str, Any]) -> int:
    return ctx["ctx_valid"].shape[0]


def _step_params(model: M.ViTCAP, cfg: ModelConfig) -> Dict[str, Any]:
    """What both engines read around the decoder layers: the embeddings,
    the word embeddings in the compute dtype, the LM head."""
    return {"embeddings": model.bert.embeddings,
            "word": M.word_embedding_weight(model).to(cfg.compute_dtype),
            "head": model.cls.predictions}


def _decode_params_cast(model: M.ViTCAP, cfg: ModelConfig) -> Dict[str, Any]:
    """_step_params plus the decoder layers' weights for the eager step,
    cast to the compute dtype once (LayerNorms stay f32) and with q/k/v
    merged into one (3H, H) matrix per layer; each layer's TPShard and
    heads."""
    dt = cfg.compute_dtype
    layers = []
    for layer in model.bert.decoder.layer:
        ps, po = layer.attention.self, layer.attention.output
        tp = tp_of(layer)
        layers.append({
            "tp": tp, "heads": local_heads(tp, cfg.num_attention_heads),
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
    return dict(_step_params(model, cfg), layers=layers)


# ---------------------------------------------------------------------------
# the eager ('heads') step
# ---------------------------------------------------------------------------

def _lin(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.t() + b


def _row_lin(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tp
             ) -> torch.Tensor:
    """_lin of a row-split layer: the f32 partial products summed over the
    model axis, rounded once, then the bias (_lin without a shard)."""
    if tp is None:
        return _lin(x, w, b)
    return all_reduce_tp(x.float() @ w.float().t(), tp).to(x.dtype) + b


def _decode_attention(lw: Dict[str, Any], x_win: torch.Tensor,
                      cap_k: torch.Tensor, cap_v: torch.Tensor,
                      ctx_k: Any, ctx_v: Any, ctx_valid: torch.Tensor,
                      t: int, num_heads: int) -> torch.Tensor:
    """Window [prev@t-1, MASK@t] attention against the caption cache (slots
    <= t-1), the MASK row's own K/V, and the context cache (per od
    validity).  cap_* (Bb, h, A, d) are updated in place at slot t-1;
    ctx_* are per-image (B, h, S, d) f32 copies shared by the Bb rows, or
    int8 dicts {'q8': float copy of the int8 values, 'scale'}.  H below is
    the width of the layer's num_heads heads (a shard's under tensor
    parallelism)."""
    Bb, W, _ = x_win.shape
    H = lw["qkv_w"].shape[0] // 3
    quant = isinstance(ctx_k, dict)
    k_arr = ctx_k["q8"] if quant else ctx_k
    B, _, S, _ = k_arr.shape
    nb = Bb // B
    hd = H // num_heads
    A = cap_k.shape[2]
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
    q5 = qf.reshape(B, nb, num_heads, W, hd)
    if quant:
        # int8 x int8 products summed exactly (as the TPU's int32 dot),
        # rescaled per q row and per (image, head)
        q8, q_scale = _quantize_rows(q5)
        s32 = torch.einsum("bnhqd,bhkd->bnhqk", q8.to(k_arr.dtype), k_arr)
        s_ctx = s32.float() * q_scale * ctx_k["scale"][:, None, :, :, 0:1]
    else:
        s_ctx = torch.einsum("bnhqd,bhkd->bnhqk", q5, ctx_k)
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
    e_ctx5 = e_ctx.reshape(B, nb, num_heads, W, S)
    if quant:
        # the per-row absmax of e equals that of e / l, so these are the
        # int8 bits of the quantized probabilities
        p8, p_scale = _quantize_rows(e_ctx5)
        o32 = torch.einsum("bnhqk,bhkd->bnhqd", p8.to(ctx_v["q8"].dtype),
                           ctx_v["q8"])
        o_ctx = o32.float() * p_scale * ctx_v["scale"][:, None, :, :, 0:1]
    else:
        o_ctx = torch.einsum("bnhqk,bhkd->bnhqd", e_ctx5.to(dt).float(),
                             ctx_v)
    out = out + o_ctx.reshape(Bb, num_heads, W, hd)
    out = (out * inv).to(dt)
    return out.transpose(1, 2).reshape(Bb, W, H)


def _decode_layer(lw: Dict[str, Any], x_win: torch.Tensor, cap_k, cap_v,
                  ctx_k, ctx_v, ctx_valid, t: int, cfg: ModelConfig
                  ) -> torch.Tensor:
    eps = cfg.bert_layer_norm_eps
    attn = _decode_attention(lw, x_win, cap_k, cap_v, ctx_k, ctx_v,
                             ctx_valid, t, lw["heads"])
    attn = _row_lin(attn, lw["out_w"], lw["out_b"], lw["tp"])
    x = layer_norm(lw["ln1"], attn + x_win, eps)
    out = _row_lin(gelu(_lin(x, lw["inter_w"], lw["inter_b"])),
                   lw["out2_w"], lw["out2_b"], lw["tp"])
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


def _logits(dw: Dict[str, Any], x_win: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """f32 caption logits (Bb, V) read at the MASK row."""
    tied = dw["word"] if cfg.tie_weights else None
    return lm_head(dw["head"], x_win[:, 1], cfg.bert_layer_norm_eps,
                   tied).float()


def decode_step(dw: Dict[str, Any], cap_k: List[torch.Tensor],
                cap_v: List[torch.Tensor], ctx: Dict[str, Any],
                prev_tok: torch.Tensor, t: int, cfg: ModelConfig
                ) -> torch.Tensor:
    """One eager MASK-probe step: f32 logits (Bb, V); the caches are
    updated in place.  ctx['ctx_k'/'ctx_v'] are the engine's f32 (or int8
    float) copies."""
    x = _window_embeddings(dw, prev_tok, t, cfg)
    for li, lw in enumerate(dw["layers"]):
        x = _decode_layer(lw, x, cap_k[li], cap_v[li], ctx["ctx_k"][li],
                          ctx["ctx_v"][li], ctx["ctx_valid"], t, cfg)
    return _logits(dw, x, cfg)


def _init_caps(B: int, n_layers: int, A: int, H: int, dtype: torch.dtype,
               num_heads: int, device) -> Tuple[List[torch.Tensor],
                                                List[torch.Tensor]]:
    hd = H // num_heads

    def zeros():
        return [torch.zeros(B, num_heads, A, hd, dtype=dtype, device=device)
                for _ in range(n_layers)]
    return zeros(), zeros()


# ---------------------------------------------------------------------------
# the two engines
# ---------------------------------------------------------------------------

Engine = Tuple[Callable[[], Any], Callable[..., Tuple[torch.Tensor, Any]],
               Callable[[Any, torch.Tensor], Any]]


def _decode_engine(model: M.ViTCAP, ctx: Dict[str, Any], cfg: ModelConfig,
                   opts: DecodeOptions, Bb: int) -> Engine:
    """(init, step, reorder) over either context layout.

    init() -> caches; step(caches, prev (Bb,), t) -> (f32 logits (Bb, V),
    caches), the caches updated in place; reorder(caches, flat_idx) ->
    caches gathered by row (beam reorder)."""
    A = opts.max_length
    nL = cfg.decoder_layers
    dt = cfg.compute_dtype
    dev = ctx["ctx_valid"].device
    tp = _decoder_shard(model)
    heads = local_heads(tp, cfg.num_attention_heads)
    # the caches' width: the rank's heads under tensor parallelism
    H = cfg.hidden_size // cfg.num_attention_heads * heads

    if _ctx_layout(ctx) == "flat":
        dw = _step_params(model, cfg)
        packed = pack_decode_layers(model, dt)
        ts = torch.arange(A, dtype=torch.int32, device=dev)  # t on the device

        def init():
            z = torch.zeros(nL, Bb, A, H, dtype=dt, device=dev)
            return z, torch.zeros_like(z)

        def step(caches, prev, t):
            cap_k, cap_v = caches
            x = _window_embeddings(dw, prev, t, cfg)
            x = fused_decode_step(packed, ctx["ctx_k"], ctx["ctx_v"],
                                  ctx["ctx_bias"], cap_k, cap_v, x, ts[t],
                                  num_heads=heads,
                                  eps=cfg.bert_layer_norm_eps, tp=tp)
            return _logits(dw, x, cfg), caches

        def reorder(caches, flat_idx):
            return tuple(c.index_select(1, flat_idx) for c in caches)

        return init, step, reorder

    dw = _decode_params_cast(model, cfg)
    S = ctx["ctx_valid"].shape[1]

    def step_cache(c):
        # f32 copies made once: the step's context scores and outputs
        # accumulate in f32 over compute-dtype values, as on the TPU
        if isinstance(c, dict):
            n = max(S, cfg.hidden_size)
            return {"q8": c["q8"].to(_int8_sum_dtype(n)),
                    "scale": c["scale"]}
        return c.float()
    step_ctx = dict(ctx, ctx_k=[step_cache(c) for c in ctx["ctx_k"]],
                    ctx_v=[step_cache(c) for c in ctx["ctx_v"]])

    def init():
        return _init_caps(Bb, nL, A, H, dt, heads, dev)

    def step(caches, prev, t):
        cap_k, cap_v = caches
        return decode_step(dw, cap_k, cap_v, step_ctx, prev, t, cfg), caches

    def reorder(caches, flat_idx):
        return tuple([c.index_select(0, flat_idx) for c in cs]
                     for cs in caches)

    return init, step, reorder


# ---------------------------------------------------------------------------
# decode options: top-k, repetition penalty, sampling filter
# ---------------------------------------------------------------------------

def exact_top_k(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, values descending, ties to the lower
    index (like lax.top_k).  torch.topk promises no tie order, so this is a
    stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """CTRL-style repetition penalty: for every vocab id already in the
    row's prefix (`seen`, a (Bb, V) bool mask including BOS, and PAD once a
    row has finished), divide positive logits by `penalty` and multiply
    negative ones."""
    pen = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, pen, logits)


def _seen_init(Bb: int, V: int, first_token: int, device) -> torch.Tensor:
    seen = torch.zeros(Bb, V, dtype=torch.bool, device=device)
    seen[:, first_token] = True
    return seen


def _seen_add(seen: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    seen[torch.arange(seen.shape[0], device=seen.device), tok] = True
    return seen


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 1.0,
                          min_tokens_to_keep: int = 1) -> torch.Tensor:
    """The reference's sampling filter: logits outside the top k, or
    outside the smallest set whose probability exceeds top_p, become
    NEG_INF (at least min_tokens_to_keep survive)."""
    V = logits.shape[-1]
    if top_k > 0:
        k = max(top_k, min_tokens_to_keep)
        kth = torch.sort(logits, dim=-1).values[..., V - k, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        remove = cum > top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]),
                            remove[..., :-1]], dim=-1)
        remove[..., :min_tokens_to_keep] = False
        scatter = torch.zeros_like(remove).scatter(-1, sort_idx, remove)
        logits = torch.where(scatter, NEG_INF, logits)
    return logits


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _generator(rng: Optional[torch.Generator], device) -> torch.Generator:
    """The caller's generator, or one seeded 0 on the tensors' device (the
    TPU package's PRNGKey(0) default)."""
    return rng if rng is not None else \
        torch.Generator(device=device).manual_seed(0)


# ---------------------------------------------------------------------------
# greedy / sampling (no beam)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def generate_greedy(model: M.ViTCAP, images: torch.Tensor,
                    od_ids: torch.Tensor,
                    od_token_type_ids: Optional[torch.Tensor],
                    seq_len: torch.Tensor, cfg: ModelConfig,
                    opts: DecodeOptions,
                    rng: Optional[torch.Generator] = None,
                    ctx: Optional[Dict[str, Any]] = None,
                    visual_token_idx: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """No-beam decode, greedy or sampled.  Returns ids (B[, nrs], 1 or
    nrs, max_length), logprobs, per-step token logprobs (Bb, A-1), the raw
    argmax/sampled tokens, tag logits and the selected concept ids.  `ctx`
    (build_decode_context) may be given to reuse a context; else one is
    built, on the visual_token_idx subset when given."""
    A = opts.max_length
    nrs = opts.num_return_sequences
    if ctx is None:
        ctx = build_decode_context(model, images, od_ids, od_token_type_ids,
                                   seq_len, cfg, opts, visual_token_idx)
    B = _ctx_batch(ctx)
    Bb = B * nrs
    dev = ctx["ctx_valid"].device
    init, engine_step, _ = _decode_engine(model, ctx, cfg, opts, Bb)
    caches = init()
    gen = _generator(rng, dev) if opts.do_sample else None
    rep_pen = float(opts.repetition_penalty)
    seen = (_seen_init(Bb, cfg.vocab_size, cfg.cls_token_id, dev)
            if rep_pen != 1.0 else None)

    tokens = torch.full((Bb, A), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = cfg.cls_token_id
    unfin = torch.ones(Bb, device=dev)
    sum_lp = torch.zeros(Bb, device=dev)
    cnt = torch.zeros(Bb, device=dev)
    scores, raw = [], []
    for t in range(1, A):
        logits, caches = engine_step(caches, tokens[:, t - 1], t)
        if seen is not None:
            logits = apply_repetition_penalty(logits, seen, rep_pen)
        if opts.do_sample:
            lg = logits / opts.temperature if opts.temperature != 1.0 \
                else logits
            lg = top_k_top_p_filtering(lg, opts.top_k, opts.top_p)
            nxt = (lg + _gumbel(lg.shape, gen, dev)).argmax(-1)
        else:
            lg = logits
            nxt = logits.argmax(-1)                  # first maximum
        # log_softmax at one index: (x - m) - log(sum(exp(x - m)))
        m = lg.amax(-1, keepdim=True)
        shifted = lg.gather(1, nxt[:, None]) - m
        lse = torch.log(torch.exp(lg - m).sum(-1, keepdim=True))
        score = (shifted - lse)[:, 0]
        add = torch.where(unfin > 0, nxt, cfg.pad_token_id)
        tokens[:, t] = add
        sum_lp = sum_lp + score * unfin
        cnt = cnt + unfin
        unfin = unfin * (add != cfg.sep_token_id).float()
        if seen is not None:
            seen = _seen_add(seen, add)
        scores.append(score)
        raw.append(nxt)
    # force EOS on rows unfinished at max length
    tokens[:, A - 1] = torch.where(unfin > 0, cfg.sep_token_id,
                                   tokens[:, A - 1])
    logprobs = sum_lp / cnt.clamp_min(1.0)
    ids, lp = tokens[:, None, :], logprobs[:, None]
    if nrs > 1:
        ids, lp = ids.reshape(B, nrs, A), lp.reshape(B, nrs)
    return {"ids": ids, "logprobs": lp,
            "step_scores": torch.stack(scores, dim=1),
            "raw_tokens": torch.stack(raw, dim=1),
            "tag_logits": ctx["tag_logits"], "pred_topk": ctx["pred_topk"]}


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def sample_beam_candidates(logits: torch.Tensor, beam_scores: torch.Tensor,
                           gen: torch.Generator, nb: int,
                           opts: DecodeOptions
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampled-beam candidate draw.  Per beam row: temperature and the
    top-k/top-p filter (min_tokens_to_keep=2), then 2 words drawn without
    replacement (Gumbel top-2); a candidate's score is that beam's filtered
    log-softmax at the word plus the beam's score.

    Returns (cand_score, cand_idx), each (B, 2*nb).  cand_idx is
    `word + V*beam` exactly as the reference builds it: the words are laid
    out interleaved [b0d0, b0d1, b1d0, ...] but the beam offsets are tiled
    [0, V, .., (nb-1)V, 0, V, ..], so for nb > 1 candidate j extends beam
    j % nb's prefix while carrying beam j // 2's score.  That is the
    reference's observable behaviour and is kept."""
    Bb, V = logits.shape
    B = Bb // nb
    lg = logits / opts.temperature if opts.temperature != 1.0 else logits
    lg = top_k_top_p_filtering(lg, opts.top_k, opts.top_p,
                               min_tokens_to_keep=2)
    _, draws = exact_top_k(lg + _gumbel(lg.shape, gen, lg.device), 2)
    dscore = torch.log_softmax(lg, dim=-1).gather(1, draws) \
        + beam_scores.reshape(Bb)[:, None]
    words = draws.reshape(B, 2 * nb)
    offs = (torch.arange(nb, device=words.device) * V).repeat(2)[None]
    return dscore.reshape(B, 2 * nb), words + offs


@torch.inference_mode()
def generate_beam(model: M.ViTCAP, images: torch.Tensor,
                  od_ids: torch.Tensor,
                  od_token_type_ids: Optional[torch.Tensor],
                  seq_len: torch.Tensor, cfg: ModelConfig,
                  opts: DecodeOptions,
                  rng: Optional[torch.Generator] = None,
                  ctx: Optional[Dict[str, Any]] = None,
                  visual_token_idx: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Beam search with the reference's semantics: 2 candidates per beam;
    EOS candidates (and at the last step every candidate) go to a
    num_keep_best-sized hypothesis store scored sum_logprob / len^penalty;
    a batch row is done once its store is full and no candidate can beat
    its worst entry; done rows freeze.  do_sample=True takes the
    sampled-beam branch (sample_beam_candidates).  `ctx` and
    visual_token_idx as in generate_greedy.  Returns ids (B, K, A) and
    logprobs (B, K), K = num_keep_best."""
    A = opts.max_length
    nb = opts.num_beams
    K = opts.num_keep_best
    lp_pow = opts.length_penalty
    if ctx is None:
        ctx = build_decode_context(model, images, od_ids, od_token_type_ids,
                                   seq_len, cfg, opts, visual_token_idx)
    B = _ctx_batch(ctx)
    Bb = B * nb
    dev = ctx["ctx_valid"].device
    init, engine_step, reorder = _decode_engine(model, ctx, cfg, opts, Bb)
    caches = init()
    gen = _generator(rng, dev) if opts.do_sample else None
    rep_pen = float(opts.repetition_penalty)
    seen = (_seen_init(Bb, cfg.vocab_size, cfg.cls_token_id, dev)
            if rep_pen != 1.0 else None)
    pad, n_cand = cfg.pad_token_id, 2 * nb
    rows = torch.arange(B, device=dev)[:, None]

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    tokens = full((B, nb, A), pad, torch.long)
    tokens[:, :, 0] = cfg.cls_token_id
    beam_scores = full((B, nb), NEG_INF)
    beam_scores[:, 0] = 0.0
    hs = full((B, K), NEG_INF)                     # hypothesis store
    ht = full((B, K, A), pad, torch.long)
    hl = full((B, K), 0, torch.long)
    hn = full((B,), 0, torch.long)
    done = full((B,), False, torch.bool)

    for t in range(1, A):
        logits, caches = engine_step(caches, tokens[:, :, t - 1].reshape(Bb),
                                     t)
        if seen is not None:
            logits = apply_repetition_penalty(logits, seen, rep_pen)
        V = logits.shape[-1]
        if opts.do_sample:
            cand_score, cand_idx = sample_beam_candidates(
                logits, beam_scores, gen, nb, opts)
        else:
            total = torch.log_softmax(logits, dim=-1).view(B, nb, V) \
                + beam_scores[..., None]
            cand_score, cand_idx = exact_top_k(total.view(B, nb * V), n_cand)
        cand_beam = cand_idx // V
        cand_word = cand_idx % V

        # done check before this step's insertions (the reference's order);
        # the reference normalizes by (max_length - 1), not the length
        best_possible = cand_score.amax(1) / (float(A - 1) ** lp_pow)
        done = done | ((hn >= K) & (best_possible <= hs.amin(-1)))

        final = t == A - 1
        to_hyp = (torch.ones_like(cand_word, dtype=torch.bool) if final
                  else cand_word == cfg.sep_token_id)
        # candidates are scanned in order until nb non-EOS ones are taken;
        # EOS candidates before that cut go to the store
        not_hyp = (~to_hyp).long()
        before_cut = (torch.ones_like(to_hyp) if final
                      else (not_hyp.cumsum(1) - not_hyp) < nb)
        take_hyp = to_hyp & before_cut & ~done[:, None]

        # insert: the K best of (store + taken candidates), one stable sort
        # (existing entries win exact ties, as the reference's strict `>`)
        cand_tokens = tokens.gather(
            1, cand_beam[..., None].expand(B, n_cand, A))
        cand_len = full((B, n_cand), t, torch.long)
        norm = torch.where(take_hyp,
                           cand_score / (cand_len.float() ** lp_pow),
                           NEG_INF)
        all_s = torch.cat([hs, norm], dim=1)
        order = torch.sort(all_s, dim=1, descending=True,
                           stable=True).indices[:, :K]
        hs = all_s.gather(1, order)
        hl = torch.cat([hl, cand_len], dim=1).gather(1, order)
        ht = torch.cat([ht, cand_tokens], dim=1).gather(
            1, order[..., None].expand(B, K, A))
        hn = (hn + take_hyp.sum(1)).clamp_max(K)

        # next beams: the first nb candidates that stay out of the store
        keep = ~to_hyp & before_cut
        rank = keep.long().cumsum(1) - 1
        order = torch.sort(torch.where(keep, rank, n_cand + 1), dim=1,
                           stable=True).indices[:, :nb]
        new_beam = cand_beam.gather(1, order)
        new_word = cand_word.gather(1, order)
        new_score = cand_score.gather(1, order)
        # done rows freeze (scores 0, PAD), and so do the slots left empty
        # when fewer than nb candidates were kept (only at the last step)
        empty = torch.arange(nb, device=dev)[None] >= keep.sum(1)[:, None]
        frozen = done[:, None] | empty
        new_beam = torch.where(frozen, 0, new_beam)
        new_word = torch.where(frozen, pad, new_word)
        new_score = torch.where(frozen, 0.0, new_score)

        tokens = tokens.gather(1, new_beam[..., None].expand(B, nb, A))
        tokens[:, :, t] = new_word
        beam_scores = new_score
        flat_idx = (rows * nb + new_beam).reshape(Bb)
        caches = reorder(caches, flat_idx)
        if seen is not None:
            # each mask follows its beam's prefix, then takes the new word
            seen = _seen_add(seen[flat_idx], new_word.reshape(Bb))

    # final selection: the K best hypotheses, EOS written after each
    order = torch.sort(hs, dim=-1, descending=True, stable=True).indices
    sel_scores = hs.gather(1, order)
    sel_tokens = ht.gather(1, order[..., None].expand(B, K, A))
    sel_len = hl.gather(1, order)[..., None]
    posn = torch.arange(A, device=dev)[None, None]
    sel_tokens = torch.where(posn < sel_len, sel_tokens, pad)
    sel_tokens = torch.where(posn == sel_len, cfg.sep_token_id, sel_tokens)
    sel_scores = torch.where(torch.arange(K, device=dev)[None]
                             >= hn[:, None], -1e5, sel_scores)
    return {"ids": sel_tokens, "logprobs": sel_scores,
            "tag_logits": ctx["tag_logits"], "pred_topk": ctx["pred_topk"]}


def generate(model: M.ViTCAP, images: torch.Tensor, od_ids: torch.Tensor,
             od_token_type_ids: Optional[torch.Tensor],
             seq_len: torch.Tensor, cfg: ModelConfig, opts: DecodeOptions,
             rng: Optional[torch.Generator] = None,
             visual_token_idx: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Dispatch like the reference `generate`: beam search for
    num_beams > 1, else greedy or sampling.  `rng` is the generator
    sampling draws from (on the images' device; default seed 0);
    visual_token_idx (B, keep) the visual tokens the encoder keeps
    (TokenSample, vitcap.sample_visual_token_idx)."""
    if opts.num_beams > 1:
        return generate_beam(model, images, od_ids, od_token_type_ids,
                             seq_len, cfg, opts, rng,
                             visual_token_idx=visual_token_idx)
    return generate_greedy(model, images, od_ids, od_token_type_ids,
                           seq_len, cfg, opts, rng,
                           visual_token_idx=visual_token_idx)


def prod_generate(model: M.ViTCAP, image: torch.Tensor, cfg: ModelConfig,
                  opts: Optional[DecodeOptions] = None,
                  od_ids: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Production greedy decode of one image (H, W, 3) or a batch, with
    empty od labels and the default options of cfg."""
    if opts is None:
        opts = DecodeOptions(max_length=cfg.max_gen_length,
                             od_labels_start_posid=cfg.max_seq_a_len)
    if image.dim() == 3:
        image = image[None]
    B = image.shape[0]
    if od_ids is None:
        od_ids = torch.zeros(B, cfg.max_seq_len - cfg.max_seq_a_len,
                             dtype=torch.long, device=image.device)
    seq_len = torch.full((B,), cfg.max_seq_a_len, device=image.device)
    return generate_greedy(model, image, od_ids, None, seq_len, cfg, opts)
