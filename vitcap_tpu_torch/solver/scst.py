"""SCST (self-critical sequence training): CIDEr-D fine-tuning, the port
of vitcap_tpu/solver/scst.py.  One step in three phases:

1. decode (no gradient): TokenSample indices drawn from an explicit
   torch.Generator, one decode context, then greedy decoding (the
   baseline) and K sampled sequences per image from that context;
2. reward (host): the captions, wrapped with ' <eos>', scored by CIDEr-D
   (evals.metrics.CiderD) against the ground truth; advantage = sample
   - greedy baseline, or - the leave-one-out mean of the other samples;
3. gradient: the sampled ids re-scored in one dense forward of the probe
   layout (score_caption_logprobs: real tokens, a MASK probe at each
   position 0..A-1, the context), loss = mean(-mean token logprob *
   advantage), then the global-norm clip and the reference AdamW step.

As in the TPU package, sampling runs without dropout and the scoring is
deterministic.  The port runs eagerly (no jit).  Under a torch.distributed
process group each rank decodes and rewards its own rows against their
own ground truth, as each process of the TPU package does, and the
gradient step is the global batch's: each rank's loss is its share of the
global mean (the ranks' rows counted by one small all-reduce), and the
gradients and metric sums are SUMmed before the clip
(parallel/mesh.py all_reduce_grads).  On a (data, model) grid those sums
run over the data group and a tensor-parallel model's clip sums its split
leaves over the model group, as in solver/train_step.py; decoding and
scoring run the blocks' shards.  The TPU package's `mesh` argument is a
JAX sharding and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..evals.metrics import CiderD
from ..models import decode as D
from ..models import vitcap as M
from ..models.config import ModelConfig
from ..models.layers import NEG_MASK_VALUE, bert_embeddings
from ..parallel.mesh import (all_reduce_grads, all_reduce_sum, mesh_of,
                             split_norm_args)
from .optimization import (AdamWConfig, adamw_update, caption_param_hypers,
                           clip_by_global_norm, warmup_linear)
from .train_step import TrainState


# ---------------------------------------------------------------------------
# reward (host side)
# ---------------------------------------------------------------------------

def wrap_sentence(s: str) -> str:
    """The reference's _wrap_sentence: strip, drop one trailing '.', append
    ' <eos>'."""
    r = s.strip()
    if r.endswith("."):
        r = r[:-1]
    return r + " <eos>"


class ScstReward:
    def __init__(self, cider_cached_tokens: str = "corpus",
                 baseline_type: str = "greedy"):
        """cider_cached_tokens: 'corpus' or the path of a df pickle;
        baseline_type: 'greedy' or 'sample' (leave-one-out)."""
        if baseline_type not in ("greedy", "sample"):
            raise ValueError(f"baseline_type={baseline_type!r}: 'greedy' "
                             f"or 'sample'")
        self.scorer = CiderD(df=cider_cached_tokens)
        self.baseline_type = baseline_type
        self._cur_score: Optional[float] = None

    def __call__(self, gt_res: List[List[str]], greedy_res: List[str],
                 sample_res: List[str]) -> np.ndarray:
        """Per-sample advantages (B * K,) f32; sample i belongs to image
        i // K."""
        B = len(gt_res)
        K = len(sample_res) // B
        gen = list(sample_res)
        gt_idx = [i // K for i in range(len(sample_res))]
        if self.baseline_type == "greedy":
            gen += list(greedy_res)
            gt_idx += list(range(B))
        gts = {i: [wrap_sentence(c) for c in gt_res[gt_idx[i]]]
               for i in range(len(gen))}
        res = {i: [wrap_sentence(g)] for i, g in enumerate(gen)}
        _, scores = self.scorer.compute_score(gts, res)
        if self.baseline_type == "greedy":
            baseline = scores[-B:][:, None]
        else:
            sc = scores[: B * K].reshape(B, K)
            baseline = (sc.sum(1, keepdims=True) - sc) / (K - 1)
        reward = scores[: B * K].reshape(B, K)
        self._cur_score = float(reward.mean())
        return (reward - baseline).reshape(-1).astype(np.float32)

    def get_score(self) -> Optional[float]:
        """The mean CIDEr-D of the last call's samples."""
        return self._cur_score


# ---------------------------------------------------------------------------
# differentiable sequence scoring (probe layout)
# ---------------------------------------------------------------------------

def probe_allow_mask(ctx_valid: torch.Tensor, od_len: int, A: int
                     ) -> torch.Tensor:
    """(Bk, L, L) bool, L = 2A + S: real token t sees real tokens <= t;
    probe t sees real tokens < t and itself; both see the valid context;
    od rows see the valid context, tagCLS and visual rows see tagCLS and
    visual."""
    Bk, S = ctx_valid.shape
    dev = ctx_valid.device
    L = 2 * A + S
    i = torch.arange(A, device=dev)
    allow = torch.zeros(Bk, L, L, dtype=torch.bool, device=dev)
    allow[:, :A, :A] = i[:, None] >= i[None, :]
    allow[:, A:2 * A, :A] = i[:, None] > i[None, :]
    allow[:, A:2 * A, A:2 * A] = torch.eye(A, dtype=torch.bool, device=dev)
    allow[:, :2 * A, 2 * A:] = ctx_valid[:, None, :]
    is_od = torch.arange(S, device=dev) < od_len
    allow[:, 2 * A:, 2 * A:] = torch.where(is_od[None, :, None],
                                           ctx_valid[:, None, :],
                                           ~is_od[None, None, :])
    return allow


def score_caption_logprobs(model: M.ViTCAP, images: torch.Tensor,
                           od_ids: torch.Tensor,
                           od_token_type_ids: Optional[torch.Tensor],
                           seq_len: torch.Tensor,
                           caption_ids: torch.Tensor,
                           cfg: ModelConfig, opts: D.DecodeOptions,
                           target_ids: Optional[torch.Tensor] = None,
                           visual_token_idx: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Mean per-token logprob (Bk,) of captions caption_ids (Bk, A), Bk =
    B * K (each image's context repeated K times), with the decode loop's
    normalisation: the logprobs of the steps where the sentence was still
    unfinished, over their count.  target_ids (Bk, A-1): the raw per-step
    tokens (the decode loop's 'raw_tokens'; its last step may force EOS
    into caption_ids while recording the sampled token's logprob); default
    caption_ids[:, 1:].  Gradients flow through the encoder and decoder."""
    A = opts.max_length
    Bk = caption_ids.shape[0]
    K = Bk // images.shape[0]
    # the decode loop's ids are inference tensors, which autograd cannot
    # save for the backward
    caption_ids = caption_ids.clone()
    if target_ids is not None:
        target_ids = target_ids.clone()
    ce = D.build_context_embeddings(model, images, od_ids,
                                    od_token_type_ids, seq_len, cfg, opts,
                                    visual_token_idx, inference=False)
    ctx, ctx_valid = ce["ctx"], ce["ctx_valid"]
    if K > 1:
        ctx = ctx.repeat_interleave(K, dim=0)
        ctx_valid = ctx_valid.repeat_interleave(K, dim=0)
    dt = cfg.compute_dtype
    dev = caption_ids.device
    emb = model.bert.embeddings
    pos = torch.arange(A, device=dev).expand(Bk, A)
    zeros = torch.zeros_like(pos)
    probe_ids = torch.full((Bk, A), cfg.mask_token_id, dtype=torch.long,
                           device=dev)
    real = bert_embeddings(emb, caption_ids, pos, zeros,
                           cfg.bert_layer_norm_eps, dtype=dt)
    probe = bert_embeddings(emb, probe_ids, pos, zeros,
                            cfg.bert_layer_norm_eps, dtype=dt)
    seq = torch.cat([real, probe, ctx], dim=1)          # (Bk, 2A + S, H)
    allow = probe_allow_mask(ctx_valid, ce["od_len"], A)
    bias = torch.where(allow, 0.0, NEG_MASK_VALUE)[:, None]
    hidden = M.fusion_decoder(model, seq, bias, cfg)
    logits = M.caption_logits(model, hidden[:, A:2 * A], cfg)  # (Bk, A, V)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok = caption_ids[:, 1:] if target_ids is None else target_ids
    lp = logp[:, 1:].gather(-1, tok[..., None].long())[..., 0]  # (Bk, A-1)
    # step t counts while no EOS came among w_1..w_{t-1}
    eos_before = torch.cumsum((caption_ids[:, 1:] == cfg.sep_token_id)
                              .int(), dim=1)
    unfin = torch.cat([torch.ones(Bk, 1, device=dev),
                       (eos_before[:, :-1] == 0).float()], dim=1)
    total = (lp * unfin).sum(1)
    return total / unfin.sum(1).clamp_min(1.0)


# ---------------------------------------------------------------------------
# SCST train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScstConfig:
    num_return: int = 2               # K, the samples per image
    baseline_type: str = "greedy"
    cider_cached_tokens: str = "corpus"
    # TokenSample: the fraction of visual tokens kept during SCST (the
    # reference's random_token_sample, ~0.7)
    visual_token_ratio: float = 1.0


def make_scst_fns(cfg: ModelConfig, opts: D.DecodeOptions,
                  scst: ScstConfig, hyper, mesh=None
                  ) -> Tuple[Callable, Callable]:
    """Returns (decode_fn, grad_step).

    decode_fn(model, images, od_ids, tt, seq_len, generator) ->
        (greedy ids (B, A), sample ids (B*K, A), raw tokens (B*K, A-1),
         TokenSample indices (B, keep), or (B, 0) with every token kept);
        the indices, then the samples, are drawn from `generator`.
    grad_step(state, batch, sample_ids, raw_tokens, advantages, vidx) ->
        (state, metrics): the parameters and moments updated in place.
    hyper: solver.train_step.TrainHyper (base_lr, eps, grad_clip,
    warmup_steps, max_iter, weight_decay, lr_multiplier)."""
    if mesh is not None:
        raise ValueError("make_scst_fns: mesh is a JAX sharding; the port's "
                         "SCST is data-parallel under a torch.distributed "
                         "process group")
    greedy_opts = dataclasses.replace(opts, num_beams=1, do_sample=False,
                                      num_return_sequences=1)
    sample_opts = dataclasses.replace(opts, num_beams=1, do_sample=True,
                                      num_return_sequences=scst.num_return)
    n_vis = cfg.num_visual_tokens
    keep = (int(round(scst.visual_token_ratio * n_vis))
            if scst.visual_token_ratio < 1.0 else n_vis)

    def decode_fn(model, images, od_ids, tt, seq_len,
                  generator: torch.Generator):
        B = images.shape[0]
        vidx = (M.sample_visual_token_idx(generator, B, n_vis, keep)
                .to(od_ids.device) if keep < n_vis else None)
        ctx = D.build_decode_context(model, images, od_ids, tt, seq_len,
                                     cfg, greedy_opts, vidx)
        g = D.generate_greedy(model, images, od_ids, tt, seq_len, cfg,
                              greedy_opts, ctx=ctx)
        s = D.generate_greedy(model, images, od_ids, tt, seq_len, cfg,
                              sample_opts, rng=generator, ctx=ctx)
        A = sample_opts.max_length
        if vidx is None:
            vidx = torch.zeros((B, 0), dtype=torch.long, device=od_ids.device)
        return (g["ids"][:, 0], s["ids"].reshape(-1, A),
                s["raw_tokens"].reshape(-1, A - 1), vidx)

    schedule = warmup_linear(hyper.warmup_steps, hyper.max_iter)
    opt_cfg = AdamWConfig(base_lr=hyper.base_lr, eps=hyper.eps,
                          grad_clip=hyper.grad_clip)
    # the decoder runs over B*K sequences of 2A+S tokens on top of the
    # encoder with gradients: each fusion layer is recomputed in the
    # backward (torch.utils.checkpoint), so one layer's residuals live
    score_cfg = cfg.replace(remat="fusion")
    hypers: Dict[Tuple[str, ...], Any] = {}

    def grad_step(state: TrainState, batch: Dict[str, Any],
                  sample_ids: torch.Tensor, raw_tokens: torch.Tensor,
                  advantages: torch.Tensor, vidx: torch.Tensor
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = dict(state.model.named_parameters())
        for p in params.values():
            p.grad = None
        dp = torch.distributed.is_initialized()
        mesh = mesh_of(state.model)
        group = mesh.data_group if mesh is not None else None
        if dp:            # this rank's share of the global mean
            rows = sample_ids.new_tensor([float(sample_ids.shape[0])],
                                         dtype=torch.float32)
            share = rows[0] / all_reduce_sum(rows, group)[0]
        lp = score_caption_logprobs(
            state.model, batch["image"], batch["od_ids"],
            batch.get("od_token_type_ids"), batch["seq_len"], sample_ids,
            score_cfg, opts, target_ids=raw_tokens,
            visual_token_idx=vidx if vidx.shape[1] > 0 else None)
        loss = torch.mean(-lp * advantages)
        mean_lp = lp.detach().mean()
        if dp:
            loss = loss * share
            mean_lp = mean_lp * share
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if dp:
            grads, sums = all_reduce_grads(
                grads, torch.stack([loss.detach(), mean_lp]), group)
            loss, mean_lp = sums[0], sums[1]
        grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip,
                                           *split_norm_args(state.model))
        key = tuple(params)
        if key not in hypers:
            hypers[key] = caption_param_hypers(
                key, cfg.split_blocks, cfg.num_hidden_layers,
                weight_decay=hyper.weight_decay,
                lr_multiplier=hyper.lr_multiplier)
        lr_mult, wd = hypers[key]
        opt = adamw_update(grads, state.opt, params, lr_mult, wd, opt_cfg,
                           schedule)
        metrics = {"scst_loss": loss.detach(), "grad_norm": gnorm,
                   "mean_logprob": mean_lp}
        return TrainState(state.model, opt, state.generator), metrics

    return decode_fn, grad_step


def scst_train_step(decode_fn: Callable, grad_step: Callable,
                    reward: ScstReward, tokenizer, state: TrainState,
                    batch: Dict[str, Any], gt_captions: List[List[str]],
                    generator: torch.Generator, mesh=None
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """One SCST iteration: decode, the host's reward, the gradient step.
    tokenizer: anything with decode(ids, skip_special_tokens=True), e.g.
    data.tokenization.CaptionDecoder.  metrics adds 'cider_score', the
    mean CIDEr-D of this rank's samples.  With a process group, batch and
    gt_captions are this rank's rows."""
    if mesh is not None:
        raise ValueError("scst_train_step: mesh is a JAX sharding; the "
                         "port's SCST is data-parallel under a "
                         "torch.distributed process group")
    greedy_ids, sample_ids, raw_tokens, vidx = decode_fn(
        state.model, batch["image"], batch["od_ids"],
        batch.get("od_token_type_ids"), batch["seq_len"], generator)
    greedy = [tokenizer.decode(r, skip_special_tokens=True)
              for r in greedy_ids.tolist()]
    samples = [tokenizer.decode(r, skip_special_tokens=True)
               for r in sample_ids.tolist()]
    adv = torch.from_numpy(reward(gt_captions, greedy, samples)).to(
        sample_ids.device)
    state, metrics = grad_step(state, batch, sample_ids, raw_tokens, adv,
                               vidx)
    metrics = dict(metrics)
    metrics["cider_score"] = reward.get_score()
    return state, metrics
