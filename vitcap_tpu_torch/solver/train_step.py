"""The training step, the port of vitcap_tpu/solver/train_step.py:
forward (loss dict) -> backward -> global-norm clip -> the reference AdamW
step with its param groups and schedule.

Where the TPU package jits one function over donated state, the port runs
eagerly and updates the model's parameters and the Adam moments in place.
Dropout randomness comes from the state's explicit torch.Generator (the
TPU package's train_rng key): each step draws its decoder-layer seeds and
embedding masks from it.

Under a torch.distributed process group the step is data-parallel and
equals the TPU package's step over the global (data-sharded) batch: each
rank runs its own rows, the masked loss is divided by the global batch's
weight sum (one small all-reduce before the forward) and the BCE tag loss
by its rows, so that the ranks' losses and gradients sum to the global
ones; the gradients and the metrics' sums are SUMmed in flat buckets
after the backward (parallel/mesh.py all_reduce_grads), before the clip,
so the clip's norm and the AdamW update are the same on every rank.  The
reported metrics are the global batch's.  Each rank's dropout draws from
its own generator (the pipeline seeds it from the seed and the rank), so
with dropout on, the masks differ from the TPU package's one draw over the
global batch.

On a (data, model) grid (parallel/mesh.py shard_params; the model records
its grid) every one of those sums runs over the data group: the ranks of
one model group hold the same rows and replicated sums, which a sum over
the world would count n_model times.  With tensor_parallel=True the
blocks run their shards (ops/fused_block.py), the clip's norm sums the
split leaves' squares over the model group and counts the replicated
leaves once, and AdamW updates each shard elementwise as it is.  The
ranks of one model group draw from generators with one seed
(parallel/mesh.py rank_seed over the data rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models import vitcap as M
from ..models.config import ModelConfig
from ..parallel.mesh import (all_reduce_grads, all_reduce_sum, mesh_of,
                             split_norm_args)
from .optimization import (SCHEDULES, AdamWConfig, AdamWState, adamw_init,
                           adamw_update, caption_param_hypers,
                           clip_by_global_norm)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt: AdamWState
    generator: Optional[torch.Generator]   # None: no dropout


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Training-recipe knobs (live YAML + pipeline defaults)."""
    base_lr: float = 1e-4
    weight_decay: float = 0.05
    lr_multiplier: float = 0.1
    warmup_steps: int = 0
    max_iter: int = 10000
    scheduler_type: str = "linear"
    grad_clip: float = 1.0
    eps: float = 1e-8
    bias_no_weight_decay: bool = True
    ln_no_weight_decay: bool = True


def init_train_state(model: torch.nn.Module,
                     generator: Optional[torch.Generator]) -> TrainState:
    """Turns on the model's gradients and zeroes the Adam moments."""
    model.requires_grad_(True)
    return TrainState(model, adamw_init(dict(model.named_parameters())),
                      generator)


def _caption_acc_sums(class_logits: torch.Tensor, masked_ids: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(hits, weight) sums over the weighted masked slots."""
    hit = (class_logits.argmax(-1) == masked_ids).float() * weight
    return torch.stack([hit.sum(), weight.sum()])


def caption_acc(class_logits: torch.Tensor, masked_ids: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Train-time caption token accuracy over the weighted masked slots."""
    hits, w = _caption_acc_sums(class_logits, masked_ids, weight)
    return hits / w.clamp_min(1.0)


def _tag_precision_sums(tag_logits: torch.Tensor, label: torch.Tensor
                        ) -> torch.Tensor:
    """(sum of the per-sample hit rates, samples with a positive)."""
    k = label.sum(1)
    order = torch.argsort(-tag_logits.float(), dim=1, stable=True)
    lab_sorted = (label > 0).gather(1, order)
    pos = torch.arange(label.shape[1], device=label.device)[None]
    hits = (lab_sorted & (pos < k[:, None])).sum(1)
    valid = k > 0
    per = torch.where(valid, 100.0 * hits / k.clamp_min(1), 0.0)
    return torch.stack([per.sum(), valid.sum().float()])


def tag_precision(tag_logits: torch.Tensor, label: torch.Tensor
                  ) -> torch.Tensor:
    """Per-sample top-k hit rate, k = the sample's number of positives, in
    percent, averaged over the samples with a positive (MultiLabelAccuracy).
    One stable sort of the logits, as the TPU package does."""
    per, valid = _tag_precision_sums(tag_logits, label)
    return per / valid.clamp_min(1)


def make_train_step(cfg: ModelConfig, hyper: TrainHyper,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """Returns step(state, batch, with_probes=True, layer_seeds=None) ->
    (state, metrics).  The parameters' .grad keep the step's unclipped
    gradients until the next step.  loss_fn(model, batch, cfg, generator,
    layer_seeds) -> (loss, aux); defaults to forward_train.  layer_seeds,
    when given, are the decoder's per-layer dropout seeds for this step.
    With a process group the step is data-parallel (module docstring): the
    batch is this rank's rows, and loss_fn must read the batch's
    masked_weight_total and rows_total as forward_train does."""
    if loss_fn is None:
        loss_fn = M.forward_train
    schedule = SCHEDULES[hyper.scheduler_type](hyper.warmup_steps,
                                               hyper.max_iter)
    opt_cfg = AdamWConfig(base_lr=hyper.base_lr, eps=hyper.eps,
                          grad_clip=hyper.grad_clip)
    hypers: Dict[Tuple[str, ...], Any] = {}

    def step(state: TrainState, batch: Dict[str, Any],
             with_probes: bool = True,
             layer_seeds: Optional[Sequence[Sequence[int]]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = dict(state.model.named_parameters())
        for p in params.values():
            p.grad = None
        dp = torch.distributed.is_initialized()
        mesh = mesh_of(state.model)
        group = mesh.data_group if mesh is not None else None
        if dp:
            _, w = M.masked_slots(batch["masked_pos"], batch["masked_ids"],
                                  cfg.max_masked_tokens)
            rows = torch.tensor([float(batch["input_ids"].shape[0])],
                                device=w.device)
            totals = all_reduce_sum(torch.cat([w.sum()[None], rows]), group)
            batch = dict(batch, masked_weight_total=totals[0],
                         rows_total=totals[1])
        loss, aux = loss_fn(state.model, batch, cfg, state.generator,
                            layer_seeds)
        loss.backward()
        # a parameter the loss does not reach has a zero gradient, which
        # the clip's norm and the Adam moments see, as in the TPU package
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        sums = {"loss": loss.detach(),
                "masked_loss": aux.get("masked_loss", loss).detach()}
        if "tag_loss" in aux:
            sums["tag_loss"] = aux["tag_loss"].detach()
        if with_probes:
            with torch.no_grad():
                if "class_logits" in aux and "masked_weight" in aux:
                    sums["caption_acc"] = _caption_acc_sums(
                        aux["class_logits"], batch["masked_ids"],
                        aux["masked_weight"])
                if "tag_logits" in aux and "label" in batch:
                    sums["tag_precision"] = _tag_precision_sums(
                        aux["tag_logits"], batch["label"])
        if dp:
            flat = torch.cat([v.float().reshape(-1) for v in sums.values()])
            grads, flat = all_reduce_grads(grads, flat, group)
            sums = dict(zip(sums, flat.split([v.numel()
                                              for v in sums.values()])))
            sums = {k: v.reshape(()) if v.numel() == 1 else v
                    for k, v in sums.items()}
        grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip,
                                           *split_norm_args(state.model))
        key = tuple(params)
        if key not in hypers:
            hypers[key] = caption_param_hypers(
                key, cfg.split_blocks, cfg.num_hidden_layers,
                weight_decay=hyper.weight_decay,
                lr_multiplier=hyper.lr_multiplier,
                bias_no_weight_decay=hyper.bias_no_weight_decay,
                ln_no_weight_decay=hyper.ln_no_weight_decay)
        lr_mult, wd = hypers[key]
        lr_sched = schedule(state.opt.step)
        opt = adamw_update(grads, state.opt, params, lr_mult, wd, opt_cfg,
                           schedule)
        metrics = {"loss": sums["loss"], "grad_norm": gnorm,
                   "lr_mult": torch.tensor(lr_sched),
                   "masked_loss": sums["masked_loss"]}
        if "tag_loss" in sums:
            metrics["tag_loss"] = sums["tag_loss"]
        if "caption_acc" in sums:
            hits, w = sums["caption_acc"]
            metrics["caption_acc"] = hits / w.clamp_min(1.0)
        if "tag_precision" in sums:
            per, valid = sums["tag_precision"]
            metrics["tag_precision"] = per / valid.clamp_min(1)
        return TrainState(state.model, opt, state.generator), metrics

    return step
