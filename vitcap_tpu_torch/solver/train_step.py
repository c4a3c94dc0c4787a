"""The training step, the port of vitcap_tpu/solver/train_step.py:
forward (loss dict) -> backward -> global-norm clip -> the reference AdamW
step with its param groups and schedule.

Where the TPU package jits one function over donated state, the port runs
eagerly and updates the model's parameters and the Adam moments in place.
Dropout randomness comes from the state's explicit torch.Generator (the
TPU package's train_rng key): each step draws its decoder-layer seeds and
embedding masks from it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models import vitcap as M
from ..models.config import ModelConfig
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


def caption_acc(class_logits: torch.Tensor, masked_ids: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Train-time caption token accuracy over the weighted masked slots."""
    hit = (class_logits.argmax(-1) == masked_ids).float() * weight
    return hit.sum() / weight.sum().clamp_min(1.0)


def tag_precision(tag_logits: torch.Tensor, label: torch.Tensor
                  ) -> torch.Tensor:
    """Per-sample top-k hit rate, k = the sample's number of positives, in
    percent, averaged over the samples with a positive (MultiLabelAccuracy).
    One stable sort of the logits, as the TPU package does."""
    k = label.sum(1)
    order = torch.argsort(-tag_logits.float(), dim=1, stable=True)
    lab_sorted = (label > 0).gather(1, order)
    pos = torch.arange(label.shape[1], device=label.device)[None]
    hits = (lab_sorted & (pos < k[:, None])).sum(1)
    valid = k > 0
    per = torch.where(valid, 100.0 * hits / k.clamp_min(1), 0.0)
    return per.sum() / valid.sum().clamp_min(1)


def make_train_step(cfg: ModelConfig, hyper: TrainHyper,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """Returns step(state, batch, with_probes=True, layer_seeds=None) ->
    (state, metrics).  The parameters' .grad keep the step's unclipped
    gradients until the next step.  loss_fn(model, batch, cfg, generator,
    layer_seeds) -> (loss, aux); defaults to forward_train.  layer_seeds,
    when given, are the decoder's per-layer dropout seeds for this step.
    cfg.train_fused_blocks=True raises ValueError (not ported)."""
    M.check_train_config(cfg)
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
        loss, aux = loss_fn(state.model, batch, cfg, state.generator,
                            layer_seeds)
        loss.backward()
        # a parameter the loss does not reach has a zero gradient, which
        # the clip's norm and the Adam moments see, as in the TPU package
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip)
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
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "lr_mult": torch.tensor(lr_sched),
                   "masked_loss": aux.get("masked_loss", loss).detach()}
        if "tag_loss" in aux:
            metrics["tag_loss"] = aux["tag_loss"].detach()
        if with_probes:
            with torch.no_grad():
                if "class_logits" in aux and "masked_weight" in aux:
                    metrics["caption_acc"] = caption_acc(
                        aux["class_logits"], batch["masked_ids"],
                        aux["masked_weight"])
                if "tag_logits" in aux and "label" in batch:
                    metrics["tag_precision"] = tag_precision(
                        aux["tag_logits"], batch["label"])
        return TrainState(state.model, opt, state.generator), metrics

    return step
