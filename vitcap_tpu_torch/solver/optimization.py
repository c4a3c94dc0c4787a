"""Optimizer and learning-rate schedules, the port of
vitcap_tpu/solver/optimization.py (the reference solver's math).

- AdamW ("MAdamW"): denom = sqrt(v) + eps with eps outside the bias
  correction, the correction folded into the step size, and decoupled
  weight decay scaled by the group's lr (schedule included), applied to the
  value AFTER the Adam step.  torch.optim.AdamW decays before the step, so
  the update is written out with tensor ops.
- Schedules: multipliers of the base lr as functions of the step, read at
  the pre-increment step (torch LambdaLR: iteration k uses lambda(k)).
- Param groups: weight decay 0 for every '*bias*' leaf and for
  'LayerNorm.weight' only (the ViT norm1/norm2 scales do decay, the
  reference's string test); lr multiplier (0.1) on the trunk blocks below
  the fork, the tag blocks, the tag pooler and tag_logit.

State is plain tensors keyed by parameter name; the update runs in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# schedules (multiplier on the base lr)
# ---------------------------------------------------------------------------

def warmup_linear(warmup_steps: int, t_total: int) -> Callable:
    def f(step):
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        return max(0.0, (t_total - step) / max(1.0, t_total - warmup_steps))
    return f


def warmup_constant(warmup_steps: int) -> Callable:
    def f(step):
        return step / max(1.0, warmup_steps) if step < warmup_steps else 1.0
    return f


def warmup_cosine(warmup_steps: int, t_total: int, cycles: float = 0.5
                  ) -> Callable:
    def f(step):
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, t_total - warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0
                                              * progress)))
    return f


def warmup_cosine_hard_restarts(warmup_steps: int, t_total: int,
                                cycles: float = 1.0) -> Callable:
    """`cycles` cosine decays, each restarting at 1."""
    def f(step):
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, t_total - warmup_steps)
        if progress >= 1.0:
            return 0.0
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi
                                              * ((cycles * progress) % 1.0))))
    return f


def warmup_cosine_annealing(max_iter: int, warmup_steps: int = 500,
                            min_lr_ratio: float = 0.0,
                            warmup_factor: float = 1.0 / 3) -> Callable:
    """WarmupCosineAnnealingLR with linear warmup; min_lr as a ratio of the
    base lr."""
    def f(step):
        if step < warmup_steps:
            alpha = step / max(1.0, warmup_steps)
            return warmup_factor * (1 - alpha) + alpha
        return min_lr_ratio + (1.0 - min_lr_ratio) * \
            (1.0 + math.cos(math.pi * step / max_iter)) / 2.0
    return f


def warmup_multi_step(warmup_steps: int, milestones, gamma: float = 0.1,
                      warmup_factor: float = 1.0 / 3) -> Callable:
    """WarmupMultiStepLR: linear warmup from warmup_factor, then
    gamma ** (milestones passed)."""
    ms = sorted(milestones)

    def f(step):
        warm = 1.0
        if step < warmup_steps:
            alpha = step / max(1.0, warmup_steps) if warmup_steps > 0 else 1.0
            warm = warmup_factor * (1 - alpha) + alpha
        return warm * gamma ** sum(step >= m for m in ms)
    return f


def constant_schedule() -> Callable:
    return lambda step: 1.0


# every entry takes (warmup_steps, t_total), as make_train_step calls it
SCHEDULES = {
    "linear": warmup_linear,
    "warmup_constant": lambda warmup_steps, t_total=None:
        warmup_constant(warmup_steps),
    "warmup_cosine": warmup_cosine,
    "warmup_cosine_hard_restarts": warmup_cosine_hard_restarts,
    "cosine_annealing": lambda warmup_steps, t_total:
        warmup_cosine_annealing(t_total, warmup_steps=warmup_steps),
    # the maskrcnn milestones: 2/3 and 8/9 of the run
    "multistep": lambda warmup_steps, t_total: warmup_multi_step(
        warmup_steps, (int(t_total * 2 / 3), int(t_total * 8 / 9))),
}


# ---------------------------------------------------------------------------
# param groups
# ---------------------------------------------------------------------------

def caption_param_hypers(names: Iterable[str], split_blocks: int,
                         num_hidden_layers: int, weight_decay: float = 0.05,
                         lr_multiplier: float = 0.1,
                         bias_no_weight_decay: bool = True,
                         ln_no_weight_decay: bool = True
                         ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(lr multiplier, weight decay) per parameter name of the port's
    ViTCAP (its state-dict names)."""
    fork = num_hidden_layers - split_blocks
    lr, wd = {}, {}
    for name in names:
        parts = name.split(".")
        w = weight_decay
        if bias_no_weight_decay and "bias" in parts[-1]:
            w = 0.0
        if ln_no_weight_decay and parts[-2:] == ["LayerNorm", "weight"]:
            w = 0.0
        mult = 1.0
        if parts[:3] == ["bert", "encoder", "blocks"] and int(parts[3]) < fork:
            mult = lr_multiplier                      # shared blocks
        elif parts[:3] == ["bert", "encoder", "tag_blocks"]:
            mult = lr_multiplier
        elif parts[0] == "bert" and parts[1] in ("pooler", "tag_logit"):
            mult = lr_multiplier
        lr[name], wd[name] = mult, w
    return lr, wd


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamWState:
    step: int
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    base_lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    correct_bias: bool = True
    grad_clip: float = 1.0     # global norm


def adamw_init(params: Tensors) -> AdamWState:
    return AdamWState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                      {n: torch.zeros_like(p) for n, p in params.items()})


def _square_sum(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return sum(t.float().square().sum() for t in tensors)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(_square_sum(tensors))


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        split: Iterable[str] = (),
                        reduce_split: Optional[Callable] = None
                        ) -> Tuple[Tensors, torch.Tensor]:
    """torch.nn.utils.clip_grad_norm_ semantics: scale by
    max_norm / (norm + 1e-6) only when that is below 1.  Returns the
    scaled gradients and the norm before scaling (a device tensor).
    Tensor parallelism: `split` names the leaves split over the model
    axis, whose squared sum reduce_split sums over it; the replicated
    leaves are counted once."""
    split = set(split)
    if split:
        norm = torch.sqrt(
            _square_sum(g for n, g in grads.items() if n not in split)
            + reduce_split(_square_sum(grads[n] for n in split)))
    else:
        norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, \
        norm


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamWState, params: Tensors,
                 lr_mult: Dict[str, float], wd: Dict[str, float],
                 cfg: AdamWConfig, schedule: Callable) -> AdamWState:
    """One reference-AdamW step, in place on `params` and the moments of
    `state`; returns the state with its step advanced."""
    sched = schedule(state.step)
    t = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    bias_c = (math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
              if cfg.correct_bias else 1.0)
    for name, p in params.items():
        g = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_(g * g * (1.0 - b2))
        lr = cfg.base_lr * lr_mult[name] * sched
        newp = p.float() - (lr * bias_c) * m / (v.sqrt() + cfg.eps)
        newp = newp - (lr * wd[name]) * newp
        p.copy_(newp)
    return AdamWState(t, state.mu, state.nu)
