"""Multi-label tag losses, the port of vitcap_tpu/models/losses.py.

FocalLossWithLogitsNegLoss (the live tag loss, summed by forward_train) and
the distilled, soft and smoothed variants of alternative tagger recipes.
Each returns the ELEMENTWISE loss, as the reference modules do; callers
sum or average it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_neg_loss(pred: torch.Tensor, target: torch.Tensor,
                   alpha: float = 0.5, gamma: float = 1.0) -> torch.Tensor:
    """FocalLossWithLogitsNegLoss."""
    p = torch.sigmoid(pred)
    pos = (target == 1) * alpha * torch.pow(1.0 - p, gamma) * \
        F.logsigmoid(pred)
    neg = (target == 0) * (1 - alpha) * torch.pow(p, gamma) * \
        F.logsigmoid(-pred)
    return -(pos + neg)


def _weight(target: torch.Tensor, alpha: float) -> torch.Tensor:
    w = torch.where(target == 0, 1.0 - alpha, 0.0)
    return torch.where(target > 1e-5, alpha, w)


def distill_focal_neg_loss(pred: torch.Tensor, target: torch.Tensor,
                           guide: torch.Tensor, alpha: float = 0.5,
                           gamma: float = 1.0, t: float = 1.0
                           ) -> torch.Tensor:
    """DistillFocalLossWithLogitsNegLoss: teacher-guided soft targets
    (sigmoid(guide / t)) with |p - target|^gamma focusing."""
    p = torch.sigmoid(pred)
    pg = torch.sigmoid(guide / t)
    coef = _weight(target, alpha) * torch.pow(torch.abs(p - target), gamma)
    loss = pg * F.logsigmoid(pred) + (1.0 - pg) * F.logsigmoid(-pred)
    return -(coef * loss)


def soft_focal_neg_loss(pred: torch.Tensor, target: torch.Tensor,
                        alpha: float = 0.5, gamma: float = 1.0
                        ) -> torch.Tensor:
    """FocalLossWithLogitsNegSoftLoss: soft (fractional) targets."""
    p = torch.sigmoid(pred)
    coef = _weight(target, alpha) * torch.pow(torch.abs(p - target), gamma)
    loss = target * F.logsigmoid(pred) + \
        (1.0 - target) * F.logsigmoid(-pred)
    return -(coef * loss)


def smooth_focal_bce_loss(logits: torch.Tensor, target: torch.Tensor,
                          alpha: float = 0.5, gamma: float = 1.0,
                          pos: float = 0.9, neg: float = 0.1
                          ) -> torch.Tensor:
    """FocalSmoothBCEWithLogitsNegLoss: label-smoothed focal BCE with
    distinct positive and negative soft values."""
    p = torch.sigmoid(logits)
    ls, lsi = F.logsigmoid(logits), F.logsigmoid(-logits)
    coef_p = (target == 1) * alpha * torch.pow(torch.abs(pos - p), gamma)
    loss = coef_p * (pos * ls + (1 - pos) * lsi)
    coef_n = (target == 0) * (1 - alpha) * \
        torch.pow(torch.abs(p - neg), gamma)
    loss = loss + coef_n * (neg * ls + (1 - neg) * lsi)
    return -loss
