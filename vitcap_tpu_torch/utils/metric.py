"""Tag-metric meters: multi-label accuracy, per-class AP / mAP, probes;
the port's copy of vitcap_tpu/utils/metric.py.

Numpy re-implementation of the reference meters (ViTCAP
src/tools/metric.py:40-280) and the train-time tag probes
(logit_to_label / label_to_label used at …bertemb.py:124-163).  Every
input may be a numpy array or a torch tensor (on any device: it is
copied to the host)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _np(x, dtype=None) -> np.ndarray:
    """A numpy array of `x`; a torch tensor is detached and copied to the
    host first."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":   # numpy has no bfloat16
            x = x.float()
        x = x.numpy()
    return np.asarray(x, dtype)


class AverageMeter:
    def __init__(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MultiLabelAccuracy:
    """Per-sample top-k precision: for each sample with k positive labels,
    the fraction of its top-k scored classes that are positives x100
    (reference metric.py:40-100)."""

    def __init__(self):
        self.accuracy = AverageMeter()

    def calc(self, output, target) -> None:
        output = _np(output)
        target = _np(target)
        num_labels = target.sum(axis=1)
        valid = np.nonzero(num_labels)[0]
        n = len(valid)
        if n == 0:
            return
        maxk = max(1, int(num_labels.max()))
        pred_topk = np.argsort(-output, axis=1)[:, :maxk]
        acc = 0.0
        for i in valid:
            k = int(num_labels[i])
            hits = target[i, pred_topk[i, :k]].sum()
            acc += hits * 100.0 / num_labels[i]
        self.accuracy.update(acc / n, n)

    def prec(self) -> float:
        return self.accuracy.avg


class APMeter:
    """Per-class average precision over accumulated (scores, targets)
    (reference metric.py:123-280, torchnet semantics)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._scores: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def add(self, output, target):
        output = np.atleast_2d(_np(output, np.float64))
        target = np.atleast_2d(_np(target, np.float64))
        if output.shape != target.shape:
            raise ValueError(f"scores {output.shape} and targets "
                             f"{target.shape} differ in shape")
        self._scores.append(output)
        self._targets.append(target)

    def value(self) -> np.ndarray:
        if not self._scores:
            return np.zeros(0)
        scores = np.concatenate(self._scores, axis=0)
        targets = np.concatenate(self._targets, axis=0)
        K = scores.shape[1]
        ap = np.zeros(K)
        for k in range(K):
            order = np.argsort(-scores[:, k], kind="stable")
            t = targets[order, k]
            if t.sum() == 0:
                ap[k] = 0.0
                continue
            ranks = np.arange(1, len(t) + 1)
            prec = np.cumsum(t) / ranks
            ap[k] = (prec * t).sum() / t.sum()
        return ap


class mAPMeter:
    def __init__(self):
        self.ap = APMeter()

    def reset(self):
        self.ap.reset()

    def add(self, output, target):
        self.ap.add(output, target)

    def value(self) -> float:
        v = self.ap.value()
        return float(v.mean()) if v.size else 0.0


def logit_to_label(tag_logits, vocab: Dict[int, str], topk: int = 50,
                   threshold: Optional[float] = None) -> List[List[str]]:
    """Decode predicted tag logits to token strings (reference probe)."""
    probs = 1.0 / (1.0 + np.exp(-_np(tag_logits, np.float64)))
    out = []
    for row in probs:
        idx = np.argsort(-row)[:topk]
        if threshold is not None:
            idx = [i for i in idx if row[i] >= threshold]
        out.append([vocab[int(i)] for i in idx])
    return out


def label_to_label(labels, vocab: Dict[int, str]) -> List[List[str]]:
    return [[vocab[int(i)] for i in np.nonzero(_np(row))[0]]
            for row in labels]
