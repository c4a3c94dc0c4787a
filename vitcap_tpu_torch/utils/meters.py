"""Windowed meters for train/predict logging, the port's copy of
vitcap_tpu/utils/meters.py.

Behavioral reference: ViTCAP src/tools/logger.py (SmoothedValue :7-37,
MetricLogger :40-80).
"""

from __future__ import annotations

import math
from collections import defaultdict, deque
from typing import Deque, Dict


class SmoothedValue:
    """Track a series of values with access to the windowed median/avg and the
    global average."""

    def __init__(self, window_size: int = 20):
        self.deque: Deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        s = sorted(self.deque)
        n = len(s)
        if n == 0:
            return 0.0
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())

    def get_info(self) -> Dict[str, Dict[str, float]]:
        """Serializable meter snapshot (the reference's
        ForwardPassTimeChecker.get_time_info returned 'Not implemented';
        this actually reports)."""
        return {name: {"median": m.median, "global_avg": m.global_avg,
                       "count": m.count}
                for name, m in self.meters.items()}




class MeanSigmaMetricLogger:
    """Accumulate mean and standard deviation per key (used by the
    forward-pass profiler)."""

    def __init__(self, delimiter: str = "  "):
        self._sum: Dict[str, float] = defaultdict(float)
        self._sumsq: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self.delimiter = delimiter

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            v = float(v)
            self._sum[k] += v
            self._sumsq[k] += v * v
            self._count[k] += 1

    def get_info(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k in self._sum:
            n = self._count[k]
            mean = self._sum[k] / n
            var = max(self._sumsq[k] / n - mean * mean, 0.0)
            out[k] = {"mean": mean, "sigma": math.sqrt(var), "count": n}
        return out

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{k}: {v['mean']:.4f}\u00b1{v['sigma']:.4f}"
            for k, v in self.get_info().items())
