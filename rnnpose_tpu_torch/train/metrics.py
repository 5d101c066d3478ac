"""Running training metrics (port of `rnnpose_tpu/train/metrics.py`;
reference `torchplus/metrics.py:7+`): scalar, accuracy and precision/recall
accumulators on the host, and a dict of running scalars. Outside the
training loop's path, part of the reference's public surface. Inputs are
numpy arrays or CPU tensors."""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["RunningScalar", "RunningAccuracy", "PrecisionRecall", "MetricDict"]


class RunningScalar:
    """Streaming mean of a scalar."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.total += float(value) * n
        self.count += n

    @property
    def value(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0


class RunningAccuracy:
    """Streaming accuracy over boolean hits."""

    def __init__(self):
        self.hits = 0
        self.count = 0

    def update(self, pred, target):
        pred = np.asarray(pred)
        target = np.asarray(target)
        self.hits += int((pred == target).sum())
        self.count += pred.size

    @property
    def value(self) -> float:
        return self.hits / max(self.count, 1)

    def reset(self):
        self.hits, self.count = 0, 0


class PrecisionRecall:
    """Streaming binary precision/recall."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.fn = 0

    def update(self, scores, labels):
        pred = np.asarray(scores) >= self.threshold
        lab = np.asarray(labels) >= 0.5
        self.tp += int((pred & lab).sum())
        self.fp += int((pred & ~lab).sum())
        self.fn += int((~pred & lab).sum())

    @property
    def precision(self) -> float:
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self) -> float:
        return self.tp / max(self.tp + self.fn, 1)

    def reset(self):
        self.tp = self.fp = self.fn = 0


class MetricDict:
    """Dict of running scalars with a one-call update."""

    def __init__(self):
        self._m: Dict[str, RunningScalar] = {}

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self._m.setdefault(k, RunningScalar()).update(float(v))

    def summary(self) -> Dict[str, float]:
        return {k: m.value for k, m in self._m.items()}

    def reset(self):
        for m in self._m.values():
            m.reset()
