"""Training metrics: the port's copy of ``flexflow_tpu/metrics.py``.

Reference: ``PerfMetrics`` (``include/model.h:128-132``) accumulated by
device atomicAdd inside the MSELoss backward kernels and folded across
shards via Legion future chaining + ``UPDATE_METRICS_TASK``
(``src/runtime/model.cc:597-627``, ``src/ops/mse_loss.cu:213-221``).
Here per-step metrics come out of the train step as device scalars; this
class does the host-side running accumulation and printing (``update``
reads them, so call it only where the loop fences anyway).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

#: The reference-format keys ``report()`` renders in its fixed layout.
_KNOWN_KEYS = ("train_loss", "train_correct", "train_all")


@dataclasses.dataclass
class PerfMetrics:
    train_loss: float = 0.0
    train_correct: int = 0
    train_all: int = 0
    steps: int = 0
    #: Running SUMS of any extra scalar metrics a loss op emits (e.g.
    #: grad_norm, aux losses) — previously dropped silently.
    extras: Dict[str, float] = dataclasses.field(default_factory=dict)

    def update(self, step_metrics) -> None:
        """Fold one step's metrics dict (0-d tensors ok).  Unknown
        keys accumulate into :attr:`extras` instead of vanishing;
        non-scalar values are ignored."""
        self.train_loss += float(step_metrics.get("train_loss", 0.0))
        self.train_correct += int(step_metrics.get("train_correct", 0))
        self.train_all += int(step_metrics.get("train_all", 0))
        for k, v in step_metrics.items():
            if k in _KNOWN_KEYS:
                continue
            try:
                self.extras[k] = self.extras.get(k, 0.0) + float(v)
            except (TypeError, ValueError):
                continue  # non-scalar extras have no running mean
        self.steps += 1

    @property
    def avg_loss(self) -> float:
        return self.train_loss / max(self.steps, 1)

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(self.train_all, 1)

    def avg_extra(self, key: str) -> float:
        """Running mean of one extra metric."""
        return self.extras[key] / max(self.steps, 1)

    def report(self) -> str:
        # Mirrors update_metrics_task's printout (model.cc:597-627).
        # The reference-format prefix is BIT-IDENTICAL to the old line;
        # extra metrics (when any exist) append after it, sorted.
        line = (
            f"[Metrics] loss={self.avg_loss:.6f} "
            f"accuracy={100.0 * self.accuracy:.2f}% "
            f"({self.train_correct}/{self.train_all})"
        )
        for k in sorted(self.extras):
            line += f" {k}={self.avg_extra(k):.6f}"
        return line
