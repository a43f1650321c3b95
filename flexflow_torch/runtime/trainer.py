"""The training loop, with the reference's measurement protocol.

The port of ``flexflow_tpu/runtime/trainer.py``: ``Trainer.fit`` runs
warmup steps outside the timed region, then ``iterations`` steps with no
per-step wait on the device, ending in one fence, and prints the
reference's ``tp = iters*batch/elapsed`` samples/s (``cnn.cc:122-129``,
``dlrm.cc:159-166``).  On CUDA the fence is ``torch.cuda.synchronize()``
followed by a read of the last step's metrics: a read alone would wait
only for the loss, which the device computes before that step's backward
and update.

This slice ports the plain per-step (k=1) loop on one fixed synthetic
batch, and ``evaluate``, the read-only pass of ``--eval-iters``.
Supersteps (``steps_per_call > 1``), gradient accumulation,
checkpoints, telemetry, traces and ``--profiling`` come with later
slices (ROADMAP.md queue 1) and are refused by name; so do user batch
iterators and prefetching loaders (the data-plane slice).
``MAX_STEPS_PER_CALL`` and ``relay_safe_steps`` are kept as the JAX
package has them: the serving loop clamps its decode steps per
superstep through them.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.metrics import PerfMetrics

_log = logging.getLogger("ff.trainer")

#: Most fused steps between two host readbacks.
MAX_STEPS_PER_CALL = 20


def relay_safe_steps(k: int, what: str = "steps_per_call",
                     log: logging.Logger = _log) -> int:
    """Clamp a fused step count to ``[1, MAX_STEPS_PER_CALL]``, warning
    when it cuts."""
    k = int(k)
    if k > MAX_STEPS_PER_CALL:
        log.warning("%s=%d exceeds the fused-step cap; clamping to %d",
                    what, k, MAX_STEPS_PER_CALL)
        return MAX_STEPS_PER_CALL
    return max(1, k)


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"Trainer.fit: {what} is not ported yet; this slice of the port "
        f"runs the plain per-step loop (ROADMAP.md queue 1)")


class Trainer:
    def __init__(self, executor):
        self.ex = executor
        self.metrics = PerfMetrics()

    def synthetic_batch(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Device-resident synthetic inputs (reference: syntheticInput,
        ``config.h:73``), the JAX package's numpy draw: integer inputs
        in ``{0, 1}``."""
        return self.ex.shard_batch(synthetic_host_batch(
            self.ex.model, np.random.default_rng(seed)))

    def _fence(self, m: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Wait for every queued step, then read ``m`` to the host."""
        if self.ex.device.type == "cuda":
            torch.cuda.synchronize(self.ex.device)
        return {k: v.item() for k, v in m.items()}

    def fit(
        self,
        iterations: int,
        warmup: int = 1,
        log_every: int = 0,
        checkpoint=None,
        accum_steps: int = 1,
        steps_per_call: int = 1,
    ) -> Dict[str, Any]:
        """Run ``warmup`` untimed and ``iterations`` timed steps from
        ``ex.init()`` on one fixed synthetic batch; returns throughput
        stats computed with the reference formula.  The stats carry,
        beside the JAX package's keys, ``step_losses``: every step's
        loss, warmup included, read after the final fence."""
        cfg = self.ex.config
        if steps_per_call > 1:
            _refuse("steps_per_call > 1 (superstep execution)")
        if accum_steps > 1:
            _refuse("accum_steps > 1 (gradient accumulation)")
        if checkpoint is not None:
            _refuse("checkpointing")
        if cfg.telemetry_dir:
            _refuse("telemetry (--telemetry)")
        if cfg.trace_dir:
            _refuse("tracing (--trace)")
        if cfg.profiling:
            _refuse("--profiling")
        if iterations <= 0:
            raise ValueError("fit() needs at least one iteration")
        return self._fit_plain(iterations, warmup, log_every)

    def _fit_plain(self, iterations: int, warmup: int,
                   log_every: int) -> Dict[str, Any]:
        """The per-step (k=1) training loop; see :meth:`fit`."""
        ex = self.ex
        params, opt_state, state = ex.init()
        batch = self.synthetic_batch()
        losses = []
        m = None
        # Warmup outside the timed region (first-call allocations, the
        # kernels' build and load).  Warmup steps are real updates.
        for _ in range(warmup):
            params, opt_state, state, m = ex.train_step(
                params, opt_state, state, batch)
            losses.append(m["train_loss"])
        if m is not None:
            self._fence(m)

        start = time.perf_counter()
        for it in range(iterations):
            params, opt_state, state, m = ex.train_step(
                params, opt_state, state, batch)
            losses.append(m["train_loss"])
            if log_every and (it + 1) % log_every == 0:
                self.metrics.update(self._fence(m))
                print(f"iter {it+1}: {self.metrics.report()}")
        # The execution fence (dlrm.cc:159-162): every queued step done,
        # then the final step's metrics read back.
        final_m = self._fence(m)
        elapsed = time.perf_counter() - start

        self.metrics.update(final_m)
        batch_size = ex.model.input_tensors[0].shape[0]
        throughput = iterations * batch_size / elapsed
        # Reference printout formulas (cnn.cc:128-129, dlrm.cc:165-166).
        print(f"time = {elapsed:.4f}s")
        print(f"tp = {throughput:.2f} samples/s")
        #: The trained (params, opt_state, state) of the run that just
        #: finished, for evaluation after training.
        self.final = (params, opt_state, state)
        return {
            "elapsed_s": elapsed,
            "samples_per_s": throughput,
            "iterations": iterations,
            "batch_size": batch_size,
            "loss": float(self.metrics.avg_loss),
            "step_losses": [float(x) for x in losses],
        }

    def evaluate(self, params, state, batches: Iterable[Dict[str, Any]],
                 iterations: Optional[int] = None) -> Dict[str, float]:
        """Held-out evaluation over ``batches`` (host or device dicts):
        the mean loss and the accuracy.  Each step's metrics are read back
        as they come, so this loop waits on the device every step."""
        ex = self.ex
        pm = PerfMetrics()
        for it, batch in enumerate(batches):
            if iterations is not None and it >= iterations:
                break
            _, m = ex.eval_step(params, state, batch)
            pm.update(self._fence(m))
        return {"loss": pm.avg_loss, "accuracy": pm.accuracy,
                "batches": pm.steps}
