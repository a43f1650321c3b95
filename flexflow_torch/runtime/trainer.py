"""The training loop, with the reference's measurement protocol.

The port of ``flexflow_tpu/runtime/trainer.py``: ``Trainer.fit`` runs
warmup steps outside the timed region, then ``iterations`` steps with no
per-step wait on the device, ending in one fence, and prints the
reference's ``tp = iters*batch/elapsed`` samples/s (``cnn.cc:122-129``,
``dlrm.cc:159-166``).  On CUDA the fence of the per-step loop is
``torch.cuda.synchronize()`` followed by a read of the last step's
metrics: a read alone would wait only for the loss, which the device
computes before that step's backward and update.

Both of the JAX package's single-program loops run, on one fixed
synthetic batch: the per-step loop (``steps_per_call=1``) and the
superstep loop (``steps_per_call=K``: K steps per call of
``Executor.build_superstep``, one CUDA graph on CUDA, with one host
readback of the stacked metrics per superstep), each with gradient
accumulation (``accum_steps``); and ``evaluate``, the read-only pass of
``--eval-iters``.  User batch iterators (and so prefetching loaders),
checkpoints, telemetry, traces and ``--profiling`` come with later
slices (ROADMAP.md queue 1, items 7 and 12) and are refused by name.
``MAX_STEPS_PER_CALL`` and ``relay_safe_steps`` clamp the steps of a
superstep, here and in the serving loop's decode supersteps.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.metrics import PerfMetrics
from flexflow_torch.runtime.executor import Executor

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
        f"Trainer.fit: {what} is not ported yet; the port trains on its "
        f"fixed synthetic batch (ROADMAP.md queue 1, items 7 and 12)")


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

    @staticmethod
    def _read_stacked(ms: Dict[str, torch.Tensor]) -> Dict[str, List]:
        """A superstep's stacked metrics in ONE host readback (f64 holds
        the integer counts exactly).  It waits for the whole superstep (a
        CUDA graph completes as one unit on its stream), and it frees
        the graph's outputs for the next replay."""
        flat = torch.cat([v.reshape(-1).double() for v in ms.values()])
        flat = flat.cpu().tolist()
        out, at = {}, 0
        for key, v in ms.items():
            vals = flat[at:at + v.numel()]
            out[key] = vals if v.is_floating_point() else [int(x) for x in vals]
            at += v.numel()
        return out

    def fit(
        self,
        iterations: int,
        batches: Optional[Iterable[Dict[str, Any]]] = None,
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
        loss, warmup included, read at the fences, and ``last_metrics``:
        the last timed step's metrics on the host.

        ``steps_per_call > 1`` takes the superstep loop
        (:meth:`_fit_superstep`, clamped at ``MAX_STEPS_PER_CALL``);
        ``accum_steps > 1`` makes each step one update from that many
        microbatches of the model's batch
        (``Executor.accum_train_step``)."""
        cfg = self.ex.config
        if batches is not None:
            _refuse("a user batch iterator (and its prefetching loader)")
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
        if steps_per_call > 1:
            return self._fit_superstep(iterations, warmup, log_every,
                                       accum_steps, steps_per_call)
        return self._fit_plain(iterations, warmup, log_every, accum_steps)

    def _fit_plain(self, iterations: int, warmup: int, log_every: int,
                   accum_steps: int) -> Dict[str, Any]:
        """The per-step (k=1) training loop; see :meth:`fit`."""
        ex = self.ex
        if accum_steps > 1:
            accum_fn = ex.accum_train_step(accum_steps)

            def step_fn(p, o, s, b):
                return accum_fn(p, o, s, ex.stack_microbatches(b, accum_steps))
        else:
            step_fn = ex.train_step
        params, opt_state, state = ex.init()
        batch = self.synthetic_batch()
        losses = []
        m = None
        # Warmup outside the timed region (first-call allocations, the
        # kernels' build and load).  Warmup steps are real updates.
        for _ in range(warmup):
            params, opt_state, state, m = step_fn(
                params, opt_state, state, batch)
            losses.append(m["train_loss"])
        if m is not None:
            self._fence(m)

        start = time.perf_counter()
        for it in range(iterations):
            params, opt_state, state, m = step_fn(
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
            "last_metrics": final_m,
        }

    def _fit_superstep(self, iterations: int, warmup: int, log_every: int,
                       accum_steps: int, k: int) -> Dict[str, Any]:
        """The superstep loop: K steps per call of
        ``Executor.build_superstep`` (on CUDA one CUDA graph), with ONE
        host readback of the stacked per-step metrics per superstep, the
        fence.  As in the JAX package, warmup ROUNDS UP to whole
        supersteps: ``ceil(warmup/k)`` calls, ``ceil(warmup/k)*k`` real
        updates, the first of which runs the k steps eagerly and
        captures the graph outside the timed region.  A tail of
        ``iterations % k`` steps runs as a second, shorter superstep,
        captured before the timed region once the k-step one has warmed
        the step (without warmup its first call warms it, timed).  The
        stats add the JAX package's ``steps_per_call`` and
        ``supersteps`` (the timed calls)."""
        ex = self.ex
        if not ex.superstep_fused:
            raise ValueError("steps_per_call > 1 needs an executor whose "
                             "supersteps fuse into one dispatch")
        k = relay_safe_steps(k)
        warm_calls = -(-warmup // k) if warmup > 0 else 0
        if warm_calls and warm_calls * k != warmup:
            _log.info("steps_per_call=%d: warmup rounded up from %d to %d "
                      "steps (%d supersteps)", k, warmup, warm_calls * k,
                      warm_calls)
        plan = [k] * (warm_calls + iterations // k)
        tail = iterations % k
        if tail:
            plan.append(tail)
        fns = {n: ex.build_superstep(n, accum_steps) for n in set(plan)}
        params, opt_state, state = ex.init()
        host = synthetic_host_batch(ex.model, np.random.default_rng(0))
        fixed = {n: ex.stack_steps([host] * n, accum_steps) for n in fns}
        losses: List[float] = []

        def call(n):
            nonlocal params, opt_state, state
            params, opt_state, state, ms = fns[n](params, opt_state, state,
                                                  fixed[n])
            host_ms = self._read_stacked(ms)
            if fns[n].captured:
                fixed[n] = fns[n].static_inputs  # the next call copies nothing
            losses.extend(host_ms["train_loss"])
            return host_ms

        for _ in range(warm_calls):
            call(k)
        if tail and warm_calls and ex.device.type == "cuda":
            fns[tail].capture(params, opt_state, state, fixed[tail])
            fixed[tail] = fns[tail].static_inputs
        timed = plan[warm_calls:]

        steps_done = 0
        last = {}
        start = time.perf_counter()
        for n in timed:
            host_ms = call(n)
            for j in range(n):
                last = Executor.metrics_row(host_ms, j)
                self.metrics.update(last)
                steps_done += 1
                if log_every and steps_done % log_every == 0:
                    print(f"iter {steps_done}: {self.metrics.report()}")
        elapsed = time.perf_counter() - start

        batch_size = ex.model.input_tensors[0].shape[0]
        throughput = steps_done * batch_size / elapsed
        print(f"time = {elapsed:.4f}s")
        print(f"tp = {throughput:.2f} samples/s")
        self.final = (params, opt_state, state)
        return {
            "elapsed_s": elapsed,
            "samples_per_s": throughput,
            "iterations": steps_done,
            "batch_size": batch_size,
            "loss": float(self.metrics.avg_loss),
            "steps_per_call": k,
            "supersteps": len(timed),
            "step_losses": losses,
            "last_metrics": last,
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
