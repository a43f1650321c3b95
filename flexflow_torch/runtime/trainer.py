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
``--eval-iters``.  Both loops take, as the JAX package's do:

- ``checkpoint`` (a ``CheckpointManager``): resume from the latest step,
  a save every ``save_every`` steps (after a fence, so queued compute is
  not billed to the save) and one at the end; checkpoint time is left
  out of the throughput; SIGTERM / SIGINT stops at the next boundary
  with an emergency save (``PreemptionHandler``);
- run telemetry (``--telemetry``): ``record_step``, ``program_cost`` at
  the first timed call, and the fences labelled
  ``warmup``, ``log``, ``pre_save``, ``superstep`` and ``final``: every
  fence goes through ``telemetry.current().fence``, which is the fence
  itself when telemetry is off.  The fixed batch is pulled from no
  source, so no ``input_wait`` is recorded (the loader of item 12 brings
  one);
- ``--trace DIR``: a ``torch.profiler`` trace of the timed loop
  (``runtime/profiler.py::trace``), each step (``train``) or superstep
  (``superstep``) a ``record_function`` range, summarised into
  ``run_end`` when telemetry is on;
- ``--profiling``: each op's forward timed alone after the run
  (``runtime/profiler.py::profile_ops``), its table printed.

Over a layer-wise pipeline (``runtime/pipeline.py``) the per-step loop
is the same; ``steps_per_call = K`` takes ``_fit_superstep`` on the
compiled pipeline (its fused superstep: one CUDA graph a rank over NCCL)
and ``_fit_superstep_pipeline`` on the host-driven one (K host-driven
steps, one fence); ``accum_steps`` must be the one the executor lowered
into microbatches, and ``--profiling`` prints JAX's "unavailable"
line.

Under a world of ranks every rank runs the loop on its blocks: the
fixed batch is the global host draw, each rank keeping its block (of
every step and microbatch); a checkpoint binds the executor's snapshot
layout (whole tensors, gathered by every rank, written by rank 0); a
SIGTERM to any rank is agreed over the world at the boundary (one small
host collective), so every rank saves the same step and returns; each
rank writes its own telemetry run and ``--trace`` file (``-p<rank>``);
``--profiling`` times every op on every rank and rank 0 prints the
table.

User batch iterators (and so prefetching loaders) come with the data
plane (ROADMAP.md queue 1, item 12) and are refused by name.
``MAX_STEPS_PER_CALL`` and ``relay_safe_steps`` clamp the steps of a
superstep, here and in the serving loop's decode supersteps.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.metrics import PerfMetrics
from flexflow_torch.runtime import telemetry as _telemetry
from flexflow_torch.runtime.executor import Executor
from flexflow_torch.runtime.pipeline import PipelineExecutor

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


def _trace_ctx(ex):
    """``--trace DIR``: the timed loop under ``profiler.trace``."""
    if not ex.config.trace_dir:
        return contextlib.nullcontext()
    from flexflow_torch.runtime.profiler import trace

    return trace(ex.config.trace_dir)


def _window(ex, name: str):
    """A step window of the trace (``record_function``), only when
    tracing: outside a trace a range costs ~10 us a step on the host."""
    if not ex.config.trace_dir:
        return contextlib.nullcontext()
    return record_function(name)


def _print_profile(ex, params, state, batch) -> None:
    """``--profiling``: the per-op table of the trained params (every rank
    times the ops; rank 0 prints); a pipeline has none (JAX's words)."""
    from flexflow_torch.runtime.profiler import profile_ops, report

    if isinstance(ex, PipelineExecutor):
        if ex.rank == 0:
            print("profiling: per-op breakdown unavailable for pipeline "
                  "executors")
        return

    table = report(profile_ops(ex, params, state, batch))
    if ex.world is None or ex.world.rank == 0:
        print(table)


def _attach_trace(ex, tel, prof) -> None:
    """Fold this rank's own trace file into the run's summary."""
    if ex.config.trace_dir and tel.enabled:
        tel.attach_trace_summary(getattr(prof, "trace_path", None)
                                 or ex.config.trace_dir, ex.device.type)


def _stop(ex, preempt, checkpoint) -> bool:
    """Whether to stop at this boundary: the preemption flag, agreed over
    the world when a checkpoint is attached (the flag's handler is
    installed only then), and written back so every rank reports it."""
    if checkpoint is not None and ex.world is not None:
        preempt.triggered = ex.agree(preempt.triggered)[0]
    return preempt.triggered


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

    def _restore(self, checkpoint, templates):
        """``(start_step, params, opt_state, state)``: the latest snapshot
        restored into ``templates`` when there is one to resume from (the
        step rank 0 chose, under a world)."""
        if checkpoint is None:
            return (0, *templates)
        checkpoint.layout = self.ex.snapshot_layout()
        try:
            out = checkpoint.restore(templates=templates)
        except FileNotFoundError:
            return (0, *templates)
        print(f"resumed from step {out[0]}")
        return out

    def fit(
        self,
        iterations: int,
        batches: Optional[Iterable[Dict[str, Any]]] = None,
        warmup: int = 1,
        log_every: int = 0,
        checkpoint=None,
        save_every: int = 0,
        accum_steps: int = 1,
        steps_per_call: int = 1,
    ) -> Dict[str, Any]:
        """Run ``warmup`` untimed and ``iterations`` timed steps from
        ``ex.init()`` (or the latest snapshot of ``checkpoint``, when it
        has one) on one fixed synthetic batch; returns throughput
        stats computed with the reference formula.  The stats carry,
        beside the JAX package's keys, ``step_losses``: every step's
        loss, warmup included, read at the fences, and ``last_metrics``:
        the last timed step's metrics on the host.

        ``steps_per_call > 1`` takes the superstep loop
        (:meth:`_fit_superstep`, clamped at ``MAX_STEPS_PER_CALL``);
        ``accum_steps > 1`` makes each step one update from that many
        microbatches of the model's batch
        (``Executor.accum_train_step``).  With ``checkpoint``, a save
        every ``save_every`` steps and one at the end; a SIGTERM stops at
        the next boundary, saves, and the stats carry ``preempted`` and
        ``checkpoint_step``.  With ``config.telemetry_dir`` the run
        writes its JSONL stream and the stats its summary under
        ``"telemetry"``; off, the numbers and the stats are unchanged."""
        if batches is not None:
            raise NotImplementedError(
                "Trainer.fit: a user batch iterator (and its prefetching "
                "loader) is not ported yet; the port trains on its fixed "
                "synthetic batch (ROADMAP.md queue 1, item 12)")
        if iterations <= 0:
            raise ValueError("fit() needs at least one iteration")
        pipe = isinstance(self.ex, PipelineExecutor)
        with _telemetry.maybe_run(self.ex.config):
            if pipe and accum_steps > 1:
                # A pipeline lowers accumulation at construction (a
                # groups x m microbatches are a*m microbatches); the
                # trainer must not stack again.
                if accum_steps != self.ex.accum_steps:
                    raise ValueError(
                        f"accum_steps={accum_steps} on a layer-wise "
                        f"strategy must be lowered at construction: build "
                        f"the PipelineExecutor (or make_executor) with "
                        f"accum_steps={accum_steps} (this one has "
                        f"accum_steps={self.ex.accum_steps})")
                accum_steps = 1
            if steps_per_call > 1:
                if pipe and not self.ex.superstep_fused:
                    return self._fit_superstep_pipeline(
                        iterations, warmup, log_every, checkpoint,
                        save_every, accum_steps, steps_per_call)
                return self._fit_superstep(iterations, warmup, log_every,
                                           checkpoint, save_every,
                                           accum_steps, steps_per_call)
            return self._fit_plain(iterations, warmup, log_every, checkpoint,
                                   save_every, accum_steps)

    def _stats(self, elapsed, steps, losses, last, start_step, preempt,
               **extra) -> Dict[str, Any]:
        tel = _telemetry.current()
        batch_size = self.ex.model.input_tensors[0].shape[0]
        throughput = steps * batch_size / elapsed
        # Reference printout formulas (cnn.cc:128-129, dlrm.cc:165-166).
        print(f"time = {elapsed:.4f}s")
        print(f"tp = {throughput:.2f} samples/s")
        stats = {
            "elapsed_s": elapsed,
            "samples_per_s": throughput,
            "iterations": steps,
            "batch_size": batch_size,
            "loss": float(self.metrics.avg_loss),
            **extra,
            "step_losses": [float(x) for x in losses],
            "last_metrics": last,
        }
        if preempt.triggered:
            tel.emit("preempt", step=start_step + steps,
                     signum=preempt.signum)
            stats["preempted"] = True
            stats["checkpoint_step"] = start_step + steps
        return tel.fold_stats(stats)

    @staticmethod
    def _final_save(checkpoint, step, params, opt_state, state,
                    preempt) -> None:
        if checkpoint is None:
            return
        checkpoint.save(step, params, opt_state, state)
        checkpoint.wait_until_finished()  # on disk before the process ends
        if preempt.triggered:
            print(f"preempted: emergency checkpoint at step {step}, "
                  f"exiting cleanly")

    def _fit_plain(self, iterations: int, warmup: int, log_every: int,
                   checkpoint, save_every: int,
                   accum_steps: int) -> Dict[str, Any]:
        """The per-step (k=1) training loop; see :meth:`fit`."""
        from flexflow_torch.runtime.resilience import PreemptionHandler

        tel = _telemetry.current()
        ex = self.ex
        host = synthetic_host_batch(ex.model, np.random.default_rng(0))
        plain = ex.shard_batch(host)
        if accum_steps > 1:
            # The global batch's microbatches, each rank's block of each.
            step_fn = ex.accum_train_step(accum_steps)
            batch = ex.shard_batch(ex.stack_microbatches(host, accum_steps),
                                   lead=1)
        else:
            step_fn, batch = ex.train_step, plain
        start_step, params, opt_state, state = self._restore(
            checkpoint, ex.init())
        losses = []
        m = None
        with PreemptionHandler(install=checkpoint is not None) as preempt:
            # Warmup outside the timed region (first-call allocations, the
            # kernels' build and load).  Warmup steps are real updates,
            # counted in the step numbering of the checkpoints.
            for _ in range(warmup):
                params, opt_state, state, m = step_fn(
                    params, opt_state, state, batch)
                losses.append(m["train_loss"])
            start_step += warmup
            if m is not None:
                tel.fence(m, "warmup")

            ckpt_s = 0.0  # checkpoint time, left out of the throughput
            with _trace_ctx(ex) as prof:
                start = time.perf_counter()
                t_prev = start
                for it in range(iterations):
                    if it == 0:
                        tel.program_cost(
                            "accum_step" if accum_steps > 1
                            else "train_step", ex.model,
                            accum_steps=accum_steps)
                    with _window(ex, "train"):
                        params, opt_state, state, m = step_fn(
                            params, opt_state, state, batch)
                    losses.append(m["train_loss"])
                    if tel.enabled:
                        # Host wall per step: dispatch time on this
                        # unfenced path.
                        now = time.perf_counter()
                        tel.record_step(start_step + it, wall_s=now - t_prev)
                        t_prev = now
                    if log_every and (it + 1) % log_every == 0:
                        self.metrics.update(tel.fence(m, "log"))
                        print(f"iter {it+1}: {self.metrics.report()}")
                        t_prev = time.perf_counter()
                    if checkpoint is not None and save_every and \
                            (it + 1) % save_every == 0:
                        tel.fence(m, "pre_save")
                        t0 = time.perf_counter()
                        checkpoint.save(start_step + it + 1, params,
                                        opt_state, state)
                        ckpt_s += time.perf_counter() - t0
                        t_prev = time.perf_counter()
                    if _stop(ex, preempt, checkpoint):
                        break  # the emergency save below, then out
                completed = it + 1
                # The execution fence (dlrm.cc:159-162): every queued step
                # done, then the final step's metrics read back.
                final_m = tel.fence(m, "final")
                elapsed = time.perf_counter() - start - ckpt_s
            _attach_trace(ex, tel, prof)
            self.metrics.update(final_m)
            self._final_save(checkpoint, start_step + completed, params,
                             opt_state, state, preempt)
            if ex.config.profiling:
                _print_profile(ex, params, state, plain)
            #: The trained (params, opt_state, state) of the run that just
            #: finished, for evaluation after training.
            self.final = (params, opt_state, state)
            return self._stats(elapsed, completed, losses, final_m,
                               start_step, preempt)

    def _fit_superstep(self, iterations: int, warmup: int, log_every: int,
                       checkpoint, save_every: int,
                       accum_steps: int, k: int) -> Dict[str, Any]:
        """The superstep loop: K steps per call of
        ``Executor.build_superstep`` (on CUDA one CUDA graph), with ONE
        fence per superstep, which reads the stacked per-step metrics.
        As in the JAX package, warmup ROUNDS UP to whole supersteps:
        ``ceil(warmup/k)`` calls, ``ceil(warmup/k)*k`` real updates, the
        first of which runs the k steps eagerly and captures the graph
        outside the timed region.  A tail of ``iterations % k`` steps
        runs as a second, shorter superstep, captured before the timed
        region once the k-step one has warmed the step (without warmup
        its first call warms it, timed).  Saves land at the first
        superstep boundary past each ``save_every`` multiple.  The stats
        add the JAX package's ``steps_per_call`` and ``supersteps`` (the
        timed calls)."""
        from flexflow_torch.runtime.resilience import PreemptionHandler

        tel = _telemetry.current()
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
        start_step, params, opt_state, state = self._restore(
            checkpoint, ex.init())
        host = synthetic_host_batch(ex.model, np.random.default_rng(0))
        fixed = {n: ex.stack_steps([host] * n, accum_steps) for n in fns}
        losses: List[float] = []

        def call(n, label):
            nonlocal params, opt_state, state
            params, opt_state, state, ms = fns[n](params, opt_state, state,
                                                  fixed[n])
            host_ms = tel.fence(ms, label)
            if isinstance(ex, PipelineExecutor):
                # The compiled pipeline: one program covered n steps.
                ex.note_fused_dispatch(n)
            if fns[n].captured:
                fixed[n] = fns[n].static_inputs  # the next call copies nothing
            losses.extend(host_ms["train_loss"])
            return host_ms

        with PreemptionHandler(install=checkpoint is not None) as preempt:
            for _ in range(warm_calls):
                call(k, "warmup")
            start_step += warm_calls * k
            if tail and warm_calls and fns[tail].graphed:
                fns[tail].capture(params, opt_state, state, fixed[tail])
                fixed[tail] = fns[tail].static_inputs
            timed = plan[warm_calls:]

            steps_done = 0
            last = {}
            ckpt_s = 0.0
            with _trace_ctx(ex) as prof:
                start = time.perf_counter()
                for n in timed:
                    t_call = time.perf_counter()
                    if steps_done == 0:
                        tel.program_cost("superstep", ex.model, steps=n, k=n)
                    with _window(ex, "superstep"):
                        host_ms = call(n, "superstep")
                    wall = time.perf_counter() - t_call
                    if tel.enabled:
                        tel.emit("superstep", k=n, mode="fused",
                                 wall_s=round(wall, 6),
                                 first_step=start_step + steps_done)
                    for j in range(n):
                        last = Executor.metrics_row(host_ms, j)
                        if tel.enabled:
                            tel.record_step(start_step + steps_done,
                                            loss=last.get("train_loss"),
                                            wall_s=wall / n)
                        self.metrics.update(last)
                        steps_done += 1
                        if log_every and steps_done % log_every == 0:
                            print(f"iter {steps_done}: "
                                  f"{self.metrics.report()}")
                    if checkpoint is not None and save_every and \
                            steps_done // save_every > \
                            (steps_done - n) // save_every:
                        t0 = time.perf_counter()
                        checkpoint.save(start_step + steps_done, params,
                                        opt_state, state)
                        ckpt_s += time.perf_counter() - t0
                    if _stop(ex, preempt, checkpoint):
                        break  # the emergency save at this boundary
                elapsed = time.perf_counter() - start - ckpt_s
            _attach_trace(ex, tel, prof)
            self._final_save(checkpoint, start_step + steps_done, params,
                             opt_state, state, preempt)
            if ex.config.profiling:
                _print_profile(ex, params, state, ex.shard_batch(host))
            self.final = (params, opt_state, state)
            return self._stats(elapsed, steps_done, losses, last, start_step,
                               preempt, steps_per_call=k,
                               supersteps=len(timed),
                               superstep_graph=fns[k].graphed)

    def _fit_superstep_pipeline(self, iterations: int, warmup: int,
                                log_every: int, checkpoint, save_every: int,
                                accum_steps: int, k: int) -> Dict[str, Any]:
        """Supersteps over the host-driven pipeline (JAX's
        ``_fit_superstep_pipeline``): its step is one host-driven program
        a (stage, microbatch) event and cannot fuse into one graph, but
        the fence amortizes: ``k`` ``train_step`` calls back to back and
        one fence a superstep, which reads their ``k`` metrics.  With
        ``clip_norm > 0`` the global norm is one more collective a step,
        not a fence here, but JAX's floor of one fence a step is warned
        of as JAX warns.  Warmup is not rounded (no graph is captured).
        Saves land at the first superstep boundary past each
        ``save_every`` multiple.  The stats add ``steps_per_call`` and
        ``supersteps``."""
        from flexflow_torch.runtime.resilience import PreemptionHandler

        tel = _telemetry.current()
        ex = self.ex
        if accum_steps > 1:
            raise ValueError("accum_steps composes with full-mesh strategies "
                             "only; pipeline strategies microbatch via "
                             "microbatches=")
        k = relay_safe_steps(k)
        if ex.config.clip_norm > 0.0:
            _log.warning(
                "steps_per_call=%d with clip_norm=%g: the global-norm "
                "fetch is a per-step fence, so dispatch amortizes but "
                "the fence does not (one-fence-per-step floor)",
                k, ex.config.clip_norm)
        start_step, params, opt_state, state = self._restore(
            checkpoint, ex.init())
        host = synthetic_host_batch(ex.model, np.random.default_rng(0))
        batch = ex.shard_batch(host)
        losses: List[Any] = []
        with PreemptionHandler(install=checkpoint is not None) as preempt:
            m = None
            for _ in range(warmup):
                params, opt_state, state, m = ex.train_step(
                    params, opt_state, state, batch)
                losses.append(m["train_loss"])
            start_step += warmup
            if m is not None:
                tel.fence(m, "warmup")
            steps_done = supersteps = 0
            last: Dict[str, Any] = {}
            ckpt_s = 0.0
            with _trace_ctx(ex) as prof:
                start = time.perf_counter()
                while steps_done < iterations:
                    n = min(k, iterations - steps_done)
                    t_call = time.perf_counter()
                    if steps_done == 0:
                        tel.program_cost("train_step", ex.model)
                    ms, walls = [], []
                    for _ in range(n):
                        t_disp = time.perf_counter()
                        with _window(ex, "train"):
                            params, opt_state, state, m = ex.train_step(
                                params, opt_state, state, batch)
                        walls.append(time.perf_counter() - t_disp)
                        ms.append(m)
                    # ONE readback a superstep: its n steps' metrics.
                    host_ms = tel.fence(ms, "superstep")
                    if tel.enabled:
                        tel.emit("superstep", k=n, mode="amortized",
                                 wall_s=round(time.perf_counter() - t_call,
                                              6),
                                 first_step=start_step + steps_done,
                                 programs_per_step=len(ex.last_schedule))
                    supersteps += 1
                    for i, hm in enumerate(host_ms):
                        if tel.enabled:
                            tel.record_step(start_step + steps_done,
                                            loss=hm.get("train_loss"),
                                            wall_s=walls[i])
                        self.metrics.update(hm)
                        losses.append(hm["train_loss"])
                        last = hm
                        steps_done += 1
                        if log_every and steps_done % log_every == 0:
                            print(f"iter {steps_done}: "
                                  f"{self.metrics.report()}")
                    if checkpoint is not None and save_every and \
                            steps_done // save_every > \
                            (steps_done - n) // save_every:
                        t0 = time.perf_counter()
                        checkpoint.save(start_step + steps_done, params,
                                        opt_state, state)
                        ckpt_s += time.perf_counter() - t0
                    if _stop(ex, preempt, checkpoint):
                        break  # the emergency save at this boundary
                elapsed = time.perf_counter() - start - ckpt_s
            _attach_trace(ex, tel, prof)
            self._final_save(checkpoint, start_step + steps_done, params,
                             opt_state, state, preempt)
            if ex.config.profiling:
                _print_profile(ex, params, state, batch)
            self.final = (params, opt_state, state)
            return self._stats(elapsed, steps_done, losses, last, start_step,
                               preempt, steps_per_call=k,
                               supersteps=supersteps)

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
            pm.update(_telemetry.host_fence(m))
        return {"loss": pm.avg_loss, "accuracy": pm.accuracy,
                "batches": pm.steps}
