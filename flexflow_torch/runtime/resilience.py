"""Failure detection and recovery: the port of ``flexflow_tpu/runtime/
resilience.py`` (RESILIENCE.md has the failure model).

- **Detection.** Raised failures (a runtime error out of a step),
  silent ones (a non-finite loss: divergence, a bad batch) and
  preemption (SIGTERM / SIGINT from a scheduler).
- **Recovery.** :class:`ResilientTrainer` restores the latest readable
  checkpoint (``runtime/checkpoint.py``) and replays from there; batches
  come from ``batch_fn(step)``, so the replayed steps see the same data
  and the recovered loss trajectory equals an unfaulted run's bit for
  bit.  A silent failure keeps the executor and its captured CUDA
  graphs: the snapshot is copied INTO the tensors the graphs captured
  (a NaN step has already written NaNs into the parameters, Adam's
  moments and its on-device step count, in place).  A raised failure
  builds a fresh executor from the factory, fresh tensors and fresh
  graphs.  A restart budget bounds crash loops; ``fatal`` classifies
  failures that in-process recovery cannot help.
- **Supersteps.** ``fit(steps_per_call=k)`` drives
  ``Executor.build_superstep`` (one CUDA graph of k steps on CUDA): one
  fence per superstep, whose stacked losses are scanned for the first
  non-finite step.  At k = 1 the losses of the steps up to the next
  save (at most ``MAX_STEPS_PER_CALL``) are read in one fence.
- **Fault injection.** :class:`FaultInjector`: scheduled raised faults,
  NaN batches (every float input of the step's batch), NaN losses (the
  host-read loss), self-preemption and checkpoint corruption, each
  firing once; a bare ``callable(step)`` is accepted too.
- :class:`PreemptionHandler` turns SIGTERM / SIGINT into a flag the
  loops read at their step or superstep boundaries: the resilient loop
  and ``Trainer.fit`` with a checkpoint save and exit cleanly, the
  serving loop's drain (``Server(drain_on_preempt=True)``) stops
  admitting and journals its in-flight work.

The streaming ``loader`` of the JAX loop comes with the data plane
(ROADMAP.md queue 1, item 12) and is refused by name.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import signal
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from flexflow_torch.runtime import telemetry as _telemetry
from flexflow_torch.runtime.checkpoint import CheckpointManager, flatten
from flexflow_torch.runtime.trainer import (
    MAX_STEPS_PER_CALL,
    relay_safe_steps,
)

logger = logging.getLogger("ff.resilience")


@dataclasses.dataclass
class FailurePolicy:
    """What counts as a failure and how hard to try to recover."""

    max_restarts: int = 3
    #: Exception types recovered from; every other one re-raises.
    #: Narrow on purpose: a ValueError, TypeError, KeyError or
    #: AssertionError is a programmer error that a replay would only
    #: repeat until the budget ran out.
    recoverable: tuple = (RuntimeError, OSError)
    #: A True verdict re-raises a failure that is recoverable by type but
    #: not in this process (a lost peer of a world: item 13).
    fatal: Optional[Callable[[BaseException], bool]] = None


class StepFailure(RuntimeError):
    """A detected silent failure (a non-finite loss)."""


class PreemptionHandler:
    """SIGTERM/SIGINT -> ``triggered``, read by the loop at its
    boundaries.  A second SIGINT restores the default handling (an
    impatient ^C^C still kills).  Handlers can be installed only on the
    main thread; elsewhere the handler is never triggered.  Use it as a
    context manager: leaving restores the previous handlers."""

    def __init__(self, install: bool = True,
                 signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self._install = install
        self._signals = tuple(signals)
        self._previous: Dict[int, Any] = {}
        self.triggered = False
        self.signum: Optional[int] = None

    def _on_signal(self, signum, frame):
        if self.triggered and signum == signal.SIGINT:
            self._restore()
            raise KeyboardInterrupt
        self.triggered = True
        self.signum = signum
        logger.warning("received signal %d: stopping at the next step or "
                       "superstep boundary, then a clean exit", signum)

    def __enter__(self) -> "PreemptionHandler":
        if self._install:
            try:
                for s in self._signals:
                    self._previous[s] = signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread
                logger.info("signal handlers unavailable off the main "
                            "thread; preemption handling disabled")
                self._previous = {}
        return self

    def _restore(self) -> None:
        for s, h in self._previous.items():
            signal.signal(s, h)
        self._previous = {}

    def __exit__(self, *exc) -> None:
        self._restore()


class FaultInjector:
    """Scheduled chaos for the tests, ``runtime/chaos.py`` and
    ``tools/chaos_smoke.py``.  Each mode fires once per scheduled step
    and disarms, so the replay after a rollback sees a clean step.  Keyed
    by global step index:

    - ``raise_at``: ``{step: exception}`` (or steps, raising
      ``RuntimeError``), raised on the host before the step runs;
    - ``nan_batch_at``: every float input of that step's host batch
      becomes NaN (a batch of integer inputs alone is left as it is);
    - ``nan_loss_at``: the host-read loss of that step becomes NaN;
    - ``preempt_at``: SIGTERM to this process before the step;
    - ``corrupt_checkpoint_at``: after the first save at or after that
      step, the newest snapshot's ``params`` item is deleted.

    ``fired`` logs the ``(mode, step)`` pairs that fired, each also a
    ``fault`` telemetry event."""

    def __init__(
        self,
        raise_at: Union[Dict[int, BaseException], Iterable[int], None] = None,
        nan_batch_at: Iterable[int] = (),
        nan_loss_at: Iterable[int] = (),
        preempt_at: Iterable[int] = (),
        corrupt_checkpoint_at: Iterable[int] = (),
    ):
        if raise_at is None:
            raise_at = {}
        elif not isinstance(raise_at, dict):
            raise_at = {s: RuntimeError(f"injected fault at step {s}")
                        for s in raise_at}
        self.raise_at = dict(raise_at)
        self.nan_batch_at = set(nan_batch_at)
        self.nan_loss_at = set(nan_loss_at)
        self.preempt_at = set(preempt_at)
        self.corrupt_checkpoint_at = set(corrupt_checkpoint_at)
        self.fired: List[tuple] = []

    def _fire(self, mode: str, step: int) -> None:
        self.fired.append((mode, step))
        _telemetry.current().emit("fault", mode=mode, step=int(step))

    def before_step(self, step: int) -> None:
        """On the host, before the step's batch is assembled."""
        if step in self.preempt_at:
            self.preempt_at.discard(step)
            self._fire("preempt", step)
            os.kill(os.getpid(), signal.SIGTERM)
        if step in self.raise_at:
            exc = self.raise_at.pop(step)
            self._fire("raise", step)
            raise exc

    def poison_batch(self, step: int, batch: Dict[str, Any]) -> Dict[str, Any]:
        if step not in self.nan_batch_at:
            return batch
        self.nan_batch_at.discard(step)
        self._fire("nan_batch", step)
        return {k: np.full_like(v, np.nan)
                if isinstance(v, np.ndarray)
                and np.issubdtype(v.dtype, np.floating) else v
                for k, v in batch.items()}

    def poison_loss(self, step: int, loss: float) -> float:
        if step not in self.nan_loss_at:
            return loss
        self.nan_loss_at.discard(step)
        self._fire("nan_loss", step)
        return float("nan")

    def after_save(self, step: int, checkpoint: CheckpointManager) -> None:
        """After each periodic save (which may still be writing)."""
        due = {s for s in self.corrupt_checkpoint_at if s <= step}
        if not due:
            return
        self.corrupt_checkpoint_at -= due
        self._fire("corrupt", step)
        self.corrupt(checkpoint)

    @staticmethod
    def corrupt(checkpoint: CheckpointManager) -> None:
        """Delete the newest snapshot's ``params`` item: the torn
        directory the restore fallback must survive."""
        checkpoint.wait_until_finished()
        step = checkpoint.latest_step()
        if step is None:
            return
        payload = os.path.join(checkpoint.directory, str(step), "params")
        if os.path.isdir(payload):
            shutil.rmtree(payload)
            logger.warning("chaos: corrupted checkpoint step %d", step)
        checkpoint.reload()

    @classmethod
    def wrap(cls, obj) -> "FaultInjector":
        """None -> an inert injector, a FaultInjector -> itself, a bare
        ``callable(step)`` -> an adapter firing it before each step."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        return _CallableInjector(obj)


class _CallableInjector(FaultInjector):
    def __init__(self, fn: Callable[[int], None]):
        super().__init__()
        self._fn = fn

    def before_step(self, step: int) -> None:
        self._fn(step)


def _copy_into(dst, src) -> None:
    """Every tensor of ``src`` copied into the same-keyed tensor of
    ``dst``."""
    want, got = flatten(dst), flatten(src)
    with torch.no_grad():
        for k, t in want.items():
            t.copy_(got[k])


class ResilientTrainer:
    """A checkpointed train loop that survives step failures and
    preemption, on the per-step and the superstep path.

    ``executor_factory`` builds the Executor; it is called again after a
    raised failure (fresh tensors, fresh CUDA graphs).  A silent failure
    keeps the executor and restores into its tensors."""

    def __init__(self, executor_factory: Callable[[], Any],
                 checkpoint: CheckpointManager,
                 policy: Optional[FailurePolicy] = None,
                 fault_injector: Union[FaultInjector, Callable[[int], None],
                                       None] = None):
        self.executor_factory = executor_factory
        self.checkpoint = checkpoint
        self.policy = policy or FailurePolicy()
        self.fault_injector = fault_injector
        #: Failures since the last durable progress (the crash-loop
        #: budget), and over the whole fit.
        self.restarts = 0
        self.total_restarts = 0
        #: Seconds each recovery took, from the failure to the restored
        #: state (the executor rebuild included).
        self.rollback_s: List[float] = []
        #: The executor of the finished (or failed) fit.
        self.executor = None

    def _fresh_state(self, ex, seed: int, current=None):
        """``(step, params, opt_state, state)`` from the latest readable
        snapshot, or step 0 from ``ex.init(seed)`` when there is none.
        With ``current`` (the live trees of a kept executor) both land in
        its tensors, in place."""
        templates = current if current is not None else ex.init(seed=seed)
        try:
            step, params, opt_state, state = self.checkpoint.restore(
                templates=templates)
            logger.info("resumed from checkpoint step %d", step)
            return step, params, opt_state, state
        except FileNotFoundError:
            if current is not None:
                _copy_into(current, ex.init(seed=seed))
            return (0, *templates)

    def _recover(self, ex, seed: int, why: BaseException, current):
        t0 = time.perf_counter()
        self.restarts += 1
        self.total_restarts += 1
        if self.restarts > self.policy.max_restarts:
            raise RuntimeError(
                f"restart budget ({self.policy.max_restarts}) exhausted"
            ) from why
        rebuild = not isinstance(why, StepFailure)
        logger.warning("step failure (%s); restart %d/%d", why,
                       self.restarts, self.policy.max_restarts)
        _telemetry.current().emit(
            "rollback", restart=self.restarts,
            reason=f"{type(why).__name__}: {why}", rebuild_executor=rebuild)
        if rebuild:
            ex, current = self.executor_factory(), None
        step, params, opt_state, state = self._fresh_state(ex, seed, current)
        _telemetry.current().emit("replay", from_step=int(step))
        self.rollback_s.append(time.perf_counter() - t0)
        return ex, step, params, opt_state, state

    def fit(self, iterations: int,
            batch_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
            save_every: int = 10, seed: int = 0, steps_per_call: int = 1,
            loader=None) -> Dict[str, Any]:
        """Run ``iterations`` steps with detection and recovery.

        ``batch_fn(step)`` gives each step's host batch (numpy arrays),
        the same every time a step is replayed.  ``steps_per_call=k >
        1`` runs k steps per superstep (one CUDA graph on CUDA), one
        fence each, the stacked losses scanned for the first non-finite
        step; at k = 1 the device losses of ``save_every`` steps (at most
        ``MAX_STEPS_PER_CALL``) are read in one fence.  A save never covers an unread step.  On SIGTERM /
        SIGINT the loop finishes the step or superstep in flight, reads
        it, saves and returns with ``preempted=True``; a fit on the same
        checkpoint directory resumes there.

        Returns ``step``, ``restarts``, ``params``, ``opt_state``,
        ``state``, ``loss``, ``losses`` (``{step: loss}`` of every step
        this fit ran) and ``preempted``; with run telemetry, its summary
        under ``telemetry``.  Telemetry installs itself from the
        executor's config (``--telemetry`` / ``FF_TELEMETRY_DIR``) when
        no run is current."""
        if loader is not None:
            raise NotImplementedError(
                "ResilientTrainer.fit(loader=...): the streaming loader is "
                "not ported yet (ROADMAP.md queue 1, item 12); pass "
                "batch_fn")
        if batch_fn is None:
            raise ValueError("ResilientTrainer.fit needs batch_fn")
        ex = self.executor_factory()
        with _telemetry.maybe_run(getattr(ex, "config", None)):
            return self._fit(ex, iterations, batch_fn, save_every, seed,
                             steps_per_call)

    def _save(self, step, params, opt_state, state, injector) -> None:
        self.checkpoint.save(step, params, opt_state, state)
        injector.after_save(step, self.checkpoint)
        # Durable progress: the budget bounds crash loops, not the faults
        # of a whole run.
        self.restarts = 0

    def _fit(self, ex, iterations, batch_fn, save_every, seed,
             steps_per_call) -> Dict[str, Any]:
        tel = _telemetry.current()
        injector = FaultInjector.wrap(self.fault_injector)
        k = relay_safe_steps(steps_per_call, log=logger)
        check_every = min(save_every or 1, MAX_STEPS_PER_CALL)
        if k > 1 and not getattr(ex, "superstep_fused", False):
            raise ValueError("steps_per_call > 1 in ResilientTrainer needs "
                             "an executor whose supersteps fuse")
        step, params, opt_state, state = self._fresh_state(ex, seed)
        if step >= iterations:
            logger.info("resumed at step %d >= iterations %d: already "
                        "complete", step, iterations)
        losses: Dict[int, float] = {}
        sstep_fns: Dict[int, Any] = {}
        pending: List[tuple] = []  # k = 1: (step, device loss) unread
        preempted = False
        fn = ms = None

        def validate_pending():
            nonlocal pending
            if not pending:
                return
            host = tel.fence([m for _, m in pending], "validate")
            todo, pending = pending, []
            for (s, _), v in zip(todo, host):
                self._record(losses, injector, s, float(v))

        with PreemptionHandler() as preempt:
            while step < iterations:
                try:
                    if k == 1:
                        injector.before_step(step)
                        batch = ex.shard_batch(
                            injector.poison_batch(step, batch_fn(step)))
                        params, opt_state, state, metrics = ex.train_step(
                            params, opt_state, state, batch)
                        pending.append((step, metrics["train_loss"]))
                        step += 1
                        trig = preempt.triggered
                        at_save = bool(save_every) and step % save_every == 0
                        if len(pending) >= check_every or at_save or \
                                step >= iterations or trig:
                            validate_pending()
                            if at_save:
                                self._save(step, params, opt_state, state,
                                           injector)
                    else:
                        n = min(k, iterations - step)
                        group = []
                        for i in range(n):
                            injector.before_step(step + i)
                            group.append(injector.poison_batch(
                                step + i, batch_fn(step + i)))
                        fn = sstep_fns.get(n)
                        if fn is None:
                            fn = sstep_fns[n] = ex.build_superstep(n)
                        params, opt_state, state, ms = fn(
                            params, opt_state, state, ex.stack_steps(group))
                        # ONE fence a superstep: the stacked losses.
                        host = tel.fence(ms["train_loss"], "superstep")
                        # The flag is read after the fence: a signal that
                        # landed during the superstep stops at THIS
                        # boundary.
                        trig = preempt.triggered
                        for j in range(n):
                            self._record(losses, injector, step + j,
                                         float(host[j]),
                                         f" (superstep offset {j} of {n})")
                        prev, step = step, step + n
                        if save_every and \
                                step // save_every > prev // save_every:
                            self._save(step, params, opt_state, state,
                                       injector)
                    if trig:
                        preempted = True
                        tel.emit("preempt", step=int(step),
                                 signum=preempt.signum)
                        logger.warning("preempted: emergency checkpoint at "
                                       "step %d, exiting cleanly", step)
                        break
                except self.policy.recoverable as e:  # noqa: PERF203
                    if self.policy.fatal is not None and self.policy.fatal(e):
                        raise
                    pending = []
                    current = None
                    if isinstance(e, StepFailure):
                        current = (params, opt_state, state)
                    else:
                        # The fresh executor gets fresh tensors and
                        # graphs: drop the old ones first.
                        params = opt_state = state = fn = ms = None
                        sstep_fns = {}
                    ex, step, params, opt_state, state = self._recover(
                        ex, seed, e, current)
        # The final (or emergency) save, unless this very step was saved
        # periodically (its async write flushed first, so the check sees
        # it); then the flush, so the snapshot is on disk before the
        # process can exit.
        self.checkpoint.wait_until_finished()
        if step not in self.checkpoint.all_steps():
            self.checkpoint.save(step, params, opt_state, state, force=True)
        self.checkpoint.wait_until_finished()
        self.executor = ex
        return tel.fold_stats({
            "step": step,
            "restarts": self.total_restarts,
            "params": params,
            "opt_state": opt_state,
            "state": state,
            "loss": losses.get(step - 1, math.nan),
            "losses": losses,
            "preempted": preempted,
        })

    def _record(self, losses, injector, s: int, v: float, where: str = ""):
        """One host loss at the fence: recorded, or a StepFailure."""
        v = injector.poison_loss(s, v)
        if not math.isfinite(v):
            raise StepFailure(f"non-finite loss at step {s}{where}: {v}")
        losses[s] = v
        _telemetry.current().record_step(s, loss=v)
