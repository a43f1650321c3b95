"""Structured run telemetry: the JSONL event stream, the fence and step
counters, step-time percentiles and the stall watchdog.  The port of
``flexflow_tpu/runtime/telemetry.py`` (OBSERVABILITY.md has the event
schema; the port writes the same schema and only names of
``obs/events.py::EVENT_CATALOG``).

- ONE :class:`Telemetry` per run; components report into
  :func:`current` (installed by the context manager): the trainer, the
  checkpoint manager, the resilient loop and the fault injectors.
- Events are JSON lines ``{"ts": wall-clock s, "seq": n, "ev": type,
  ...}``.  Rare events flush at once; ``step`` and ``input_wait`` events
  buffer and flush at the next rare event or after ``FLUSH_EVERY_S``.
- **Nothing when off**: the :data:`NULL` singleton's hooks do nothing,
  and its :meth:`_NullTelemetry.fence` *is* the trainer's fence,
  :func:`host_fence` (``torch.cuda.synchronize()``, then one read of the
  values).  :meth:`Telemetry.fence` wraps that same call and never adds
  one, so the fences a step makes are the same with telemetry on and
  off.
- The **stall watchdog** is a daemon thread fed by heartbeats (every
  recorded step and both edges of every fence).  A gap past the
  deadline logs one warning naming the last event, emits a ``stall``
  event and, with ``--stall-notify-pid``, sends SIGUSR1 to that external
  pid.  It only reads timestamps the loop writes: it never calls into
  CUDA and never touches the process it watches.  Its clock is
  injectable and :meth:`Telemetry.check_stall` is one pass of it, so a
  test drives time instead of sleeping.  Heartbeats also touch a file
  (``DIR/heartbeat`` or ``FF_HEARTBEAT_FILE``) for an external watcher.
- ``program_cost`` takes its flops from ``search/cost_model.py::
  train_flops`` (the number MFU uses) with ``source: "cost_model"``:
  the port has no compiler cost analysis, and leaves the byte fields out
  rather than invent them.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

_log = logging.getLogger("ff.telemetry")

#: The run-scoped telemetry components report into (None = disabled).
_current: Optional["Telemetry"] = None

#: Watchdog deadline (s) used when a config carries no override.
DEFAULT_STALL_DEADLINE_S = 300.0

#: Max age of buffered ``step`` events before a time-based flush.
FLUSH_EVERY_S = 0.5

#: Min spacing of heartbeat-file touches.
HEARTBEAT_FILE_EVERY_S = 1.0

#: High-rate event types that may buffer; every other event flushes.
_BUFFERED_EVENTS = frozenset({"step", "input_wait"})

#: Fence labels left out of the fence_ms calibration fit: ``warmup``
#: includes the first call's build and capture, ``final`` drains the run.
CALIBRATION_FENCE_EXCLUDE = frozenset({"warmup", "final"})

#: Per-process run counter: two fits in one second get two files.
_RUN_COUNTER = itertools.count()


def _tensors(value, out: List[torch.Tensor]) -> None:
    if isinstance(value, torch.Tensor):
        out.append(value)
    elif isinstance(value, dict):
        for v in value.values():
            _tensors(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _tensors(v, out)


def _rebuild(value, it):
    if isinstance(value, torch.Tensor):
        vals = next(it)
        return vals[0] if value.dim() == 0 else vals
    if isinstance(value, dict):
        return {k: _rebuild(v, it) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_rebuild(v, it) for v in value]
    return value


def host_fence(value):
    """The trainer's fence: wait for every queued kernel of the devices
    ``value``'s tensors live on (``torch.cuda.synchronize()``), then read
    ``value`` (a tensor, or dicts and lists of them) to the host in ONE
    copy.  A 0-d tensor becomes a Python number, any other a flat list
    (a superstep's stacked metrics); integer tensors give ints, float
    ones exact floats (through float64)."""
    leaves: List[torch.Tensor] = []
    _tensors(value, leaves)
    for dev in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    if not leaves:
        return value
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in leaves]).cpu().tolist()
    parts, at = [], 0
    for t in leaves:
        vals = flat[at:at + t.numel()]
        at += t.numel()
        parts.append(vals if t.is_floating_point()
                     else [int(x) for x in vals])
    return _rebuild(value, iter(parts))


class _NullTelemetry:
    """The disabled singleton: every hook does nothing, and ``fence`` is
    exactly :func:`host_fence`."""

    enabled = False
    path = None

    def fence(self, value, label: str = "fence", read=None):
        return (read or host_fence)(value)

    def emit(self, ev: str, **fields) -> None:
        pass

    def record_step(self, step, loss=None, wall_s=None, **fields) -> None:
        pass

    def record_input_wait(self, step, wall_s, **depths) -> None:
        pass

    def add_programs(self, n: int, steps: int = 1) -> None:
        pass

    def program_cost(self, kind, model, steps: int = 1, flops=None,
                     **meta) -> None:
        pass

    def attach_trace_summary(self, log_dir, device_type) -> None:
        pass

    def heartbeat(self, label: str = "beat") -> None:
        pass

    def note_summary(self, **fields) -> None:
        pass

    def step_summary(self) -> Dict[str, Any]:
        return {}

    def fold_stats(self, stats: Dict[str, Any]) -> Dict[str, Any]:
        return stats

    def close(self) -> None:
        pass

    def __enter__(self) -> "_NullTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL = _NullTelemetry()


def current():
    """The active run's :class:`Telemetry`, or :data:`NULL`."""
    return _current if _current is not None else NULL


def process_tag() -> str:
    """``-p<rank>`` when this process is one of a ``torch.distributed``
    world of more than one (or ``RANK`` is set with ``WORLD_SIZE`` > 1),
    else empty: processes sharing one ``--telemetry DIR`` get their own
    run and heartbeat files."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return f"-p{dist.get_rank()}"
    rank, world = os.environ.get("RANK", ""), os.environ.get("WORLD_SIZE", "")
    if rank.isdigit() and world.isdigit() and int(world) > 1:
        return f"-p{int(rank)}"
    return ""


def maybe_run(config=None, meta: Optional[Dict[str, Any]] = None):
    """A fresh :class:`Telemetry` when ``config.telemetry_dir`` (or
    ``FF_TELEMETRY_DIR``) names a directory and no run telemetry is
    installed yet; otherwise :data:`NULL` (an enclosing run keeps its
    telemetry: nested fits report into the outer stream)."""
    if current().enabled:
        return NULL
    d = getattr(config, "telemetry_dir", None) or \
        os.environ.get("FF_TELEMETRY_DIR")
    if not d:
        return NULL
    deadline = getattr(config, "stall_deadline_s", DEFAULT_STALL_DEADLINE_S)
    notify = getattr(config, "stall_notify_pid", 0)
    if not notify:
        try:
            notify = int(os.environ.get("FF_STALL_NOTIFY_PID", "0") or 0)
        except ValueError:
            _log.warning("FF_STALL_NOTIFY_PID=%r is not an integer; stall "
                         "escalation disabled",
                         os.environ.get("FF_STALL_NOTIFY_PID"))
            notify = 0
    return Telemetry(d, stall_deadline_s=deadline, meta=meta,
                     notify_pid=notify)


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def _jnum(v: float) -> str:
    """One float as JSON: repr for finite values (exact round trip),
    NaN/Infinity as ``json.dumps`` spells them."""
    v = float(v)
    if v == v and v not in (float("inf"), float("-inf")):
        return repr(v)
    return json.dumps(v)


class Telemetry:
    """Run-scoped telemetry collector.

    ``directory=None`` keeps everything in-process (counters,
    percentiles, watchdog; no JSONL): what the bench uses.  As a context
    manager it installs itself as :func:`current`.  ``clock`` (default
    ``time.monotonic``) times the heartbeats the watchdog reads;
    ``watchdog=False`` starts no thread, for a caller that drives
    :meth:`check_stall` itself."""

    enabled = True

    def __init__(
        self,
        directory: Optional[str] = None,
        run_id: Optional[str] = None,
        heartbeat_path: Optional[str] = None,
        stall_deadline_s: float = 0.0,
        meta: Optional[Dict[str, Any]] = None,
        notify_pid: int = 0,
        clock: Callable[[], float] = time.monotonic,
        watchdog: bool = True,
    ):
        self.run_id = run_id or (
            time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            + f"-{os.getpid()}-{next(_RUN_COUNTER)}")
        self._lock = threading.Lock()
        self._seq = 0
        self._f = None
        self.path: Optional[str] = None
        self._dir = directory
        self.meta: Dict[str, Any] = dict(meta or {})
        if directory:
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(
                directory, f"run-{self.run_id}{process_tag()}.jsonl")
            self._f = open(self.path, "a")
        from flexflow_torch.obs.registry import box_fingerprint

        self.fingerprint: Dict[str, Any] = box_fingerprint()
        #: ``fences`` and ``steps`` give fences/step; ``host_programs`` /
        #: ``program_steps`` programs/step (the pipeline's
        #: event list, ``runtime/pipeline.py``).
        self.counts: Dict[str, int] = {
            "fences": 0, "steps": 0, "host_programs": 0, "program_steps": 0,
        }
        #: Host-side wall time of each recorded step (s): dispatch time
        #: on the unfenced per-step path, device time included on the
        #: fenced superstep path.
        self.step_times: List[float] = []
        #: Per-step input waits (s), from instrumented batch pulls only.
        self.input_waits: List[float] = []
        #: ``(label, wall_s)`` of every fence.
        self.fence_times: List[tuple] = []
        self._extra_summary: Dict[str, Any] = {}
        self._clock = clock
        self._hb_path = (
            heartbeat_path or os.environ.get("FF_HEARTBEAT_FILE")
            or (os.path.join(directory, "heartbeat" + process_tag())
                if directory else None))
        self._hb_warned = False
        self._hb_created = False
        now = self._clock()
        self._last_flush = time.monotonic()
        self._last_file_touch = now
        self._last_beat = now
        self._last_label = "run_start"
        self._stall_deadline = float(stall_deadline_s or 0.0)
        #: SIGUSR1 target on a stall: one EXTERNAL pid, or 0 for none.
        self._notify_pid = int(notify_pid or 0)
        if self._notify_pid < 0:
            _log.warning("stall_notify_pid=%d is negative (a process "
                         "group); refusing: escalation notifies exactly "
                         "one external pid or nothing", self._notify_pid)
            self._notify_pid = 0
        if self._notify_pid == os.getpid():
            _log.warning("stall_notify_pid=%d is this process; refusing "
                         "(the watchdog never signals the process it "
                         "watches)", self._notify_pid)
            self._notify_pid = 0
        self._stalled = False
        self._closed = False
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        self._prev_current: Optional[Telemetry] = None
        #: A recorded ``preempt`` makes the run's exit ``preempt``.
        self._preempted = False
        self.exit_status: Optional[str] = None
        self._cost_seen: set = set()
        self._trace_summary: Optional[Dict[str, Any]] = None
        if self._hb_path:
            self._touch_heartbeat()
        self.emit("run_start", run_id=self.run_id, pid=os.getpid(),
                  fingerprint=self.fingerprint, **(meta or {}))
        if self._stall_deadline > 0 and watchdog:
            self._watchdog = threading.Thread(
                target=self._watch, name="ff-telemetry-watchdog",
                daemon=True)
            self._watchdog.start()

    # -- event stream -----------------------------------------------------

    def emit(self, ev: str, **fields) -> None:
        """Append one event; ``step``/``input_wait`` events buffer, every
        other event flushes at once."""
        with self._lock:
            self._seq += 1
            rec: Dict[str, Any] = {"ts": round(time.time(), 6),
                                   "seq": self._seq, "ev": ev}
            rec.update(fields)
            if self._f is not None and not self._closed:
                self._f.write(json.dumps(rec, default=_json_default) + "\n")
                now = time.monotonic()
                if ev not in _BUFFERED_EVENTS or \
                        now - self._last_flush >= FLUSH_EVERY_S:
                    self._f.flush()
                    self._last_flush = now
            self._last_label = ev
            if ev == "preempt":
                self._preempted = True

    def record_step(self, step, loss=None, wall_s=None, **fields) -> None:
        """One completed step: a buffered ``step`` event, the counters and
        percentile feed, and a heartbeat.  A replayed step is recorded
        again; a reader takes the last event of each index.  The line is
        built by hand (the per-step hot path)."""
        step = int(step)
        self.counts["steps"] += 1
        if wall_s is not None:
            self.step_times.append(float(wall_s))
        with self._lock:
            self._seq += 1
            if self._f is not None and not self._closed:
                line = (f'{{"ts": {time.time():.6f}, "seq": {self._seq}, '
                        f'"ev": "step", "step": {step}')
                if wall_s is not None:
                    line += f', "wall_s": {float(wall_s):.6f}'
                if loss is not None:
                    line += f', "loss": {_jnum(loss)}'
                for k, v in fields.items():
                    line += (f', {json.dumps(k)}: '
                             f'{json.dumps(v, default=_json_default)}')
                self._f.write(line + "}\n")
                now = time.monotonic()
                if now - self._last_flush >= FLUSH_EVERY_S:
                    self._f.flush()
                    self._last_flush = now
            self._last_label = "step"
        self.heartbeat(f"step:{step}")

    def record_input_wait(self, step, wall_s, **depths) -> None:
        """The wall time one steady-state batch pull blocked the loop,
        with the loader's queue depths; buffered like ``step``."""
        w = round(float(wall_s), 6)
        self.input_waits.append(w)
        self.emit("input_wait", step=int(step), wall_s=w, **depths)

    def fence(self, value, label: str = "fence", read=None):
        """The caller's fence, ``read(value)`` (the trainer's is
        :func:`host_fence`), wrapped: heartbeats on both edges, timed, a
        ``fence`` event; returns the host values.  It adds no fence of
        its own."""
        self.heartbeat(f"fence:{label}:in-flight")
        t0 = time.perf_counter()
        host = (read or host_fence)(value)
        dt = time.perf_counter() - t0
        self.counts["fences"] += 1
        self.fence_times.append((label, dt))
        self.emit("fence", label=label, wall_s=round(dt, 6))
        self.heartbeat(f"fence:{label}:done")
        return host

    def add_programs(self, n: int, steps: int = 1) -> None:
        """``n`` host programs covering ``steps`` steps (programs/step)."""
        self.counts["host_programs"] += int(n)
        self.counts["program_steps"] += int(steps)

    def program_cost(self, kind: str, model, steps: int = 1, flops=None,
                     **meta) -> None:
        """One ``program_cost`` event per program at its first timed
        call: the analytic flops of ``steps`` train steps of ``model``
        (``search/cost_model.py::train_flops``, ``source:
        "cost_model"``), or ``flops()`` when the caller passes a function
        computing them (a serving program passes itself as ``model``, as
        the JAX package keys its events by program; the function runs
        only for a new key).  Deduplicated per (kind, model, steps);
        never raises."""
        key = (kind, id(model), int(steps))
        if key in self._cost_seen:
            return
        self._cost_seen.add(key)
        try:
            if flops is None:
                from flexflow_torch.search.cost_model import train_flops

                flops = float(train_flops(model)) * int(steps)
            else:
                flops = flops()
            self.emit("program_cost", kind=kind, flops=float(flops),
                      source="cost_model", **meta)
        except Exception as e:
            _log.debug("program_cost(%s): flops unavailable: %s", kind, e)

    def attach_trace_summary(self, log_dir: str, device_type: str) -> None:
        """Fold the device-time summary of the trace under ``log_dir`` (a
        run on ``device_type``) into the coming ``run_end``; a parse
        failure, or a CUDA trace with no device lane, warns and attaches
        nothing."""
        from flexflow_torch.obs.trace import summarize_trace_dir

        summary = summarize_trace_dir(log_dir, device_type)
        if summary is not None:
            self._trace_summary = summary

    # -- heartbeat / watchdog ---------------------------------------------

    def heartbeat(self, label: str = "beat") -> None:
        now = self._clock()
        self._last_beat = now
        self._last_label = label
        if self._stalled:
            self._stalled = False
            _log.warning("telemetry watchdog: heartbeat resumed (%s); the "
                         "stall cleared on its own", label)
            self.emit("stall_recovered", last=label)
        if self._hb_path and \
                now - self._last_file_touch >= HEARTBEAT_FILE_EVERY_S:
            self._last_file_touch = now
            self._touch_heartbeat()

    def _touch_heartbeat(self) -> None:
        try:
            if self._hb_created:
                try:
                    os.utime(self._hb_path, None)
                    return
                except FileNotFoundError:
                    pass
            with open(self._hb_path, "a"):
                pass
            os.utime(self._hb_path, None)
            self._hb_created = True
        except OSError as e:
            if not self._hb_warned:
                self._hb_warned = True
                _log.warning("cannot touch heartbeat file %s: %s",
                             self._hb_path, e)

    def check_stall(self) -> bool:
        """One watchdog pass: when no heartbeat came within the deadline
        and no stall is open, warn once, notify the supervisor, emit a
        ``stall`` event and return True.  Reads only the loop's
        timestamps: no CUDA call."""
        idle = self._clock() - self._last_beat
        if self._stall_deadline <= 0 or idle < self._stall_deadline or \
                self._stalled:
            return False
        self._stalled = True
        _log.warning(
            "telemetry watchdog: NO heartbeat for %.1fs (deadline %.1fs); "
            "last known event: %s.  A fence in flight here is a device "
            "that never finished its queue (or a long first build).  "
            "Observe and warn only: nothing is killed.",
            idle, self._stall_deadline, self._last_label)
        notified = self._notify_supervisor()
        self.emit("stall", idle_s=round(idle, 1),
                  deadline_s=self._stall_deadline, last=self._last_label,
                  notified_pid=notified)
        return True

    def _watch(self) -> None:
        period = min(max(self._stall_deadline / 4.0, 0.05), 30.0)
        while not self._stop.wait(period):
            self.check_stall()

    def _notify_supervisor(self) -> int:
        """SIGUSR1 to the configured external supervisor pid; a dead or
        invalid pid is logged and ignored.  Returns the pid notified (0 =
        none)."""
        if not self._notify_pid:
            return 0
        try:
            os.kill(self._notify_pid, signal.SIGUSR1)
            _log.warning("telemetry watchdog: notified supervisor pid %d "
                         "(SIGUSR1) of the stall", self._notify_pid)
            return self._notify_pid
        except OSError as e:
            _log.warning("telemetry watchdog: could not notify supervisor "
                         "pid %d: %s", self._notify_pid, e)
            return 0

    # -- summaries --------------------------------------------------------

    def note_summary(self, **fields) -> None:
        """Summary rows a subsystem computed, merged into
        :meth:`step_summary` (and ``run_end``)."""
        self._extra_summary.update(fields)

    def step_summary(self) -> Dict[str, Any]:
        """Counters and host-side step-time percentiles (p50/p95/max ms,
        nearest rank): the block folded into fit stats and the bench."""
        out: Dict[str, Any] = {"steps": self.counts["steps"],
                               "fences": self.counts["fences"]}
        steps = max(self.counts["steps"], 1)
        out["fences_per_step"] = round(self.counts["fences"] / steps, 4)
        if self.counts["program_steps"]:
            out["programs_per_step"] = round(
                self.counts["host_programs"] / self.counts["program_steps"],
                4)

        def pct(xs, p):
            return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))]

        if self.step_times:
            ts = sorted(self.step_times)
            out["step_ms_p50"] = round(pct(ts, 0.50) * 1e3, 3)
            out["step_ms_p95"] = round(pct(ts, 0.95) * 1e3, 3)
            out["step_ms_max"] = round(ts[-1] * 1e3, 3)
        if self.input_waits:
            ws = sorted(self.input_waits)
            out["input_wait_ms_p50"] = round(pct(ws, 0.50) * 1e3, 3)
            out["input_wait_ms_p95"] = round(pct(ws, 0.95) * 1e3, 3)
            out["input_waits"] = len(ws)
            out["input_wait_s_total"] = round(sum(ws), 6)
        out.update(self._extra_summary)
        return out

    def fold_stats(self, stats: Dict[str, Any]) -> Dict[str, Any]:
        """The summary into a fit's stats, under ``"telemetry"``."""
        stats["telemetry"] = self.step_summary()
        return stats

    def calibration_summary(self) -> Dict[str, Any]:
        """``run_end``'s ``calibration`` block: steady-state fences per
        step and the fence round-trip floor (the least fence outside
        :data:`CALIBRATION_FENCE_EXCLUDE`), step p50, and the dispatch
        cost per program when programs/step >= 2."""
        ss = self.step_summary()
        floors = [dt for lbl, dt in self.fence_times
                  if lbl not in CALIBRATION_FENCE_EXCLUDE]
        out: Dict[str, Any] = {
            "steps": ss["steps"],
            "fences_per_step": round(len(floors) / max(ss["steps"], 1), 4),
        }
        pps = ss.get("programs_per_step")
        if pps is not None:
            out["programs_per_step"] = pps
        p50 = ss.get("step_ms_p50")
        if p50 is not None:
            out["step_ms_p50"] = p50
            if pps is not None and pps >= 2.0:
                out["dispatch_ms_per_program"] = round(p50 / pps, 4)
        if floors:
            out["fence_ms"] = round(max(min(floors) * 1e3, 1e-3), 4)
            out["fence_samples"] = len(floors)
        return out

    # -- lifecycle --------------------------------------------------------

    def close(self, exc_type=None) -> None:
        """End the run: the exit (``clean``, ``exception:<type>`` or
        ``preempt``), ``run_end`` with the summary and calibration blocks
        (and ``trace_summary`` when attached), and the index row."""
        if self._closed:
            return
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
        from flexflow_torch.obs.events import (
            EXIT_CLEAN,
            EXIT_PREEMPT,
            exit_exception,
        )

        if self._preempted:
            self.exit_status = EXIT_PREEMPT
        elif exc_type is not None:
            self.exit_status = exit_exception(
                getattr(exc_type, "__name__", str(exc_type)))
        else:
            self.exit_status = EXIT_CLEAN
        end: Dict[str, Any] = {"summary": self.step_summary(),
                               "calibration": self.calibration_summary(),
                               "exit": self.exit_status}
        if self._trace_summary is not None:
            end["trace_summary"] = self._trace_summary
        self.emit("run_end", **end)
        with self._lock:
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None
        if self._dir:
            from flexflow_torch.obs.registry import append_run, index_record

            append_run(self._dir, index_record(self))

    def __enter__(self) -> "Telemetry":
        global _current
        self._prev_current = _current
        _current = self
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None) -> None:
        global _current
        if _current is self:
            _current = self._prev_current
        self._prev_current = None
        self.close(exc_type)
