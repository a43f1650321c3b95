"""Device-time attribution from a ``torch.profiler`` Chrome trace: the
counterpart of ``flexflow_tpu/obs/trace.py`` (stdlib only).

``--trace DIR`` writes the timed loop's trace as ``DIR/*.pt.trace.json``
(``runtime/profiler.py::trace``); with ``--telemetry`` as well, the
trainer folds :func:`summarize_trace_dir`'s block into ``run_end`` as its
``trace_summary``, in the JAX package's layout:

- ``top_ops``: the op names with the most summed device duration (how
  the reference's per-task cudaEvent timing answered "where did device
  time go");
- ``annotations``: per step window (``train`` / ``superstep``, the
  ``torch.profiler.record_function`` ranges the trainer opens), the
  count, the summed host wall, and the device time of the ops that
  started inside those windows.

Lanes: a device event is one whose ``cat`` is ``kernel``, ``gpu_memcpy``
or ``gpu_memset``.  A step window's device side is its
``gpu_user_annotation`` range (the profiler's device copy of the host
range) when the trace has one, else the host range.  The trace of a CPU
run has no device event: it counts the outermost ``cpu_op`` of each
thread as the stand-in, as the JAX package counts its XLA threads there,
and the summary's ``lane`` says ``host``.  A CUDA run whose trace holds
no device event (the profiler recorded no kernel activity) is not
summarised: its host ops would pass for device time.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

_log = logging.getLogger("ff.obs")

#: How many ops the ``top_ops`` table keeps (JAX keeps 10; a train step
#: on the card names ~20 distinct elementwise kernels of the optimizer
#: beside the products and attention).
DEFAULT_TOP_N = 20

#: Trace-file suffix ``runtime/profiler.py::trace`` writes.
TRACE_SUFFIX = ".pt.trace.json"

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

#: The trainer's step windows.
STEP_WINDOWS = ("train", "superstep")


def find_trace(log_dir: str) -> Optional[str]:
    """The newest ``*.pt.trace.json[.gz]`` under ``log_dir``."""
    paths = [p for suffix in (TRACE_SUFFIX, TRACE_SUFFIX + ".gz")
             for p in glob.glob(os.path.join(log_dir, "**", "*" + suffix),
                                recursive=True)]
    return max(paths, key=os.path.getmtime) if paths else None


def _load_events(path: str) -> List[Dict[str, Any]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    ev = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in ev if isinstance(e, dict) and e.get("ph") == "X"]


def _outermost(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The events of each (pid, tid) that no other event of that thread
    encloses."""
    by_thread: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                -float(e.get("dur", 0.0))))
        end = float("-inf")
        for e in evs:
            ts = float(e.get("ts", 0.0))
            if ts >= end:
                out.append(e)
                end = ts + float(e.get("dur", 0.0))
    return out


def summarize_trace(path: str, device_type: str,
                    top_n: int = DEFAULT_TOP_N) -> Dict[str, Any]:
    """One trace file of a run on ``device_type`` (``"cuda"`` or
    ``"cpu"``) as the ``trace_summary`` block (durations in the trace's
    microseconds, reported as ms to 3 places).  Raises ``ValueError``
    for a CUDA run's trace without a device lane."""
    events = _load_events(path)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    lane = "device"
    if not device:
        if device_type != "cpu":
            raise ValueError(f"{path}: a {device_type} run's trace holds no "
                             f"device event (no kernel activity recorded)")
        device = _outermost([e for e in events if e.get("cat") == "cpu_op"])
        lane = "host"
    host_win: Dict[str, List[Tuple[float, float]]] = {}
    dev_win: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        name = str(e.get("name", ""))
        if name not in STEP_WINDOWS:
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if e.get("cat") == "user_annotation":
            host_win.setdefault(name, []).append((ts, ts + dur))
        elif e.get("cat") == "gpu_user_annotation":
            dev_win.setdefault(name, []).append((ts, ts + dur))

    op_totals: Dict[str, float] = {}
    op_counts: Dict[str, int] = {}
    starts: List[Tuple[float, float]] = []
    for e in device:
        name = str(e.get("name", ""))
        dur = float(e.get("dur", 0.0))
        starts.append((float(e.get("ts", 0.0)), dur))
        if name:
            op_totals[name] = op_totals.get(name, 0.0) + dur
            op_counts[name] = op_counts.get(name, 0) + 1

    annotations: Dict[str, Dict[str, Any]] = {}
    for name, windows in host_win.items():
        # An op belongs to the window its start falls in.
        wins = sorted(dev_win.get(name) or windows)
        begins = [w[0] for w in wins]
        dev_us = 0.0
        for ts, dur in starts:
            i = bisect.bisect_right(begins, ts) - 1
            if i >= 0 and ts < wins[i][1]:
                dev_us += dur
        annotations[name] = {
            "count": len(windows),
            "host_ms": round(sum(b - a for a, b in windows) / 1e3, 3),
            "device_ms": round(dev_us / 1e3, 3),
        }
    top = sorted(op_totals.items(), key=lambda kv: -kv[1])[:top_n]
    return {
        "trace_file": path,
        "lane": lane,
        "device_ms_total": round(sum(d for _, d in starts) / 1e3, 3),
        "top_ops": [{"op": name, "device_ms": round(us / 1e3, 3),
                     "count": op_counts[name]} for name, us in top],
        "annotations": annotations,
    }


def summarize_trace_dir(log_dir: str, device_type: str,
                        top_n: int = DEFAULT_TOP_N,
                        ) -> Optional[Dict[str, Any]]:
    """The trainer's entry point: the newest trace under ``log_dir`` of a
    run on ``device_type`` as a summary block, or None (with one
    warning) when the trace is absent, unreadable or without its device
    lane; attribution never fails the run that made it."""
    try:
        path = find_trace(log_dir)
        if path is None:
            _log.warning("trace summary: no *%s under %s", TRACE_SUFFIX,
                         log_dir)
            return None
        return summarize_trace(path, device_type, top_n=top_n)
    except (OSError, ValueError, KeyError) as e:
        _log.warning("trace summary: cannot parse trace under %s: %s",
                     log_dir, e)
        return None
