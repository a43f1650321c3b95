"""Run registry: the box-state fingerprint and the append-only run
index, the port's copy of ``flexflow_tpu/obs/registry.py``.

- :func:`box_fingerprint` names the box a run ran on: git sha, platform,
  device count, process rank and world size, host.  It keeps the JAX
  package's keys (``jax`` and ``jaxlib`` are ``None`` here), so that
  ``fingerprint_diff`` of a JAX run and a port run lists every field
  that differs, and adds ``torch``, ``cuda`` and ``gpu`` (the card's
  name).  It is stamped onto every ``run_start`` and every index row.
- The index (``runs.jsonl`` next to the run logs, one line per finished
  run: id, path, exit, fingerprint, headline summary numbers) is
  appended by ``Telemetry.close``; its name does not match the
  ``run-*.jsonl`` glob of the run logs.  :func:`history` reads it back
  (tolerant of a torn tail line) and :func:`format_history` is the
  ``python -m flexflow_torch.obs history`` table.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import socket
import subprocess
import time
from typing import Any, Dict, List

_log = logging.getLogger("ff.obs")

#: Index file name under the telemetry dir (append-only JSONL).
INDEX_NAME = "runs.jsonl"

#: Summary keys copied onto index rows (the JAX package's list).
_INDEX_SUMMARY_KEYS = (
    "steps", "fences_per_step", "programs_per_step",
    "step_ms_p50", "step_ms_p95", "input_wait_ms_p50",
    "queue_wait_ms_p50", "queue_wait_ms_p99", "slo_attainment",
    "request_sheds", "request_preempts", "engine_restarts",
    "fleet_replicas", "fleet_dead_replicas",
)


@functools.lru_cache(maxsize=1)
def box_fingerprint() -> Dict[str, Any]:
    """The box-state identity of this process, cached per process.  A
    field that cannot be read is ``None``: a fingerprint never breaks
    the run it describes."""
    fp: Dict[str, Any] = {
        "git_sha": None, "jax": None, "jaxlib": None,
        "platform": None, "devices": None,
        "process_id": 0, "process_count": 1,
        "host": socket.gethostname(),
        "torch": None, "cuda": None, "gpu": None,
    }
    try:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=repo, capture_output=True, text=True,
                             timeout=10)
        if out.returncode == 0:
            fp["git_sha"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        import torch

        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        gpu = torch.cuda.is_available()
        fp["platform"] = "gpu" if gpu else "cpu"
        fp["devices"] = torch.cuda.device_count() if gpu else 1
        if gpu:
            fp["gpu"] = torch.cuda.get_device_name(0)
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            fp["process_id"] = dist.get_rank()
            fp["process_count"] = dist.get_world_size()
    except Exception as e:  # a fingerprint never raises
        _log.warning("box_fingerprint: device identity unavailable (%s)", e)
    return fp


def fingerprint_diff(a: Dict[str, Any], b: Dict[str, Any]) -> List[str]:
    """Fields that differ between two fingerprints, as readable
    ``key: a -> b`` strings (empty = same box state)."""
    return [f"{k}: {a.get(k)!r} -> {b.get(k)!r}"
            for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)]


def index_path(directory: str) -> str:
    return os.path.join(directory, INDEX_NAME)


def append_run(directory: str, record: Dict[str, Any]) -> None:
    """Append one finished run's row to the index.  A failure is logged
    and never reaches the run being closed."""
    try:
        with open(index_path(directory), "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
    except OSError as e:
        _log.warning("run registry: cannot append to %s: %s",
                     index_path(directory), e)


def index_record(tel) -> Dict[str, Any]:
    """The index row of a closing ``Telemetry``: the summary's headline
    numbers, the fingerprint and the exit."""
    summary = tel.step_summary()
    rec: Dict[str, Any] = {
        "ts": round(time.time(), 3),
        "run_id": tel.run_id,
        "path": os.path.basename(tel.path) if tel.path else None,
        "exit": getattr(tel, "exit_status", None),
        "fingerprint": getattr(tel, "fingerprint", None),
        "meta": getattr(tel, "meta", None) or None,
    }
    for k in _INDEX_SUMMARY_KEYS:
        if k in summary:
            rec[k] = summary[k]
    return rec


def history(directory: str) -> List[Dict[str, Any]]:
    """All index rows under ``directory``, oldest first; tolerant of a
    torn tail line exactly like the run-log reader."""
    rows: List[Dict[str, Any]] = []
    try:
        with open(index_path(directory)) as f:
            lines = f.read().splitlines()
    except OSError:
        return rows
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            rows.append(rec)
    return rows


def format_history(rows: List[Dict[str, Any]]) -> str:
    """The ``obs history`` table."""
    if not rows:
        return "run registry: no runs recorded"
    hdr = (f"{'run_id':<26} {'exit':<20} {'steps':>6} {'p50 ms':>8} "
           f"{'fence/st':>8} {'qw p99':>8} {'slo':>6} {'git':>8}  app")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        fp = r.get("fingerprint") or {}
        meta = r.get("meta") or {}
        p50 = r.get("step_ms_p50")
        fps = r.get("fences_per_step")
        qw99 = r.get("queue_wait_ms_p99")
        slo = r.get("slo_attainment")
        lines.append(
            f"{str(r.get('run_id')):<26} {str(r.get('exit')):<20} "
            f"{str(r.get('steps', '')):>6} "
            f"{('' if p50 is None else format(p50, '.3f')):>8} "
            f"{('' if fps is None else format(fps, '.2f')):>8} "
            f"{('' if qw99 is None else format(qw99, '.2f')):>8} "
            f"{('' if slo is None else format(slo, '.3f')):>6} "
            f"{str(fp.get('git_sha') or ''):>8}  "
            f"{meta.get('app', '')}"
        )
    return "\n".join(lines)
