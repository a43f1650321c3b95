"""Cross-run drift detection and the paired measurement protocol: the
port's copy of ``flexflow_tpu/obs/compare.py``, thresholds, rows and
verdicts alike.

- :func:`compare_runs` diffs two runs' summary and calibration metrics
  against relative thresholds and gives a verdict (``ok`` or
  ``drift:<metric>``, the first drifted metric in threshold order);
  ``python -m flexflow_torch.obs compare A B`` prints it, with the
  fingerprint diff saying whether the box itself changed.
- :func:`paired_measure` is the paired-median protocol with its A/A
  control: each rep runs both variants back to back, the order
  alternating between reps, and the statistic is the median of the
  per-pair relative deltas.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Callable, Dict, List, Optional

from flexflow_torch.obs.reader import RunLog, resolve_run
from flexflow_torch.obs.registry import fingerprint_diff

#: Relative-drift thresholds per metric (|b-a|/|a| past which the
#: verdict flips), in verdict priority order (the JAX package's table).
#: Counter metrics (fences/step, programs/step) are accounting: any
#: change is drift; wall-time metrics carry run-to-run noise, so their
#: thresholds sit well above it.
DEFAULT_THRESHOLDS: Dict[str, float] = {
    "fences_per_step": 0.01,
    "programs_per_step": 0.01,
    # Serving-scheduler accounting and virtual-clock latency rows
    # (SERVING.md): sheds/preempts are decision COUNTS and the
    # queue-wait/SLO metrics are deterministic virtual-clock values,
    # so any change is a scheduling regression, not box noise.
    "request_sheds": 0.01,
    "request_preempts": 0.01,
    "request_retries": 0.01,
    "request_expiries": 0.01,
    "engine_restarts": 0.01,
    "queue_wait_ms_p50": 0.01,
    "queue_wait_ms_p99": 0.01,
    "slo_attainment": 0.01,
    "step_ms_p50": 0.25,
    "step_ms_p95": 0.35,
    "dispatch_ms_per_program": 0.50,
    "fence_ms": 0.50,
    "input_wait_ms_p50": 1.00,
}

#: Metrics read from the run summary vs the calibration block.
_SUMMARY_METRICS = ("fences_per_step", "programs_per_step",
                    "request_sheds", "request_preempts",
                    "request_retries", "request_expiries",
                    "engine_restarts",
                    "queue_wait_ms_p50", "queue_wait_ms_p99",
                    "slo_attainment",
                    "step_ms_p50", "step_ms_p95", "input_wait_ms_p50")
_CALIBRATION_METRICS = ("dispatch_ms_per_program", "fence_ms")


@dataclasses.dataclass
class MetricRow:
    metric: str
    a: Optional[float]
    b: Optional[float]
    rel: Optional[float]       # |b-a|/|a|; None when not comparable
    threshold: float
    drifted: bool


@dataclasses.dataclass
class CompareResult:
    """Two runs diffed: per-metric rows, the box-state fingerprint
    delta, and the verdict (first drifted metric in threshold order)."""

    a_id: Optional[str]
    b_id: Optional[str]
    rows: List[MetricRow]
    fingerprint_delta: List[str]
    verdict: str

    @property
    def ok(self) -> bool:
        return self.verdict == "ok"

    def format(self) -> str:
        lines = [
            f"compare: {self.a_id or '?'}  vs  {self.b_id or '?'}",
            f"{'metric':<26} {'a':>10} {'b':>10} {'drift':>8} "
            f"{'threshold':>10}",
        ]
        for r in self.rows:
            a = "-" if r.a is None else f"{r.a:.4g}"
            b = "-" if r.b is None else f"{r.b:.4g}"
            rel = "-" if r.rel is None else f"{r.rel * 100:+.1f}%".replace(
                "+", "" if r.rel < 0 else "+")
            mark = "  <-- DRIFT" if r.drifted else ""
            lines.append(f"{r.metric:<26} {a:>10} {b:>10} {rel:>8} "
                         f"{r.threshold * 100:>9.0f}%{mark}")
        if self.fingerprint_delta:
            lines.append("fingerprint delta:")
            for d in self.fingerprint_delta:
                lines.append(f"  {d}")
        else:
            lines.append("fingerprint: identical box state")
        lines.append(f"verdict: {self.verdict}")
        return "\n".join(lines)


def _rel(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None:
        return None
    if a == 0.0:
        return 0.0 if b == 0.0 else float("inf")
    return (b - a) / abs(a)


#: Synthetic metric-name prefixes the autopsy block flattens into
#: (``slo_missed_t<tier>``, ``autopsy_t<tier>_<phase>_ms``).
_AUTOPSY_PREFIX = ("slo_missed_t", "autopsy_t")


def _flatten_autopsy(summary: Dict[str, Any]) -> None:
    """Flatten a ``slo_autopsy`` block (OBSERVABILITY.md "Reading a
    request") into per-tier scalar rows the 1%-accounting drift table
    can diff: missed count + per-phase attributed ms.  In place; a
    summary without the block is untouched."""
    block = summary.pop("slo_autopsy", None)
    if not isinstance(block, dict):
        return
    for tier, row in block.items():
        if not isinstance(row, dict):
            continue
        summary[f"slo_missed_t{tier}"] = row.get("missed", 0)
        for phase, ms in (row.get("phase_ms") or {}).items():
            summary[f"autopsy_t{tier}_{phase}_ms"] = ms


def compare_runs(a: RunLog, b: RunLog,
                 thresholds: Optional[Dict[str, float]] = None,
                 ) -> CompareResult:
    """Diff run ``b`` against baseline ``a``.  A metric present in only
    one run is reported but never drifts (regimes differ legitimately —
    a pipeline run has programs/step, a full-mesh run does not); the
    verdict is the FIRST drifted metric in threshold-table order."""
    th = dict(DEFAULT_THRESHOLDS)
    if thresholds:
        th.update(thresholds)
    sa, sb = a.summary(), b.summary()
    ca, cb = a.calibration(), b.calibration()
    _flatten_autopsy(sa)
    _flatten_autopsy(sb)
    for metric in sorted(set(k for s in (sa, sb) for k in s
                             if k.startswith(_AUTOPSY_PREFIX))):
        # Autopsy rows are virtual-clock accounting like the other
        # serving metrics: any change is a scheduling/attribution
        # regression, never box noise.
        th.setdefault(metric, 0.01)
    rows: List[MetricRow] = []
    verdict = "ok"
    for metric in th:
        src_a, src_b = (
            (ca, cb) if metric in _CALIBRATION_METRICS else (sa, sb)
        )
        va, vb = src_a.get(metric), src_b.get(metric)
        va = None if va is None else float(va)
        vb = None if vb is None else float(vb)
        rel = _rel(va, vb)
        drifted = rel is not None and abs(rel) > th[metric]
        rows.append(MetricRow(metric=metric, a=va, b=vb, rel=rel,
                              threshold=th[metric], drifted=drifted))
        if drifted and verdict == "ok":
            verdict = f"drift:{metric}"
    return CompareResult(
        a_id=a.run_id, b_id=b.run_id, rows=rows,
        fingerprint_delta=fingerprint_diff(a.fingerprint, b.fingerprint),
        verdict=verdict,
    )


def compare_paths(path_a: str, path_b: str,
                  thresholds: Optional[Dict[str, float]] = None,
                  ) -> CompareResult:
    """CLI form: each argument is a run log or a telemetry dir (the
    dir resolves to its latest run)."""
    ra = resolve_run(path_a)
    rb = resolve_run(path_b)
    if ra is None or rb is None:
        missing = path_a if ra is None else path_b
        raise FileNotFoundError(f"no run log under {missing!r}")
    la, lb = RunLog.load(ra), RunLog.load(rb)
    for path, log in ((ra, la), (rb, lb)):
        if log.read_error:
            raise FileNotFoundError(
                f"cannot read run log {path!r}: {log.read_error}"
            )
    return compare_runs(la, lb, thresholds=thresholds)


# -- paired measurement protocol ----------------------------------------------


@dataclasses.dataclass
class PairedResult:
    """One paired A/B: per-rep leg values plus both statistic forms
    (delta-% for overhead bars, ratio for throughput bars) and their
    A/A controls.  ``a`` is the baseline leg in both forms:
    ``delta_pct = (b-a)/a*100`` and ``ratio = a/b``."""

    a: List[float]
    b: List[float]
    delta_pct: List[float]
    ratio: List[float]
    aa_pct: List[float]
    aa_ratio: List[float]

    @property
    def median_a(self) -> float:
        return statistics.median(self.a)

    @property
    def median_b(self) -> float:
        return statistics.median(self.b)

    @property
    def median_delta_pct(self) -> float:
        return statistics.median(self.delta_pct)

    @property
    def median_ratio(self) -> float:
        return statistics.median(self.ratio)

    @property
    def median_aa_pct(self) -> float:
        return statistics.median(self.aa_pct) if self.aa_pct else 0.0

    @property
    def median_aa_ratio(self) -> float:
        return statistics.median(self.aa_ratio) if self.aa_ratio else 1.0


def paired_measure(
    make_a: Callable[[int], float],
    make_b: Callable[[int], float],
    reps: int,
    control: Optional[Callable[[int], float]] = None,
) -> PairedResult:
    """The paired-median protocol: each rep runs both legs back to
    back with ORDER ALTERNATING between reps (drift cancels to first
    order inside a pair) and the statistic is the median of per-pair
    relative deltas (the median rejects the box's occasional 2x
    outlier runs).  ``control`` (run twice per rep, same alternation
    formula) gives the A/A floor to read the A/B number against."""
    res = PairedResult(a=[], b=[], delta_pct=[], ratio=[],
                       aa_pct=[], aa_ratio=[])
    for r in range(reps):
        legs = [("a", make_a), ("b", make_b)]
        if r % 2:
            legs.reverse()  # cancel drift inside the pair
        pair: Dict[str, float] = {}
        for kind, fn in legs:
            pair[kind] = float(fn(r))
        res.a.append(pair["a"])
        res.b.append(pair["b"])
        res.delta_pct.append((pair["b"] - pair["a"]) / pair["a"] * 100)
        res.ratio.append(pair["a"] / pair["b"])
        if control is not None:
            c1 = float(control(r))
            c2 = float(control(r))
            res.aa_pct.append(
                ((c2 - c1) if r % 2 == 0 else (c1 - c2)) / c1 * 100
            )
            res.aa_ratio.append((c2 / c1) if r % 2 == 0 else (c1 / c2))
    return res
