"""Per-request span timelines from a serving run's event stream: the
port's copy of ``flexflow_tpu/obs/spans.py``, fold for fold.

The serving scheduler stamps every request-visible phase transition
with the deterministic virtual clock (``vclock_ms``, rounded to 3
decimals = integer microseconds).  This module folds those events into
one span timeline per request — queued → kv_wait → prefill → decode →
slot_wait → preempted → retry_backoff → transplanted — whose phase
totals reconcile EXACTLY (integer-microsecond equality, not a
tolerance) with the ``e2e_ms`` the ``request_end`` event carries:
``e2e_ms`` is computed from the same rounded stamps the phase edges
are, so the telescoped sum and the recorded end-to-end are the same
integer.  Any gap is a scheduler instrumentation bug, and the tests
pin it (OBSERVABILITY.md "Reading a request").

Stdlib only: loadable by the obs CLI anywhere.  Input is either a ``RunLog`` or any
iterable of raw event dicts (``{"ev": name, ...}``) — the scheduler
feeds its own in-memory copy of the serving events through the same
fold to compute the ``slo_autopsy`` stats block, so the run's stats
and the log-only reconstruction are bit-identical by construction.

Fleet runs: each replica's ``run()`` restarts its virtual clock at 0
against the same absolute arrival schedule, so all replicas share one
clock.  A request transplanted after a replica loss carries the donor
replica's spans too; the donor segment is archived (``donor_spans``)
and EXCLUDED from phase totals — the survivor's segment re-anchors at
the arrival stamp with the recovery gap attributed to the
``transplanted`` phase, so reconciliation holds for transplanted
requests exactly like undisturbed ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

#: Every phase a request can spend time in, in attribution-priority
#: order (dominant-phase ties break toward the earlier entry).
PHASES = (
    "queued",          # waiting for a slot (incl. post-backoff requeue)
    "kv_wait",         # slot free but paged KV blocks are not
    "prefill",         # the admission prefill dispatch(es)
    "decode",          # inside a fused decode superstep / spec round
    "slot_wait",       # holding a slot while the loop serves others
    "preempted",       # evicted (or engine-restart requeued), not yet back
    "retry_backoff",   # slot-fault exponential-backoff window
    "transplanted",    # replica-loss recovery gap before survivor re-admit
)

#: Fold-state -> phase attributed to the interval ending at the next
#: stamped event.
_STATE_PHASE = {
    "queued": "queued",
    "kv_wait": "kv_wait",
    "prefill": "prefill",
    "in_slot": "slot_wait",
    "preempted": "preempted",
    "transplanted": "transplanted",
}


def us(ms: Any) -> int:
    """Rounded-ms stamp -> exact integer microseconds.  Every serving
    stamp is ``round(x, 3)`` so this is lossless — the arithmetic the
    reconciliation contract runs on."""
    return int(round(float(ms) * 1000.0))


@dataclasses.dataclass
class Span:
    """One contiguous phase interval on the virtual clock."""

    phase: str
    start_ms: float
    end_ms: float

    @property
    def dur_ms(self) -> float:
        return round(self.end_ms - self.start_ms, 3)


@dataclasses.dataclass
class RequestTimeline:
    """One request's reconstructed lifecycle."""

    id: int
    arrival_ms: float
    end_ms: float
    e2e_ms: float
    queue_wait_ms: Optional[float]
    tier: Optional[int]
    slo_ok: Optional[bool]
    error: Optional[str]
    tokens: int
    #: Final (survivor) segment, contiguous from arrival to end.
    spans: List[Span]
    #: Archived pre-transplant segment(s) — shown, never totaled.
    donor_spans: List[Span]
    transplanted: bool
    #: phase -> integer microseconds (the reconciliation currency).
    phase_us: Dict[str, int]

    @property
    def total_us(self) -> int:
        return sum(self.phase_us.values())

    @property
    def reconciled(self) -> bool:
        """Phase totals telescope to exactly ``e2e_ms`` — the
        virtual-clock equality the span layer is pinned on."""
        return self.total_us == us(self.e2e_ms)

    @property
    def phase_ms(self) -> Dict[str, float]:
        return {p: round(u / 1000.0, 3)
                for p, u in self.phase_us.items() if u}

    @property
    def dominant_phase(self) -> str:
        return max(PHASES,
                   key=lambda p: (self.phase_us.get(p, 0),
                                  -PHASES.index(p)))


def _get(rec: Any, key: str, default: Any = None) -> Any:
    return rec.get(key, default)


def build_timelines(records: Iterable[Any]) -> Dict[int, RequestTimeline]:
    """Fold an event stream (raw dicts or ``RunLog`` events, in stream
    order) into per-request timelines.  Only requests whose
    ``request_end`` carries the stamped split (``arrival_ms`` /
    ``vclock_ms`` / ``e2e_ms`` — the scheduler era) yield a timeline;
    legacy events are skipped, never raised on."""
    # -- pass 1: per-id ordered record lists ------------------------------
    recs: Dict[int, List[tuple]] = {}
    ends: Dict[int, Dict[str, Any]] = {}

    def push(rid, kind, stamp, extra=None):
        recs.setdefault(int(rid), []).append((kind, stamp, extra))

    pending = None  # (v0_us, [slot ids]) from the last sched_decision
    for r in records:
        ev = _get(r, "ev")
        v = _get(r, "vclock_ms")
        rid = _get(r, "id")
        if ev == "sched_decision":
            ids = _get(r, "slots")
            pending = ((us(v), list(ids))
                       if v is not None and ids is not None else None)
        elif ev in ("decode_superstep", "spec_verify"):
            ids = _get(r, "slots")
            if v is not None and ids is not None and pending is not None:
                v1 = us(v)
                for sid in ids:
                    push(sid, "decode", pending[0], v1)
            pending = None
        elif v is None and ev != "replica_route":
            continue  # legacy (unstamped) serving event
        elif ev == "request_start":
            push(rid, "start", us(v), _get(r, "bucket"))
        elif ev == "kv_wait":
            push(rid, "kv_wait", us(v))
        elif ev == "prefill":
            push(rid, "prefill_done", us(v))
        elif ev == "prefix_hit" and _get(r, "full"):
            # A FULL hit admits with zero prefill dispatch and zero
            # clock advance — it closes the prefill phase at length 0.
            push(rid, "prefill_done", us(v))
        elif ev == "request_preempt":
            push(rid, "preempt", us(v))
        elif ev == "request_retry":
            until = _get(r, "until_ms")
            push(rid, "retry", us(v),
                 us(until) if until is not None else None)
        elif ev in ("request_expire", "request_shed"):
            push(rid, "dequeue", us(v))
        elif ev == "engine_restart":
            for sid in _get(r, "requeued") or ():
                push(sid, "requeued", us(v))
        elif ev == "replica_route":
            if _get(r, "redistributed") and rid is not None:
                push(rid, "transplant", None)
        elif ev == "request_end":
            arr = _get(r, "arrival_ms")
            e2e = _get(r, "e2e_ms")
            if arr is None or v is None or e2e is None:
                continue
            push(rid, "end", us(v))
            ends[int(rid)] = dict(r.data) if hasattr(r, "data") else dict(r)

    # -- pass 2: per-id state-machine fold --------------------------------
    out: Dict[int, RequestTimeline] = {}
    for rid, end in ends.items():
        rl = recs[rid]
        # A spec round's closing event lands AFTER the per-slot
        # completion events it covered (same stamp): restore
        # clock order so the final round is attributed to decode.
        for i in range(len(rl) - 1):
            if rl[i][0] == "end" and rl[i + 1][0] == "decode" \
                    and rl[i + 1][2] <= rl[i][1]:
                rl[i], rl[i + 1] = rl[i + 1], rl[i]
        arr = us(end["arrival_ms"])
        phase_us = {p: 0 for p in PHASES}
        spans: List[Span] = []
        donor: List[Span] = []
        last = arr
        state = "queued"
        until: Optional[int] = None
        transplanted = False
        t_pending = False

        def add(phase, a, b):
            if b > a:
                phase_us[phase] += b - a
                spans.append(Span(phase, round(a / 1000.0, 3),
                                  round(b / 1000.0, 3)))

        def close(to):
            nonlocal last
            to = max(to, last)
            if state == "retry_backoff":
                mid = min(max(until if until is not None else to, last),
                          to)
                add("retry_backoff", last, mid)
                add("queued", mid, to)
            else:
                add(_STATE_PHASE[state], last, to)
            last = to

        for kind, stamp, extra in rl:
            if kind == "transplant":
                t_pending = True
                continue
            if stamp is not None and (t_pending or stamp < last):
                # New engine-run segment (replica-loss transplant, or
                # any clock restart): archive what the donor ran and
                # re-anchor at arrival — the survivor's own stamps
                # telescope arrival -> end, so totals still reconcile.
                donor.extend(spans)
                spans = []
                phase_us = {p: 0 for p in PHASES}
                last = arr
                state = "transplanted" if t_pending else "queued"
                transplanted = transplanted or t_pending
                t_pending = False
            if kind == "start":
                close(stamp)
                state = "prefill" if extra is not None else "queued"
            elif kind == "kv_wait":
                close(stamp)
                state = "kv_wait"
            elif kind == "prefill_done":
                close(stamp)
                state = "in_slot"
            elif kind == "decode":
                close(stamp)          # residual in-slot -> slot_wait
                add("decode", last, max(extra, last))
                last = max(extra, last)
                state = "in_slot"
            elif kind in ("preempt", "requeued"):
                close(stamp)
                state = "preempted"
            elif kind == "retry":
                close(stamp)
                state = "retry_backoff"
                until = extra
            elif kind == "dequeue":
                close(stamp)
                state = "queued"
            elif kind == "end":
                close(stamp)
                break

        out[rid] = RequestTimeline(
            id=rid,
            arrival_ms=float(end["arrival_ms"]),
            end_ms=float(end["vclock_ms"]),
            e2e_ms=float(end["e2e_ms"]),
            queue_wait_ms=end.get("queue_wait_ms"),
            tier=end.get("tier"),
            slo_ok=end.get("slo_ok"),
            error=end.get("error"),
            tokens=int(end.get("tokens", 0)),
            spans=spans,
            donor_spans=donor,
            transplanted=transplanted,
            phase_us=phase_us,
        )
    return out


def timelines_from_run(run) -> Dict[int, RequestTimeline]:
    """Timelines from a loaded :class:`~flexflow_torch.obs.reader.RunLog`
    (or anything with ``iter_raw``)."""
    return build_timelines(run.iter_raw())


def slo_autopsy(timelines: Dict[int, RequestTimeline]) -> Dict[str, Any]:
    """Per-tier dominant-phase attribution over the SLO misses — the
    block that folds into ``run_end``, the serving stats and ``obs
    compare``.  Empty when nothing missed.  Keys are stringified tiers
    (JSON round-trip stable); phase milliseconds are summed integer
    microseconds, so the block is deterministic and drift-comparable
    at the 1% accounting threshold."""
    acc: Dict[str, Dict[str, Any]] = {}
    for tl in timelines.values():
        if tl.slo_ok is not False:
            continue
        t = acc.setdefault(str(tl.tier), {
            "missed": 0,
            "_us": {p: 0 for p in PHASES},
        })
        t["missed"] += 1
        for p, u in tl.phase_us.items():
            t["_us"][p] += u
    out: Dict[str, Any] = {}
    for tier in sorted(acc):
        t = acc[tier]
        u = t.pop("_us")
        dom = max(PHASES, key=lambda p: (u[p], -PHASES.index(p)))
        out[tier] = {
            "missed": t["missed"],
            "dominant_phase": dom,
            "phase_ms": {p: round(x / 1000.0, 3)
                         for p, x in u.items() if x},
        }
    return out


def fleet_journal_paths(path: str) -> List[str]:
    """A fleet run fans its journal out to ``PATH.r{i}``; return every
    replica journal (plus the bare path when it exists — the
    single-server layout)."""
    import glob
    import os

    out = [path] if os.path.exists(path) else []
    out += sorted(glob.glob(path + ".r*"))
    return out


def journal_outcomes(paths: Iterable[str]) -> Dict[int, Dict[str, Any]]:
    """Fold one or more request journals into per-id outcome rows
    (``sv_done`` metrics + token counts) — the cross-check for ids the
    telemetry stream lost (torn tail) and the fleet-merge key set.
    Later journals win per id (a transplanted request's survivor
    record supersedes the donor's)."""
    from flexflow_torch.obs.reader import RunLog
    from flexflow_torch.serving.journal import fold_journal_events

    out: Dict[int, Dict[str, Any]] = {}
    for p in paths:
        st = fold_journal_events(RunLog.load(p).events)
        for rid, rec in st.completed.items():
            row = dict(rec)
            row["tokens"] = len(rec.get("tokens", []))
            out[int(rid)] = row
    return out


def render_waterfall(tl: RequestTimeline, width: int = 40) -> str:
    """One request's span waterfall as fixed-width text (the ``obs
    request`` rendering)."""
    lines = []
    slo = ("miss" if tl.slo_ok is False
           else "ok" if tl.slo_ok else "-")
    head = (f"request {tl.id}  tier={tl.tier if tl.tier is not None else '-'}"
            f"  e2e={tl.e2e_ms:.3f}ms  slo={slo}"
            f"  tokens={tl.tokens}"
            f"  dominant={tl.dominant_phase}"
            f"  reconciled={'yes' if tl.reconciled else 'NO'}")
    if tl.error:
        head += f"  error={tl.error!r}"
    lines.append(head)
    if tl.donor_spans:
        lines.append(f"  [donor segment: {len(tl.donor_spans)} span(s) "
                     f"on the lost replica — excluded from totals]")
    span_total = max(us(tl.e2e_ms), 1)
    for s in tl.spans:
        frac = (us(s.end_ms) - us(s.start_ms)) / span_total
        bar = "#" * max(1, int(round(frac * width)))
        lines.append(f"  {s.phase:<14} {s.start_ms:>10.3f} -> "
                     f"{s.end_ms:>10.3f}  {s.dur_ms:>9.3f}ms  {bar}")
    tot = ", ".join(f"{p}={v:.3f}" for p, v in tl.phase_ms.items())
    lines.append(f"  phase totals (ms): {tot or '(zero-length)'}")
    return "\n".join(lines)
