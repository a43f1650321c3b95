"""The port's span fold (``flexflow_torch/obs/spans.py``) held against the
JAX package's on the CPU: the same timelines, microsecond for
microsecond, and the same tail autopsy, on streams JAX wrote (single
servers, and a fleet run that loses a replica), on streams the port
wrote, and across the two readers.

- Every request timeline reconciles exactly: its phase totals telescope
  to ``us(e2e_ms)``, integer equality, through kv_wait, preemption,
  retry backoff and a replica-loss transplant.
- The port's scheduler stats, its ``run_end`` and the reader's
  reconstruction from the log carry the same ``slo_autopsy``.
- ``render_waterfall``, ``fleet_journal_paths`` and ``journal_outcomes``
  give JAX's output on the same inputs.

Every case runs a simulated scheduler (no model compute).
"""

import dataclasses

import numpy as np
import pytest

from flexflow_tpu import serving as jsv
from flexflow_tpu.obs import reader as jreader
from flexflow_tpu.obs import spans as jspans
from flexflow_tpu.runtime import serving as jrs
from flexflow_tpu.runtime.telemetry import Telemetry as JTelemetry
from flexflow_torch import serving as tsv
from flexflow_torch.obs import reader as treader
from flexflow_torch.obs import spans as tspans
from flexflow_torch.runtime import serving as trs
from flexflow_torch.runtime.telemetry import Telemetry as TTelemetry

V, S = 64, 32

#: Overload with tight tier-0 deadlines: SLO misses, so an autopsy.
BURSTY = dict(n_requests=16, vocab=V, prompt_len=(3, 6), max_new=(2, 10),
              mean_gap_ms=1.0, burst=8, priorities=3, slo_ms=20.0, seed=5)
FLEET_BURSTY = dict(BURSTY, n_requests=12, burst=6, slo_ms=60.0)


def _req(rt, rid, plen, max_new, arrival_ms=0.0, priority=0,
         slo_ms=float("inf")):
    return rt.Request(id=rid,
                      prompt=np.arange(1, plen + 1, dtype=np.int32) * 3 % V,
                      max_new_tokens=max_new, arrival_ms=arrival_ms,
                      priority=priority, slo_ms=slo_ms)


def _case(pkg, rt, name):
    """``(simulated server, requests)`` of one named stream."""
    slo = pkg.SchedulerPolicy(name="slo")
    shape = dict(max_batch=2, max_seq=S, buckets=(8, S))
    kw = {}
    if name == "bursty":
        reqs = pkg.make_workload(pkg.WorkloadSpec(**BURSTY))
    elif name == "kv_wait":
        shape = dict(max_batch=2, max_seq=64, buckets=(8, 64), kv_block=16,
                     kv_blocks=5)
        reqs = [_req(rt, 0, 4, 30), _req(rt, 1, 4, 30, 1.0),
                _req(rt, 2, 4, 8, 2.0)]
    elif name == "preempt":
        shape = dict(max_batch=1, max_seq=S, buckets=(8, S))
        reqs = [_req(rt, 0, 4, 40, 0.0, priority=1),
                _req(rt, 1, 4, 4, 5.0, priority=0, slo_ms=20.0)]
    elif name == "retry":
        kw = dict(resilience=pkg.ServingResilience(max_retries=2),
                  fault_injector=rt.ServingFaultInjector(
                      nan_cache_at={0: 0, 1: 0}))
        reqs = [_req(rt, 0, 4, 6)]
    elif name == "restart_spec":
        kw = dict(speculate=2,
                  resilience=pkg.ServingResilience(max_retries=1,
                                                   max_restarts=1),
                  fault_injector=rt.ServingFaultInjector(
                      nan_cache_at={1: 0}, engine_raise_at={3: "death"}))
        reqs = pkg.make_workload(pkg.WorkloadSpec(**BURSTY))
    elif name == "prefix":
        shape = dict(max_batch=2, max_seq=S, buckets=(16, S), kv_block=8,
                     prefix_cache=True)
        reqs = pkg.make_workload(pkg.WorkloadSpec(
            **dict(BURSTY, shared_prefix=8, prompt_len=(4, 12))))
    else:
        raise KeyError(name)
    return pkg.ScheduledServer.simulated(pkg.SlotShape(**shape),
                                         decode_steps=4, policy=slo,
                                         **kw), reqs


CASES = ("bursty", "kv_wait", "preempt", "retry", "restart_spec", "prefix")


def _same_timelines(a, b):
    assert sorted(a) == sorted(b)
    for i in a:
        assert dataclasses.asdict(a[i]) == dataclasses.asdict(b[i]), i
        assert a[i].dominant_phase == b[i].dominant_phase


def _reconciled(tls):
    bad = [i for i in sorted(tls) if not tls[i].reconciled]
    assert not bad, {i: (tls[i].total_us, tspans.us(tls[i].e2e_ms))
                     for i in bad}


@pytest.mark.parametrize("name", CASES)
def test_fold_of_a_jax_stream_matches_jax(tmp_path, name):
    """JAX writes the stream; the port's fold of the JAX-written log
    (read by the port's reader) and of the in-memory events gives JAX's
    timelines and autopsy, and every timeline reconciles."""
    srv, reqs = _case(jsv, jrs, name)
    tel = JTelemetry(str(tmp_path))
    with tel:
        _res, stats = srv.run(reqs)
    want = jspans.build_timelines(srv.span_events)
    log = treader.RunLog.load(tel.path)
    assert not log.unknown_events and not log.malformed
    got = tspans.timelines_from_run(log)
    _same_timelines(got, {i: _as_port(t) for i, t in want.items()})
    _same_timelines(tspans.build_timelines(srv.span_events), got)
    _reconciled(got)
    assert tspans.slo_autopsy(got) == jspans.slo_autopsy(want) == \
        stats.get("slo_autopsy", {})
    assert log.reconstruct_summary().get("slo_autopsy") == \
        stats.get("slo_autopsy")


def _as_port(tl):
    """A JAX ``RequestTimeline`` as the port's dataclass, for equality."""
    d = dataclasses.asdict(tl)
    d["spans"] = [tspans.Span(**s) for s in d["spans"]]
    d["donor_spans"] = [tspans.Span(**s) for s in d["donor_spans"]]
    return tspans.RequestTimeline(**d)


@pytest.mark.parametrize("name", CASES)
def test_port_stream_reconciles_and_autopsy_three_ways(tmp_path, name):
    """The port writes the stream: its stats, its ``run_end`` and the
    reconstruction carry one autopsy; JAX's reader and fold read the
    port's log to the same timelines; the port's events equal JAX's
    (wall fields left out)."""
    srv, reqs = _case(tsv, trs, name)
    tel = TTelemetry(str(tmp_path))
    with tel:
        _res, stats = srv.run(reqs)
    tls = tspans.build_timelines(srv.span_events)
    assert len(tls) == len(reqs)
    _reconciled(tls)
    log = treader.RunLog.load(tel.path)
    assert not log.unknown_events
    _same_timelines(tspans.timelines_from_run(log), tls)
    jtls = jspans.timelines_from_run(jreader.RunLog.load(tel.path))
    _same_timelines(tls, {i: _as_port(t) for i, t in jtls.items()})
    autopsy = stats.get("slo_autopsy")
    assert log.summary().get("slo_autopsy") == autopsy
    assert log.reconstruct_summary().get("slo_autopsy") == autopsy
    jsrv, jreqs = _case(jsv, jrs, name)
    jsrv.run(jreqs)
    strip = lambda evs: [{k: v for k, v in e.items()
                          if k not in ("wall_s", "latency_s")} for e in evs]
    assert strip(srv.span_events) == strip(jsrv.span_events)
    if name == "bursty":
        assert autopsy and autopsy["0"]["dominant_phase"] in tspans.PHASES
    phase = {"kv_wait": "kv_wait", "preempt": "preempted",
             "retry": "retry_backoff"}.get(name)
    if phase:
        assert any(t.phase_us.get(phase, 0) > 0 for t in tls.values())
    if name == "retry":
        assert tls[0].phase_us["retry_backoff"] == tspans.us(24.0)


def _jax_fleet(tmp_path, journals=False):
    inj = {0: jrs.ServingFaultInjector(engine_raise_at={1: "sim death"})}
    kw = {}
    if journals:
        base = str(tmp_path / "journal.jsonl")
        kw["journals"] = [jsv.RequestJournal(f"{base}.r{i}")
                          for i in range(2)]
    fleet = jsv.FleetRouter.simulated(
        jsv.SlotShape(max_batch=2, max_seq=S, buckets=(8, S)), 2,
        decode_steps=4, policy=jsv.SchedulerPolicy(name="slo"),
        resilience=jsv.ServingResilience(max_restarts=0),
        fault_injectors=inj, **kw)
    results, stats = fleet.run(jsv.make_workload(
        jsv.WorkloadSpec(**FLEET_BURSTY)))
    return fleet, results, stats


def test_fold_of_a_jax_fleet_with_a_replica_loss(tmp_path):
    """JAX's fleet loses replica 0 and transplants its work: the port's
    fold gives JAX's timelines, transplants and donor segments included,
    each reconciling."""
    fleet, _results, stats = _jax_fleet(tmp_path)
    assert fleet.dead == [0] and stats["redistributed"] > 0
    want = jspans.build_timelines(fleet.span_events)
    got = tspans.build_timelines(fleet.span_events)
    _same_timelines(got, {i: _as_port(t) for i, t in want.items()})
    assert sorted(got) == list(range(FLEET_BURSTY["n_requests"]))
    _reconciled(got)
    moved = [i for i in got if got[i].transplanted]
    assert len(moved) == stats["redistributed"]
    assert any(got[i].donor_spans for i in moved)
    assert tspans.slo_autopsy(got) == jspans.slo_autopsy(want)


def test_fleet_journals_fold_as_jax_folds_them(tmp_path):
    _fleet, results, _stats = _jax_fleet(tmp_path, journals=True)
    base = str(tmp_path / "journal.jsonl")
    paths = tspans.fleet_journal_paths(base)
    assert paths == jspans.fleet_journal_paths(base) == \
        [f"{base}.r0", f"{base}.r1"]
    rows = tspans.journal_outcomes(paths)
    assert rows == jspans.journal_outcomes(paths)
    for i, r in results.items():
        if r.error is None:
            assert rows[i]["tokens"] == len(r.tokens)


def test_merged_streams_with_a_torn_tail(tmp_path):
    """A log split over two streams, one with a torn tail, folds to the
    intact log's timelines; an unreadable stream alone is a read
    error."""
    srv, reqs = _case(tsv, trs, "bursty")
    tel = TTelemetry(str(tmp_path / "whole"))
    with tel:
        srv.run(reqs)
    lines = open(tel.path).read().splitlines(keepends=True)
    a, b = str(tmp_path / "s0.jsonl"), str(tmp_path / "s1.jsonl")
    open(a, "w").writelines(lines[:len(lines) // 2])
    with open(b, "w") as f:
        f.writelines(lines[len(lines) // 2:])
        f.write('{"ev": "request_end", "id": 99, "torn')
    merged = treader.RunLog.load_streams([a, b])
    assert merged.torn_tail and merged.read_error is None
    _same_timelines(tspans.timelines_from_run(merged),
                    tspans.timelines_from_run(treader.RunLog.load(tel.path)))
    gone = treader.RunLog.load_streams([str(tmp_path / "gone.jsonl")])
    assert gone.read_error is not None and gone.events == []


def test_waterfall_and_dominant_phase_match_jax():
    srv, reqs = _case(jsv, jrs, "preempt")
    srv.run(reqs)
    for rid, tl in jspans.build_timelines(srv.span_events).items():
        assert tspans.render_waterfall(_as_port(tl)) == \
            jspans.render_waterfall(tl), rid
    tie = dict(id=0, arrival_ms=0.0, end_ms=2.0, e2e_ms=2.0,
               queue_wait_ms=1.0, tier=0, slo_ok=False, error=None, tokens=1,
               spans=[], donor_spans=[], transplanted=False,
               phase_us={"queued": 1000, "decode": 1000})
    assert tspans.RequestTimeline(**tie).dominant_phase == "queued"
    assert tspans.PHASES == jspans.PHASES
    for x in (0.0, 0.001, 8.25, 41.667, 12345.999, 0.1 + 0.2):
        assert tspans.us(round(x, 3)) == jspans.us(round(x, 3))
