"""The port's run reader, comparator, CLI and the serving loop's
telemetry (``flexflow_torch/obs/``, ``runtime/serving.py``), held against
the JAX package's on the CPU.

- ``RunLog`` reads JAX-written and port-written logs (complete, torn,
  garbled, truncated, ended by an exception, with unknown events) to
  JAX's events, summaries, calibration blocks and exit classes.
- ``compare`` and ``python -m flexflow_torch.obs report|request|compare|
  history`` print what JAX's print on the same files.
- The plain ``Server`` under telemetry emits JAX's event sequence (names
  and the fields that carry no wall time) for the padded loop and for
  the paged loop with the prefix cache and speculation, and serves the
  same tokens with the same fences with telemetry off.
- ``ServingLatencyModel``'s fit and prices equal JAX's on the same
  events, and ``from_run`` reads a port run's calibration block as JAX's
  ``Calibration.from_summary`` reads it.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest

from flexflow_tpu import serving as jsv
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.obs import compare as jcompare
from flexflow_tpu.obs import reader as jreader
from flexflow_tpu.obs.__main__ import main as jmain
from flexflow_tpu.runtime import serving as jrs
from flexflow_tpu.runtime.telemetry import Telemetry as JTelemetry
from flexflow_torch import serving as tsv
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.obs import compare as tcompare
from flexflow_torch.obs import reader as treader
from flexflow_torch.obs.__main__ import main as tmain
from flexflow_torch.runtime import serving as trs
from flexflow_torch.runtime import telemetry as ttel
from flexflow_torch.weights import params_from_numpy

V, D, H, L, S = 64, 32, 2, 2, 32
BURSTY = dict(n_requests=16, vocab=V, prompt_len=(3, 6), max_new=(2, 10),
              mean_gap_ms=1.0, burst=8, priorities=3, slo_ms=20.0, seed=5)


@pytest.fixture(scope="module")
def stacks():
    """``{layout: (jax executor, port executor)}`` on one tiny LM and
    ``(jax params, port params)``: JAX's, carried over."""
    kw = dict(batch_size=2, seq_len=S, vocab_size=V, d_model=D, num_heads=H,
              num_layers=L)
    jlm = jbuild(config=JConfig(batch_size=2), **kw)
    tlm = tbuild(config=TConfig(batch_size=2), **kw)
    out = {}
    for name, ex in (("padded", {}), ("paged", dict(kv_block=8,
                                                    prefix_cache=True))):
        ex.update(max_batch=2, max_seq=S, buckets=(8, 16, S))
        out[name] = (jrs.ServingExecutor(jlm, decode_kernel=False, **ex),
                     trs.ServingExecutor(tlm, device="cpu", **ex))
    jparams, _ = out["padded"][0].init(seed=0)
    out["params"] = (jparams,
                     params_from_numpy(jax.device_get(jparams), device="cpu"))
    return out


def _requests(rt):
    """Seven requests: three that share a 16-token prefix (the prefix
    cache's hits; the 16-token prompt recomputes its last shared block, a
    ``kv_cow``), three synthetic, and one too long for every bucket."""
    span = np.arange(1, 17, dtype=np.int32)
    reqs = [rt.Request(id=i, prompt=np.concatenate(
        [span, np.asarray(tail, np.int32)]).astype(np.int32),
        max_new_tokens=5) for i, tail in enumerate(([5, 6], [], [7, 8, 9]))]
    for r in rt.synthetic_requests(3, V, prompt_len=(3, 9), max_new_tokens=6,
                                   seed=3):
        reqs.append(rt.Request(id=3 + r.id, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens))
    reqs.append(rt.Request(id=6, prompt=np.ones(S + 1, np.int32),
                           max_new_tokens=2))
    return reqs


def _serve(side, stacks, tmp_path, layout="padded", speculate=0, tel=True):
    jex, tex = stacks[layout]
    jp, tp = stacks["params"]
    if side == "jax":
        srv = jrs.Server(jex, jp, {}, decode_steps=4, speculate=speculate)
        reqs, T = _requests(jrs), JTelemetry
    else:
        srv = trs.Server(tex, tp, {}, decode_steps=4, speculate=speculate)
        reqs, T = _requests(trs), ttel.Telemetry
    if not tel:
        return srv.run(reqs) + (None,)
    t = T(str(tmp_path / side), meta={"app": "serve"})
    with t:
        res, stats = srv.run(reqs)
    return res, stats, t.path


#: Fields of an event that carry wall time or the process's identity.
_VARYING = {"ts", "seq", "wall_s", "latency_s", "run_id", "pid",
            "fingerprint", "summary", "calibration"}


def _sequence(path):
    """The log's events, program costs left out (JAX's carry XLA's byte
    estimates), each without its varying fields."""
    return [{k: v for k, v in e.items() if k not in _VARYING}
            for e in jreader.RunLog.load(path).iter_raw()
            if e["ev"] != "program_cost"]


@pytest.mark.parametrize("layout,speculate", [("padded", 0), ("paged", 2)])
def test_plain_server_emits_jax_event_sequence(stacks, tmp_path, layout,
                                               speculate):
    jres, jst, jpath = _serve("jax", stacks, tmp_path, layout, speculate)
    tres, tst, tpath = _serve("torch", stacks, tmp_path, layout, speculate)
    assert {i: (r.tokens, r.error) for i, r in tres.items()} == \
        {i: (r.tokens, r.error) for i, r in jres.items()}
    seq = _sequence(tpath)
    assert seq == _sequence(jpath)
    names = {e["ev"] for e in seq}
    assert {"serving_program", "request_start", "request_end", "prefill",
            "fence", "step"} <= names
    assert ("spec_verify" if speculate else "decode_superstep") in names
    if layout == "paged":
        assert {"prefix_hit", "kv_cow"} <= names
    log = treader.RunLog.load(tpath)
    assert len(log.select("request_start")) == \
        len(log.select("request_end")) == len(_requests(trs))
    costs = log.select("program_cost")
    assert costs and all(e["flops"] > 0 and e["source"] == "cost_model"
                         for e in costs)
    summ = log.summary()
    assert summ["programs_per_step"] == round(
        1 / (speculate + 1 if speculate else 4), 4)
    rec = log.reconstruct_summary()
    for k in ("prefix_hit_rate", "prefill_tokens_saved",
              "spec_acceptance_rate", "spec_tokens_per_dispatch"):
        assert rec.get(k) == summ.get(k) == tst["telemetry"].get(k), k
        assert rec.get(k) == jreader.RunLog.load(jpath).summary().get(k), k


def test_plain_server_telemetry_off_same_tokens_and_fences(stacks, tmp_path,
                                                           monkeypatch):
    calls = []
    real = trs._readback
    monkeypatch.setattr(trs, "_readback",
                        lambda v: (calls.append(1), real(v))[1])
    on, on_st, path = _serve("torch", stacks, tmp_path)
    n_on = len(calls)
    calls.clear()
    off, off_st, _ = _serve("torch", stacks, tmp_path, tel=False)
    assert {i: r.tokens for i, r in on.items()} == \
        {i: r.tokens for i, r in off.items()}
    assert len(calls) == n_on == on_st["prefills"] + on_st["decode_supersteps"]
    assert len(treader.RunLog.load(path).select("fence")) == n_on
    assert "telemetry" in on_st and "telemetry" not in off_st


# -- the reader ------------------------------------------------------------------


def _write(path, records, tail=""):
    with open(path, "w") as f:
        for r in records:
            f.write((r if isinstance(r, str) else json.dumps(r)) + "\n")
        f.write(tail)
    return str(path)


@pytest.fixture(scope="module")
def logs(stacks, tmp_path_factory):
    """Run logs of both packages, and hand-made damaged ones."""
    d = tmp_path_factory.mktemp("logs")
    out = {}
    for side in ("jax", "torch"):
        _r, _s, out[f"{side}_serve"] = _serve(side, stacks, d, "paged", 2)
        pkg, rt, T = ((jsv, jrs, JTelemetry) if side == "jax"
                      else (tsv, trs, ttel.Telemetry))
        t = T(str(d / f"{side}_sched"))
        with t:
            pkg.ScheduledServer.simulated(
                pkg.SlotShape(max_batch=2, max_seq=S, buckets=(8, S)),
                decode_steps=4, policy=pkg.SchedulerPolicy(
                    name="slo", shed_depth=3),
                resilience=pkg.ServingResilience(max_retries=1,
                                                 max_restarts=1),
                fault_injector=rt.ServingFaultInjector(
                    nan_cache_at={1: 0}, engine_raise_at={3: "x"}),
            ).run(pkg.make_workload(pkg.WorkloadSpec(**BURSTY)))
        out[f"{side}_sched"] = t.path
        t = T(str(d / f"{side}_train"), meta={"app": "mlp"})
        with contextlib.suppress(KeyError):
            with t:
                for i in range(5):
                    t.record_step(i, loss=1.0 / (i + 1), wall_s=0.01 * (i + 1))
                    t.record_input_wait(i, 0.001 * i, depth=2)
                t.emit("fault", mode="raise", step=2)
                t.emit("rollback", to_step=0)
                t.emit("superstep", k=4, programs_per_step=0.25)
                raise KeyError("planted")
        out[f"{side}_train"] = t.path
    lines = open(out["torch_sched"]).read().splitlines()
    out["torn"] = _write(d / "torn.jsonl", lines[:-1], tail=lines[-1][:30])
    out["garbled"] = _write(d / "garbled.jsonl", lines[:5] + [
        "not json", "[1, 2]", '{"no_ev": 1}',
        '{"ev": "from_the_future", "x": 1}'] + lines[5:])
    out["truncated"] = _write(d / "truncated.jsonl", lines[:len(lines) // 2])
    out["missing"] = str(d / "missing.jsonl")
    return out


LOGS = ("jax_serve", "torch_serve", "jax_sched", "torch_sched", "jax_train",
        "torch_train", "torn", "garbled", "truncated", "missing")


@pytest.mark.parametrize("name", LOGS)
def test_runlog_reads_as_jax_reads(logs, name):
    j = jreader.RunLog.load(logs[name])
    t = treader.RunLog.load(logs[name])
    assert [e.data for e in t.events] == [e.data for e in j.events]
    assert [(e.ts, e.seq, e.ev) for e in t.events] == \
        [(e.ts, e.seq, e.ev) for e in j.events]
    for attr in ("malformed", "torn_tail", "unknown_events", "exit",
                 "complete", "run_id", "fingerprint"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (t.read_error is None) == (j.read_error is None)
    for fn in ("summary", "reconstruct_summary", "calibration",
               "trace_summary", "losses"):
        assert getattr(t, fn)() == getattr(j, fn)(), fn
    assert sorted(t.steps()) == sorted(j.steps())
    merged = [logs["torch_sched"], logs[name]]
    tm, jm = (treader.RunLog.load_streams(merged),
              jreader.RunLog.load_streams(merged))
    assert [e.data for e in tm.events] == [e.data for e in jm.events]
    assert (tm.malformed, tm.torn_tail, tm.unknown_events) == \
        (jm.malformed, jm.torn_tail, jm.unknown_events)
    want = {"torn": "truncated", "truncated": "truncated",
            "missing": "truncated", "jax_train": "exception:KeyError",
            "torch_train": "exception:KeyError"}.get(name, "clean")
    assert t.exit == want


def test_run_files_and_latest_run(logs, tmp_path):
    import os
    import time

    d = os.path.dirname(logs["torch_sched"])
    assert treader.run_files(d) == jreader.run_files(d)
    assert treader.latest_run(d) == jreader.latest_run(d)
    assert treader.resolve_run(d) == treader.latest_run(d)
    assert treader.latest_run(d, exclude=treader.latest_run(d)) is None
    a = _write(tmp_path / "run-a.jsonl", [{"ev": "run_start"}])
    time.sleep(0.01)
    b = _write(tmp_path / "run-b.jsonl", [{"ev": "run_start"}])
    assert treader.latest_run(str(tmp_path)) == b
    assert treader.latest_run(str(tmp_path), exclude=b) == a
    assert treader.resolve_run(a) == a
    assert treader.run_files(str(tmp_path / "none")) == []


# -- compare and the CLI ---------------------------------------------------------


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("a,b", [("jax_sched", "torch_sched"),
                                 ("torch_serve", "jax_serve"),
                                 ("torch_sched", "torch_sched"),
                                 ("torch_train", "truncated")])
def test_compare_prints_what_jax_prints(logs, a, b):
    t = tcompare.compare_paths(logs[a], logs[b])
    j = jcompare.compare_paths(logs[a], logs[b])
    assert t.format() == j.format() and t.verdict == j.verdict
    for gate in ([], ["--gate"]):
        assert _cli(tmain, ["compare", logs[a], logs[b]] + gate) == \
            _cli(jmain, ["compare", logs[a], logs[b]] + gate)
    if a.endswith("sched") and b.endswith("sched"):
        # The two packages' simulated runs decide alike: no drift in any
        # virtual-clock or accounting metric.
        assert t.verdict == "ok"
    with pytest.raises(FileNotFoundError):
        tcompare.compare_paths(logs["missing"], logs[b])


def test_compare_flattens_the_autopsy():
    def log(pkg, missed):
        return pkg.RunLog.from_events([
            {"ev": "run_start", "app": "serve"},
            {"ev": "run_end", "exit": "clean", "summary": {
                "slo_attainment": 0.8, "slo_autopsy": {"0": {
                    "missed": missed, "dominant_phase": "queued",
                    "phase_ms": {"queued": 30.0, "decode": 5.0}}}}}])

    for missed in (3, 5):
        t = tcompare.compare_runs(log(treader, 3), log(treader, missed))
        j = jcompare.compare_runs(log(jreader, 3), log(jreader, missed))
        assert t.format() == j.format()
    assert t.verdict == "drift:slo_missed_t0"
    assert tcompare.DEFAULT_THRESHOLDS == jcompare.DEFAULT_THRESHOLDS


def test_paired_measure_matches_jax():
    vals = iter([10.0, 11.0, 9.0, 12.0, 10.5, 10.0, 9.5, 11.5] * 4)
    seq = [next(vals) for _ in range(32)]

    def legs():
        it = iter(seq)
        return (lambda r: next(it)), (lambda r: next(it) * 1.1), \
            (lambda r: next(it))

    t = tcompare.paired_measure(*legs()[:2], reps=4, control=legs()[2])
    j = jcompare.paired_measure(*legs()[:2], reps=4, control=legs()[2])
    assert vars(t) == vars(j)
    assert (t.median_delta_pct, t.median_ratio, t.median_aa_pct) == \
        (j.median_delta_pct, j.median_ratio, j.median_aa_pct)


@pytest.mark.parametrize("name", LOGS)
def test_cli_report_and_request_print_what_jax_prints(logs, name):
    path = logs[name]
    assert _cli(tmain, ["report", path]) == _cli(jmain, ["report", path])
    for extra in ([], ["0"], ["--slo-miss", "--worst", "2"], ["--worst", "1"],
                  ["99"]):
        argv = ["request", path] + extra
        assert _cli(tmain, argv) == _cli(jmain, argv), argv
    if name.endswith("sched"):
        rc, out, _ = _cli(tmain, ["report", path])
        assert rc == 0 and "serving:" in out and "slo autopsy" in out
        rc, out, _ = _cli(tmain, ["request", path, "--id", "0"])
        assert rc == 0 and "reconciled=yes" in out
        assert out == _cli(jmain, ["request", path, "0"])[1]


def test_cli_request_with_streams_and_journal(logs, tmp_path):
    journal = tsv.RequestJournal(str(tmp_path / "j.jsonl"))
    journal.done(42, 3, 2, None)
    journal.close()
    argv = ["request", logs["torch_sched"], "--stream", logs["truncated"],
            "--journal", str(tmp_path / "j.jsonl")]
    rc, out, err = _cli(tmain, argv)
    assert (rc, out, err) == _cli(jmain, argv)
    assert "journal-only requests (telemetry stream lost them): [42]" in out


def test_cli_history_prints_what_jax_prints(logs):
    import os

    for name in ("torch_sched", "jax_sched", "torch_train", "missing"):
        d = os.path.dirname(logs[name])
        assert _cli(tmain, ["history", d]) == _cli(jmain, ["history", d])
    rc, out, _ = _cli(tmain, ["history", os.path.dirname(logs["torch_sched"])])
    assert rc == 0 and "clean" in out


# -- the latency model -----------------------------------------------------------


def _events(logs):
    """Serving events of both packages' runs, and hand-made spec and
    prefix events."""
    evs = []
    for name in ("jax_serve", "torch_serve"):
        evs += list(treader.RunLog.load(logs[name]).iter_raw())
    evs += [{"ev": "spec_verify", "d": 3, "wall_s": 0.009},
            {"ev": "spec_verify", "d": 2, "wall_s": 0.004},
            {"ev": "prefix_hit", "full": True, "tokens_saved": 16},
            {"ev": "prefix_hit", "full": False, "tokens_saved": 8},
            {"ev": "prefill", "bucket": 32, "offset": 8, "wall_s": 0.002},
            {"ev": "decode_superstep", "k": 8, "wall_s": 0.0}]
    return evs


def test_latency_model_fit_and_prices_match_jax(logs):
    jm = jsv.ServingLatencyModel.from_calibration().fit_events(
        _events(logs), source="x")
    tm = tsv.ServingLatencyModel().fit_events(_events(logs), source="x")
    assert tm.to_json() == jm.to_json() and tm.calibrated
    assert tm.describe() == jm.describe()
    for b in (8, 16, 32, 128):
        assert tm.prefill_ms(b) == jm.prefill_ms(b)
        assert tm.prefill_ms(b, 8) == jm.prefill_ms(b, 8)
        assert tm.expected_prefill_ms(b) == jm.expected_prefill_ms(b)
        assert tm.draft_prefill_ms(b) == jm.draft_prefill_ms(b)
    for k in (1, 2, 4, 8, 16):
        assert tm.decode_ms(k) == jm.decode_ms(k)
        assert tm.spec_ms(k) == jm.spec_ms(k)
    default_j = jsv.ServingLatencyModel.from_calibration()
    assert tsv.ServingLatencyModel().to_json() == default_j.to_json()
    hits = [e for e in _events(logs) if e["ev"] == "prefix_hit"]
    pm = tsv.ServingLatencyModel().fit_events(hits)
    assert pm.prefix_hit_rate > 0 and pm.prefix_mean_offset > 0
    assert pm.expected_prefill_ms(32) < pm.prefill_ms(32)


@pytest.mark.parametrize("name", ("torch_serve", "jax_serve", "torch_sched",
                                  "truncated", "missing"))
def test_latency_model_from_run_matches_jax(logs, name):
    t = tsv.ServingLatencyModel.from_run(treader.RunLog.load(logs[name]))
    j = jsv.ServingLatencyModel.from_run(jreader.RunLog.load(logs[name]))
    assert t.to_json() == j.to_json()
    block = {"fence_ms": 0.2, "step_ms_p50": 3.0, "programs_per_step": 2.5,
             "steps": 9}
    from flexflow_tpu.search.cost_model import Calibration

    for blk in (block, dict(block, dispatch_ms_per_program=0.7),
                dict(block, programs_per_step=1.0), {"steps": 3}):
        t = tsv.ServingLatencyModel.from_calibration(blk, source="p")
        j = jsv.ServingLatencyModel.from_calibration(
            Calibration.from_summary(blk, source="p"))
        assert t.to_json() == j.to_json(), blk
