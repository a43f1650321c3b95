"""The port's run telemetry (``flexflow_torch/runtime/telemetry.py``,
``obs/``), held against the JAX package's on the CPU.

- A port run log is read by JAX's ``flexflow_tpu.obs.reader.RunLog``
  with no unknown event, and its summary reconstructs from the events.
- The same fit writes the same event sequence and the same counts
  (steps, fences, fences per step) in both packages, less JAX's
  ``input_wait``: the port's fixed batch is pulled from no source.
- Telemetry wraps the trainer's fences and adds none.
- ``run_end.exit`` is ``clean``, ``exception:<type>`` or ``preempt``, as
  JAX classifies it.
- The watchdog fires once per stall under a driven clock, notifies an
  external pid, and refuses its own; rare events flush at once, steps
  buffer.
"""

import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.obs import registry as jregistry
from flexflow_tpu.obs.reader import RunLog
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_tpu.runtime.telemetry import Telemetry as JTelemetry
from flexflow_tpu.runtime.trainer import Trainer as JTrainer
from flexflow_torch import bench
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.graph import FFModel as TModel
from flexflow_torch.obs import events as tevents
from flexflow_torch.obs import registry as tregistry
from flexflow_torch.optim import SGDOptimizer as TSGD
from flexflow_torch.runtime import telemetry
from flexflow_torch.runtime.checkpoint import CheckpointManager
from flexflow_torch.runtime.chaos import chaos_batch_fn, tiny_factory
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.resilience import FaultInjector, ResilientTrainer
from flexflow_torch.runtime.telemetry import NULL, Telemetry
from flexflow_torch.runtime.trainer import Trainer
from flexflow_torch.search.cost_model import train_flops


def _model(pkg, batch=8, depth=2, seed=11):
    if pkg == "jax":
        ff, i32 = JModel(JConfig(batch_size=batch, seed=seed)), np.int32
    else:
        ff, i32 = TModel(TConfig(batch_size=batch, seed=seed)), torch.int32
    x = ff.create_tensor((batch, 16), name="x")
    lbl = ff.create_tensor((batch,), dtype=i32, name="label")
    t = x
    for i in range(depth):
        t = ff.dense(t, 32, activation="relu", name=f"fc{i}")
    t = ff.dense(t, 4, name="head")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _tex():
    return TExecutor(_model("torch"), optimizer=TSGD(lr=0.1), device="cpu")


def _jex():
    return JExecutor(_model("jax"), optimizer=JSGD(lr=0.1),
                     devices=jax.devices()[:1])


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


FITS = {"per_step": dict(iterations=4, warmup=1, log_every=2),
        "superstep": dict(iterations=8, warmup=2, steps_per_call=4)}


def test_event_catalog_is_jax_s():
    from flexflow_tpu.analysis.lint import FF008_EVENT_NAMES
    from flexflow_tpu.obs import events as jevents

    assert tevents.EVENT_CATALOG == jevents.EVENT_CATALOG == FF008_EVENT_NAMES
    assert (tevents.EXIT_CLEAN, tevents.EXIT_PREEMPT,
            tevents.EXIT_TRUNCATED) == (jevents.EXIT_CLEAN,
                                        jevents.EXIT_PREEMPT,
                                        jevents.EXIT_TRUNCATED)
    assert tevents.exit_exception("X") == jevents.exit_exception("X")


@pytest.mark.parametrize("fit", list(FITS))
def test_jax_reader_reads_a_port_run(tmp_path, fit):
    with Telemetry(str(tmp_path)) as tel:
        stats = Trainer(_tex()).fit(**FITS[fit])
    log = RunLog.load(tel.path)
    assert log.unknown_events == [] and log.malformed == 0
    assert log.complete and log.exit == "clean"
    assert log.summary() == stats["telemetry"]
    rebuilt = log.reconstruct_summary()
    for key in ("steps", "fences", "fences_per_step", "step_ms_p50",
                "step_ms_p95", "step_ms_max"):
        assert rebuilt[key] == stats["telemetry"][key], key
    assert log.fingerprint["platform"] == "cpu"
    assert log.run_end.get("calibration")["steps"] == stats["iterations"]


@pytest.mark.parametrize("fit", list(FITS))
def test_same_fit_same_events_and_counts_as_jax(tmp_path, fit):
    with Telemetry(str(tmp_path / "t")) as ttel:
        tstats = Trainer(_tex()).fit(**FITS[fit])
    with JTelemetry(str(tmp_path / "j")) as jtel:
        jstats = JTrainer(_jex()).fit(**FITS[fit])
    tev, jev = _events(ttel.path), _events(jtel.path)
    # JAX times the pull of its batch iterator; the port's fixed batch is
    # pulled from no source, so it records no input wait.
    assert [e["ev"] for e in tev] == \
        [e["ev"] for e in jev if e["ev"] != "input_wait"]
    assert "input_waits" not in tstats["telemetry"]
    assert [e["label"] for e in tev if e["ev"] == "fence"] == \
        [e["label"] for e in jev if e["ev"] == "fence"]
    assert [e["step"] for e in tev if e["ev"] == "step"] == \
        [e["step"] for e in jev if e["ev"] == "step"]
    for key in ("steps", "fences", "fences_per_step"):
        assert tstats["telemetry"][key] == jstats["telemetry"][key], key
    cost = [e for e in tev if e["ev"] == "program_cost"]
    assert len(cost) == 1 and cost[0]["source"] == "cost_model"
    k = FITS[fit].get("steps_per_call", 1)
    assert cost[0]["flops"] == train_flops(_model("torch")) * k


@pytest.mark.parametrize("fit", list(FITS))
def test_telemetry_adds_no_fence(monkeypatch, tmp_path, fit):
    seen = []
    real = telemetry.host_fence
    monkeypatch.setattr(telemetry, "host_fence",
                        lambda v: seen.append(1) or real(v))
    off = Trainer(_tex()).fit(**FITS[fit])
    n_off = len(seen)
    with Telemetry(str(tmp_path)):
        on = Trainer(_tex()).fit(**FITS[fit])
    assert len(seen) - n_off == n_off == on["telemetry"]["fences"]
    assert on["step_losses"] == off["step_losses"]
    assert "telemetry" not in off
    assert NULL.fence is not None and not NULL.enabled


def _exit_of(pkg_tel, d, how):
    tel = pkg_tel(d)
    try:
        with tel:
            if how == "preempt":
                tel.emit("preempt", step=3, signum=int(signal.SIGTERM))
            elif how == "exception":
                raise KeyError("boom")
    except KeyError:
        pass
    return _events(tel.path)[-1]["exit"]


@pytest.mark.parametrize("how", ["clean", "exception", "preempt"])
def test_exit_is_classified_as_jax_does(tmp_path, how):
    got = _exit_of(Telemetry, str(tmp_path / "t"), how)
    assert got == _exit_of(JTelemetry, str(tmp_path / "j"), how)
    assert got == {"clean": "clean", "exception": "exception:KeyError",
                   "preempt": "preempt"}[how]
    rows = [json.loads(ln) for ln in open(
        tregistry.index_path(str(tmp_path / "t")))]
    assert len(rows) == 1 and rows[0]["exit"] == got


# -- the watchdog -----------------------------------------------------------


def test_watchdog_fires_once_per_stall_under_a_driven_clock(monkeypatch,
                                                            tmp_path):
    now = [0.0]
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
    other = os.getppid()
    with Telemetry(str(tmp_path), stall_deadline_s=1.0, clock=lambda: now[0],
                   notify_pid=other, watchdog=False) as tel:
        tel.heartbeat("step:0")
        now[0] = 0.9
        assert not tel.check_stall()
        now[0] = 1.5
        assert tel.check_stall()          # the stall
        now[0] = 9.0
        assert not tel.check_stall()      # the same stall: no second event
        tel.heartbeat("step:1")           # recovered
        now[0] = 10.5
        assert tel.check_stall()          # a new stall
    ev = [e for e in _events(tel.path)
          if e["ev"] in ("stall", "stall_recovered")]
    assert [e["ev"] for e in ev] == ["stall", "stall_recovered", "stall"]
    assert ev[0]["last"] == "step:0" and ev[0]["idle_s"] == 1.5
    assert ev[0]["notified_pid"] == other
    assert kills == [(other, signal.SIGUSR1)] * 2


def test_watchdog_thread_reads_the_driven_clock(tmp_path):
    now = [0.0]
    with Telemetry(str(tmp_path), stall_deadline_s=0.05,
                   clock=lambda: now[0]) as tel:
        now[0] = 1.0
        for _ in range(200):  # the thread polls every 0.05 s
            if tel._stalled:
                break
            time.sleep(0.01)
        assert tel._stalled
        time.sleep(0.15)  # three more polls: still one event
    assert [e["ev"] for e in _events(tel.path)].count("stall") == 1
    assert not tel._watchdog.is_alive()


@pytest.mark.parametrize("pid", ["self", -5])
def test_watchdog_never_signals_its_own_process(tmp_path, pid):
    pid = os.getpid() if pid == "self" else pid
    tel = Telemetry(None, stall_deadline_s=1.0, notify_pid=pid,
                    watchdog=False)
    assert tel._notify_pid == 0 and tel._notify_supervisor() == 0
    tel.close()


def test_rare_events_flush_and_steps_buffer(monkeypatch, tmp_path):
    monkeypatch.setattr(telemetry, "FLUSH_EVERY_S", 1e9)
    with Telemetry(str(tmp_path)) as tel:
        tel.record_step(0, loss=1.5, wall_s=0.01)
        assert [e["ev"] for e in _events(tel.path)] == ["run_start"]
        tel.emit("fault", mode="raise", step=0)
        assert [e["ev"] for e in _events(tel.path)] == \
            ["run_start", "step", "fault"]
        assert os.path.exists(os.path.join(str(tmp_path), "heartbeat"))


def test_maybe_run_from_the_environment_and_nesting(monkeypatch, tmp_path):
    monkeypatch.setenv("FF_TELEMETRY_DIR", str(tmp_path))
    stats = Trainer(_tex()).fit(iterations=2, warmup=1)
    assert stats["telemetry"]["steps"] == 2
    with Telemetry(str(tmp_path / "outer")) as outer:
        Trainer(_tex()).fit(iterations=2, warmup=1)
        Trainer(_tex()).fit(iterations=3, warmup=1)
    assert outer.counts["steps"] == 5
    monkeypatch.delenv("FF_TELEMETRY_DIR")
    assert telemetry.maybe_run(TConfig()) is NULL


def test_fingerprint_keeps_jax_s_keys():
    tfp, jfp = tregistry.box_fingerprint(), jregistry.box_fingerprint()
    assert set(jfp) <= set(tfp)
    assert tfp["platform"] == "cpu" and tfp["jax"] is None
    assert tfp["torch"] == torch.__version__
    assert tfp["process_id"] == 0 and tfp["process_count"] == 1
    diff = tregistry.fingerprint_diff(tfp, jfp)
    assert any(d.startswith("jax:") for d in diff)
    assert tregistry.fingerprint_diff(tfp, dict(tfp)) == []


def test_resilient_log_reconstructs_the_run(tmp_path):
    """A chaos run's log: fault, rollback, replay in order, checkpoint
    saves and restores, and the step events' last loss per index equal
    the returned losses."""
    ex_factory = tiny_factory("cpu")

    def factory():
        ex = ex_factory()
        ex.config.telemetry_dir = str(tmp_path / "tel")
        return ex

    with CheckpointManager(str(tmp_path / "ck")) as ck:
        out = ResilientTrainer(factory, ck, fault_injector=FaultInjector(
            nan_loss_at=(11,))).fit(16, chaos_batch_fn, save_every=8,
                                    steps_per_call=8)
    log = RunLog.load(next(str(p) for p in (tmp_path / "tel").glob(
        "run-*.jsonl")))
    names = [e.ev for e in log.events]
    assert names.index("fault") < names.index("rollback") < \
        names.index("replay")
    assert "ckpt_save" in names and "ckpt_restore" in names
    assert log.losses() == out["losses"] and log.exit == "clean"
    # Steps 8-10 were recorded before the NaN at 11, then again.
    assert out["telemetry"]["steps"] == 16 + 3


def test_bench_telemetry_leg_small_on_cpu(monkeypatch):
    monkeypatch.setenv("FF_TELEMETRY_DIR", "/nonexistent-telemetry-dir")
    out = bench.bench_telemetry(device="cpu", batch=8, width=16, iters=4)
    assert os.environ["FF_TELEMETRY_DIR"] == "/nonexistent-telemetry-dir"
    assert not os.path.exists("/nonexistent-telemetry-dir")
    assert out["fences_per_step"] == 0.5  # warmup + final over 4 steps
    assert out["step_ms_p50"] <= out["step_ms_p95"] <= out["step_ms_max"]
    assert set(out) == {"batch_size", "iterations", "fences_per_step", "step_ms_p50", "step_ms_p95",
                        "step_ms_max", "overhead_pct"}
