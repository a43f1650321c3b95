"""The port's resilient trainer and chaos matrix
(``flexflow_torch/runtime/resilience.py``, ``runtime/chaos.py``) on the
CPU, held against the JAX package where JAX defines the answer.

- Every ported training scenario of the chaos matrix recovers with a
  loss trajectory bit-identical to the unfaulted run, at K = 1 (the
  per-step path) and K = 8 (supersteps).
- The unfaulted trajectory equals JAX's on the chaos MLP from the same
  weights and the same ``chaos_batch_fn`` batches, within 1e-5, both on
  one device (JAX's ``n2c4`` table on 8 devices against the port's world
  of 8 ranks: ``tests/test_torch_chaos_mesh.py``).
- The restart budget, its reset on durable progress, ``fatal``, and the
  narrow ``recoverable`` types behave as ``tests/test_resilience.py``
  pins them for JAX.
- ``Trainer.fit`` saves and stops cleanly on SIGTERM; the apps run
  ``--resilient`` with ``--telemetry`` and still refuse by name what is
  not ported.
"""

import glob
import json
import os
import signal

import jax
import numpy as np
import pytest

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_torch.apps import candle_uno as tcandle
from flexflow_torch.apps import transformer as ttransformer
from flexflow_torch.runtime import chaos
from flexflow_torch.runtime.checkpoint import CheckpointManager
from flexflow_torch.runtime.resilience import (
    FailurePolicy,
    FaultInjector,
    ResilientTrainer,
    StepFailure,
)
from flexflow_torch.runtime.trainer import Trainer
from flexflow_torch.tools import chaos_smoke
from flexflow_torch.weights import params_from_numpy

TRAINING = ("raised_fault", "nan_batch", "nan_loss", "sigterm",
            "corrupt_checkpoint")


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("name", TRAINING)
def test_chaos_scenario_recovers_bit_for_bit(tmp_path, name, k):
    ok, detail = chaos.SCENARIOS[name](str(tmp_path), device="cpu", k=k)
    assert ok, detail


def test_force_save_kill_scenario(tmp_path):
    ok, detail = chaos.scenario_force_save_kill(str(tmp_path), device="cpu")
    assert ok, detail


def test_matrix_reports_what_is_not_ported(tmp_path):
    rows = chaos.run_matrix(str(tmp_path), ["loader_fault", "host_loss",
                                             "pipeline_superstep_nan",
                                             "force_save_kill"],
                            device="cpu")
    got = {name: (ok, detail) for ok, name, detail in rows}
    assert got["loader_fault"] == (None, "not ported (item 12)")
    assert got["host_loss"] == (None, "not ported (item 13)")
    assert got["pipeline_superstep_nan"] == (None, "not ported (item 10b)")
    assert got["force_save_kill"][0] is True
    with pytest.raises(NotImplementedError, match="item 13"):
        chaos.SCENARIOS["coordinator_loss"](str(tmp_path))
    assert set(chaos.SCENARIOS) == set(
        __import__("flexflow_tpu.runtime.chaos",
                   fromlist=["SCENARIOS"]).SCENARIOS)


def test_chaos_smoke_tool_on_cpu(capsys):
    assert chaos_smoke.main(["--device", "cpu", "sigterm",
                             "host_loss"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("PASS") and " sigterm " in out[0]
    assert out[1].startswith("NOT PORTED") and "(item 13)" in out[1]
    assert "1/1 ported scenarios passed, 1 not ported" in out[2]
    assert chaos_smoke.main(["--device", "cpu", "no_such"]) == 2


# -- the unfaulted trajectory against JAX --------------------------------------


def _jax_chaos_executor():
    ff = JModel(JConfig(batch_size=8))
    x = ff.create_tensor((8, 16), name="x")
    lbl = ff.create_tensor((8,), dtype=np.int32, name="label")
    t = ff.dense(x, 32, activation="relu", name="fc1")
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return JExecutor(ff, optimizer=JSGD(lr=0.1), devices=jax.devices()[:1])


def test_unfaulted_trajectory_matches_jax(tmp_path):
    jex = _jax_chaos_executor()
    params, opt, state = jex.init(seed=0)
    start = jax.device_get(params)
    step = jax.jit(jex.train_step)
    want = []
    for s in range(chaos.ITERS):
        params, opt, state, m = step(params, opt, state,
                                     jex.shard_batch(chaos.chaos_batch_fn(s)))
        want.append(float(m["train_loss"]))

    def factory():
        ex = chaos.tiny_factory("cpu")()

        def init(seed=None):  # JAX's initial weights
            return params_from_numpy(start, device="cpu"), None, {}

        ex.init = init
        return ex

    with CheckpointManager(str(tmp_path)) as ck:
        out = ResilientTrainer(factory, ck).fit(
            chaos.ITERS, chaos.chaos_batch_fn, save_every=chaos.SAVE_EVERY,
            steps_per_call=chaos.K)
    got = chaos.trajectory(out["losses"], chaos.ITERS)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- the recovery rules (tests/test_resilience.py) ------------------------------


def _fit(tmp_path, inject, iterations=4, **kw):
    with CheckpointManager(str(tmp_path / "ck")) as ck:
        rt = ResilientTrainer(chaos.tiny_factory("cpu"), ck,
                              fault_injector=inject, **kw)
        try:
            return rt, rt.fit(iterations=iterations,
                              batch_fn=chaos.chaos_batch_fn, save_every=3)
        except BaseException as e:
            return rt, e


def test_restart_budget_exhausted_raises(tmp_path):
    def inject(step):
        raise RuntimeError("permanently broken")

    rt, err = _fit(tmp_path, inject, policy=FailurePolicy(max_restarts=2))
    assert isinstance(err, RuntimeError) and "restart budget" in str(err)
    assert rt.restarts == 3


def test_budget_resets_on_durable_progress(tmp_path):
    seen = set()

    def inject(step):
        if step % 3 == 2 and step not in seen:
            seen.add(step)
            raise RuntimeError(f"transient at {step}")

    rt, out = _fit(tmp_path, inject, iterations=18,
                   policy=FailurePolicy(max_restarts=3))
    assert out["step"] == 18 and out["restarts"] == 6 and rt.restarts == 0
    assert len(rt.rollback_s) == 6


class _Fatal(BaseException):
    pass


@pytest.mark.parametrize("exc,policy", [
    (_Fatal("not recoverable"), None),
    (ValueError("shape bug: expected (8, 16), got (8, 17)"), None),
    (RuntimeError("world lost"), FailurePolicy(fatal=lambda e: True)),
])
def test_unrecoverable_failures_surface_at_once(tmp_path, exc, policy):
    def inject(step):
        raise exc

    kw = {"policy": policy} if policy else {}
    rt, err = _fit(tmp_path, inject, **kw)
    assert err is exc and rt.restarts == 0 and rt.total_restarts == 0


def test_real_shape_bug_surfaces_immediately(tmp_path):
    def bad_batch(step):
        b = chaos.chaos_batch_fn(step)
        b["x"] = np.zeros((8, 17), np.float32)
        return b

    with CheckpointManager(str(tmp_path)) as ck:
        rt = ResilientTrainer(chaos.tiny_factory("cpu"), ck)
        with pytest.raises(ValueError):
            rt.fit(iterations=4, batch_fn=bad_batch)
    assert rt.restarts == 0


def test_nonfinite_detection_and_injector_modes(tmp_path):
    inj = FaultInjector(nan_loss_at=[2])
    assert FaultInjector.wrap(inj) is inj
    assert FaultInjector.wrap(None).fired == []
    batch = {"x": np.ones((2, 2), np.float32), "label": np.ones(2, np.int32)}
    out = FaultInjector(nan_batch_at=[1]).poison_batch(1, batch)
    assert np.isnan(out["x"]).all() and (out["label"] == 1).all()
    assert issubclass(StepFailure, RuntimeError)
    rt, res = _fit(tmp_path, inj, iterations=6)
    assert res["restarts"] == 1 and inj.fired == [("nan_loss", 2)]
    with pytest.raises(NotImplementedError, match="item 12"):
        ResilientTrainer(chaos.tiny_factory("cpu"), None).fit(
            2, chaos.chaos_batch_fn, loader=object())


def test_per_step_fence_is_amortized(monkeypatch, tmp_path):
    from flexflow_torch.runtime import telemetry

    seen = []
    real = telemetry.host_fence
    monkeypatch.setattr(telemetry, "host_fence",
                        lambda v: seen.append(len(v)) or real(v))
    with CheckpointManager(str(tmp_path)) as ck:
        ResilientTrainer(chaos.tiny_factory("cpu"), ck).fit(
            10, chaos.chaos_batch_fn, save_every=4)
    assert seen == [4, 4, 2]  # one readback per check, not per step


# -- Trainer.fit's preemption, the apps ----------------------------------------


def test_trainer_fit_saves_and_stops_on_sigterm(tmp_path):
    ex = chaos.tiny_factory("cpu")()
    step = ex.train_step
    calls = []

    def train_step(*a):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a)

    ex.train_step = train_step
    with CheckpointManager(str(tmp_path)) as ck:
        stats = Trainer(ex).fit(iterations=10, warmup=1, checkpoint=ck)
        assert stats["preempted"] and stats["checkpoint_step"] == 3
        assert ck.all_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


_LM = ["-b", "2", "--seq", "16", "--layers", "2", "--vocab", "64",
       "--d-model", "32", "--heads", "2", "--optimizer", "adam", "--lr",
       "1e-2", "--seed", "3"]


@pytest.mark.parametrize("k", [1, 2])
def test_transformer_app_resilient_with_telemetry(tmp_path, capsys, k):
    ck, tel = str(tmp_path / "ck"), str(tmp_path / "tel")
    argv = _LM + ["-i", "4", "--resilient", "--save-every", "2",
                  "--ckpt-dir", ck, "--telemetry", tel, "--sync-ckpt",
                  "--steps-per-call", str(k)]
    stats = {}
    assert ttransformer.main(argv, device="cpu", stats_out=stats) == 0
    out = capsys.readouterr().out
    assert "restarts = 0" in out and "THROUGHPUT" in out
    assert stats["steps_this_run"] == 4 and stats["iterations"] == 4
    losses = stats["step_losses"]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert sorted(int(s) for s in os.listdir(ck)) == [2, 4]
    run = glob.glob(os.path.join(tel, "run-*.jsonl"))
    events = [json.loads(ln) for ln in open(run[0])]
    assert events[-1]["exit"] == "clean" and \
        events[-1]["summary"]["steps"] == 4
    assert [e["ev"] for e in events].count("ckpt_save") == 2
    # A rerun on the same directory has nothing left to do.
    assert ttransformer.main(argv, device="cpu", stats_out=stats) == 0
    assert "already complete" in capsys.readouterr().out


def test_plain_app_checkpoints_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = _LM + ["-i", "2", "--save-every", "2", "--ckpt-dir", ck]
    assert ttransformer.main(argv, device="cpu") == 0
    assert ttransformer.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert CheckpointManager(ck).all_steps() == [3, 6]


@pytest.mark.parametrize("flags,item", [
    (["--elastic"], "item 13"), (["--stream-dataset"], "item 12"),
    (["--resilient", "--accum-steps", "2"], "--accum-steps"),
])
def test_what_stays_refused_names_its_item(flags, item):
    with pytest.raises(SystemExit, match=item):
        ttransformer.main(_LM + ["-i", "2"] + flags, device="cpu")


def test_candle_app_runs_resilient(tmp_path):
    argv = ["-b", "8", "--dense-layers", "32-32", "--dense-feature-layers",
            "16", "--optimizer", "sgd", "--lr", "0.01", "--momentum", "0",
            "--wd", "0", "-i", "2", "--resilient", "--save-every", "1",
            "--ckpt-dir", str(tmp_path)]
    stats = {}
    assert tcandle.main(argv, device="cpu", stats_out=stats) == 0
    assert stats["restarts"] == 0 and len(stats["step_losses"]) == 2


def _op_state_factory():
    """A net whose op state advances every step: Dropout's threefry key
    and BatchNorm's running statistics."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel
    from flexflow_torch.optim import AdamOptimizer
    from flexflow_torch.runtime.executor import Executor

    def make():
        import torch

        ff = FFModel(FFConfig(batch_size=4, seed=0))
        x = ff.create_tensor((4, 6, 6, 3), name="image")
        label = ff.create_tensor((4,), dtype=torch.int32, name="label")
        t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation=None, name="conv")
        t = ff.batch_norm(t, relu=True, name="bn")
        t = ff.flat(t, name="flat")
        t = ff.dropout(t, 0.3, name="drop")
        t = ff.dense(t, 10, name="linear_out")
        ff.softmax(t, label, name="softmax")
        return Executor(ff, optimizer=AdamOptimizer(lr=1e-3), device="cpu")

    return make


def _op_state_batch(step):
    rng = np.random.default_rng(step)
    return {"image": rng.standard_normal((4, 6, 6, 3)).astype(np.float32),
            "label": rng.integers(0, 10, size=4).astype(np.int32)}


@pytest.mark.parametrize("k", [1, 4])
def test_replay_restores_op_state_bit_for_bit(tmp_path, k):
    """A NaN batch writes NaNs into BatchNorm's running statistics and
    Adam's state in place; the rollback restores them, and Dropout's key,
    into the same tensors, and the replay equals the unfaulted run."""
    runs = []
    for tag, inj in (("clean", None),
                     ("faulted", FaultInjector(nan_batch_at=(5,)))):
        with CheckpointManager(str(tmp_path / tag)) as ck:
            runs.append(ResilientTrainer(_op_state_factory(), ck,
                                         fault_injector=inj).fit(
                8, _op_state_batch, save_every=4, steps_per_call=k))
    clean, faulted = runs
    assert faulted["restarts"] == 1 and faulted["losses"] == clean["losses"]
    from flexflow_torch.runtime.checkpoint import flatten

    for key in ("params", "opt_state", "state"):
        a, b = flatten(clean[key]), flatten(faulted[key])
        assert sorted(a) == sorted(b)
        assert all(a[n].dtype == b[n].dtype and torch_equal(a[n], b[n])
                   for n in a), key
    assert any(n.startswith("drop/") for n in flatten(clean["state"]))


def torch_equal(a, b):
    import torch

    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))
