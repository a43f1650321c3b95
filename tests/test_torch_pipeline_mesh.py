"""The layer-wise pipeline on a world of four gloo ranks, held against the
JAX package's ``PipelineExecutor`` on ``jax.devices()[:4]`` and against
the port's one ``Executor`` (``tests/test_pipeline.py``'s cases).

One world (``flexflow_torch.tools.mesh_pipeline:world_cases``) runs
every case of the module; JAX's initial per-stage parameters cross over
through numpy (``weights.pipeline_params_from_numpy``) and the batches
are drawn with numpy.  The bars are JAX's own
(``tests/test_pipeline.py:140-152``): losses within ``rtol=1e-5``,
parameters within ``rtol=2e-4, atol=2e-5``.

- The two-stage MLP (enc on ranks {0, 1}, dec on {2, 3}, n = 2 each) at
  m = 1, 2 and 4 under 1f1b and at m = 4 under gpipe, with momentum SGD:
  against JAX's pipeline and the one Executor; gpipe and 1f1b bit for
  bit; the event list is the schedule's.
- ``--clip-norm`` (the global norm over both stages) at m = 2, against
  JAX's.
- A skip connection (stage 0's output read by stages 1 and 2): the
  cotangents summed on the producer, against JAX's and the one Executor.
- Intra-stage tensor parallelism (``dec0`` at c = 2 on {2, 3}), against
  JAX's.
- A table leaving rank 3 in no stage (dec on {2}): rank 3 walks the
  schedule, and the step is the one Executor's.
- The README's AlexNet table at batch 12, image 67, 10 classes (six
  stages, ``[0, 2, 1, 3]`` among them), two steps: losses against JAX's.
- The apps on the world's ranks: ``apps.alexnet -s
  strategies/alexnet_readme_4dev.json --microbatches 4`` under 1f1b and
  gpipe (bit for bit), ``apps.nmt --pipeline`` at ``--microbatches 2``
  with ``--pipeline-schedule gpipe`` (run telemetry's programs a step:
  the event list's 2 x S x m), ``--steps-per-call 2`` (the
  amortized superstep: the steps' losses bit for bit) and
  ``--accum-steps 2`` (lowered into four microbatches, bit for bit
  ``--microbatches 4``, with ``--eval-iters 1``); ``--resilient`` at one
  step a call and refused at ``--steps-per-call 2``, the trainer's
  accumulation refusals and ``--profiling``'s line, in JAX's words.
- ``eval_step`` against the one Executor's; planted faults (the loss
  seeded with 1 instead of ``1/m``; a skip connection's second
  cotangent dropped) break JAX's bars.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_torch.optim import SGDOptimizer
from flexflow_torch.parallel import launch
from flexflow_torch.runtime.executor import Executor
from flexflow_torch.tools import mesh_pipeline as mp
from flexflow_torch.weights import params_from_numpy
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.alexnet import build_alexnet as jalexnet
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime.pipeline import PipelineExecutor as JPipe

RUN = "flexflow_torch.tools.mesh_pipeline:world_cases"
RANKS = 4
WORLD_S = 300
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
SGD = ("sgd", {"lr": 0.1, "momentum": 0.9})
README = "strategies/alexnet_readme_4dev.json"

ENC, DEC = [0, 1], [2, 3]
TWO = {**{n: {"n": 2, "device_ids": ENC} for n in ("enc0", "enc1")},
       **{n: {"n": 2, "device_ids": DEC} for n in ("dec0", "dec1",
                                                    "softmax")}}
TP = {**TWO, "dec0": {"c": 2, "device_ids": DEC}}
IDLE = {**{n: {"n": 2, "device_ids": ENC} for n in ("enc0", "enc1")},
        **{n: {"device_ids": [2]} for n in ("dec0", "dec1", "softmax")}}
SKIP = {"s0": {"n": 2, "device_ids": [0, 1]},
        "s1": {"n": 2, "device_ids": [2, 3]},
        **{n: {"n": 2, "device_ids": [1, 3]} for n in ("s2cat", "s2fc",
                                                       "softmax")}}
APP_ALEX = ["-ll:gpu", "4", "-s", README, "--microbatches", "4", "-b", "16",
            "--image-size", "67", "-i", "2", "--optimizer", "sgd", "--lr",
            "0.01"]
APP_NMT = ["--pipeline", "-ll:gpu", "4", "-b", "8", "--src-len", "6",
           "--tgt-len", "6", "--hidden", "32", "--vocab", "128",
           "--optimizer", "sgd", "--lr", "0.5", "--momentum", "0", "--wd",
           "0", "-i", "4"]


def _readme():
    with open(README) as f:
        return json.load(f)["ops"]


def _mlp_batches(n=2, batch=8, din=12, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((batch, din)).astype(np.float32),
             "label": rng.integers(0, classes, (batch,)).astype(np.int32)}
            for _ in range(n)]


def _alex_batches(n=2):
    rng = np.random.default_rng(3)
    return [{"image": rng.standard_normal((12, 67, 67, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (12,)).astype(np.int32)}
            for _ in range(n)]


# -- JAX's side ---------------------------------------------------------------


def _jax_two_stage(batch=8, din=12, dh=16, classes=4):
    ff = JModel(JConfig(batch_size=batch))
    x = ff.create_tensor((batch, din), name="x")
    lbl = ff.create_tensor((batch,), dtype=jnp.int32, name="label")
    t = ff.dense(x, dh, activation="relu", name="enc0")
    t = ff.dense(t, dh, activation="relu", name="enc1")
    t = ff.dense(t, dh, activation="relu", name="dec0")
    t = ff.dense(t, classes, activation=None, name="dec1")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _jax_skip(batch=8, din=12, classes=4):
    ff = JModel(JConfig(batch_size=batch))
    x = ff.create_tensor((batch, din), name="x")
    lbl = ff.create_tensor((batch,), dtype=jnp.int32, name="label")
    t0 = ff.dense(x, 8, activation="relu", name="s0")
    t1 = ff.dense(t0, 8, activation="relu", name="s1")
    t2 = ff.concat([t0, t1], axis=1, name="s2cat")
    t3 = ff.dense(t2, classes, activation=None, name="s2fc")
    ff.softmax(t3, lbl, name="softmax")
    return ff


def _jax_run(ff, table, batches, m=1, schedule="1f1b", clip=0.0,
             momentum=0.9, lr=0.1):
    """JAX's pipeline on four devices: its initial per-stage params, the
    losses and the final params (one tree)."""
    store = JStore(RANKS)
    for k, v in table.items():
        store.set(k, JPC.from_json(v))
    cfg = ff.config
    cfg.clip_norm = clip
    pipe = JPipe(ff, store, config=cfg,
                 optimizer=JSGD(lr=lr, momentum=momentum),
                 microbatches=m, schedule=schedule,
                 devices=jax.devices()[:RANKS])
    pp, po, ps = pipe.init(seed=0)
    p0 = jax.device_get(pp)
    losses = []
    for b in batches:
        pp, po, ps, met = pipe.train_step(pp, po, ps, pipe.shard_batch(b))
        losses.append(float(jax.device_get(met["train_loss"])))
    final = {op: g for tree in jax.device_get(pp).values()
             for op, g in tree.items()}
    return dict(p0=p0, losses=losses, params=final)


@pytest.fixture(scope="module")
def jax_runs():
    b = _mlp_batches()
    return {
        "m1": _jax_run(_jax_two_stage(), TWO, b, m=1),
        "m2": _jax_run(_jax_two_stage(), TWO, b, m=2),
        "m4": _jax_run(_jax_two_stage(), TWO, b, m=4),
        "clip": _jax_run(_jax_two_stage(), TWO, b, m=2, clip=0.5),
        "skip": _jax_run(_jax_skip(), SKIP, b, momentum=0.0),
        "tp": _jax_run(_jax_two_stage(), TP, b),
        "readme": _jax_run(jalexnet(batch_size=12, image_size=67,
                                    num_classes=10), _readme(),
                           _alex_batches(), momentum=0.0, lr=0.01),
    }


# -- the port's world ---------------------------------------------------------


def _case(name, model, table, p0, batches, **kw):
    return dict(name=name, model=model, table=table, params=p0,
                batches=batches, optimizer=kw.pop("optimizer", SGD), **kw)


@pytest.fixture(scope="module")
def world(jax_runs, tmp_path_factory):
    b = _mlp_batches()
    j = jax_runs
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    tel = str(tmp_path_factory.mktemp("tel"))
    cases = [
        _case("m1", "two_stage", TWO, j["m1"]["p0"], b),
        _case("m2", "two_stage", TWO, j["m2"]["p0"], b, microbatches=2,
              eval=b[0]),
        _case("m2_seed_one", "two_stage", TWO, j["m2"]["p0"], b,
              microbatches=2, fault="seed_one"),
        _case("skip_drop_sum", "skip", SKIP, j["skip"]["p0"], b,
              optimizer=("sgd", {"lr": 0.1}), fault="drop_skip_sum"),
        _case("m4", "two_stage", TWO, j["m4"]["p0"], b, microbatches=4),
        _case("m4_gpipe", "two_stage", TWO, j["m4"]["p0"], b,
              microbatches=4, schedule="gpipe"),
        _case("clip", "two_stage", TWO, j["clip"]["p0"], b, microbatches=2,
              config={"clip_norm": 0.5}),
        _case("skip", "skip", SKIP, j["skip"]["p0"], b,
              optimizer=("sgd", {"lr": 0.1})),
        _case("tp", "two_stage", TP, j["tp"]["p0"], b),
        _case("idle", "two_stage", IDLE, j["m1"]["p0"], b, microbatches=2),
        _case("readme", "alexnet", _readme(), j["readme"]["p0"],
              _alex_batches(), optimizer=("sgd", {"lr": 0.01})),
        dict(name="app_alex", app="alexnet", argv=APP_ALEX),
        dict(name="app_alex_gpipe", app="alexnet",
             argv=APP_ALEX + ["--pipeline-schedule", "gpipe"]),
        dict(name="app_nmt", app="nmt", argv=APP_NMT + [
            "--microbatches", "2", "--pipeline-schedule", "gpipe",
            "--telemetry", tel]),
        dict(name="app_nmt_k2", app="nmt", argv=APP_NMT + [
            "--microbatches", "2", "--pipeline-schedule", "gpipe",
            "--steps-per-call", "2"]),
        dict(name="app_nmt_m4", app="nmt", argv=APP_NMT + [
            "--microbatches", "4", "--eval-iters", "1"]),
        dict(name="app_nmt_accum", app="nmt", argv=APP_NMT + [
            "--microbatches", "2", "--accum-steps", "2"]),
        dict(name="app_nmt_resilient", app="nmt", argv=APP_NMT + [
            "--microbatches", "2", "--resilient", "--save-every", "2",
            "--ckpt-dir", ckpt]),
        dict(name="app_nmt_resilient_k2", app="nmt", argv=APP_NMT + [
            "--resilient", "--steps-per-call", "2", "--ckpt-dir", ckpt]),
        dict(name="app_nmt_profiling", app="nmt", argv=APP_NMT + [
            "--profiling"]),
        _case("refusals", "two_stage", TWO, j["m1"]["p0"], [],
              refusals=True),
    ]
    ranks = launch.run(RUN, (cases,), nprocs=RANKS, device="cpu",
                       timeout_s=WORLD_S)
    return [{c["name"]: r for c, r in zip(cases, rank)} for rank in ranks]


def _one_executor(model, p0, batches, momentum=0.9, lr=0.1, **cfg):
    """The port's one Executor from the same parameters (JAX's per-stage
    tree merged)."""
    ff = mp.MODELS[model]()
    for k, v in cfg.items():
        setattr(ff.config, k, v)
    ex = Executor(ff, optimizer=SGDOptimizer(lr=lr, momentum=momentum),
                  device="cpu")
    params = params_from_numpy({op: g for t in p0.values()
                                for op, g in t.items()}, "cpu")
    opt_state, state = ex.optimizer.init(params), {}
    losses = []
    for b in batches:
        params, opt_state, state, m = ex.train_step(params, opt_state, state,
                                                    ex.shard_batch(b))
        losses.append(float(m["train_loss"]))
    return dict(losses=losses, params={op: {k: v.detach().numpy()
                                            for k, v in g.items()}
                                       for op, g in params.items()})


def _close(got, want, loss_rtol=LOSS_RTOL):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=loss_rtol)
    for op, g in want["params"].items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       err_msg=f"{op}.{k}", **PARAM_TOL)


def _same(a, b):
    assert a["losses"] == b["losses"]
    assert a["params"].keys() == b["params"].keys()
    for op, g in a["params"].items():
        for k, v in g.items():
            np.testing.assert_array_equal(v, b["params"][op][k],
                                          err_msg=f"{op}.{k}")


@pytest.mark.parametrize("case", ["m1", "m2", "m4", "clip", "skip", "tp"])
def test_pipeline_matches_jax(world, jax_runs, case):
    for rank in world:
        assert not rank[case]["jax_imported"]
    _close(world[0][case], jax_runs[case])


@pytest.mark.parametrize("case", ["m1", "m2", "m4", "skip", "idle"])
def test_pipeline_matches_one_executor(world, jax_runs, case):
    p0 = jax_runs["skip" if case == "skip" else "m1" if case == "idle"
                  else case]["p0"]
    want = _one_executor("skip" if case == "skip" else "two_stage", p0,
                         _mlp_batches(),
                         momentum=0.0 if case == "skip" else 0.9)
    _close(world[0][case], want)
    # Every rank reads the last stage's losses, the idle one included.
    for rank in world:
        assert rank[case]["losses"] == world[0][case]["losses"]


def test_gpipe_is_1f1b_bit_for_bit(world):
    for rank in world:
        _same(rank["m4_gpipe"], rank["m4"])
    assert world[0]["m4"]["schedule"] != world[0]["m4_gpipe"]["schedule"]
    from flexflow_torch.runtime.pipeline import build_schedule

    assert world[1]["m4"]["schedule"] == build_schedule("1f1b", 2, 4)


def test_idle_rank_is_in_no_stage(world):
    assert world[3]["idle"]["mine"] == []
    assert world[2]["idle"]["stages"] == [[0, 1], [2]]


def test_readme_alexnet_table_matches_jax(world, jax_runs):
    got = world[0]["readme"]
    assert got["stages"] == [[0, 1, 2, 3], [0, 2, 1, 3], [0, 2], [0, 2, 3],
                             [0, 1, 2], [0]]
    assert world[1]["readme"]["mine"] == [0, 1, 4]
    np.testing.assert_allclose(got["losses"], jax_runs["readme"]["losses"],
                               rtol=LOSS_RTOL)


def test_apps_train_on_the_pipeline(world):
    for name in ("app_alex", "app_alex_gpipe", "app_nmt", "app_nmt_k2",
                 "app_nmt_m4", "app_nmt_accum"):
        for rank in world:
            got = rank[name]
            assert got["code"] == 0 and got["kind"] == "PipelineExecutor", \
                name
            assert all(np.isfinite(got["losses"])), name
            assert got["losses"] == world[0][name]["losses"], name
        assert world[0][name]["losses"][-1] < world[0][name]["losses"][0]
    _same(world[0]["app_alex_gpipe"], world[0]["app_alex"])
    # The amortized superstep is the steps; accumulation is microbatching.
    _same(world[0]["app_nmt_k2"], world[0]["app_nmt"])
    _same(world[0]["app_nmt_accum"], world[0]["app_nmt_m4"])
    assert len(world[0]["app_alex"]["schedule"]) == 2 * 6 * 4
    # Run telemetry counts the step's event list: 2 x S x m programs.
    for rank in world:
        assert rank["app_nmt"]["telemetry"]["programs_per_step"] == 8.0


def test_resilient_and_refusals(world):
    """``--resilient`` trains at one step a call (its snapshots through
    the pipeline's layout); at K > 1, an ``accum_steps`` the executor did
    not lower and accumulation in the superstep loop are refused in
    JAX's words; ``--profiling`` prints JAX's line."""
    for rank in world:
        got = rank["app_nmt_resilient"]
        assert got["code"] == 0 and got["kind"] == "PipelineExecutor"
        assert got["losses"] == world[0]["app_nmt_resilient"]["losses"]
        assert "requires a fused superstep" in \
            rank["app_nmt_resilient_k2"]["code"]
        assert rank["app_nmt_profiling"]["code"] == 0
        ref = rank["refusals"]["refusals"]
        assert "must be lowered at construction" in ref["accum"]
        assert "pipeline strategies microbatch via microbatches=" in \
            ref["superstep_accum"]
    assert "per-op breakdown unavailable for pipeline executors" in \
        world[0]["app_nmt_profiling"]["report"]
    assert world[0]["app_nmt_resilient"]["losses"][-1] < \
        world[0]["app_nmt_resilient"]["losses"][0]


def test_eval_step_matches_one_executor(world, jax_runs):
    """``eval_step`` after the steps: the last stage's loss and metrics,
    the one Executor's (``--eval-iters`` through the app too)."""
    from flexflow_torch.weights import params_from_numpy

    ff = mp.two_stage()
    ex = Executor(ff, optimizer=SGDOptimizer(lr=0.1, momentum=0.9),
                  device="cpu")
    params = params_from_numpy(world[0]["m2"]["params"], "cpu")
    loss, mets = ex.eval_step(params, {}, ex.shard_batch(_mlp_batches()[0]))
    for rank in world:
        got = rank["m2"]["eval"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
        assert got["train_correct"] == float(mets["train_correct"])
    assert "EVAL loss = " in world[0]["app_nmt_m4"]["report"]


@pytest.mark.parametrize("fault,case,want", [
    ("seed_one", "m2_seed_one", "m2"), ("drop_skip_sum", "skip_drop_sum",
                                        "skip")])
def test_planted_faults_break_the_bars(world, jax_runs, fault, case, want):
    """The loss seeded with 1 instead of 1/m, and a skip connection's
    second cotangent dropped: each leaves JAX's parameters beyond the
    bars."""
    with pytest.raises(AssertionError):
        _close(world[0][case], jax_runs[want])
