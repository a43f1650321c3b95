"""The port's training machinery across a world of ranks, held against
the JAX package's runs of the same tables and against the port itself.

One world of four gloo ranks (``parallel/launch.py``: CPU ranks of one
thread) runs ``flexflow_torch.tools.mesh_train:world_cases`` once for the
module under ``WORLD_S``, so a decision one rank takes alone fails the
world instead of hanging it.  JAX runs each table on four devices of the
8-device CPU mesh ``tests/conftest.py`` forces; its initial parameters
cross over through numpy and the batches are drawn with numpy.

- Gradient accumulation: the two-layer LM of
  ``tests/test_torch_sharding.py`` (batch 4, seq 32, vocab 256, d 64, 4
  heads, Adam) at dp 2 and at dp 2 x tp 2 with ``accum_steps = 2``, step
  by step, as one k = 4 superstep and under ZeRO-1, against JAX's
  ``build_superstep(4, accum_steps=2)``: losses within ``LM_LOSS_RTOL``
  and every parameter within ``LM_PARAM_ATOL`` (that file's bars).
- ``--remat``: at dp 2 x tp 2, at dp 2 x sp 2 (ring attention: its
  shifts and ``anchor`` issued again in the recompute) and with four
  experts at dp 2 x tp 2 (the MoE's reduce-scatter and all-gathers
  again): losses and parameters bit for bit the plain step's under the
  same table, and at dp 2 x tp 2 within the bars of JAX's plain step.
- Supersteps: a k = 4 superstep bit for bit four k = 1 steps on every
  rank, for the LM at dp 2 x tp 2 and for a small DLRM under
  ``dlrm_strategy(4)`` (its row-sparse step, the tables at c = 4).
- Snapshots (the port's forms of JAX's
  ``tests/test_checkpoint.py:75`` and ``:305``): written by this process
  on one device, by ``apps.transformer -ll:gpu 2`` on a world of two,
  and on the world of four under dp 4, dp 2, tp 2, dp 2 x tp 2 and dp 2
  x tp 2 with ZeRO-1 (whose moments are split); each restored under
  every one of those tables, on one device, and on a world of two (a
  second spawn, after the first) under dp 2, tp 2 and dp 2 with ZeRO-1,
  and gathered whole again: every tensor bit for bit the file's.  dp
  restores under tp, ZeRO's moments with ZeRO off, and the reverse.
- SIGTERM to rank 1 alone (the chaos model at ``n2c2``, k = 4): every
  rank saves the same step and returns, and a second fit finishes with
  the unfaulted trajectory.
- The apps: ``apps.transformer -ll:gpu 2`` with ``--steps-per-call 2
  --accum-steps 2 --save-every 2 --telemetry DIR``, and with
  ``--resilient`` instead of ``--accum-steps`` (the JAX package refuses
  the two together, and so does the port), each writing two
  ``-p<rank>`` run files with equal losses; ``--remat``, ``--trace`` and
  ``--profiling`` under two ranks; ``apps.alexnet -ll:gpu 2 --remat``;
  ``apps.serve --ckpt-dir`` from the two-rank snapshot on one engine
  and under ``--shard 2,1 --telemetry``; and ``--accum-steps`` whose
  microbatch does not split over an op's ``n``, refused by name.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest

from flexflow_torch.apps import alexnet as talex
from flexflow_torch.apps import serve as tserve
from flexflow_torch.apps import transformer as tapp
from flexflow_torch.models.dlrm import DLRMConfig
from flexflow_torch.models.dlrm import dlrm_strategy as tdlrm_strategy
from flexflow_torch.models.transformer import transformer_strategy as tstrat
from flexflow_torch.parallel import launch
from flexflow_torch.tools import mesh_smoke, mesh_train
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jlm
from flexflow_tpu.models.transformer import transformer_strategy as jstrat
from flexflow_tpu.optim import AdamOptimizer as JAdam
from flexflow_tpu.runtime.executor import Executor as JExecutor

RUN = "flexflow_torch.tools.mesh_train:world_cases"
WORLD_S = 300
RANKS = 4
LR = 1e-3
LM_LOSS_RTOL = 1e-5
LM_PARAM_ATOL = 1e-2 * LR
LM_EPS = 1e-4
STEPS = 4
ACCUM = 2
LM = dict(batch_size=4, seq_len=32, vocab_size=256, d_model=64, num_heads=4,
          num_layers=2)
LM_FLAGS = ["-b", "4", "--seq", "32", "--layers", "2", "--vocab", "256",
            "--d-model", "64", "--heads", "4", "--optimizer", "adam",
            "--lr", "1e-3"]
ADAM = ("adam", {"lr": LR, "eps": LM_EPS})
#: The snapshot tables on the world of four: (name, dp, tp, ZeRO-1).
SNAP_TABLES = [("dp4", 4, 1, False), ("dp2", 2, 1, False),
               ("tp2", 1, 2, False), ("dp2tp2", 2, 2, False),
               ("zero", 2, 2, True)]
DLRM = dict(batch=8, tables=4, vocab=64, dim=8)


def _lm_batches():
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, LM["vocab_size"],
                             (LM["batch_size"], LM["seq_len"])).astype(np.int32)
             for k in ("tokens", "label")} for _ in range(STEPS)]


def _table(store):
    return {k: v.to_json() for k, v in store.table.items()}


# -- JAX's side ---------------------------------------------------------------


def _jax_lm(dp, tp, accum=1):
    """JAX's initial params and, over the four batches, its losses and
    final params: one k = 4 superstep (``accum_steps = accum``)."""
    ff = jlm(config=JConfig(batch_size=LM["batch_size"], seed=0), **LM)
    ex = JExecutor(ff, strategy=jstrat(RANKS, LM["num_layers"], dp=dp, tp=tp),
                   optimizer=JAdam(lr=LR, eps=LM_EPS),
                   devices=jax.devices()[:RANKS])
    params, opt_state, state = ex.init()
    p0 = jax.device_get(params)
    fn = ex.build_superstep(STEPS, accum_steps=accum)
    params, opt_state, state, ms = fn(params, opt_state, state,
                                      ex.stack_steps(_lm_batches(), accum))
    return dict(p0=p0, losses=[float(x) for x in
                               np.asarray(jax.device_get(ms["train_loss"]))],
                params=jax.device_get(params))


@pytest.fixture(scope="module")
def jax_runs():
    return {"accum_dp2": _jax_lm(2, 1, ACCUM),
            "accum_dp2tp2": _jax_lm(2, 2, ACCUM),
            "plain_dp2tp2": _jax_lm(2, 2)}


# -- the port's world ---------------------------------------------------------


def _lm_case(name, p0, dp=1, tp=1, sp=1, ranks=RANKS, **extra):
    return dict(name=name, model="lm", model_kw=extra.pop("model_kw", LM),
                table=_table(tstrat(ranks, LM["num_layers"], dp=dp, sp=sp,
                                    tp=tp, moe=extra.pop("moe", False))),
                optimizer=ADAM, batches=_lm_batches(), params=p0, **extra)


def _dlrm_batches():
    from flexflow_torch.data.loader import synthetic_host_batch

    ff = mesh_smoke.dlrm(**DLRM)
    highs = {t.name: DLRM["vocab"] for t in ff.input_tensors
             if not t.dtype.is_floating_point and t.name != "label"}
    rng = np.random.default_rng(5)
    return [synthetic_host_batch(ff, rng, highs) for _ in range(STEPS)]


def _dlrm_cases():
    cfg = DLRMConfig(sparse_feature_size=DLRM["dim"],
                     embedding_size=[DLRM["vocab"]] * DLRM["tables"])
    table = _table(tdlrm_strategy(RANKS, cfg))
    p0 = mesh_smoke._numpy(mesh_smoke.executor_for(
        dict(model="dlrm", model_kw=DLRM))[1].init()[0])
    base = dict(model="dlrm", model_kw=DLRM, table=table,
                optimizer=("sgd", {"lr": 0.1, "momentum": 0.0}),
                batches=_dlrm_batches(), params=p0)
    return table, [dict(base, name="dlrm_k1"),
                   dict(base, name="dlrm_k4", superstep=STEPS)]


def _snap_case(name, p0, dp, tp, zero, ranks=RANKS):
    case = _lm_case(name, p0, dp=dp, tp=tp, ranks=ranks)
    case["batches"] = case["batches"][:1]
    if zero:
        case["config"] = {"zero_sharded_optimizer": True}
    return case


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """The two-rank app runs (their snapshot is one of the world's) and
    the one-device snapshot of this process."""
    root = tmp_path_factory.mktemp("apps")
    out = {"root": str(root)}
    for name, extra in (("accum", ["--accum-steps", "2"]),
                        ("resilient", ["--resilient"])):
        d, tel = str(root / f"ck_{name}"), str(root / f"tel_{name}")
        st = {}
        rc = tapp.main(LM_FLAGS + ["-ll:gpu", "2", "--dp", "2", "-i", "4",
                                   "--steps-per-call", "2", "--save-every",
                                   "2", "--ckpt-dir", d, "--telemetry", tel]
                       + extra, device="cpu", stats_out=st)
        out[name] = dict(rc=rc, stats=st, ckpt=d, tel=tel)
    return out


@pytest.fixture(scope="module")
def one_device(tmp_path_factory, jax_runs):
    """A snapshot written on one device (no world) of the dp 2 x tp 2
    reader's model, and the executor case that wrote it."""
    root = tmp_path_factory.mktemp("one")
    case = _snap_case("one", jax_runs["plain_dp2tp2"]["p0"], 1, 1, False)
    case["table"] = {}
    from flexflow_torch.runtime.checkpoint import CheckpointManager

    ex, params, opt_state, state = mesh_train._trained(case)
    with CheckpointManager(str(root)) as ck:
        ck.save(1, params, opt_state, state)
    return dict(dir=str(root), case=case)


@pytest.fixture(scope="module")
def world(jax_runs, apps, one_device, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("world"))
    p0 = jax_runs["plain_dp2tp2"]["p0"]
    moe_kw = dict(LM, moe_experts=4)
    moe_p0 = mesh_smoke._numpy(mesh_smoke.executor_for(
        dict(model="lm", model_kw=moe_kw))[1].init()[0])
    _, dlrm = _dlrm_cases()
    cases = [
        _lm_case("accum_dp2", jax_runs["accum_dp2"]["p0"], dp=2, accum=ACCUM),
        _lm_case("accum_dp2tp2", p0, dp=2, tp=2, accum=ACCUM),
        _lm_case("accum_dp2tp2_k4", p0, dp=2, tp=2, accum=ACCUM,
                 superstep=STEPS),
        _lm_case("accum_zero", p0, dp=2, tp=2, accum=ACCUM,
                 config={"zero_sharded_optimizer": True}),
        _lm_case("plain_dp2tp2", p0, dp=2, tp=2),
        _lm_case("superstep_dp2tp2", p0, dp=2, tp=2, superstep=STEPS),
        _lm_case("remat_dp2tp2", p0, dp=2, tp=2, config={"remat": True}),
        _lm_case("plain_dp2sp2", p0, dp=2, sp=2),
        _lm_case("remat_dp2sp2", p0, dp=2, sp=2, config={"remat": True}),
        _lm_case("plain_moe", moe_p0, dp=2, tp=2, moe=True,
                 model_kw=moe_kw),
        _lm_case("remat_moe", moe_p0, dp=2, tp=2, moe=True,
                 model_kw=moe_kw, config={"remat": True}),
    ] + dlrm
    for c in cases:
        c["batches"] = c["batches"][:2] if c["name"].endswith(
            ("sp2", "moe")) else c["batches"]
    tables = [_snap_case(n, p0, dp, tp, z) for n, dp, tp, z in SNAP_TABLES]
    spec = dict(cases=cases, snapshots=dict(
        root=os.path.join(root, "snap"), writers=tables, readers=tables,
        others={"one": one_device["dir"], "app2": apps["accum"]["ckpt"]}),
        sigterm=dict(root=os.path.join(root, "chaos"), k=4))
    return launch.run(RUN, (spec,), nprocs=RANKS, device="cpu",
                      timeout_s=WORLD_S)


#: The snapshot tables on a world of two: (name, dp, tp, ZeRO-1).
SNAP_TABLES_2 = [("two_dp2", 2, 1, False), ("two_tp2", 1, 2, False),
                 ("two_zero", 2, 1, True)]


@pytest.fixture(scope="module")
def world2(world, jax_runs, apps, one_device):
    """A world of two restoring every snapshot: this process's, the
    two-rank app's and the world of four's under each of its tables."""
    p0 = jax_runs["plain_dp2tp2"]["p0"]
    root = world[0]["snapshots"]["root"]
    others = {"one": one_device["dir"], "app2": apps["accum"]["ckpt"],
              **{name: os.path.join(root, name) for name, *_ in SNAP_TABLES}}
    readers = [_snap_case(n, p0, dp, tp, z, ranks=2)
               for n, dp, tp, z in SNAP_TABLES_2]
    spec = dict(snapshots=dict(root=os.path.join(root, "two"), writers=[],
                               readers=readers, others=others))
    return launch.run(RUN, (spec,), nprocs=2, device="cpu",
                      timeout_s=WORLD_S)


def _close_lm(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LM_LOSS_RTOL)
    for op, g in want["params"].items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       rtol=0, atol=LM_PARAM_ATOL,
                                       err_msg=f"{op}.{k}")


def _same(a, b):
    assert a["losses"] == b["losses"]
    for op, g in a["params"].items():
        for k, v in g.items():
            np.testing.assert_array_equal(v, b["params"][op][k],
                                          err_msg=f"{op}.{k}")


@pytest.mark.parametrize("case,want", [
    ("accum_dp2", "accum_dp2"), ("accum_dp2tp2", "accum_dp2tp2"),
    ("accum_dp2tp2_k4", "accum_dp2tp2"), ("accum_zero", "accum_dp2tp2")])
def test_accumulation_matches_jax(world, jax_runs, case, want):
    for rank in world:
        assert not rank[case]["jax_imported"]
        _close_lm(rank[case], jax_runs[want])


def test_accumulated_superstep_is_the_steps(world):
    for rank in world:
        _same(rank["accum_dp2tp2_k4"], rank["accum_dp2tp2"])
        assert rank["accum_dp2tp2_k4"]["superstep_graph"] is False


@pytest.mark.parametrize("table", ["dp2tp2", "dp2sp2", "moe"])
def test_remat_is_the_plain_step_bit_for_bit(world, table):
    for rank in world:
        _same(rank[f"remat_{table}"], rank[f"plain_{table}"])
    _same(world[0][f"remat_{table}"], world[3][f"remat_{table}"])


def test_remat_matches_jax(world, jax_runs):
    for rank in world:
        _close_lm(rank["remat_dp2tp2"], jax_runs["plain_dp2tp2"])


@pytest.mark.parametrize("model", ["dp2tp2", "dlrm"])
def test_superstep_is_four_steps_bit_for_bit(world, model):
    a, b = (("superstep_dp2tp2", "plain_dp2tp2") if model == "dp2tp2"
            else ("dlrm_k4", "dlrm_k1"))
    for rank in world:
        _same(rank[a], rank[b])
        assert len(rank[a]["losses"]) == STEPS
    if model == "dlrm":  # the tables split four ways, one block a rank
        table = world[0]["dlrm_k1"]["local_shapes"]["embeddings"]["tables"]
        assert table[0] == DLRM["tables"] // RANKS


def test_snapshots_restore_across_ranks_and_strategies(world, apps,
                                                       one_device):
    snaps = world[0]["snapshots"]
    files = {name: mesh_train.file_digest(os.path.join(
        world_root(world), name)) for name in snaps["saved"]}
    files["one"] = mesh_train.file_digest(one_device["dir"])
    files["app2"] = mesh_train.file_digest(apps["accum"]["ckpt"])
    for name, digest in snaps["saved"].items():
        assert digest == files[name], name  # saved what it gathered
    for rank in world:
        got = rank["snapshots"]["restored"]
        assert len(got) == len(files) * len(SNAP_TABLES)
        for key, digest in got.items():
            assert digest == files[key.split(">")[0]], key
    # ZeRO's moments are split (a quarter of lm_head's rows), restored
    # from snapshots written without it and into tables without it.
    shapes = snaps["local_shapes"]
    assert shapes["zero"] == (LM["vocab_size"] // 4, LM["d_model"])
    assert shapes["dp2tp2"] == (LM["vocab_size"] // 2, LM["d_model"])


def world_root(world):
    return world[0]["snapshots"]["root"]


def test_snapshots_restore_on_two_ranks(world, world2, apps, one_device):
    files = {name: mesh_train.file_digest(os.path.join(world_root(world),
                                                       name))
             for name, *_ in SNAP_TABLES}
    files["one"] = mesh_train.file_digest(one_device["dir"])
    files["app2"] = mesh_train.file_digest(apps["accum"]["ckpt"])
    for rank in world2:
        got = rank["snapshots"]["restored"]
        assert len(got) == len(files) * len(SNAP_TABLES_2)
        for key, digest in got.items():
            assert digest == files[key.split(">")[0]], key
    shapes = world2[0]["snapshots"]["local_shapes"]
    assert shapes["two_zero"] == (LM["vocab_size"] // 2, LM["d_model"])
    assert shapes["two_dp2"] == (LM["vocab_size"], LM["d_model"])


def test_snapshots_restore_on_one_device(world, apps, one_device):
    from flexflow_torch.runtime.checkpoint import CheckpointManager

    case = one_device["case"]
    for name in list(world[0]["snapshots"]["saved"]) + ["app2"]:
        d = apps["accum"]["ckpt"] if name == "app2" else os.path.join(
            world_root(world), name)
        _, ex = mesh_smoke.executor_for(case)
        with CheckpointManager(d, read_only=True) as ck:
            trees = ck.restore(templates=ex.init())[1:]
            assert mesh_train.snapshot_digest(ck._whole(*trees)) == \
                mesh_train.file_digest(d), name


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(world):
    got = [rank["sigterm"] for rank in world]
    # The signal lands while steps 0-3 run (steps 4-7's host side is
    # prepared meanwhile): every rank stops at the boundary after them.
    for g in got:
        assert g["preempted"] and g["first_step"] == 4
        assert not g["second_preempted"] and g["second_step"] == 16
        assert g["equal"], g["trajectory"]
    assert all(g["trajectory"] == got[0]["trajectory"] for g in got)


# -- the apps -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["accum", "resilient"])
def test_app_under_two_ranks_writes_a_run_a_rank(apps, name):
    run = apps[name]
    assert run["rc"] == 0
    losses = run["stats"]["step_losses"]
    assert np.isfinite(losses).all() and len(losses) >= 4
    files = sorted(glob.glob(os.path.join(run["tel"], "run-*-p*.jsonl")))
    assert [f[-9:] for f in files] == ["-p0.jsonl", "-p1.jsonl"]
    per_rank = []
    for f in files:
        events = [json.loads(ln) for ln in open(f)]
        assert events[-1]["exit"] == "clean"
        per_rank.append([e["loss"] for e in events
                         if e["ev"] == "step" and "loss" in e])
    assert per_rank[0] and per_rank[0] == per_rank[1]
    assert sorted(int(s) for s in os.listdir(run["ckpt"]))[-1] >= 4


def test_app_remat_trace_profiling_under_two_ranks(tmp_path, capfd):
    tr = str(tmp_path / "trace")
    assert tapp.main(LM_FLAGS + ["-ll:gpu", "2", "--tp", "2", "-i", "2",
                                 "--remat", "--trace", tr, "--profiling"],
                     device="cpu") == 0
    out = capfd.readouterr().out
    assert out.count("TOTAL (unfused sum)") == 1  # rank 0's table
    names = sorted(os.listdir(tr))
    assert len(names) == 2 and "-p0." in names[0] and "-p1." in names[1]
    assert talex.main(["-b", "2", "--image-size", "67", "-i", "1",
                       "-ll:gpu", "2", "--remat"], device="cpu") == 0


def test_app_refuses_microbatches_that_do_not_split():
    with pytest.raises(SystemExit, match="--accum-steps 4.*n = 2"):
        tapp.main(LM_FLAGS + ["-ll:gpu", "2", "--dp", "2", "-i", "1",
                              "--accum-steps", "4"], device="cpu")


SERVE = ["--vocab", "256", "--d-model", "64", "--heads", "4", "--layers",
         "2", "--max-seq", "32", "--max-batch", "2", "--buckets", "8,32",
         "--decode-steps", "4", "--requests", "3", "--max-new", "4",
         "--prompt-len", "3:6"]


@pytest.mark.parametrize("shard", [None, "2,1"])
def test_serve_from_the_two_rank_snapshot(apps, tmp_path, capfd, shard):
    argv = SERVE + ["--ckpt-dir", apps["accum"]["ckpt"]]
    if shard:
        argv += ["--shard", shard, "--telemetry", str(tmp_path)]
    st = {}
    assert tserve.main(argv, device="cpu", stats_out=st) == 0
    out = capfd.readouterr().out
    step = sorted(int(s) for s in os.listdir(apps["accum"]["ckpt"]))[-1]
    assert f"restored training checkpoint step {step}" in out
    if shard:
        runs = sorted(glob.glob(str(tmp_path / "run-*-p*.jsonl")))
        assert [f[-9:] for f in runs] == ["-p0.jsonl", "-p1.jsonl"]
