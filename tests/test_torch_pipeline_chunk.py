"""The chunked and the compiled pipeline (``runtime/pipeline.py``,
``chunk`` and ``compiled``) on a world of four gloo ranks, held against
the JAX package's (``tests/test_pipeline_chunk.py``) and against the
port's own host-driven event loop.

One world (``flexflow_torch.tools.mesh_pipeline:world_cases``) runs every
case of the module.  JAX's initial per-stage parameters cross over
through numpy (``weights.pipeline_params_from_numpy``); batches are drawn
with numpy.

- Chunked = the ``c = 1`` loop, bit for bit: c in {2, 4} at m = 4, the
  tail c = 3 (chunks of 3 + 1), gpipe at c = 2, ``--clip-norm``,
  Dropout (its key threads the microbatches in order) and the skip
  connection (stage 0's output read by stages 1 and 2).
- A step walks ``2 S ceil(m/c)`` events (``last_schedule``,
  dependency-valid at chunk grain) and sends ``ceil(m/c)`` hand-offs a
  boundary and direction; ``chunk > m`` clamps with JAX's warning,
  ``chunk < 1`` raises.
- Compiled = host-driven, bit for bit: plain, Dropout, clip, S = 4 (a
  rank a stage), m = 3, ``c = 2`` inside the stages on ``Linear`` ops,
  the skip connection (stages on ranks {0}, {1}, {2}: disjoint, one
  size, rank 3 in none), accumulation lowered into the microbatches;
  ``build_superstep(k)`` over ``stack_steps`` equals k steps and counts
  one program a superstep; ``eval_step`` equals the host-driven one.
  JAX's 8-device corners (S = 4 at n = 2, nested n2c2) run on a world
  of eight under ``slow``.
- ``make_executor`` falls back loudly, in JAX's words, on unequal stages,
  ``h = 2`` and ``c = 2`` on a Dropout; ``compiled_unsupported_reason``
  gives JAX's strings; ``--zero-opt`` stays refused;
  ``superstep_mode``/``superstep_capable`` are JAX's.
- The apps: ``apps.nmt --pipeline --microbatches 2 --pipeline-chunk 2``
  bit for bit ``--microbatches 2``; ``--pipeline-compiled
  --steps-per-call 2`` bit for bit the same steps host-driven, and under
  ``--resilient`` bit for bit the resilient run at one step a call.
- ``pipeline_superstep_nan`` (``runtime/chaos.py``) on the world: two
  stages of two, rolled back once and replayed bit for bit.
- Against JAX's chunked (c = 2) and compiled runs within JAX's
  cross-framework bars (losses ``rtol=1e-5``; parameters ``rtol=2e-4,
  atol=2e-5``).

JAX's own ``test_chunked_skip_connection`` and
``test_compiled_skip_connection`` fail on the CPU (jax 0.9.0) by
XLA's rounding alone: 2 of 8 updated parameters differ from JAX's host
loop by 9.313e-10 (a relative 1.97e-7, one f32 ulp), two compiled
programs rounding one sum differently.  The port runs the same stage programs in
every form, so it pins its skip connection bit for bit.
"""

import glob
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_torch.config import FFConfig
from flexflow_torch.parallel import launch
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore
from flexflow_torch.runtime import pipeline as tpipe
from flexflow_torch.tools import mesh_pipeline as mp
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime import pipeline as jpipe

RUN = "flexflow_torch.tools.mesh_pipeline:world_cases"
RANKS = 4
WORLD_S = 420
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
SGD = ("sgd", {"lr": 0.1, "momentum": 0.9})
ENC, DEC = [0, 1], [2, 3]
TWO = {**{n: {"n": 2, "device_ids": ENC} for n in ("enc0", "enc1")},
       **{n: {"n": 2, "device_ids": DEC} for n in ("dec0", "dec1",
                                                    "softmax")}}
DROP = {**TWO, "drop": {"n": 2, "device_ids": DEC}}
SKIP = {"s0": {"device_ids": [0]}, "s1": {"device_ids": [1]},
        **{n: {"device_ids": [2]} for n in ("s2cat", "s2fc", "softmax")}}
S4 = {**{f"fc{i}": {"device_ids": [i]} for i in range(3)},
      **{n: {"device_ids": [3]} for n in ("fc3", "head", "softmax")}}
TP = {**{n: {"c": 2, "device_ids": ENC} for n in ("fc0", "fc1")},
      **{n: {"c": 2, "device_ids": DEC} for n in ("fc2", "fc3", "head")},
      "softmax": {"n": 2, "device_ids": DEC}}
UNEQUAL = {**{n: {"n": 2, "device_ids": ENC} for n in ("enc0", "enc1")},
           **{n: {"device_ids": [2]} for n in ("dec0", "dec1", "softmax")}}
H2 = {**TWO, "enc0": {"h": 2, "device_ids": ENC}}
DROP_C2 = {**DROP, "drop": {"c": 2, "device_ids": DEC}}
APP_NMT = ["--pipeline", "-ll:gpu", "4", "-b", "8", "--src-len", "6",
           "--tgt-len", "6", "--hidden", "32", "--vocab", "128",
           "--optimizer", "sgd", "--lr", "0.5", "--momentum", "0", "--wd",
           "0", "--microbatches", "2"]
FALLBACK = "--pipeline-compiled unavailable for this model/strategy"


def _batches(n, batch=16, din=12, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((batch, din)).astype(np.float32),
             "label": rng.integers(0, classes, (batch,)).astype(np.int32)}
            for _ in range(n)]


# -- JAX's side ---------------------------------------------------------------


def _jax_two_stage(batch=16, din=12, dh=16, classes=4):
    ff = JModel(JConfig(batch_size=batch))
    x = ff.create_tensor((batch, din), name="x")
    lbl = ff.create_tensor((batch,), dtype=jnp.int32, name="label")
    t = ff.dense(x, dh, activation="relu", name="enc0")
    t = ff.dense(t, dh, activation="relu", name="enc1")
    t = ff.dense(t, dh, activation="relu", name="dec0")
    t = ff.dense(t, classes, activation=None, name="dec1")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _jax_store(table, nd=RANKS):
    store = JStore(nd)
    for k, v in table.items():
        store.set(k, JPC.from_json(v))
    return store


def _jax_run(batches, **kw):
    """JAX's pipeline on four devices: initial per-stage params, losses,
    final params (one tree)."""
    ff = _jax_two_stage()
    pipe = jpipe.PipelineExecutor(
        ff, _jax_store(TWO), config=ff.config,
        optimizer=JSGD(lr=0.1, momentum=0.9), microbatches=4,
        devices=jax.devices()[:RANKS], **kw)
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
    b = _batches(3)
    return {"chunk": _jax_run(b, chunk=2), "compiled": _jax_run(
        b, compiled=True)}


# -- the port's world ---------------------------------------------------------


@pytest.fixture(scope="module")
def world(jax_runs, tmp_path_factory):
    p0 = jax_runs["chunk"]["p0"]
    b, clip_b = _batches(3), _batches(2, seed=3)
    eval_b = _batches(1, seed=5)[0]
    d = tmp_path_factory.mktemp("chunk")

    def two(name, **kw):
        return {**dict(name=name, model="two_stage", table=TWO,
                       model_kw={"batch": 16}, params=p0, optimizer=SGD,
                       batches=b, microbatches=4), **kw}

    def drop(name, **kw):
        return {**dict(name=name, model="two_stage", table=DROP, seed=0,
                       model_kw={"batch": 16, "dropout": 0.5},
                       optimizer=SGD, batches=_batches(2), microbatches=4),
                **kw}

    def skip(name, **kw):
        return {**dict(name=name, model="skip", table=SKIP, seed=0,
                       optimizer=("sgd", {"lr": 0.1}),
                       batches=_batches(1, batch=8), microbatches=2), **kw}

    def deep(name, table, m, batch, **kw):
        return {**dict(name=name, model="deep", table=table, seed=0,
                       model_kw={"batch": batch}, optimizer=SGD,
                       batches=_batches(2, batch=batch), microbatches=m),
                **kw}

    def app(name, *extra):
        return dict(name=name, app="nmt", argv=APP_NMT + list(extra))

    res = str(d / "res")
    cases = [
        two("c1", eval=eval_b), two("c2", chunk=2), two("c3", chunk=3),
        two("c4", chunk=4, eval=eval_b),
        two("c2_gpipe", chunk=2, schedule="gpipe"),
        two("clip_c1", config={"clip_norm": 0.5}, batches=clip_b),
        two("clip_c4", config={"clip_norm": 0.5}, batches=clip_b, chunk=4),
        two("clamp", chunk=8, batches=[]),
        two("comp", compiled=True, eval=eval_b),
        two("comp_clip", compiled=True, config={"clip_norm": 0.5},
            batches=clip_b),
        two("comp_k3", compiled=True, superstep=3),
        two("accum", microbatches=2, accum_steps=2),
        two("comp_accum", microbatches=2, accum_steps=2, compiled=True),
        drop("drop_c1"), drop("drop_c2", chunk=2),
        drop("drop_comp", compiled=True),
        skip("skip_c1"), skip("skip_c2", chunk=2),
        skip("skip_comp", compiled=True),
        deep("s4", S4, 4, 16), deep("s4_comp", S4, 4, 16, compiled=True),
        deep("s4_m3", S4, 3, 24), deep("s4_m3_comp", S4, 3, 24,
                                      compiled=True),
        deep("tp", TP, 4, 16), deep("tp_comp", TP, 4, 16, compiled=True),
        two("fb_unequal", table=UNEQUAL, compiled=True, batches=[]),
        two("fb_h2", table=H2, compiled=True, batches=[]),
        drop("fb_drop_c2", table=DROP_C2, compiled=True, batches=[]),
        app("app_m2", "-i", "3"),
        app("app_chunk", "-i", "3", "--pipeline-chunk", "2"),
        app("app_host6", "-i", "5"),
        app("app_comp", "-i", "4", "--pipeline-compiled",
            "--steps-per-call", "2", "--telemetry", str(d / "tel")),
        app("app_res_host", "-i", "4", "--resilient", "--ckpt-dir",
            res + "_host"),
        app("app_res_comp", "-i", "4", "--resilient", "--pipeline-compiled",
            "--steps-per-call", "2", "--ckpt-dir", res + "_comp"),
        dict(name="chaos", chaos=str(d / "chaos")),
    ]
    ranks = launch.run(RUN, (cases,), nprocs=RANKS, device="cpu",
                       timeout_s=WORLD_S)
    out = [{c["name"]: r for c, r in zip(cases, rank)} for rank in ranks]
    out[0]["_tel"] = str(d / "tel")
    return out


def _same(a, b, what=""):
    assert a["losses"] == b["losses"], what
    assert a["params"].keys() == b["params"].keys()
    for op, g in a["params"].items():
        for k, v in g.items():
            np.testing.assert_array_equal(v, b["params"][op][k],
                                          err_msg=f"{what} {op}.{k}")


def _close(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    for op, g in want["params"].items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       err_msg=f"{op}.{k}", **PARAM_TOL)


@pytest.mark.parametrize("case,ref", [
    ("c2", "c1"), ("c4", "c1"), ("c3", "c1"), ("c2_gpipe", "c1"),
    ("clip_c4", "clip_c1"), ("drop_c2", "drop_c1"), ("skip_c2", "skip_c1")])
def test_chunked_is_the_event_loop_bit_for_bit(world, case, ref):
    for rank in world:
        assert rank[case]["losses"] == world[0][case]["losses"]
    _same(world[0][case], world[0][ref], case)


def test_clip_engaged(world):
    a, b = world[0]["clip_c1"], world[0]["c1"]
    assert a["params"]["enc0"]["kernel"].tolist() != \
        b["params"]["enc0"]["kernel"].tolist()


@pytest.mark.parametrize("c,units", [(1, 4), (2, 2), (3, 2), (4, 1)])
def test_chunk_cuts_events_and_handoffs(world, c, units):
    """``2 S ceil(m/c)`` events a step, dependency-valid at chunk grain;
    ``ceil(m/c)`` hand-offs a boundary and direction: the encoder's first
    rank sends the activations, the decoder's first rank the
    cotangents, no other rank sends."""
    got = world[0][f"c{c}"]
    ev = [tuple(e) for e in got["schedule"]]
    assert len(ev) == 2 * 2 * units
    assert ev == tpipe.build_schedule("1f1b", 2, units)
    pos = {e: i for i, e in enumerate(ev)}
    for kind, si, ci in ev:
        if kind == "F" and si > 0:
            assert pos[("F", si - 1, ci)] < pos[("F", si, ci)]
        if kind == "B":
            assert pos[("F", si, ci)] < pos[("B", si, ci)]
            if si < 1:
                assert pos[("B", si + 1, ci)] < pos[("B", si, ci)]
    assert [rank[f"c{c}"]["sends"] for rank in world] == [units, 0, units, 0]
    assert [rank["comp"]["sends"] for rank in world] == [1, 0, 1, 0]


def test_chunk_clamped_and_refused(world, caplog):
    assert world[0]["clamp"]["chunk"] == 4
    assert any("clamping" in w for w in world[0]["clamp"]["warnings"])
    ts = StrategyStore(RANKS, {k: ParallelConfig.from_json(v)
                               for k, v in TWO.items()})
    with pytest.raises(ValueError, match="pipeline chunk must be >= 1"):
        tpipe.PipelineExecutor(mp.two_stage(), ts, chunk=0)
    with caplog.at_level(logging.WARNING, logger="ff.pipeline"):
        with pytest.raises(tpipe.PlacementError, match="-ll:gpu 4"):
            tpipe.PipelineExecutor(mp.two_stage(), ts, microbatches=2,
                                   chunk=8)
    assert any("clamping" in r.message for r in caplog.records)


@pytest.mark.parametrize("case,ref", [
    ("comp", "c1"), ("drop_comp", "drop_c1"), ("comp_clip", "clip_c1"),
    ("s4_comp", "s4"), ("s4_m3_comp", "s4_m3"), ("tp_comp", "tp"),
    ("skip_comp", "skip_c1"), ("comp_k3", "c1"), ("comp_accum", "c1"),
    ("accum", "c1")])
def test_compiled_is_host_driven_bit_for_bit(world, case, ref):
    for rank in world:
        got = rank[case]
        assert got["losses"] == world[0][case]["losses"]
        assert got["compiled"] is (case != "accum")
    _same(world[0][case], world[0][ref], case)


def test_compiled_step_accounting(world):
    """One program a step (``("C", 0, 0)``), one a superstep of k; the
    compiled executor's supersteps fuse, the host-driven's do not."""
    assert world[0]["comp"]["schedule"] == [("C", 0, 0)]
    assert world[0]["comp"]["fused"] and not world[0]["c4"]["fused"]
    assert world[3]["skip_comp"]["mine"] == []  # rank 3 is in no stage


def test_compiled_eval_is_host_driven(world):
    for rank in world:
        assert rank["comp"]["eval"] == rank["c1"]["eval"] == \
            rank["c4"]["eval"]


@pytest.mark.parametrize("case,table", [("fb_unequal", UNEQUAL),
                                        ("fb_h2", H2),
                                        ("fb_drop_c2", DROP_C2)])
def test_make_executor_falls_back_loudly(world, case, table):
    got = world[0][case]
    assert got["compiled"] is False
    assert any(w.startswith(FALLBACK) and w.endswith(
        "falling back to the host-driven pipeline") for w in got["warnings"])
    model = (mp.two_stage(batch=16, dropout=0.5) if "drop" in case
             else mp.two_stage(batch=16))
    store = StrategyStore(RANKS, {k: ParallelConfig.from_json(v)
                                  for k, v in table.items()})
    reason = tpipe.compiled_unsupported_reason(model, store)
    assert reason is not None and reason in " ".join(got["warnings"])
    jff = _jax_two_stage()
    if "drop" in case:
        jff = JModel(JConfig(batch_size=16))
        x = jff.create_tensor((16, 12), name="x")
        lbl = jff.create_tensor((16,), dtype=jnp.int32, name="label")
        t = jff.dense(x, 16, activation="relu", name="enc0")
        t = jff.dense(t, 16, activation="relu", name="enc1")
        t = jff.dropout(t, rate=0.5, name="drop")
        t = jff.dense(t, 16, activation="relu", name="dec0")
        t = jff.dense(t, 4, activation=None, name="dec1")
        jff.softmax(t, lbl, name="softmax")
    assert reason == jpipe.compiled_unsupported_reason(jff, _jax_store(table))


def test_eligible_tables_match_jax():
    for table in (TWO, DROP, SKIP):
        store = StrategyStore(RANKS, {k: ParallelConfig.from_json(v)
                                      for k, v in table.items()})
        model = mp.skip() if table is SKIP else mp.two_stage(
            batch=16, dropout=0.5 if table is DROP else 0.0)
        assert tpipe.compiled_unsupported_reason(model, store) is None
    assert tpipe.CompiledPipelineUnsupported.__mro__[1] is \
        tpipe.PlacementError


def test_superstep_mode_and_zero_opt():
    store = StrategyStore(RANKS, {k: ParallelConfig.from_json(v)
                                  for k, v in TWO.items()})
    jstore = _jax_store(TWO)
    for compiled in (False, True):
        assert store.superstep_mode(compiled) == \
            jstore.superstep_mode(compiled=compiled)
        assert store.superstep_capable(compiled) == \
            jstore.superstep_capable(compiled=compiled)
    assert store.superstep_mode() == "amortized"
    assert store.superstep_mode(compiled=True) == "fused"
    assert store.layer_wise and not StrategyStore(RANKS).layer_wise
    assert StrategyStore(RANKS).superstep_mode() == "fused"
    cfg = FFConfig(batch_size=16, zero_sharded_optimizer=True)
    with pytest.raises(tpipe.PlacementError, match="PER-SUBMESH"):
        tpipe.PipelineExecutor(mp.two_stage(batch=16), store, config=cfg,
                               microbatches=4, compiled=True)


def test_apps_chunk_and_compiled(world):
    """``--pipeline-chunk 2`` is ``--microbatches 2``; the compiled
    ``--steps-per-call 2`` (a superstep of warmup, then 4 steps) is the
    six host-driven steps; ``--resilient`` at K = 2 on the compiled
    pipeline is the resilient run at one step a call."""
    for rank in world:
        for name in ("app_m2", "app_chunk", "app_host6", "app_comp",
                     "app_res_host", "app_res_comp"):
            got = rank[name]
            assert got["code"] == 0 and got["kind"] == "PipelineExecutor", \
                name
            assert got["losses"] == world[0][name]["losses"], name
    w = world[0]
    _same(w["app_chunk"], w["app_m2"], "app_chunk")
    assert len(w["app_comp"]["losses"]) == 6
    _same(w["app_comp"], w["app_host6"], "app_comp")
    assert w["app_comp"]["schedule"] == [("C", 0, 0)]
    assert len(w["app_res_comp"]["losses"]) == 4
    _same(w["app_res_comp"], w["app_res_host"], "app_res_comp")
    assert w["app_res_comp"]["losses"][-1] < w["app_res_comp"]["losses"][0]


def test_compiled_superstep_telemetry(world):
    """JAX's ``test_compiled_superstep_bit_identical_and_counters``: one
    program a superstep (``programs_per_step`` = 1/k), every superstep
    ``fused``, a ``compiled_step`` event naming k, S and m, no
    ``clip_norm`` fence."""
    for rank in world:
        assert rank["app_comp"]["telemetry"]["programs_per_step"] == 0.5
    events = []
    for path in glob.glob(os.path.join(world[0]["_tel"], "**", "*.jsonl"),
                          recursive=True):
        with open(path) as f:
            events += [json.loads(line) for line in f if line.strip()]
    events = [e for e in events if "ev" in e]
    assert any(e["ev"] == "compiled_step" and (e["k"], e["S"], e["m"])
               == (2, 2, 2) for e in events)
    ss = [e for e in events if e["ev"] == "superstep"]
    assert ss and all(e["mode"] == "fused" and e["k"] == 2 for e in ss)
    assert not [e for e in events if e["ev"] == "fence"
                and e.get("label") == "clip_norm"]


def test_pipeline_superstep_nan_recovers(world):
    for r, rank in enumerate(world):
        ok, detail = rank["chaos"]["ok"], rank["chaos"]["detail"]
        assert ok and "restarts=1" in detail, f"rank {r}: {detail}"


@pytest.mark.parametrize("case,jax_case", [("c2", "chunk"),
                                           ("comp", "compiled")])
def test_matches_jax(world, jax_runs, case, jax_case):
    for rank in world:
        assert not rank[case]["jax_imported"]
    _close(world[0][case], jax_runs[jax_case])


# -- JAX's 8-device corners on a world of eight -------------------------------

S4_N2 = {**{f"fc{i}": {"n": 2, "device_ids": [2 * i, 2 * i + 1]}
            for i in range(3)},
         **{n: {"n": 2, "device_ids": [6, 7]} for n in ("fc3", "head",
                                                        "softmax")}}
NC = {**{n: {"n": 2, "c": 2, "device_ids": [0, 1, 2, 3]}
         for n in ("fc0", "fc1")},
      **{n: {"n": 2, "c": 2, "device_ids": [4, 5, 6, 7]}
         for n in ("fc2", "fc3", "head")},
      "softmax": {"n": 4, "device_ids": [4, 5, 6, 7]}}


@pytest.mark.slow
def test_compiled_parity_corners_on_eight_ranks():
    """JAX's ``test_compiled_parity_corners``: S = 4 at n = 2, m = 3 and
    nested n2c2, compiled bit for bit host-driven."""
    cases = []
    for name, table, m, batch in (("S4_n2", S4_N2, 4, 16),
                                  ("S4_odd_m", S4_N2, 3, 24),
                                  ("S2_nested_n2c2", NC, 4, 16)):
        for compiled in (False, True):
            cases.append(dict(name=f"{name}_{compiled}", model="deep",
                              table=table, seed=0, model_kw={"batch": batch},
                              optimizer=SGD, batches=_batches(2, batch=batch),
                              microbatches=m, compiled=compiled))
    ranks = launch.run(RUN, (cases,), nprocs=8, device="cpu",
                       timeout_s=WORLD_S)
    got = {c["name"]: r for c, r in zip(cases, ranks[0])}
    for name in ("S4_n2", "S4_odd_m", "S2_nested_n2c2"):
        assert got[f"{name}_True"]["compiled"]
        _same(got[f"{name}_True"], got[f"{name}_False"], name)
