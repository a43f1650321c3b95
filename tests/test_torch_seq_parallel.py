"""The port's sequence parallelism and model strategies across a world
of ranks, held against the JAX package's runs of the same tables.

One world of four gloo ranks (``parallel/launch.py``: CPU ranks of one
thread) is spawned for the module and runs every case through
``flexflow_torch.tools.mesh_smoke.run_cases`` under ``WORLD_S``, so a
backward whose collectives fall out of lockstep fails instead of
hanging; a table of fewer parts runs replicated over the mesh axes it
leaves.  JAX runs each table on four devices of the 8-device CPU mesh
``tests/conftest.py`` forces; its initial parameters (and NMT's Dropout
keys) cross over through numpy and the batches are drawn with numpy.

- Ring attention (``tests/test_attention.py:80-188``'s models): the
  einsum route (batch 4, seq 8, d 12, 3 heads: hd 4 is outside the
  dispatcher's gate) at ``s = 4`` causal and ``n = 2 x s = 2``, and the
  flash route (batch 2, seq 64, d 16, 2 heads: K1f's and K1b's plain
  versions on the CPU) at ``s = 4`` causal and ``n = 2 x s = 2``: the
  attention's output within ``FWD_TOL`` = 2e-5 and the parameters after
  two SGD steps (momentum 0.9) within ``GRAD_RTOL`` = 1e-4 /
  ``GRAD_ATOL`` = 1e-5; rank ``s_idx`` calls the dispatcher ``1 +
  s_idx`` times a forward under the causal mask, ``S`` times without.
- The pipelined LSTM (``tests/test_rnn.py:70-200``): ``s = 2``
  (microbatches 2), ``s = 4`` (8) and ``n = 2 x s = 2`` (1, from an
  initial state): outputs, final states and trained parameters within
  the same bars.
- NMT under ``nmt_strategy(4)`` (dp 2 x sp 2, Dropout between the
  layers), Candle-Uno under ``candle_uno_strategy(4)`` and a one-layer
  LM under ``transformer_strategy`` (dp 2 x sp 2, and sp 2 x tp 2, where
  ``mlp_up``'s ``c`` moves to ``mlp_down``'s ``s``): three steps'
  losses and parameters within the bars above (the LM's within
  ``tests/test_torch_sharding.py``'s).
- ``transformer_strategy``, ``nmt_strategy`` and ``candle_uno_strategy``
  give JAX's tables at every degree on 1, 2, 4 and 8 devices.
- Planted faults (``mesh_smoke.SEQ_FAULTS``, on every rank):
  ``ring_attend_future``, ``ring_reverse`` and ``lstm_no_carry`` each put
  the output far outside ``FWD_TOL``.
- The apps: ``apps.transformer -ll:gpu 2 --sp 2`` and ``apps.nmt
  -ll:gpu 2`` train on two CPU ranks and print one report.
- ``@pytest.mark.slow``: the 8-rank tables (ring at ``n = 2 x s = 4``,
  both routes, causal and not; the LSTM's gradients at ``n = 2 x s = 4``;
  the LM at dp 2 x sp 2 x tp 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_torch.apps import nmt as tnmt
from flexflow_torch.apps import transformer as tapp
from flexflow_torch.models.nmt import nmt_strategy as tnmt_strategy
from flexflow_torch.models.transformer import transformer_strategy as tstrat
from flexflow_torch.parallel import launch
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.candle_uno import CandleConfig as JCandle
from flexflow_tpu.models.candle_uno import build_candle_uno as jcandle
from flexflow_tpu.models.candle_uno import candle_uno_strategy as jcandle_st
from flexflow_tpu.models.nmt import build_nmt as jnmt
from flexflow_tpu.models.nmt import nmt_strategy as jnmt_strategy
from flexflow_tpu.models.transformer import build_transformer_lm as jlm
from flexflow_tpu.models.transformer import transformer_strategy as jstrat
from flexflow_tpu.optim import AdamOptimizer as JAdam
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime.executor import Executor as JExecutor

RUN = "flexflow_torch.tools.mesh_smoke:run_cases"
WORLD_S = 240
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
SGD = dict(lr=0.1, momentum=0.9)
LR = 1e-3
LM_LOSS_RTOL = 1e-5
LM_PARAM_ATOL = 1e-2 * LR
LM_EPS = 1e-4
LM = dict(batch_size=4, seq_len=32, vocab_size=256, d_model=64, num_heads=4,
          num_layers=1)
EINSUM = dict(batch=4, seq=8, d=12, heads=3)
FLASH = dict(batch=2, seq=64, d=16, heads=2)
NMT = dict(batch_size=8, src_len=8, tgt_len=8, vocab_size=64, embed_dim=8,
           hidden_size=8, num_layers=2)
CANDLE = dict(dense_layers=[32, 32], dense_feature_layers=[16],
              feature_shapes={"dose": 1, "cell.rnaseq": 24,
                              "drug.descriptors": 40, "drug.fingerprints": 16})


# -- JAX's side ---------------------------------------------------------------


def _jax_mha(batch, seq, d, heads, causal):
    ff = JModel(JConfig(batch_size=batch, compute_dtype="float32"))
    x = ff.create_tensor((batch, seq, d), name="x", dim_axes=("n", "s", None))
    lbl = ff.create_tensor((batch, seq), dtype=jnp.int32, name="label",
                           dim_axes=("n", "s"))
    y = ff.multihead_attention(x, heads, causal=causal, name="attn")
    ff.softmax(ff.dense(y, 5, name="head"), lbl, name="softmax")
    return ff


def _jax_lstm(microbatches=None, initial_state=False):
    ff = JModel(JConfig(batch_size=8, compute_dtype="float32"))
    x = ff.create_tensor((8, 8, 5), name="x", dim_axes=("n", "s", None))
    state = None
    if initial_state:
        state = tuple(ff.create_tensor((8, 6), name=n, dim_axes=("n", None))
                      for n in ("h0", "c0"))
    lbl = ff.create_tensor((8,), dtype=jnp.int32, name="label")
    _, hT, _ = ff.lstm(x, 6, initial_state=state,
                       num_microbatches=microbatches, name="lstm")
    ff.softmax(ff.dense(hT, 4, name="head"), lbl, name="softmax")
    return ff


def _run(ff, store, n, opt, batches, outputs=()):
    """JAX's run: initial params and state (numpy), the named outputs of
    an eval forward of the first batch, and the losses and final params
    of a train step a batch."""
    ex = JExecutor(ff, strategy=store, optimizer=opt,
                   devices=jax.devices()[:n])
    params, opt_state, state = ex.init(seed=0)
    p0, s0 = jax.device_get(params), jax.device_get(state)
    outs = {}
    if outputs:
        _, env = ex.forward_step(params, state, batches[0])
        outs = {k: np.asarray(env[k]) for k in outputs}
    losses = []
    for b in batches:
        params, opt_state, state, m = ex.train_step(
            params, opt_state, state, ex.shard_batch(b))
        losses.append(float(m["train_loss"]))
    return dict(p0=p0, s0=s0, outputs=outs, losses=losses,
                params=jax.device_get(params))


def _mha_batches(batch, seq, d, heads=None):
    rng = np.random.default_rng(3)
    return [{"x": rng.standard_normal((batch, seq, d)).astype(np.float32),
             "label": rng.integers(0, 5, (batch, seq)).astype(np.int32)}
            for _ in range(2)]


def _lstm_batches(initial_state=False):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(2):
        b = {"x": rng.standard_normal((8, 8, 5)).astype(np.float32),
             "label": rng.integers(0, 4, (8,)).astype(np.int32)}
        if initial_state:
            b["h0"] = rng.standard_normal((8, 6)).astype(np.float32)
            b["c0"] = rng.standard_normal((8, 6)).astype(np.float32)
        out.append(b)
    return out


def _nmt_batches():
    rng = np.random.default_rng(5)
    return [{k: rng.integers(0, 64, (8, 8)).astype(np.int32)
             for k in ("src", "tgt", "label")} for _ in range(3)]


def _candle_batches(ff):
    rng = np.random.default_rng(6)
    return [{t.name: rng.standard_normal(t.shape).astype(np.float32)
             for t in ff.input_tensors} for _ in range(3)]


def _lm_batches():
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, LM["vocab_size"],
                             (LM["batch_size"], LM["seq_len"])).astype(np.int32)
             for k in ("tokens", "label")} for _ in range(3)]


#: (name, model kw, causal, {op: degrees}) of the ring cases: each route
#: causal and not, ``s`` 4 and ``n`` 2 x ``s`` 2 (the LM's tables run the
#: flash route's ring at ``s`` 2).
RING = [
    ("einsum_s4_causal", EINSUM, True, dict(s=4)),
    ("einsum_n2s2", EINSUM, False, dict(n=2, s=2)),
    ("flash_s4_causal", FLASH, True, dict(s=4)),
    ("flash_n2s2", FLASH, False, dict(n=2, s=2)),
]
#: (name, lstm_model kw, {op: degrees}) of the LSTM cases: ``s`` 2 and 4
#: and ``n`` 2 x ``s`` 2, microbatches 2 (the default at ``s`` 2), 8 and
#: 1, with and without an initial state.
LSTM = [
    ("s2", {}, dict(s=2)),
    ("s4_mb8", dict(microbatches=8), dict(s=4)),
    ("n2s2_mb1_init", dict(microbatches=1, initial_state=True),
     dict(n=2, s=2)),
]
LSTM_OUTS = ("lstm:out", "lstm:out1", "lstm:out2")
#: (name, dp, sp, tp) of the LM cases on four ranks.
LM_TABLES = [("dp2sp2", 2, 2, 1), ("sp2tp2", 1, 2, 2)]
RANKS = 4


def _jax_ring(kw, causal, pc, n=RANKS):
    ff = _jax_mha(causal=causal, **kw)
    return _run(ff, JStore(n, {"attn": JPC(**pc)}), n, JSGD(**SGD),
                _mha_batches(**kw), outputs=("attn:out",))


def _jax_lstm_case(kw, pc, n=RANKS):
    return _run(_jax_lstm(**kw), JStore(n, {"lstm": JPC(**pc)}), n,
                JSGD(**SGD), _lstm_batches(kw.get("initial_state", False)),
                outputs=LSTM_OUTS)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {f"ring_{name}": _jax_ring(kw, causal, pc)
            for name, kw, causal, pc in RING}
    for name, kw, pc in LSTM:
        runs[f"lstm_{name}"] = _jax_lstm_case(kw, pc)
    nmt = jnmt(config=JConfig(batch_size=8, seed=0), **NMT)
    runs["nmt"] = _run(nmt, jnmt_strategy(RANKS, num_layers=2), RANKS,
                       JSGD(lr=0.5), _nmt_batches())
    cff = jcandle(batch_size=8, candle=JCandle(**CANDLE),
                  config=JConfig(batch_size=8, seed=0))
    runs["candle"] = _run(cff, jcandle_st(RANKS, JCandle(**CANDLE)), RANKS,
                          JSGD(lr=0.05), _candle_batches(cff))
    for name, dp, sp, tp in LM_TABLES:
        ff = jlm(config=JConfig(batch_size=LM["batch_size"], seed=0), **LM)
        runs[f"lm_{name}"] = _run(ff, jstrat(RANKS, LM["num_layers"], dp=dp,
                                             sp=sp, tp=tp), RANKS,
                                  JAdam(lr=LR, eps=LM_EPS), _lm_batches())
    return runs


# -- the port's worlds --------------------------------------------------------


def _ring_case(jr, kw, causal, pc, **extra):
    return dict(model="mha", model_kw=dict(kw, causal=causal),
                table={"attn": pc}, optimizer=("sgd", SGD),
                batches=_mha_batches(**kw), params=jr["p0"],
                outputs=["attn:out"], **extra)


def _lstm_case(jr, kw, pc, **extra):
    return dict(model="lstm", model_kw=kw, table={"lstm": pc},
                optimizer=("sgd", SGD),
                batches=_lstm_batches(kw.get("initial_state", False)),
                params=jr["p0"], outputs=list(LSTM_OUTS), **extra)


def _table(store):
    return {k: v.to_json() for k, v in store.table.items()}


def _lm_case(p0, n, dp, sp, tp):
    return dict(model="lm", model_kw=LM,
                table=_table(tstrat(n, LM["num_layers"], dp=dp, sp=sp,
                                    tp=tp)),
                optimizer=("adam", {"lr": LR, "eps": LM_EPS}),
                batches=_lm_batches(), params=p0)


@pytest.fixture(scope="module")
def world(jax_runs):
    """Every case on one world of four ranks (a table of fewer parts runs
    replicated over the mesh axes it leaves), and the planted faults."""
    from flexflow_torch.models.candle_uno import candle_uno_strategy
    from flexflow_torch.tools import mesh_smoke

    names, cases = [], []
    for name, kw, causal, pc in RING:
        names.append(f"ring_{name}")
        cases.append(_ring_case(jax_runs[names[-1]], kw, causal, pc,
                                record_shapes=True))
    for name, kw, pc in LSTM:
        names.append(f"lstm_{name}")
        cases.append(_lstm_case(jax_runs[names[-1]], kw, pc))
    for name, dp, sp, tp in LM_TABLES:
        names.append(f"lm_{name}")
        cases.append(_lm_case(jax_runs[names[-1]]["p0"], RANKS, dp, sp, tp))
    nmt = jax_runs["nmt"]
    names += ["nmt", "candle"]
    cases.append(dict(model="nmt", model_kw=NMT,
                      table=_table(tnmt_strategy(RANKS, num_layers=2)),
                      optimizer=("sgd", {"lr": 0.5, "momentum": 0.0}),
                      batches=_nmt_batches(), params=nmt["p0"],
                      state=nmt["s0"]))
    cases.append(dict(model="candle", model_kw=CANDLE,
                      table=_table(candle_uno_strategy(RANKS)),
                      optimizer=("sgd", {"lr": 0.05, "momentum": 0.0}),
                      batches=_candle_batches(mesh_smoke.candle(**CANDLE)),
                      params=jax_runs["candle"]["p0"]))
    for fault, base in FAULTS:
        names.append(fault)
        cases.append(dict(cases[names.index(base)], fault=fault,
                          record_shapes=False, batches=cases[names.index(
                              base)]["batches"][:1]))
    out = launch.run(RUN, (cases,), nprocs=RANKS, device="cpu",
                     timeout_s=WORLD_S)
    return [dict(zip(names, rank)) for rank in out]


#: (fault, the case it is planted on, the output it must corrupt).
FAULTS = [("ring_attend_future", "ring_flash_s4_causal"),
          ("ring_reverse", "ring_einsum_s4_causal"),
          ("lstm_no_carry", "lstm_s4_mb8")]


def _close_params(got, want, rtol, atol):
    for op, g in want.items():
        for k, v in g.items():
            np.testing.assert_allclose(got[op][k], np.asarray(v), rtol=rtol,
                                       atol=atol, err_msg=f"{op}.{k}")


@pytest.mark.parametrize("name,kw,causal,pc", RING,
                         ids=[r[0] for r in RING])
def test_ring_attention_matches_jax(world, jax_runs, name, kw, causal, pc):
    want = jax_runs[f"ring_{name}"]
    for rank in world:
        got = rank[f"ring_{name}"]
        assert not got["jax_imported"]
        np.testing.assert_allclose(got["outputs"]["attn:out"],
                                   want["outputs"]["attn:out"], rtol=FWD_TOL,
                                   atol=FWD_TOL)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        _close_params(got["params"], want["params"], GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name,kw,causal,pc", RING,
                         ids=[r[0] for r in RING])
def test_ring_calls_the_dispatcher_per_visible_chunk(world, name, kw, causal,
                                                     pc):
    """Under the causal mask rank ``s_idx`` runs its own chunk and the
    ``s_idx`` earlier ones: ``1 + s_idx`` dispatcher calls a forward
    (K1f launches on the card), at the local ``(b/n, h, t/S, hd)``;
    without the mask every rank runs all ``S``.  The einsum route calls
    the dispatcher once a forward (it returns None) and launches
    nothing."""
    from flexflow_torch.parallel.mesh import build_mesh_plan
    from flexflow_torch.parallel.strategy import ParallelConfig

    plan = build_mesh_plan(RANKS)
    s_axes = plan.assign(ParallelConfig(**pc))["s"]
    size = plan.size(s_axes)
    local = (kw["batch"] // pc.get("n", 1), kw["heads"], kw["seq"] // size,
             kw["d"] // kw["heads"])
    forwards = 1 + 2  # one eval forward, then a training forward a step
    for r, rank in enumerate(world):
        shapes = rank[f"ring_{name}"]["kernel_shapes"][
            "flash_attention_lse_auto"]
        assert set(shapes) == {local}
        s_idx = plan.block_index(s_axes, r)
        per = 1 if name.startswith("einsum") else \
            (1 + s_idx if causal else size)
        assert len(shapes) == per * forwards, (r, len(shapes))


@pytest.mark.parametrize("name,kw,pc", LSTM, ids=[r[0] for r in LSTM])
def test_pipelined_lstm_matches_jax(world, jax_runs, name, kw, pc):
    want = jax_runs[f"lstm_{name}"]
    for rank in world:
        got = rank[f"lstm_{name}"]
        for k in LSTM_OUTS:
            np.testing.assert_allclose(got["outputs"][k], want["outputs"][k],
                                       rtol=FWD_TOL, atol=FWD_TOL, err_msg=k)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        _close_params(got["params"], want["params"], GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("model", ["nmt", "candle"])
def test_model_strategy_on_four_ranks_matches_jax(world, jax_runs, model):
    """NMT under ``nmt_strategy(4)`` (the LSTMs' pipeline at dp 2 x sp 2,
    the Dropout's keyed masks cut along the sequence, the projection over
    the vocabulary) and Candle-Uno under ``candle_uno_strategy(4)`` (the
    trunk at n 2 x c 2)."""
    want = jax_runs[model]
    for rank in world:
        got = rank[model]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        _close_params(got["params"], want["params"], GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name,dp,sp,tp", LM_TABLES,
                         ids=[t[0] for t in LM_TABLES])
def test_lm_sequence_tables_match_jax(world, jax_runs, name, dp, sp, tp):
    """The LM under ``transformer_strategy`` at dp 2 x sp 2 and at sp 2 x
    tp 2, where ``mlp_up``'s ``c`` split moves to ``mlp_down``'s ``s``
    across dims (one all-to-all: the two share the mesh axis)."""
    want = jax_runs[f"lm_{name}"]
    for rank in world:
        got = rank[f"lm_{name}"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LM_LOSS_RTOL)
        _close_params(got["params"], want["params"], 0, LM_PARAM_ATOL)


@pytest.mark.parametrize("fault,base", FAULTS, ids=[f[0] for f in FAULTS])
def test_planted_faults_fail_their_checks(world, fault, base):
    """Each fault, planted on every rank (so the world stays in lockstep),
    moves the output it corrupts far past ``FWD_TOL``, while the sound
    run sits within it."""
    out = "lstm:out" if base.startswith("lstm") else "attn:out"
    for rank in world:
        good = rank[base]["outputs"][out]
        bad = rank[fault]["outputs"][out]
        assert float(np.abs(bad - good).max()) > 1e3 * FWD_TOL


@pytest.mark.parametrize("argv", [
    (tapp, ["-b", "4", "--seq", "32", "--layers", "2", "--vocab", "256",
            "--d-model", "64", "--heads", "4", "--optimizer", "adam", "--lr",
            "1e-3", "-i", "2", "-ll:gpu", "2", "--sp", "2"]),
    (tnmt, ["-b", "4", "--vocab", "64", "--hidden", "16", "--src-len", "4",
            "--tgt-len", "4", "-i", "2", "-ll:gpu", "2"])],
    ids=["transformer_sp2", "nmt"])
def test_apps_train_sequence_tables_on_two_cpu_ranks(capfd, argv):
    """The app spawns its own world of two under its model's strategy
    (the LM at ``--sp 2``, NMT at ``nmt_strategy(2)``: sp 2), prints one
    report and hands rank 0's stats to the caller."""
    app, args = argv
    stats = {}
    assert app.main(args, device="cpu", stats_out=stats) == 0
    assert capfd.readouterr().out.count("THROUGHPUT = ") == 1
    assert len(stats["step_losses"]) == 3
    assert np.isfinite(stats["step_losses"]).all()


# -- eight ranks ---------------------------------------------------------------


@pytest.mark.slow
def test_eight_rank_tables_match_jax():
    """Ring attention at n 2 x s 4 (both routes, causal and not), the
    LSTM's gradients at n 2 x s 4 and the LM at dp 2 x sp 2 x tp 2 on 8
    ranks, against JAX's runs on 8 devices."""
    runs, cases, names = {}, [], []
    for route, kw in (("einsum", EINSUM), ("flash", FLASH)):
        for causal in (True, False):
            name = f"{route}_{causal}"
            runs[name] = _jax_ring(kw, causal, dict(n=2, s=4), 8)
            cases.append(_ring_case(runs[name], kw, causal, dict(n=2, s=4)))
            names.append(name)
    runs["lstm"] = _jax_lstm_case({}, dict(n=2, s=4), 8)
    cases.append(_lstm_case(runs["lstm"], {}, dict(n=2, s=4)))
    names.append("lstm")
    ff = jlm(config=JConfig(batch_size=LM["batch_size"], seed=0), **LM)
    runs["lm"] = _run(ff, jstrat(8, LM["num_layers"], dp=2, sp=2, tp=2), 8,
                      JAdam(lr=LR, eps=LM_EPS), _lm_batches())
    cases.append(_lm_case(runs["lm"]["p0"], 8, 2, 2, 2))
    names.append("lm")
    out = launch.run(RUN, (cases,), nprocs=8, device="cpu",
                     timeout_s=2 * WORLD_S)
    for rank in out:
        got = dict(zip(names, rank))
        for name in names[:-2]:
            np.testing.assert_allclose(got[name]["outputs"]["attn:out"],
                                       runs[name]["outputs"]["attn:out"],
                                       rtol=FWD_TOL, atol=FWD_TOL)
            _close_params(got[name]["params"], runs[name]["params"],
                          GRAD_RTOL, GRAD_ATOL)
        _close_params(got["lstm"]["params"], runs["lstm"]["params"],
                      GRAD_RTOL, GRAD_ATOL)
        np.testing.assert_allclose(got["lm"]["losses"], runs["lm"]["losses"],
                                   rtol=LM_LOSS_RTOL)
        _close_params(got["lm"]["params"], runs["lm"]["params"], 0,
                      LM_PARAM_ATOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_strategy_tables_equal_jax(n):
    """``transformer_strategy`` at every degree that fits ``n`` devices
    (with and without experts), ``nmt_strategy`` (its default split and
    given degrees) and ``candle_uno_strategy`` give JAX's tables."""
    from flexflow_torch.models.candle_uno import (CandleConfig,
                                                  candle_uno_strategy)

    def same(mine, theirs):
        assert {k: v.to_json() for k, v in mine.table.items()} == \
            {k: v.to_json() for k, v in theirs.table.items()}
        assert mine.num_devices == theirs.num_devices

    degrees = [d for d in (1, 2, 4, 8) if d <= n]
    for dp in degrees:
        for sp in degrees:
            for tp in degrees:
                if dp * sp > n or dp * tp > n:
                    continue
                for moe in (False, True):
                    same(tstrat(n, 2, dp=dp, sp=sp, tp=tp, moe=moe),
                         jstrat(n, 2, dp=dp, sp=sp, tp=tp, moe=moe))
    same(tnmt_strategy(n, num_layers=2), jnmt_strategy(n, num_layers=2))
    for dp in degrees:
        same(tnmt_strategy(n, dp=dp), jnmt_strategy(n, dp=dp))
        same(tnmt_strategy(n, sp=dp), jnmt_strategy(n, sp=dp))
    same(candle_uno_strategy(n, CandleConfig(**CANDLE)),
         jcandle_st(n, JCandle(**CANDLE)))
