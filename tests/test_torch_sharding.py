"""The port's dense strategies across worlds of ranks (``parallel/``)
held against the JAX package's runs of the same tables.

Each world is spawned once (``parallel/launch.py``: gloo, CPU ranks of
one thread, a ``FileStore`` rendezvous) and runs every case of its group
through ``flexflow_torch.tools.mesh_smoke.run_cases``; the ranks import
torch and the port only (each case reports whether ``jax`` was
imported).  JAX runs on the first N devices of the 8-device CPU mesh
``tests/conftest.py`` forces; its initial parameters cross over through
numpy and the batches are drawn from a seed with numpy.

- The small CNN of ``tests/test_sharding_equivalence.py`` (batch 8,
  8 x 8 x 4, SGD lr 0.05 momentum 0.9) under DP 4, TP (``fc1``/``fc2``
  at n=2 c=2), spatial (``conv1`` h=2 w=2, ``pool1`` n=2 h=2) and hybrid
  (``conv1`` n=2 c=2, ``fc1`` c=4, ``fc2`` n=4) tables on 4 ranks: the
  losses and the parameters after 3 steps within that file's bar
  (``rtol`` 2e-4, ``atol`` 1e-5) of JAX's on 4 devices.
- A 2-layer LM (vocab 256, d 64, 4 heads, seq 32, batch 4, f32, Adam lr
  1e-3) under ``transformer_strategy`` dp 2, tp 2 and dp 2 x tp 2: the
  losses within ``LM_LOSS_RTOL`` of JAX's and every parameter within
  ``LM_PARAM_ATOL`` (``1e-2 * lr``) of JAX's after 3 steps.  Adam's
  ``eps`` is ``LM_EPS`` = 1e-4 on both sides: with the default 1e-8 a
  gradient at rounding-noise level (the key biases', zero in exact
  arithmetic since a softmax row is invariant to a shift, and a few
  small entries elsewhere) becomes a step of about ``lr`` in either
  direction, so two correct runs that sum in different orders land up to
  ``2 * lr`` apart there; with 1e-4 such a gradient moves its parameter
  by less than ``1e-4 * lr``.
- Inside the port: attention with its heads split over ``c`` (and with
  ``c`` not dividing them) equal to one rank; ZeRO-1 equal to replicated
  Adam bit for bit (dp 2,
  and composed with tp 2 on 4 ranks), its moments held split (half the
  rows on each rank); the global ``--clip-norm`` under tp 2 equal to one
  rank's within 1e-6; ``Dropout`` and ``BatchNorm`` under DP 2 equal to
  one rank (the masks bit for bit, losses and parameters within 1e-6);
  a world of 1 equal to the plain ``Executor`` bit for bit; the
  attention and cross-entropy wrappers called at the rank's local
  shapes.
- The app: ``apps.transformer -ll:gpu 2 --dp 2`` (and ``--tp 2``) on the
  CPU prints one report and hands rank 0's stats to the caller; without
  ``-ll:gpu`` an app stays one process on a (mocked) two-card host;
  ``-ll:gpu 4`` without four cards raises; a rank that fails before a
  collective fails the world with an error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_torch.apps import transformer as tapp
from flexflow_torch.models.transformer import transformer_strategy as tstrat
from flexflow_torch.parallel import launch
from flexflow_torch.tools import mesh_smoke
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.transformer import build_transformer_lm as jlm
from flexflow_tpu.models.transformer import transformer_strategy as jstrat
from flexflow_tpu.optim import AdamOptimizer as JAdam
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime.executor import Executor as JExecutor

RUN = "flexflow_torch.tools.mesh_smoke:run_cases"
WORLD_S = 240  # each world's time limit
CNN_RTOL, CNN_ATOL = 2e-4, 1e-5
LR = 1e-3
STEPS = 3
LM_LOSS_RTOL = 1e-5
LM_PARAM_ATOL = 1e-2 * LR
LM_EPS = 1e-4
LM = dict(batch_size=4, seq_len=32, vocab_size=256, d_model=64, num_heads=4,
          num_layers=2)

CNN_TABLES = {
    "dp": {},
    "tp": {"fc1": dict(n=2, c=2), "fc2": dict(n=2, c=2)},
    "spatial": {"conv1": dict(h=2, w=2), "pool1": dict(n=2, h=2)},
    "hybrid": {"conv1": dict(n=2, c=2), "fc1": dict(c=4), "fc2": dict(n=4)},
}


# -- JAX's side ---------------------------------------------------------------


def _jax_cnn():
    ff = JModel(JConfig(batch_size=8, seed=7))
    x = ff.create_tensor((8, 8, 8, 4), name="x")
    lbl = ff.create_tensor((8,), dtype=jnp.int32, name="lbl")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 16, activation="relu", name="fc1")
    t = ff.dense(t, 4, activation=None, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _jax_run(ff, store, n, opt, batches):
    """JAX's initial params (numpy), losses and final params (numpy)."""
    ex = JExecutor(ff, strategy=store, optimizer=opt,
                   devices=jax.devices()[:n])
    params, opt_state, state = ex.init()
    p0 = jax.device_get(params)
    losses = []
    for b in batches:
        params, opt_state, state, m = ex.train_step(
            params, opt_state, state, ex.shard_batch(b))
        losses.append(float(m["train_loss"]))
    return p0, losses, jax.device_get(params)


def _cnn_batches():
    rng = np.random.default_rng(42)
    return [{"x": rng.standard_normal((8, 8, 8, 4)).astype(np.float32),
             "lbl": rng.integers(0, 4, size=(8,)).astype(np.int32)}
            for _ in range(STEPS)]


def _lm_batches():
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, LM["vocab_size"],
                             (LM["batch_size"], LM["seq_len"])).astype(np.int32)
             for k in ("tokens", "label")} for _ in range(STEPS)]


def _lm_table(n, dp, tp):
    return {k: v.to_json() for k, v in tstrat(n, LM["num_layers"], dp=dp,
                                              tp=tp).table.items()}


def _jax_lm(n, dp, tp):
    ff = jlm(config=JConfig(batch_size=LM["batch_size"], seed=0), **LM)
    return _jax_run(ff, jstrat(n, LM["num_layers"], dp=dp, tp=tp), n,
                    JAdam(lr=LR, eps=LM_EPS), _lm_batches())


@pytest.fixture(scope="module")
def jax_cnn():
    return {name: _jax_run(_jax_cnn(), JStore(4, {k: JPC(**v) for k, v in
                                                  t.items()}), 4,
                           JSGD(lr=0.05, momentum=0.9), _cnn_batches())
            for name, t in CNN_TABLES.items()}


@pytest.fixture(scope="module")
def jax_lm():
    return {"dp2": _jax_lm(2, 2, 1), "tp2": _jax_lm(2, 1, 2),
            "dp2tp2": _jax_lm(4, 2, 2)}


# -- the port's worlds --------------------------------------------------------


def _lm_case(p0, n, dp, tp, **extra):
    return dict(model="lm", model_kw=LM, table=_lm_table(n, dp, tp),
                optimizer=("adam", {"lr": LR, "eps": LM_EPS}),
                batches=_lm_batches(), params=p0, **extra)


def _attn_c_case(p0, c, heads):
    """The LM with every attention's heads split ``c`` ways (``heads``
    of them: when ``c`` does not divide them the op gathers its
    projections and runs every head on each rank)."""
    case = _lm_case(p0, c, 1, 1)
    case["model_kw"] = dict(LM, num_heads=heads)
    case["table"] = {f"blk{i}_attn": dict(c=c)
                     for i in range(LM["num_layers"])}
    return case


@pytest.fixture(scope="module")
def world4(jax_cnn, jax_lm):
    """CNN under the four tables; the LM under dp 2 x tp 2, with and
    without ZeRO."""
    p0 = jax_lm["dp2tp2"][0]
    cases = [dict(model="small_cnn", table=t, batches=_cnn_batches(),
                  params=jax_cnn[name][0])
             for name, t in CNN_TABLES.items()]
    cases += [_lm_case(p0, 4, 2, 2),
              _lm_case(p0, 4, 2, 2, config={"zero_sharded_optimizer": True}),
              _attn_c_case(p0, 4, 2)]
    out = launch.run(RUN, (cases,), nprocs=4, device="cpu",
                     timeout_s=WORLD_S)
    names = list(CNN_TABLES) + ["lm", "lm_zero", "attn_c4_h2"]
    return [dict(zip(names, rank)) for rank in out]


@pytest.fixture(scope="module")
def world2(jax_lm):
    """The LM under dp 2 (kernel shapes recorded), tp 2, dp 2 with ZeRO
    and tp 2 with --clip-norm; the norm CNN under DP 2."""
    p0 = jax_lm["dp2"][0]
    norm = dict(model="norm_cnn", batches=_cnn_batches(), dropout_masks=True,
                optimizer=("sgd", {"lr": 0.05, "momentum": 0.9}))
    cases = [_lm_case(p0, 2, 2, 1, record_shapes=True), _lm_case(p0, 2, 1, 2),
             _lm_case(p0, 2, 2, 1, config={"zero_sharded_optimizer": True}),
             _lm_case(p0, 2, 1, 2, config={"clip_norm": 0.5}), norm,
             _attn_c_case(p0, 2, LM["num_heads"])]
    out = launch.run(RUN, (cases,), nprocs=2, device="cpu",
                     timeout_s=WORLD_S)
    names = ["dp2", "tp2", "dp2_zero", "tp2_clip", "norm", "attn_c2"]
    return [dict(zip(names, rank)) for rank in out], cases


@pytest.fixture(scope="module")
def one_rank(world2, jax_lm):
    """The plain Executor (no world) on world2's clip, norm and
    attention cases and on the 2-head LM, with one thread as a rank
    runs."""
    _, cases = world2
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"tp2_clip": mesh_smoke.train_case(dict(cases[3], table={})),
                "norm": mesh_smoke.train_case(cases[4]),
                "attn_c2": mesh_smoke.train_case(dict(cases[5], table={})),
                "attn_c4_h2": mesh_smoke.train_case(dict(
                    _attn_c_case(jax_lm["dp2tp2"][0], 4, 2), table={}))}
    finally:
        torch.set_num_threads(threads)


def _close_cnn(got, want):
    _, losses, params = want
    np.testing.assert_allclose(got["losses"], losses, rtol=CNN_RTOL,
                               atol=CNN_ATOL)
    for op, g in params.items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       rtol=CNN_RTOL, atol=CNN_ATOL,
                                       err_msg=f"{op}.{k}")


def _close_lm(got, want):
    _, losses, params = want
    np.testing.assert_allclose(got["losses"], losses, rtol=LM_LOSS_RTOL)
    for op, g in params.items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       rtol=0, atol=LM_PARAM_ATOL,
                                       err_msg=f"{op}.{k}")


def _trees_equal(a, b):
    for op, g in a.items():
        for k, v in g.items():
            np.testing.assert_array_equal(v, b[op][k], err_msg=f"{op}.{k}")


@pytest.mark.parametrize("table", list(CNN_TABLES))
def test_cnn_tables_on_four_ranks_match_jax(world4, jax_cnn, table):
    for rank in world4:
        assert not rank[table]["jax_imported"]
        _close_cnn(rank[table], jax_cnn[table])
    _trees_equal(world4[0][table]["params"], world4[3][table]["params"])


@pytest.mark.parametrize("case", ["dp2", "tp2"])
def test_lm_on_two_ranks_matches_jax(world2, jax_lm, case):
    ranks, _ = world2
    for rank in ranks:
        _close_lm(rank[case], jax_lm[case])


def test_lm_dp2_tp2_on_four_ranks_matches_jax(world4, jax_lm):
    for rank in world4:
        _close_lm(rank["lm"], jax_lm["dp2tp2"])


def test_zero_equals_replicated_and_splits_moments(world2, world4):
    ranks, _ = world2
    for plain, zero in ((ranks[0]["dp2"], ranks[0]["dp2_zero"]),
                        (world4[0]["lm"], world4[0]["lm_zero"])):
        assert zero["losses"] == plain["losses"]
        _trees_equal(zero["params"], plain["params"])
        for k in ("m", "v"):
            _trees_equal(zero["moments"][k], plain["moments"][k])
    vocab, d = LM["vocab_size"], LM["d_model"]
    # dp 2: every moment's rows halved (lm_head's vocab rows included).
    assert ranks[0]["dp2_zero"]["moment_shapes"]["lm_head"]["kernel"] == \
        (vocab // 2, d)
    assert ranks[0]["dp2"]["moment_shapes"]["lm_head"]["kernel"] == (vocab, d)
    # dp 2 x tp 2: lm_head's rows split by tp, then by dp.
    assert world4[0]["lm_zero"]["moment_shapes"]["lm_head"]["kernel"] == \
        (vocab // 4, d)
    assert world4[0]["lm"]["moment_shapes"]["lm_head"]["kernel"] == \
        (vocab // 2, d)


def test_clip_norm_under_tp_equals_one_rank(world2, one_rank):
    ranks, _ = world2
    want = one_rank["tp2_clip"]
    for rank in ranks:
        got = rank["tp2_clip"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        assert got["losses"] != ranks[0]["tp2"]["losses"]  # the clip binds
        for op, g in want["params"].items():
            for k, v in g.items():
                np.testing.assert_allclose(got["params"][op][k], v, rtol=0,
                                           atol=1e-6)


@pytest.mark.parametrize("case", ["attn_c2", "attn_c4_h2"])
def test_attention_heads_split_over_c_equal_one_rank(world2, world4,
                                                     one_rank, case):
    """Attention at c=2 (each rank two of four heads, the output
    all-reduced) and at c=4 over two heads (the projections gathered,
    every head on each rank) equal one rank's run within 1e-6."""
    ranks = world2[0] if case == "attn_c2" else world4
    want = one_rank[case]
    for rank in ranks:
        got = rank[case]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for op, g in want["params"].items():
            for k, v in g.items():
                np.testing.assert_allclose(got["params"][op][k], v, rtol=0,
                                           atol=1e-6, err_msg=f"{op}.{k}")


def test_dropout_and_batchnorm_under_dp2_equal_one_rank(world2, one_rank):
    ranks, _ = world2
    want = one_rank["norm"]
    for rank in ranks:
        got = rank["norm"]
        np.testing.assert_array_equal(got["dropout_masks"]["drop"],
                                      want["dropout_masks"]["drop"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for op, g in want["params"].items():
            for k, v in g.items():
                np.testing.assert_allclose(got["params"][op][k], v,
                                           rtol=1e-6, atol=1e-7)


def test_kernel_wrappers_run_at_the_local_shapes(world2):
    """Under dp 2 each rank's attention goes through the flash dispatcher
    on (b/2, h, t, hd) and its cross-entropy through K3's wrapper on
    b/2 x t rows with the whole vocabulary (on CUDA tensors these are
    K1f, K1b and K3 at those shapes; the CPU runs their plain
    versions)."""
    ranks, _ = world2
    b, t, h = LM["batch_size"], LM["seq_len"], LM["num_heads"]
    hd = LM["d_model"] // h
    for rank in ranks:
        shapes = rank["dp2"]["kernel_shapes"]
        assert set(shapes["flash_attention_lse_auto"]) == \
            {(b // 2, h, t, hd)}
        assert set(shapes["softmax_xent"]) == \
            {(b // 2 * t, LM["vocab_size"])}
        assert len(shapes["flash_attention_lse_auto"]) == \
            LM["num_layers"] * STEPS


def test_world_of_one_equals_plain_executor_bit_for_bit():
    lm = _lm_case(None, 1, 1, 1)
    cnn = dict(model="small_cnn", batches=_cnn_batches(), params=None)
    cases = [lm, cnn]
    got = launch.run(RUN, (cases,), nprocs=1, device="cpu",
                     timeout_s=WORLD_S)[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = [mesh_smoke.train_case(c) for c in cases]
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(got, want):
        assert g["losses"] == w["losses"]
        _trees_equal(g["params"], w["params"])


_APP = ["-b", "4", "--seq", "32", "--layers", "2", "--vocab", "256",
        "--d-model", "64", "--heads", "4", "--optimizer", "adam", "--lr",
        "1e-3", "-i", "2"]


@pytest.mark.parametrize("table", [["--dp", "2"], ["--tp", "2"]])
def test_transformer_app_on_two_cpu_ranks_prints_one_report(capfd, table):
    """The app spawns its own world, prints one report and hands rank 0's
    stats (the global batch's losses and samples) to the caller."""
    stats = {}
    assert tapp.main(_APP + ["-ll:gpu", "2"] + table, device="cpu",
                     stats_out=stats) == 0
    out = capfd.readouterr().out
    assert out.count("THROUGHPUT = ") == 1 and out.count("tokens/s = ") == 1
    assert len(stats["step_losses"]) == 3
    assert np.isfinite(stats["step_losses"]).all()
    assert stats["batch_size"] == 4 and stats["iterations"] == 2
    assert "final" not in stats and "executor" not in stats


def test_default_run_stays_on_one_rank_on_a_two_card_host(monkeypatch):
    """Without ``-ll:gpu`` an app runs in its own process on a host with
    two cards; ``-ll:gpu 2`` takes both and ``-ll:gpu 4`` raises."""
    from flexflow_torch.apps import common

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def no_world(*a, **k):
        raise AssertionError("a default run started a world")

    monkeypatch.setattr(launch, "run", no_world)
    cfg = common.parse_training_args([])
    assert common.world_ranks(cfg, "cuda") == 1
    assert common.spawn_ranks(cfg, "flexflow_torch.apps.transformer:main",
                              [], "cuda") is None
    two = common.parse_training_args(["-ll:gpu", "2"])
    assert common.world_ranks(two, "cuda") == 2
    with pytest.raises(SystemExit, match="-ll:gpu 4: 2 CUDA devices"):
        common.world_ranks(common.parse_training_args(["-ll:gpu", "4"]),
                           "cuda")


def test_more_ranks_than_cards_raises():
    if torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are visible")
    with pytest.raises(SystemExit, match="-ll:gpu 4"):
        tapp.main(_APP + ["-ll:gpu", "4", "--dp", "4"])
    with pytest.raises(RuntimeError):
        launch.run("flexflow_torch.tools.mesh_smoke:fail_rank", (0,),
                   nprocs=4, device="cuda")


def test_a_failing_rank_fails_the_world():
    with pytest.raises(Exception, match="fails on purpose"):
        launch.run("flexflow_torch.tools.mesh_smoke:fail_rank", (1,),
                   nprocs=2, device="cpu", timeout_s=60)


def test_device_subset_table_names_the_pipeline():
    """``strategies/alexnet_readme_4dev.json`` pins ops to proper device
    subsets (``flat`` on [0, 2], ``linear3`` on [0]): layer-wise
    placement, which the plain Executor refuses naming the pipeline
    executor, as JAX's ``Executor`` refuses it."""
    from flexflow_torch.parallel.strategy import StrategyStore

    store = StrategyStore.load("strategies/alexnet_readme_4dev.json",
                               num_devices=4)
    with pytest.raises(ValueError, match="'flat'.*PipelineExecutor"):
        store.check_full_mesh()
    with pytest.raises(ValueError, match="places on devices"):
        JExecutor(_jax_cnn(), strategy=JStore(4, {"flat": JPC(
            n=2, device_ids=(0, 2))}), devices=jax.devices()[:4])
