"""The port's expert-parallel MoE across worlds of ranks, held against
the JAX package.

``tests/test_moe.py``'s model (an MoE over a float (8, 4, 8) input, 4
experts, ffn 16, a dense head of 4; SGD lr 0.05, three steps on numpy
batches) runs on one world of four gloo ranks under ``c = 2``, ``c = 4``
and ``n = 2 x c = 2``, top-1 and top-2, at capacity factor 8.0 (nothing
drops) and 0.5 (tokens drop), and JAX runs it on one device
(``tests/test_moe.py:124-135``, ``:293-305``): the losses and every
parameter within ``RTOL`` = 2e-4 / ``ATOL`` = 1e-5, the ``moe_dropped``
counts of every step equal.  The global routing is what makes them
equal: the planted fault ``ep_local_capacity`` (capacity and queues
from each rank's own tokens) drops other tokens than one device does.
The MoE LM under ``transformer_strategy(4, dp=2, tp=2, moe=True)`` (each
MoE op at n 2 x c 2, ``tests/test_distributed.py:147``'s table at 4
devices) against JAX's run of the same table; ``apps.transformer
--experts 4 --tp 2 -ll:gpu 2`` trains on two CPU ranks.  Under
``@pytest.mark.slow``: ``n = 2 x c = 4`` with the head at ``n = 8`` on
eight ranks, JAX's own table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_torch.apps import transformer as tapp
from flexflow_torch.models.transformer import transformer_strategy as tstrat
from flexflow_torch.parallel import launch
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.transformer import build_transformer_lm as jlm
from flexflow_tpu.models.transformer import transformer_strategy as jstrat
from flexflow_tpu.optim import AdamOptimizer as JAdam
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime.executor import Executor as JExecutor

RUN = "flexflow_torch.tools.mesh_smoke:run_cases"
WORLD_S = 240
RTOL, ATOL = 2e-4, 1e-5
LR = 0.05
LM_LR, LM_EPS = 1e-3, 1e-4
LM_LOSS_RTOL = 1e-5
LM = dict(batch_size=4, seq_len=8, vocab_size=64, d_model=16, num_heads=2,
          num_layers=1, moe_experts=4)
#: (name, top_k, capacity factor, {op: degrees}) on four ranks.
CASES = [
    ("top1_c2", 1, 0.5, {"moe": dict(c=2)}),
    ("top1_c4", 1, 8.0, {"moe": dict(c=4)}),
    ("top1_n2c2", 1, 0.5, {"moe": dict(n=2, c=2)}),
    ("top2_c2", 2, 8.0, {"moe": dict(c=2)}),
    ("top2_c4", 2, 0.5, {"moe": dict(c=4)}),
    ("top2_n2c2", 2, 0.5, {"moe": dict(n=2, c=2)}),
]


def _jax_moe(cf, top_k):
    ff = JModel(JConfig(batch_size=8, seed=3))
    x = ff.create_tensor((8, 4, 8), name="x", dim_axes=("n", "s", None))
    lbl = ff.create_tensor((8, 4), dtype=jnp.int32, name="lbl",
                           dim_axes=("n", "s"))
    t = ff.moe(x, 4, 16, capacity_factor=cf, top_k=top_k, name="moe")
    ff.softmax(ff.dense(t, 4, name="head"), lbl, name="softmax")
    return ff


def _batches():
    rng = np.random.default_rng(11)
    return [{"x": rng.standard_normal((8, 4, 8)).astype(np.float32),
             "lbl": rng.integers(0, 4, size=(8, 4)).astype(np.int32)}
            for _ in range(3)]


def _lm_batches():
    rng = np.random.default_rng(2)
    return [{k: rng.integers(0, LM["vocab_size"], (LM["batch_size"],
                                                   LM["seq_len"])).astype(
                np.int32) for k in ("tokens", "label")} for _ in range(3)]


def _jax_run(ff, store, n, opt, batches):
    ex = JExecutor(ff, strategy=store, optimizer=opt,
                   devices=jax.devices()[:n])
    params, opt_state, state = ex.init(seed=0)
    p0 = jax.device_get(params)
    losses, dropped = [], []
    for b in batches:
        params, opt_state, state, m = ex.train_step(
            params, opt_state, state, ex.shard_batch(b))
        losses.append(float(m["train_loss"]))
        dropped.append([float(v) for k, v in sorted(m.items())
                        if k.endswith("_dropped")])
    return dict(p0=p0, losses=losses, dropped=dropped,
                params=jax.device_get(params))


@pytest.fixture(scope="module")
def jax_runs():
    runs = {(k, cf): _jax_run(_jax_moe(cf, k), JStore(1), 1, JSGD(lr=LR),
                              _batches())
            for k in (1, 2) for cf in (0.5, 8.0)}
    ff = jlm(config=JConfig(batch_size=LM["batch_size"], seed=0), **LM)
    runs["lm"] = _jax_run(ff, jstrat(4, 1, dp=2, tp=2, moe=True), 4,
                          JAdam(lr=LM_LR, eps=LM_EPS), _lm_batches())
    return runs


def _case(p0, top_k, cf, table, **extra):
    return dict(model="moe", model_kw=dict(cf=cf, top_k=top_k), table=table,
                optimizer=("sgd", {"lr": LR, "momentum": 0.0}),
                batches=_batches(), params=p0, **extra)


@pytest.fixture(scope="module")
def world(jax_runs):
    names = [c[0] for c in CASES] + ["fault", "lm"]
    cases = [_case(jax_runs[(k, cf)]["p0"], k, cf, table)
             for _, k, cf, table in CASES]
    cases.append(_case(jax_runs[(1, 0.5)]["p0"], 1, 0.5,
                       {"moe": dict(n=2, c=2)}, fault="ep_local_capacity"))
    cases.append(dict(model="lm", model_kw=LM,
                      table={k: v.to_json() for k, v in tstrat(
                          4, 1, dp=2, tp=2, moe=True).table.items()},
                      optimizer=("adam", {"lr": LM_LR, "eps": LM_EPS}),
                      batches=_lm_batches(), params=jax_runs["lm"]["p0"]))
    out = launch.run(RUN, (cases,), nprocs=4, device="cpu",
                     timeout_s=WORLD_S)
    return [dict(zip(names, rank)) for rank in out]


def _dropped(got):
    return [[v for k, v in sorted(m.items()) if k.endswith("_dropped")]
            for m in got["metrics"]]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol,
                               atol=atol)
    for op, g in want["params"].items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{op}.{k}")


@pytest.mark.parametrize("name,top_k,cf,table", CASES,
                         ids=[c[0] for c in CASES])
def test_expert_parallel_matches_one_jax_device(world, jax_runs, name, top_k,
                                                cf, table):
    want = jax_runs[(top_k, cf)]
    for rank in world:
        got = rank[name]
        assert not got["jax_imported"]
        assert _dropped(got) == want["dropped"]
        _close(got, want)
        # Each rank holds its experts' rows only.
        c = table["moe"].get("c", 1)
        assert got["local_shapes"]["moe"]["w1"] == (4 // c, 8, 16)
    if cf < 1.0:
        assert all(d[0] > 0 for d in want["dropped"])


def test_local_capacity_fault_drops_other_tokens(world, jax_runs):
    """Routing each rank's tokens under its own capacity drops other
    tokens than JAX's one device: the drop counts differ and so do the
    parameters."""
    want = jax_runs[(1, 0.5)]
    for rank in world:
        got = rank["fault"]
        assert _dropped(got) != want["dropped"]
        with pytest.raises(AssertionError):
            _close(got, want)


def test_moe_lm_under_dp2_tp2_matches_jax(world, jax_runs):
    want = jax_runs["lm"]
    for rank in world:
        got = rank["lm"]
        assert _dropped(got) == want["dropped"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LM_LOSS_RTOL)
        for op, g in want["params"].items():
            for k, v in g.items():
                np.testing.assert_allclose(got["params"][op][k],
                                           np.asarray(v), rtol=0,
                                           atol=1e-2 * LM_LR,
                                           err_msg=f"{op}.{k}")


def test_transformer_app_trains_experts_under_tp_on_two_cpu_ranks(capfd):
    stats = {}
    assert tapp.main(["-b", "2", "--seq", "16", "--layers", "2", "--vocab",
                      "64", "--d-model", "16", "--heads", "2", "--optimizer",
                      "adam", "--lr", "1e-2", "--experts", "4", "-i", "2",
                      "-ll:gpu", "2", "--tp", "2"], device="cpu",
                     stats_out=stats) == 0
    assert capfd.readouterr().out.count("tokens/s = ") == 1
    assert np.isfinite(stats["step_losses"]).all()


@pytest.mark.slow
@pytest.mark.parametrize("top_k", [1, 2])
def test_eight_rank_expert_table_matches_one_jax_device(top_k):
    """JAX's own EP table (``moe`` n 2 x c 4, ``head`` n 8) on eight
    ranks."""
    want = _jax_run(_jax_moe(8.0, top_k), JStore(1), 1, JSGD(lr=LR),
                    _batches())
    table = {"moe": dict(n=2, c=4), "head": dict(n=8)}
    out = launch.run(RUN, ([_case(want["p0"], top_k, 8.0, table)],),
                     nprocs=8, device="cpu", timeout_s=WORLD_S)
    for rank in out:
        assert _dropped(rank[0]) == want["dropped"]
        _close(rank[0], want)
