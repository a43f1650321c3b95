"""The port's Candle-Uno (``flexflow_torch/models/candle_uno.py``) and
``apps.candle_uno``, held against the JAX package on the CPU.

The model at ``tests/test_models.py``'s small widths (towers of 16, a
32-32 trunk, features 1/24/40/16, batch 8), f32: JAX's parameters carried
across with ``params_from_numpy``, both packages on the same numpy
batches.  Bars: three SGD steps' losses within ``LOSS_TOL`` = 1e-5 and
every parameter within ``PARAM_TOL`` = 1e-5 after them; the graph, its
parameter shapes and ``summary()`` equal JAX's.
"""

import contextlib
import io

import jax
import numpy as np
import pytest

from flexflow_tpu import optim as joptim
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.candle_uno import CandleConfig as JCandle
from flexflow_tpu.models.candle_uno import build_candle_uno as jbuild
from flexflow_tpu.models.candle_uno import candle_uno_strategy as jstrategy
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_torch import optim as toptim
from flexflow_torch.apps import candle_uno as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.models import CandleConfig, build_candle_uno
from flexflow_torch.models.candle_uno import candle_uno_strategy
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.weights import params_from_numpy

LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
B, LR = 8, 0.05
SMALL = dict(dense_layers=[32, 32], dense_feature_layers=[16],
             feature_shapes={"dose": 1, "cell.rnaseq": 24,
                             "drug.descriptors": 40, "drug.fingerprints": 16})


def _builds():
    jff = jbuild(batch_size=B, candle=JCandle(**SMALL),
                 config=JConfig(batch_size=B, seed=0))
    tff = build_candle_uno(batch_size=B, candle=CandleConfig(**SMALL),
                           config=TConfig(batch_size=B, seed=0))
    return jff, tff


def test_candle_graph_matches_jax():
    jff, tff = _builds()
    assert tff.summary() == jff.summary()
    assert len(tff.input_tensors) == 7
    for jop, top in zip(jff.layers, tff.layers):
        assert {k: s.shape for k, s in jop.param_specs().items()} == \
            {k: s.shape for k, s in top.param_specs().items()}
    full_j = jbuild(batch_size=512, config=JConfig(batch_size=512))
    full_t = build_candle_uno(batch_size=512, config=TConfig(batch_size=512))
    assert full_t.summary() == full_j.summary()


def test_candle_sgd_trajectory_matches_jax():
    jff, tff = _builds()
    jex = JExecutor(jff, config=jff.config,
                    optimizer=joptim.SGDOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    params, opt, state = jex.init(seed=0)
    start = jax.device_get(params)
    batches = [synthetic_host_batch(tff, np.random.default_rng(s))
               for s in (1, 2, 3)]
    jl = []
    for b in batches:
        params, opt, state, m = jex.train_step(params, opt, state,
                                               jex.shard_batch(b))
        jl.append(float(m["train_loss"]))
    tex = TExecutor(tff, config=tff.config,
                    optimizer=toptim.SGDOptimizer(lr=LR), device="cpu")
    tp = params_from_numpy(start, device="cpu")
    to, ts, tl = tex.optimizer.init(tp), {}, []
    for b in batches:
        tp, to, ts, m = tex.train_step(tp, to, ts, b)
        tl.append(float(m["train_loss"]))
    assert max(abs(a - b) for a, b in zip(tl, jl)) <= LOSS_TOL
    for op, group in jax.device_get(params).items():
        for k, want in group.items():
            err = float(np.abs(tp[op][k].detach().numpy() - want).max())
            assert err <= PARAM_TOL, (op, k, err)


def test_candle_config_parse_args():
    argv = ["-b", "4", "--dense-layers", "8-4", "--dense-feature-layers",
            "16-16-2"]
    got, want = CandleConfig.parse_args(argv), JCandle.parse_args(argv)
    assert got.dense_layers == want.dense_layers == [8, 4]
    assert got.dense_feature_layers == want.dense_feature_layers == [16, 16, 2]
    assert CandleConfig.parse_args([]) == CandleConfig()
    assert CandleConfig().feature_shapes == JCandle().feature_shapes
    with pytest.raises(ValueError, match="expects a value"):
        CandleConfig.parse_args(["--dense-layers"])


def test_candle_strategy_one_device():
    store = candle_uno_strategy(1)
    want = jstrategy(1)
    assert sorted(store.table) == sorted(want.table) == \
        ["trunk_dense0", "trunk_dense1", "trunk_dense2"]
    assert all(pc.n == pc.c == 1 == pc.num_parts
               for pc in store.table.values())
    # More devices give JAX's n x c trunk (it ran refused before item 9d).
    for n in (2, 4, 8):
        assert {k: v.to_json() for k, v in candle_uno_strategy(n).table.items()} \
            == {k: v.to_json() for k, v in jstrategy(n).table.items()}
    assert candle_uno_strategy(4).table["trunk_dense0"].c == 2


_APP = ["-b", "8", "--dense-layers", "32-32", "--dense-feature-layers",
        "16", "--optimizer", "sgd", "--lr", "0.01", "--momentum", "0",
        "--wd", "0"]


@pytest.mark.parametrize("flags", [[], ["--steps-per-call", "2"],
                                   ["--accum-steps", "2", "--remat"]])
def test_candle_app_on_cpu(flags):
    stats = {}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tapp.main(_APP + ["-i", "4"] + flags, device="cpu",
                         stats_out=stats) == 0
    assert "THROUGHPUT" in out.getvalue()
    losses = stats["step_losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    tower = stats["final"][0]["tower_cell_rnaseq_dense0"]["kernel"]
    assert tuple(tower.shape) == (16, 942)


@pytest.mark.parametrize("flag,msg", [
    (["-d", "csvs"], "item 12"), (["--elastic"], "item 13"),
    (["--granules", "2"], "granules"), (["--stream-dataset"], "item 12"),
    (["-s", "auto"], "item 11"), (["--search", "5"], "item 11"),
    (["--dense-layers", "a-b"], "invalid")])
def test_candle_app_refuses(flag, msg):
    with pytest.raises(SystemExit, match=msg):
        tapp.main(_APP + flag, device="cpu")
