"""The layer-wise pipeline's host side, held against the JAX package's
(``flexflow_tpu/runtime/pipeline.py``, ``tests/test_pipeline.py``): no
world of ranks here.

- ``derive_stages`` equal to JAX's on the two-stage MLP, the reference
  README's AlexNet table (``strategies/alexnet_readme_4dev.json``: GPU 0
  in five layers, ``[0, 2, 1, 3]`` its own stage), the unplaced op with
  two producers, overlapping stages (JAX's warning) and a device
  repeated inside one stage (refused).
- ``build_schedule`` equal to JAX's event list for S in 1..4 and m in
  1..8 under both schedules; 1f1b's dependency order, its live
  microbatches (at most ``S - si`` a stage, gpipe's ``m``) and its last
  stage alternating F and B (JAX's ``tests/test_pipeline.py:311-363``).
- ``check_stage_mesh_feasible`` and ``build_stage_mesh_plan`` equal to
  JAX's.
- ``make_executor``: the plain Executor for full-mesh tables (JAX's
  warning when explicit ids span the mesh), the pipeline for proper
  subsets, which needs a world; the plain Executor still refuses a
  subset; ``--zero-opt`` refused in JAX's words, ``chunk < 1`` refused,
  ``compiled`` on an ineligible table falling back loudly; the apps read
  ``--pipeline-chunk`` and ``--pipeline-compiled``.
- ``nmt_pipeline_strategy`` equal to JAX's table.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_torch.apps import alexnet as talex
from flexflow_torch.apps import nmt as tnmt
from flexflow_torch.config import FFConfig
from flexflow_torch.models.alexnet import build_alexnet as talexnet
from flexflow_torch.models.nmt import nmt_pipeline_strategy
from flexflow_torch.parallel.mesh import (
    InfeasibleStrategyError,
    build_stage_mesh_plan,
    check_stage_mesh_feasible,
)
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore
from flexflow_torch.runtime import pipeline as tpipe
from flexflow_torch.runtime.executor import Executor
from flexflow_torch.tools import mesh_pipeline as mp
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.alexnet import build_alexnet as jalexnet
from flexflow_tpu.models.nmt import nmt_pipeline_strategy as jnmt_pipe
from flexflow_tpu.parallel import mesh as jmesh
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime import pipeline as jpipe

README = "strategies/alexnet_readme_4dev.json"


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


def _jax_multi_input(batch=8):
    ff = JModel(JConfig(batch_size=batch))
    x = ff.create_tensor((batch, 8), name="x")
    lbl = ff.create_tensor((batch,), dtype=jnp.int32, name="label")
    a = ff.dense(x, 8, activation="relu", name="a")
    b = ff.dense(a, 8, activation="relu", name="b")
    t = ff.concat([b, a], axis=1, name="cat")
    t = ff.dense(t, 4, name="head")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _torch_multi_input(batch=8):
    import torch

    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch))
    x = ff.create_tensor((batch, 8), name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
    a = ff.dense(x, 8, activation="relu", name="a")
    b = ff.dense(a, 8, activation="relu", name="b")
    t = ff.concat([b, a], axis=1, name="cat")
    t = ff.dense(t, 4, name="head")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _tables(table, nd):
    """The same table as the port's and JAX's stores."""
    t = StrategyStore(nd, {k: ParallelConfig.from_json(v)
                           for k, v in table.items()})
    j = JStore(nd)
    for k, v in table.items():
        j.set(k, JPC.from_json(v))
    return t, j


def _two_stage_table(nd=8):
    enc, dec = list(range(nd // 2)), list(range(nd // 2, nd))
    out = {n: {"n": len(enc), "device_ids": enc} for n in ("enc0", "enc1")}
    out.update({n: {"n": len(dec), "device_ids": dec}
                for n in ("dec0", "dec1", "softmax")})
    return out


def _view(stages):
    return [(st.index, tuple(st.device_ids), [op.name for op in st.ops],
             list(st.in_names), list(st.out_names)) for st in stages]


def _readme():
    with open(README) as f:
        return json.load(f)["ops"]


@pytest.mark.parametrize("case", ["two_stage", "readme", "multi_input",
                                  "overlap"])
def test_derive_stages_matches_jax(case, caplog):
    if case == "two_stage":
        tf, jf, table, nd = mp.two_stage(), _jax_two_stage(), \
            _two_stage_table(), 8
    elif case == "readme":
        tf, jf = talexnet(batch_size=12, image_size=67, num_classes=10), \
            jalexnet(batch_size=12, image_size=67, num_classes=10)
        table, nd = _readme(), 4
    elif case == "multi_input":
        tf, jf, nd = _torch_multi_input(), _jax_multi_input(), 4
        table = {"a": {"n": 2, "device_ids": [0, 1]},
                 "b": {"n": 2, "device_ids": [2, 3]}}
    else:
        tf, jf, nd = mp.two_stage(), _jax_two_stage(), 8
        table = {"enc0": {"n": 4, "device_ids": [0, 1, 2, 3]},
                 "dec1": {"n": 4, "device_ids": [3, 4, 5, 6]}}
    ts, js = _tables(table, nd)
    with caplog.at_level(logging.WARNING, logger="ff.pipeline"):
        got = _view(tpipe.derive_stages(tf, ts))
    assert got == _view(jpipe.derive_stages(jf, js))
    if case == "readme":
        assert [s[1] for s in got] == [(0, 1, 2, 3), (0, 2, 1, 3), (0, 2),
                                      (0, 2, 3), (0, 1, 2), (0,)]
        assert got[-1][2] == ["linear3", "softmax"]
    if case == "multi_input":
        assert got[1][2] == ["b", "cat", "head", "softmax"]
    if case in ("readme", "overlap"):
        assert any("overlap" in r.message for r in caplog.records)


def test_duplicate_device_in_one_stage_refused():
    ts, js = _tables({"enc0": {"n": 2, "device_ids": [0, 0]}}, 8)
    with pytest.raises(tpipe.PlacementError, match="repeats a device"):
        tpipe.derive_stages(mp.two_stage(), ts)
    with pytest.raises(jpipe.PlacementError, match="repeats a device"):
        jpipe.derive_stages(_jax_two_stage(), js)


@pytest.fixture(scope="module")
def jax_schedules():
    ff = _jax_two_stage()
    _, js = _tables(_two_stage_table(), 8)
    return {kind: jpipe.PipelineExecutor(ff, js, schedule=kind)
            for kind in ("1f1b", "gpipe")}


@pytest.mark.parametrize("kind", ["1f1b", "gpipe"])
def test_build_schedule_matches_jax(jax_schedules, kind):
    for S in range(1, 5):
        for m in range(1, 9):
            assert tpipe.build_schedule(kind, S, m) == \
                jax_schedules[kind].build_schedule(S, m), (kind, S, m)


def test_1f1b_schedule_is_dependency_valid():
    for S, m in [(2, 1), (2, 4), (4, 4), (4, 8), (3, 5)]:
        ev = tpipe.build_schedule("1f1b", S, m)
        assert sorted(ev) == sorted(
            [("F", si, mi) for si in range(S) for mi in range(m)]
            + [("B", si, mi) for si in range(S) for mi in range(m)])
        pos = {e: i for i, e in enumerate(ev)}
        for kind, si, mi in ev:
            if kind == "F" and si > 0:
                assert pos[("F", si - 1, mi)] < pos[("F", si, mi)]
            if kind == "B":
                assert pos[("F", si, mi)] < pos[("B", si, mi)]
                if si < S - 1:
                    assert pos[("B", si + 1, mi)] < pos[("B", si, mi)]


def _peaks(ev, S):
    live, peak = [0] * S, [0] * S
    for kind, si, _ in ev:
        live[si] += 1 if kind == "F" else -1
        peak[si] = max(peak[si], live[si])
    return peak


def test_1f1b_bounds_live_microbatches():
    S, m = 4, 8
    peak = _peaks(tpipe.build_schedule("1f1b", S, m), S)
    assert all(peak[si] <= S - si for si in range(S)), peak
    assert _peaks(tpipe.build_schedule("gpipe", S, m), S) == [m] * S
    last = [e for e in tpipe.build_schedule("1f1b", 4, 4) if e[1] == 3]
    assert last == [(k, 3, mi) for mi in range(4) for k in ("F", "B")]
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        tpipe.build_schedule("zigzag", 2, 2)


@pytest.mark.parametrize("ids", [[(0, 1), (2, 3)], [(0, 1, 2, 3),
                                                    (4, 5, 6, 7)],
                                 [(0,), (1,)], [(0, 1, 2), (3, 4, 5)]])
def test_stage_mesh_plan_matches_jax(ids):
    got = build_stage_mesh_plan(ids)
    want = jmesh.build_stage_mesh_plan(ids, devices=jax.devices())
    assert (got.axis_names, got.axis_sizes) == (want.axis_names,
                                                want.axis_sizes)
    assert got.axis_names[0].startswith("s")


@pytest.mark.parametrize("ids,why", [([(0, 1), (2,)], "equal-size"),
                                     ([(0, 1), (1, 2)], "disjoint")])
def test_stage_mesh_infeasible_like_jax(ids, why):
    with pytest.raises(InfeasibleStrategyError, match=why):
        check_stage_mesh_feasible(ids)
    with pytest.raises(jmesh.InfeasibleStrategyError, match=why):
        jmesh.check_stage_mesh_feasible(ids)


def test_make_executor_dispatch(caplog):
    ff = mp.two_stage()
    ex = tpipe.make_executor(ff, StrategyStore.data_parallel(1),
                             device="cpu", microbatches=4)
    assert type(ex) is Executor
    full = StrategyStore(1, {"enc0": ParallelConfig(device_ids=(0,))})
    with caplog.at_level(logging.WARNING, logger="ff.pipeline"):
        assert type(tpipe.make_executor(ff, full, device="cpu")) is Executor
    assert any("span the full mesh" in r.message for r in caplog.records)
    ts, _ = _tables(_two_stage_table(4), 4)
    with pytest.raises(tpipe.PlacementError, match="-ll:gpu 4"):
        tpipe.make_executor(ff, ts, device="cpu", microbatches=2)


def test_executor_still_refuses_subsets():
    ts, js = _tables(_two_stage_table(), 8)
    with pytest.raises(ValueError, match="'dec0'.*PipelineExecutor"):
        Executor(mp.two_stage(), strategy=ts, device="cpu")
    with pytest.raises(ValueError, match="PipelineExecutor"):
        jpipe.Executor(_jax_two_stage(), strategy=js)


def test_refusals_name_jax_words_and_item_10b(caplog):
    """Item 10b landed: ``--zero-opt`` stays refused in JAX's words, a
    chunk below 1 is refused, and a table the compiled step cannot run
    falls back loudly to the host-driven pipeline (which then needs its
    world), as JAX's ``make_executor`` does."""
    ff = mp.two_stage()
    ts, _ = _tables(_two_stage_table(4), 4)
    cfg = FFConfig(batch_size=8, zero_sharded_optimizer=True)
    with pytest.raises(tpipe.PlacementError,
                       match="--zero-opt supports the full-mesh Executor"):
        tpipe.PipelineExecutor(ff, ts, config=cfg)
    with pytest.raises(ValueError, match="pipeline chunk must be >= 1"):
        tpipe.make_executor(ff, ts, chunk=0)
    unequal, _ = _tables({"enc0": {"n": 2, "device_ids": [0, 1]},
                          "dec0": {"device_ids": [2]}}, 4)
    with caplog.at_level(logging.WARNING, logger="ff.pipeline"):
        with pytest.raises(tpipe.PlacementError, match="-ll:gpu 4"):
            tpipe.make_executor(ff, unequal, compiled=True)
    assert any("--pipeline-compiled unavailable for this model/strategy "
               "(compiled pipeline step: shared stage mesh needs equal-size"
               in r.message and "falling back to the host-driven pipeline"
               in r.message for r in caplog.records)


@pytest.mark.parametrize("flag", [["--pipeline-chunk", "2"],
                                  ["--pipeline-compiled"]])
def test_apps_refuse_chunk_and_compiled(flag):
    """The flags are read since item 10b; on one rank each app then
    refuses for its table's own reason."""
    from flexflow_torch.apps.common import parse_training_args

    cfg = parse_training_args(["-b", "4"] + flag)
    assert (cfg.pipeline_chunk, cfg.pipeline_compiled) == (
        (2, False) if "--pipeline-chunk" in flag else (1, True))
    with pytest.raises(SystemExit, match="only 1 devices exist.*-ll:gpu 4"):
        talex.main(["-b", "4", "--image-size", "67", "-s", README]
                   + flag, device="cpu")
    with pytest.raises(SystemExit, match="even device count"):
        tnmt.main(["--pipeline", "-b", "4"] + flag, device="cpu")


def test_nmt_pipeline_strategy_matches_jax():
    for nd, layers in ((2, 2), (4, 2), (8, 3)):
        got = nmt_pipeline_strategy(nd, num_layers=layers)
        want = jnmt_pipe(nd, num_layers=layers)
        assert got.num_devices == want.num_devices
        assert {k: v.to_json() for k, v in got.table.items()} == \
            {k: v.to_json() for k, v in want.table.items()}
    with pytest.raises(ValueError, match="even device count"):
        nmt_pipeline_strategy(3)


def test_readme_table_needs_four_ranks():
    """Without ``-ll:gpu 4`` the README table names the ranks it needs."""
    with pytest.raises(SystemExit, match="only 1 devices exist.*-ll:gpu 4"):
        talex.main(["-b", "4", "--image-size", "67", "-s", README],
                   device="cpu")
    np.testing.assert_equal(len(_readme()), 9)
