"""The pipeline's per-stage row-sparse carry on a world of four gloo
ranks (JAX's ``tests/test_pipeline_sparse.py``), and its snapshots.

The model is JAX's: an embedding (96 x 8, bags of 4) on ranks {0, 1}, two
dense layers and the loss on {2, 3}, batch 16 in four microbatches.

- The gate: the embedding stage takes the row path under plain SGD and
  the lazy optimizers, not with the dense config nor momentum SGD.
- Sparse and dense: with globally unique ids every row is touched once,
  so the row update is the dense one bit for bit; with duplicate ids
  within ``rtol=1e-6``; the duplicate-id sparse run, lazy momentum and
  lazy Adam against JAX's pipeline within JAX's bars.
- Schedule invariance: 1f1b and gpipe bit for bit.
- ``--clip-norm``: the unique-row squares in the global norm: sparse
  against dense within ``rtol=1e-6``, and the clip engaged.
- Lazy momentum: rows no microbatch touched keep their initial values.
- Snapshots: the pipeline's (lazy Adam, three steps) restored under one
  executor bit for bit, and one executor's restored under the pipeline
  and saved again, every tensor of both files the same.
- Chunked and compiled (JAX's ``tests/test_pipeline_sparse.py:186-264``):
  the row carry at c = 2 and 4, on the compiled step, under
  ``--clip-norm`` and with the lazy optimizers, each bit for bit the
  ``c = 1`` loop.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_torch.optim import AdamOptimizer, SGDOptimizer
from flexflow_torch.parallel import launch
from flexflow_torch.runtime.checkpoint import CheckpointManager
from flexflow_torch.runtime.executor import Executor
from flexflow_torch.tools import mesh_pipeline as mp
from flexflow_torch.weights import params_from_numpy
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.optim import AdamOptimizer as JAdam
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime.pipeline import PipelineExecutor as JPipe

RUN = "flexflow_torch.tools.mesh_pipeline:world_cases"
RANKS = 4
VOCAB, BAG, BATCH, M = 96, 4, 16, 4
TABLE = {"emb": {"n": 2, "device_ids": [0, 1]},
         **{n: {"n": 2, "device_ids": [2, 3]}
            for n in ("fc1", "fc2", "softmax")}}
OPTS = {"sgd": ("sgd", {"lr": 0.1}),
        "mom": ("sgd", {"lr": 0.1, "momentum": 0.9}),
        "lazy_mom": ("sgd", {"lr": 0.1, "momentum": 0.9,
                             "lazy_sparse": True}),
        "lazy_adam": ("adam", {"lr": 0.05, "lazy_sparse": True})}
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)


def _batches(n, seed=0, unique=False, high=VOCAB):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = (rng.permutation(VOCAB)[:BATCH * BAG].reshape(BATCH, BAG)
               if unique else rng.integers(0, high, (BATCH, BAG)))
        out.append({"ids": ids.astype(np.int32),
                    "label": rng.integers(0, 4, (BATCH,)).astype(np.int32)})
    return out


def _jax_model(sparse=True):
    ff = JModel(JConfig(batch_size=BATCH, sparse_embedding_updates=sparse))
    ids = ff.create_tensor((BATCH, BAG), dtype=jnp.int32, name="ids")
    lbl = ff.create_tensor((BATCH,), dtype=jnp.int32, name="label")
    t = ff.embedding(ids, VOCAB, 8, aggr="sum", name="emb")
    t = ff.dense(t, 16, activation="relu", name="fc1")
    t = ff.dense(t, 4, activation=None, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _jax_opt(kind):
    name, kw = OPTS[kind]
    return (JAdam if name == "adam" else JSGD)(**kw)


def _jax_run(kind, batches):
    store = JStore(RANKS)
    for k, v in TABLE.items():
        store.set(k, JPC.from_json(v))
    ff = _jax_model()
    pipe = JPipe(ff, store, config=ff.config, optimizer=_jax_opt(kind),
                 microbatches=M, devices=jax.devices()[:RANKS])
    pp, po, ps = pipe.init(seed=0)
    p0 = jax.device_get(pp)
    losses = []
    for b in batches:
        pp, po, ps, met = pipe.train_step(pp, po, ps, pipe.shard_batch(b))
        losses.append(float(jax.device_get(met["train_loss"])))
    return dict(p0=p0, losses=losses,
                params={op: g for t in jax.device_get(pp).values()
                        for op, g in t.items()})


@pytest.fixture(scope="module")
def jax_runs():
    dup = _batches(3, seed=1)
    return {kind: _jax_run(kind, dup) for kind in ("sgd", "lazy_mom",
                                                   "lazy_adam")}


def _one(kind):
    name, kw = OPTS[kind]
    ff = mp.emb()
    return Executor(ff, optimizer=(AdamOptimizer if name == "adam"
                                   else SGDOptimizer)(**kw), device="cpu")


@pytest.fixture(scope="module")
def one_snapshot(tmp_path_factory, jax_runs):
    """One executor's snapshot (lazy Adam, one step from JAX's params)."""
    d = str(tmp_path_factory.mktemp("one"))
    ex = _one("lazy_adam")
    params = params_from_numpy({op: g for t in jax_runs["sgd"]["p0"].values()
                                for op, g in t.items()}, "cpu")
    opt_state, state = ex.optimizer.init(params), {}
    params, opt_state, state, _ = ex.train_step(
        params, opt_state, state, ex.shard_batch(_batches(1, seed=9)[0]))
    with CheckpointManager(d) as ck:
        ck.save(1, params, opt_state, state)
    return d


@pytest.fixture(scope="module")
def world(jax_runs, one_snapshot, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipe"))
    p0 = jax_runs["sgd"]["p0"]
    uniq, dup = _batches(3, unique=True), _batches(3, seed=1)
    cold = _batches(2, seed=7, high=8)

    def case(name, kind="sgd", batches=dup, **kw):
        return dict(name=name, model="emb", table=TABLE, params=p0,
                    batches=batches, optimizer=OPTS[kind], microbatches=M,
                    **kw)

    cases = [
        case("uniq_sparse", batches=uniq),
        case("uniq_dense", batches=uniq, model_kw={"sparse": False}),
        case("dup_sparse"),
        case("dup_dense", model_kw={"sparse": False}),
        case("dup_gpipe", schedule="gpipe"),
        case("gate_mom", kind="mom", batches=[]),
        case("clip_sparse", config={"clip_norm": 0.01}),
        case("clip_dense", config={"clip_norm": 0.01},
             model_kw={"sparse": False}),
        case("lazy_mom", kind="lazy_mom"),
        case("lazy_adam", kind="lazy_adam",
             snapshot=os.path.join(root, "pipe")),
        case("cold", kind="lazy_mom", batches=cold),
        case("restore_one", kind="lazy_adam", batches=[],
             restore=one_snapshot, snapshot=os.path.join(root, "again")),
    ]
    for tag, seed, kind, cfg in (("chunk", 2, "sgd", {}),
                                 ("comp", 5, "sgd", {}),
                                 ("clip", 3, "sgd", {"clip_norm": 0.5}),
                                 ("lazy_mom", 6, "lazy_mom", {}),
                                 ("lazy_adam", 6, "lazy_adam", {})):
        bs = _batches(2, seed=seed)
        cases += [case(f"{tag}_c1", kind=kind, batches=bs, config=cfg),
                  case(f"{tag}_c2", kind=kind, batches=bs, config=cfg,
                       chunk=2),
                  case(f"{tag}_c4", kind=kind, batches=bs, config=cfg,
                       chunk=4),
                  case(f"{tag}_compiled", kind=kind, batches=bs, config=cfg,
                       compiled=True)]
    ranks = launch.run(RUN, (cases,), nprocs=RANKS, device="cpu",
                       timeout_s=300)
    out = [{c["name"]: r for c, r in zip(cases, rank)} for rank in ranks]
    out[0]["_root"] = root
    return out


def _same(a, b):
    assert a["losses"] == b["losses"]
    for op, g in a["params"].items():
        for k, v in g.items():
            np.testing.assert_array_equal(v, b["params"][op][k],
                                          err_msg=f"{op}.{k}")


def _close(a, b, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=rtol)
    for op, g in a["params"].items():
        for k, v in g.items():
            np.testing.assert_allclose(v, b["params"][op][k], rtol=rtol,
                                       atol=atol, err_msg=f"{op}.{k}")


def test_stage_sparse_gate(world):
    for r, rank in enumerate(world):
        want = {0: ["emb"]} if r < 2 else {1: []}
        assert rank["dup_sparse"]["sparse"] == want
        assert rank["lazy_adam"]["sparse"] == want
        assert all(not v for v in rank["dup_dense"]["sparse"].values())
        assert all(not v for v in rank["gate_mom"]["sparse"].values())


def test_sparse_matches_dense_unique_ids_bit_for_bit(world):
    _same(world[0]["uniq_sparse"], world[0]["uniq_dense"])


def test_sparse_matches_dense_duplicate_ids(world):
    _close(world[0]["dup_sparse"], world[0]["dup_dense"])


@pytest.mark.parametrize("kind,case", [("sgd", "dup_sparse"),
                                       ("lazy_mom", "lazy_mom"),
                                       ("lazy_adam", "lazy_adam")])
def test_sparse_matches_jax(world, jax_runs, kind, case):
    got, want = world[0][case], jax_runs[kind]
    assert not got["jax_imported"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    for op, g in want["params"].items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       err_msg=f"{op}.{k}", **PARAM_TOL)


def test_sparse_schedule_invariant(world):
    for rank in world:
        assert rank["dup_gpipe"]["losses"] == rank["dup_sparse"]["losses"]
    _same(world[0]["dup_gpipe"], world[0]["dup_sparse"])


def test_clip_norm_sparse(world):
    _close(world[0]["clip_sparse"], world[0]["clip_dense"])
    assert not np.array_equal(world[0]["clip_sparse"]["params"]["emb"]
                              ["table"], world[0]["dup_sparse"]["params"]
                              ["emb"]["table"])


def test_lazy_cold_rows_frozen(world, jax_runs):
    p0 = jax_runs["sgd"]["p0"][0]["emb"]["table"]
    table = world[0]["cold"]["params"]["emb"]["table"]
    np.testing.assert_array_equal(table[8:], p0[8:])
    assert not np.array_equal(table[:8], p0[:8])


def _flat_file(d, step):
    out = {}
    for item in ("params", "opt_state", "state"):
        path = os.path.join(d, str(step), item, "tensors.pt")
        if os.path.exists(path):
            out[item] = torch.load(path, weights_only=True)
    return out


def test_pipeline_snapshot_restores_under_one_executor(world):
    d = os.path.join(world[0]["_root"], "pipe")
    ex = _one("lazy_adam")
    with CheckpointManager(d) as ck:
        step, params, opt_state, _ = ck.restore(ex.init())
    assert step == 3 and int(opt_state["t"]) == 3
    want = world[0]["lazy_adam"]["params"]
    for op, g in want.items():
        for k, v in g.items():
            np.testing.assert_array_equal(params[op][k].detach().numpy(), v,
                                          err_msg=f"{op}.{k}")


def test_one_executor_snapshot_restores_under_pipeline(world, one_snapshot):
    got = world[0]["restore_one"]
    assert got["restored_step"] == 1
    a = _flat_file(one_snapshot, 1)
    b = _flat_file(os.path.join(world[0]["_root"], "again"), 0)
    assert a.keys() == b.keys() and set(a["opt_state"]) == \
        set(b["opt_state"]) and set(a["params"]) == set(b["params"])
    for item, flat in a.items():
        for k, v in flat.items():
            assert torch.equal(v, b[item][k]), (item, k)
    for op, g in got["params"].items():
        for k, v in g.items():
            np.testing.assert_array_equal(v, a["params"][f"{op}/{k}"]
                                          .float().numpy())


@pytest.mark.parametrize("tag", ["chunk", "comp", "clip", "lazy_mom",
                                 "lazy_adam"])
@pytest.mark.parametrize("form", ["c2", "c4", "compiled"])
def test_chunked_and_compiled_sparse_bit_for_bit(world, tag, form):
    """JAX's ``test_chunked_sparse_bit_identical``,
    ``test_compiled_sparse_bit_identical``,
    ``test_clip_norm_sparse_chunk_invariant``,
    ``test_compiled_clip_norm_sparse`` and
    ``test_lazy_sparse_chunk_and_compiled_invariant``: the row carry
    flattened in microbatch order whatever the chunk, the compiled step's
    tail the host-driven one's."""
    got, ref = world[0][f"{tag}_{form}"], world[0][f"{tag}_c1"]
    for r, rank in enumerate(world):
        assert rank[f"{tag}_{form}"]["compiled"] is (form == "compiled")
        want = {0: ["emb"]} if r < 2 else {1: []}
        assert rank[f"{tag}_{form}"]["sparse"] == want
    _same(got, ref)
