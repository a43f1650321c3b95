"""Row-sharded embedding tables and the row-sparse step across worlds of
ranks (``ops/embedding.py``, ``runtime/executor.py``) held against the
JAX package's runs.

The windowed row kernels' plain versions (K4 and K5 with ``row_start``)
are held against their unwindowed forms and against JAX's
``_sharded_gather`` and ``_sharded_scatter_add`` on its 4-device CPU
mesh.  One world of 4 runs every training case through
``flexflow_torch.tools.mesh_smoke.run_cases`` (gloo, CPU ranks of one
thread; initial parameters from JAX's init through numpy, batches drawn
from a numpy seed):

- JAX's sharded-embedding model (``tests/test_sharding_equivalence.py``:
  vocab 64, bag 4, momentum SGD, so the dense path) at ``{"emb": n=2,
  c=2}``, ``{"emb": n=1, c=4}`` and a hybrid with ``fc1`` at n=2 c=2,
  against the world of 1 and JAX's 4-device run at ``RTOL``; at n=2 c=1
  against n=2 c=2 bit for bit (both reduce the table's gradient over the
  same two batch blocks, and the masked rows add exact zeros);
- lazy Adam over the table at c=2 against the port's unsharded lazy Adam
  bit for bit, and against JAX's one-device lazy Adam at ``RTOL`` (not
  JAX's sharded run, which differs from its own unsharded one by 8 ULP:
  ROADMAP.md queue 3); with ZeRO-1 within 1e-6 of it without, and
  JAX's ZeRO-1 run at ``RTOL``;
- plain SGD on the row-sparse path with the table replicated under DP 4
  (every replica the same bits, the world of 1 within ``RTOL``), and at
  c=2 with ``--clip-norm`` (the world of 1 within ``RTOL``);
- ``MultiEmbedding`` at c=2 and c=4, ``HeteroEmbedding`` at c=4 over 20
  rows and over 18 (which c=4 does not divide: replicated), and
  ``WordEmbedding(shard_rows=True)`` at c=4, against JAX at ``RTOL``.

One world of 2 runs the DLRM app (``mesh_smoke.dlrm_app``: the app on
each rank, ``-ll:gpu 2``) from JAX's initial parameters: the tables
sharded by ``dlrm_strategy`` equal the replicated ones (``-s``, n=2 c=1)
bit for bit under plain SGD and lazy Adam, the losses equal JAX's
``build_dlrm`` on two devices at ``RTOL``, and each planted fault of
``chip_smoke.py``'s phase 28 (c) breaks the equality.  ``dlrm_strategy``
is JAX's for every case of ``DLRM_STRATEGY_CASES``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_torch.models.dlrm import DLRMConfig, dlrm_strategy
from flexflow_torch.ops import kernels
from flexflow_torch.parallel import launch
from flexflow_torch.tools import mesh_smoke
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.dlrm import DLRMConfig as JDLRMConfig
from flexflow_tpu.models.dlrm import build_dlrm as jbuild_dlrm
from flexflow_tpu.models.dlrm import dlrm_strategy as jdlrm_strategy
from flexflow_tpu.ops import embedding as jemb
from flexflow_tpu.optim import AdamOptimizer as JAdam
from flexflow_tpu.optim import SGDOptimizer as JSGD
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime.executor import Executor as JExecutor

WORLD_S = 240
STEPS = 3
#: Port against JAX, and a world against the world of 1: f32 sums of the
#: dense layers taken in other orders.
RTOL = 1e-5
VOCAB = 64
SGD = ("sgd", {"lr": 0.05, "momentum": 0.9})
SGD0 = ("sgd", {"lr": 0.05})
LAZY = ("adam", {"lr": 0.05, "lazy_sparse": True})
#: (kind, ids width, id bound) of the table models (``mesh_smoke.TABLES``).
TABLE_IDS = {"multi": (4, 16), "hetero": (3, 3), "hetero18": (3, 3),
             "word": (4, 64)}


# -- JAX's side ---------------------------------------------------------------


def _jax_emb_model(batch=8):
    ff = JModel(JConfig(batch_size=batch, seed=7, shard_embeddings=True))
    ids = ff.create_tensor((batch, 4), dtype=jnp.int32, name="ids")
    lbl = ff.create_tensor((batch,), dtype=jnp.int32, name="lbl")
    t = ff.embedding(ids, VOCAB, 8, aggr="sum", name="emb")
    t = ff.dense(t, 16, activation="relu", name="fc1")
    t = ff.dense(t, 4, activation=None, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _jax_table_model(kind, batch=8):
    k, _ = TABLE_IDS[kind]
    ff = JModel(JConfig(batch_size=batch, seed=5))
    ids = ff.create_tensor((batch, k), dtype=jnp.int32, name="ids")
    lbl = ff.create_tensor((batch,), dtype=jnp.int32, name="lbl")
    if kind == "multi":
        t = ff.multi_embedding(ids, 4, 16, 8, name="emb")
    elif kind == "word":
        t = ff.word_embedding(ids, 64, 8, name="emb", shard_rows=True)
    else:
        t = ff.hetero_embedding(ids, (5, 9, 3), 8, name="emb",
                                pad_to=4 if kind == "hetero" else 2)
    t = ff.reshape(t, (batch, k * 8), name="rows")
    t = ff.dense(t, 4, activation=None, name="fc")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _batches(k=4, high=VOCAB, seed=42):
    rng = np.random.default_rng(seed)
    return [{"ids": rng.integers(0, high, size=(8, k)).astype(np.int32),
             "lbl": rng.integers(0, 4, size=(8,)).astype(np.int32)}
            for _ in range(STEPS)]


def _table_batches(kind):
    return _batches(*TABLE_IDS[kind], seed=11)


def _jopt(opt):
    name, kw = opt
    return (JAdam if name == "adam" else JSGD)(**kw)


def _jax_run(ff, table, n, opt, batches, zero=False):
    """JAX's initial params (numpy), losses and final params (numpy) on
    its first ``n`` CPU devices."""
    ff.config.zero_sharded_optimizer = zero
    ex = JExecutor(ff, strategy=JStore(n, {k: JPC(**v)
                                           for k, v in table.items()}),
                   optimizer=_jopt(opt), devices=jax.devices()[:n])
    params, opt_state, state = ex.init()
    p0 = jax.device_get(params)
    losses = []
    for b in batches:
        params, opt_state, state, m = ex.train_step(
            params, opt_state, state, ex.shard_batch(b))
        losses.append(float(m["train_loss"]))
    return p0, losses, jax.device_get(params)


EMB_TABLES = {
    "n2c2": {"emb": dict(n=2, c=2)},
    "n1c4": {"emb": dict(n=1, c=4)},
    "n2c1": {"emb": dict(n=2, c=1)},
    "hybrid": {"emb": dict(n=2, c=2), "fc1": dict(n=2, c=2)},
}
#: The table models' placements on the world of 4: (kind, c).
TABLE_CASES = [("multi", 2), ("multi", 4), ("hetero", 4), ("hetero18", 4),
               ("word", 4)]


@pytest.fixture(scope="module")
def jax_runs():
    out = {name: _jax_run(_jax_emb_model(), t, 4, SGD, _batches())
           for name, t in EMB_TABLES.items() if name != "n2c1"}
    out["lazy"] = _jax_run(_jax_emb_model(), {}, 1, LAZY, _batches())
    out["lazy_zero"] = _jax_run(_jax_emb_model(), EMB_TABLES["n2c1"], 4,
                                LAZY, _batches(), zero=True)
    for kind in TABLE_IDS:
        out[kind] = _jax_run(_jax_table_model(kind), {}, 1, SGD0,
                             _table_batches(kind))
    return out


# -- the port's worlds --------------------------------------------------------


def _emb_case(p0, table, opt=SGD, **extra):
    return dict(model="emb", table=table, optimizer=opt, batches=_batches(),
                params=p0, **extra)


def _cases(jr):
    p0 = jr["n2c2"][0]
    cases = {name: _emb_case(p0, t) for name, t in EMB_TABLES.items()}
    cases["lazy_c2"] = _emb_case(p0, EMB_TABLES["n2c2"], LAZY)
    cases["lazy_c1"] = _emb_case(p0, EMB_TABLES["n2c1"], LAZY)
    cases["lazy_c1_zero"] = _emb_case(p0, EMB_TABLES["n2c1"], LAZY,
                                      config={"zero_sharded_optimizer": True})
    cases["sparse_dp"] = _emb_case(p0, {}, SGD0)
    cases["sparse_clip"] = _emb_case(p0, EMB_TABLES["n2c2"], SGD0,
                                     config={"clip_norm": 0.05})
    for kind, c in TABLE_CASES:
        cases[f"{kind}_c{c}"] = dict(
            model="table", model_kw={"kind": kind}, table={"emb": dict(c=c)},
            optimizer=SGD0, batches=_table_batches(kind),
            params=jr[kind][0])
    return cases


@pytest.fixture(scope="module")
def world4(jax_runs):
    cases = _cases(jax_runs)
    out = launch.run("flexflow_torch.tools.mesh_smoke:run_cases",
                     (list(cases.values()),), nprocs=4, device="cpu",
                     timeout_s=WORLD_S)
    return [dict(zip(cases, rank)) for rank in out]


@pytest.fixture(scope="module")
def one_rank(jax_runs):
    """The plain Executor (no world) on the emb model's cases, one thread
    as a rank runs."""
    cases = _cases(jax_runs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: mesh_smoke.train_case(dict(cases[name], table={}))
                for name in ("n2c2", "sparse_dp", "sparse_clip")}
    finally:
        torch.set_num_threads(threads)


def _close(got, losses, params, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(got["losses"], losses, rtol=rtol)
    for op, g in params.items():
        for k, v in g.items():
            np.testing.assert_allclose(got["params"][op][k], np.asarray(v),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{op}.{k}")


def _equal(a, b):
    assert a["losses"] == b["losses"]
    for op, g in a["params"].items():
        for k, v in g.items():
            np.testing.assert_array_equal(v, b["params"][op][k],
                                          err_msg=f"{op}.{k}")


# -- the windowed row kernels (plain versions) --------------------------------


def _table(r=12, d=8, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (r, d)).astype(np.float32))


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_windowed_gather_zero_rows_outside_the_window(id_dtype):
    """``row_start`` reads row ``id - row_start`` of the block and gives a
    zero row outside it; the blocks' rows summed are the whole table's
    (the all-reduce); without a window an id outside ``[0, R)`` still
    gives a NaN row."""
    full = _table()
    ids = torch.tensor([0, 5, 11, 3, 6, 5, 7], dtype=id_dtype)
    blocks = full.chunk(3)
    got = [kernels.gather_rows_plain(b, ids, row_start=4 * k)
           for k, b in enumerate(blocks)]
    for k, rows in enumerate(got):
        inside = (ids >= 4 * k) & (ids < 4 * k + 4)
        assert torch.equal(rows[inside], full[ids[inside].long()])
        assert not rows[~inside].any()
    assert torch.equal(sum(got), full[ids.long()])
    assert torch.equal(kernels.gather_rows(blocks[1], ids, row_start=4),
                       got[1])
    multi = kernels.gather_rows_multi([blocks[2], -blocks[2]], ids,
                                      row_start=8)
    assert torch.equal(multi[0], got[2]) and torch.equal(multi[1], -got[2])
    assert kernels.gather_rows_plain(blocks[0], ids)[1:3].isnan().all()


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_windowed_scatter_drops_updates_outside_the_window(id_dtype):
    """``row_start`` adds the update of ``id`` to row ``id - row_start`` of
    the block and drops those outside it; the blocks together are the
    whole table's scatter bit for bit (each row's updates summed in batch
    order either way)."""
    full = _table()
    ids = torch.tensor([0, 5, 11, 3, 6, 5, 7, 5, 11], dtype=id_dtype)
    upd = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (9, 8)).astype(np.float32))
    want = kernels.scatter_add_rows_plain(full.clone(), ids, upd)
    blocks = [b.clone() for b in full.chunk(3)]
    for k, b in enumerate(blocks):
        kernels.scatter_add_rows(b, ids, upd, row_start=4 * k)
    assert torch.equal(torch.cat(blocks), want)
    one = full[4:8].clone()
    kernels.scatter_add_rows_plain(one, ids, upd, row_start=4)
    assert torch.equal(one, blocks[1])


def test_row_start_none_is_the_unwindowed_kernel_bit_for_bit():
    """No window is today's functions: ``table[ids]`` with NaN rows for an
    id outside ``[0, R)``, and the scatter dropping those updates."""
    t = _table()
    ids = torch.tensor([3, 12, -1, 0, 3], dtype=torch.int64)
    ok = (ids >= 0) & (ids < 12)
    want = torch.full((5, 8), float("nan"))
    want[ok] = t[ids[ok]]
    got = kernels.gather_rows(t, ids)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    upd = torch.ones((5, 8))
    a = kernels.scatter_add_rows(t.clone(), ids, upd)
    b = t.clone()
    b[3] += 2.0
    b[0] += 1.0
    assert torch.equal(a, b)


def _jax_bound_embedding(c):
    """A JAX ``Embedding(shard_rows=True)`` bound to c ways of its
    4-device mesh, and its row sharding."""
    ff = JModel(JConfig(batch_size=8, seed=0, shard_embeddings=True))
    ids = ff.create_tensor((8, 3), dtype=jnp.int32, name="ids")
    ff.embedding(ids, 12, 8, name="e")
    ex = JExecutor(ff, strategy=JStore(4, {"e": JPC(n=4 // c, c=c)}),
                   devices=jax.devices()[:4])
    op = ff.layers[0]
    op.bind_mesh(ex.plan, ex._pc(op))
    return op, jemb._row_sharding(op, "table")


def test_windowed_kernels_against_jax_sharded_gather_and_scatter():
    """The rank blocks' windowed gathers summed are JAX's
    ``_sharded_gather`` (its masked takes and psum) bit for bit; their
    windowed scatters concatenated are JAX's ``_sharded_scatter_add``
    within 1e-6 (JAX adds each update to the row in turn, K5 sums a row's
    updates first: another order of the same f32 adds)."""
    op, shard = _jax_bound_embedding(4)
    assert shard[1:] == (4, 3)
    full = _table()
    ids = np.asarray([[0, 5, 11], [3, 6, 5], [7, 2, 2], [11, 1, 9],
                      [4, 4, 4], [8, 10, 0], [6, 6, 1], [3, 9, 10]],
                     np.int32)
    upd = np.random.default_rng(5).standard_normal((8, 3, 8)).astype(
        np.float32)
    want = np.asarray(jemb._sharded_gather(op, jnp.asarray(full.numpy()),
                                           jnp.asarray(ids), shard))
    blocks = full.chunk(4)
    tids = torch.from_numpy(ids).reshape(-1)
    got = sum(kernels.gather_rows(b, tids, row_start=3 * k)
              for k, b in enumerate(blocks)).reshape(8, 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jemb._sharded_scatter_add(
        op, jnp.asarray(full.numpy()), jnp.asarray(ids), jnp.asarray(upd),
        shard))
    parts = [b.clone() for b in blocks]
    for k, b in enumerate(parts):
        kernels.scatter_add_rows(b, tids, torch.from_numpy(upd).reshape(-1, 8),
                                 row_start=3 * k)
    np.testing.assert_allclose(torch.cat(parts).numpy(), want, rtol=1e-6,
                               atol=1e-7)


def test_shard_events_once_per_op_and_event(tmp_path):
    """The sharded gather and combine announce themselves once per op and
    event in a run's telemetry, with JAX's fields (the port's combine is
    an all-reduce where JAX's is a psum)."""
    import json

    from flexflow_torch.ops import embedding as temb
    from flexflow_torch.runtime.telemetry import Telemetry

    class _Op:
        name = "emb"

    op = _Op()
    with Telemetry(str(tmp_path), watchdog=False) as tel:
        for _ in range(2):
            temb._note_shard_event(op, "embedding_gather", shards=2,
                                   rows_per_shard=32, combine="all_reduce")
            temb._note_shard_event(op, "embedding_combine", shards=2,
                                   rows_per_shard=32,
                                   combine="local_scatter_add")
    with open(tel.path) as f:
        events = [json.loads(line) for line in f]
    mine = [e for e in events if e.get("ev", "").startswith("embedding_")]
    assert [(e["ev"], e["op"], e["shards"], e["rows_per_shard"],
             e["combine"]) for e in mine] == [
        ("embedding_gather", "emb", 2, 32, "all_reduce"),
        ("embedding_combine", "emb", 2, 32, "local_scatter_add")]


# -- the emb model on the world of 4 ------------------------------------------


@pytest.mark.parametrize("table", ["n2c2", "n1c4", "hybrid"])
def test_sharded_emb_tables_match_jax(world4, jax_runs, table):
    """The table row-sharded over c (with the dense tail split too in the
    hybrid) trains as JAX's run of the same table within ``RTOL``; every
    rank holds the same whole parameters."""
    _, losses, params = jax_runs[table]
    for rank in world4:
        assert not rank[table]["jax_imported"]
        _close(rank[table], losses, params)
    _equal(world4[0][table], world4[3][table])


@pytest.mark.parametrize("table", ["n2c2", "n1c4"])
def test_sharded_emb_tables_equal_the_world_of_one(world4, one_rank, table):
    want = one_rank["n2c2"]
    _close(world4[0][table], want["losses"], want["params"])


def test_sharded_table_equals_replicated_bit_for_bit(world4):
    """n=2 c=2 against n=2 c=1: the table's gradient is reduced over the
    same two batch blocks in both, and a block's masked rows add exact
    zeros, so the runs are the same bits; each rank of c=2 holds half the
    vocabulary."""
    for rank in world4:
        _equal(rank["n2c2"], rank["n2c1"])
        assert rank["n2c2"]["local_shapes"]["emb"]["table"] == (VOCAB // 2, 8)
        assert rank["n2c1"]["local_shapes"]["emb"]["table"] == (VOCAB, 8)
        assert rank["n1c4"]["local_shapes"]["emb"]["table"] == (VOCAB // 4, 8)


def test_lazy_adam_over_a_sharded_table(world4, jax_runs):
    """Lazy Adam over the c=2 table equals the port's unsharded lazy Adam
    bit for bit (each rank steps the unique rows it holds, from the same
    global row sums), moments included, which are split as the table is;
    and JAX's one-device lazy Adam within ``RTOL``."""
    _, losses, params = jax_runs["lazy"]
    for rank in world4:
        _equal(rank["lazy_c2"], rank["lazy_c1"])
        for k in ("m", "v"):
            for op, g in rank["lazy_c1"]["moments"][k].items():
                for name, v in g.items():
                    np.testing.assert_array_equal(
                        rank["lazy_c2"]["moments"][k][op][name], v)
        assert rank["lazy_c2"]["moment_shapes"]["emb"]["table"] == \
            (VOCAB // 2, 8)
        _close(rank["lazy_c2"], losses, params)


def test_zero_with_lazy_adam_follows_jax(world4, jax_runs):
    """ZeRO-1 with a row-sparse table: its lazy moments keep the table's
    own placement (JAX reads them whole through GSPMD), the dense
    layers' moments are split; JAX's ZeRO-1 run within ``RTOL``, and the
    run without ZeRO within 1e-6 (the dense layers' gradients are
    reduce-scattered over four ranks instead of all-reduced: gloo sums
    them in another order)."""
    _, losses, params = jax_runs["lazy_zero"]
    for rank in world4:
        zero = rank["lazy_c1_zero"]
        _close(zero, rank["lazy_c1"]["losses"], rank["lazy_c1"]["params"],
               rtol=1e-6)
        _close(zero, losses, params)
        assert zero["moment_shapes"]["emb"]["table"] == (VOCAB, 8)
        assert zero["moment_shapes"]["fc1"]["kernel"][0] < \
            rank["lazy_c1"]["moment_shapes"]["fc1"]["kernel"][0]


def test_row_sparse_sgd_under_dp_keeps_replicas_equal(world4, one_rank):
    """Plain SGD (the row-sparse path) with the table replicated on four
    ranks: the batch's ids and row gradients are gathered and scattered
    into every replica, so every rank's table is the same bits, and the
    run is the world of 1's within ``RTOL``."""
    for rank in world4[1:]:
        _equal(rank["sparse_dp"], world4[0]["sparse_dp"])
    want = one_rank["sparse_dp"]
    _close(world4[0]["sparse_dp"], want["losses"], want["params"])


def test_clip_norm_with_sparse_rows_under_the_mesh(world4, one_rank):
    """The clip norm counts the global batch's unique row sums once (the
    same on every rank) beside the dense gradients' squares: the c=2 run
    with ``--clip-norm`` is the world of 1's within ``RTOL``, and the
    clip binds."""
    want = one_rank["sparse_clip"]
    for rank in world4:
        _close(rank["sparse_clip"], want["losses"], want["params"])
    assert one_rank["sparse_clip"]["params"]["fc2"]["kernel"].tolist() != \
        one_rank["sparse_dp"]["params"]["fc2"]["kernel"].tolist()


@pytest.mark.parametrize("kind, c", TABLE_CASES)
def test_table_ops_sharded_match_jax(world4, jax_runs, kind, c):
    """``MultiEmbedding`` (its stacked T dim), ``HeteroEmbedding`` (its
    padded rows) and ``WordEmbedding(shard_rows=True)`` split over c on
    the row-sparse path match JAX within ``RTOL``; 18 rows, which c=4
    does not divide, run replicated (JAX's rule)."""
    _, losses, params = jax_runs[kind]
    name = f"{kind}_c{c}"
    full = {"multi": (4, 16, 8), "hetero": (20, 8), "hetero18": (18, 8),
            "word": (64, 8)}[kind]
    local = full if kind == "hetero18" else (full[0] // c,) + full[1:]
    for rank in world4:
        _close(rank[name], losses, params)
        key = "tables" if kind == "multi" else "table"
        assert rank[name]["local_shapes"]["emb"][key] == local


# -- the DLRM app on the world of 2 -------------------------------------------

DLRM_ARGV = ["-b", "8", "-i", "2", "--optimizer", "sgd", "--momentum", "0",
             "--wd", "0", "--lr", "0.5", "--arch-sparse-feature-size", "16",
             "--arch-embedding-size", "1000-1000-1000-1000", "--arch-mlp-bot",
             "16-64-16", "--arch-mlp-top", "80-64-1"]
LAZY_ARGV = ["--optimizer", "adam", "--lr", "0.01", "--lazy-sparse-opt"]
REPLICATED = {"embeddings": {"n": 2}}
DLRM_CONFIGS = [
    dict(name="sgd_shard", table=None),
    dict(name="sgd_rep", table=REPLICATED),
    dict(name="lazy_shard", table=None, extra=LAZY_ARGV),
    dict(name="lazy_rep", table=REPLICATED, extra=LAZY_ARGV),
    dict(name="no_all_reduce", table=None, fault="no_all_reduce"),
    dict(name="no_window", table=None, fault="no_window"),
]


def _jax_dlrm(n, opt, batch):
    dl = JDLRMConfig(sparse_feature_size=16, embedding_size=[1000] * 4,
                     mlp_bot=[16, 64, 16], mlp_top=[80, 64, 1])
    ff = jbuild_dlrm(batch_size=8, dlrm=dl,
                     config=JConfig(batch_size=8, seed=0))
    ex = JExecutor(ff, strategy=jdlrm_strategy(n, dl), optimizer=opt,
                   devices=jax.devices()[:n])
    params, opt_state, state = ex.init()
    p0 = jax.device_get(params)
    losses = []
    for _ in range(3):  # the app's warmup step and two timed ones
        params, opt_state, state, m = ex.train_step(
            params, opt_state, state, ex.shard_batch(batch))
        losses.append(float(m["train_loss"]))
    return p0, losses


@pytest.fixture(scope="module")
def dlrm_world():
    """JAX's DLRM on two devices under plain SGD and lazy Adam, and the
    port's app on two ranks under every configuration, from JAX's
    initial parameters and on the app's batch."""
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.dlrm import build_dlrm

    ff = build_dlrm(8, DLRMConfig(sparse_feature_size=16,
                                  embedding_size=[1000] * 4,
                                  mlp_bot=[16, 64, 16], mlp_top=[80, 64, 1]))
    batch = synthetic_host_batch(ff, np.random.default_rng(0))
    jax_sgd = _jax_dlrm(2, JSGD(lr=0.5), batch)
    jax_lazy = _jax_dlrm(2, JAdam(lr=0.01, lazy_sparse=True), batch)
    ranks = launch.run("flexflow_torch.tools.mesh_smoke:dlrm_app",
                       (DLRM_CONFIGS, DLRM_ARGV, "cpu", jax_sgd[0]),
                       nprocs=2, device="cpu", timeout_s=WORLD_S)
    names = [c["name"] for c in DLRM_CONFIGS]
    return [dict(zip(names, r)) for r in ranks], {"sgd": jax_sgd[1],
                                                  "lazy": jax_lazy[1]}


def _rows(ranks, name):
    """The batch's rows of the whole table, from each rank's window."""
    out = {}
    for r in ranks:
        out.update(zip(r[name]["rows"], r[name]["trained_rows"]))
    return out


def _same_tables(ranks, a, b):
    ra, rb = _rows(ranks, a), _rows(ranks, b)
    return ra.keys() == rb.keys() and all(
        np.array_equal(ra[k], rb[k]) for k in ra) and all(
        r[a]["only_batch_rows"] and r[b]["only_batch_rows"] for r in ranks)


@pytest.mark.parametrize("opt", ["sgd", "lazy"])
def test_dlrm_sharded_tables_equal_replicated(dlrm_world, opt):
    """The app on two ranks with the tables sharded by ``dlrm_strategy``
    (c=2: two of the four tables a rank) and replicated (``-s``, n=2 c=1):
    the same losses, dense layers and table bits (each rank's batch rows,
    and nothing else moved), each rank's tables halved; lazy Adam moves
    no moment of a row outside the batch."""
    ranks, _ = dlrm_world
    shard, rep = f"{opt}_shard", f"{opt}_rep"
    for r in ranks:
        assert r[shard]["code"] == 0 and r[rep]["code"] == 0
        assert r[shard]["losses"] == r[rep]["losses"]
        assert r[shard]["dense_digest"] == r[rep]["dense_digest"] == \
            ranks[0][shard]["dense_digest"]
        assert r[shard]["local_shape"] == (2, 1000, 16)
        assert r[rep]["local_shape"] == (4, 1000, 16)
        assert r[shard]["batch_rows_moved"]
        if opt == "lazy":
            assert r[shard]["moments_only_batch"]
    assert _same_tables(ranks, shard, rep)
    assert [r[shard]["window"] for r in ranks] == [(0, 2000), (2000, 2000)]


@pytest.mark.parametrize("opt", ["sgd", "lazy"])
def test_dlrm_world_of_two_matches_jax(dlrm_world, opt):
    """The app's losses on two ranks are JAX's ``build_dlrm`` on two
    devices (its ``dlrm_strategy``) within ``RTOL``, from the same
    parameters and batch; one report, on rank 0."""
    ranks, jax_losses = dlrm_world
    got = ranks[0][f"{opt}_shard"]
    np.testing.assert_allclose(got["losses"], jax_losses[opt], rtol=RTOL)
    assert got["report"].count("THROUGHPUT = ") == 1
    assert not got["jax_imported"]


@pytest.mark.parametrize("fault", ["no_all_reduce", "no_window"])
def test_planted_faults_break_the_equality(dlrm_world, fault):
    """Phase 28 (c) on the CPU: a rank whose gather keeps its own window
    instead of the all-reduce, or that scatters without its window, no
    longer trains the replicated table's bits."""
    ranks, _ = dlrm_world
    assert not _same_tables(ranks, fault, "sgd_rep")


DLRM_STRATEGY_CASES = [
    (2, [1000] * 8, False), (4, [1000] * 8, False), (8, [1000] * 8, True),
    (3, [1000] * 4, False), (6, [1000] * 4, False), (1, [1000] * 8, False),
    (4, [10, 12, 7, 16], True), (4, [10, 12, 7, 16], False),
    (8, [64, 6, 1000, 3], True), (2, [5, 5, 6], True)]


@pytest.mark.parametrize("nd, vocabs, shard", DLRM_STRATEGY_CASES)
def test_dlrm_strategy_is_jax(nd, vocabs, shard):
    """The same table of degrees as JAX's ``dlrm_strategy`` for every
    (devices, vocabularies, ``shard_embeddings``)."""
    kw = dict(sparse_feature_size=4, embedding_size=vocabs, mlp_bot=[4, 4],
              mlp_top=[4 + 4 * len(vocabs), 1])
    got = dlrm_strategy(nd, DLRMConfig(**kw), shard_embeddings=shard)
    want = jdlrm_strategy(nd, JDLRMConfig(**kw), shard_embeddings=shard)
    assert got.num_devices == want.num_devices
    assert {k: v.to_json() for k, v in got.table.items()} == \
        {k: v.to_json() for k, v in want.table.items()}
