"""The port's DLRM slice held against the JAX package: the embedding and
interaction ops, the MSE loss, the row-sparse train step with plain SGD,
clip-norm and the lazy optimizers, and a small DLRM trained end to end.

Inputs are drawn by numpy from a seed and handed to both packages; the
JAX parameters (and optimizer state) are carried into the port with
``weights.py``.  On the CPU the JAX sparse path gathers with
``jnp.take`` and scatters with ``.at[].add``; the port's goes through the
plain versions of K4/K5.  Tolerances (f32):

- op outputs within 1e-5, op gradients within 1e-5 of their largest
  magnitude (``TOL``);
- a sparse step's parameters within ``STEP_RTOL`` of each tensor's
  largest magnitude plus ``STEP_ATOL``: the reference adds each
  duplicate id's update to the table in turn, the port sums a row's
  updates first and adds once, and autograd sums the MLP gradients in
  another order;
- losses within 1e-5 (``LOSS_TOL``);
- the port's sparse step against its own dense step under plain SGD:
  rtol 1e-6 (the same ops; only the order of the duplicate sums moves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.ops as jops
from flexflow_tpu import optim as joptim
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.dlrm import DLRMConfig as JDLRMConfig
from flexflow_tpu.models.dlrm import build_dlrm as jbuild_dlrm
from flexflow_tpu.ops.base import TensorSpec as JSpec
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_tpu.runtime.trainer import Trainer as JTrainer
import flexflow_torch.ops as tops
from flexflow_torch import optim as toptim
from flexflow_torch.apps import dlrm as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.graph import FFModel as TModel
from flexflow_torch.models.dlrm import DLRMConfig as TDLRMConfig
from flexflow_torch.models.dlrm import build_dlrm as tbuild_dlrm
from flexflow_torch.ops import kernels
from flexflow_torch.ops.base import TensorSpec as TSpec
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.executor import _unique_row_sums
from flexflow_torch.runtime.trainer import Trainer as TTrainer
from flexflow_torch.weights import opt_state_from_numpy, params_from_numpy

TOL = 1e-5
LOSS_TOL = 1e-5
STEP_RTOL = 1e-5
STEP_ATOL = 1e-7


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _specs(name, shape, ints=False):
    axes = ("n",) + (None,) * (len(shape) - 1)
    return (JSpec(name, tuple(shape), jnp.int32 if ints else jnp.float32, axes),
            TSpec(name, tuple(shape), torch.int32 if ints else torch.float32,
                  axes))


def _params(jop, top, seed):
    jspecs, tspecs = jop.param_specs(), top.param_specs()
    assert sorted(jspecs) == sorted(tspecs)
    r = np.random.default_rng(seed)
    arrays = {}
    for k in sorted(jspecs):
        assert tuple(jspecs[k].shape) == tuple(tspecs[k].shape), k
        arrays[k] = (0.3 * r.standard_normal(jspecs[k].shape)).astype(np.float32)
    return arrays


def _check_op(jop, top, arrays, xs, float_inputs=()):
    """Forward within ``TOL``; gradients of ``sum(y * g)`` w.r.t. the
    params and the float inputs within ``TOL`` of their largest
    magnitude, against ``jax.vjp``."""
    jp = {k: jnp.asarray(a) for k, a in arrays.items()}
    tp = {k: torch.from_numpy(a.copy()).requires_grad_(True)
          for k, a in arrays.items()}
    jxs = [jnp.asarray(x) for x in xs]
    txs = [torch.from_numpy(np.asarray(x).copy()) for x in xs]
    for i in float_inputs:
        txs[i].requires_grad_(True)

    def jf(p, fl):
        ins = list(jxs)
        for i, x in zip(float_inputs, fl):
            ins[i] = x
        return jop.forward(p, ins, {}, True)[0][0]

    jy, vjp = jax.vjp(jf, jp, [jxs[i] for i in float_inputs])
    ty = top.forward(tp, txs, {}, True)[0][0]
    assert tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=TOL,
                               rtol=0)
    g = _x(99, jy.shape)
    jgp, jgx = vjp(jnp.asarray(g))
    leaves = list(tp.values()) + [txs[i] for i in float_inputs]
    got = torch.autograd.grad((ty * torch.from_numpy(g)).sum(), leaves)
    for name, a, b in zip(list(tp) + ["x"] * len(float_inputs), got,
                          [jgp[k] for k in tp] + list(jgx)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, err_msg=name,
                                   atol=TOL * max(1.0, float(np.abs(b).max())))


def _ids(seed, high, shape):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# ops, forward and gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aggr", ["sum", "avg"])
def test_embedding_bag(aggr):
    js, ts = _specs("bag", (4, 3), ints=True)
    jop = jops.Embedding("e", js, 10, 6, aggr=aggr)
    top = tops.Embedding("e", ts, 10, 6, aggr=aggr)
    _check_op(jop, top, _params(jop, top, 1), [_ids(2, 4, (4, 3))])


def test_multi_embedding():
    js, ts = _specs("ids", (4, 3), ints=True)
    jop = jops.MultiEmbedding("m", js, 3, 10, 6)
    top = tops.MultiEmbedding("m", ts, 3, 10, 6)
    assert tuple(top.param_specs()["tables"].shape) == (3, 10, 6)
    _check_op(jop, top, _params(jop, top, 3), [_ids(4, 5, (4, 3))])


def test_hetero_embedding():
    js, ts = _specs("ids", (6, 3), ints=True)
    jop = jops.HeteroEmbedding("h", js, (5, 9, 3), 4, pad_to=4)
    top = tops.HeteroEmbedding("h", ts, (5, 9, 3), 4, pad_to=4)
    assert top.attrs["rows"] == 20 and top.attrs["offsets"] == (0, 5, 14)
    ids = np.stack([_ids(5 + i, v, 6) for i, v in enumerate((5, 9, 3))], 1)
    _check_op(jop, top, _params(jop, top, 6), [ids])


def test_hetero_embedding_init():
    """Per-table U(+-1/sqrt(V)) rows and zero padding rows (the values
    are the port's own draw)."""
    _, ts = _specs("ids", (2, 2), ints=True)
    top = tops.HeteroEmbedding("h", ts, (4, 100), 8, pad_to=128)
    spec = top.param_specs()["table"]
    t = spec.initializer(torch.Generator().manual_seed(0), spec.shape, spec.dtype)
    assert t.shape == (128, 8)
    assert float(t[:4].abs().max()) <= 0.5 and float(t[:4].abs().max()) > 0.1
    assert float(t[4:104].abs().max()) <= 0.1
    assert not t[104:].any()


def test_concat_and_reshape():
    ja, ta = _specs("a", (2, 3))
    jb, tb = _specs("b", (2, 5))
    _check_op(jops.Concat("c", [ja, jb], 1), tops.Concat("c", [ta, tb], 1), {},
              [_x(7, (2, 3)), _x(8, (2, 5))], float_inputs=(0, 1))
    jx, tx = _specs("x", (2, 3, 4))
    _check_op(jops.Reshape("r", jx, (2, 12)), tops.Reshape("r", tx, (2, 12)),
              {}, [_x(9, (2, 3, 4))], float_inputs=(0,))


def test_dot_interaction():
    """Dense features then the strictly-lower-triangular pairwise dots in
    ``tril_indices(k=-1)`` order."""
    jd, td = _specs("d", (3, 8))
    js, ts = _specs("s", (3, 4, 8))
    jop, top = jops.DotInteraction("i", jd, js), tops.DotInteraction("i", td, ts)
    assert top.outputs[0].shape == (3, 8 + 10)
    _check_op(jop, top, {}, [_x(10, (3, 8)), _x(11, (3, 4, 8))],
              float_inputs=(0, 1))


@pytest.mark.parametrize("shape", [(8, 1), (8, 3)])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_mse_loss(shape, reduction):
    """The loss and its gradient within 1e-5; ``train_correct`` by the
    reference's rule (``|pred - label| < 0.5`` for one column, argmax
    otherwise) exactly."""
    jp_, tp_ = _specs("p", shape)
    jl, tl = _specs("l", shape)
    jop = jops.MSELoss("mse", jp_, jl, reduction)
    top = tops.MSELoss("mse", tp_, tl, reduction)
    pred, label = _x(12, shape), np.round(np.abs(_x(13, shape)))
    (jloss, jm, _), _ = jop.forward({}, [jnp.asarray(pred), jnp.asarray(label)],
                                    {}, True)
    tpred = torch.from_numpy(pred).requires_grad_(True)
    (tloss, tm, ys), _ = top.forward({}, [tpred, torch.from_numpy(label)], {},
                                     True)
    assert ys[0] is tloss
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL
    for k in ("train_correct", "train_all"):
        assert int(tm[k]) == int(jm[k]), k
    jg = jax.grad(lambda p: jop.forward({}, [p, jnp.asarray(label)], {},
                                        True)[0][0])(jnp.asarray(pred))
    (tg,) = torch.autograd.grad(tloss, tpred)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the sparse protocol of each op
# ---------------------------------------------------------------------------


def _sparse_cases():
    ids4 = _ids(20, 5, (4, 3))
    return {
        "embedding": (lambda s: (jops.Embedding("e", s[0], 10, 6, aggr="avg"),
                                 tops.Embedding("e", s[1], 10, 6, aggr="avg")),
                      (4, 3), ids4),
        "multi": (lambda s: (jops.MultiEmbedding("m", s[0], 3, 10, 6),
                             tops.MultiEmbedding("m", s[1], 3, 10, 6)),
                  (4, 3), ids4),
        "hetero": (lambda s: (jops.HeteroEmbedding("h", s[0], (5, 9, 3), 6,
                                                   pad_to=4),
                              tops.HeteroEmbedding("h", s[1], (5, 9, 3), 6,
                                                   pad_to=4)),
                   (4, 3), np.minimum(ids4, 2)),
        "word": (lambda s: (jops.WordEmbedding("w", s[0], 10, 6),
                            tops.WordEmbedding("w", s[1], 10, 6)),
                 (4, 3), ids4),
    }


@pytest.mark.parametrize("case", ["embedding", "multi", "hetero", "word"])
def test_sparse_protocol_matches_jax(case):
    """``sparse_rows`` and ``sparse_flat_ids`` equal JAX's;
    ``sparse_forward`` of the rows equals ``forward``; ``sparse_apply``
    scatters ``-lr * g`` in place, within 1e-6 of JAX's."""
    make, shape, ids = _sparse_cases()[case]
    jop, top = make(_specs("ids", shape, ints=True))
    arrays = _params(jop, top, 21)
    jp = {k: jnp.asarray(a) for k, a in arrays.items()}
    tp = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
    jxs, txs = [jnp.asarray(ids)], [torch.from_numpy(ids)]
    jrows = jop.sparse_rows(jp, jxs)
    trows = top.sparse_rows(tp, txs)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(top.sparse_flat_ids(tp, txs).numpy(),
                                  np.asarray(jop.sparse_flat_ids(jp, jxs)))
    y = top.sparse_forward(trows, txs, {}, True)[0][0]
    assert torch.equal(y, top.forward(tp, txs, {}, True)[0][0])
    g = _x(22, trows.shape)
    want = jop.sparse_apply(jp, jxs, jnp.asarray(g), 0.5)
    key = top.sparse_keys()[0]
    table = tp[key]
    assert top.sparse_apply(tp, txs, torch.from_numpy(g), 0.5)[key] is table
    np.testing.assert_allclose(table.numpy(), np.asarray(want[key]), rtol=1e-6,
                               atol=1e-6)


def test_unique_row_sums():
    """Fixed-size form: slot i holds sorted id i; the last slot of each
    run holds the run's summed gradient (1e-6 against numpy's sums),
    every other slot zeros and a False mask."""
    ids = np.array([4, 1, 4, 9, 1, 4, 0], np.int32)
    g = _x(23, (7, 5))
    uids, gsum, mask = _unique_row_sums(torch.from_numpy(ids),
                                        torch.from_numpy(g))
    np.testing.assert_array_equal(uids.numpy(), np.sort(ids))
    np.testing.assert_array_equal(mask.numpy(),
                                  [True, False, True, False, False, True, True])
    want = {u: g[ids == u].sum(0) for u in np.unique(ids)}
    for i in range(7):
        if mask[i]:
            np.testing.assert_allclose(gsum[i].numpy(), want[int(uids[i])],
                                       rtol=1e-6, atol=1e-6)
        else:
            assert not gsum[i].any()


# ---------------------------------------------------------------------------
# the sparse train step against JAX's
# ---------------------------------------------------------------------------


def _build(pkg, sparse, batch=8, clip=0.0):
    """``tests/test_sparse_update.py::_build`` in either package: a
    stacked table and a bag embedding, duplicates in both."""
    if pkg == "jax":
        ff = JModel(JConfig(batch_size=batch, sparse_embedding_updates=sparse,
                            clip_norm=clip))
        i32 = jnp.int32
    else:
        ff = TModel(TConfig(batch_size=batch, sparse_embedding_updates=sparse,
                            clip_norm=clip))
        i32 = torch.int32
    ids = ff.create_tensor((batch, 4), dtype=i32, name="ids")
    bag = ff.create_tensor((batch, 3), dtype=i32, name="bag")
    lbl = ff.create_tensor((batch,), dtype=i32, name="label")
    e1 = ff.multi_embedding(ids, 4, 16, 8, name="tables")
    e1 = ff.reshape(e1, (batch, 32), name="r1")
    e2 = ff.embedding(bag, 32, 8, aggr="avg", name="bagged")
    t = ff.concat([e1, e2], axis=1, name="cat")
    t = ff.dense(t, 4, name="fc")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _build_word(pkg, sparse):
    """``test_sparse_update.py::test_word_embedding_sparse``'s model."""
    if pkg == "jax":
        ff, i32 = JModel(JConfig(batch_size=4,
                                 sparse_embedding_updates=sparse)), jnp.int32
    else:
        ff, i32 = TModel(TConfig(batch_size=4,
                                 sparse_embedding_updates=sparse)), torch.int32
    tok = ff.create_tensor((4, 6), dtype=i32, name="tokens")
    lbl = ff.create_tensor((4, 6), dtype=i32, name="label")
    t = ff.word_embedding(tok, 32, 8, name="wte")
    t = ff.dense(t, 32, name="proj")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _batch(seed=0, batch=8):
    r = np.random.default_rng(seed)
    return {"ids": r.integers(0, 4, (batch, 4)).astype(np.int32),
            "bag": r.integers(0, 6, (batch, 3)).astype(np.int32),
            "label": r.integers(0, 4, (batch,)).astype(np.int32)}


def _word_batch(seed=1):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, 32, (4, 6)).astype(np.int32),
            "label": r.integers(0, 32, (4, 6)).astype(np.int32)}


def _jax_run(ff, opt, batch, steps, start=None):
    """``steps`` JAX train steps from ``start`` (or a fresh init, seed 0);
    returns (initial (params, opt_state), final (params, opt_state),
    losses), all on the host."""
    ex = JExecutor(ff, optimizer=opt, devices=jax.devices()[:1])
    if start is None:
        params, opt_state, state = ex.init(seed=0)
    else:
        params, opt_state = jax.tree.map(jnp.asarray, start)
        state = {}
    first = jax.device_get((params, opt_state))
    b = ex.shard_batch(dict(batch))
    losses = []
    for _ in range(steps):
        params, opt_state, state, m = ex.train_step(params, opt_state, state, b)
        losses.append(float(jax.device_get(m["train_loss"])))
    return ex, first, jax.device_get((params, opt_state)), losses


def _torch_run(ff, opt, batch, steps, params, opt_state=None):
    ex = TExecutor(ff, optimizer=opt, device="cpu")
    params = params_from_numpy(params, device="cpu")
    opt_state = (opt.init(params) if opt_state is None
                 else opt_state_from_numpy(opt_state, "cpu"))
    b = ex.shard_batch(batch)
    losses = []
    for _ in range(steps):
        params, opt_state, _, m = ex.train_step(params, opt_state, {}, b)
        losses.append(float(m["train_loss"]))
    return ex, params, opt_state, losses


def _assert_close_tree(got, want, rtol=STEP_RTOL, atol=STEP_ATOL):
    assert sorted(got) == sorted(want)
    for op in want:
        for k in want[op]:
            w = np.asarray(want[op][k], np.float32)
            g = got[op][k].detach().float().numpy()
            assert g.shape == w.shape, (op, k)
            np.testing.assert_allclose(g, w, rtol=0, err_msg=f"{op}/{k}",
                                       atol=rtol * float(np.abs(w).max()) + atol)


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_sparse_sgd_step_matches_jax(clip):
    """Plain SGD, then with --clip-norm small enough to bind every step
    (the norm takes the per-unique-row sums): three steps."""
    jff, tff = _build("jax", True, clip=clip), _build("torch", True, clip=clip)
    batch = _batch()
    jex, (p0, _), (pj, _), jl = _jax_run(jff, joptim.SGDOptimizer(lr=0.3),
                                         batch, 3)
    assert {op.name for op in jex._sparse_ops} == {"tables", "bagged"}
    tex, pt, st, tl = _torch_run(tff, toptim.SGDOptimizer(lr=0.3), batch, 3, p0)
    assert {op.name for op in tex._sparse_ops} == {"tables", "bagged"}
    assert st is None
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    _assert_close_tree(pt, pj)


def test_word_embedding_sparse_step_matches_jax():
    """The LM's token table under plain SGD takes the sparse path in both
    packages."""
    batch = _word_batch()
    jex, (p0, _), (pj, _), jl = _jax_run(_build_word("jax", True),
                                         joptim.SGDOptimizer(lr=0.3), batch, 3)
    tex, pt, _, tl = _torch_run(_build_word("torch", True),
                                toptim.SGDOptimizer(lr=0.3), batch, 3, p0)
    assert [op.name for op in jex._sparse_ops] == ["wte"]
    assert [op.name for op in tex._sparse_ops] == ["wte"]
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    _assert_close_tree(pt, pj)


def _lazy_opts(which):
    if which == "momentum":
        kw = dict(lr=0.2, momentum=0.9, weight_decay=1e-3, lazy_sparse=True)
        return joptim.SGDOptimizer(**kw), toptim.SGDOptimizer(**kw)
    kw = dict(lr=0.05, weight_decay=1e-3, lazy_sparse=True)
    return joptim.AdamOptimizer(**kw), toptim.AdamOptimizer(**kw)


@pytest.mark.parametrize("which", ["momentum", "adam"])
def test_lazy_trajectory_matches_jax(which):
    """--lazy-sparse-opt: one JAX step, then the params and the optimizer
    state (3-D stacked table, momentum or Adam's m/v/t) are carried into
    the port and both packages take two more steps; rows the batch does
    not touch keep their state.  Params and state within the step
    tolerance, losses within 1e-5."""
    batch = _batch(seed=3)
    jopt, topt = _lazy_opts(which)
    jff = _build("jax", True)
    _, _, start, _ = _jax_run(jff, jopt, batch, 1)
    jex, _, (pj, sj), jl = _jax_run(jff, jopt, batch, 2, start=start)
    assert {op.name for op in jex._sparse_ops} == {"tables", "bagged"}
    tex, pt, st, tl = _torch_run(_build("torch", True), topt, batch, 2,
                                 *start)
    assert {op.name for op in tex._sparse_ops} == {"tables", "bagged"}
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    _assert_close_tree(pt, pj)
    if which == "adam":
        assert st["t"] == int(sj["t"]) == 3
        _assert_close_tree(st["m"], sj["m"])
        _assert_close_tree(st["v"], sj["v"])
        cold = np.setdiff1d(np.arange(16), batch["ids"][:, 0])
        assert cold.size and not st["m"]["tables"]["tables"][0, cold].any()
    else:
        _assert_close_tree(st, sj)


@pytest.mark.parametrize("which", ["momentum", "adam"])
def test_lazy_step_gathers_param_and_state_rows_in_one_call(which,
                                                            monkeypatch):
    """The lazy step gathers each sparse op's unique rows of the param and
    of its optimizer state through one ``gather_rows_multi`` call (one K4
    launch on the card: two tables under momentum, three under Adam), and
    one step from the same start still matches JAX's within the step
    tolerance, losses within 1e-5."""
    calls = []
    real = kernels.gather_rows_multi

    def spy(tables, ids):
        calls.append(len(tuple(tables)))
        return real(tables, ids)

    monkeypatch.setattr(kernels, "gather_rows_multi", spy)
    batch = _batch(seed=5)
    jopt, topt = _lazy_opts(which)
    jff = _build("jax", True)
    _, (p0, s0), (pj, sj), jl = _jax_run(jff, jopt, batch, 1)
    tex, pt, st, tl = _torch_run(_build("torch", True), topt, batch, 1, p0)
    assert calls == [2 if which == "momentum" else 3] * len(tex._sparse_ops)
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    _assert_close_tree(pt, pj)
    if which == "adam":
        _assert_close_tree(st["m"], sj["m"])
        _assert_close_tree(st["v"], sj["v"])
    else:
        _assert_close_tree(st, sj)


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_sparse_equals_dense_under_plain_sgd(clip):
    """Port-internal: the row-sparse step is the dense step (rtol 1e-6)."""
    batch = _batch(seed=4)
    p0 = TExecutor(_build("torch", False), device="cpu").init_params(seed=0)
    p0 = {op: {k: v.numpy() for k, v in g.items()} for op, g in p0.items()}
    out = {}
    for sparse in (False, True):
        ex, p, _, losses = _torch_run(_build("torch", sparse, clip=clip),
                                      toptim.SGDOptimizer(lr=0.3), batch, 3, p0)
        assert bool(ex._sparse_ops) == sparse
        out[sparse] = (p, losses)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-6)
    _assert_close_tree(out[True][0],
                       {op: {k: v.detach().numpy() for k, v in g.items()}
                        for op, g in out[False][0].items()}, rtol=1e-6, atol=0)


def test_sparse_path_criteria():
    """Momentum or weight decay without --lazy-sparse-opt, a disabled
    config or a bf16 table keep the tables dense."""
    ff = _build("torch", True)
    assert not TExecutor(ff, optimizer=toptim.SGDOptimizer(lr=0.1, momentum=0.9),
                         device="cpu")._sparse_ops
    assert not TExecutor(ff, optimizer=toptim.AdamOptimizer(), device="cpu")._sparse_ops
    assert not TExecutor(_build("torch", False), optimizer=toptim.SGDOptimizer(),
                         device="cpu")._sparse_ops
    bf = TModel(TConfig(batch_size=2, compute_dtype="bfloat16",
                        sparse_embedding_updates=False))
    e = bf.word_embedding(bf.create_tensor((2, 3), dtype=torch.int32), 10, 4)
    bf.softmax(bf.dense(e, 10), bf.create_tensor((2, 3), dtype=torch.int32))
    bf.config.sparse_embedding_updates = True  # the table stays bf16
    assert not TExecutor(bf, optimizer=toptim.SGDOptimizer(momentum=0.0,
                                                           weight_decay=0.0),
                         device="cpu")._sparse_ops


def test_sparse_step_never_reads_the_table_in_autograd():
    """The rows are fresh leaves: the table gets no gradient and no
    autograd history, and a second step runs on the in-place table."""
    ff = _build("torch", True)
    ex = TExecutor(ff, optimizer=toptim.SGDOptimizer(lr=0.3, momentum=0.0,
                                                     weight_decay=0.0),
                   device="cpu")
    params, opt_state, state = ex.init()
    table = params["tables"]["tables"]
    b = ex.shard_batch(_batch())
    for _ in range(2):
        params, opt_state, state, _ = ex.train_step(params, opt_state, state, b)
    assert params["tables"]["tables"] is table
    assert not table.requires_grad and table.grad is None


# ---------------------------------------------------------------------------
# DLRM end to end
# ---------------------------------------------------------------------------


def _small(pkg, interaction="cat"):
    kw = dict(sparse_feature_size=16, embedding_size=[1000] * 4,
              mlp_bot=[16, 64, 16], arch_interaction_op=interaction,
              mlp_top=[16 + 4 * 16 if interaction == "cat" else 16 + 10, 64, 1])
    if pkg == "jax":
        return jbuild_dlrm(8, JDLRMConfig(**kw), JConfig(batch_size=8))
    return tbuild_dlrm(8, TDLRMConfig(**kw), TConfig(batch_size=8))


def test_dlrm_graph_matches():
    for interaction in ("cat", "dot"):
        jff, tff = _small("jax", interaction), _small("torch", interaction)
        assert [op.name for op in jff.layers] == [op.name for op in tff.layers]
        assert [t.name for t in jff.input_tensors] == \
            [t.name for t in tff.input_tensors]
        for jop, top in zip(jff.layers, tff.layers):
            assert type(jop).__name__ == type(top).__name__
            assert [t.shape for t in jop.outputs] == [t.shape for t in top.outputs]
            jsp, tsp = jop.param_specs(), top.param_specs()
            assert {k: tuple(v.shape) for k, v in jsp.items()} == \
                {k: tuple(v.shape) for k, v in tsp.items()}


def _record(trainer):
    """Wrap ``trainer.metrics.update`` to record each folded loss."""
    seen = []
    update = trainer.metrics.update

    def rec(m):
        seen.append(float(m["train_loss"]))
        update(m)

    trainer.metrics.update = rec
    return seen


@pytest.mark.parametrize("interaction", ["cat", "dot"])
def test_dlrm_fit_matches_jax(interaction):
    """Three ``Trainer.fit`` steps of a small DLRM (4 x 1000 x 16) from
    JAX's initial params on the fixed synthetic batch (ids in {0, 1} in
    both packages): the loss trajectory within 1e-5 and the trained
    params within the step tolerance; the port's tables took the sparse
    path (through the plain kernel versions on the CPU)."""
    jff, tff = _small("jax", interaction), _small("torch", interaction)
    jex = JExecutor(jff, optimizer=joptim.SGDOptimizer(lr=0.1),
                    devices=jax.devices()[:1])
    params, opt, state = jax.device_get(jex.init(seed=0))
    jex.init = lambda seed=None: (jax.tree.map(jnp.asarray, params), opt, state)
    jtr = JTrainer(jex)
    jseen = _record(jtr)
    jtr.fit(iterations=3, warmup=0, log_every=1, prefetch=0)
    tex = TExecutor(tff, optimizer=toptim.SGDOptimizer(lr=0.1), device="cpu")
    assert [op.name for op in tex._sparse_ops] == ["embeddings"]
    tex.init = lambda seed=None: (params_from_numpy(params, "cpu"), None, {})
    before = kernels.gather_rows.launches
    ttr = TTrainer(tex)
    tseen = _record(ttr)
    stats = ttr.fit(iterations=3, warmup=0, log_every=1)
    assert kernels.gather_rows.launches == before
    assert len(tseen) == len(jseen) == 4  # 3 logged steps + the final fold
    np.testing.assert_allclose(tseen, jseen, atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(stats["step_losses"], jseen[:3], atol=LOSS_TOL,
                               rtol=0)
    _assert_close_tree(ttr.final[0], jax.device_get(jtr.final[0]))


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


def test_dlrm_app_default_shape_on_cpu(capsys):
    stats = {}
    assert tapp.main(["-b", "8", "-i", "3", "--optimizer", "sgd", "--momentum",
                      "0", "--wd", "0", "--lr", "0.5"], device="cpu",
                     stats_out=stats) == 0
    out = capsys.readouterr().out
    assert "THROUGHPUT = " in out and "samples/s" in out
    losses = stats["step_losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_dlrm_app_lazy_adam_and_dot_on_cpu():
    stats = {}
    assert tapp.main(["-b", "8", "-i", "2", "--optimizer", "adam", "--lr",
                      "0.01", "--lazy-sparse-opt", "--arch-interaction-op",
                      "dot", "--arch-sparse-feature-size", "8",
                      "--arch-embedding-size", "50-50-50", "--arch-mlp-bot",
                      "4-8", "--arch-mlp-top", "14-8-1"], device="cpu",
                     stats_out=stats) == 0
    assert len(stats["step_losses"]) == 3 and all(np.isfinite(stats["step_losses"]))


@pytest.mark.parametrize("flag", [
    ["-d", "x.h5"], ["--dataset", "x.h5"], ["--stream-dataset"],
    ["--zc-dataset"], ["--prod-trace"], ["--trace-alpha", "1.5"],
    ["--trace-burst", "0.1"],
    # The ids these two had beside the --shard-embeddings case, which
    # now runs (test_dlrm_app_shard_embeddings_runs_on_one_rank).
    pytest.param(["-s", "s.json"], id="flag8"),
    pytest.param(["--strategy", "s.json"], id="flag9")])
def test_dlrm_app_refuses_by_name(flag):
    with pytest.raises(SystemExit) as e:
        tapp.main(["-b", "8"] + flag, device="cpu")
    assert isinstance(e.value.code, str) and flag[0] in e.value.code


def test_dlrm_app_shard_embeddings_runs_on_one_rank():
    """``--shard-embeddings`` tags each mixed-vocabulary table
    ``("c", None)``; on one rank that places it whole, and the app trains
    as without the flag (``tests/test_torch_dlrm_mesh.py`` runs it over
    two ranks)."""
    argv = ["-b", "8", "-i", "2", "--optimizer", "sgd", "--momentum", "0",
            "--wd", "0", "--arch-sparse-feature-size", "8",
            "--arch-embedding-size", "50-60-70", "--arch-mlp-bot", "4-8",
            "--arch-mlp-top", "32-8-1"]
    runs = []
    for extra in (["--shard-embeddings"], []):
        stats = {}
        assert tapp.main(argv + extra, device="cpu", stats_out=stats) == 0
        runs.append(stats)
    assert runs[0]["step_losses"] == runs[1]["step_losses"]
    ex = runs[0]["executor"]
    assert ex.param_specs()["embedding0"]["table"] == ((), ())
    op = next(op for op in ex.model.layers if op.name == "embedding0")
    assert op.param_specs()["table"].dim_axes == ("c", None)


def test_dlrm_app_refuses_a_bad_shape():
    with pytest.raises(SystemExit, match="top MLP input"):
        tapp.main(["--arch-sparse-feature-size", "8", "--arch-embedding-size",
                   "10-10", "--arch-mlp-bot", "4-8", "--arch-mlp-top",
                   "99-1"], device="cpu")
