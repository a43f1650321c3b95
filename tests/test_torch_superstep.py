"""The port's supersteps, gradient accumulation and remat (ROADMAP item
6), held against the JAX package and against the port's own plain
steps on the CPU.

On the CPU ``Executor.build_superstep`` runs its k steps as a loop (on
CUDA they are one CUDA graph: ``chip_smoke.py``'s ``superstep`` phase
holds that path on the card).  The JAX parameters are carried into the
port with ``params_from_numpy`` and both packages train on the same
numpy batches.  Bars (f32):

- against JAX, the small LM of ``test_torch_training.py`` (its flash and
  cross-entropy Pallas kernels in interpret mode): every step's loss
  within ``LOSS_TOL`` = 1e-5 over 6 Adam steps, and the params within
  ``PARAM_TOL`` = 4e-6 (the worst measured is 8.2e-7), except the key
  biases: their gradient is rounding noise, which Adam's first steps
  follow by about lr each way, so they are held within ``6 * lr``;
- the MLP of the JAX package's accumulation test (``tests/
  test_accum_prefetch.py``): rtol 1e-5, atol 1e-6, as there; remat as
  in ``tests/test_optim_remat.py``: rtol 1e-6, atol 1e-7;
- the small DLRM of ``test_torch_dlrm.py`` (plain SGD, row-sparse):
  ``test_torch_dlrm.py``'s step bars;
- inside the port, K fused steps against K sequential ones, the
  superstep loop's losses against the per-step loop's, and remat's
  params against the plain step's: bit for bit.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optim as joptim
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_torch import optim as toptim
from flexflow_torch.apps import alexnet as talexnet
from flexflow_torch.apps import dlrm as tdlrm
from flexflow_torch.apps import transformer as ttransformer
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.graph import FFModel as TModel
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.runtime import graphs
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.trainer import MAX_STEPS_PER_CALL, Trainer
from flexflow_torch.weights import opt_state_from_numpy, params_from_numpy

V, D, H, L, B, S = 1024, 32, 2, 2, 2, 16
LR = 1e-3
LOSS_TOL = 1e-5
PARAM_TOL = 4e-6
ACCUM_TOL = dict(rtol=1e-5, atol=1e-6)
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)


def _assert_bits(a, b):
    """Two trees of tensors equal bit for bit."""
    assert sorted(a) == sorted(b)
    for op in a:
        assert sorted(a[op]) == sorted(b[op])
        for k in a[op]:
            assert torch.equal(a[op][k], b[op][k]), (op, k)


# -- the small LM against JAX ------------------------------------------------


def _lm_kw():
    return dict(batch_size=B, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L)


def _lm_batches(n):
    ff = tbuild(config=TConfig(batch_size=B), **_lm_kw())
    return [synthetic_host_batch(ff, np.random.default_rng(10 + i),
                                 {"tokens": V, "label": V}) for i in range(n)]


def _jax_lm(remat=False):
    lm = jbuild(config=JConfig(batch_size=B, seed=0, remat=remat), **_lm_kw())
    return JExecutor(lm, config=lm.config,
                     optimizer=joptim.AdamOptimizer(lr=LR),
                     devices=jax.devices()[:1])


def _torch_lm(remat=False):
    lm = tbuild(config=TConfig(batch_size=B, seed=0, remat=remat), **_lm_kw())
    return TExecutor(lm, config=lm.config,
                     optimizer=toptim.AdamOptimizer(lr=LR), device="cpu")


@pytest.fixture(scope="module")
def lm_start():
    """JAX's initial (params, opt_state) on the host."""
    params, opt, _ = jax.device_get(_jax_lm().init(seed=0))
    return params, opt


def _jax_supersteps(jex, start, batches, k):
    params, opt = jax.tree.map(jnp.asarray, start)
    fn = jex.build_superstep(k)
    state, losses = {}, []
    for i in range(0, len(batches), k):
        params, opt, state, ms = fn(params, opt, state,
                                    jex.stack_steps(batches[i:i + k]))
        losses.extend(np.asarray(jax.device_get(ms["train_loss"])))
    return np.array(losses), jax.device_get(params), jax.device_get(opt)


def _torch_supersteps(tex, start, batches, k):
    params = params_from_numpy(start[0], device="cpu")
    opt = opt_state_from_numpy(start[1], device="cpu")
    fn = tex.build_superstep(k)
    state, losses = {}, []
    for i in range(0, len(batches), k):
        params, opt, state, ms = fn(params, opt, state,
                                    tex.stack_steps(batches[i:i + k]))
        assert ms["train_loss"].shape == (k,)
        losses.extend(ms["train_loss"].tolist())
    return np.array(losses), params, opt


def _assert_lm_params_close(got, want, steps):
    for op, group in want.items():
        for k, w in group.items():
            err = float(np.abs(got[op][k].detach().numpy() - w).max())
            # The key biases' gradient is zero in exact arithmetic (a
            # softmax row is invariant to a shift): Adam moves them by
            # about lr along the sign of rounding noise, either way.
            tol = steps * LR if k == "bk" else PARAM_TOL
            assert err <= tol, (op, k, err)


@pytest.mark.parametrize("remat", [False, True])
def test_lm_superstep_matches_jax(lm_start, remat):
    """Two supersteps of k = 3 on the small LM: the stacked losses and
    the params after 6 steps against JAX's ``build_superstep``; with
    ``remat`` both packages recompute every layer (JAX's ``--remat``)."""
    batches = _lm_batches(6)
    jl, jp, jo = _jax_supersteps(_jax_lm(remat), lm_start, batches, 3)
    tl, tp, to = _torch_supersteps(_torch_lm(remat), lm_start, batches, 3)
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    _assert_lm_params_close(tp, jp, 6)
    assert int(to["t"]) == int(jo["t"]) == 6


def test_fused_steps_equal_sequential_steps_bit_for_bit(lm_start):
    """The port's counterpart of ``tests/test_superstep.py``'s
    bit-identity: 6 sequential ``train_step``s against two supersteps of
    3, losses, params and Adam state."""
    batches = _lm_batches(6)
    tex = _torch_lm()
    params = params_from_numpy(lm_start[0], device="cpu")
    opt = opt_state_from_numpy(lm_start[1], device="cpu")
    state, losses = {}, []
    for b in batches:
        params, opt, state, m = tex.train_step(params, opt, state,
                                               tex.shard_batch(b))
        losses.append(float(m["train_loss"]))
    sl, sp, so = _torch_supersteps(_torch_lm(), lm_start, batches, 3)
    assert sl.tolist() == losses
    _assert_bits(sp, params)
    _assert_bits(so["m"], opt["m"])
    _assert_bits(so["v"], opt["v"])
    assert torch.equal(so["t"], opt["t"])


def test_remat_equals_the_plain_step_in_the_port(lm_start):
    """--remat recomputes the same ops in the backward: three Adam steps
    give the plain steps' params bit for bit (the JAX package holds its
    own within rtol 1e-6), and the loss op is not recomputed."""
    batches = _lm_batches(3)
    out = []
    for remat in (False, True):
        tex = _torch_lm(remat)
        params = params_from_numpy(lm_start[0], device="cpu")
        opt = tex.optimizer.init(params)
        for b in batches:
            params, opt, _, _ = tex.train_step(params, opt, {}, b)
        out.append(params)
    _assert_bits(out[0], out[1])
    assert not any(op.allow_remat for op in tex.model.layers)


def test_remat_checkpoints_every_op_but_the_loss(monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *a, **kw):
        calls.append((fn.__self__.name, kw))
        return real(fn, *a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    tex = _torch_lm(remat=True)
    params = tex.init_params()
    tex.loss_and_grads(params, {}, _lm_batches(1)[0])
    names = [n for n, _ in calls]
    assert names == [op.name for op in tex.model.layers if not op.is_loss]
    assert all(kw == dict(use_reentrant=False, preserve_rng_state=False)
               for _, kw in calls)
    calls.clear()
    tex.eval_step(params, {}, _lm_batches(1)[0])
    assert calls == []  # only a training forward recomputes


# -- the MLP of the JAX package's accumulation tests -------------------------


def _mlp(pkg, batch, sum_loss=False, remat=False):
    if pkg == "jax":
        ff, i32 = JModel(JConfig(batch_size=batch, remat=remat)), np.int32
    else:
        ff, i32 = TModel(TConfig(batch_size=batch, remat=remat)), torch.int32
    x = ff.create_tensor((batch, 16), name="x")
    if sum_loss:
        y = ff.create_tensor((batch, 4), name="label")
        ff.mse_loss(ff.dense(x, 4, name="fc"), y, reduction="sum", name="mse")
        return ff
    lbl = ff.create_tensor((batch,), dtype=i32, name="label")
    t = ff.dense(x, 32, activation="relu", name="fc1")
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _mlp_batch(seed, batch):
    r = np.random.default_rng(seed)
    return {"x": r.standard_normal((batch, 16)).astype(np.float32),
            "label": r.integers(0, 4, size=(batch,)).astype(np.int32)}


def _tmlp_executor(batch, opt=None, **kw):
    return TExecutor(_mlp("torch", batch, **kw),
                     optimizer=opt or toptim.SGDOptimizer(lr=0.1, momentum=0.9),
                     device="cpu")


def test_accum_matches_jax_and_one_full_batch_step():
    """Two accumulated microbatches of 8 against one step on the batch of
    16 (``tests/test_accum_prefetch.py``'s case), and against JAX's
    ``accum_train_step`` from the same params."""
    full = _mlp_batch(0, 16)
    jex = JExecutor(_mlp("jax", 8),
                    optimizer=joptim.SGDOptimizer(lr=0.1, momentum=0.9),
                    devices=jax.devices()[:1])
    p0, o0, _ = jax.device_get(jex.init(seed=0))
    jp, jo, _, jm = jex.accum_train_step(2)(
        jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, o0), {},
        jex.stack_microbatches(full, 2))

    acc = _tmlp_executor(8)
    tp = params_from_numpy(p0, device="cpu")
    tp, to, _, tm = acc.accum_train_step(2)(
        tp, acc.optimizer.init(tp), {}, acc.stack_microbatches(full, 2))
    ref = _tmlp_executor(16)
    rp = params_from_numpy(p0, device="cpu")
    rp, _, _, rm = ref.train_step(rp, ref.optimizer.init(rp), {}, full)
    for op, group in jax.device_get(jp).items():
        for k, want in group.items():
            got = tp[op][k].detach().numpy()
            np.testing.assert_allclose(got, want, **ACCUM_TOL)
            np.testing.assert_allclose(got, rp[op][k].detach().numpy(),
                                       **ACCUM_TOL)
            np.testing.assert_allclose(to[op][k].numpy(),
                                       np.asarray(jo[op][k]), **ACCUM_TOL)
    assert int(tm["train_all"]) == int(jm["train_all"]) == 16
    assert int(tm["train_correct"]) == int(jm["train_correct"])
    np.testing.assert_allclose(float(tm["train_loss"]),
                               float(jm["train_loss"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tm["train_loss"]),
                               float(rm["train_loss"]), atol=1e-6, rtol=0)


def test_accum_grads_are_dense_and_counts_sum():
    """Four microbatches of 8: counts sum, and the row-sparse path is not
    taken (the JAX package's accumulation differentiates the tables)."""
    ex = _tmlp_executor(8, opt=toptim.SGDOptimizer(lr=0.01))
    params, opt, state = ex.init()
    stacked = ex.stack_microbatches(_mlp_batch(1, 32), 4)
    _, _, _, m = ex.accum_train_step(4)(params, opt, state, stacked)
    assert int(m["train_all"]) == 32
    assert m["train_loss"].dtype == torch.float32
    assert np.isfinite(float(m["train_loss"]))


def test_accum_refuses_sum_reduction_losses():
    ex = _tmlp_executor(4, sum_loss=True)
    with pytest.raises(ValueError, match="mean-reduction"):
        ex.accum_train_step(2)
    with pytest.raises(ValueError, match="mean-reduction"):
        ex.build_superstep(2, accum_steps=2)


def test_stack_microbatches_needs_equal_microbatches():
    with pytest.raises(ValueError, match="multiple of accum_steps"):
        TExecutor.stack_microbatches(_mlp_batch(0, 6), 4)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_mlp_matches_jax(remat):
    """``tests/test_optim_remat.py``'s remat case, and the plain step, in
    both packages: three momentum-SGD steps from one init."""
    batch = _mlp_batch(2, 8)
    jex = JExecutor(_mlp("jax", 8, remat=remat),
                    optimizer=joptim.SGDOptimizer(lr=0.1, momentum=0.9),
                    devices=jax.devices()[:1])
    jp, jo, js = jex.init(seed=0)
    p0 = jax.device_get(jp)
    tex = _tmlp_executor(8, remat=remat)
    tp = params_from_numpy(p0, device="cpu")
    to = tex.optimizer.init(tp)
    for _ in range(3):
        jp, jo, js, _ = jex.train_step(jp, jo, js, batch)
        tp, to, _, _ = tex.train_step(tp, to, {}, batch)
    for op, group in jax.device_get(jp).items():
        for k, want in group.items():
            np.testing.assert_allclose(tp[op][k].detach().numpy(), want,
                                       **REMAT_TOL)


# -- the superstep's layout and loop -----------------------------------------


def test_stack_steps_layout_and_order():
    ex = _tmlp_executor(4)
    batches = [_mlp_batch(i, 4) for i in range(3)]
    st = ex.stack_steps(batches)
    assert list(st) == ["label", "x"]  # integer inputs staged first
    assert st["x"].shape == (3, 4, 16) and st["x"].dtype == torch.float32
    assert st["label"].shape == (3, 4) and st["label"].dtype == torch.int32
    for j, b in enumerate(batches):
        np.testing.assert_array_equal(st["x"][j].numpy(), b["x"])
        np.testing.assert_array_equal(st["label"][j].numpy(), b["label"])
    acc = _tmlp_executor(2).stack_steps(batches, accum_steps=2)
    assert acc["x"].shape == (3, 2, 2, 16) and acc["label"].shape == (3, 2, 2)
    np.testing.assert_array_equal(acc["x"][1, 1].numpy(), batches[1]["x"][2:])
    # Tensors (already placed batches) stack alike.
    tens = ex.stack_steps([ex.shard_batch(b) for b in batches])
    for name in st:
        assert torch.equal(tens[name], st[name])


def test_metrics_row():
    ms = {"train_loss": torch.tensor([1.0, 2.0, 3.0]),
          "train_all": torch.tensor([4, 5, 6])}
    row = TExecutor.metrics_row(ms, 1)
    assert float(row["train_loss"]) == 2.0 and int(row["train_all"]) == 5
    host = {"train_loss": [1.0, 2.0], "train_all": [7, 8]}
    assert TExecutor.metrics_row(host, 0) == {"train_loss": 1.0,
                                             "train_all": 7}


def _fit(k=1, **kw):
    ex = _tmlp_executor(8)
    built = []
    real = ex.build_superstep

    def spy(n, accum_steps=1):
        built.append(n)
        return real(n, accum_steps)

    ex.build_superstep = spy
    stats = Trainer(ex).fit(steps_per_call=k, **kw)
    return stats, built


@pytest.mark.parametrize("warmup,iterations,want_warm,supersteps", [
    (1, 6, 3, 2), (3, 5, 3, 2), (4, 7, 6, 3), (0, 4, 0, 2)])
def test_superstep_warmup_rounds_up_and_a_tail_runs(warmup, iterations,
                                                    want_warm, supersteps):
    """k = 3: warmup rounds up to whole supersteps; ``iterations % 3``
    steps run as one shorter superstep.  Every step's loss equals the
    per-step loop's over the same number of steps, bit for bit."""
    stats, built = _fit(k=3, iterations=iterations, warmup=warmup)
    assert stats["iterations"] == iterations
    assert stats["steps_per_call"] == 3
    assert stats["supersteps"] == supersteps
    assert sorted(set(built)) == sorted({3} | ({iterations % 3} - {0}))
    plain, _ = _fit(iterations=iterations + want_warm - 1, warmup=1)
    assert len(stats["step_losses"]) == want_warm + iterations
    assert stats["step_losses"] == plain["step_losses"]


def test_superstep_clamps_at_the_cap(caplog):
    with caplog.at_level(logging.WARNING, logger="ff.trainer"):
        stats, built = _fit(k=MAX_STEPS_PER_CALL + 1,
                            iterations=MAX_STEPS_PER_CALL, warmup=0)
    assert stats["steps_per_call"] == MAX_STEPS_PER_CALL == 20
    assert built == [20] and stats["supersteps"] == 1
    assert "clamping to 20" in caplog.text


def test_superstep_with_accum_equals_the_accumulated_loop():
    stats, _ = _fit(k=2, iterations=4, warmup=2, accum_steps=2)
    plain, _ = _fit(iterations=5, warmup=1, accum_steps=2)
    assert stats["step_losses"] == plain["step_losses"]


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: what the
    capture ran is what a replay would run."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _NoCapture:
    def __init__(self, graph):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _graph_on_cpu(monkeypatch, step, k=2):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _NoCapture)
    return graphs.StepGraph(step, k, torch.device("cuda"))


def test_step_graph_refuses_other_tensors_than_the_captured(monkeypatch):
    """A replay writes into the tensors captured; a call with others
    raises, and so does a call with another input shape."""
    def step(p, batch):
        p["w"].add_(batch["x"].sum())
        return p, {"s": p["w"].sum()}

    g = _graph_on_cpu(monkeypatch, step)
    p = {"w": torch.zeros(3)}
    stacked = {"x": torch.ones(2, 4)}
    g.capture(p, stacked)
    assert g.captured and torch.equal(g.static_inputs["x"], stacked["x"])
    assert g.static_inputs["x"] is not stacked["x"]
    p2, ms = g(p, stacked)
    assert p2 is p and g._graph.replays == 1 and ms["s"].shape == (2,)
    g(p, g.static_inputs)  # its own buffer: nothing copied
    assert g._graph.replays == 2
    with pytest.raises(ValueError, match="captured on other tensors"):
        g({"w": p["w"].clone()}, stacked)
    with pytest.raises(ValueError, match="captured at"):
        g(p, {"x": torch.ones(2, 5)})
    with pytest.raises(RuntimeError, match="already captured"):
        g.capture(p, stacked)
    assert g._graph.replays == 2


def test_step_graph_captures_with_the_collector_paused(monkeypatch):
    """The cyclic collector is paused during a capture (a dead graph
    destroyed mid-capture invalidates the capture on the card), then
    resumed, also after a failed capture."""
    import gc

    enabled = []

    def step(p, batch):
        enabled.append(gc.isenabled())
        p["w"].add_(1.0)
        return p, {"s": p["w"].sum()}

    assert gc.isenabled()
    _graph_on_cpu(monkeypatch, step).capture({"w": torch.zeros(3)},
                                             {"x": torch.ones(2, 4)})
    assert enabled == [False, False] and gc.isenabled()

    def planted(p, batch):
        raise RuntimeError("planted")

    with pytest.raises(RuntimeError, match="planted"):
        _graph_on_cpu(monkeypatch, planted).capture(
            {"w": torch.zeros(3)}, {"x": torch.ones(2, 4)})
    assert gc.isenabled()


def test_step_graph_refuses_a_step_that_rebinds_its_state(monkeypatch):
    def step(p, batch):
        return {"w": p["w"] + batch["x"].sum()}, {"s": p["w"].sum()}

    g = _graph_on_cpu(monkeypatch, step)
    with pytest.raises(RuntimeError, match="updated in place"):
        g.capture({"w": torch.zeros(3)}, {"x": torch.ones(2, 4)})
    assert not g.captured


def test_train_steps_keep_their_tensors(lm_start):
    """What a graph needs of the port's steps: the dense, accumulated
    and row-sparse train steps hand back the tensors they were given
    (Adam's ``t`` included), updated in place."""
    tex = _torch_lm()
    params = params_from_numpy(lm_start[0], device="cpu")
    opt = opt_state_from_numpy(lm_start[1], device="cpu")
    before = [t.data_ptr() for t in graphs.tensor_leaves((params, opt))]
    batch = tex.shard_batch(_lm_batches(1)[0])
    out = tex.train_step(params, opt, {}, batch)[:2]
    assert [t.data_ptr() for t in graphs.tensor_leaves(out)] == before
    step = tex.accum_train_step(2)
    out = step(params, opt, {}, tex.stack_microbatches(batch, 2))[:2]
    assert [t.data_ptr() for t in graphs.tensor_leaves(out)] == before
    assert int(opt["t"]) == 2


def test_superstep_on_the_cpu_captures_nothing():
    ex = _tmlp_executor(4)
    fn = ex.build_superstep(2)
    params, opt, state = ex.init()
    fn(params, opt, state, ex.stack_steps([_mlp_batch(0, 4)] * 2))
    assert not fn.captured
    with pytest.raises(ValueError, match="only a step graph on CUDA"):
        fn.capture(params, opt, state, ex.stack_steps([_mlp_batch(0, 4)] * 2))
    with pytest.raises(ValueError, match=">= 1"):
        ex.build_superstep(0)


# -- the row-sparse DLRM against JAX -----------------------------------------


def _dlrm(pkg, batch=8):
    """``test_torch_dlrm.py``'s sparse model: a stacked table and a bag
    embedding, duplicate ids in both."""
    if pkg == "jax":
        ff, i32 = JModel(JConfig(batch_size=batch)), np.int32
    else:
        ff, i32 = TModel(TConfig(batch_size=batch)), torch.int32
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


def _dlrm_batch(seed, batch=8):
    r = np.random.default_rng(seed)
    return {"ids": r.integers(0, 4, (batch, 4)).astype(np.int32),
            "bag": r.integers(0, 6, (batch, 3)).astype(np.int32),
            "label": r.integers(0, 4, (batch,)).astype(np.int32)}


def test_dlrm_sparse_superstep_matches_jax():
    """Plain SGD on the row-sparse path: two supersteps of k = 2 against
    JAX's, losses within 1e-5 and each param within 1e-5 of its tensor's
    largest magnitude plus 1e-7 (``test_torch_dlrm.py``'s step bars: the
    two packages sum duplicate ids' updates in other orders)."""
    batches = [_dlrm_batch(s) for s in range(4)]
    jex = JExecutor(_dlrm("jax"), optimizer=joptim.SGDOptimizer(lr=0.3),
                    devices=jax.devices()[:1])
    p0, _, _ = jax.device_get(jex.init(seed=0))
    tex = TExecutor(_dlrm("torch"), optimizer=toptim.SGDOptimizer(lr=0.3),
                    device="cpu")
    assert {op.name for op in tex._sparse_ops} == {"tables", "bagged"}
    jl, jp, _ = _jax_supersteps(jex, (p0, None), batches, 2)
    tl, tp, to = _torch_supersteps(tex, (p0, None), batches, 2)
    assert to is None
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    for op, group in jp.items():
        for k, want in group.items():
            np.testing.assert_allclose(
                tp[op][k].detach().numpy(), want, rtol=0,
                atol=1e-5 * float(np.abs(want).max()) + 1e-7)


# -- the apps -----------------------------------------------------------------


_LM_APP = ["-b", "4", "--seq", "16", "--layers", "2", "--vocab", "64",
           "--d-model", "32", "--heads", "2", "--optimizer", "adam", "--lr",
           "1e-2", "--seed", "3"]


@pytest.mark.parametrize("flags,steps", [
    (["--steps-per-call", "2", "-i", "4"], 6),
    (["--accum-steps", "2", "--remat", "-i", "3"], 4),
    (["--accum-steps", "2", "--remat", "--steps-per-call", "2", "-i", "3"], 5),
])
def test_transformer_app_runs_the_new_flags(flags, steps):
    stats = {}
    assert ttransformer.main(_LM_APP + flags, device="cpu",
                             stats_out=stats) == 0
    losses = stats["step_losses"]
    assert len(losses) == steps and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_transformer_app_superstep_equals_its_per_step_run():
    """The app with ``--steps-per-call 2`` (one warmup step rounds up to
    two) against the app without it over the same 6 steps."""
    a, b = {}, {}
    ttransformer.main(_LM_APP + ["--steps-per-call", "2", "-i", "4"],
                      device="cpu", stats_out=a)
    ttransformer.main(_LM_APP + ["-i", "5"], device="cpu", stats_out=b)
    assert a["step_losses"] == b["step_losses"]
    _assert_bits(a["final"][0], b["final"][0])


def test_dlrm_app_runs_supersteps():
    stats = {}
    assert tdlrm.main(["-b", "8", "-i", "4", "--optimizer", "sgd",
                       "--momentum", "0", "--wd", "0", "--lr", "0.5",
                       "--steps-per-call", "2"], device="cpu",
                      stats_out=stats) == 0
    losses = stats["step_losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert stats["steps_per_call"] == 2 and stats["supersteps"] == 2


def test_alexnet_app_runs_supersteps():
    stats = {}
    assert talexnet.main(["-b", "2", "--image-size", "67", "-i", "2",
                          "--seed", "3", "--steps-per-call", "2"],
                         device="cpu", stats_out=stats) == 0
    losses = stats["step_losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert stats["supersteps"] == 1


@pytest.mark.parametrize("flags,what", [
    (["--accum-steps", "3"], "microbatches"),
    (["--remat", "--resilient", "--accum-steps", "2"], "--resilient"),
    (["--remat", "--telemetry"], "--telemetry"),
])
def test_training_apps_refuse_what_does_not_fit(flags, what):
    """The refusal walk steps over the bare ``--remat`` and over each
    flag's value, and still names the flag it refuses."""
    with pytest.raises(SystemExit) as e:
        ttransformer.main(_LM_APP + flags, device="cpu")
    assert isinstance(e.value.code, str) and what in e.value.code
