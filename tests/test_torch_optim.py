"""The port's optimizers, loss op, metrics and synthetic batches, held
against the JAX package on the CPU with the same numpy inputs.

- ``SGDOptimizer`` (momentum, nesterov, weight decay) and
  ``AdamOptimizer`` (constant/cosine/step schedules, decoupled weight
  decay): three updates of the same params from the same grads agree
  with ``flexflow_tpu/optim.py`` within 1e-6 (relative and absolute),
  moments and step count included.
- ``SoftmaxCrossEntropy``: loss and metrics equal the JAX op's (1e-5),
  label smoothing included, on the fused (V = 1024) and the unfused
  (V = 10) JAX paths; the gradient of the loss agrees within 1e-5, and
  with bf16 logits the smoothed gradient is the f32 one within bf16
  rounding.
- ``Executor`` without an optimizer runs forwards and refuses to train.
- ``PerfMetrics``, ``mean_metrics`` and ``synthetic_host_batch`` match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.ops as jops
from flexflow_tpu import optim as joptim
from flexflow_tpu.data.loader import synthetic_host_batch as j_batch
from flexflow_tpu.metrics import PerfMetrics as JMetrics
from flexflow_tpu.ops import pallas_kernels
from flexflow_tpu.ops.base import TensorSpec as JSpec
from flexflow_tpu.runtime.executor import mean_metrics as j_mean
import flexflow_torch.ops as tops
from flexflow_torch import optim as toptim
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch as t_batch
from flexflow_torch.metrics import PerfMetrics as TMetrics
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.ops.base import TensorSpec as TSpec
from flexflow_torch.runtime.executor import mean_metrics as t_mean
from flexflow_torch.weights import opt_state_from_numpy, params_from_numpy

OPT_TOL = 1e-6
TOL = 1e-5


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    shapes = {"a": {"kernel": (6, 5), "bias": (6,)}, "b": {"table": (7, 3)}}
    return {op: {k: (scale * r.standard_normal(s)).astype(np.float32)
                 for k, s in g.items()} for op, g in shapes.items()}


def _close(got, want):
    for op in want:
        for k in want[op]:
            np.testing.assert_allclose(got[op][k].numpy(), np.asarray(want[op][k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def _run_both(jopt, topt, steps=3):
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    js = jopt.init(jp)
    ts = topt.init(tp)
    for i in range(steps):
        grads = _tree(10 + i, scale=0.1)
        grads["a"]["bias"][0] = 0.0  # a zero gradient entry
        jp, js = jopt.update(jp, js, jax.tree.map(jnp.asarray, grads))
        tp, ts = topt.update(tp, ts, params_from_numpy(grads, device="cpu"))
    _close(tp, jp)
    return js, ts


@pytest.mark.parametrize("momentum,nesterov,wd", [
    (0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 1e-4), (0.0, False, 1e-2)])
def test_sgd_matches_jax(momentum, nesterov, wd):
    js, ts = _run_both(
        joptim.SGDOptimizer(lr=0.05, momentum=momentum, nesterov=nesterov,
                            weight_decay=wd),
        toptim.SGDOptimizer(lr=0.05, momentum=momentum, nesterov=nesterov,
                            weight_decay=wd))
    if momentum:
        _close(ts, js)
    else:
        assert js is None and ts is None


@pytest.mark.parametrize("schedule,kw", [
    ("constant", {}),
    ("cosine", dict(warmup_steps=2, decay_steps=5, min_lr=1e-4)),
    ("step", dict(decay_steps=2, gamma=0.5)),
])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_jax(schedule, kw, wd):
    js, ts = _run_both(
        joptim.AdamOptimizer(lr=1e-2, weight_decay=wd, schedule=schedule, **kw),
        toptim.AdamOptimizer(lr=1e-2, weight_decay=wd, schedule=schedule, **kw),
        steps=4)
    assert ts["t"] == int(js["t"]) == 4
    _close(ts["m"], js["m"])
    _close(ts["v"], js["v"])


@pytest.mark.parametrize("schedule,kw", [
    ("cosine", dict(warmup_steps=3, decay_steps=7, min_lr=1e-5)),
    ("step", dict(decay_steps=3, gamma=0.3))])
def test_adam_schedule_matches_jax(schedule, kw):
    j = joptim.AdamOptimizer(lr=2e-3, schedule=schedule, **kw)
    t = toptim.AdamOptimizer(lr=2e-3, schedule=schedule, **kw)
    for step in range(1, 14):
        np.testing.assert_allclose(float(t._lr_at(step)),
                                   float(j._lr_at(jnp.int32(step))),
                                   rtol=OPT_TOL, atol=0)


def test_adam_step_count_lives_on_the_device_and_advances_in_place():
    """``t`` is a 0-d int32 tensor on the params' device that ``update``
    advances in place (a captured CUDA graph replays onto it), and the
    scheduled lr and bias corrections are tensors computed from it."""
    opt = toptim.AdamOptimizer(lr=1e-2, schedule="cosine", warmup_steps=2,
                               decay_steps=5)
    tp = params_from_numpy(_tree(0), device="cpu")
    ts = opt.init(tp)
    t = ts["t"]
    assert t.dtype == torch.int32 and t.dim() == 0 and int(t) == 0
    for step in (1, 2, 3):
        tp, ts = opt.update(tp, ts, params_from_numpy(_tree(step, 0.1), "cpu"))
        assert ts["t"] is t and int(t) == step
    lr, c1, c2 = opt._factors(t)
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
               for x in (lr, c1, c2))
    j = joptim.AdamOptimizer(lr=1e-2, schedule="cosine", warmup_steps=2,
                             decay_steps=5)
    np.testing.assert_allclose(float(lr), float(j._lr_at(jnp.int32(3))),
                               rtol=OPT_TOL)


def test_adam_bf16_params_keep_no_master_copy():
    """bf16 params: f32 moments, each update rounded once to bf16."""
    params = _tree(1)
    grads = _tree(2, scale=0.1)
    j = joptim.AdamOptimizer(lr=1e-2)
    t = toptim.AdamOptimizer(lr=1e-2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = params_from_numpy(params, device="cpu", dtype=torch.bfloat16)
    jgrads = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads)
    tgrads = params_from_numpy(grads, device="cpu", dtype=torch.bfloat16)
    jp, js = j.update(jp, j.init(jp), jgrads)
    tp, ts = t.update(tp, t.init(tp), tgrads)
    for op in params:
        for k in params[op]:
            assert tp[op][k].dtype == torch.bfloat16
            assert ts["m"][op][k].dtype == torch.float32
            np.testing.assert_array_equal(
                tp[op][k].float().numpy(),
                np.asarray(jp[op][k].astype(jnp.float32)))


_SPARSE_CONFIGS = [
    ("sgd", dict()), ("sgd", dict(momentum=0.9)), ("sgd", dict(weight_decay=1e-4)),
    ("sgd", dict(momentum=0.9, lazy_sparse=True)),
    ("sgd", dict(weight_decay=1e-4, lazy_sparse=True)),
    ("adam", dict()), ("adam", dict(lazy_sparse=True)),
]


def test_lazy_sparse_is_refused():
    """The row-sparse path is refused exactly where the JAX package
    refuses it: momentum, weight decay or Adam without ``lazy_sparse``
    (``--lazy-sparse-opt``) keep the tables dense; with it, the lazy row
    update is taken.  ``stateless_sparse`` (per-occurrence scatter) agrees
    too."""
    for kind, kw in _SPARSE_CONFIGS:
        cls = "SGDOptimizer" if kind == "sgd" else "AdamOptimizer"
        j, t = getattr(joptim, cls)(**kw), getattr(toptim, cls)(**kw)
        assert t.supports_sparse_rows == j.supports_sparse_rows, (kind, kw)
        assert t.stateless_sparse == j.stateless_sparse, (kind, kw)
    assert not toptim.AdamOptimizer().supports_sparse_rows
    assert not toptim.SGDOptimizer(momentum=0.9).supports_sparse_rows


@pytest.mark.parametrize("kind,kw", [
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=1e-3)),
    ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True)),
    ("sgd", dict(lr=0.1, weight_decay=1e-2)),
    ("adam", dict(lr=1e-2, weight_decay=1e-3)),
    ("adam", dict(lr=1e-2, schedule="cosine", warmup_steps=2, decay_steps=5)),
])
def test_sparse_row_step_matches_jax(kind, kw):
    """One lazy row step on gathered rows (params, gradients and state
    rows from numpy, Adam at step t = 3): the parameter and state deltas
    within 1e-6 of JAX's."""
    r = np.random.default_rng(5)
    p, g = (r.standard_normal((6, 8)).astype(np.float32) for _ in range(2))
    names = ("v",) if kind == "sgd" else ("m", "v")
    state = {n: np.abs(r.standard_normal((6, 8))).astype(np.float32)
             for n in names}
    if kind == "sgd" and not kw.get("momentum"):
        state = {}
    cls = "SGDOptimizer" if kind == "sgd" else "AdamOptimizer"
    j = getattr(joptim, cls)(lazy_sparse=True, **kw)
    t = getattr(toptim, cls)(lazy_sparse=True, **kw)
    jd, jds = j.sparse_row_step(jnp.asarray(p), jnp.asarray(g),
                                {n: jnp.asarray(a) for n, a in state.items()},
                                t=jnp.int32(3))
    td, tds = t.sparse_row_step(torch.from_numpy(p), torch.from_numpy(g),
                                {n: torch.from_numpy(a) for n, a in state.items()},
                                t=3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    assert sorted(tds) == sorted(jds)
    for n in jds:
        np.testing.assert_allclose(tds[n].numpy(), np.asarray(jds[n]),
                                   atol=1e-6, rtol=0)


def test_opt_state_converter_round_trips_jax_adam_state():
    params = _tree(3)
    j = joptim.AdamOptimizer(lr=1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    jp, js = j.update(jp, j.init(jp), jax.tree.map(jnp.asarray, _tree(4)))
    ts = opt_state_from_numpy(jax.device_get(js), device="cpu")
    assert ts["t"] == 1
    _close(ts["m"], js["m"])
    _close(ts["v"], js["v"])
    assert opt_state_from_numpy(None, device="cpu") is None


# ---------------------------------------------------------------------------
# SoftmaxCrossEntropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v,eps", [(1024, 0.0), (1024, 0.1), (10, 0.0),
                                   (10, 0.2)])
def test_softmax_cross_entropy_matches_jax(v, eps):
    """V = 1024 reaches the JAX op's fused Pallas path (its gate is
    asserted), V = 10 its unfused branch; the port runs K3 for both."""
    shape = (2, 16, v)
    fused = pallas_kernels.xent_supported(32, v)
    assert fused == (v == 1024)
    r = np.random.default_rng(v + int(10 * eps))
    logits = (2 * r.standard_normal(shape)).astype(np.float32)
    labels = r.integers(0, v, shape[:2]).astype(np.int32)
    axes = ("n", "s", None)
    jop = jops.SoftmaxCrossEntropy(
        "softmax", JSpec("lg", shape, jnp.float32, axes),
        JSpec("lb", shape[:2], jnp.int32, axes[:2]), label_smoothing=eps)
    top = tops.SoftmaxCrossEntropy(
        "softmax", TSpec("lg", shape, torch.float32, axes),
        TSpec("lb", shape[:2], torch.int32, axes[:2]), label_smoothing=eps)

    def jloss(x):
        (loss, m, _), _ = jop.forward({}, [x, jnp.asarray(labels)], {}, True)
        return loss, m

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    (tl, tm, ys), _ = top.forward({}, [x, torch.from_numpy(labels)], {}, True)
    assert ys == []  # no probabilities are materialised
    (tg,) = torch.autograd.grad(tl, x)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=TOL, rtol=0)
    assert sorted(tm) == sorted(jm)
    assert int(tm["train_correct"]) == int(jm["train_correct"])
    assert int(tm["train_all"]) == int(jm["train_all"]) == 32
    assert tm["train_correct"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL, rtol=0)


def test_loss_graph_goes_through_the_kernel_functions():
    """A training forward of the LM on the CPU: the loss's autograd graph
    reaches the K3 and K1f/K1b Functions, once per loss and per layer."""
    ff = tbuild(batch_size=2, seq_len=16, vocab_size=64, d_model=32,
                num_heads=2, num_layers=2,
                config=TConfig(batch_size=2, seed=0))
    from flexflow_torch.runtime.executor import Executor

    ex = Executor(ff, device="cpu")
    params, state = ex.init_params(), {}
    for g in params.values():
        for p in g.values():
            p.requires_grad_(True)
    batch = t_batch(ff, np.random.default_rng(0))
    loss, _, _, _ = ex.forward(params, state, batch, training=True)
    seen, stack, names = set(), [loss.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    assert names.count("_SoftmaxXentBackward") == 1
    assert names.count("_FlashAttentionBackward") == 2


def test_label_smoothing_bf16_gradient():
    """With label smoothing, the row mean's gradient is a per-row
    constant ``c = -eps / (V N)`` in the logits' dtype added to K3's
    dlogits: bf16 logits get the f32 gradient within the roundings of
    both terms and of their sum, 2^-7 of ``|grad| + |c|`` (the sum may
    cancel)."""
    shape, eps = (2, 16, 1024), 0.1
    r = np.random.default_rng(11)
    logits = (2 * r.standard_normal(shape)).astype(np.float32)
    labels = torch.from_numpy(r.integers(0, 1024, shape[:2]).astype(np.int32))
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        op = tops.SoftmaxCrossEntropy(
            "softmax", TSpec("lg", shape, dt, ("n", "s", None)),
            TSpec("lb", shape[:2], torch.int32, ("n", "s")),
            label_smoothing=eps)
        x = torch.from_numpy(logits).to(dt).requires_grad_(True)
        (loss, _, _), _ = op.forward({}, [x, labels], {}, True)
        (grads[dt],) = torch.autograd.grad(loss, x)
        assert grads[dt].dtype == dt
    # Same bf16 inputs in f32, so only the gradient's rounding differs.
    x32 = torch.from_numpy(logits).to(torch.bfloat16).float()
    x32.requires_grad_(True)
    (loss, _, _), _ = op.forward({}, [x32, labels], {}, True)
    (want,) = torch.autograd.grad(loss, x32)
    err = (grads[torch.bfloat16].float() - want).abs()
    c = eps / (shape[-1] * shape[0] * shape[1])
    assert bool((err <= 2.0 ** -7 * (want.abs() + c)).all()), err.max()


def test_executor_needs_an_optimizer_to_train():
    """An executor without an optimizer gives params and runs forwards,
    and refuses ``init`` and ``train_step``; ``forward_step`` returns the
    non-loss outputs of the same walk as ``forward``."""
    from flexflow_torch.runtime.executor import Executor

    ff = tbuild(batch_size=2, seq_len=16, vocab_size=64, d_model=32,
                num_heads=2, num_layers=1, config=TConfig(batch_size=2, seed=0))
    ex = Executor(ff, device="cpu")
    params = ex.init_params()
    batch = t_batch(ff, np.random.default_rng(0))
    with pytest.raises(ValueError, match="needs an optimizer"):
        ex.init()
    with pytest.raises(ValueError, match="needs an optimizer"):
        ex.train_step(params, None, {}, batch)
    outs = ex.forward_step(params, {"tokens": batch["tokens"]})
    with torch.no_grad():
        _, _, _, env = ex.forward(params, {}, batch, training=False)
    assert outs and all(torch.equal(v, env[k]) for k, v in outs.items())
    trained = Executor(ff, optimizer=toptim.SGDOptimizer(lr=0.1), device="cpu")
    p, s, st = trained.init()
    assert all(torch.equal(p[op][k], params[op][k])
               for op in params for k in params[op])


# ---------------------------------------------------------------------------
# metrics and batches
# ---------------------------------------------------------------------------


def test_perf_metrics_match_jax():
    steps = [{"train_loss": torch.tensor(2.5), "train_correct": torch.tensor(3),
              "train_all": torch.tensor(8), "aux": torch.tensor(0.5)},
             {"train_loss": torch.tensor(1.5), "train_correct": torch.tensor(5),
              "train_all": torch.tensor(8), "aux": torch.tensor(1.5)}]
    jm, tm = JMetrics(), TMetrics()
    for s in steps:
        jm.update({k: float(v) if v.is_floating_point() else int(v)
                   for k, v in s.items()})
        tm.update(s)
    assert tm.report() == jm.report()
    assert tm.avg_loss == jm.avg_loss and tm.accuracy == jm.accuracy


@pytest.mark.parametrize("stacked", [False, True])
def test_mean_metrics_match_jax(stacked):
    r = np.random.default_rng(5)
    shape = (3,) if stacked else ()
    m = {"train_loss": r.standard_normal(shape).astype(np.float32),
         "train_correct": np.asarray(r.integers(0, 9, shape), np.int32)}
    want = j_mean({k: jnp.asarray(v) for k, v in m.items()}, count=3,
                  stacked=stacked)
    got = t_mean({k: torch.from_numpy(np.asarray(v)) for k, v in m.items()},
                 count=3, stacked=stacked)
    for k in m:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-7, atol=0)
        assert got[k].is_floating_point() == (k == "train_loss")


def test_synthetic_batch_matches_jax():
    from flexflow_tpu.config import FFConfig as JConfig
    from flexflow_tpu.models.transformer import build_transformer_lm as jbuild

    kw = dict(batch_size=2, seq_len=16, vocab_size=64, d_model=32,
              num_heads=2, num_layers=1)
    jb = j_batch(jbuild(config=JConfig(batch_size=2), **kw),
                 np.random.default_rng(3))
    tb = t_batch(tbuild(config=TConfig(batch_size=2), **kw),
                 np.random.default_rng(3))
    assert sorted(jb) == sorted(tb) == ["label", "tokens"]
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
        assert tb[k].dtype == np.int32 and set(np.unique(tb[k])) <= {0, 1}
    hi = {"tokens": 64, "label": 64}
    np.testing.assert_array_equal(
        t_batch(tbuild(config=TConfig(batch_size=2), **kw),
                np.random.default_rng(4), hi)["tokens"],
        j_batch(jbuild(config=JConfig(batch_size=2), **kw),
                np.random.default_rng(4), hi)["tokens"])
