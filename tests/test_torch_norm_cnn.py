"""The port's BatchNorm, the FFModel builders ``batch_norm``, ``find_op``
and ``summary``, the CNN catalog (VGG-16, Inception-v3, DenseNet-121,
ResNet-101) and ``apps.cnn``, held against the JAX package on the CPU.

No full catalog model is computed in JAX (its Inception step alone takes
about a minute): the whole graphs are held equal through ``summary()``,
and the numbers on graphs built from the catalog's own pieces
(``_inception_a`` ... ``_inception_e``) and on a hand-built dense block
and transition (BN -> conv -> BN -> conv -> concat, conv -> avg pool).
JAX's parameters and op state are carried across with
``params_from_numpy`` / ``state_from_numpy``.  Bars:

- BatchNorm's forward, f32: ``y`` and the running statistics within
  ``TOL`` = 1e-5; bf16: within one bf16 ulp (2^-8 of the element, plus
  2^-14 for elements near zero), since the f32 statistics are summed in
  other orders before the one rounding;
- BatchNorm's gradients against ``jax.vjp`` and every graph's gradients
  within ``GRAD_RTOL`` = 1e-4 of the tensor's largest magnitude plus
  ``GRAD_ATOL`` = 1e-7;
- a train step (SGD, lr ``LR``): the loss within ``TOL``, each updated
  parameter within lr x its gradient bar plus 2^-22 of the parameter's
  largest magnitude, the running statistics within ``TOL``;
- three steps and two accumulated microbatches of a small conv/BN graph:
  the same bars, the statistics advancing once per microbatch as JAX's
  scan threads them.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optim as joptim
from flexflow_tpu.apps import cnn as jcnn
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models import cnn_catalog as jcat
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_torch import optim as toptim
from flexflow_torch.apps import cnn as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.graph import FFModel as TModel
from flexflow_torch.models import cnn_catalog as tcat
from flexflow_torch.ops.norm import BatchNorm
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.weights import params_from_numpy, state_from_numpy

TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7
LR = 0.1
N, HW, C = 4, 6, 8


def _bn_pair(relu, dtype):
    ops = []
    for ff, mod in ((JModel(JConfig(batch_size=N)), jnp),
                    (TModel(TConfig(batch_size=N)), torch)):
        x = ff.create_tensor((N, HW, HW, C), dtype=getattr(mod, dtype),
                             name="x")
        ff.batch_norm(x, relu=relu, name="bn")
        ops.append(ff.find_op("bn"))
    return ops


def _bn_inputs(seed=0):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((N, HW, HW, C)) * 2.0 + 0.5).astype(np.float32)
    p = {"scale": (1.0 + 0.3 * r.standard_normal(C)).astype(np.float32),
         "bias": (0.2 * r.standard_normal(C)).astype(np.float32)}
    s = {"running_mean": (0.1 * r.standard_normal(C)).astype(np.float32),
         "running_var": (1.0 + 0.2 * r.random(C)).astype(np.float32)}
    return x, p, s


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        return float(np.abs(got - want).max()) <= TOL
    return bool((np.abs(got - want)
                 <= 2.0 ** -8 * np.abs(want) + 2.0 ** -14).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_forward_matches_jax(dtype, relu, training):
    jop, top = _bn_pair(relu, dtype)
    x, p, s = _bn_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    (jy,), js = jop.forward({k: jnp.asarray(v, jdt) for k, v in p.items()},
                            [jnp.asarray(x, jdt)],
                            {k: jnp.asarray(v, jdt) for k, v in s.items()},
                            training)
    tp = params_from_numpy({"bn": p}, "cpu", tdt)["bn"]
    ts = params_from_numpy({"bn": s}, "cpu", tdt)["bn"]
    (ty,), tns = top.forward(tp, [torch.from_numpy(x).to(tdt)], ts, training)
    assert ty.dtype == tdt
    assert _close(ty.float().numpy(), jy.astype(jnp.float32), dtype)
    if relu:
        assert float(ty.min()) == 0.0
    if not training:
        assert tns is ts
    for k in s:
        assert tns[k].dtype == tdt
        assert _close(tns[k].float().numpy(), js[k].astype(jnp.float32),
                      dtype), k
        if training:
            assert not np.array_equal(tns[k].float().numpy(), s[k])


def test_batch_norm_gradients_match_jax():
    jop, top = _bn_pair(True, "float32")
    x, p, s = _bn_inputs(1)
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jf(p, x):
        (y,), _ = jop.forward(p, [x], {k: jnp.asarray(v) for k, v in s.items()},
                              True)
        return jnp.sum(y * g)

    jg = jax.grad(jf, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (y,), _ = top.forward(tp, [tx], {k: torch.from_numpy(v)
                                     for k, v in s.items()}, True)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                              [tp["scale"], tp["bias"], tx])
    for gt, w in zip(got, [jg[0]["scale"], jg[0]["bias"], jg[1]]):
        w = np.asarray(w)
        assert float(np.abs(gt.numpy() - w).max()) <= \
            GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL


def test_batch_norm_specs_match_jax():
    jop, top = _bn_pair(False, "bfloat16")
    for what in ("param_specs", "state_specs"):
        js, ts = getattr(jop, what)(), getattr(top, what)()
        assert sorted(js) == sorted(ts)
        for k in js:
            assert js[k].shape == ts[k].shape
            assert ts[k].dtype == torch.bfloat16
    assert isinstance(top, BatchNorm) and top.attrs == jop.attrs


# -- the whole catalog: graphs held equal through summary() -------------------


@pytest.mark.parametrize("model", sorted(tapp.MODELS))
def test_catalog_summary_matches_jax(model):
    jb, jsize = jcnn.MODELS[model]
    tb, tsize = tapp.MODELS[model]
    assert jsize == tsize
    jff = jb(batch_size=2, image_size=jsize, num_classes=10,
             config=JConfig(batch_size=2))
    tff = tb(batch_size=2, image_size=tsize, num_classes=10,
             config=TConfig(batch_size=2))
    assert tff.summary() == jff.summary()
    for jop, top in zip(jff.layers, tff.layers):
        assert {k: s.shape for k, s in jop.param_specs().items()} == \
            {k: s.shape for k, s in top.param_specs().items()}
        assert sorted(jop.state_specs()) == sorted(top.state_specs())


def test_find_op_and_summary_format():
    tff = tcat.build_densenet121(batch_size=2, num_classes=10,
                                 config=TConfig(batch_size=2))
    bn = tff.find_op("db4_l15_bn2")
    assert isinstance(bn, BatchNorm) and bn.attrs["relu"]
    with pytest.raises(KeyError):
        tff.find_op("nope")
    lines = tff.summary().splitlines()
    assert lines[0] == f"input   {'image':24s} (2, 224, 224, 3)"
    assert lines[-1].startswith("SoftmaxCrossEntropy") and \
        lines[-1].endswith("-> (2, 10)")
    assert sum(isinstance(op, BatchNorm) for op in tff.layers) == 1 + 2 * (6 + 12 + 24 + 16)
    assert tcat.CH_AXIS == 3


# -- train steps on the catalog's pieces ---------------------------------------


def _dense_block(ff, x, tag="db"):
    """Two DenseNet layers and a transition, as ``build_densenet121``
    builds them (growth 8)."""
    last = x
    for i in range(2):
        u = ff.batch_norm(last, relu=True, name=f"{tag}_l{i}_bn1")
        u = ff.conv2d(u, 32, 1, 1, 1, 1, 0, 0, activation=None,
                      name=f"{tag}_l{i}_conv1")
        u = ff.batch_norm(u, relu=True, name=f"{tag}_l{i}_bn2")
        u = ff.conv2d(u, 8, 3, 3, 1, 1, 1, 1, activation=None,
                      name=f"{tag}_l{i}_conv2")
        last = ff.concat([last, u], axis=3, name=f"{tag}_l{i}_cat")
    t = ff.conv2d(last, 12, 1, 1, 1, 1, 0, 0, activation="relu",
                  name="tr_conv")
    return ff.pool2d(t, 2, 2, 2, 2, 0, 0, pool_type="avg", name="tr_pool")


#: piece -> (input (h, c), builder given the catalog module).
PIECES = {
    "inception_a": (9, lambda m, ff, x: m._inception_a(ff, x, 8, "a")),
    "inception_b": (9, lambda m, ff, x: m._inception_b(ff, x, "b")),
    "inception_c": (9, lambda m, ff, x: m._inception_c(ff, x, 12, "c")),
    "inception_d": (9, lambda m, ff, x: m._inception_d(ff, x, "d")),
    "inception_e": (5, lambda m, ff, x: m._inception_e(ff, x, "e")),
    "dense_block": (8, lambda m, ff, x: _dense_block(ff, x)),
}


def _piece_graph(pkg, piece, batch=2, cin=16):
    hw, body = PIECES[piece]
    if pkg == "jax":
        ff, mod, cat = JModel(JConfig(batch_size=batch, seed=0)), jnp, jcat
    else:
        ff, mod, cat = TModel(TConfig(batch_size=batch, seed=0)), torch, tcat
    x = ff.create_tensor((batch, hw, hw, cin), name="image")
    label = ff.create_tensor((batch,), dtype=mod.int32, name="label")
    t = body(cat, ff, x)
    k = t.shape[1]
    t = ff.pool2d(t, k, k, 1, 1, 0, 0, pool_type="avg", name="avgpool")
    cat._head(ff, t, label, 10)
    return ff


def _piece_batch(ff, seed, batch=None):
    r = np.random.default_rng(seed)
    img = ff.input_tensors[0].shape
    n = batch or img[0]
    return {"image": r.standard_normal((n,) + img[1:]).astype(np.float32),
            "label": r.integers(0, 10, size=(n,)).astype(np.int32)}


def _grad_ok(got, want):
    return float(np.abs(got - want).max()) <= \
        GRAD_RTOL * float(np.abs(want).max()) + GRAD_ATOL


def _param_ok(got, p0, g):
    bar = LR * (GRAD_RTOL * float(np.abs(g).max()) + GRAD_ATOL) + \
        2.0 ** -22 * float(np.abs(p0).max())
    return float(np.abs(got - (p0 - np.float32(LR) * g)).max()) <= bar


@pytest.mark.parametrize("piece", sorted(PIECES))
def test_piece_train_step_matches_jax(piece):
    """One SGD step: JAX's loss, gradients and new op state from
    ``value_and_grad`` of its loss; the port's loss, gradients, updated
    params (held against ``p - lr g`` of JAX's gradient) and state."""
    jff = _piece_graph("jax", piece)
    jex = JExecutor(jff, config=jff.config,
                    optimizer=joptim.SGDOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    params, _, state = jax.device_get(jex.init(seed=0))
    batch = _piece_batch(jff, 1)
    (loss, (_m, jstate)), jg = jax.jit(jax.value_and_grad(
        jex._loss_fn, has_aux=True))(params, state, jex.shard_batch(batch))
    jg, jstate = jax.device_get(jg), jax.device_get(jstate)

    tff = _piece_graph("torch", piece)
    assert tff.summary() == jff.summary()
    tex = TExecutor(tff, config=tff.config,
                    optimizer=toptim.SGDOptimizer(lr=LR), device="cpu")
    tp = params_from_numpy(params, device="cpu")
    ts = state_from_numpy(state, device="cpu")
    tloss, _tm, tstate, tg = tex.loss_and_grads(tp, ts, batch)
    assert abs(float(tloss) - float(loss)) <= TOL
    for op, group in jg.items():
        for k, want in group.items():
            assert _grad_ok(tg[op][k].numpy(), want), (op, k)
    ts = state_from_numpy(state, device="cpu")
    tp, _o, ts, m = tex.train_step(tp, tex.optimizer.init(tp), ts, batch)
    assert abs(float(m["train_loss"]) - float(loss)) <= TOL
    for op, group in jg.items():
        for k, g in group.items():
            assert _param_ok(tp[op][k].detach().numpy(), params[op][k], g), \
                (op, k)
    assert sorted(ts) == sorted(jstate)
    for op, group in jstate.items():
        for k, want in group.items():
            assert float(np.abs(ts[op][k].numpy() - want).max()) <= TOL
            assert not np.array_equal(want, state[op][k])


# -- running statistics over steps and microbatches ----------------------------


def _bn_net(pkg, batch):
    if pkg == "jax":
        ff, mod = JModel(JConfig(batch_size=batch, seed=0)), jnp
    else:
        ff, mod = TModel(TConfig(batch_size=batch, seed=0)), torch
    x = ff.create_tensor((batch, 6, 6, 3), name="image")
    label = ff.create_tensor((batch,), dtype=mod.int32, name="label")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation=None, name="conv")
    t = ff.batch_norm(t, relu=True, name="bn")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 10, name="linear_out")
    ff.softmax(t, label, name="softmax")
    return ff


@pytest.fixture(scope="module")
def bn_net_runs():
    """JAX's start, its params and state after 1 and 3 steps, and after
    one step of two accumulated microbatches of 4."""
    jex = JExecutor(_bn_net("jax", 8), optimizer=joptim.SGDOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    p0, o0, s0 = jex.init(seed=0)
    start = jax.device_get((p0, s0))
    batches = [_piece_batch(jex.model, 10 + i) for i in range(3)]
    p, o, s = p0, o0, s0
    after = []
    for b in batches:
        p, o, s, _m = jex.train_step(p, o, s, jex.shard_batch(b))
        after.append(jax.device_get((p, s)))
    aex = JExecutor(_bn_net("jax", 4), optimizer=joptim.SGDOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    ap, _, as_, _ = aex.accum_train_step(2)(
        jax.tree.map(jnp.asarray, start[0]), aex.optimizer.init(start[0]),
        jax.tree.map(jnp.asarray, start[1]),
        aex.stack_microbatches(batches[0], 2))
    return dict(start=start, batches=batches, after=after,
                accum=jax.device_get((ap, as_)))


def _assert_tree(got, want, tol):
    for op, group in want.items():
        for k, w in group.items():
            err = float(np.abs(got[op][k].detach().numpy() - w).max())
            assert err <= tol, (op, k, err)


@pytest.mark.parametrize("steps", [1, 3])
def test_running_stats_over_steps_match_jax(bn_net_runs, steps):
    tex = TExecutor(_bn_net("torch", 8), optimizer=toptim.SGDOptimizer(lr=LR),
                    device="cpu")
    p = params_from_numpy(bn_net_runs["start"][0], device="cpu")
    s = state_from_numpy(bn_net_runs["start"][1], device="cpu")
    o = tex.optimizer.init(p)
    stats = s["bn"]["running_mean"]
    for b in bn_net_runs["batches"][:steps]:
        p, o, s, _m = tex.train_step(p, o, s, b)
    assert s["bn"]["running_mean"] is stats  # advanced in place
    wp, ws = bn_net_runs["after"][steps - 1]
    _assert_tree(p, wp, 1e-6)
    _assert_tree(s, ws, TOL)


def test_running_stats_under_accumulation_match_jax(bn_net_runs):
    """Each microbatch's forward advances the statistics once."""
    tex = TExecutor(_bn_net("torch", 4), optimizer=toptim.SGDOptimizer(lr=LR),
                    device="cpu")
    p = params_from_numpy(bn_net_runs["start"][0], device="cpu")
    s = state_from_numpy(bn_net_runs["start"][1], device="cpu")
    p, _o, s, _m = tex.accum_train_step(2)(
        p, tex.optimizer.init(p), s,
        tex.stack_microbatches(bn_net_runs["batches"][0], 2))
    wp, ws = bn_net_runs["accum"]
    _assert_tree(p, wp, 1e-6)
    _assert_tree(s, ws, TOL)
    one = TExecutor(_bn_net("torch", 8), optimizer=toptim.SGDOptimizer(lr=LR),
                    device="cpu")
    s1 = state_from_numpy(bn_net_runs["start"][1], device="cpu")
    _l, _m, s1, _g = one.loss_and_grads(
        params_from_numpy(bn_net_runs["start"][0], device="cpu"), s1,
        bn_net_runs["batches"][0])
    assert not torch.equal(s1["bn"]["running_var"], s["bn"]["running_var"])


def _steps(tex, start, batches, k=1):
    p = params_from_numpy(start[0], device="cpu")
    s = state_from_numpy(start[1], device="cpu")
    o = tex.optimizer.init(p)
    if k > 1:
        p, o, s, ms = tex.build_superstep(k)(p, o, s,
                                             tex.stack_steps(batches))
        return ms["train_loss"].tolist(), p, s
    losses = []
    for b in batches:
        p, o, s, m = tex.train_step(p, o, s, b)
        losses.append(float(m["train_loss"]))
    return losses, p, s


def _bits(a, b):
    for op in b:
        for k in b[op]:
            assert torch.equal(a[op][k], b[op][k]), (op, k)


def test_remat_and_superstep_advance_the_stats_once(bn_net_runs):
    """``--remat`` recomputes BatchNorm from the step's statistics and a
    superstep of 2 advances them in place: both equal two plain steps
    bit for bit, the statistics included."""
    start, batches = bn_net_runs["start"], bn_net_runs["batches"][:2]

    def ex(remat=False):
        ff = _bn_net("torch", 8)
        ff.config.remat = remat
        return TExecutor(ff, optimizer=toptim.SGDOptimizer(lr=LR),
                         device="cpu")

    plain = _steps(ex(), start, batches)
    for other in (_steps(ex(remat=True), start, batches),
                  _steps(ex(), start, batches, k=2)):
        assert other[0] == plain[0]
        _bits(other[1], plain[1])
        _bits(other[2], plain[2])


def test_eval_reads_the_running_stats(bn_net_runs):
    """``eval_step`` and ``forward_step`` normalise with the running
    statistics (JAX's eval forward), and leave them unchanged."""
    jex = JExecutor(_bn_net("jax", 8), optimizer=joptim.SGDOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    wp, ws = bn_net_runs["after"][2]
    batch = bn_net_runs["batches"][0]
    jloss, _ = jex.eval_step(jax.tree.map(jnp.asarray, wp),
                             jax.tree.map(jnp.asarray, ws),
                             jex.shard_batch(batch))
    tex = TExecutor(_bn_net("torch", 8), optimizer=toptim.SGDOptimizer(lr=LR),
                    device="cpu")
    p = params_from_numpy(wp, device="cpu")
    s = state_from_numpy(ws, device="cpu")
    before = {k: v.clone() for k, v in s["bn"].items()}
    tloss, _ = tex.eval_step(p, s, batch)
    assert abs(float(tloss) - float(jloss)) <= TOL
    outs = tex.forward_step(p, batch, s)
    (want,), _ = tex.model.find_op("bn").forward(
        p["bn"], [outs["conv:out"]], s["bn"], False)
    assert torch.equal(outs["bn:out"], want)
    for k, v in before.items():
        assert torch.equal(s["bn"][k], v)


def test_executor_inits_the_running_stats():
    tex = TExecutor(_bn_net("torch", 8), optimizer=toptim.SGDOptimizer(lr=LR),
                    device="cpu")
    _p, _o, s = tex.init(seed=0)
    assert torch.equal(s["bn"]["running_mean"], torch.zeros(8))
    assert torch.equal(s["bn"]["running_var"], torch.ones(8))


# -- the app --------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(tapp.MODELS))
def test_cnn_app_on_cpu(model):
    stats = {}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tapp.main(["--model", model, "-b", "2", "-i", "1",
                          "--optimizer", "sgd", "--lr", "0.01"],
                         device="cpu", stats_out=stats) == 0
    assert "images/s" in out.getvalue()
    assert len(stats["step_losses"]) == 2
    assert all(np.isfinite(stats["step_losses"]))
    if model == "densenet121":
        rm = stats["final"][2]["stem_bn"]["running_mean"]
        assert torch.isfinite(rm).all() and bool((rm != 0).any())


@pytest.mark.parametrize("flag,msg", [(["--model", "lenet"], "unknown"),
                                      (["-d", "imgs"], "item 12"),
                                      (["-s", "auto"], "item 11")])
def test_cnn_app_refuses(flag, msg):
    with pytest.raises(SystemExit, match=msg):
        tapp.main(["-b", "2"] + flag, device="cpu")
