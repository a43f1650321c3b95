"""The port's NMT training slice (ROADMAP item 5's first part): JAX's
threefry ``split`` and ``bernoulli``, Dropout, the LSTM and the NMT model,
held against the JAX package on the CPU, and the app and the bench leg.

The JAX parameters and op state (Dropout's uint32 key) are carried into
the port with ``params_from_numpy`` / ``state_from_numpy``; both packages
train on the same numpy batches.  Bars (f32):

- ``split``, ``bernoulli`` and Dropout's masks: bit for bit (integer
  outputs JAX defines exactly); Dropout's values within 1 ulp of JAX's
  (``x / (1 - rate)``, one rounding each side);
- the LSTM alone (batch 3, seq 5, in 6, hidden 4): outputs within
  ``LSTM_TOL`` = 1e-5 and every gradient within ``GRAD_RTOL`` = 1e-4 of
  its tensor's largest magnitude plus ``GRAD_ATOL`` = 1e-7;
- the NMT model (batch 4, seq 6, hidden 32, vocab 128, 2 layers, dropout
  0.2) through one SGD step: the loss within ``LOSS_TOL`` = 1e-5, every
  gradient by the LSTM's gradient bar, the updated parameters within
  ``PARAM_TOL`` = 1e-6, and the advanced Dropout keys bit for bit;
- inside the port, remat and a superstep of 2 against the plain steps:
  bit for bit, masks (keys) included.
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optim as joptim
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.graph import FFModel as JModel
from flexflow_tpu.models.nmt import build_nmt as jbuild
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_torch import bench as tbench
from flexflow_torch import optim as toptim
from flexflow_torch.apps import nmt as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.graph import FFModel as TModel
from flexflow_torch.models.nmt import build_nmt as tbuild
from flexflow_torch.models.nmt import nmt_pipeline_strategy, nmt_strategy
from flexflow_torch.ops.rnn import LSTM as TLSTM
from flexflow_torch.runtime import keyed_random
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.search.cost_model import op_cost
from flexflow_torch.weights import params_from_numpy, state_from_numpy

LSTM_TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7
LOSS_TOL = 1e-5
PARAM_TOL = 1e-6
B, T, HID, VOCAB, LAYERS, RATE = 4, 6, 32, 128, 2, 0.2
LR = 0.1


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


KEYS = [(0, 0), (0, 42), (123456789, 987654321), (0xFFFFFFFF, 1)]


def test_threefry_is_partitionable():
    """The bit layout ``keyed_random`` reproduces."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("num", [2, 3])
def test_split_matches_jax(key, num):
    k = jnp.array(key, jnp.uint32)
    want = np.asarray(jax.random.split(k, num)).astype(np.int64)
    got = keyed_random.split(_u32(k), num).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape,rate", [((7,), 0.5), ((3, 5, 8), 0.2),
                                        ((4, 6, 32), 0.9), ((2, 1000), 0.0)])
def test_bernoulli_matches_jax(key, shape, rate):
    k = jnp.array(key, jnp.uint32)
    want = np.asarray(jax.random.bernoulli(k, 1.0 - rate, shape))
    got = keyed_random.bernoulli(_u32(k), 1.0 - rate, shape).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)


# -- Dropout -----------------------------------------------------------------


def _dropout_pair(rate, dtype):
    jff = JModel(JConfig(batch_size=B))
    jx = jff.create_tensor((B, T, HID), dtype=getattr(jnp, dtype), name="x")
    jff.dropout(jx, rate, name="drop")
    tff = TModel(TConfig(batch_size=B))
    tx = tff.create_tensor((B, T, HID), dtype=getattr(torch, dtype), name="x")
    tff.dropout(tx, rate, name="drop")
    return jff.layers[0], tff.layers[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_masks_match_jax_over_three_steps(dtype, rate):
    """The key is JAX's op state carried across; each training step
    splits it and draws the mask: three steps' masks bit for bit and the
    advanced keys equal."""
    jop, top = _dropout_pair(rate, dtype)
    jstate = {"rng": jax.random.key_data(jax.random.PRNGKey(5))}
    jstate = {"rng": jnp.asarray(jstate["rng"], jnp.uint32)}
    tstate = state_from_numpy({"drop": jax.device_get(jstate)}, "cpu")["drop"]
    assert tstate["rng"].dtype == torch.int64
    x = np.random.default_rng(0).standard_normal((B, T, HID)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for _ in range(3):
        (jy,), jstate = jop.forward({}, [jx], jstate, True)
        (ty,), tnew = top.forward({}, [tx], tstate, True)
        tstate = {"rng": tnew["rng"]}
        jy = np.asarray(jy.astype(jnp.float32))
        ty = ty.float().numpy()
        assert np.array_equal(ty != 0, jy != 0)
        assert 0 < (ty == 0).sum() < ty.size
        np.testing.assert_array_max_ulp(ty, jy, maxulp=1)
        assert np.array_equal(tstate["rng"].numpy(),
                              np.asarray(jstate["rng"]).astype(np.int64))


def test_dropout_eval_rate_zero_and_bad_rates():
    _jop, top = _dropout_pair(0.5, "float32")
    x = torch.randn(B, T, HID)
    st = {"rng": torch.tensor([1, 2])}
    (y,), s = top.forward({}, [x], st, False)
    assert y is x and s is st
    _jop, top0 = _dropout_pair(0.0, "float32")
    (y,), s = top0.forward({}, [x], st, True)
    assert y is x and s is st
    tff = TModel(TConfig(batch_size=B))
    tx = tff.create_tensor((B, HID), name="x")
    for bad in (1.0, -0.1, float("nan")):
        with pytest.raises(ValueError, match="rate"):
            tff.dropout(tx, bad)


# -- LSTM --------------------------------------------------------------------


@pytest.mark.parametrize("initial", [False, True])
def test_lstm_forward_and_gradients_match_jax(initial):
    b, t, i, h = 3, 5, 6, 4
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    h0 = rng.standard_normal((b, h)).astype(np.float32)
    c0 = rng.standard_normal((b, h)).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h), (b, h))]

    jff = JModel(JConfig(batch_size=b))
    jx = jff.create_tensor((b, t, i), name="x")
    jinit = None
    tff = TModel(TConfig(batch_size=b))
    tx = tff.create_tensor((b, t, i), name="x")
    tinit = None
    if initial:
        jinit = (jff.create_tensor((b, h), name="h0"),
                 jff.create_tensor((b, h), name="c0"))
        tinit = (tff.create_tensor((b, h), name="h0"),
                 tff.create_tensor((b, h), name="c0"))
    jff.lstm(jx, h, initial_state=jinit, name="lstm")
    tff.lstm(tx, h, initial_state=tinit, name="lstm")
    jop, top = jff.layers[0], tff.layers[0]
    assert isinstance(top, TLSTM)
    assert {k: (s.shape, s.dtype.itemsize) for k, s in jop.param_specs().items()} \
        == {k: (s.shape, s.dtype.itemsize) for k, s in top.param_specs().items()}
    params = {"wx": rng.standard_normal((i, 4 * h)).astype(np.float32) * 0.5,
              "wh": rng.standard_normal((h, 4 * h)).astype(np.float32) * 0.5,
              "bias": rng.standard_normal((4 * h,)).astype(np.float32) * 0.1}
    xs = [x, h0, c0] if initial else [x]

    def jloss(p, xs):
        ys, _ = jop.forward(p, xs, {}, True)
        return sum(jnp.sum(y * c) for y, c in zip(ys, cots)), ys

    (jl, jys), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(a) for a in xs])
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    txs = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    tys, _ = top.forward(tp, txs, {}, True)
    tl = sum((y * torch.from_numpy(c)).sum() for y, c in zip(tys, cots))
    grads = torch.autograd.grad(tl, list(tp.values()) + txs)
    for ty, jy in zip(tys, jys):
        assert float(np.abs(ty.detach().numpy() - np.asarray(jy)).max()) \
            <= LSTM_TOL
    want = [jg[0][k] for k in tp] + list(jg[1])
    for got, w in zip(grads, want):
        w = np.asarray(w)
        err = float(np.abs(got.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL


def test_lstm_cost_matches_jax():
    """``op_cost`` prices the LSTM as JAX's cost model does: the gate
    products over the sequence, charged 4x."""
    from flexflow_tpu.search.cost_model import op_cost as jop_cost

    jff = jbuild(batch_size=B, src_len=T, tgt_len=T, vocab_size=VOCAB,
                 embed_dim=HID, hidden_size=HID, num_layers=LAYERS,
                 config=JConfig(batch_size=B))
    tff = tbuild(batch_size=B, src_len=T, tgt_len=T, vocab_size=VOCAB,
                 embed_dim=HID, hidden_size=HID, num_layers=LAYERS,
                 config=TConfig(batch_size=B))
    for jop, top in zip(jff.layers, tff.layers):
        if isinstance(top, TLSTM):
            assert op_cost(top).flops == jop_cost(jop).flops \
                == 4.0 * 2.0 * B * T * 4 * HID * (2 * HID)


# -- the NMT model -----------------------------------------------------------


def _builds(remat=False):
    args = dict(batch_size=B, src_len=T, tgt_len=T, vocab_size=VOCAB,
                embed_dim=HID, hidden_size=HID, num_layers=LAYERS,
                dropout=RATE)
    jff = jbuild(config=JConfig(batch_size=B, seed=0), **args)
    tff = tbuild(config=TConfig(batch_size=B, seed=0, remat=remat), **args)
    return jff, tff


def _batch(tff, seed=1):
    return synthetic_host_batch(tff, np.random.default_rng(seed),
                                {"src": VOCAB, "tgt": VOCAB, "label": VOCAB})


@pytest.fixture(scope="module")
def nmt_start():
    """JAX's initial (params, state), the batch and JAX's step."""
    jff, tff = _builds()
    jex = JExecutor(jff, config=jff.config,
                    optimizer=joptim.SGDOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    params, _opt, state = jax.device_get(jex.init(seed=0))
    batch = _batch(tff)
    jb = jex.shard_batch(batch)
    (loss, (_m, jstate)), grads = jax.jit(jax.value_and_grad(
        jex._loss_fn, has_aux=True))(params, state, jb)
    new_params, _, new_state, _ = jex.train_step(
        jax.tree.map(jnp.asarray, params), jex.optimizer.init(params),
        jax.tree.map(jnp.asarray, state), jb)
    return dict(params=params, state=state, batch=batch, loss=float(loss),
                grads=jax.device_get(grads), jstate=jax.device_get(jstate),
                new_params=jax.device_get(new_params),
                new_state=jax.device_get(new_state))


def _texec(remat=False, lr=LR):
    _jff, tff = _builds(remat=remat)
    return TExecutor(tff, config=tff.config,
                     optimizer=toptim.SGDOptimizer(lr=lr), device="cpu")


def test_nmt_graph_matches_jax():
    jff, tff = _builds()
    assert [op.name for op in jff.layers] == [op.name for op in tff.layers]
    assert [type(op).__name__ for op in jff.layers] == \
        [type(op).__name__ for op in tff.layers]
    for jop, top in zip(jff.layers, tff.layers):
        assert sorted(jop.param_specs()) == sorted(top.param_specs())
        assert sorted(jop.state_specs()) == sorted(top.state_specs())
        for jt, tt in zip(jop.outputs, top.outputs):
            assert jt.name == tt.name and tuple(jt.shape) == tuple(tt.shape)
    assert {op.name for op in tff.layers if op.state_specs()} == \
        {"enc_drop0", "dec_drop0"}


def test_nmt_loss_and_gradients_match_jax(nmt_start):
    st = nmt_start
    tex = _texec()
    params = params_from_numpy(st["params"], device="cpu")
    state = state_from_numpy(st["state"], device="cpu")
    loss, _m, new_state, grads = tex.loss_and_grads(params, state,
                                                    st["batch"])
    assert abs(float(loss) - st["loss"]) <= LOSS_TOL
    for op, keys in st["jstate"].items():
        assert np.array_equal(new_state[op]["rng"].numpy(),
                              keys["rng"].astype(np.int64))
    assert sorted(grads) == sorted(st["grads"])
    for op, group in st["grads"].items():
        for k, want in group.items():
            err = float(np.abs(grads[op][k].numpy() - want).max())
            scale = float(np.abs(want).max())
            assert err <= GRAD_RTOL * scale + GRAD_ATOL, (op, k, err, scale)


def test_nmt_sgd_step_matches_jax(nmt_start):
    """One SGD step (the embeddings on the row-sparse path in both
    packages): every updated parameter and the advanced keys."""
    st = nmt_start
    tex = _texec()
    assert {op.name for op in tex._sparse_ops} == {"src_embed", "tgt_embed"}
    params = params_from_numpy(st["params"], device="cpu")
    state = state_from_numpy(st["state"], device="cpu")
    params, _, state, m = tex.train_step(params, tex.optimizer.init(params),
                                         state, st["batch"])
    assert abs(float(m["train_loss"]) - st["loss"]) <= LOSS_TOL
    for op, group in st["new_params"].items():
        for k, want in group.items():
            err = float(np.abs(params[op][k].detach().numpy() - want).max())
            assert err <= PARAM_TOL, (op, k, err)
    for op, keys in st["new_state"].items():
        assert np.array_equal(state[op]["rng"].numpy(),
                              keys["rng"].astype(np.int64))


def _steps(tex, start, batches):
    params = params_from_numpy(start["params"], device="cpu")
    state = state_from_numpy(start["state"], device="cpu")
    opt = tex.optimizer.init(params)
    keys = {op: g["rng"].data_ptr() for op, g in state.items()}
    losses = []
    for b in batches:
        params, opt, state, m = tex.train_step(params, opt, state, b)
        losses.append(float(m["train_loss"]))
    # The keys advance in place, in the tensors the state started with.
    assert {op: g["rng"].data_ptr() for op, g in state.items()} == keys
    return losses, params, state


def _assert_bits(a, b):
    assert sorted(a) == sorted(b)
    for op in a:
        for k in a[op]:
            assert torch.equal(a[op][k], b[op][k]), (op, k)


def test_remat_with_dropout_equals_the_plain_step(nmt_start):
    """The recompute reads the step's key, not the advanced one: three
    steps with --remat give the plain steps' losses, params and keys bit
    for bit."""
    _j, tff = _builds()
    batches = [_batch(tff, seed=s) for s in (1, 2, 3)]
    plain = _steps(_texec(), nmt_start, batches)
    remat = _steps(_texec(remat=True), nmt_start, batches)
    assert remat[0] == plain[0]
    _assert_bits(remat[1], plain[1])
    _assert_bits(remat[2], plain[2])


def test_superstep_with_dropout_equals_eager_steps(nmt_start):
    """A superstep of 2 (a loop on the CPU; one CUDA graph on the card)
    against 2 eager steps: losses, params and the advanced keys (so the
    masks) bit for bit."""
    _j, tff = _builds()
    batches = [_batch(tff, seed=s) for s in (1, 2)]
    losses, params, state = _steps(_texec(), nmt_start, batches)
    tex = _texec()
    sp = params_from_numpy(nmt_start["params"], device="cpu")
    ss = state_from_numpy(nmt_start["state"], device="cpu")
    fn = tex.build_superstep(2)
    sp, _o, ss, ms = fn(sp, tex.optimizer.init(sp), ss,
                        tex.stack_steps(batches))
    assert ms["train_loss"].tolist() == losses
    _assert_bits(sp, params)
    _assert_bits(ss, state)


def test_executor_inits_the_dropout_keys():
    tex = _texec()
    params, _opt, state = tex.init(seed=0)
    assert sorted(state) == ["dec_drop0", "enc_drop0"]
    for g in state.values():
        k = g["rng"]
        assert k.dtype == torch.int64 and k.shape == (2,)
        assert int(k.min()) >= 0 and int(k.max()) < 2 ** 32
    again = tex.init(seed=0)
    _assert_bits(again[0], params)
    _assert_bits(again[2], state)


def test_nmt_strategies():
    store = nmt_strategy(1)
    assert all(pc.num_parts == 1 for pc in store.table.values())
    assert "enc_drop0" in store.table and "vocab_proj" in store.table
    # Two devices: JAX's default split, the LSTMs' pipeline at sp 2.
    two = nmt_strategy(2)
    assert two.table["enc_lstm0"].s == 2 and two.table["vocab_proj"].c == 2
    assert two.table["softmax"].n == 2
    # The layer-wise placement: the encoder on the first half, the
    # decoder on the second (JAX's table, tests/test_torch_pipeline.py).
    pipe = nmt_pipeline_strategy(2)
    assert pipe.table["src_embed"].device_ids == (0,)
    assert pipe.table["softmax"].device_ids == (1,)


# -- the app and the bench leg -------------------------------------------------

_APP = ["-b", "4", "--src-len", "6", "--tgt-len", "6", "--hidden", "32",
        "--vocab", "128", "--optimizer", "sgd", "--lr", "0.5",
        "--momentum", "0", "--wd", "0"]


@pytest.mark.parametrize("flags", [[], ["--steps-per-call", "2", "--remat"],
                                   ["--accum-steps", "2"]])
def test_nmt_app_on_cpu(capsys, flags):
    stats = {}
    assert tapp.main(_APP + ["-i", "4"] + flags, device="cpu",
                     stats_out=stats) == 0
    out = capsys.readouterr().out
    assert "time = " in out and "sentence-pairs/s" in out
    losses = stats["step_losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ``--pipeline`` runs since the pipeline landed; its chunked form is the
# refused one now (item 10b: the match covers it).
@pytest.mark.parametrize("flag,msg", [(["--pipeline-chunk", "2"], "item 10"),
                                      (["--search", "5"], "search")])
def test_nmt_app_refuses(flag, msg):
    with pytest.raises(SystemExit, match=msg):
        tapp.main(_APP + flag, device="cpu")


def test_bench_nmt_leg_at_a_small_shape():
    stats = {}
    with contextlib.redirect_stdout(io.StringIO()):
        elapsed, pairs, iters = tbench.bench_nmt(
            device="cpu", batch=4, hidden=32, vocab=128, seq=6, iters=2,
            warmup=2, stats_out=stats)
    assert iters == 2 and elapsed > 0 and pairs == pytest.approx(
        2 * 4 / elapsed)
    assert len(stats["step_losses"]) == 4
    assert all(np.isfinite(stats["step_losses"]))
