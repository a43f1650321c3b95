"""The port's mixture-of-experts FFN (``flexflow_torch/ops/moe.py``) and
the MoE LM, held against the JAX package on the CPU.

The port routes by index (slot rows, batched expert products, a gather
of each token's slots) where JAX builds one-hot ``(S, E, C)`` dispatch
and combine tensors; both compute one function.  The JAX parameters are
carried across with ``params_from_numpy``; both packages see the same
numpy inputs.  Bars (f32):

- the op at ``tests/test_moe.py``'s sizes (batch 8, seq 4 or 16, d 8, 4
  experts, ffn 16), top-1 and top-2, with capacity factor 8.0 (nothing
  drops) and 0.5 (tokens drop): ``y`` within ``Y_TOL`` = 1e-5, the aux
  loss within ``AUX_TOL`` = 1e-6, ``dropped`` equal as an integer; in
  bf16 ``y`` within ``Y_TOL_BF16`` = 2^-6 of its largest magnitude (the
  expert products round in bf16 on both sides, in other orders);
- planted ties (a zero gate makes every probability equal): JAX routes
  every token to experts 0 (and 1); so does the port, ``dropped`` equal;
- gradients of ``x``, ``gate``, ``w1``, ``b1``, ``w2``, ``b2`` against
  ``jax.vjp``, each within ``GRAD_RTOL`` = 1e-5 of its largest magnitude
  plus ``GRAD_ATOL`` = 1e-7;
- capacity from the runtime token count: two accumulated microbatches
  against JAX's ``accum_train_step`` (``PARAM_TOL`` = 1e-6);
- a 2-layer MoE LM (batch 2, seq 16, vocab 64, d 16, 2 heads, 4 experts):
  three Adam steps' losses within ``LOSS_TOL`` = 1e-5 and the params
  within ``PARAM_TOL``, except the elements whose first gradient is below
  ``ADAM_FLOOR`` = 1e-3 of their tensor's largest and the key biases
  (rounding noise, which Adam scales up to lr: within 3 x lr, as
  ``tests/test_torch_superstep.py`` holds the key biases);
- inside the port, ``--remat`` and a superstep of 2 against the plain
  steps: bit for bit;
- ``cost_model.train_flops`` of the MoE LM equal to JAX's.
"""

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
from flexflow_torch.apps import transformer as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.graph import FFModel as TModel
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.models.transformer import transformer_strategy
from flexflow_torch.ops.moe import MixtureOfExperts, top_k_lowest_index
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.weights import opt_state_from_numpy, params_from_numpy

Y_TOL = 1e-5
Y_TOL_BF16 = 2.0 ** -6
AUX_TOL = 1e-6
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-7
LOSS_TOL = 1e-5
PARAM_TOL = 1e-6
ADAM_FLOOR = 1e-3
D, E, FFN = 8, 4, 16


def _pair(batch, seq, cf, top_k, dtype="float32"):
    """The same one-op graph in both packages."""
    ops = []
    for model, mod in ((JModel(JConfig(batch_size=batch)), jnp),
                       (TModel(TConfig(batch_size=batch)), torch)):
        x = model.create_tensor((batch, seq, D), dtype=getattr(mod, dtype),
                                name="x", dim_axes=("n", "s", None))
        model.moe(x, E, FFN, capacity_factor=cf, top_k=top_k, name="moe")
        ops.append(model.layers[0])
    return ops


def _params(seed, zero_gate=False):
    r = np.random.default_rng(seed)
    p = {"gate": r.standard_normal((D, E)).astype(np.float32),
         "w1": (r.standard_normal((E, D, FFN)) * 0.3).astype(np.float32),
         "b1": (r.standard_normal((E, FFN)) * 0.1).astype(np.float32),
         "w2": (r.standard_normal((E, FFN, D)) * 0.3).astype(np.float32),
         "b2": (r.standard_normal((E, D)) * 0.1).astype(np.float32)}
    if zero_gate:
        p["gate"][:] = 0.0
    return p


def _run_both(batch, seq, cf, top_k, dtype="float32", zero_gate=False,
              training=True):
    jop, top = _pair(batch, seq, cf, top_k, dtype)
    params = _params(1, zero_gate)
    x = np.random.default_rng(2).standard_normal((batch, seq, D)).astype(
        np.float32)
    jdt = getattr(jnp, dtype)
    (jl, jm, (jy,)), _ = jax.jit(
        lambda p, x: jop.forward(p, [x], {}, training))(
        {k: jnp.asarray(v, jdt) for k, v in params.items()},
        jnp.asarray(x, jdt))
    tp = params_from_numpy({"moe": params}, device="cpu",
                           dtype=getattr(torch, dtype))["moe"]
    (tl, tm, (ty,)), _ = top.forward(
        tp, [torch.from_numpy(x).to(getattr(torch, dtype))], {}, training)
    return (np.asarray(jy.astype(jnp.float32)), float(jl),
            {k: float(v) for k, v in jm.items()},
            ty.float().numpy(), float(tl),
            {k: float(v) for k, v in tm.items()}, top)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf,seq", [(8.0, 4), (0.5, 16)])
def test_moe_op_matches_jax(top_k, cf, seq):
    jy, jl, jm, ty, tl, tm, top = _run_both(8, seq, cf, top_k)
    assert float(np.abs(ty - jy).max()) <= Y_TOL
    assert abs(tl - jl) <= AUX_TOL
    assert sorted(tm) == sorted(jm) == ["moe_aux_loss", "moe_dropped"]
    assert abs(tm["moe_aux_loss"] - jm["moe_aux_loss"]) <= AUX_TOL
    assert tm["moe_dropped"] == jm["moe_dropped"]
    assert tm["moe_dropped"] == int(tm["moe_dropped"])
    if cf == 8.0:
        assert tm["moe_dropped"] == 0
    else:
        assert 0 < tm["moe_dropped"] < 8 * seq * top_k
    assert top.capacity(8 * seq) == top.attrs["capacity"]


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_op_bf16_matches_jax(top_k):
    jy, jl, jm, ty, tl, tm, _ = _run_both(8, 16, 0.5, top_k, "bfloat16")
    assert float(np.abs(ty - jy).max()) <= Y_TOL_BF16 * float(np.abs(jy).max())
    assert tm["moe_dropped"] == jm["moe_dropped"]
    assert abs(tm["moe_aux_loss"] - jm["moe_aux_loss"]) <= AUX_TOL


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_planted_ties_route_as_jax(top_k, cf):
    """A zero gate makes every probability 1/E: JAX's top_k takes the
    lowest indices, so every token goes to expert 0 (and 1), and past
    capacity the same tokens drop."""
    jy, jl, jm, ty, tl, tm, _ = _run_both(8, 4, cf, top_k, zero_gate=True)
    assert float(np.abs(ty - jy).max()) <= Y_TOL
    assert tm["moe_dropped"] == jm["moe_dropped"]
    assert (tm["moe_dropped"] > 0) == (cf == 1.0)
    probs = torch.full((5, E), 0.25)
    vals, idx = top_k_lowest_index(probs, top_k)
    assert idx.tolist() == [list(range(top_k))] * 5
    assert torch.equal(vals, torch.full((5, top_k), 0.25))


def test_top_k_lowest_index_matches_lax_top_k():
    r = np.random.default_rng(4)
    p = r.integers(0, 3, size=(64, 6)).astype(np.float32)  # many ties
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        tv, ti = top_k_lowest_index(torch.from_numpy(p), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_moe_eval_has_no_loss():
    jy, jl, jm, ty, tl, tm, _ = _run_both(8, 4, 8.0, 1, training=False)
    assert tl == jl == 0.0
    assert float(np.abs(ty - jy).max()) <= Y_TOL


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf,seq", [(8.0, 4), (0.5, 16)])
def test_moe_gradients_match_jax(top_k, cf, seq):
    """Gradients of ``loss + sum(y * g)`` with respect to the input and
    every parameter, against ``jax.vjp``."""
    jop, top = _pair(8, seq, cf, top_k)
    params = _params(1)
    r = np.random.default_rng(3)
    x = r.standard_normal((8, seq, D)).astype(np.float32)
    g = r.standard_normal((8, seq, D)).astype(np.float32)

    def jf(p, x):
        (loss, _m, (y,)), _ = jop.forward(p, [x], {}, True)
        return loss + jnp.sum(y * g)

    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (loss, _m, (y,)), _ = top.forward(tp, [tx], {}, True)
    out = loss + (y * torch.from_numpy(g)).sum()
    got = torch.autograd.grad(out, list(tp.values()) + [tx])
    want = [jg[0][k] for k in tp] + [jg[1]]
    for name, gt, w in zip(list(tp) + ["x"], got, want):
        w = np.asarray(w)
        err = float(np.abs(gt.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, \
            (name, err)


def test_moe_graph_capture_has_nothing_on_the_host(monkeypatch):
    """No device value reaches the host in the forward (a CUDA graph
    would refuse it): ``.item()``, ``.tolist()`` and ``nonzero`` raise."""
    _jop, top = _pair(8, 16, 0.5, 2)
    tp = params_from_numpy({"moe": _params(1)}, device="cpu")["moe"]
    x = torch.randn(8, 16, D)

    def refuse(*a, **k):
        raise AssertionError("the forward read a device value")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "nonzero", refuse)
    (_l, m, (y,)), _ = top.forward(tp, [x], {}, True)
    assert y.shape == x.shape


def test_moe_refuses_bad_shapes():
    tff = TModel(TConfig(batch_size=2))
    x = tff.create_tensor((2, 4, D), name="x")
    with pytest.raises(ValueError, match="experts"):
        tff.moe(x, 1, FFN)
    with pytest.raises(ValueError, match="top_k"):
        tff.moe(x, E, FFN, top_k=E + 1)
    with pytest.raises(ValueError, match="batch, seq, d"):
        tff.moe(tff.create_tensor((2, D), name="y"), E, FFN)


# -- capacity from the runtime tokens: accumulation against JAX --------------


def _moe_head(pkg, batch, seq=16, cf=0.5):
    if pkg == "jax":
        ff, i32 = JModel(JConfig(batch_size=batch, seed=3)), jnp.int32
    else:
        ff, i32 = TModel(TConfig(batch_size=batch, seed=3)), torch.int32
    x = ff.create_tensor((batch, seq, D), name="x", dim_axes=("n", "s", None))
    lbl = ff.create_tensor((batch, seq), dtype=i32, name="lbl",
                           dim_axes=("n", "s"))
    t = ff.moe(x, E, FFN, capacity_factor=cf, name="moe")
    t = ff.dense(t, 4, name="head")
    ff.softmax(t, lbl, name="softmax")
    return ff


def test_moe_accum_capacity_follows_the_microbatch():
    """A graph declared at batch 8 (capacity 16 at cf 0.5) stepped on two
    microbatches of 4: each routes its 64 tokens into the microbatch's
    capacity, 8, as JAX's ``accum_train_step`` does.  The updated params,
    the loss and the dropped count (a float metric: the microbatches'
    mean, as in JAX) against JAX's."""
    r = np.random.default_rng(5)
    full = {"x": r.standard_normal((8, 16, D)).astype(np.float32),
            "lbl": r.integers(0, 4, size=(8, 16)).astype(np.int32)}
    jex = JExecutor(_moe_head("jax", 8), optimizer=joptim.SGDOptimizer(
        lr=0.1), devices=jax.devices()[:1])
    p0 = jax.device_get(jex.init(seed=0)[0])
    p0["moe"] = _params(1)
    jp, _, _, jm = jex.accum_train_step(2)(
        jax.tree.map(jnp.asarray, p0), jex.optimizer.init(p0), {},
        jex.stack_microbatches(full, 2))
    tex = TExecutor(_moe_head("torch", 8), optimizer=toptim.SGDOptimizer(
        lr=0.1), device="cpu")
    moe = tex.model.find_op("moe")
    assert moe.capacity(4 * 16) == 8 and moe.attrs["capacity"] == 16
    tp = params_from_numpy(p0, device="cpu")
    tp, _, _, tm = tex.accum_train_step(2)(
        tp, tex.optimizer.init(tp), {}, tex.stack_microbatches(full, 2))
    assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) <= LOSS_TOL
    assert float(tm["moe_dropped"]) == float(jm["moe_dropped"]) > 0
    for op, group in jax.device_get(jp).items():
        for k, want in group.items():
            err = float(np.abs(tp[op][k].detach().numpy() - want).max())
            assert err <= PARAM_TOL, (op, k, err)


# -- the MoE LM ----------------------------------------------------------------

B, S, V, DM, H, L = 2, 16, 64, 16, 2, 2
LR = 1e-3


def _lm_kw():
    return dict(batch_size=B, seq_len=S, vocab_size=V, d_model=DM,
                num_heads=H, num_layers=L, moe_experts=E,
                moe_capacity_factor=1.0)


def _batches(n):
    ff = tbuild(config=TConfig(batch_size=B), **_lm_kw())
    return [synthetic_host_batch(ff, np.random.default_rng(20 + i),
                                 {"tokens": V, "label": V}) for i in range(n)]


def _torch_lm(remat=False):
    lm = tbuild(config=TConfig(batch_size=B, seed=0, remat=remat), **_lm_kw())
    return TExecutor(lm, config=lm.config,
                     optimizer=toptim.AdamOptimizer(lr=LR), device="cpu")


@pytest.fixture(scope="module")
def lm_run():
    """JAX's initial params and optimizer state, and its three Adam
    steps' losses, params and dropped counts."""
    lm = jbuild(config=JConfig(batch_size=B, seed=0), **_lm_kw())
    jex = JExecutor(lm, config=lm.config,
                    optimizer=joptim.AdamOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    params, opt, state = jex.init(seed=0)
    start = jax.device_get((params, opt))
    losses, dropped = [], []
    for b in _batches(3):
        params, opt, state, m = jex.train_step(params, opt, state,
                                               jex.shard_batch(b))
        losses.append(float(m["train_loss"]))
        dropped.append(float(m["blk0_moe_dropped"]))
    return dict(start=start, losses=losses, dropped=dropped,
                params=jax.device_get(params))


def _torch_steps(tex, start, batches):
    params = params_from_numpy(start[0], device="cpu")
    opt = opt_state_from_numpy(start[1], device="cpu")
    state, losses, dropped = {}, [], []
    for b in batches:
        params, opt, state, m = tex.train_step(params, opt, state, b)
        losses.append(float(m["train_loss"]))
        dropped.append(float(m["blk0_moe_dropped"]))
    return losses, dropped, params, opt


def test_moe_lm_graph_matches_jax():
    jff = jbuild(config=JConfig(batch_size=B), **_lm_kw())
    tff = tbuild(config=TConfig(batch_size=B), **_lm_kw())
    assert jff.summary() == tff.summary()
    assert [op.name for op in tff.layers if isinstance(op, MixtureOfExperts)] \
        == ["blk0_moe", "blk1_moe"]
    for jop, top in zip(jff.layers, tff.layers):
        assert {k: s.shape for k, s in jop.param_specs().items()} == \
            {k: s.shape for k, s in top.param_specs().items()}


def test_moe_lm_adam_trajectory_matches_jax(lm_run):
    """Adam scales each element's step by its own gradient's magnitude,
    so an element whose gradient is near rounding noise (below
    ``ADAM_FLOOR`` of its tensor's largest; the key biases' whole
    gradient) moves by up to lr a step either way: those are held within
    3 x lr, every other element within ``PARAM_TOL``.  Fewer than 5 % of
    the elements with a gradient are that small."""
    tex = _torch_lm()
    batches = _batches(3)
    g0 = tex.loss_and_grads(params_from_numpy(lm_run["start"][0], "cpu"), {},
                            batches[0])[3]
    losses, dropped, params, _ = _torch_steps(tex, lm_run["start"], batches)
    assert max(abs(a - b) for a, b in zip(losses, lm_run["losses"])) \
        <= LOSS_TOL
    assert dropped == lm_run["dropped"] and max(dropped) > 0
    loose = nonzero = 0
    for op, group in lm_run["params"].items():
        for k, w in group.items():
            err = np.abs(params[op][k].detach().numpy() - w)
            g = np.abs(g0[op][k].numpy())
            noise = g < ADAM_FLOOR * g.max() if k != "bk" else g >= 0
            loose += int((noise & (g > 0)).sum())
            nonzero += int((g > 0).sum())
            assert float(np.where(noise, 0.0, err).max()) <= PARAM_TOL, (op, k)
            assert float(err.max()) <= 3 * LR, (op, k)
    assert loose < 0.05 * nonzero


def _assert_bits(a, b):
    assert sorted(a) == sorted(b)
    for op in a:
        for k in a[op]:
            assert torch.equal(a[op][k], b[op][k]), (op, k)


def test_moe_lm_remat_and_superstep_equal_the_plain_steps(lm_run):
    batches = _batches(2)
    plain = _torch_steps(_torch_lm(), lm_run["start"], batches)
    remat = _torch_steps(_torch_lm(remat=True), lm_run["start"], batches)
    assert remat[0] == plain[0] and remat[1] == plain[1]
    _assert_bits(remat[2], plain[2])
    tex = _torch_lm()
    sp = params_from_numpy(lm_run["start"][0], device="cpu")
    so = opt_state_from_numpy(lm_run["start"][1], device="cpu")
    sp, so, _s, ms = tex.build_superstep(2)(sp, so, {},
                                            tex.stack_steps(batches))
    assert ms["train_loss"].tolist() == plain[0]
    assert ms["blk0_moe_dropped"].tolist() == plain[1]
    _assert_bits(sp, plain[2])


def test_moe_lm_train_flops_match_jax():
    from flexflow_tpu.search.cost_model import op_cost as jop_cost
    from flexflow_torch.search.cost_model import op_cost, train_flops

    jff = jbuild(config=JConfig(batch_size=B), **_lm_kw())
    tff = tbuild(config=TConfig(batch_size=B), **_lm_kw())
    for jop, top in zip(jff.layers, tff.layers):
        assert op_cost(top).flops == jop_cost(jop).flops, top.name
    want = 3.0 * sum(jop_cost(op).flops for op in jff.layers)
    assert train_flops(tff) == want
    moe = tff.find_op("blk0_moe")
    s, cap = B * S, moe.capacity(B * S)
    assert op_cost(moe).flops == (2.0 * s * DM * E + 4.0 * s * E * cap * DM
                                  + 4.0 * E * cap * DM * 4 * DM)


def test_transformer_strategy_one_device():
    store = transformer_strategy(1, num_layers=2, moe=True)
    assert "blk1_moe" in store.table and "blk0_mlp_up" not in store.table
    assert all(pc.num_parts == 1 for pc in store.table.values())
    # On two devices the experts split over c (refused before item 9d).
    two = transformer_strategy(2, num_layers=2, tp=2, moe=True)
    assert two.table["blk1_moe"].c == 2 and two.table["blk1_moe"].n == 1


_APP = ["-b", "2", "--seq", "16", "--layers", "2", "--vocab", "64",
        "--d-model", "16", "--heads", "2", "--optimizer", "adam", "--lr",
        "1e-2", "--experts", "4"]


@pytest.mark.parametrize("flags", [[], ["--steps-per-call", "2", "--remat"],
                                   ["--accum-steps", "2"]])
def test_transformer_app_trains_experts_on_cpu(capsys, flags):
    stats = {}
    assert tapp.main(_APP + ["-i", "4"] + flags, device="cpu",
                     stats_out=stats) == 0
    assert "tokens/s = " in capsys.readouterr().out
    losses = stats["step_losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("flag,msg", [
    # --tp 2 on one rank needs a second one (the id is the case's old one)
    pytest.param(["--tp", "2"], "-ll:gpu 2", id="flag0-item 9"),
    (["--experts", "1"], "experts")])
def test_transformer_app_refuses(flag, msg):
    with pytest.raises(SystemExit, match=msg):
        tapp.main(_APP[:-2] + flag, device="cpu")
