"""The port's training slice as a whole, held against the JAX package.

The LM (vocab 1024, d_model 32, 2 heads, 2 layers, batch 2, seq 16, f32)
is built in both packages; the JAX ``Executor.init(seed=0)`` parameters
(on one device) are carried into the port with ``params_from_numpy``,
and both train on the same numpy batch.  At these shapes the JAX step
reaches its Pallas kernels (flash forward and backward, the fused
cross-entropy; the gates are asserted), run in interpret mode.  Bars:

- one step's loss within 1e-5 and every gradient within 1e-5 of its
  tensor's largest magnitude plus 1e-7 (``LOSS_TOL``, ``GRAD_RTOL``,
  ``GRAD_ATOL``; the key biases' gradient is zero in exact arithmetic,
  since a softmax row is invariant to a shift, and both sides give
  rounding noise near 1e-9 there);
- the parameters after one Adam step within ``1e-3 * lr`` of JAX's
  where ``|g| >= max(1e-4 * max|g|, 1e-6)`` over the tensor (Adam's
  first step is about ``lr * sign(g)``, so a gradient that is rounding
  noise may move either way), and within ``2 * lr`` elsewhere;
- the loss trajectory of a 3-step ``Trainer.fit`` from the same state
  within 1e-5 of JAX's ``Trainer.fit``.

Also here: the app end to end on the CPU, the flags it refuses, and the
Trainer's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optim as joptim
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.ops import pallas_kernels
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_tpu.runtime.trainer import Trainer as JTrainer
from flexflow_torch import optim as toptim
from flexflow_torch.apps import transformer as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.trainer import Trainer as TTrainer
from flexflow_torch.weights import opt_state_from_numpy, params_from_numpy

V, D, H, L, B, S = 1024, 32, 2, 2, 2, 16
LR = 1e-3
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-7


def _kw():
    return dict(batch_size=B, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L)


def _jax_executor():
    lm = jbuild(config=JConfig(batch_size=B, seed=0), **_kw())
    return JExecutor(lm, config=lm.config,
                     optimizer=joptim.AdamOptimizer(lr=LR),
                     devices=jax.devices()[:1])


def _torch_executor():
    lm = tbuild(config=TConfig(batch_size=B, seed=0), **_kw())
    return TExecutor(lm, config=lm.config,
                     optimizer=toptim.AdamOptimizer(lr=LR), device="cpu")


@pytest.fixture(scope="module")
def start():
    """JAX's initial (params, opt_state, state) on the host, the LM's
    batch (tokens over the whole vocabulary), and the gates."""
    assert pallas_kernels.flash_supported((B, H, S, D // H), jnp.float32)
    assert pallas_kernels.xent_supported(B * S, V)
    jex = _jax_executor()
    params, opt, state = jax.device_get(jex.init(seed=0))
    batch = synthetic_host_batch(tbuild(config=TConfig(batch_size=B), **_kw()),
                                 np.random.default_rng(1),
                                 {"tokens": V, "label": V})
    return params, opt, state, batch


@pytest.fixture(scope="module")
def jax_step(start):
    params, opt, state, batch = start
    jex = _jax_executor()
    jb = jex.shard_batch(batch)
    (loss, (metrics, _)), grads = jax.jit(jax.value_and_grad(
        jex._loss_fn, has_aux=True))(params, state, jb)
    new_params, _, _, _ = jex.train_step(
        jax.tree.map(jnp.asarray, params), jex.optimizer.init(params), state,
        jb)
    return (float(loss), jax.device_get(metrics), jax.device_get(grads),
            jax.device_get(new_params))


def _tparams(params):
    return params_from_numpy(params, device="cpu")


def test_one_step_loss_and_gradients_match_jax(start, jax_step):
    params, _, state, batch = start
    jloss, jmetrics, jgrads, _ = jax_step
    tex = _torch_executor()
    loss, metrics, _, grads = tex.loss_and_grads(_tparams(params), {}, batch)
    assert abs(float(loss) - jloss) <= LOSS_TOL
    assert int(metrics["train_correct"]) == int(jmetrics["train_correct"])
    assert int(metrics["train_all"]) == int(jmetrics["train_all"]) == B * S
    assert sorted(grads) == sorted(jgrads)
    for op, group in jgrads.items():
        assert sorted(grads[op]) == sorted(group)
        for k, want in group.items():
            got = grads[op][k].numpy()
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            assert err <= GRAD_RTOL * scale + GRAD_ATOL, (op, k, err, scale)


def test_one_adam_step_matches_jax(start, jax_step):
    params, _, state, batch = start
    _, _, jgrads, jnew = jax_step
    tex = _torch_executor()
    tp = _tparams(params)
    tp, ts, _, m = tex.train_step(tp, tex.optimizer.init(tp), {}, batch)
    assert ts["t"] == 1 and m["train_loss"].dim() == 0
    for op, group in jnew.items():
        for k, want in group.items():
            g = np.abs(jgrads[op][k])
            big = g >= max(1e-4 * g.max(), 1e-6)
            diff = np.abs(tp[op][k].detach().numpy() - want)
            assert diff[big].max(initial=0.0) <= 1e-3 * LR, (op, k)
            assert diff.max() <= 2 * LR, (op, k)


def test_clip_norm_step_matches_jax(start):
    """--clip-norm: the global-norm scale applied before the update."""
    params, _, state, batch = start
    jlm = jbuild(config=JConfig(batch_size=B, seed=0, clip_norm=0.05), **_kw())
    jex = JExecutor(jlm, config=jlm.config,
                    optimizer=joptim.SGDOptimizer(lr=0.5, momentum=0.9),
                    devices=jax.devices()[:1])
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, _, _ = jex.train_step(jp, jex.optimizer.init(jp), state,
                                 jex.shard_batch(batch))
    tlm = tbuild(config=TConfig(batch_size=B, seed=0, clip_norm=0.05), **_kw())
    tex = TExecutor(tlm, config=tlm.config,
                    optimizer=toptim.SGDOptimizer(lr=0.5, momentum=0.9),
                    device="cpu")
    tp = _tparams(params)
    tp, _, _, _ = tex.train_step(tp, tex.optimizer.init(tp), {}, batch)
    for op, group in jax.device_get(jp).items():
        for k, want in group.items():
            np.testing.assert_allclose(tp[op][k].detach().numpy(), want,
                                       atol=1e-6, rtol=0)


def test_eval_step_matches_jax(start, jax_step):
    params, _, state, batch = start
    loss, metrics = _torch_executor().eval_step(_tparams(params), {}, batch)
    assert not loss.requires_grad
    assert abs(float(loss) - jax_step[0]) <= LOSS_TOL


def _record(trainer):
    """Wrap ``trainer.metrics.update`` to record each folded loss."""
    seen = []
    update = trainer.metrics.update

    def rec(m):
        seen.append(float(m["train_loss"]))
        update(m)

    trainer.metrics.update = rec
    return seen


def test_fit_loss_trajectory_matches_jax(start):
    """Three Trainer.fit steps from one state on the fixed synthetic
    batch (tokens and labels in {0, 1}, as ``Trainer.synthetic_batch``
    draws them in both packages)."""
    params, opt, state, _ = start
    jex = _jax_executor()
    jex.init = lambda seed=None: (jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, opt), state)
    jtr = JTrainer(jex)
    jseen = _record(jtr)
    jtr.fit(iterations=3, warmup=0, log_every=1, prefetch=0)
    tex = _torch_executor()
    tex.init = lambda seed=None: (_tparams(params),
                                  opt_state_from_numpy(opt, "cpu"), {})
    ttr = TTrainer(tex)
    tseen = _record(ttr)
    stats = ttr.fit(iterations=3, warmup=0, log_every=1)
    assert len(jseen) == len(tseen) == 4  # 3 logged steps + the final fold
    np.testing.assert_allclose(tseen, jseen, atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(stats["step_losses"], jseen[:3],
                               atol=LOSS_TOL, rtol=0)
    assert stats["step_losses"][-1] < stats["step_losses"][0]
    assert stats["iterations"] == 3 and stats["batch_size"] == B


@pytest.mark.parametrize("kw,what", [
    (dict(batches=iter([{}])), "batch iterator")])
def test_trainer_refuses_what_is_not_ported(kw, what):
    ex = _torch_executor()
    with pytest.raises(NotImplementedError, match=what):
        TTrainer(ex).fit(iterations=1, **kw)


@pytest.mark.parametrize("what", ["checkpoint", "telemetry"])
def test_trainer_takes_checkpoints_and_telemetry(tmp_path, what):
    """What item 7 brought: a checkpoint (saved at the end) and run
    telemetry (its summary in the stats), the losses unchanged."""
    from flexflow_torch.runtime.checkpoint import CheckpointManager

    plain = TTrainer(_torch_executor()).fit(iterations=1)
    ex = _torch_executor()
    if what == "telemetry":
        ex.config.telemetry_dir = str(tmp_path)
        stats = TTrainer(ex).fit(iterations=1)
        assert stats["telemetry"]["steps"] == 1
    else:
        with CheckpointManager(str(tmp_path)) as ck:
            stats = TTrainer(ex).fit(iterations=1, checkpoint=ck)
            assert ck.all_steps() == [2]
    assert stats["step_losses"] == plain["step_losses"]


_APP = ["-b", "2", "--seq", "16", "--layers", "2", "--vocab", "64",
        "--d-model", "32", "--heads", "2", "--optimizer", "adam", "--lr",
        "1e-2", "-i", "3", "--seed", "3"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_app_on_cpu(capsys, dtype):
    stats = {}
    assert tapp.main(_APP + ["--dtype", dtype], device="cpu",
                     stats_out=stats) == 0
    out = capsys.readouterr().out
    assert "tokens/s = " in out and "THROUGHPUT = " in out
    losses = stats["step_losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("flag", [
    ["--dp", "2"], ["--sp", "2"], ["--tp", "2"],
    ["--elastic"], ["--telemetry"], ["--lazy-sparse-opt"],
    ["-ll:gpu", "2", "--remat"], ["--dtype", "float16"], ["--ckpt-dir"],
    ["--bogus"]])
def test_transformer_app_refuses_unported_flags(flag):
    with pytest.raises(SystemExit) as e:
        tapp.main(_APP + flag, device="cpu")
    assert e.value.code not in (0, None)
    assert isinstance(e.value.code, str) and e.value.code


def test_transformer_app_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(_APP)
