"""The port's AlexNet slice as a whole, held against the JAX package.

AlexNet at its full widths (64-192-384-256-256 channels, 4096-4096
linears) is built in both packages at image 67 (flat 256 features), 10
classes, batch 4, f32; the JAX ``Executor.init(seed=0)`` parameters are
carried into the port with ``params_from_numpy`` and both take one SGD
step (lr 0.01, momentum 0.9, wd 1e-4) on the same numpy batch.  The JAX
loss is plain jnp (10 classes fail ``xent_supported``); the port's runs
through K3's plain version on the CPU.  Bars:

- the loss within ``LOSS_TOL``;
- every gradient within ``GRAD_RTOL`` of its tensor's largest magnitude
  (f32 sums of up to ``4 x 16 x 16 x 121 x 3`` products in another
  order);
- every updated parameter within ``lr * GRAD_RTOL`` of the gradient's
  scale plus two f32 ulps of the parameter's largest magnitude (both
  sides round ``p - lr (g + wd p)`` once).

Also here: the graph's shapes at 229 against JAX's, the app on the CPU,
the flags it refuses by name, strategy files, ``--eval-iters`` against
the JAX package's eval on the same trained parameters, and eight bf16
steps' losses against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optim as joptim
from flexflow_tpu.apps.common import _run_eval as jrun_eval
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.alexnet import build_alexnet as jbuild
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_tpu.runtime.trainer import Trainer as JTrainer
from flexflow_torch import optim as toptim
from flexflow_torch.apps import alexnet as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.models.alexnet import build_alexnet as tbuild
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.trainer import Trainer as TTrainer
from flexflow_torch.weights import params_from_numpy

B, IMG, CLASSES = 4, 67, 10
SGD = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5


def _jax_executor(classes=CLASSES, batch=B):
    ff = jbuild(batch_size=batch, image_size=IMG, num_classes=classes,
                config=JConfig(batch_size=batch, seed=0))
    return JExecutor(ff, config=ff.config,
                     optimizer=joptim.SGDOptimizer(**SGD),
                     devices=jax.devices()[:1])


def _torch_executor():
    ff = tbuild(batch_size=B, image_size=IMG, num_classes=CLASSES,
                config=TConfig(batch_size=B, seed=0))
    return TExecutor(ff, config=ff.config,
                     optimizer=toptim.SGDOptimizer(**SGD), device="cpu")


def test_alexnet_shapes_match_jax():
    """``tests/test_alexnet.py::test_alexnet_shapes``'s graph at 229,
    every op's name, output shape and parameter shapes equal to JAX's;
    61.1 M parameters."""
    tff, jff = tbuild(batch_size=4), jbuild(batch_size=4)
    shapes = {op.name: op.outputs[0].shape for op in tff.layers}
    assert shapes["conv1"] == (4, 56, 56, 64)
    assert shapes["pool1"] == (4, 27, 27, 64)
    assert shapes["conv2"] == (4, 27, 27, 192)
    assert shapes["pool2"] == (4, 13, 13, 192)
    assert shapes["conv5"] == (4, 13, 13, 256)
    assert shapes["pool3"] == (4, 6, 6, 256)
    assert shapes["flat"] == (4, 9216)
    assert shapes["linear3"] == (4, 1000)
    assert [(op.name, tuple(op.outputs[0].shape)) for op in tff.layers] == \
        [(op.name, tuple(op.outputs[0].shape)) for op in jff.layers]
    for top, jop in zip(tff.layers, jff.layers):
        assert {k: tuple(s.shape) for k, s in top.param_specs().items()} == \
            {k: tuple(s.shape) for k, s in jop.param_specs().items()}
    n = sum(int(np.prod(s.shape)) for op in tff.layers
            for s in op.param_specs().values())
    assert n == 61_100_840


@pytest.fixture(scope="module")
def start():
    """JAX's initial params on the host and one batch with labels over
    the classes."""
    jex = _jax_executor()
    params, _, state = jax.device_get(jex.init(seed=0))
    batch = synthetic_host_batch(_torch_executor().model,
                                 np.random.default_rng(1), {"label": CLASSES})
    return params, state, batch


@pytest.fixture(scope="module")
def jax_step(start):
    params, state, batch = start
    jex = _jax_executor()
    jb = jex.shard_batch(batch)
    (loss, (metrics, _)), grads = jax.jit(jax.value_and_grad(
        jex._loss_fn, has_aux=True))(params, state, jb)
    jp = jax.tree.map(jnp.asarray, params)
    new_params, _, _, _ = jex.train_step(jp, jex.optimizer.init(jp), state, jb)
    return (float(loss), jax.device_get(metrics), jax.device_get(grads),
            jax.device_get(new_params))


def test_one_sgd_step_matches_jax(start, jax_step):
    params, _, batch = start
    jloss, jmetrics, jgrads, jnew = jax_step
    tex = _torch_executor()
    tp = params_from_numpy(params, device="cpu")
    loss, metrics, _, grads = tex.loss_and_grads(tp, {}, batch)
    assert abs(float(loss) - jloss) <= LOSS_TOL
    assert int(metrics["train_correct"]) == int(jmetrics["train_correct"])
    assert sorted(grads) == sorted(jgrads)
    for op, group in jgrads.items():
        assert sorted(grads[op]) == sorted(group)
        for k, want in group.items():
            scale = float(np.abs(want).max())
            err = float(np.abs(grads[op][k].numpy() - want).max())
            assert err <= GRAD_RTOL * scale, (op, k, err, scale)
    tp = params_from_numpy(params, device="cpu")
    tp, _, _, m = tex.train_step(tp, tex.optimizer.init(tp), {}, batch)
    assert abs(float(m["train_loss"]) - jloss) <= LOSS_TOL
    for op, group in jnew.items():
        for k, want in group.items():
            g = float(np.abs(jgrads[op][k]).max())
            ulp = 2 * np.spacing(np.float32(np.abs(want).max()))
            err = float(np.abs(tp[op][k].detach().numpy() - want).max())
            assert err <= SGD["lr"] * GRAD_RTOL * g + ulp, (op, k, err)


#: bf16 losses of the two packages after the same steps: both round the
#: same products in bf16 (eps 2^-8) in different orders, and the
#: differences compound from step to step (at most 0.7 % when this test
#: was written: 0.0068 at image 67's step 8, 0.040 at image 229's step 4).
BF16_LOSS_RTOL = 2e-2


@pytest.mark.parametrize("image,steps", [(IMG, 8), (229, 4)])
def test_bf16_sgd_steps_follow_jax(image, steps):
    """bf16 SGD steps (momentum 0.9, wd 1e-4, as ``bench.py``'s AlexNet
    leg) on one fixed batch with 1000 classes and labels in ``{0, 1}``
    (``synthetic_host_batch``'s default, the bench's batch), from JAX's
    initial bf16 params: every step's loss within ``BF16_LOSS_RTOL`` of
    JAX's, relative to ``max(1, loss)``.  A bf16 fault in a
    convolution's or a pool's gradient would bend one trajectory and not
    the other.  At 229 x 229 (``bench.py``'s image, batch 4) the loss
    rises again at the fourth step in both packages (4.0 to 6.5): the
    configuration's dynamics, not the port's.  Past that step bf16 rounding differences
    grow too fast to compare."""
    classes = 1000
    jff = jbuild(batch_size=B, image_size=image, num_classes=classes,
                 config=JConfig(batch_size=B, seed=0,
                                compute_dtype="bfloat16"))
    jex = JExecutor(jff, config=jff.config,
                    optimizer=joptim.SGDOptimizer(**SGD),
                    devices=jax.devices()[:1])
    tff = tbuild(batch_size=B, image_size=image, num_classes=classes,
                 config=TConfig(batch_size=B, seed=0,
                                compute_dtype="bfloat16"))
    tex = TExecutor(tff, config=tff.config,
                    optimizer=toptim.SGDOptimizer(**SGD), device="cpu")
    batch = synthetic_host_batch(tff, np.random.default_rng(0))
    params, opt, state = jex.init(seed=0)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    assert tp["conv1"]["kernel"].dtype == torch.bfloat16
    jb = jex.shard_batch({"image": batch["image"].astype(jnp.bfloat16),
                          "label": batch["label"]})
    to, ts = tex.optimizer.init(tp), {}
    losses = []
    for step in range(steps):
        params, opt, state, jm = jex.train_step(params, opt, state, jb)
        tp, to, ts, tm = tex.train_step(tp, to, ts, batch)
        want, got = float(jm["train_loss"]), float(tm["train_loss"])
        assert np.isfinite(got)
        assert abs(got - want) <= BF16_LOSS_RTOL * max(1.0, abs(want)), \
            (step, got, want)
        losses.append(got)
    if image == 229:
        assert losses[3] > losses[2] + 1.0, losses


def test_card_branches_move_only_inputs_at_a_kink():
    """``chip_smoke._CardBranches`` (phase 18's CPU step taking the
    card's ReLU masks and pool choices), recorded and replayed here on
    the CPU: the replayed step's gradients equal the recorded one's
    within ``GRAD_RTOL``; a recorded ReLU mask or pool choice that is
    wrong away from its kink fails the replay."""
    import chip_smoke

    tex = _torch_executor()
    params = tex.init_params()
    batch = synthetic_host_batch(tex.model, np.random.default_rng(1),
                                 {"label": CLASSES})

    def step(br, replay):
        br.replay = replay
        with br:
            p = {o: {k: v.detach().clone() for k, v in g.items()}
                 for o, g in params.items()}
            return tex.loss_and_grads(p, {}, batch)[3]

    br = chip_smoke._CardBranches(torch, GRAD_RTOL)
    want = step(br, False)
    assert [k for k, _ in br.log] == ["relu", "pool", "relu", "pool", "relu",
                                      "relu", "relu", "pool", "relu", "relu"]
    got = step(br, True)
    for op, group in want.items():
        for k, w in group.items():
            scale = float(w.abs().max())
            assert float((got[op][k] - w).abs().max()) <= GRAD_RTOL * scale
    for at in (0, 1):  # conv1's ReLU mask, pool1's choices
        bad = chip_smoke._CardBranches(torch, GRAD_RTOL)
        step(bad, False)
        kind, rec = bad.log[at]
        rec = rec.clone().contiguous()
        flat = rec.view(-1)
        if kind == "relu":
            flat[int(torch.nonzero(flat)[0])] = False
        else:
            flat[0] = (flat[0] + 1) % 3
        bad.log[at] = (kind, rec)
        with pytest.raises(RuntimeError, match="other"):
            step(bad, True)


_APP = ["-b", "2", "--image-size", "67", "-i", "2", "--seed", "3"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_alexnet_app_on_cpu(capsys, dtype):
    stats = {}
    assert tapp.main(_APP + ["--dtype", dtype], device="cpu",
                     stats_out=stats) == 0
    out = capsys.readouterr().out
    assert "tp = " in out and "images/s" in out and "THROUGHPUT = " in out
    losses = stats["step_losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))


@pytest.mark.parametrize("flag,why", [
    (["-d", "images/"], "item 12"), (["--dataset", "images/"], "item 12"),
    (["-s", "auto"], "item 11"), (["--search"], "item 11"),
    (["--search-iters", "10"], "item 11"), (["-s", "s.pb"], "protobuf"),
    # Under ranks --remat runs (tests/test_torch_mesh_train.py); what
    # stays refused there names its own item.
    pytest.param(["--elastic", "-ll:gpu", "2"], "item 13",
                 id="flag6-item 9")])
def test_alexnet_app_refuses_by_name(flag, why):
    with pytest.raises(SystemExit) as e:
        tapp.main(_APP + flag, device="cpu")
    msg = e.value.code
    assert isinstance(msg, str) and flag[0] in msg and why in msg, msg


def test_alexnet_app_takes_a_one_gpu_strategy_file(tmp_path, capsys):
    """A JSON file written by the JAX package: every op on the one GPU
    runs; on one rank an op split two ways is refused, naming the op and
    the ranks it needs, and so is an op placed on a device past the one
    rank (a layer-wise table needs the ranks it names)."""
    ok = JStore(1)
    ok.set("conv1", JPC(n=1))
    ok.set("linear1", JPC(device_ids=(0,)))
    ok.save(str(tmp_path / "one.json"))
    assert tapp.main(_APP + ["-s", str(tmp_path / "one.json")],
                     device="cpu") == 0
    wide = JStore(2)
    wide.set("linear1", JPC(c=2))
    wide.save(str(tmp_path / "two.json"))
    with pytest.raises(SystemExit, match="'linear1'.*-ll:gpu 2"):
        tapp.main(_APP + ["--strategy", str(tmp_path / "two.json")],
                  device="cpu")
    subset = JStore(1)
    subset.set("linear1", JPC(device_ids=(1,)))
    subset.save(str(tmp_path / "subset.json"))
    with pytest.raises(SystemExit, match="'linear1'.*only 1 devices exist"):
        tapp.main(_APP + ["-s", str(tmp_path / "subset.json")], device="cpu")


def test_eval_iters_match_jax(capsys):
    """``--eval-iters 2`` after one warmup and one timed SGD step from the
    JAX parameters, against the JAX package's eval (``_run_eval``) after
    the same two steps of its ``Trainer.fit``: the same loss within
    ``LOSS_TOL``, the same accuracy."""
    argv = ["-b", str(B), "--image-size", str(IMG), "-i", "1",
            "--eval-iters", "2", "--optimizer", "sgd", "--seed", "0"]
    jex = _jax_executor(classes=1000)
    jparams, jopt, jstate = jax.device_get(jex.init(seed=0))
    jex.init = lambda seed=None: (jax.tree.map(jnp.asarray, jparams),
                                  jax.tree.map(jnp.asarray, jopt), jstate)
    jtr = JTrainer(jex)
    jtr.fit(iterations=1, warmup=1, prefetch=0)
    cfg = JConfig.parse_args(list(argv))
    assert cfg.eval_iters == 2
    want = jrun_eval(jtr, *jtr.final[::2], cfg, None)
    capsys.readouterr()

    init = TExecutor.init

    def carried(self, seed=None):
        p = params_from_numpy(jparams, device="cpu")
        return p, self.optimizer.init(p), {}

    TExecutor.init = carried
    try:
        stats = {}
        assert tapp.main(argv, device="cpu", stats_out=stats) == 0
    finally:
        TExecutor.init = init
    got = stats["eval"]
    assert got["batches"] == want["batches"] == 2
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL
    assert got["accuracy"] == want["accuracy"]
    assert "EVAL loss = " in capsys.readouterr().out


def test_trainer_evaluate_reads_every_batch_it_is_given():
    tex = _torch_executor()
    tr = TTrainer(tex)
    params = tex.init_params()
    batches = [tr.synthetic_batch(seed=s) for s in (1, 2, 3)]
    ev = tr.evaluate(params, {}, iter(batches))
    assert ev["batches"] == 3 and np.isfinite(ev["loss"])
    assert tr.evaluate(params, {}, iter(batches), iterations=2)["batches"] == 2


@pytest.mark.parametrize("app", ["dlrm", "transformer"])
def test_other_apps_take_eval_iters_and_a_one_gpu_strategy(app, tmp_path,
                                                           capsys):
    """``--eval-iters`` and ``-s FILE.json`` live in the shared harness:
    the DLRM and LM apps take them too."""
    from flexflow_torch.apps import dlrm as tdlrm
    from flexflow_torch.apps import transformer as ttransformer

    store = JStore(1)
    store.set("embeddings" if app == "dlrm" else "lm_head", JPC(n=1))
    store.save(str(tmp_path / "s.json"))
    argv = ["-b", "8", "-i", "1", "--eval-iters", "2", "-s",
            str(tmp_path / "s.json")]
    if app == "dlrm":
        main = tdlrm.main
    else:
        main = ttransformer.main
        argv += ["--seq", "16", "--layers", "1", "--vocab", "64",
                 "--d-model", "32", "--heads", "2"]
    stats = {}
    assert main(argv, device="cpu", stats_out=stats) == 0
    assert stats["eval"]["batches"] == 2
    assert np.isfinite(stats["eval"]["loss"])
    assert "EVAL loss = " in capsys.readouterr().out
