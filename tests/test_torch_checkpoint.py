"""The port's checkpoints (``flexflow_torch/runtime/checkpoint.py``) and
the train-to-serve handoff, on the CPU at small sizes.

- A JAX run's orbax snapshot, converted into the port's format
  (``tests/jax_ckpt_to_torch.py``), resumes in the port: its next 4
  losses are within 1e-5 of JAX's own continuation.
- Save then restore is bit-exact for params, Adam's m, v and t and
  BatchNorm's running statistics, and writes into the templates' own
  tensors.
- The durability cases of ``tests/test_checkpoint.py``: torn-step
  fallback, every step torn, a key mismatch, a periodic save over a torn
  step, a force-replace killed between its phases, retention, async
  saves visible at restore, and an async write error raised at the next
  call.  A read-only manager (a server restoring from a running
  trainer's directory) leaves the trainer's in-flight staging alone.
  The key mismatch raises ``ValueError``, the contract that test
  states (the JAX package itself fails it on this tree).
- ``Trainer.fit`` with a checkpoint resumes bit for bit, per step and as
  supersteps; ``apps.serve --ckpt-dir`` serves a port snapshot with the
  tokens of the same params in memory, and of JAX serving JAX's snapshot
  of the same weights.
"""

import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import optim as joptim
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime import serving as jserving
from flexflow_tpu.runtime.checkpoint import CheckpointManager as JCkpt
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_tpu.runtime.resilience import ResilientTrainer as JResilient
from flexflow_torch import optim as toptim
from flexflow_torch.apps import serve as tserve
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.graph import FFModel as TModel
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.runtime import serving as tserving
from flexflow_torch.runtime.checkpoint import (
    CheckpointManager,
    TornCheckpointError,
    flatten,
)
from flexflow_torch.runtime.chaos import dead_pid, tiny_factory
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.resilience import ResilientTrainer
from flexflow_torch.runtime.trainer import Trainer

from jax_ckpt_to_torch import convert

B, S, V, D, H, L, LR = 2, 16, 64, 32, 2, 2, 1e-3
LOSS_TOL = 1e-5


def _raw(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _bits(a, b) -> list:
    """Key paths where two trees differ in dtype or any bit."""
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    return [k for k in fa if fa[k].dtype != fb[k].dtype or
            fa[k].shape != fb[k].shape or
            not torch.equal(_raw(fa[k]), _raw(fb[k]))]


def _mlp():
    return tiny_factory("cpu")()


def _trained_mlp(steps=2):
    ex = _mlp()
    p, o, s = ex.init(seed=1)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        batch = {"x": rng.standard_normal((8, 16)).astype(np.float32),
                 "label": rng.integers(0, 4, size=8).astype(np.int32)}
        p, o, s, _ = ex.train_step(p, o, s, ex.shard_batch(batch))
    return ex, p, o, s


def _bn_net():
    ff = TModel(TConfig(batch_size=4, seed=0))
    x = ff.create_tensor((4, 6, 6, 3), name="image")
    label = ff.create_tensor((4,), dtype=torch.int32, name="label")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation=None, name="conv")
    t = ff.batch_norm(t, relu=True, name="bn")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 10, name="linear_out")
    ff.softmax(t, label, name="softmax")
    return TExecutor(ff, optimizer=toptim.AdamOptimizer(lr=LR), device="cpu")


# -- round trip ----------------------------------------------------------------


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_bit_exact_and_in_place(tmp_path, async_save):
    ex = _bn_net()
    p, o, s = ex.init(seed=0)
    for i in range(2):
        batch = Trainer(ex).synthetic_batch(seed=i)
        p, o, s, _ = ex.train_step(p, o, s, batch)
    assert int(o["t"]) == 2 and float(s["bn"]["running_mean"].abs().sum()) > 0
    with CheckpointManager(str(tmp_path), async_save=async_save) as ck:
        assert ck.save(2, p, o, s)
        templates = ex.init(seed=7)
        ptrs = [t.data_ptr() for tree in templates
                for t in flatten(tree).values()]
        step, rp, ro, rs = ck.restore(templates=templates)
    assert step == 2 and (rp, ro, rs) == tuple(templates)
    assert [t.data_ptr() for tree in (rp, ro, rs)
            for t in flatten(tree).values()] == ptrs
    assert not _bits(rp, p) and not _bits(ro, o) and not _bits(rs, s)
    assert sorted(os.listdir(tmp_path / "2")) == ["opt_state", "params",
                                                  "state"]


def test_none_template_reads_the_tree_and_empty_items_are_left_out(tmp_path):
    ex, p, o, s = _trained_mlp()
    assert o is None and s == {}  # plain SGD, no op state
    with CheckpointManager(str(tmp_path)) as ck:
        ck.save(3, p, o, s)
        assert sorted(os.listdir(tmp_path / "3")) == ["params"]
        step, rp, ro, rs = ck.restore(templates=(None, None, {}))
    assert step == 3 and ro is None and rs == {}
    assert not _bits(rp, p)


# -- durability (tests/test_checkpoint.py::TestDurability) -----------------------


def _torn_fallback(d):
    ex, p, o, s = _trained_mlp()
    p2 = {op: {k: v + 1.0 for k, v in g.items()} for op, g in p.items()}
    with CheckpointManager(d) as ck:
        ck.save(1, p, o, s)
        ck.save(2, p2, o, s)
    shutil.rmtree(os.path.join(d, "2", "params"))
    with CheckpointManager(d) as ck:
        step, rp, _, _ = ck.restore(templates=ex.init(seed=3))
    assert step == 1 and not _bits(rp, p)


def _all_torn(d):
    ex, p, o, s = _trained_mlp()
    with CheckpointManager(d) as ck:
        ck.save(1, p, o, s)
    shutil.rmtree(os.path.join(d, "1", "params"))
    with CheckpointManager(d) as ck:
        with pytest.raises(TornCheckpointError):
            ck.restore(templates=ex.init())
    empty = os.path.join(d, "empty")
    with CheckpointManager(empty) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore(templates=ex.init())


def _key_mismatch(d):
    ex, p, o, s = _trained_mlp()
    with CheckpointManager(d) as ck:
        ck.save(1, p, o, s)
        bad = {("fc1_renamed" if k == "fc1" else k): v for k, v in p.items()}
        with pytest.raises(ValueError, match="key mismatch"):
            ck.restore(templates=(bad, o, s))
        wide = {op: {k: torch.zeros(v.shape[0] + 1, *v.shape[1:])
                     for k, v in g.items()} for op, g in p.items()}
        with pytest.raises(ValueError, match="saved"):
            ck.restore(templates=(wide, o, s))


def _periodic_replaces_torn(d):
    ex, p, o, s = _trained_mlp()
    with CheckpointManager(d) as ck:
        ck.save(1, p, o, s)
        shutil.rmtree(os.path.join(d, "1", "params"))
        ck.reload()
        assert ck.save(1, p, o, s)  # replaced, not skipped
        step, rp, _, _ = ck.restore(templates=ex.init(seed=4))
        assert step == 1 and not _bits(rp, p)
        assert not ck.save(1, p, o, s)  # an intact step is not re-saved


def _retention(d):
    ex, p, o, s = _trained_mlp()
    with CheckpointManager(d, max_to_keep=2) as ck:
        for step in (1, 2, 3, 4):
            ck.save(step, p, o, s)
        assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    with CheckpointManager(d, save_interval_steps=5) as ck:
        assert not ck.save(6, p, o, s)      # off the interval
        assert ck.save(10, p, o, s)
        assert not ck.save(9, p, o, s)      # older than the latest
        assert ck.save(9, p, o, s, force=True)
    assert sorted(n for n in os.listdir(d) if not n.isdigit()) == []


def _async_visible_at_restore(d):
    ex, p, o, s = _trained_mlp()
    with CheckpointManager(d, async_save=True) as ck:
        want = {op: {k: v.clone() for k, v in g.items()}
                for op, g in p.items()}
        assert ck.save(5, p, o, s)
        # The host copy is taken before save returns: later in-place
        # updates do not reach the snapshot.
        with torch.no_grad():
            for t in flatten(p).values():
                t.add_(1.0)
        step, rp, _, _ = ck.restore(templates=ex.init(seed=9))
    assert step == 5 and not _bits(rp, want)


DURABILITY = {
    "torn_fallback": _torn_fallback,
    "all_torn": _all_torn,
    "key_mismatch": _key_mismatch,
    "periodic_replaces_torn": _periodic_replaces_torn,
    "retention": _retention,
    "async_visible_at_restore": _async_visible_at_restore,
}


@pytest.mark.parametrize("case", list(DURABILITY))
def test_durability(tmp_path, case):
    DURABILITY[case](str(tmp_path / "ck"))


@pytest.mark.parametrize("phase", ["mid_write", "after_stage", "mid_retire"])
def test_force_replace_killed_between_phases_stays_restorable(tmp_path,
                                                              phase):
    """A kill inside the staged write leaves the old snapshot; after the
    staged one committed (the old one whole or half deleted) the next
    manager promotes the new one."""
    d = str(tmp_path)
    old = {"w": {"k": torch.full((4,), 1.0)}}
    new = {"w": {"k": torch.full((4,), 2.0)}}
    with CheckpointManager(d) as ck:
        ck.save(1, old, None, {})
        if phase == "mid_write":
            os.makedirs(os.path.join(d, f"1.force-tmp.tmp-{dead_pid()}-0",
                                     "params"))
        else:
            ck._write_force_tmp(1, ck._items(new, None, {}))
            if phase == "mid_retire":
                shutil.rmtree(os.path.join(d, "1", "params"))
    tmpl = {"w": {"k": torch.zeros(4)}}
    with CheckpointManager(d) as ck:
        assert ck.restore(templates=(tmpl, None, {}))[0] == 1
    assert float(tmpl["w"]["k"][0]) == (1.0 if phase == "mid_write" else 2.0)
    assert os.listdir(d) == ["1"]


def test_a_reader_leaves_a_live_writer_s_staging(tmp_path, monkeypatch):
    """A server restores from a running trainer's directory while the
    trainer's async save is in flight: the reader deletes and writes
    nothing, a second writer removes only a dead writer's staging, and
    the live write commits."""
    ex, p, o, s = _trained_mlp()
    d = str(tmp_path)
    started, release = threading.Event(), threading.Event()
    real_save = torch.save

    def slow_save(obj, path):
        started.set()
        release.wait()
        real_save(obj, path)

    ck = CheckpointManager(d, async_save=True)
    assert ck.save(1, p, o, s)
    ck.wait_until_finished()
    monkeypatch.setattr(torch, "save", slow_save)
    assert ck.save(2, p, o, s)
    assert started.wait(30)
    live = [n for n in os.listdir(d) if n.startswith("2.tmp-")]
    dead = os.path.join(d, f"1.tmp-{dead_pid()}-0")
    os.makedirs(os.path.join(dead, "params"))
    reader = CheckpointManager(d, read_only=True)
    assert reader.restore(templates=ex.init(seed=9))[0] == 1
    assert not reader.save(3, p, o, s)
    assert len(live) == 1 and os.path.isdir(dead)
    CheckpointManager(d).close()
    assert os.path.isdir(os.path.join(d, live[0]))
    assert not os.path.exists(dead)
    release.set()
    ck.close()
    assert sorted(os.listdir(d)) == ["1", "2"]


@pytest.mark.parametrize("call", ["save", "wait_until_finished", "restore",
                                  "close"])
def test_async_write_error_is_raised_at_the_next_call(tmp_path, call):
    ex, p, o, s = _trained_mlp()
    ck = CheckpointManager(str(tmp_path), async_save=True)

    def boom(dest, items):
        raise OSError("disk full")

    ck._write = boom
    assert ck.save(1, p, o, s)  # returns once the host copy is taken
    args = {"save": (2, p, o, s), "restore": (ex.init(),)}.get(call, ())
    with pytest.raises(RuntimeError, match="disk full"):
        getattr(ck, call)(*args)
    ck.close()  # the error was raised once, then cleared


# -- Trainer.fit with a checkpoint ---------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_fit_resumes_bit_for_bit(tmp_path, k):
    """Two fits on one directory equal one fit of their steps."""
    warm = k
    with CheckpointManager(str(tmp_path / "a")) as ck:
        Trainer(_bn_net()).fit(iterations=4, warmup=warm, checkpoint=ck,
                               save_every=2, steps_per_call=k)
        assert ck.latest_step() == warm + 4
        t = Trainer(_bn_net())
        second = t.fit(iterations=4, warmup=warm, checkpoint=ck,
                       steps_per_call=k)
        assert ck.latest_step() == 2 * (warm + 4)
    whole = Trainer(_bn_net())
    full = whole.fit(iterations=4 + warm + 4, warmup=warm,
                     steps_per_call=k)
    assert second["step_losses"] == full["step_losses"][-(warm + 4):]
    for a, b in zip(t.final, whole.final):
        assert not _bits(a, b)


# -- JAX's orbax snapshot into the port ----------------------------------------


def _lm_kw():
    return dict(batch_size=B, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L)


def _lm_batch(step):
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, V, size=(B, S)).astype(np.int32)
    return {"tokens": toks, "label": np.roll(toks, -1, axis=1)}


def _jax_lm_factory():
    def make():
        lm = jbuild(config=JConfig(batch_size=B, seed=0), **_lm_kw())
        return JExecutor(lm, config=lm.config,
                         optimizer=joptim.AdamOptimizer(lr=LR),
                         devices=jax.devices()[:1])
    return make


def _torch_lm_factory():
    def make():
        lm = tbuild(config=TConfig(batch_size=B, seed=0), **_lm_kw())
        return TExecutor(lm, config=lm.config,
                         optimizer=toptim.AdamOptimizer(lr=LR), device="cpu")
    return make


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    with JCkpt(jdir) as ck:
        JResilient(_jax_lm_factory(), ck).fit(iterations=4,
                                              batch_fn=_lm_batch,
                                              save_every=4)
    templates = _jax_lm_factory()().init(seed=0)
    assert convert(jdir, tdir, templates) == 4
    with JCkpt(jdir) as ck:
        want = JResilient(_jax_lm_factory(), ck).fit(
            iterations=8, batch_fn=_lm_batch, save_every=4)["losses"]
    with CheckpointManager(tdir) as ck:
        got = ResilientTrainer(_torch_lm_factory(), ck).fit(
            iterations=8, batch_fn=_lm_batch, save_every=4)["losses"]
    assert sorted(got) == sorted(want) == [4, 5, 6, 7]
    np.testing.assert_allclose([got[s] for s in range(4, 8)],
                               [want[s] for s in range(4, 8)],
                               atol=LOSS_TOL, rtol=0)


# -- train to serve ------------------------------------------------------------

SERVE_ARGV = ["--vocab", str(V), "--d-model", str(D), "--heads", str(H),
              "--layers", str(L), "--max-seq", str(S), "--max-batch", "2",
              "--buckets", "8,16", "--requests", "3", "--prompt-len", "3:6",
              "--max-new", "5", "--decode-steps", "4", "--seed", "1"]


def _tokens(results):
    return {rid: list(r.tokens) for rid, r in results.items()}


def test_serve_app_restores_a_port_snapshot(tmp_path, capsys):
    ck_dir = str(tmp_path / "ck")
    ex = _torch_lm_factory()()
    t = Trainer(ex)
    with CheckpointManager(ck_dir) as ck:
        t.fit(iterations=2, warmup=1, checkpoint=ck)
    params = t.final[0]
    stats = {}
    assert tserve.main(SERVE_ARGV + ["--ckpt-dir", ck_dir], device="cpu",
                       stats_out=stats) == 0
    assert "restored training checkpoint step 3" in capsys.readouterr().out
    served = _tokens(stats["results"])
    # The same snapshot as the draft: speculation changes no token.
    spec = {}
    assert tserve.main(SERVE_ARGV + ["--ckpt-dir", ck_dir, "--speculate",
                                     "2", "--draft-ckpt", ck_dir],
                       device="cpu", stats_out=spec) == 0
    assert "restored draft checkpoint step 3" in capsys.readouterr().out
    assert _tokens(spec["results"]) == served
    assert spec["spec_acceptance_rate"] == 1.0
    # The same params in memory.
    lm = tbuild(config=TConfig(batch_size=2), **dict(_lm_kw(), batch_size=2))
    sex = tserving.ServingExecutor(lm, max_batch=2, max_seq=S,
                                   buckets=(8, 16), device="cpu")
    reqs = tserving.synthetic_requests(3, V, prompt_len=(3, 6),
                                       max_new_tokens=5, seed=1)
    live, _ = tserving.Server(sex, params, {}, decode_steps=4).run(reqs)
    assert _tokens(live) == served
    # JAX serving JAX's snapshot of the same weights.
    np_params = {op: {k: v.detach().numpy() for k, v in g.items()}
                 for op, g in params.items()}
    jdir = str(tmp_path / "jax")
    with JCkpt(jdir) as ck:
        ck.save(3, jax.tree.map(np.asarray, np_params), None, {})
    jlm = jbuild(config=JConfig(batch_size=2), **dict(_lm_kw(), batch_size=2))
    jsex = jserving.ServingExecutor(jlm, max_batch=2, max_seq=S,
                                    buckets=(8, 16))
    step, jparams, jstate = jsex.restore(jdir)
    jreqs = jserving.synthetic_requests(3, V, prompt_len=(3, 6),
                                        max_new_tokens=5, seed=1)
    jres, _ = jserving.Server(jsex, jparams, jstate,
                              decode_steps=4).run(jreqs)
    assert step == 3 and _tokens(jres) == served


def test_serve_app_draft_ckpt_needs_speculation(tmp_path):
    with pytest.raises(SystemExit, match="--speculate"):
        tserve.main(SERVE_ARGV + ["--draft-ckpt", str(tmp_path)],
                    device="cpu")


def test_serving_restore_keeps_the_training_params(tmp_path):
    """``ServingExecutor.restore`` reads the optimizer state and drops
    it; the params land on the serving device."""
    ex = _torch_lm_factory()()
    p, o, s = ex.init(seed=2)
    with CheckpointManager(str(tmp_path)) as ck:
        ck.save(7, p, o, s)
    lm = tbuild(config=TConfig(batch_size=2), **dict(_lm_kw(), batch_size=2))
    sex = tserving.ServingExecutor(lm, max_batch=2, max_seq=S, buckets=(8,),
                                   device="cpu")
    step, params, state = sex.restore(str(tmp_path))
    assert step == 7 and state == {} and not _bits(params, p)
