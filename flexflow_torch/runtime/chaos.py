"""The chaos scenario matrix: the port of ``flexflow_tpu/runtime/
chaos.py``.  One place defines the fault scenarios; the tests
(``tests/test_torch_resilience.py``, ``test_torch_serving_resilience.py``),
``tools/chaos_smoke.py`` and ``chip_smoke.py`` drive them.

Training scenarios inject a fault through
:class:`~flexflow_torch.runtime.resilience.FaultInjector` into a
``steps_per_call=k`` run (k = 8 by default, one CUDA graph a superstep on
CUDA; k = 1 the per-step path) with saves every 8 steps, and require the
recovered loss trajectory to equal the unfaulted run's bit for bit.
Their model is JAX's chaos MLP (16 -> 32 ReLU -> 4, softmax, SGD lr 0.1,
batch 8).  On a world of 8 ranks it runs under JAX's own table, ``fc1``
hybrid-parallel ``n2c4`` (``chaos_table``), every rank of the world
running the scenario together (each with its own injector, the same
schedule); on 4 ranks under ``n2c2``; on one device, as a plain run.
``pipeline_superstep_nan`` runs the same model layer-wise on the
compiled pipeline (``pipeline_table``: two stages of half the world
each), in a world of its own when started outside one.

The serving scenarios run the plain ``Server``'s and the scheduler's
failure models on JAX's scenario stack (vocab 32, d_model 16, 2 heads,
1 layer, 2 slots, max_seq 32, f32): a fault isolates the faulted slots
and every other request keeps the unfaulted tokens, on the padded and
the paged layout; an overload sheds the same requests on every replay;
an engine crash resumes from the journal, or restarts in process, with
the uninterrupted run's tokens; a fleet that loses a replica finishes its
requests on the survivor with a single replica's tokens.
They take ``params`` (a ``{op: {name: array}}`` tree: the tests carry
JAX's across) or draw the port's own from seed 0.

A scenario returns ``(ok, detail)``.  The scenarios whose machinery is
not ported yet stay in :data:`SCENARIOS` and raise
``NotImplementedError`` naming their item; :func:`run_matrix` reports
them as not ported, never as passed.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.optim import SGDOptimizer
from flexflow_torch.parallel import launch
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore
from flexflow_torch.runtime.checkpoint import CheckpointManager
from flexflow_torch.runtime.executor import Executor
from flexflow_torch.runtime.resilience import (
    FailurePolicy,
    FaultInjector,
    ResilientTrainer,
)

#: The acceptance shape: a fault inside a k = 8 superstep, saves at
#: superstep boundaries.
K, ITERS, SAVE_EVERY = 8, 16, 8

Result = Tuple[bool, str]


def chaos_table(ranks: int) -> Dict[str, ParallelConfig]:
    """The chaos model's strategy table on ``ranks`` ranks: JAX's ``fc1``
    at ``n2c4`` on 8 (``flexflow_tpu/runtime/chaos.py``), ``n2c2`` on 4,
    none (data parallelism, or one device) otherwise."""
    c = {8: 4, 4: 2}.get(ranks)
    return {"fc1": ParallelConfig(n=2, c=c)} if c else {}


def chaos_model() -> FFModel:
    """JAX's chaos MLP: 16 -> 32 ReLU -> 4, softmax, batch 8."""
    ff = FFModel(FFConfig(batch_size=8))
    x = ff.create_tensor((8, 16), name="x")
    lbl = ff.create_tensor((8,), dtype=torch.int32, name="label")
    t = ff.dense(x, 32, activation="relu", name="fc1")
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


def tiny_factory(device="cuda") -> Callable[[], Executor]:
    """Executor factory of the chaos model on ``device``, under
    :func:`chaos_table` of the world's size."""

    def make() -> Executor:
        ranks = launch.world_size()
        return Executor(chaos_model(), optimizer=SGDOptimizer(lr=0.1),
                        device=device,
                        strategy=StrategyStore(ranks, chaos_table(ranks)))

    return make


def pipeline_table(ranks: int) -> Dict[str, ParallelConfig]:
    """JAX's layer-wise chaos table on ``ranks`` ranks: ``fc1`` on the
    first half, ``fc2`` and the loss on the second, data-parallel in
    each (two stages of four on 8 ranks, of two on 4)."""
    h = ranks // 2
    first, second = tuple(range(h)), tuple(range(h, 2 * h))
    return {"fc1": ParallelConfig(n=h, device_ids=first),
            "fc2": ParallelConfig(n=h, device_ids=second),
            "softmax": ParallelConfig(n=h, device_ids=second)}


def pipeline_factory(device="cuda") -> Callable[[], Any]:
    """Executor factory of the pipeline scenario: the chaos model under
    :func:`pipeline_table` of the world's size on the compiled pipeline
    step, two microbatches (JAX's ``pipeline_factory``): the fused k = 8
    superstep a rollback at k > 1 needs (one CUDA graph a rank over
    NCCL, a loop over gloo)."""

    def make():
        from flexflow_torch.runtime.pipeline import PipelineExecutor

        ranks = launch.world_size()
        return PipelineExecutor(
            chaos_model(), StrategyStore(ranks, pipeline_table(ranks)),
            optimizer=SGDOptimizer(lr=0.1), device=device, microbatches=2,
            compiled=True)

    return make


def chaos_batch_fn(step: int) -> Dict[str, np.ndarray]:
    """Deterministic per-step batches (JAX's draw): a replayed step sees
    the same data."""
    rng = np.random.default_rng(step)
    return {"x": rng.standard_normal((8, 16)).astype(np.float32),
            "label": rng.integers(0, 4, size=(8,)).astype(np.int32)}


def fit_once(ck_dir: str, injector: Optional[FaultInjector] = None,
             k: int = K, iters: int = ITERS, save_every: int = SAVE_EVERY,
             factory: Optional[Callable] = None, device="cuda") -> Dict:
    """One ResilientTrainer run against ``ck_dir`` (async saves on);
    ``factory(device)`` makes the executor factory."""
    with CheckpointManager(ck_dir, async_save=True) as ck:
        rt = ResilientTrainer((factory or tiny_factory)(device), ck,
                              policy=FailurePolicy(max_restarts=3),
                              fault_injector=injector)
        return rt.fit(iterations=iters, batch_fn=chaos_batch_fn,
                      save_every=save_every, steps_per_call=k)


def trajectory(losses: Dict[int, float], iters: int) -> np.ndarray:
    return np.array([losses[i] for i in range(iters)])


_BASELINES: Dict[tuple, np.ndarray] = {}


def baseline(root: str, k: int = K, iters: int = ITERS,
             save_every: int = SAVE_EVERY, device="cuda",
             factory: Optional[Callable] = None, tag: str = "") -> np.ndarray:
    """The unfaulted trajectory, computed once per shape, device and
    model (``factory``, named by ``tag``)."""
    key = (str(torch.device(device)), k, iters, save_every, tag)
    if key not in _BASELINES:
        out = fit_once(os.path.join(root, f"baseline{tag}_{key[0]}_k{k}_"
                                          f"{iters}"),
                       k=k, iters=iters, save_every=save_every,
                       factory=factory, device=device)
        assert out["restarts"] == 0 and not out["preempted"]
        _BASELINES[key] = trajectory(out["losses"], iters)
    return _BASELINES[key]


def _compare(name: str, base: np.ndarray, got: np.ndarray, out: Dict) -> Result:
    if got.shape == base.shape and np.array_equal(got, base):
        return True, (f"{name}: trajectory bit-identical to unfaulted run "
                      f"(restarts={out['restarts']})")
    bad = int(np.argmax(got != base)) if got.shape == base.shape else -1
    return False, (f"{name}: trajectory DIVERGED (first mismatch at step "
                   f"{bad}, restarts={out['restarts']})")


def _one_fault(name: str, root: str, device, k: int, **fault) -> Result:
    inj = FaultInjector(**fault)
    out = fit_once(os.path.join(root, f"{name}_k{k}"), inj, k=k,
                   device=device)
    if out["restarts"] != 1:
        return False, f"{name}: expected 1 restart, got {out['restarts']}"
    return _compare(name, baseline(root, k=k, device=device),
                    trajectory(out["losses"], ITERS), out)


# -- training scenarios ----------------------------------------------------


def scenario_raised_fault(root: str, device="cuda", k: int = K) -> Result:
    """A raised fault before step 11: a fresh executor (fresh tensors and
    graphs) restores step 8 and replays."""
    return _one_fault("raised", root, device, k, raise_at=(11,))


def scenario_nan_batch(root: str, device="cuda", k: int = K) -> Result:
    """NaN inputs at step 11 write NaNs into the parameters in place; the
    fence finds the loss, step 8 is restored into the same tensors and
    the steps replay on the graph they were captured in."""
    return _one_fault("nan_batch", root, device, k, nan_batch_at=(11,))


def scenario_nan_loss(root: str, device="cuda", k: int = K) -> Result:
    """The host-read loss of step 11 reads NaN once."""
    return _one_fault("nan_loss", root, device, k, nan_loss_at=(11,))


def scenario_sigterm(root: str, device="cuda", k: int = K) -> Result:
    """SIGTERM before step 5: an emergency save at the next boundary and
    a clean return; a second fit on the same directory resumes there and
    finishes.  The two trajectories concatenate to the unfaulted one."""
    d = os.path.join(root, f"sigterm_k{k}")
    first = fit_once(d, FaultInjector(preempt_at=(5,)), k=k, device=device)
    if not first["preempted"]:
        return False, "sigterm: run was not preempted"
    second = fit_once(d, k=k, device=device)
    if second["preempted"] or second["step"] != ITERS:
        return False, f"sigterm: restart did not finish ({second['step']})"
    ok, detail = _compare("sigterm", baseline(root, k=k, device=device),
                          trajectory({**first["losses"], **second["losses"]},
                                     ITERS), second)
    if ok:
        detail += f"; emergency save at step {first['step']}"
    return ok, detail


def scenario_corrupt_checkpoint(root: str, device="cuda", k: int = K
                                ) -> Result:
    """The newest snapshot torn after the save at 8, then a raised fault
    at 10 (k <= 4, saves every 4, so two snapshots exist): restore skips
    the torn step, falls back to step 4 and replays the longer tail."""
    k = min(k, 4)
    inj = FaultInjector(corrupt_checkpoint_at=(8,), raise_at=(10,))
    out = fit_once(os.path.join(root, f"corrupt_k{k}"), inj, k=k, iters=12,
                   save_every=4, device=device)
    if out["restarts"] != 1:
        return False, f"corrupt: expected 1 restart, got {out['restarts']}"
    fired = {m for m, _ in inj.fired}
    if fired != {"corrupt", "raise"}:
        return False, f"corrupt: injector fired {sorted(fired)}"
    return _compare("corrupt", baseline(root, k=k, iters=12, save_every=4,
                                        device=device),
                    trajectory(out["losses"], 12), out)


def dead_pid() -> int:
    """The pid of a process that has exited: the owner of a killed
    writer's staging."""
    child = subprocess.Popen([sys.executable, "-c", ""])
    child.wait()
    return child.pid


def scenario_force_save_kill(root: str, device="cuda", k: int = K) -> Result:
    """A force-replace killed between each of its phases: a fresh manager
    always finds a restorable snapshot, the new value once the staged one
    committed, the old value before."""
    import shutil

    d = os.path.join(root, "force_kill")
    old = {"w": torch.full((4,), 1.0, device=device)}
    new = {"w": torch.full((4,), 2.0, device=device)}

    def restored_w() -> float:
        tmpl = {"w": torch.zeros(4, device=device)}
        with CheckpointManager(d) as ck:
            ck.restore(templates=(tmpl, None, {}))
        return float(tmpl["w"][0])

    with CheckpointManager(d) as ck:
        ck.save(1, old, None, {})
    # Killed during phase 1: the staging of the staged snapshot is left.
    os.makedirs(os.path.join(d, f"1.force-tmp.tmp-{dead_pid()}-0",
                             "params"))
    if restored_w() != 1.0:
        return False, "force_kill: mid-write crash lost the old snapshot"
    # Killed after phase 1: staged snapshot committed, old not retired.
    with CheckpointManager(d) as ck:
        ck._write_force_tmp(1, ck._items(new, None, {}))
    if restored_w() != 2.0:
        return False, "force_kill: committed staging was not promoted"
    # Killed in phase 2: the old step half deleted, the staged one whole.
    with CheckpointManager(d) as ck:
        ck._write_force_tmp(1, ck._items(new, None, {}))
        shutil.rmtree(os.path.join(d, "1", "params"))
    if restored_w() != 2.0:
        return False, "force_kill: torn old + staged new not recovered"
    return True, ("force_kill: every kill point left a restorable "
                  "checkpoint (write-new-then-retire)")


#: The world the pipeline scenario starts when it runs outside one.
PIPELINE_RANKS = 4


def pipeline_nan_rank(root: str, device="cuda", k: int = K) -> Result:
    """The pipeline scenario on this rank of a world."""
    inj = FaultInjector(nan_loss_at=(11,))
    out = fit_once(os.path.join(root, f"pipe_nan_k{k}"), inj, k=k,
                   factory=pipeline_factory, device=device)
    if out["restarts"] != 1:
        return False, (f"pipeline_superstep_nan: expected 1 restart, got "
                       f"{out['restarts']}")
    return _compare("pipeline_superstep_nan",
                    baseline(root, k=k, device=device,
                             factory=pipeline_factory, tag="_pipeline"),
                    trajectory(out["losses"], ITERS), out)


def scenario_pipeline_superstep_nan(root: str, device="cuda",
                                    k: int = K) -> Result:
    """ResilientTrainer over the COMPILED pipeline at k = 8 (JAX's
    scenario): a silent NaN loss inside the second fused superstep is
    caught at its one fence, rolled back to the step-8 snapshot (the
    per-stage trees through ``PipelineLayout``, into the live tensors a
    graph replays on) and replayed bit for bit.  Inside a world every
    rank runs it under :func:`pipeline_table` of the world's size;
    outside one it starts a world of :data:`PIPELINE_RANKS` (NCCL a card
    a rank where the cards suffice, else gloo) and reports rank 0's
    result, or the first rank's failure."""
    if launch.in_world():
        return pipeline_nan_rank(root, device, k)
    kind = torch.device(device).type
    backend = None if kind == "cpu" or \
        torch.cuda.device_count() >= PIPELINE_RANKS else "gloo"
    ranks = launch.run("flexflow_torch.runtime.chaos:pipeline_nan_rank",
                       (root, kind, k), nprocs=PIPELINE_RANKS, device=kind,
                       backend=backend, timeout_s=600)
    bad = [r for r in ranks if not r[0]]
    return bad[0] if bad else ranks[0]


# -- serving scenarios -----------------------------------------------------

SERVING_MODEL = dict(batch_size=2, seq_len=32, vocab_size=32, d_model=16,
                     num_heads=2, num_layers=1)
LAYOUTS = (0, 8)  # padded, paged with 8-token blocks
RECOVERY_BUCKETS = (8, 16, 32)


def _serving_setup(device, kv_block: int = 0, buckets=(8,),
                   prefix_cache: bool = False, params=None):
    """The scenario stack: ``(executor, params)``."""
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import ServingExecutor
    from flexflow_torch.weights import params_from_numpy

    lm = build_transformer_lm(config=FFConfig(batch_size=2), **SERVING_MODEL)
    sex = ServingExecutor(lm, max_batch=2, max_seq=32, buckets=buckets,
                          device=device, kv_block=kv_block,
                          prefix_cache=prefix_cache)
    if params is None:
        return sex, sex.init(seed=0)[0]
    return sex, params_from_numpy(params, device=device)


def _serving_requests():
    """4 requests, prompts of 3-6 tokens, 12 new tokens each, seed 7."""
    from flexflow_torch.runtime.serving import synthetic_requests

    return synthetic_requests(4, 32, prompt_len=(3, 6), max_new_tokens=12,
                              seed=7)


def _serve(stack, requests, **kw):
    from flexflow_torch.runtime.serving import Server

    sex, params = stack
    return Server(sex, params, {}, decode_steps=4, **kw).run(requests)


def _tokens(results) -> Dict[int, List[int]]:
    return {rid: list(r.tokens) for rid, r in results.items()}


def _failed(results) -> List[int]:
    return sorted(rid for rid, r in results.items() if r.error)


def _layout(kv_block: int) -> str:
    return "paged" if kv_block else "padded"


def _plain_base(device, params, buckets=(8,)) -> Dict[int, List[int]]:
    """The unfaulted padded run's tokens (the eager loop: the oracle)."""
    res, _ = _serve(_serving_setup(device, buckets=buckets, params=params),
                    _serving_requests(), graph=False)
    return _tokens(res)


def _isolated(tag: str, res, inj, base) -> Optional[str]:
    """Why a faulted run (NaN cache before superstep 1, raise before 3)
    broke isolation, or None."""
    fired = {m for m, _, _ in inj.fired}
    if fired != {"nan_cache", "raise"}:
        return f"{tag}: injector fired {sorted(fired)}"
    if _failed(res) != [0, 2]:
        return f"{tag}: expected requests [0, 2] to error out, got " \
               f"{_failed(res)}"
    for rid in (1, 3):
        if list(res[rid].tokens) != base[rid]:
            return f"{tag}: request {rid}'s tokens DIVERGED from the " \
                   f"unfaulted run"
    return None


def scenario_serving_decode_fault(root: str, device="cuda",
                                  layouts: Sequence[int] = LAYOUTS,
                                  graph: Optional[bool] = None,
                                  params=None) -> Result:
    """A NaN'd cache row (padded) or first block (paged) before decode
    superstep 1 and a raise before superstep 3: requests 0 and 2 error
    out (the finiteness flag at the readback; the raise before the
    dispatch), 1 and 3 keep the unfaulted padded run's tokens."""
    from flexflow_torch.runtime.serving import ServingFaultInjector

    base = _plain_base(device, params)
    for kv_block in layouts:
        tag = f"serving[{_layout(kv_block)}]"
        inj = ServingFaultInjector(nan_cache_at={1: 0}, raise_at={3: 0})
        res, stats = _serve(_serving_setup(device, kv_block, params=params),
                            _serving_requests(), fault_injector=inj,
                            graph=graph)
        if stats["kv_layout"] != _layout(kv_block):
            return False, f"{tag}: ran {stats['kv_layout']}"
        why = _isolated(tag, res, inj, base)
        if why:
            return False, why
        if res[0].error != "non-finite logits in decode" or \
                not res[2].error.startswith("raised fault"):
            return False, f"{tag}: errors {res[0].error!r}, {res[2].error!r}"
    return True, ("serving: faulted requests [0, 2] errored out; surviving "
                  "slots' sequences byte-identical to the unfaulted run "
                  f"(layouts {[_layout(b) for b in layouts]})")


def scenario_serving_sigterm_drain(root: str, device="cuda",
                                   layouts: Sequence[int] = LAYOUTS,
                                   graph: Optional[bool] = None,
                                   params=None) -> Result:
    """SIGTERM before decode superstep 1 on a journaled Server: it drains
    at the next boundary with no error and work left; a fresh Server on
    the journal serves the rest, and the merged output equals the
    undrained run."""
    from flexflow_torch.runtime.serving import ServingFaultInjector
    from flexflow_torch.serving.journal import RequestJournal

    base = _plain_base(device, params, RECOVERY_BUCKETS)
    for kv_block in layouts:
        tag = f"sigterm_drain[{_layout(kv_block)}]"
        stack = _serving_setup(device, kv_block, RECOVERY_BUCKETS,
                               params=params)
        path = os.path.join(root, "sigterm_drain",
                            f"journal_{kv_block}_{graph}.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):
            os.remove(path)
        inj = ServingFaultInjector(preempt_at={1})
        res_d, st_d = _serve(stack, _serving_requests(), graph=graph,
                             fault_injector=inj,
                             journal=RequestJournal(path))
        if st_d["drained"] is not True or inj.fired != [("preempt", 1, -1)]:
            return False, f"{tag}: drain never triggered ({inj.fired})"
        if _failed(res_d) or len(res_d) >= 4:
            return False, f"{tag}: drained run failed {_failed(res_d)} " \
                          f"or deferred nothing ({len(res_d)} done)"
        if not RequestJournal(path).replay().drained:
            return False, f"{tag}: the journal records no drain"
        res_r, st_r = _serve(stack, _serving_requests(), graph=graph,
                             journal=RequestJournal(path))
        if st_r["drained"] is not False:
            return False, f"{tag}: resume run reported drained"
        if _tokens(res_r) != base:
            return False, f"{tag}: resumed outputs DIVERGED from the " \
                          f"undrained run"
        if signal.getsignal(signal.SIGTERM) != signal.SIG_DFL:
            return False, f"{tag}: SIGTERM's handling was not restored"
    return True, ("sigterm_drain: drained cleanly at the superstep boundary; "
                  "journal resume byte-identical to the undrained run "
                  f"(layouts {[_layout(b) for b in layouts]})")


def scenario_serving_spec_fault(root: str, device="cuda",
                                layouts: Sequence[int] = LAYOUTS,
                                graph: Optional[bool] = None,
                                params=None) -> Result:
    """Speculation (full self-draft, d = 4): clean, its tokens equal
    plain decode's; under the decode-fault matrix requests 0 and 2 error
    at the verify fence and 1 and 3 keep the unspeculated tokens."""
    from flexflow_torch.runtime.serving import ServingFaultInjector

    base = _plain_base(device, params)
    for kv_block in layouts:
        tag = f"spec_fault[{_layout(kv_block)}]"
        stack = _serving_setup(device, kv_block, params=params)
        clean, st = _serve(stack, _serving_requests(), speculate=4,
                           graph=graph)
        if st["speculate"] != 4 or _tokens(clean) != base:
            return False, f"{tag}: clean speculation DIVERGED from plain " \
                          f"decode"
        inj = ServingFaultInjector(nan_cache_at={1: 0}, raise_at={3: 0})
        res, _ = _serve(stack, _serving_requests(), speculate=4, graph=graph,
                        fault_injector=inj)
        why = _isolated(tag, res, inj, base)
        if why:
            return False, why
    return True, ("spec_fault: clean speculation byte-identical to plain "
                  "decode; faulted requests [0, 2] errored at the verify "
                  "fence; survivors byte-identical to the unspeculated run "
                  f"(layouts {[_layout(b) for b in layouts]})")


def _prefix_requests():
    from flexflow_torch.runtime.serving import Request

    rng = np.random.default_rng(11)
    span = rng.integers(0, 32, size=8).astype(np.int32)
    tails = [rng.integers(0, 32, size=n).astype(np.int32) for n in (3, 4, 3)]
    other = rng.integers(0, 32, size=5).astype(np.int32)
    prompts = [np.concatenate([span, t]).astype(np.int32)
               for t in tails] + [other]
    budgets = (8, 16, 8, 8)
    return [Request(id=i, prompt=p, max_new_tokens=budgets[i])
            for i, p in enumerate(prompts)]


def scenario_prefix_donor_eviction(root: str, device="cuda",
                                   graph: Optional[bool] = None,
                                   params=None) -> Result:
    """Requests 0-2 share an 8-token block; the donor (0) is raised out
    before superstep 1 while sharer 1 still points at its block.  The
    refcount keeps the block, the index survives (2 still hits), and
    every sharer equals the unshared padded oracle; the paged run with
    the cache off equals it too."""
    from flexflow_torch.runtime.serving import ServingFaultInjector

    oracle, _ = _serve(_serving_setup(device, buckets=(16,), params=params),
                       _prefix_requests(), graph=graph)
    if _failed(oracle):
        return False, "prefix_donor: unfaulted padded oracle had errors"
    off, _ = _serve(_serving_setup(device, 8, (16,), params=params),
                    _prefix_requests(), graph=graph)
    if _tokens(off) != _tokens(oracle):
        return False, "prefix_donor[paged]: cache OFF diverged from the " \
                      "padded oracle"
    stack = _serving_setup(device, 8, (16,), prefix_cache=True,
                           params=params)
    on, st = _serve(stack, _prefix_requests(), graph=graph)
    if st.get("prefix_hits", 0) < 2 or _tokens(on) != _tokens(oracle):
        return False, (f"prefix_donor: unfaulted cache-on run had "
                       f"{st.get('prefix_hits')} hits or diverged")
    inj = ServingFaultInjector(raise_at={1: 0})
    res, st = _serve(stack, _prefix_requests(), graph=graph,
                     fault_injector=inj)
    if {m for m, _, _ in inj.fired} != {"raise"} or _failed(res) != [0]:
        return False, f"prefix_donor: fired {inj.fired}, failed " \
                      f"{_failed(res)}"
    if st.get("prefix_hits", 0) < 2:
        return False, f"prefix_donor: index lost ({st.get('prefix_hits')} " \
                      f"hits)"
    for rid in (1, 2, 3):
        if list(res[rid].tokens) != list(oracle[rid].tokens):
            return False, (f"prefix_donor: sharer {rid}'s tokens DIVERGED "
                           f"from the unshared oracle after the donor crash")
    return True, ("prefix_donor_eviction: donor crash left sharers "
                  "byte-identical to the unshared run "
                  f"({st['prefix_hits']} hits through the fault)")


def scenario_serving_overload_shed(root: str, device="cuda",
                                   graph: Optional[bool] = None,
                                   params=None) -> Result:
    """Overload shedding as a fault property: 10 requests in bursts of 5
    against 2 slots and ``shed_depth`` 3 spill the waiting queue, and the
    scheduler sheds the worst tier and latest deadline.  The decisions
    run on the virtual clock, so a replay sheds the same requests with
    the same decision log, and every survivor's tokens equal a
    no-shedding run of the survivors alone; the paged stack makes the
    same decisions with the same tokens."""
    from flexflow_torch.serving import (
        ScheduledServer, SchedulerPolicy, WorkloadSpec, make_workload)

    def overload():
        return make_workload(WorkloadSpec(
            n_requests=10, vocab=32, prompt_len=(3, 6), max_new=(2, 8),
            mean_gap_ms=1.0, burst=5, priorities=2, slo_ms=30.0, seed=11))

    policy = SchedulerPolicy(name="slo", preempt=False, shed_depth=3)

    def serve(stack, requests, pol=policy):
        sex, p = stack
        srv = ScheduledServer(sex, p, {}, decode_steps=4, policy=pol,
                              graph=graph)
        results, stats = srv.run(requests)
        return srv.decisions, results, stats

    def shed(results):
        return sorted(rid for rid, r in results.items()
                      if r.error and r.error.startswith("shed"))

    stack = _serving_setup(device, params=params)
    dec_a, res_a, _ = serve(stack, overload())
    shed_a = shed(res_a)
    if not shed_a:
        return False, "overload_shed: the burst never tripped shed_depth"
    if [rid for rid in _failed(res_a) if rid not in shed_a]:
        return False, f"overload_shed: errors besides the sheds: " \
                      f"{_failed(res_a)}"
    dec_b, res_b, _ = serve(stack, overload())
    if shed(res_b) != shed_a or dec_b != dec_a:
        return False, (f"overload_shed: the replay DIVERGED: shed "
                       f"{shed_a} vs {shed(res_b)}")
    survivors = [r for r in overload() if r.id not in shed_a]
    _d, res_c, _ = serve(stack, survivors, SchedulerPolicy(
        name="slo", preempt=False, shed_depth=0))
    if _failed(res_c):
        return False, "overload_shed: the survivors-only run had errors"
    for rid in res_c:
        if res_a[rid].tokens != res_c[rid].tokens:
            return False, (f"overload_shed: survivor {rid}'s tokens "
                           f"DIVERGED from the no-shedding run")
    dec_p, res_p, st_p = serve(_serving_setup(device, 8, params=params),
                               overload())
    if st_p.get("kv_layout") != "paged":
        return False, "overload_shed: the paged check did not run paged"
    if shed(res_p) != shed_a or dec_p != dec_a:
        return False, (f"overload_shed[paged]: decisions DIVERGED from the "
                       f"padded run: shed {shed(res_p)} vs {shed_a}")
    if _tokens(res_p) != _tokens(res_a):
        return False, "overload_shed[paged]: tokens DIVERGED from padded"
    return True, (f"overload_shed: requests {shed_a} shed alike on every "
                  f"replay; all {len(res_c)} survivors byte-identical to "
                  f"the no-shedding run (padded and paged layouts)")


def scenario_serving_engine_crash(root: str, device="cuda",
                                  graph: Optional[bool] = None,
                                  params=None) -> Result:
    """Engine-crash recovery of the scheduler: an engine fault before
    superstep 2 with a restart budget of 0 raises ``ServingCrashLoop``
    (the process death); a fresh server on the same journal restores the
    completed requests and resumes the in-flight ones, with the
    uninterrupted run's tokens.  With a budget of 1 the same fault
    restarts the engine in process (caches, graphs and ledger built
    anew), same tokens; and the crash and resume on the paged stack give
    the padded run's tokens."""
    from flexflow_torch.runtime.serving import (
        ServingCrashLoop, ServingFaultInjector)
    from flexflow_torch.serving import (
        RequestJournal, ScheduledServer, ServingResilience)

    def run(stack, journal=None, injector=None, max_restarts=0):
        sex, p = stack
        return ScheduledServer(
            sex, p, {}, decode_steps=4,
            resilience=ServingResilience(max_restarts=max_restarts),
            journal=journal, fault_injector=injector, graph=graph,
        ).run(_serving_requests())

    def death(msg="injected engine death"):
        return ServingFaultInjector(engine_raise_at={2: msg})

    d = os.path.join(root, "engine_crash")
    stack = _serving_setup(device, buckets=RECOVERY_BUCKETS, params=params)
    base, _ = run(stack)
    if _failed(base):
        return False, "engine_crash: the unfaulted run had errors"
    inj = death()
    try:
        run(stack, RequestJournal(os.path.join(d, "journal.jsonl")), inj)
        return False, "engine_crash: the crash-loop budget never tripped"
    except ServingCrashLoop:
        pass
    if not any(m == "engine" for m, _, _ in inj.fired):
        return False, f"engine_crash: the injector fired {inj.fired}"
    res_r, _ = run(stack, RequestJournal(os.path.join(d, "journal.jsonl")))
    if _failed(res_r) or _tokens(res_r) != _tokens(base):
        return False, ("engine_crash: the journal resume DIVERGED from the "
                       "uninterrupted run")
    res_i, st_i = run(stack, RequestJournal(os.path.join(d, "inproc.jsonl")),
                      death(), max_restarts=1)
    if st_i.get("engine_restarts") != 1:
        return False, (f"engine_crash: expected 1 in-process restart, got "
                       f"{st_i.get('engine_restarts')}")
    if st_i.get("degraded_rungs"):
        return False, (f"engine_crash: one fault took degraded rungs "
                       f"{st_i['degraded_rungs']}")
    if _failed(res_i) or _tokens(res_i) != _tokens(base):
        return False, ("engine_crash: the in-process restart DIVERGED from "
                       "the uninterrupted run")
    paged = _serving_setup(device, 8, RECOVERY_BUCKETS, params=params)
    pj = os.path.join(d, "journal_paged.jsonl")
    try:
        run(paged, RequestJournal(pj), death())
        return False, "engine_crash[paged]: the budget never tripped"
    except ServingCrashLoop:
        pass
    res_p, st_p = run(paged, RequestJournal(pj))
    if st_p.get("kv_layout") != "paged":
        return False, "engine_crash: the paged check did not run paged"
    if _failed(res_p) or _tokens(res_p) != _tokens(base):
        return False, ("engine_crash[paged]: the journal resume DIVERGED "
                       "from the padded uninterrupted run")
    return True, ("engine_crash: journal resume and in-process restart "
                  "both byte-identical to the uninterrupted run (padded "
                  "and paged layouts)")


def scenario_replica_loss(root: str, device="cuda",
                          graph: Optional[bool] = None,
                          params=None) -> Result:
    """Fleet replica loss: a 2-replica ``FleetRouter`` over real
    scheduled servers, each journaling to its own file.  An engine fault
    with a restart budget of 0 kills replica 0 before its decode
    superstep 1; the router marks it dead, releases its engine, replays
    its journal and redistributes its unfinished requests to replica 1,
    which resumes them by its journal-replay prelude (re-prefill over
    prompt ‖ carried).  The fleet's tokens equal an unfaulted
    single-replica run's, whichever replica finished each request; every
    request's span timeline, transplanted ones included, reconciles from
    the telemetry log alone; and the same loss on the paged fleet gives
    the padded run's tokens."""
    from flexflow_torch.obs import spans
    from flexflow_torch.obs.reader import RunLog
    from flexflow_torch.runtime.serving import ServingFaultInjector
    from flexflow_torch.runtime.telemetry import Telemetry
    from flexflow_torch.serving import (
        FleetRouter, RequestJournal, ScheduledServer, ServingResilience)

    d = os.path.join(root, "replica_loss")

    def make_fleet(tag, stacks):
        inj = ServingFaultInjector(
            engine_raise_at={1: "injected replica death"})
        reps = [ScheduledServer(
            sex, p, {}, decode_steps=4,
            resilience=ServingResilience(max_restarts=0),
            journal=RequestJournal(os.path.join(d, f"journal_{tag}.r{i}")),
            fault_injector=inj if i == 0 else None, graph=graph)
            for i, (sex, p) in enumerate(stacks)]
        return FleetRouter(reps, router="least-loaded"), inj

    def setup(kv_block=0):
        return _serving_setup(device, kv_block, RECOVERY_BUCKETS,
                              params=params)

    sex, p = setup()
    base, _ = ScheduledServer(sex, p, {}, decode_steps=4,
                              graph=graph).run(_serving_requests())
    if _failed(base):
        return False, "replica_loss: the unfaulted single replica had errors"
    # The survivor reuses the baseline's stack; the victim has its own.
    fleet, inj = make_fleet("padded", [setup(), (sex, p)])
    tel = Telemetry(os.path.join(d, "telemetry"))
    with tel:
        res, st = fleet.run(_serving_requests())
    if not any(m == "engine" for m, _, _ in inj.fired):
        return False, f"replica_loss: the injector fired {inj.fired}"
    if st.get("dead_replicas") != 1 or fleet.dead != [0]:
        return False, f"replica_loss: expected replica 0 dead, got " \
                      f"{fleet.dead}"
    if not st.get("redistributed"):
        return False, "replica_loss: nothing was redistributed"
    if fleet.replicas[0].engine is not None:
        return False, "replica_loss: the dead replica's engine was kept"
    if _failed(res) or _tokens(res) != _tokens(base):
        return False, ("replica_loss: the redistributed outputs DIVERGED "
                       "from the unfaulted single-replica run")
    carried = [x for x in fleet.decisions
               if x["d"] == "redistribute" and x["carried"]]
    if not carried:
        return False, ("replica_loss: no redistributed request carried a "
                       "journaled prefix")
    tls = spans.timelines_from_run(RunLog.load(tel.path))
    if sorted(tls) != sorted(res):
        return False, f"replica_loss: span timelines {sorted(tls)} for " \
                      f"requests {sorted(res)}"
    bad = [i for i in sorted(tls) if not tls[i].reconciled]
    moved = [i for i in sorted(tls) if tls[i].transplanted]
    if bad or not moved:
        return False, (f"replica_loss: unreconciled timelines {bad}, "
                       f"transplanted {moved}")
    pfleet, _pinj = make_fleet("paged", [setup(8), setup(8)])
    res_p, st_p = pfleet.run(_serving_requests())
    if st_p.get("kv_layout") != "paged":
        return False, "replica_loss: the paged check did not run paged"
    if st_p.get("dead_replicas") != 1 or not st_p.get("redistributed"):
        return False, (f"replica_loss[paged]: dead "
                       f"{st_p.get('dead_replicas')}, redistributed "
                       f"{st_p.get('redistributed')}")
    if _failed(res_p) or _tokens(res_p) != _tokens(base):
        return False, ("replica_loss[paged]: the redistributed outputs "
                       "DIVERGED from the padded single-replica run")
    return True, (f"replica_loss: replica 0 died mid-decode; "
                  f"{st['redistributed']} request(s) ({len(carried)} with "
                  f"carried prefixes) finished on the survivor with the "
                  f"single-replica run's tokens (padded and paged "
                  f"layouts); {len(tls)} span timelines ({len(moved)} "
                  f"transplanted) reconciled from the telemetry log")


# -- not ported yet ----------------------------------------------------------


def _not_ported(name: str, item: str, what: str) -> Callable[..., Result]:
    def scenario(root: str, device="cuda", **kw) -> Result:
        raise NotImplementedError(
            f"{name} needs {what}, not ported yet (ROADMAP.md queue 1, "
            f"{item})")

    scenario.__name__ = f"scenario_{name}"
    scenario.item = item
    return scenario


SCENARIOS: Dict[str, Callable[..., Result]] = {
    "raised_fault": scenario_raised_fault,
    "nan_batch": scenario_nan_batch,
    "nan_loss": scenario_nan_loss,
    "sigterm": scenario_sigterm,
    "corrupt_checkpoint": scenario_corrupt_checkpoint,
    "force_save_kill": scenario_force_save_kill,
    "pipeline_superstep_nan": scenario_pipeline_superstep_nan,
    "loader_fault": _not_ported(
        "loader_fault", "item 12", "the streaming loader"),
    "serving_decode_fault": scenario_serving_decode_fault,
    "serving_overload_shed": scenario_serving_overload_shed,
    "serving_engine_crash": scenario_serving_engine_crash,
    "serving_sigterm_drain": scenario_serving_sigterm_drain,
    "serving_spec_fault": scenario_serving_spec_fault,
    "prefix_donor_eviction": scenario_prefix_donor_eviction,
    "replica_loss": scenario_replica_loss,
    "host_loss": _not_ported("host_loss", "item 13",
                             "the multi-host elastic rig"),
    "coordinator_loss": _not_ported("coordinator_loss", "item 13",
                                    "the multi-host elastic rig"),
}

#: The scenarios that run (the others raise naming their item).
PORTED = tuple(n for n, fn in SCENARIOS.items() if not hasattr(fn, "item"))


def run_matrix(root: str, names: Optional[List[str]] = None,
               device="cuda") -> List[Tuple[Optional[bool], str, str]]:
    """Run the matrix under ``root`` on ``device``: ``[(ok, name,
    detail), ...]`` in scenario order, ``ok`` None for a scenario not
    ported yet."""
    results = []
    for name, fn in SCENARIOS.items():
        if names and name not in names:
            continue
        if hasattr(fn, "item"):
            results.append((None, name, f"not ported ({fn.item})"))
            continue
        try:
            ok, detail = fn(root, device=device)
        except Exception as e:  # a scenario crashing is a failure
            ok, detail = False, f"{name}: crashed with {type(e).__name__}: {e}"
        results.append((ok, name, detail))
    return results
