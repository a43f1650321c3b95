"""Rank bodies of the layer-wise pipeline's worlds
(``runtime/pipeline.py``): the CPU tests' ``world_cases`` and chip_smoke's
``chip_apps``.

A *case* is a dict: ``model`` (a key of :data:`MODELS`) and its
``model_kw``, ``config`` (FFConfig fields), ``table`` (op name ->
``ParallelConfig`` JSON, ``device_ids`` included: the world's ranks),
``optimizer`` (``(name, kwargs)``), ``microbatches``, ``schedule``,
``chunk``, ``compiled``, ``accum_steps``, ``superstep`` (``k``: the
batches run through ``build_superstep(k)`` and ``stack_steps``, k at a
time), ``batches`` (global host batches, numpy), ``params`` (a numpy tree, per
stage or one executor's, carried in by ``weights``), ``eval`` (a batch
for one ``eval_step`` after the steps), ``refusals`` (the trainer's),
``fault`` (a key of :data:`FAULTS`), ``snapshot`` (a directory to save
the trained state into, or ``restore`` one to restore from before the
steps).  Its result: the losses, every step's metrics, the event list,
the hand-offs this rank sent in the last step, whether the executor took
the compiled step, the trained parameters gathered whole (rank 0's;
``{}`` elsewhere) and whether ``jax`` was imported.  An ``app`` case runs an app's ``main`` on
its argv inside the rank instead.

Run from a script under ``if __name__ == "__main__":`` (spawned ranks
import the main module)::

    from flexflow_torch.parallel import launch
    launch.run("flexflow_torch.tools.mesh_pipeline:world_cases",
               ([case, ...],), nprocs=4, device="cpu")
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict, List

import numpy as np
import torch


def two_stage(batch: int = 8, din: int = 12, dh: int = 16, classes: int = 4,
              dropout: float = 0.0):
    """JAX's ``tests/test_pipeline.py::_two_stage_model`` (with
    ``dropout``, ``tests/test_pipeline_chunk.py::_model``'s ``drop``
    after ``enc1``)."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch))
    x = ff.create_tensor((batch, din), name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
    t = ff.dense(x, dh, activation="relu", name="enc0")
    t = ff.dense(t, dh, activation="relu", name="enc1")
    if dropout > 0.0:
        t = ff.dropout(t, rate=dropout, name="drop")
    t = ff.dense(t, dh, activation="relu", name="dec0")
    t = ff.dense(t, classes, activation=None, name="dec1")
    ff.softmax(t, lbl, name="softmax")
    return ff


def skip(batch: int = 8, din: int = 12, classes: int = 4):
    """JAX's skip-connection model (``test_pipeline_skip_connection_
    grads``): stage 0's output read by stages 1 and 2."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch))
    x = ff.create_tensor((batch, din), name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
    t0 = ff.dense(x, 8, activation="relu", name="s0")
    t1 = ff.dense(t0, 8, activation="relu", name="s1")
    t2 = ff.concat([t0, t1], axis=1, name="s2cat")
    t3 = ff.dense(t2, classes, activation=None, name="s2fc")
    ff.softmax(t3, lbl, name="softmax")
    return ff


def deep(batch: int = 16, din: int = 12, classes: int = 4):
    """JAX's ``tests/test_pipeline_chunk.py::_deep_model``: four ReLU
    layers, a head and the loss."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch))
    x = ff.create_tensor((batch, din), name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
    t = x
    for i in range(4):
        t = ff.dense(t, 16, activation="relu", name=f"fc{i}")
    t = ff.dense(t, classes, activation=None, name="head")
    ff.softmax(t, lbl, name="softmax")
    return ff


def emb(batch: int = 16, vocab: int = 96, bag: int = 4, sparse: bool = True):
    """JAX's ``tests/test_pipeline_sparse.py::_model``: an embedding
    stage, then two dense layers and the loss."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch,
                          sparse_embedding_updates=sparse))
    ids = ff.create_tensor((batch, bag), dtype=torch.int32, name="ids")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
    t = ff.embedding(ids, vocab, 8, aggr="sum", name="emb")
    t = ff.dense(t, 16, activation="relu", name="fc1")
    t = ff.dense(t, 4, activation=None, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


def alexnet(batch: int = 12, image: int = 67, classes: int = 10):
    from flexflow_torch.models.alexnet import build_alexnet

    return build_alexnet(batch_size=batch, image_size=image,
                         num_classes=classes)


def nmt(**kw):
    from flexflow_torch.models.nmt import build_nmt

    return build_nmt(**kw)


MODELS = {"two_stage": two_stage, "skip": skip, "deep": deep, "emb": emb,
          "alexnet": alexnet, "nmt": nmt}


def _seed_one(real):
    """The loss seeded with 1 instead of ``1/m``: the microbatches'
    gradients then sum to ``m`` times the mean."""
    return lambda self, m: 1.0


def _drop_skip_sum(real):
    """A skip connection's cotangents not summed: only the first
    consumer's reaches the producer."""
    def collect(self, si, mi, dout_back, out_meta):
        for name, parts in dout_back[mi].items():
            del parts[1:]
        return real(self, si, mi, dout_back, out_meta)
    return collect


#: Planted faults: (PipelineExecutor method, wrapper of the real one).
FAULTS = {"seed_one": ("_loss_seed", _seed_one),
          "drop_skip_sum": ("_collect_douts", _drop_skip_sum)}


def planted(fault):
    """Plant ``fault`` (a key of :data:`FAULTS`, or None) for this
    process; returns the undo."""
    from flexflow_torch.runtime.pipeline import PipelineExecutor

    if fault is None:
        return lambda: None
    name, wrap = FAULTS[fault]
    real = getattr(PipelineExecutor, name)
    setattr(PipelineExecutor, name, wrap(real))
    return lambda: setattr(PipelineExecutor, name, real)


def _numpy(tree):
    return {op: {k: v.detach().float().cpu().numpy() if v.is_floating_point()
                 else v.cpu().numpy() for k, v in g.items()}
            for op, g in tree.items()}


def build(case: Dict[str, Any]):
    """The case's model and executor (``make_executor``: the pipeline for
    a layer-wise table)."""
    from flexflow_torch.optim import AdamOptimizer, SGDOptimizer
    from flexflow_torch.parallel import launch
    from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore
    from flexflow_torch.runtime.pipeline import make_executor

    ff = MODELS[case["model"]](**case.get("model_kw", {}))
    for k, v in case.get("config", {}).items():
        setattr(ff.config, k, v)
    name, kw = case.get("optimizer", ("sgd", {"lr": 0.1, "momentum": 0.9}))
    opt = (AdamOptimizer if name == "adam" else SGDOptimizer)(**kw)
    table = {k: ParallelConfig.from_json(v)
             for k, v in case.get("table", {}).items()}
    store = StrategyStore(launch.world_size(), table)
    ex = make_executor(ff, store, config=ff.config, optimizer=opt,
                       device=case.get("device", "cpu"),
                       microbatches=case.get("microbatches", 1),
                       schedule=case.get("schedule", "1f1b"),
                       chunk=case.get("chunk", 1),
                       compiled=case.get("compiled", False),
                       accum_steps=case.get("accum_steps", 1))
    return ff, ex


def run_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """One case on this rank (module docstring)."""
    if case.get("app"):
        return _app_case(case)
    if case.get("chaos"):
        from flexflow_torch.runtime import chaos

        ok, detail = chaos.pipeline_nan_rank(case["chaos"],
                                             case.get("device", "cpu"))
        return {"ok": ok, "detail": detail}
    undo = planted(case.get("fault"))
    try:
        return _run(case)
    finally:
        undo()


class _Warnings(logging.Handler):
    """The ``ff.pipeline`` warnings while open (``make_executor``'s
    fallback among them)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("ff.pipeline").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("ff.pipeline").removeHandler(self)


def _run(case: Dict[str, Any]) -> Dict[str, Any]:
    from flexflow_torch.runtime.checkpoint import CheckpointManager
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import relay_safe_steps
    from flexflow_torch.weights import pipeline_params_from_numpy

    with _Warnings() as warned:
        ff, ex = build(case)
    params, opt_state, state = ex.init(case.get("seed"))
    dev = ex.device
    if case.get("params") is not None:
        params = pipeline_params_from_numpy(case["params"], ex, dev)
        opt_state = {si: ex.optimizer.init(params[si]) for si in ex.mine}
    out: Dict[str, Any] = {"jax_imported": "jax" in sys.modules,
                           "stages": [list(st.device_ids)
                                      for st in ex.stages],
                           "mine": list(ex.mine),
                           "sparse": {si: [op.name for op in
                                           ex.stage_ex[si]._sparse_ops]
                                      for si in ex.mine},
                           "warnings": warned.messages,
                           "chunk": getattr(ex, "chunk", None),
                           "fused": getattr(ex, "superstep_fused", None)}
    if case.get("restore"):
        with CheckpointManager(case["restore"]) as ck:
            ck.layout = ex.snapshot_layout()
            out["restored_step"], params, opt_state, state = ck.restore(
                (params, opt_state, state))
    losses, metrics = [], []
    batches = list(case.get("batches", []))
    k = case.get("superstep")
    while batches:
        if k:
            group, batches = batches[:k], batches[k:]
            n = relay_safe_steps(len(group))
            params, opt_state, state, ms = ex.build_superstep(n)(
                params, opt_state, state, ex.stack_steps(group))
            ex.note_fused_dispatch(n)
            rows = [Executor.metrics_row(ms, j) for j in range(n)]
        else:
            params, opt_state, state, m = ex.train_step(
                params, opt_state, state, batches.pop(0))
            rows = [m]
        for m in rows:
            losses.append(float(m["train_loss"]))
            metrics.append({name: float(v) for name, v in m.items()})
    out["losses"] = losses
    out["metrics"] = metrics
    out["schedule"] = list(ex.last_schedule)
    out["sends"] = getattr(ex, "last_sends", None)
    out["compiled"] = getattr(ex, "compiled", False)
    if case.get("snapshot"):
        with CheckpointManager(case["snapshot"]) as ck:
            ck.layout = ex.snapshot_layout()
            ck.save(len(losses), params, opt_state, state)
    out["params"] = _numpy(ex.gather_full(params))
    if case.get("refusals"):
        out["refusals"] = _refusals(ex)
    if case.get("eval") is not None:
        loss, mets = ex.eval_step(params, state, case["eval"])
        out["eval"] = {"loss": float(loss),
                       **{k: float(v) for k, v in mets.items()}}
    return out


def _refusals(ex) -> Dict[str, str]:
    """The trainer's refusals on a pipeline, JAX's words: an
    ``accum_steps`` the executor did not lower, and accumulation in the
    pipeline superstep loop."""
    from flexflow_torch.runtime.trainer import Trainer

    out = {}
    for name, call in (
            ("accum", lambda: Trainer(ex).fit(1, accum_steps=2)),
            ("superstep_accum", lambda: Trainer(ex)._fit_superstep_pipeline(
                1, 0, 0, None, 0, 2, 2))):
        try:
            call()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def _app_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """An app's ``main`` on ``case["argv"]`` inside this rank (the world
    is the app's ``-ll:gpu``)."""
    import contextlib
    import importlib
    import io

    undo = planted(case.get("fault"))
    stats: Dict[str, Any] = {}
    report = io.StringIO()
    try:
        mod = importlib.import_module(f"flexflow_torch.apps.{case['app']}")
        try:
            with contextlib.redirect_stdout(report):
                code = mod.main(list(case["argv"]),
                                device=case.get("device", "cpu"),
                                stats_out=stats)
        except SystemExit as e:
            code = e.code
    finally:
        undo()
    out = {"code": code, "losses": stats.get("step_losses", []),
           "report": report.getvalue(), "telemetry": stats.get("telemetry"),
           "jax_imported": "jax" in sys.modules}
    ex = stats.get("executor")
    if ex is not None and stats.get("final") is not None:
        out["kind"] = type(ex).__name__
        out["params"] = _numpy(ex.gather_full(stats["final"][0]))
        out["schedule"] = list(getattr(ex, "last_schedule", []))
    return out


def world_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every case in turn on this rank of the world."""
    return [run_case(c) for c in cases]


class _DrawOnce:
    """``runtime/pipeline.py``'s host draw memoised in this process, by
    the model's parameter shapes and the seed, while the context is open:
    the runs of one model start from one draw (a drawn tree is never
    trained in place)."""

    def __init__(self):
        self.seen: Dict[Any, Any] = {}

    def __enter__(self):
        from flexflow_torch.runtime import pipeline

        self.real = real = pipeline.draw_params_and_state

        def draw(model, config, seed=None):
            key = (config.seed if seed is None else seed, tuple(
                (op.name, tuple(sorted((k, tuple(v.shape), str(v.dtype))
                                       for k, v in op.param_specs().items())))
                for op in model.layers))
            if key not in self.seen:
                self.seen[key] = real(model, config, seed)
            return self.seen[key]

        pipeline.draw_params_and_state = draw
        return self

    def __exit__(self, *exc):
        from flexflow_torch.runtime import pipeline

        pipeline.draw_params_and_state = self.real


def chip_apps(runs: List[Dict[str, Any]], refs: Dict[str, str],
              device: str = "cuda") -> List[Dict[str, Any]]:
    """Rank body of chip_smoke's phase 32: per run, ``argv`` through the
    app ``app`` (``alexnet`` or ``nmt``) with ``-ll:gpu`` the world's
    size, every kernel counter zeroed first, ``fault`` (a key of
    :data:`FAULTS`) planted.  Returns per run the exit code, losses,
    launch counts, the stages and this rank's, ms a step (the app's),
    whether the executor took the compiled step and its supersteps were
    CUDA graphs, and on rank 0 the digest of the trained parameters
    gathered whole and their distance from ``refs[run["ref"]]`` (a file
    of ``{"trained", "change"}``); ``timed`` runs one more step with each
    hand-off synchronised alone: its wall and the hand-offs' share.
    ``replay`` (``{"every": {kernel: launches a step}, "last_stage":
    {...}}``, the latter added on the last stage's ranks): where the
    compiled superstep is a CUDA graph, a fresh ``--steps-per-call``
    graph on the trained tensors, its launches at capture and by kernel
    name in a profiled replay (``chip_smoke._replay_counts``).  A run
    with ``chaos`` instead runs ``runtime/chaos.py``'s
    ``pipeline_superstep_nan`` on the world (``{ok, detail, s}``).
    cuDNN takes deterministic algorithms only (its timed plans may pick
    atomic ones otherwise, and two schedules are compared bit for bit),
    and the runs of one model share one host draw of its parameters
    (:class:`_DrawOnce`).  ``device="cpu"`` rehearses it on CPU ranks."""
    import contextlib
    import importlib
    import io
    import time

    import torch.distributed as dist

    import chip_smoke as cs
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.parallel import launch
    from flexflow_torch.runtime.trainer import relay_safe_steps
    from flexflow_torch.tools.mesh_smoke import _distance, digest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = []
    draws = _DrawOnce()
    for run in runs:
        if run.get("chaos"):
            import shutil
            import tempfile

            from flexflow_torch.runtime import chaos

            root = tempfile.mkdtemp(prefix="ff_pipe_chaos_") \
                if launch.rank() == 0 else None
            box = [root]
            dist.broadcast_object_list(box, src=0)
            sync()
            t0 = time.perf_counter()
            ok, detail = chaos.pipeline_nan_rank(box[0], device)
            sync()
            dist.barrier()
            if root is not None:
                shutil.rmtree(root, ignore_errors=True)
            out.append(dict(name=run["name"], ok=ok, detail=detail,
                            s=time.perf_counter() - t0,
                            backend=dist.get_backend(),
                            jax_imported="jax" in sys.modules))
            continue
        app = importlib.import_module(f"flexflow_torch.apps.{run['app']}")
        args = list(run["argv"]) + ["-ll:gpu", str(launch.world_size())]
        stats: Dict[str, Any] = {}
        report = io.StringIO()
        undo = planted(run.get("fault"))
        sync()
        cs._zero_counts()
        try:
            with contextlib.redirect_stdout(report), draws:
                code = app.main(args, device=device, stats_out=stats)
            sync()
            counts = {k: v for k, v in cs._counts().items() if v}
            ex = stats.pop("executor")
            params, opt_state, state = stats.pop("final")
            full = ex.gather_full(params)
            result = dict(
                name=run["name"], code=code, losses=stats["step_losses"],
                counts=counts, kind=type(ex).__name__,
                compiled=ex.compiled,
                graphed=bool(stats.get("superstep_graph")),
                stages=[list(st.device_ids) for st in ex.stages],
                mine=list(ex.mine), schedule_len=len(ex.last_schedule),
                ms_step=stats["elapsed_s"] * 1e3 / stats["iterations"],
                backend=dist.get_backend(), rank=dist.get_rank(),
                jax_imported="jax" in sys.modules)
            if full:
                result["digest"] = digest(full)
                if run.get("ref"):
                    ref = torch.load(refs[run["ref"]], map_location="cpu")
                    result["distance"] = _distance(full, ref)
                    del ref
            del full
            if run.get("replay") and ex.superstep_graph:
                k = relay_safe_steps(stats["steps_per_call"])
                per_step = dict(run["replay"]["every"])
                if launch.rank() in ex.stages[-1].device_ids:
                    per_step.update(run["replay"]["last_stage"])
                host = synthetic_host_batch(ex.model,
                                            np.random.default_rng(0))
                busy_us = cs._replay_counts(
                    torch, f"mesh-pipeline {run['name']} rank "
                    f"{launch.rank()}", ex.build_superstep(k),
                    (params, opt_state, state), ex.stack_steps([host] * k),
                    per_step)
                result.update(replay_per_step=per_step, replay_k=k,
                              replay_busy_ms=busy_us / 1e3)
            if run.get("timed"):
                batch = ex.shard_batch(synthetic_host_batch(
                    ex.model, np.random.default_rng(0)))
                dist.barrier()
                sync()
                ex.handoff_s, ex.timed = 0.0, True
                t0 = time.perf_counter()
                _, _, _, m = ex.train_step(params, opt_state, state, batch)
                float(m["train_loss"])
                sync()
                result.update(one_step_ms=(time.perf_counter() - t0) * 1e3,
                              handoff_ms=ex.handoff_s * 1e3)
                ex.timed = False
        finally:
            undo()
        del ex, params, opt_state, state, stats
        if cuda:
            torch.cuda.empty_cache()
        out.append(result)
    return out
