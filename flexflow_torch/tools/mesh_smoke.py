"""Training runs across a world of ranks, for the mesh's checks.

``run_cases(cases)`` is a rank's body (``parallel/launch.py``): each case
builds a small model (``MODELS``), places it by a strategy table, loads
given full parameters (numpy, cut to the rank's blocks), trains a few
steps on given numpy batches and returns the losses and the full
parameters and optimizer moments, reassembled on every rank.  The CPU
tests hold these against the JAX package's runs of the same tables;
``chip_smoke.py`` runs them on CUDA tensors.  A case is a dict:

- ``model`` (a key of ``MODELS``) and ``model_kw``;
- ``table``: ``{op: ParallelConfig JSON}`` (missing ops data-parallel);
- ``optimizer``: ``("sgd" | "adam", kwargs)``; ``config``: FFConfig
  fields (``zero_sharded_optimizer``, ``clip_norm``, ...);
- ``params`` (full numpy tree, or None for the executor's own init),
  ``state`` (likewise), ``batches`` (a list of numpy dicts, one a step);
- ``device`` (``"cpu"`` or ``"cuda"``), ``dropout_masks`` (also return
  each Dropout output's global zero pattern from one training forward),
  ``record_shapes`` (also return the shapes the attention dispatcher and
  K3's wrapper were called with on this rank).

``dlrm_app(configs, argv)`` is the rank body of the DLRM's worlds (the
CPU tests' and ``chip_smoke.py``'s phase 28): ``apps.dlrm.main`` with
``-ll:gpu`` the world's size under each configuration in turn, every run
from one draw of the initial parameters (the seed's, or given ones),
returning its losses, launch counts, local table shape, ms a step, the
collective share, peak memory, whether only the batch's rows moved, and
the batch's rows of the rank's table block (the parent holds tables
against each other through them).

``chip_app(configs, argv, ref_path)`` is the rank body of
``chip_smoke.py``'s phase 27: the full-width bf16 LM through
``apps.transformer.main`` under each configuration in turn, with its
losses, report, launch counts, the shapes the kernels ran at (each held
against its plain version on the rank), its parameters against a
reference run's, ms a step and the share of a step spent in collectives.

``serve_cases(model_kw, params, cases, device)`` is the rank body of the
sharded serving worlds (the CPU tests' and ``chip_smoke.py``'s phase
29): per case a ``ServingExecutor(shard=(n, c))`` on this rank, its
requests through the plain ``Server``, a ``ScheduledServer`` or a
2-replica ``FleetRouter``, with ``SERVE_FAULTS`` planted on rank 1;
returns the tokens, errors, stats and decisions, the decode logits of a
teacher-forced request, the launch counts, the shapes K1f's dispatcher
and K6 ran at, ms a superstep, the collective share and peak memory.

``python -m flexflow_torch.tools.mesh_smoke --gloo-probe`` prints which
collectives and dtypes gloo runs on CUDA tensors on this machine.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch


def small_cnn(batch: int = 8, dtype=torch.float32):
    """``tests/test_sharding_equivalence.py``'s model: conv 3x3 (8) ->
    pool 2x2 -> flat -> fc 16 (relu) -> fc 4 -> softmax, on 8x8x4
    images."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch, seed=7))
    x = ff.create_tensor((batch, 8, 8, 4), dtype=dtype, name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="lbl")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 16, activation="relu", name="fc1")
    t = ff.dense(t, 4, activation=None, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


def norm_cnn(batch: int = 8):
    """A conv with BatchNorm and a Dropout before the head: the ops whose
    training forward reads the whole batch (statistics) or a key (the
    mask)."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch, seed=3))
    x = ff.create_tensor((batch, 8, 8, 4), name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="lbl")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.flat(t, name="flat")
    t = ff.dropout(t, 0.5, name="drop")
    t = ff.dense(t, 4, name="fc")
    ff.softmax(t, lbl, name="softmax")
    return ff


def lm(**kw):
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm

    return build_transformer_lm(config=FFConfig(batch_size=kw["batch_size"],
                                                seed=0), **kw)


def emb_model(batch: int = 8, vocab: int = 64):
    """``tests/test_sharding_equivalence.py``'s sharded-embedding model:
    a (batch, 4) bag of ids into a ``shard_rows`` table (vocab 64, dim 8),
    summed, then fc 16 (relu) -> fc 4 -> softmax."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch, seed=7, shard_embeddings=True))
    ids = ff.create_tensor((batch, 4), dtype=torch.int32, name="ids")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="lbl")
    t = ff.embedding(ids, vocab, 8, aggr="sum", name="emb")
    t = ff.dense(t, 16, activation="relu", name="fc1")
    t = ff.dense(t, 4, activation=None, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    return ff


#: The tables of ``table_model``: its ids' width and the call that adds the op.
TABLES = {
    "multi": (4, lambda ff, ids: ff.multi_embedding(ids, 4, 16, 8,
                                                    name="emb")),
    # 17 rows padded to 20 (c = 2, 4 divide them) or to 18 (c = 4 does
    # not: the table runs replicated).
    "hetero": (3, lambda ff, ids: ff.hetero_embedding(ids, (5, 9, 3), 8,
                                                      pad_to=4, name="emb")),
    "hetero18": (3, lambda ff, ids: ff.hetero_embedding(
        ids, (5, 9, 3), 8, pad_to=2, name="emb")),
    "word": (4, lambda ff, ids: ff.word_embedding(ids, 64, 8, name="emb",
                                                  shard_rows=True)),
}


def table_model(kind: str, batch: int = 8):
    """A table of ``TABLES[kind]`` over (batch, k) ids, its rows flattened
    into fc 4 -> softmax."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    k, build = TABLES[kind]
    ff = FFModel(FFConfig(batch_size=batch, seed=5))
    ids = ff.create_tensor((batch, k), dtype=torch.int32, name="ids")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="lbl")
    t = build(ff, ids)
    t = ff.reshape(t, (batch, k * 8), name="rows")
    t = ff.dense(t, 4, activation=None, name="fc")
    ff.softmax(t, lbl, name="softmax")
    return ff


MODELS = {"small_cnn": small_cnn, "norm_cnn": norm_cnn, "lm": lm,
          "emb": emb_model, "table": table_model}


def _skip_all_reduce(real):
    """The planted fault ``no_all_reduce``: the sharded gather keeps its
    own window's rows instead of the all-reduce over the ``c`` axes (the
    collective still runs, so the other ranks do not wait on it)."""
    def gather(op, table, flat_ids):
        w = op._world
        w.all_reduce = lambda x, axes: (type(w).all_reduce(w, x, axes), x)[1]
        try:
            return real(op, table, flat_ids)
        finally:
            del w.all_reduce
    return gather


def _no_window(real):
    """The planted fault ``no_window``: the sharded scatter-add runs
    without its window (``row_start = 0``)."""
    from flexflow_torch.ops import embedding

    def scatter(op, table, flat_ids, upd):
        offset = embedding._shard_offset
        embedding._shard_offset = lambda op, shard: 0
        try:
            return real(op, table, flat_ids, upd)
        finally:
            embedding._shard_offset = offset
    return scatter


#: Planted faults of the sharded tables, by name: ``(function of
#: ops/embedding.py, wrapper)``.  Rank 1 runs the wrapped function.
FAULTS = {"no_all_reduce": ("_gather_dispatch", _skip_all_reduce),
          "no_window": ("_scatter_add_dispatch", _no_window)}


def planted(fault):
    """Install ``FAULTS[fault]`` on this rank when it is rank 1 (nothing
    for ``fault`` None); returns the undo."""
    import torch.distributed as dist

    from flexflow_torch.ops import embedding

    if fault is None or not dist.is_initialized() or dist.get_rank() != 1:
        return lambda: None
    name, wrap = FAULTS[fault]
    real = getattr(embedding, name)
    setattr(embedding, name, wrap(real))
    return lambda: setattr(embedding, name, real)


def _numpy(tree):
    return {op: {k: v.detach().float().cpu().numpy() if v.is_floating_point()
                 else v.cpu().numpy() for k, v in g.items()}
            for op, g in tree.items()}


def executor_for(case: Dict[str, Any]):
    """The case's model and executor (on this rank's world, if any)."""
    from flexflow_torch.optim import AdamOptimizer, SGDOptimizer
    from flexflow_torch.parallel import launch
    from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore
    from flexflow_torch.runtime.executor import Executor

    ff = MODELS[case["model"]](**case.get("model_kw", {}))
    for k, v in case.get("config", {}).items():
        setattr(ff.config, k, v)
    name, kw = case.get("optimizer", ("sgd", {"lr": 0.05, "momentum": 0.9}))
    opt = (AdamOptimizer if name == "adam" else SGDOptimizer)(**kw)
    table = {k: ParallelConfig.from_json(v)
             for k, v in case.get("table", {}).items()}
    store = StrategyStore(launch.world_size(), table)
    return ff, Executor(ff, optimizer=opt, device=case.get("device", "cpu"),
                        strategy=store)


def _recording(shapes: Dict[str, list],
               names=("flash_attention_lse_auto", "softmax_xent")):
    """Have the attention op's and the loss's view of ``ops.kernels``
    record the input shape of each call of the wrappers in ``names`` (by
    default the attention dispatcher and K3's wrapper; the wrappers
    themselves, and their launch counters, stay as they are); returns
    the undo."""
    from flexflow_torch.ops import attention, kernels, losses

    class _Recorder:
        def __getattr__(self, name):
            fn = getattr(kernels, name)
            if name not in names:
                return fn

            def call(x, *a, **kw):
                shapes.setdefault(name, []).append(tuple(x.shape))
                return fn(x, *a, **kw)
            return call

    for mod in (attention, losses):
        mod.kernels = _Recorder()
    return lambda: [setattr(mod, "kernels", kernels)
                    for mod in (attention, losses)]


def train_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """One case on this rank (see the module docstring)."""
    shapes: Dict[str, list] = {}
    undo = _recording(shapes) if case.get("record_shapes") else None
    try:
        out = _train(case)
    finally:
        if undo:
            undo()
    if undo:
        out["kernel_shapes"] = shapes
    return out


def _train(case: Dict[str, Any]) -> Dict[str, Any]:
    from flexflow_torch.weights import params_from_numpy, state_from_numpy

    if case.get("device") == "cuda":  # f32 held in f32: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ff, ex = executor_for(case)
    params, opt_state, state = ex.init()
    w = ex.world
    where = dict(plan=ex.plan if w else None, rank=w.rank if w else 0)
    dev = ex.device
    if case.get("params") is not None:
        params = params_from_numpy(case["params"], dev,
                                   specs=ex.param_specs(), **where)
        opt_state = ex.optimizer.init(
            ex._zero_views(params) if w is not None and
            ex.config.zero_sharded_optimizer else params)
    if case.get("state") is not None:
        state = state_from_numpy(case["state"], dev, specs=ex.param_specs(),
                                 **where)
    out: Dict[str, Any] = {"jax_imported": "jax" in sys.modules}
    if case.get("dropout_masks"):
        _, _, _, env = ex.forward(params, {k: {n: t.clone()
                                                for n, t in g.items()}
                                           for k, g in state.items()},
                                  case["batches"][0], training=True)
        masks = {}
        for op in ff.layers:
            if type(op).__name__ == "Dropout":
                y = env[op.outputs[0].name].detach()
                if w is not None:
                    from flexflow_torch.parallel import collectives
                    from flexflow_torch.parallel.mesh import replicated

                    y = collectives.reshard(y, op.output_spec(0),
                                            replicated(y.dim()), w)
                masks[op.name] = (y == 0).cpu().numpy()
        out["dropout_masks"] = masks
    losses = []
    for batch in case["batches"]:
        params, opt_state, state, m = ex.train_step(
            params, opt_state, state, ex.shard_batch(batch))
        losses.append(float(m["train_loss"]))
    out["losses"] = losses
    out["local_shapes"] = {op: {k: tuple(v.shape) for k, v in g.items()}
                           for op, g in params.items()}
    out["params"] = _numpy(ex.gather_full(params))
    if opt_state is not None and isinstance(opt_state, dict) and \
            "m" in opt_state:
        specs = ex.zero_specs()
        out["moments"] = {k: _numpy(ex.gather_full(opt_state[k], specs))
                          for k in ("m", "v")}
        out["moment_shapes"] = {op: {k: tuple(v.shape) for k, v in g.items()}
                                for op, g in opt_state["m"].items()}
    return out


def run_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every case in turn on this rank of the world."""
    return [train_case(c) for c in cases]


def digest(params) -> Dict[str, str]:
    """A sha256 of each parameter's bytes: bit-for-bit comparisons across
    processes without moving the tensors."""
    import hashlib

    out = {}
    for op, g in params.items():
        for k, v in g.items():
            raw = v.detach().contiguous().view(torch.uint8).cpu().numpy()
            out[f"{op}.{k}"] = hashlib.sha256(raw.tobytes()).hexdigest()
    return out


def chip_app(configs: List[Dict[str, Any]], argv: List[str],
             ref_path: str) -> List[Dict[str, Any]]:
    """Rank body of chip_smoke's phase 27: per configuration (``dp``,
    ``tp``, ``zero``; ``fault`` runs without the gradient all-reduce, a
    planted fault the phase's bars must catch), the command line ``argv``
    through ``apps.transformer.main`` with ``-ll:gpu`` the world's size,
    every kernel counter zeroed first.  Returns per configuration the
    app's exit code, report, losses and ms a step, the launch counts, the
    shapes the attention dispatcher and K3 were called with, the digest
    of the trained parameters gathered whole, their distance from the
    reference run's (``ref_path``: ``{"init", "trained"}`` full tensors)
    over the reference's change, the share of one more step spent in
    collectives; K1f, K1b and K3 are held against their plain versions at
    each new shape the rank launched them at (chip_smoke's rules)."""
    import contextlib
    import io
    import time

    import torch.distributed as dist

    import chip_smoke as cs
    from flexflow_torch.apps import transformer
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.ops import kernels
    from flexflow_torch.parallel import launch
    from flexflow_torch.runtime.executor import Executor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(ref_path, map_location="cuda")
    out, held = [], {}
    for c in configs:
        args = list(argv) + ["-ll:gpu", str(launch.world_size()), "--dp",
                             str(c["dp"]), "--tp", str(c["tp"])]
        if c.get("zero"):
            args.append("--zero-opt")
        shapes: Dict[str, list] = {}
        stats: Dict[str, Any] = {}
        report = io.StringIO()
        undo = _recording(shapes)
        reduce_grads = Executor._reduce_grads
        if c.get("fault"):
            Executor._reduce_grads = lambda self, grads, zero=False: grads
        cs._zero_counts()
        try:
            with contextlib.redirect_stdout(report):
                code = transformer.main(args, device="cuda", stats_out=stats)
            torch.cuda.synchronize()
        finally:
            undo()
            Executor._reduce_grads = reduce_grads
        counts = {k: v for k, v in cs._counts().items() if v}
        ex = stats.pop("executor")
        params, opt_state, state = stats.pop("final")
        full = ex.gather_full(params)
        dig, num, den = digest(full), 0.0, 0.0
        for op, g in ref["trained"].items():
            for k, want in g.items():
                num += float((full[op][k].detach().float() - want)
                             .square().sum())
                den += float((want - ref["init"][op][k]).square().sum())
        del full
        # One more step with each collective timed alone (it updates the
        # parameters in place).
        batch = ex.shard_batch(synthetic_host_batch(ex.model,
                                                    np.random.default_rng(0)))
        w = ex.world
        dist.barrier()
        torch.cuda.synchronize()
        w.comm_s, w.timed = 0.0, True
        t0 = time.perf_counter()
        _, _, _, m = ex.train_step(params, opt_state, state, batch)
        float(m["train_loss"])
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        comm_ms, w.timed = w.comm_s * 1e3, False
        moments = {k: tuple(v.shape) for k, v in
                   opt_state["m"]["lm_head"].items()}
        result = dict(
            config=c, code=code, report=report.getvalue(),
            losses=stats["step_losses"], counts=counts,
            ms_step=stats["elapsed_s"] * 1e3 / stats["iterations"],
            samples=stats["samples_per_s"] * stats["elapsed_s"],
            shapes={k: sorted(set(v)) for k, v in shapes.items()},
            digest=dig, distance=(num / den) ** 0.5,
            one_step_ms=one_ms, comm_ms=comm_ms, lm_head_moments=moments,
            backend=dist.get_backend(), device=torch.cuda.current_device(),
            jax_imported="jax" in sys.modules)
        del ex, params, opt_state, state, batch, m, stats
        torch.cuda.empty_cache()
        holds = {}
        for shape in sorted(set(shapes.get("flash_attention_lse_auto", []))):
            if ("attn", shape) not in held:
                held[("attn", shape)] = cs.mesh_attention_hold(torch, kernels,
                                                               shape)
            holds[f"K1f/K1b {shape}"] = held[("attn", shape)]
        for shape in sorted(set(shapes.get("softmax_xent", []))):
            if ("xent", shape) not in held:
                held[("xent", shape)] = cs.mesh_xent_hold(torch, kernels,
                                                          *shape)
            holds[f"K3 {shape}"] = held[("xent", shape)]
        torch.cuda.empty_cache()
        out.append(dict(result, holds=holds))
    return out


def _table_op(ff):
    """The DLRM's table op: the stacked ``embeddings`` (one vocabulary)."""
    return next(op for op in ff.layers if op.sparse_keys())


class _InitOnce:
    """``Executor.draw_params_and_state`` memoised for one world process:
    the seed's draw (made at the first call) or ``params`` (a full numpy
    tree), so every run of a world starts from the same values without
    drawing the tables again."""

    def __init__(self, params=None):
        from flexflow_torch.runtime.executor import Executor

        self.full = None if params is None else (
            {op: {k: torch.from_numpy(np.array(v)) for k, v in g.items()}
             for op, g in params.items()}, {})
        self.real = Executor.draw_params_and_state

    def __enter__(self):
        from flexflow_torch.runtime.executor import Executor

        def draw(ex, seed=None):
            if self.full is None:
                self.full = self.real(ex, seed)
            return self.full

        Executor.draw_params_and_state = draw
        return self

    def __exit__(self, *exc):
        from flexflow_torch.runtime.executor import Executor

        Executor.draw_params_and_state = self.real


def dlrm_app(configs: List[Dict[str, Any]], argv: List[str],
             device: str = "cuda", params=None) -> List[Dict[str, Any]]:
    """Rank body of the DLRM's worlds: ``apps.dlrm.main(argv + -ll:gpu N
    + config["extra"])`` under each configuration, with ``-s`` a table
    file this rank writes from ``config["table"]`` (``{op: ParallelConfig
    JSON}``; None: the app's ``dlrm_strategy``) and ``config["fault"]``
    planted on rank 1 (:data:`FAULTS`).  Every run starts from the same
    parameters (:class:`_InitOnce`).  Returns per configuration the exit
    code, the report, the losses, the launch counts, the local table
    shape, the rank's window of the flat table, the dense parameters
    whole and the rows of the window the batch names (before and after),
    whether the batch's rows and only they moved (the lazy optimizers'
    moments too), ms a step, the ms of one more step and of its
    collectives (each synchronised alone), and the peak memory."""
    import contextlib
    import io
    import json
    import os
    import tempfile
    import time

    import torch.distributed as dist

    from flexflow_torch.apps import dlrm
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.ops import embedding, probe_kernels
    from flexflow_torch.parallel import launch

    cuda = device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n = launch.world_size()
    tmp = tempfile.mkdtemp(prefix="ff_dlrm_")
    out = []
    with _InitOnce(params) as once:
        for c in configs:
            args = list(argv) + ["-ll:gpu", str(n)] + list(c.get("extra", ()))
            if c.get("table") is not None:
                path = os.path.join(tmp, f"{c['name']}.json")
                with open(path, "w") as f:
                    json.dump({"version": 1, "num_devices": n,
                               "ops": c["table"]}, f)
                args += ["-s", path]
            for fn in probe_kernels.KERNELS:
                fn.launches = 0
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            stats: Dict[str, Any] = {}
            report = io.StringIO()
            unplant = planted(c.get("fault"))
            try:
                with contextlib.redirect_stdout(report):
                    code = dlrm.main(args, device=device, stats_out=stats)
                if cuda:
                    torch.cuda.synchronize()
            finally:
                unplant()
            counts = {fn.__name__: fn.launches for fn in probe_kernels.KERNELS
                      if fn.launches}
            peak = (torch.cuda.max_memory_allocated() - held) / 1e9 \
                if cuda else None
            ex = stats.pop("executor")
            p, opt_state, state = stats.pop("final")
            op = ex._bind(_table_op(ex.model))
            key = op.sparse_keys()[0]
            table = p[op.name][key]
            flat = table.reshape(-1, table.shape[-1])
            shard = embedding._row_sharding(op, key)
            start = 0 if shard is None else embedding._shard_offset(op, shard)
            ids = synthetic_host_batch(ex.model, np.random.default_rng(0))
            batch_rows = np.unique(op.sparse_flat_ids(
                p[op.name], [torch.from_numpy(ids[t.name])
                             for t in op.inputs]).numpy())
            mine = batch_rows[(batch_rows >= start)
                              & (batch_rows < start + flat.shape[0])]
            init_flat = ex._local(op, op.param_specs()[key],
                                  once.full[0][op.name][key]).reshape(
                                      flat.shape)
            changed = (flat != init_flat).any(-1)
            named = torch.zeros_like(changed)
            named[torch.as_tensor(mine - start, device=changed.device)] = True
            moved = None
            if isinstance(opt_state, dict) and "m" in opt_state:
                m = opt_state["m"][op.name][key].reshape(flat.shape)
                moved = not bool(((m != 0).any(-1) & ~named).any())
            sel = torch.as_tensor(mine - start, device=flat.device)
            dense = _numpy(ex.gather_full({k: g for k, g in p.items()
                                           if k != op.name}))
            result = dict(
                name=c["name"], code=code, report=report.getvalue(),
                losses=stats["step_losses"], counts=counts,
                local_shape=tuple(table.shape), window=(start, flat.shape[0]),
                rows=mine.tolist(),
                trained_rows=flat[sel].detach().cpu().numpy(),
                init_rows=init_flat[sel].cpu().numpy(),
                dense=dense if dist.get_rank() == 0 else None,
                init_dense=_numpy({k: g for k, g in once.full[0].items()
                                   if k != op.name})
                if dist.get_rank() == 0 else None,
                dense_digest=digest({op: {k: torch.from_numpy(v)
                                          for k, v in g.items()}
                                     for op, g in dense.items()}),
                only_batch_rows=not bool((changed & ~named).any()),
                batch_rows_moved=bool(changed[named].all()),
                moments_only_batch=moved,
                ms_step=stats["elapsed_s"] * 1e3 / stats["iterations"],
                peak_gb=peak, backend=dist.get_backend(),
                jax_imported="jax" in sys.modules)
            del init_flat, changed, named, flat, table
            # One more step, each collective timed alone (in place).
            w = ex.world
            batch = ex.shard_batch(ids)
            dist.barrier()
            if cuda:
                torch.cuda.synchronize()
            w.comm_s, w.timed = 0.0, True
            t0 = time.perf_counter()
            _, _, _, mt = ex.train_step(p, opt_state, state, batch)
            float(mt["train_loss"])
            if cuda:
                torch.cuda.synchronize()
            result["one_step_ms"] = (time.perf_counter() - t0) * 1e3
            result["comm_ms"], w.timed = w.comm_s * 1e3, False
            out.append(result)
            del ex, p, opt_state, state, stats, batch, mt
            if cuda:
                torch.cuda.empty_cache()
    return out


def _keep_own_sum(world):
    """The planted fault ``skip_c_all_reduce``: the attention output's
    all-reduce over ``c`` runs (the other ranks do not wait on it) and
    the rank keeps its own partial product."""
    real = type(world).all_reduce
    world.all_reduce = lambda x, axes: (real(world, x, axes), x)[1]


def _reversed_gather(world):
    """The planted fault ``gather_order``: the tokens' all-gather over
    ``n`` runs and the rank concatenates the blocks in reverse order."""
    real = type(world).all_gather

    def gather(x, dim, axes):
        out = real(world, x, dim, axes)
        return torch.cat(out.chunk(world.plan.size(axes), dim)[::-1], dim)
    world.all_gather = gather


#: Planted faults of sharded serving, by name: each patches rank 1's
#: ``World`` and keeps every collective matched.
SERVE_FAULTS = {"skip_c_all_reduce": _keep_own_sum,
                "gather_order": _reversed_gather}


def _serve_requests(case):
    from flexflow_torch.runtime.serving import Request

    return [Request(id=int(r[0]), prompt=np.asarray(r[1], np.int32),
                    max_new_tokens=int(r[2]),
                    arrival_ms=float(r[3]) if len(r) > 3 else 0.0)
            for r in case["requests"]]


def _teacher_logits(ex, params, tokens, prefix: int, bucket: int,
                    steps=None):
    """Prefill ``prefix`` of ``tokens`` into slot 0, then decode K = 1
    steps (to ``max_seq``, or ``steps`` of them) feeding the true next
    tokens: the first token and each step's slot-0 logits (numpy),
    ``tests/test_serving.py``'s protocol (on the paged pool through a
    ledger's table row)."""
    S = ex.max_seq
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :prefix] = tokens[:prefix]
    rows, tok0, _ok = ex.build_prefill(bucket)(params, {}, padded,
                                               np.int32(prefix))
    bt = ()
    if ex.paged:
        led = ex.make_ledger()
        row = led.alloc(0, led.blocks_for(prefix, S))
        table = np.zeros((ex.max_batch, led.blocks_per_slot), np.int32)
        table[0] = row
        caches = ex.install_paged(ex.init_cache(), rows, row)
        bt = (table,)
    else:
        caches = ex.install(ex.init_cache(), rows, 0)
    dec = ex.build_decode_superstep(1, return_logits=True, graph=False)
    pos = np.zeros((ex.max_batch,), np.int32)
    pos[0] = prefix
    out = []
    for t in range(prefix, S if steps is None else min(S, prefix + steps)):
        tok = np.zeros((ex.max_batch,), np.int32)
        tok[0] = tokens[t]
        caches, pos_d, _t, (_n, _ok, logits) = dec(params, {}, caches, *bt,
                                                   pos, tok)
        out.append(logits[0, 0].float().cpu().numpy())
        pos = pos_d.cpu().numpy()
    return int(tok0), np.stack(out)


def serve_cases(model_kw: Dict[str, Any], params, cases: List[Dict[str, Any]],
                device: str = "cpu") -> List[Dict[str, Any]]:
    """Rank body of the sharded serving worlds.  ``model_kw``: the LM's
    ``build_transformer_lm`` arguments plus ``dtype`` and ``seed``;
    ``params``: a full numpy tree, or None for ``ServingExecutor.init``'s
    draw.  A case is a dict:

    - ``shard`` ((n, c) or None) and the executor's ``max_batch``,
      ``max_seq``, ``buckets``, ``kv_block``, ``prefix_cache``,
      ``decode_kernel`` (``ex`` a dict of them); ``model``: overrides of
      ``model_kw``; ``dtype``: the compute dtype (default
      ``model_kw``'s); ``env``: environment variables set for the case
      (``FF_DEVICE_MEM_BYTES``);
    - ``server``: ``"plain"`` (default), ``"sched"`` (the slo policy) or
      ``"fleet"`` (2 replicas, least-loaded), with ``server_kw``
      (``decode_steps``, ``speculate``, ``temperature``, ...) and
      ``nan_cache_at`` (a ``ServingFaultInjector``'s);
    - ``requests``: ``(id, prompt, max_new[, arrival_ms])`` tuples (none:
      the teacher only);
    - ``fault``: a key of :data:`SERVE_FAULTS`, planted on rank 1 before
      the teacher and the run;
    - ``teacher``: ``(tokens, prefix, bucket[, steps])``, also return the
      decode logits of :func:`_teacher_logits`;
    - ``app``: instead of all of the above, ``apps.serve.main`` on this
      argv in this rank (:func:`_serve_app_case`);
    - ``ckpt``: serve the params ``ServingExecutor.restore`` reads there;
    - ``init_digest``: also return the digest of ``ServingExecutor.init``;
    - ``timed``: synchronise each collective alone during the run and
      return the milliseconds spent in them (``comm_ms`` of the run's
      ``timed_ms``);
    - ``expect_error``: build the executor only and return the
      ``ValueError``'s message.

    Returns per case the executor's ``shard``, the tokens and errors by
    request id, the stats, the decisions and degraded rungs (scheduler
    and fleet), the launch counts and the shapes K1f's dispatcher and K6
    ran at on this rank, ms a decode superstep and the peak memory
    (CUDA)."""
    import os

    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import ServingExecutor
    from flexflow_torch.weights import params_from_numpy

    if device == "cuda":  # f32 held in f32: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kw = dict(model_kw)
    dtype0, seed = kw.pop("dtype", "float32"), kw.pop("seed", 0)
    models: Dict[tuple, Any] = {}
    weights: Dict[str, Any] = {}
    out = []
    for case in cases:
        if case.get("app") is not None:
            out.append(_serve_app_case(case, device))
            continue
        exkw = dict(case.get("ex", {}))
        B = exkw.pop("max_batch", kw["batch_size"])
        dtype = case.get("dtype", dtype0)
        mkw = dict(kw, batch_size=B, **case.get("model", {}))
        key = tuple(sorted(mkw.items())) + (dtype,)
        if key not in models:
            models[key] = build_transformer_lm(
                config=FFConfig(batch_size=B, compute_dtype=dtype), **mkw)

        def make(ff=models[key], B=B, exkw=exkw, shard=case.get("shard")):
            return ServingExecutor(ff, max_batch=B, device=device,
                                   shard=shard, **exkw)

        def weights_of(ex, dtype=dtype):
            if dtype not in weights:  # one draw (or copy) a dtype
                weights[dtype] = (ex.init(seed)[0] if params is None else
                                  params_from_numpy(params, device))
            return weights[dtype]

        saved = {k: os.environ.get(k) for k in case.get("env", {})}
        os.environ.update(case.get("env", {}))
        try:
            out.append(_serve_case(case, make, weights_of, seed, device))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _serve_case(case, make, weights_of, seed: int, device: str):
    """One case of :func:`serve_cases` on this rank."""
    import time

    import torch.distributed as dist

    from flexflow_torch.ops import probe_kernels
    from flexflow_torch.runtime.serving import Server, ServingFaultInjector
    from flexflow_torch.serving import (FleetRouter, ScheduledServer,
                                        SchedulerPolicy)

    cuda = device == "cuda"
    if case.get("expect_error"):
        try:
            make()
        except ValueError as e:
            return dict(name=case["name"], error=str(e))
        return dict(name=case["name"], error=None)
    ex = make()
    res: Dict[str, Any] = dict(name=case["name"], shard=ex.shard,
                               jax_imported="jax" in sys.modules)
    if case.get("init_digest"):
        res["init_digest"] = digest(ex.init(seed)[0])
    if case.get("ckpt"):
        _step, p, state = ex.restore(case["ckpt"])
    else:
        p, state = weights_of(ex), {}
    if case.get("fault") and ex._world is not None and dist.get_rank() == 1:
        SERVE_FAULTS[case["fault"]](ex._world)
    if case.get("teacher") is not None:
        res["teacher"] = _teacher_logits(ex, p, *case["teacher"])
    if not case["requests"]:
        return res
    skw = dict(case.get("server_kw", {}))
    inj = case.get("nan_cache_at")
    kind = case.get("server", "plain")

    def build():
        injector = ServingFaultInjector(nan_cache_at=inj) if inj else None
        if kind == "plain":
            return Server(ex, p, state, fault_injector=injector, **skw)
        if kind == "sched":
            return ScheduledServer(ex, p, state,
                                   policy=SchedulerPolicy(name="slo"),
                                   fault_injector=injector, **skw)
        return FleetRouter([ScheduledServer(
            e, p, state, policy=SchedulerPolicy(name="slo"), **skw)
            for e in (ex, make())], router="least-loaded")

    srv = build()
    shapes: Dict[str, list] = {}
    undo = _recording(shapes, ("flash_attention_lse_auto", "flash_decode"))
    for fn in probe_kernels.KERNELS:
        fn.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    w = ex._world if case.get("timed") else None
    if w is not None:
        dist.barrier()
        w.comm_s, w.timed = 0.0, True
    t0 = time.perf_counter()
    try:
        results, stats = srv.run(_serve_requests(case))
        if cuda:
            torch.cuda.synchronize()
    finally:
        undo()
        if ex._world is not None:
            ex._world.timed = False
            for name in ("all_reduce", "all_gather"):
                ex._world.__dict__.pop(name, None)
    if w is not None:
        res["timed_ms"] = (time.perf_counter() - t0) * 1e3
        res["comm_ms"] = w.comm_s * 1e3
    res["counts"] = {fn.__name__: fn.launches
                     for fn in probe_kernels.KERNELS if fn.launches}
    res["peak_gb"] = ((torch.cuda.max_memory_allocated() - held) / 1e9
                      if cuda else None)
    res["shapes"] = {k: sorted(set(v)) for k, v in shapes.items()}
    res["tokens"] = {rid: list(r.tokens) for rid, r in results.items()}
    res["errors"] = {rid: r.error for rid, r in results.items()}
    res["stats"] = {k: v for k, v in stats.items()
                    if isinstance(v, (int, float, str, bool, list,
                                      type(None)))}
    res["max_batch"] = ex.max_batch
    res["rows"] = (ex._rows.start, ex._rows.stop)  # after any rung
    if kind != "plain":
        res["decisions"] = (srv.merged_decisions() if kind == "fleet"
                            else srv.decisions)
        res["degraded"] = list(getattr(srv, "degraded_rungs", []))
    res["ms_superstep"] = (stats.get("decode_s", 0.0) * 1e3
                           / max(stats["decode_supersteps"], 1))
    return res


def _serve_app_case(case, device: str):
    """An ``app`` case of :func:`serve_cases`: ``apps.serve.main`` on the
    argv ``case["app"]`` in this rank, so the app's own code under its
    ``--shard`` runs on the world, every launch counter zeroed first.
    Returns its exit code, report, stats, tokens by request id, the
    launch counts and the shapes K1f's dispatcher and K6 ran at."""
    import contextlib
    import io

    from flexflow_torch.apps import serve
    from flexflow_torch.ops import probe_kernels

    shapes: Dict[str, list] = {}
    stats: Dict[str, Any] = {}
    report = io.StringIO()
    undo = _recording(shapes, ("flash_attention_lse_auto", "flash_decode"))
    for fn in probe_kernels.KERNELS:
        fn.launches = 0
    try:
        with contextlib.redirect_stdout(report):
            code = serve.main(list(case["app"]), device=device,
                              stats_out=stats)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        undo()
    results = stats.pop("results", {})
    return dict(name=case["name"], code=code, report=report.getvalue(),
                stats={k: v for k, v in stats.items()
                       if isinstance(v, (int, float, str, bool, list,
                                         type(None)))},
                tokens={rid: list(r.tokens) for rid, r in results.items()},
                counts={fn.__name__: fn.launches
                        for fn in probe_kernels.KERNELS if fn.launches},
                shapes={k: sorted(set(v)) for k, v in shapes.items()},
                jax_imported="jax" in sys.modules)


def fail_rank(bad_rank: int) -> None:
    """Rank ``bad_rank`` raises before a collective the others wait in:
    the world must fail, not hang (the launcher's contract)."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    t = torch.ones(4)
    dist.all_reduce(t)


def gloo_probe() -> Dict[str, str]:
    """Which collectives gloo runs on CUDA tensors here (rank body of a
    world of 2 on one card): ``{"name dtype": "ok" | error}``."""
    import torch.distributed as dist

    dev = torch.device("cuda")
    n = dist.get_world_size()
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.arange(4, dtype=dt, device=dev)

        def probe(name, fn):
            try:
                fn()
                torch.cuda.synchronize()
                res[f"{name} {str(dt)[6:]}"] = "ok"
            except Exception as e:  # the answer, recorded per collective
                res[f"{name} {str(dt)[6:]}"] = f"{type(e).__name__}: " \
                    f"{str(e).splitlines()[0][:60]}"

        probe("all_reduce", lambda: dist.all_reduce(x.clone()))
        probe("all_gather", lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x))
        probe("reduce_scatter", lambda: dist.reduce_scatter(
            torch.empty(4 // n, dtype=dt, device=dev),
            list(x.clone().chunk(n))))
        probe("all_to_all_single", lambda: dist.all_to_all_single(
            torch.empty_like(x), x))
        probe("broadcast", lambda: dist.broadcast(x.clone(), 0))
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv != ["--gloo-probe"]:
        print("usage: python -m flexflow_torch.tools.mesh_smoke --gloo-probe")
        return 2
    from flexflow_torch.parallel import launch

    res = launch.run("flexflow_torch.tools.mesh_smoke:gloo_probe", nprocs=2,
                     device="cuda", backend="gloo", timeout_s=120)[0]
    for k, v in res.items():
        print(f"{k:28s} {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
