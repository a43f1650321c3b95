"""Rank bodies of the training machinery's worlds: checkpoints across
strategies and numbers of ranks, the resilient trainer's agreements, and
JAX's chaos matrix on a world.

``world_cases(spec)`` runs, on each rank of one world, the training cases
of ``mesh_smoke.run_cases`` (accumulated steps, ``--remat``,
supersteps), then the snapshot cases of :func:`snapshot_cases`, then
:func:`sigterm_case`; the CPU tests and ``chip_smoke.py``'s phase 31 hold
what it returns.  ``chaos_world(root, names, k, device, params)`` runs the
training scenarios of ``runtime/chaos.py`` on this rank of the world.

Snapshots are compared by digest (``snapshot_digest``: a sha256 of each
whole tensor's bytes), so a rank returns no tensor: a restored snapshot
gathered whole again must give the digests of the file it was restored
from, bit for bit.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def snapshot_digest(flat: Dict[str, Dict[str, torch.Tensor]]
                    ) -> Dict[str, str]:
    """``{item/path: sha256 of the tensor's bytes}`` of ``{item: {path:
    whole tensor}}``."""
    out = {}
    for item, group in flat.items():
        for path, t in group.items():
            raw = t.detach().reshape(-1).cpu().view(torch.uint8).numpy()
            out[f"{item}/{path}"] = hashlib.sha256(raw.tobytes()).hexdigest()
    return out


def file_digest(directory: str, step: Optional[int] = None
                ) -> Dict[str, str]:
    """The digests of a snapshot on disk (its latest step by default)."""
    from flexflow_torch.runtime.checkpoint import ITEMS, CheckpointManager

    ck = CheckpointManager(directory, read_only=True)
    step = ck.latest_step() if step is None else step
    loaded = {item: ck._load(step, item) for item in ITEMS}
    return snapshot_digest({k: v for k, v in loaded.items() if v is not None})


def _trained(case: Dict[str, Any]):
    """The case's executor after one step from its given parameters:
    ``(ex, params, opt_state, state)``."""
    from flexflow_torch.tools import mesh_smoke
    from flexflow_torch.weights import params_from_numpy

    _, ex = mesh_smoke.executor_for(case)
    params, opt_state, state = ex.init()
    w = ex.world
    params = params_from_numpy(case["params"], ex.device,
                               specs=ex.param_specs(),
                               plan=ex.plan if w else None,
                               rank=w.rank if w else 0)
    opt_state = ex.optimizer.init(
        ex._zero_views(params) if w is not None and
        ex.config.zero_sharded_optimizer else params)
    for batch in case["batches"]:
        params, opt_state, state, _ = ex.train_step(
            params, opt_state, state, ex.shard_batch(batch))
    return ex, params, opt_state, state


def _whole_digest(ck, trees) -> Dict[str, str]:
    """The digests of ``trees`` (``(params, opt_state, state)``, the
    rank's blocks) gathered whole as a save gathers them."""
    return snapshot_digest(ck._whole(*trees))


def snapshot_cases(root: str, writers: List[Dict[str, Any]],
                   readers: List[Dict[str, Any]],
                   others: Dict[str, str]) -> Dict[str, Any]:
    """Each writer case (a ``mesh_smoke`` case with a ``name``) trains one
    step and saves it under ``root/<name>``; then every snapshot (the
    writers' and ``others``, ``{name: directory}`` written elsewhere) is
    restored under every reader case and gathered whole again.  Returns
    ``{"saved": {writer: digest of what it gathered}, "restored":
    {"<snapshot>><reader>": digest}, "local_shapes": {reader: lm_head's
    moment block}, "root": root}``."""
    from flexflow_torch.runtime.checkpoint import CheckpointManager

    out: Dict[str, Any] = {"root": root, "saved": {}, "restored": {},
                           "local_shapes": {}}
    dirs = dict(others)
    for case in writers:
        d = os.path.join(root, case["name"])
        ex, params, opt_state, state = _trained(case)
        with CheckpointManager(d) as ck:
            ck.layout = ex.snapshot_layout()
            ck.save(1, params, opt_state, state)
            out["saved"][case["name"]] = _whole_digest(
                ck, (params, opt_state, state))
        dirs[case["name"]] = d
    for case in readers:
        from flexflow_torch.tools import mesh_smoke

        _, ex = mesh_smoke.executor_for(case)
        templates = ex.init()
        m = templates[1]["m"]["lm_head"]["kernel"]
        out["local_shapes"][case["name"]] = tuple(m.shape)
        for snap, d in dirs.items():
            with CheckpointManager(d, read_only=True) as ck:
                ck.layout = ex.snapshot_layout()
                _, p, o, s = ck.restore(templates=templates)
                out["restored"][f"{snap}>{case['name']}"] = _whole_digest(
                    ck, (p, o, s))
    return out


def sigterm_case(root: str, k: int, device: str = "cpu",
                 rank: int = 1) -> Dict[str, Any]:
    """The chaos model on this world (``chaos.chaos_table``): SIGTERM to
    ``rank`` alone before step 5, then a second fit on the same
    directory; returns both fits' steps and the joined trajectory beside
    the unfaulted one."""
    from flexflow_torch.parallel import launch
    from flexflow_torch.runtime import chaos
    from flexflow_torch.runtime.resilience import FaultInjector

    d = os.path.join(root, f"sigterm_k{k}")
    inj = FaultInjector(preempt_at=(5,)) if launch.rank() == rank else None
    first = chaos.fit_once(d, inj, k=k, device=device)
    second = chaos.fit_once(d, k=k, device=device)
    base = chaos.baseline(root, k=k, device=device)
    got = chaos.trajectory({**first["losses"], **second["losses"]},
                           chaos.ITERS)
    return dict(first_step=first["step"], preempted=first["preempted"],
                second_step=second["step"],
                second_preempted=second["preempted"],
                equal=bool(np.array_equal(got, base)),
                trajectory=got.tolist())


def world_cases(spec: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's part of one world: ``spec["cases"]`` (named
    ``mesh_smoke`` cases), the snapshots of ``spec["snapshots"]`` (the
    arguments of :func:`snapshot_cases`) and, with ``spec["sigterm"]``
    (``{"root", "k"}``), :func:`sigterm_case`."""
    from flexflow_torch.tools import mesh_smoke

    out: Dict[str, Any] = {}
    for case in spec.get("cases", []):
        out[case["name"]] = mesh_smoke.train_case(case)
    if spec.get("snapshots"):
        out["snapshots"] = snapshot_cases(**spec["snapshots"])
    if spec.get("sigterm"):
        out["sigterm"] = sigterm_case(**spec["sigterm"])
    return out


def chaos_world(root: str, names: List[str], k: int, device: str = "cpu",
                params=None) -> Dict[str, Any]:
    """The training scenarios ``names`` of ``runtime/chaos.py`` on this
    rank (every rank runs each scenario together, the directory shared;
    ``force_save_kill``, which acts on the directory alone, on rank 0
    only), with ``params`` (a full numpy tree) as the chaos model's
    initial weights when given.  Returns ``{name: (ok, detail)}`` and
    the unfaulted trajectory under ``"baseline"``."""
    from flexflow_torch.parallel import launch
    from flexflow_torch.runtime import chaos
    from flexflow_torch.weights import params_from_numpy

    if params is not None:
        made = chaos.tiny_factory

        def tiny_factory(dev="cuda"):
            build = made(dev)

            def make():
                ex = build()
                w = ex.world

                def init(seed=None):
                    return params_from_numpy(
                        params, ex.device, specs=ex.param_specs(),
                        plan=ex.plan if w else None,
                        rank=w.rank if w else 0), None, {}

                ex.init = init
                return ex

            return make

        chaos.tiny_factory = tiny_factory
    out: Dict[str, Any] = {}
    try:
        for name in names:
            if name == "force_save_kill" and launch.rank() != 0:
                continue
            fn = chaos.SCENARIOS[name]
            try:
                out[name] = fn(os.path.join(root, name), device=device, k=k)
            except Exception as e:  # a crashed scenario fails, with why
                out[name] = (False, f"{name}: crashed with "
                                    f"{type(e).__name__}: {e}")
        out["baseline"] = chaos.baseline(root, k=k, device=device).tolist()
    finally:
        if params is not None:
            chaos.tiny_factory = made
    return out


# -- chip_smoke.py's phase 31 --------------------------------------------------


def _fault_at(step: Optional[int]):
    """Have every ``ResilientTrainer`` built from here on raise a
    recoverable fault before ``step`` (None: no fault); returns the
    undo."""
    from flexflow_torch.runtime import resilience

    real = resilience.ResilientTrainer.__init__
    if step is None:
        return lambda: None

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.fault_injector = resilience.FaultInjector(raise_at=(step,))

    resilience.ResilientTrainer.__init__ = init
    return lambda: setattr(resilience.ResilientTrainer, "__init__", real)


def chip_world(runs: List[Dict[str, Any]], ref_path: str,
               device: str = "cuda") -> List[Dict[str, Any]]:
    """Rank body of ``chip_smoke.py``'s phase 31 app arms: per run,
    ``apps.transformer.main(run["argv"] + ["-ll:gpu", world size])`` on
    this rank, every kernel counter zeroed first, with a raised fault
    before step ``run["fault"]`` when it names one.  Returns per run the
    exit code, losses, restarts, launch counts, the shapes the attention
    dispatcher and K3 ran at, whether supersteps were CUDA graphs, the
    digest of the trained parameters gathered whole and, with
    ``ref_path`` (``{"init", "trained"}`` full tensors of one rank), their
    distance from its trained ones over its own change."""
    import contextlib
    import io

    import torch.distributed as dist

    import chip_smoke as cs
    from flexflow_torch.apps import transformer
    from flexflow_torch.parallel import launch
    from flexflow_torch.tools import mesh_smoke

    ref = torch.load(ref_path, map_location=device) if ref_path else None
    if ref is not None:
        ref["change"] = sum(float((ref["trained"][op][k] - v).square().sum())
                            for op, g in ref["init"].items()
                            for k, v in g.items())
    out = []
    for run in runs:
        shapes: Dict[str, list] = {}
        stats: Dict[str, Any] = {}
        undo = mesh_smoke._recording(shapes)
        unfault = _fault_at(run.get("fault"))
        cs._zero_counts()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                code = transformer.main(
                    list(run["argv"]) + ["-ll:gpu",
                                         str(launch.world_size())],
                    device=device, stats_out=stats)
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            unfault()
            undo()
        counts = {k: v for k, v in cs._counts().items() if v}
        ex = stats.pop("executor")
        params = stats.pop("final")[0]
        full = ex.gather_full(params)
        res = dict(name=run["name"], code=code,
                   losses=list(stats["step_losses"]),
                   restarts=stats.get("restarts", 0), counts=counts,
                   shapes={k: sorted(set(v)) for k, v in shapes.items()},
                   graph=stats.get("superstep_graph"),
                   digest=mesh_smoke.digest(full),
                   backend=dist.get_backend(),
                   jax_imported="jax" in __import__("sys").modules)
        if ref is not None and run.get("distance"):
            res["distance"] = mesh_smoke._distance(full, ref)
        del ex, params, full, stats
        if device == "cuda":
            torch.cuda.empty_cache()
        out.append(res)
    return out


def chip_graphs(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Rank body of phase 31's NCCL arms, a card a rank: (a) the LM of
    ``spec["lm"]`` under ``transformer_strategy(world, dp, tp)``: two
    eager fits and one of k-step supersteps, bit for bit, the graph's
    launches counted at capture and by kernel name in a profiled replay
    (``chip_smoke._replay_counts``), ms a step eagerly and as a graph, a
    snapshot gathered and saved, then restored, timed; (b) the DLRM of
    ``spec["dlrm"]`` under ``dlrm_strategy(world)`` likewise; (c) the
    chaos scenarios ``spec["chaos"]`` at k = 8 (``chaos_world``).  With
    ``spec["device"] == "cpu"`` (a rehearsal) the supersteps are loops
    and nothing is captured, counted or profiled."""
    import time

    import chip_smoke as cs
    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.config import FFConfig
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.dlrm import DLRMConfig, dlrm_strategy
    from flexflow_torch.models.transformer import (
        build_transformer_lm,
        transformer_strategy,
    )
    from flexflow_torch.parallel import launch
    from flexflow_torch.runtime.checkpoint import CheckpointManager
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer, relay_safe_steps
    from flexflow_torch.tools import mesh_smoke

    n = launch.world_size()
    device = spec.get("device", "cuda")
    cuda = device == "cuda"
    out: Dict[str, Any] = {}

    def graphs(tag, make, per_step, k, iters, eager_warmup=2):
        k = relay_safe_steps(k)
        steps = k + iters
        eager = [cs._fit_quiet(Trainer(make()), iterations=steps
                               - eager_warmup, warmup=eager_warmup)
                 for _ in range(2)]
        cs._same_run(torch, f"{tag}, two eager runs", *eager)
        ex = make()
        cs._zero_counts()
        graph = cs._fit_quiet(Trainer(ex), iterations=iters, warmup=k,
                              steps_per_call=k)
        counts = cs._counts()
        cs._check(graph[0]["superstep_graph"] is cuda,
                  f"{tag}: the superstep is not a CUDA graph under NCCL")
        cs._same_run(torch, f"{tag}, superstep k={k} vs eager", graph,
                     eager[0])
        busy = 0.0
        if cuda:
            want = {name: 2 * k * per_step.get(name, 0) for name in counts}
            cs._check(counts == want, f"{tag}: launches {counts}, "
                      f"expected {want}")
            host = synthetic_host_batch(ex.model, np.random.default_rng(0))
            fn = ex.build_superstep(k)
            busy = cs._replay_counts(torch, tag, fn, graph[1],
                                     ex.stack_steps([host] * k), per_step)
        res = dict(counts=counts, replay_busy_ms=busy / 1e3,
                   eager_ms=eager[0][0]["elapsed_s"] * 1e3
                   / eager[0][0]["iterations"],
                   graph_ms=graph[0]["elapsed_s"] * 1e3
                   / graph[0]["iterations"], losses=graph[0]["step_losses"])
        return ex, graph[1], res

    # -- (a) the LM --
    c = spec["lm"]

    def lm():
        cfg = FFConfig(batch_size=c["batch"], compute_dtype="bfloat16",
                       optimizer="adam", learning_rate=c["lr"],
                       seed=c["seed"])
        ff = build_transformer_lm(
            batch_size=c["batch"], seq_len=c["seq"], vocab_size=c["vocab"],
            d_model=c["d_model"], num_heads=c["heads"],
            num_layers=c["layers"], config=cfg)
        return Executor(ff, cfg, optimizer=make_optimizer(cfg), device=device,
                        strategy=transformer_strategy(n, c["layers"],
                                                      dp=c["dp"], tp=c["tp"]))

    L = c["layers"]
    ex, trees, out["lm"] = graphs(
        "mesh-train lm", lm, {"flash_attention_lse": L,
                              "flash_attention_lse_bwd": L,
                              "softmax_xent": 1, "softmax_xent_bwd": 1},
        c["k"], c["iters"])
    d = os.path.join(spec["root"], "lm")
    with CheckpointManager(d) as ck:
        ck.layout = ex.snapshot_layout()
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        ck.save(1, *trees)
        save_s = time.perf_counter() - t0
        templates = ex.init()
        t0 = time.perf_counter()
        ck.restore(templates=templates)
        sync()
        restore_s = time.perf_counter() - t0
        out["lm"].update(save_s=save_s, restore_s=restore_s, snapshot=d,
                         digest=mesh_smoke.digest(ex.gather_full(trees[0])))
        cs._check(snapshot_digest(ck._whole(*templates))
                  == snapshot_digest(ck._whole(*trees)),
                  "mesh-train lm: the restored snapshot differs from the "
                  "saved state")
    del ex, trees, templates

    # -- (b) the DLRM, its row-sparse step, tables split over the world --
    c = spec["dlrm"]
    with mesh_smoke._InitOnce():
        def dlrm():
            ff, cfg = cs._dlrm_model(c["batch"], c["vocab"], "bfloat16",
                                     c["seed"], c, optimizer="sgd",
                                     learning_rate=c["lr"], momentum=0.0,
                                     weight_decay=0.0)
            table = DLRMConfig(sparse_feature_size=c["dim"],
                               embedding_size=[c["vocab"]] * c["tables"])
            ex = Executor(ff, cfg, optimizer=make_optimizer(cfg),
                          device=device, strategy=dlrm_strategy(n, table))
            cs._check(bool(ex._sparse_ops), "mesh-train: the DLRM is not "
                      "on the row-sparse path")
            return ex

        ex, trees, out["dlrm"] = graphs(
            "mesh-train dlrm", dlrm, {"gather_rows": 1,
                                      "scatter_add_rows": 1},
            c["k"], c["iters"])
        out["dlrm"]["table_block"] = tuple(
            trees[0]["embeddings"]["tables"].shape)
        del ex, trees

    # -- (c) the chaos scenarios, k = 8 graphs --
    t0 = time.perf_counter()
    out["chaos"] = chaos_world(os.path.join(spec["root"], "chaos"),
                               spec["chaos"], 8, device)
    out["chaos_s"] = time.perf_counter() - t0
    return out
