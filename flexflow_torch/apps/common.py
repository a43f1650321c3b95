"""Shared app harness: the flag helpers, ``make_optimizer``,
``load_strategy``, ``make_batch_fn``, the world of ``-ll:gpu N``
(``world_ranks``, ``spawn_ranks``) and ``run_training`` (with ``--eval-iters``, ``--steps-per-call``,
``--accum-steps``, ``--remat``, checkpoints, ``--resilient``, run
telemetry, ``--trace`` and ``--profiling``) of
``flexflow_tpu/apps/common.py``.  ``run_training`` builds its executor
through ``runtime/pipeline.py::make_executor``: a table that places ops
on proper subsets of the ranks (``device_ids``) trains on the pipeline,
with ``--microbatches`` and ``--pipeline-schedule``."""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np

from flexflow_torch.config import FFConfig
from flexflow_torch.optim import AdamOptimizer, SGDOptimizer

COMMON_FLAGS = """\
Common flags the port reads so far:
  --dtype float32|bfloat16   --seed N
Training apps also read:
  -b/--batch-size N   -i/--iterations N   -e/--epochs N   -p/--print-freq N
  --lr F   --wd F   --optimizer sgd|adam   --momentum F   --clip-norm F
  --lr-schedule constant|cosine|step   --warmup N   --decay-steps N
  --min-lr F   --lr-gamma F (adam only)   --eval-iters N
  -ll:gpu N (N ranks, one per card, over NCCL; default one rank;
             more than are visible is refused)
  -s/--strategy FILE.json (per-op degrees; ops on proper subsets of the
                           devices, device_ids, run as pipeline stages)
  --microbatches N   --pipeline-schedule 1f1b|gpipe (layer-wise tables)
  --zero-opt (ZeRO-1: optimizer state split over the data-parallel axes)
  --granules N (the mesh's outer axes over N islands)
  --steps-per-call K (K steps as one CUDA graph, one readback per K;
                      clamped at 20)
  --accum-steps N (one update from N microbatches of the batch)
  --remat (recompute each layer's activations in the backward)
  --save-every N   --ckpt-dir PATH (checkpoints; a run on the same
                   directory resumes from its latest step)
  --resilient (failure detection, rollback and deterministic replay,
               SIGTERM emergency save)   --max-restarts N   --sync-ckpt
  --telemetry DIR (JSONL run telemetry, heartbeat, stall watchdog)
  --stall-deadline S   --stall-notify-pid PID
  --trace DIR (torch.profiler trace of the timed loop)   --profiling
  (under -ll:gpu N every rank runs them: a superstep is one CUDA graph
   a rank over NCCL; checkpoints hold whole tensors, written by rank 0
   and restored under any strategy; each rank writes its own telemetry
   run and trace file, tagged -p<rank>)
Every other flag of the JAX package's apps is refused until its slice
of the port lands (ROADMAP.md queue 1)."""

#: The FFConfig flags a training app reads that take a value.
TRAINING_FLAGS = (
    "-b", "--batch-size", "-i", "--iterations", "-e", "--epochs", "-p",
    "--print-freq", "--lr", "--learning-rate", "--wd", "--weight-decay",
    "--dtype", "--seed", "--optimizer", "--momentum", "--lr-schedule",
    "--warmup", "--decay-steps", "--min-lr", "--lr-gamma", "--clip-norm",
    "-ll:gpu", "-ll:tpu", "--eval-iters", "-s", "--strategy",
    "--steps-per-call", "--accum-steps", "--save-every", "--ckpt-dir",
    "--max-restarts", "--telemetry", "--stall-deadline",
    "--stall-notify-pid", "--trace", "--granules", "--microbatches",
    "--pipeline-schedule",
)
#: The FFConfig flags a training app reads that take no value.
TRAINING_SWITCHES = ("--remat", "--resilient", "--sync-ckpt", "--profiling",
                     "--zero-opt")

#: Flags of the JAX package's apps that name a feature still to be
#: ported, with the ROADMAP.md item that brings it.
_NOT_PORTED = {
    "-d": "datasets (ROADMAP.md queue 1, item 12)",
    "--dataset": "datasets (ROADMAP.md queue 1, item 12)",
    "--search": "the inline strategy search (ROADMAP.md queue 1, item 11)",
    "--search-iters": "the inline strategy search (ROADMAP.md queue 1, "
                      "item 11)",
    "--calibration": "the execution-config search (ROADMAP.md queue 1, "
                     "item 11)",
    "--elastic": "elastic multi-host resize (ROADMAP.md queue 1, item 13)",
    "--stream-dataset": "the streaming loader (ROADMAP.md queue 1, "
                        "item 12)",
    "--pipeline-chunk": "the chunked pipeline (ROADMAP.md queue 1, item "
                        "10b)",
    "--pipeline-compiled": "the compiled pipeline step (ROADMAP.md queue 1, "
                           "item 10b)",
}

_DTYPES = ("float32", "bfloat16")


def check_help(argv, doc: Optional[str]) -> None:
    """-h/--help: print the app's docstring plus the common flag table,
    then exit 0."""
    if "-h" in argv or "--help" in argv:
        if doc:
            print(doc.strip())
            print()
        print(COMMON_FLAGS)
        raise SystemExit(0)


def _pop(argv, flag, default, cast, what):
    """Extract an app-specific ``--flag V`` from argv."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    try:
        val = cast(argv[i + 1])
    except (IndexError, ValueError):
        raise SystemExit(f"{flag} expects {what}")
    del argv[i:i + 2]
    return val


def pop_int(argv, flag, default):
    return _pop(argv, flag, default, int, "an integer")


def pop_float(argv, flag, default):
    return _pop(argv, flag, default, float, "a number")


def pop_str(argv, flag, default):
    return _pop(argv, flag, default, str, "a value")


def parse_training_args(argv) -> FFConfig:
    """The FFConfig of a training app.  Every flag outside
    ``TRAINING_FLAGS`` and ``TRAINING_SWITCHES`` is refused (the JAX
    parser passes unknown flags through; here they would name features
    the port lacks), and so is a dtype other than f32 or bf16."""
    i = 0
    while i < len(argv):
        flag = argv[i]
        i += 2 if flag in TRAINING_FLAGS else 1
        if flag in TRAINING_FLAGS or flag in TRAINING_SWITCHES:
            continue
        if flag in _NOT_PORTED:
            raise SystemExit(f"flexflow_torch does not support {flag!r} yet: "
                             f"{_NOT_PORTED[flag]} is not ported")
        raise SystemExit(
            f"flexflow_torch does not support {flag!r} yet: the port "
            f"trains on a synthetic batch; the other training "
            f"features are queued in ROADMAP.md queue 1")
    try:
        cfg = FFConfig.parse_args(argv)
    except ValueError as e:
        raise SystemExit(str(e))
    if cfg.compute_dtype not in _DTYPES:
        raise SystemExit(f"--dtype expects one of {_DTYPES}, got "
                         f"{cfg.compute_dtype!r}")
    if cfg.accum_steps < 1 or cfg.batch_size % cfg.accum_steps:
        raise SystemExit(f"--accum-steps {cfg.accum_steps}: the batch "
                         f"({cfg.batch_size}) must split into that many "
                         f"equal microbatches")
    return cfg


def world_ranks(cfg: FFConfig, device="cuda") -> int:
    """The ranks of ``-ll:gpu N``: one unless ``N > 1`` is passed.  (The
    JAX package's default spans every visible device; here a run without
    ``-ll:gpu`` stays one process, so an app on a multi-card host does not
    start a world whose replicated ops each run the whole batch.)  On CUDA
    ``N`` above the visible cards raises: two ranks never share a card.
    Inside a world, the world's size.  Every training feature runs under
    any number of ranks (the executor's and the trainers' docstrings say
    how each is made the same on every rank)."""
    import torch

    from flexflow_torch.parallel import launch

    if launch.in_world():
        n = launch.world_size()
    else:
        n = max(cfg.num_devices, 1)
        cards = torch.cuda.device_count()
        if n > 1 and torch.device(device).type == "cuda" and n > cards:
            raise SystemExit(f"-ll:gpu {n}: {cards} CUDA devices are "
                             f"visible; the port runs one rank per card and "
                             f"never shares one")
    return n


def spawn_ranks(cfg: FFConfig, target: str, argv, device="cuda",
                stats_out: Optional[dict] = None) -> Optional[int]:
    """Under ``-ll:gpu N > 1`` outside a world, run the app ``target``
    (``"module:main"``) with ``argv`` on each rank of a new world
    (``parallel/launch.py``: NCCL a card a rank on CUDA, gloo on the CPU);
    returns the first non-zero exit code of the ranks, else 0, and puts
    rank 0's stats into ``stats_out``.  Returns None when this process is
    to run the app itself (one rank, or a rank of the world)."""
    import torch

    from flexflow_torch.parallel import launch

    n = world_ranks(cfg, device)
    if n == 1 or launch.in_world():
        return None
    load_strategy(cfg, n)  # a table the world cannot run fails here
    kind = torch.device(device).type
    try:
        ranks = launch.run("flexflow_torch.apps.common:rank_app",
                           (target, list(argv), kind), nprocs=n, device=kind)
    except Exception as e:  # a rank's failure, with its traceback above
        raise SystemExit(f"-ll:gpu {n}: {type(e).__name__}: {e}")
    refused = next((code for code, _ in ranks if isinstance(code, str)),
                   None)
    if refused is not None:  # a rank's refusal, with its own words
        raise SystemExit(refused)
    if stats_out is not None:
        stats_out.update(ranks[0][1])
    return next((code for code, _ in ranks if code), 0)


def rank_app(target: str, argv, device: str):
    """A rank's body under :func:`spawn_ranks`: the app ``target`` on this
    rank.  Returns its exit code and its stats, less the trained tensors
    and the executor (``"final"``, ``"executor"``: the rank's shards stay
    in the rank)."""
    import importlib

    mod, _, fn = target.partition(":")
    stats: Dict[str, Any] = {}
    try:
        code = getattr(importlib.import_module(mod), fn)(
            argv, device=device, stats_out=stats)
    except SystemExit as e:  # a refusal (a message) or an exit code
        code = e.code
    return code, {k: v for k, v in stats.items()
                  if k not in ("final", "executor")}


def make_optimizer(cfg: FFConfig):
    """``--optimizer sgd|adam`` (sgd matches the reference's only
    optimizer, ``optimizer_kernel.cu:28-129``; adam is the rebuild's
    addition)."""
    if cfg.lr_schedule not in ("constant", "cosine", "step"):
        raise SystemExit(f"unknown --lr-schedule {cfg.lr_schedule!r} "
                         f"(constant|cosine|step)")
    if cfg.lr_schedule != "constant" and cfg.optimizer != "adam":
        raise SystemExit("--lr-schedule requires --optimizer adam (SGD keeps "
                         "the reference's fixed-lr semantics)")
    if cfg.lr_schedule != "cosine" and (cfg.warmup_steps or cfg.min_lr):
        raise SystemExit("--warmup/--min-lr apply to --lr-schedule cosine "
                         "only")
    if cfg.optimizer == "sgd":
        return SGDOptimizer(lr=cfg.learning_rate, momentum=cfg.momentum,
                            weight_decay=cfg.weight_decay,
                            lazy_sparse=cfg.lazy_sparse_optimizer)
    if cfg.optimizer == "adam":
        return AdamOptimizer(
            lr=cfg.learning_rate, weight_decay=cfg.weight_decay,
            schedule=cfg.lr_schedule, warmup_steps=cfg.warmup_steps,
            decay_steps=cfg.decay_steps, min_lr=cfg.min_lr,
            gamma=cfg.lr_gamma, lazy_sparse=cfg.lazy_sparse_optimizer)
    raise SystemExit(f"unknown --optimizer {cfg.optimizer!r} (sgd|adam)")


def load_strategy(cfg: FFConfig, num_devices: Optional[int] = None):
    """``-s FILE``: the strategy table of the JAX package's JSON file over
    ``num_devices`` (default: the world's ranks).  A table that needs more
    devices, ``-s auto`` and the reference's ``.pb`` files are refused by
    name; one that places ops on proper subsets of the devices runs as a
    pipeline (``runtime/pipeline.py::make_executor``).  Returns the store,
    or None without ``-s``."""
    from flexflow_torch.parallel import launch
    from flexflow_torch.parallel.strategy import StrategyStore

    path = cfg.strategy_file
    if path is None:
        return None
    flag = f"-s/--strategy {path}"
    if path.lower() == "auto":
        raise SystemExit(f"{flag}: the execution-config search is not ported "
                         f"(ROADMAP.md queue 1, item 11)")
    try:
        store = StrategyStore.load(path, num_devices=num_devices
                                   or launch.world_size())
        store.check_devices()
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise SystemExit(f"{flag}: {e}")
    return store


def make_batch_fn(ff, cfg: FFConfig, int_high: Optional[Dict[str, int]] = None):
    """Deterministic per-step host batches for the resilient loop:
    ``batch_fn(step)`` gives the SAME batch every time a step is played,
    so a replay after a rollback reproduces the unfaulted trajectory bit
    for bit.  Synthetic inputs under the key ``(seed, step)``, through
    ``synthetic_host_batch``'s rules (the JAX package's draw).  The
    dataset form comes with the data plane (ROADMAP.md queue 1, item
    12)."""
    from flexflow_torch.data.loader import synthetic_host_batch

    def batch_fn(step: int) -> Dict[str, np.ndarray]:
        return synthetic_host_batch(
            ff, np.random.default_rng((cfg.seed, step)), int_high)

    return batch_fn


def _run_eval(trainer, params, state, cfg: FFConfig):
    """``--eval-iters``: read-only steps on the trained params, on fresh
    synthetic batches (seeds ``cfg.seed + 1 + i``), one implementation
    for the plain and the resilient path."""
    batches = (trainer.synthetic_batch(seed=cfg.seed + 1 + i)
               for i in range(cfg.eval_iters))
    ev = trainer.evaluate(params, state, batches, iterations=cfg.eval_iters)
    print(f"EVAL loss = {ev['loss']:.6f} "
          f"accuracy = {100.0 * ev['accuracy']:.2f}%")
    return ev


def _ckpt_dir(cfg: FFConfig) -> str:
    return cfg.ckpt_dir or os.path.join(os.getcwd(), "ckpts")


def _run_resilient(ff, cfg: FFConfig, executor_factory, label: str,
                   first_ex=None) -> Dict[str, Any]:
    """``--resilient``: the ResilientTrainer loop (failure detection,
    rollback to the latest checkpoint with deterministic replay, the
    SIGTERM emergency save), with ``--steps-per-call`` (detection at the
    one fence of each superstep).  A preempted run prints where it saved
    and exits 0; the same ``--ckpt-dir`` resumes there."""
    from flexflow_torch.runtime.checkpoint import CheckpointManager
    from flexflow_torch.runtime.resilience import (
        FailurePolicy,
        ResilientTrainer,
    )
    from flexflow_torch.runtime.trainer import Trainer

    from flexflow_torch.runtime.pipeline import PipelineExecutor

    if isinstance(first_ex, PipelineExecutor) and cfg.steps_per_call > 1:
        raise SystemExit(
            "--resilient --steps-per-call K>1 requires a fused superstep "
            "(full-mesh strategies, or a layer-wise one with "
            "--pipeline-compiled, ROADMAP.md queue 1 item 10b); host-driven "
            "layer-wise strategies compose with --resilient at "
            "steps-per-call 1")
    if cfg.accum_steps > 1:
        raise SystemExit("--resilient does not compose with --accum-steps "
                         "yet")
    batch_fn = make_batch_fn(ff, cfg)
    iters = cfg.iterations * max(cfg.epochs, 1)
    with CheckpointManager(_ckpt_dir(cfg),
                           async_save=cfg.async_checkpointing) as ck:
        rt = ResilientTrainer(executor_factory, ck,
                              policy=FailurePolicy(
                                  max_restarts=cfg.max_restarts))
        start = time.perf_counter()
        out = rt.fit(iterations=iters, batch_fn=batch_fn,
                     save_every=cfg.save_every, seed=cfg.seed,
                     steps_per_call=cfg.steps_per_call)
        elapsed = time.perf_counter() - start
    completed = len(out["losses"])
    throughput = completed * cfg.batch_size / max(elapsed, 1e-9)
    print(f"time = {elapsed:.4f}s")
    print(f"tp = {throughput:.2f} samples/s")
    print(f"ELAPSED TIME = {elapsed:.4f}s")
    print(f"THROUGHPUT = {throughput:.2f} {label}/s")
    print(f"restarts = {out['restarts']}")
    if completed == 0:
        print(f"resumed at step {out['step']}: already complete")
    if out["preempted"]:
        # Out before any eval: the grace window is for the save.
        print(f"PREEMPTED: emergency checkpoint at step {out['step']}")
        raise SystemExit(0)
    stats = {
        "elapsed_s": elapsed,
        "samples_per_s": throughput,
        "iterations": out["step"],
        "batch_size": cfg.batch_size,
        "loss": out["loss"],
        "restarts": out["restarts"],
        # Steps this process ran (a resumed run's "iterations" is its
        # absolute step): the denominator of this run's elapsed_s.
        "steps_this_run": completed,
        "step_losses": [out["losses"][s] for s in sorted(out["losses"])],
        "final": (out["params"], out["opt_state"], out["state"]),
        "executor": rt.executor,
    }
    if "telemetry" in out:
        stats["telemetry"] = out["telemetry"]
    if cfg.eval_iters > 0 and rt.executor is not None:
        stats["eval"] = _run_eval(Trainer(rt.executor), out["params"],
                                  out["state"], cfg)
    return stats


def run_training(ff, cfg: FFConfig, label: str = "samples",
                 device="cuda", strategy=None) -> Dict[str, Any]:
    """Build the executor, run ``cfg.epochs x cfg.iterations`` timed
    steps (after one warmup step; a whole superstep of warmup with
    ``--steps-per-call``) on one fixed device-resident synthetic batch
    (the reference's syntheticInput), and print the reference
    throughput lines (``cnn.cc:128-129``, ``dlrm.cc:159-166``).  The
    batch is ``Trainer.synthetic_batch``'s: as in the JAX package, its
    integer inputs are drawn in ``{0, 1}``.  With ``--eval-iters N``,
    ``N`` read-only eval steps follow on the trained params, on fresh
    synthetic batches (seeds ``cfg.seed + 1 + i``, as in the JAX
    package), and print the ``EVAL`` line.

    ``--resilient`` takes the ResilientTrainer loop on per-step batches
    from :func:`make_batch_fn`; ``--ckpt-dir`` / ``--save-every`` alone
    give ``Trainer.fit`` a checkpoint (resume, periodic and final saves,
    the SIGTERM emergency save: a preempted run exits 0).  With
    ``--telemetry DIR`` (or ``FF_TELEMETRY_DIR``) the whole run, the
    executor's build included, reports into one JSONL stream.  Returns
    the fit stats, with the trained ``(params, opt_state, state)`` under
    ``"final"`` and the eval results under ``"eval"``."""
    from flexflow_torch.runtime import telemetry as _telemetry

    with _telemetry.maybe_run(cfg, meta={"app": label}):
        return _run_training(ff, cfg, label, device, strategy)


def _run_training(ff, cfg: FFConfig, label: str, device,
                  strategy) -> Dict[str, Any]:
    from flexflow_torch.runtime.checkpoint import CheckpointManager
    from flexflow_torch.runtime.pipeline import PipelineExecutor, make_executor
    from flexflow_torch.runtime.trainer import Trainer

    strategy = load_strategy(cfg) or strategy

    def build():
        try:
            ex = make_executor(
                ff, strategy, config=cfg, optimizer=make_optimizer(cfg),
                device=device, microbatches=cfg.microbatches,
                schedule=cfg.pipeline_schedule, chunk=cfg.pipeline_chunk,
                compiled=cfg.pipeline_compiled, accum_steps=cfg.accum_steps)
        except ValueError as e:
            raise SystemExit(str(e))
        if isinstance(ex, PipelineExecutor):
            if cfg.granules > 1:
                raise SystemExit("--granules (hybrid mesh) and device-subset "
                                 "placement cannot combine yet")
            return ex
        try:
            # Under a mesh a microbatch splits over every op's n too.
            ex.check_microbatches(cfg.accum_steps)
        except ValueError as e:
            raise SystemExit(str(e))
        return ex

    ex = build()
    if cfg.resilient:
        def executor_factory(_first=[ex]):
            # The first call takes the executor built above; a recovery
            # from a raised fault builds a fresh one.
            return _first.pop() if _first else build()

        stats = _run_resilient(ff, cfg, executor_factory, label, ex)
    else:
        trainer = Trainer(ex)
        ck = None
        if cfg.ckpt_dir or cfg.save_every > 0:
            ck = CheckpointManager(_ckpt_dir(cfg),
                                   async_save=cfg.async_checkpointing)
        try:
            stats = trainer.fit(iterations=cfg.iterations * max(cfg.epochs, 1),
                                warmup=1, log_every=cfg.print_freq,
                                checkpoint=ck, save_every=cfg.save_every,
                                accum_steps=cfg.accum_steps,
                                steps_per_call=cfg.steps_per_call)
        finally:
            if ck is not None:
                ck.close()
        print(f"ELAPSED TIME = {stats['elapsed_s']:.4f}s")
        print(f"THROUGHPUT = {stats['samples_per_s']:.2f} {label}/s")
        if stats.get("preempted"):
            print(f"PREEMPTED: emergency checkpoint at step "
                  f"{stats['checkpoint_step']}")
            raise SystemExit(0)
        if cfg.eval_iters > 0:
            params, _, state = trainer.final
            stats["eval"] = _run_eval(trainer, params, state, cfg)
        #: The trained (params, opt_state, state) and the executor that
        #: trained them, for a caller that checks or evaluates them.
        stats["final"] = trainer.final
        stats["executor"] = ex
    return stats
