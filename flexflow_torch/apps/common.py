"""Shared app harness: the flag helpers, ``make_optimizer``,
``load_strategy`` and the single-device ``run_training`` (with
``--eval-iters``, ``--steps-per-call``, ``--accum-steps`` and
``--remat``) of ``flexflow_tpu/apps/common.py``."""

from __future__ import annotations

from typing import Any, Dict, Optional

from flexflow_torch.config import FFConfig
from flexflow_torch.optim import AdamOptimizer, SGDOptimizer

COMMON_FLAGS = """\
Common flags the port reads so far:
  --dtype float32|bfloat16   --seed N
Training apps also read:
  -b/--batch-size N   -i/--iterations N   -e/--epochs N   -p/--print-freq N
  --lr F   --wd F   --optimizer sgd|adam   --momentum F   --clip-norm F
  --lr-schedule constant|cosine|step   --warmup N   --decay-steps N
  --min-lr F   --lr-gamma F (adam only)   -ll:gpu 1   --eval-iters N
  -s/--strategy FILE.json (every op on the one GPU)
  --steps-per-call K (K steps as one CUDA graph, one readback per K;
                      clamped at 20)
  --accum-steps N (one update from N microbatches of the batch)
  --remat (recompute each layer's activations in the backward)
Every other flag of the JAX package's apps is refused until its slice
of the port lands (ROADMAP.md queue 1)."""

#: The FFConfig flags a training app reads that take a value.
TRAINING_FLAGS = (
    "-b", "--batch-size", "-i", "--iterations", "-e", "--epochs", "-p",
    "--print-freq", "--lr", "--learning-rate", "--wd", "--weight-decay",
    "--dtype", "--seed", "--optimizer", "--momentum", "--lr-schedule",
    "--warmup", "--decay-steps", "--min-lr", "--lr-gamma", "--clip-norm",
    "-ll:gpu", "-ll:tpu", "--eval-iters", "-s", "--strategy",
    "--steps-per-call", "--accum-steps",
)
#: The FFConfig flags a training app reads that take no value.
TRAINING_SWITCHES = ("--remat",)

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
    "--resilient": "the resilient trainer (ROADMAP.md queue 1, item 7)",
    "--telemetry": "telemetry (ROADMAP.md queue 1, item 7)",
    "--granules": "multi-host hybrid meshes (ROADMAP.md queue 1, item 9)",
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
    the port lacks), and so are more than one device and a dtype other
    than f32 or bf16."""
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
            f"trains on one GPU on a synthetic batch; the other training "
            f"features are queued in ROADMAP.md queue 1")
    try:
        cfg = FFConfig.parse_args(argv)
    except ValueError as e:
        raise SystemExit(str(e))
    if cfg.num_devices > 1:
        raise SystemExit(f"-ll:gpu {cfg.num_devices}: this slice of the port "
                         f"trains on one GPU (multi-device strategies are "
                         f"ROADMAP.md queue 1, item 9)")
    if cfg.compute_dtype not in _DTYPES:
        raise SystemExit(f"--dtype expects one of {_DTYPES}, got "
                         f"{cfg.compute_dtype!r}")
    if cfg.accum_steps < 1 or cfg.batch_size % cfg.accum_steps:
        raise SystemExit(f"--accum-steps {cfg.accum_steps}: the batch "
                         f"({cfg.batch_size}) must split into that many "
                         f"equal microbatches")
    return cfg


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


def load_strategy(cfg: FFConfig):
    """``-s FILE``: the strategy table of the JAX package's JSON file,
    accepted when every op it names sits on the one GPU (all degrees 1,
    no device but 0).  The port has no other placement, so such a table
    changes nothing; any other table, ``-s auto`` and the reference's
    ``.pb`` files are refused by name.  Returns the store, or None
    without ``-s``."""
    from flexflow_torch.parallel.strategy import StrategyStore

    path = cfg.strategy_file
    if path is None:
        return None
    flag = f"-s/--strategy {path}"
    if path.lower() == "auto":
        raise SystemExit(f"{flag}: the execution-config search is not ported "
                         f"(ROADMAP.md queue 1, item 11)")
    try:
        store = StrategyStore.load(path, num_devices=cfg.num_devices)
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise SystemExit(f"{flag}: {e}")
    for name, pc in sorted(store.table.items()):
        if pc.num_parts != 1 or set(pc.device_ids or ()) - {0}:
            raise SystemExit(
                f"{flag}: op {name!r} is placed as {pc.to_json()}; the port "
                f"runs every op on one GPU (multi-device strategies are "
                f"ROADMAP.md queue 1, item 9)")
    return store


def run_training(ff, cfg: FFConfig, label: str = "samples",
                 device="cuda") -> Dict[str, Any]:
    """Build the executor, run ``cfg.epochs x cfg.iterations`` timed
    steps (after one warmup step; a whole superstep of warmup with
    ``--steps-per-call``) on one fixed device-resident synthetic batch
    (the reference's syntheticInput), and print the reference
    throughput lines (``cnn.cc:128-129``, ``dlrm.cc:159-166``).  The
    batch is ``Trainer.synthetic_batch``'s: as in the JAX package, its
    integer inputs are drawn in ``{0, 1}``.  With ``--eval-iters N``,
    ``N`` read-only eval steps follow on the trained params, on fresh
    synthetic batches (seeds ``cfg.seed + 1 + i``, as in the JAX
    package), and print the ``EVAL`` line.  Returns the fit stats, with
    the trained ``(params, opt_state, state)`` under ``"final"`` and
    the eval results under ``"eval"``."""
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    load_strategy(cfg)
    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device=device)
    trainer = Trainer(ex)
    stats = trainer.fit(iterations=cfg.iterations * max(cfg.epochs, 1),
                        warmup=1, log_every=cfg.print_freq,
                        accum_steps=cfg.accum_steps,
                        steps_per_call=cfg.steps_per_call)
    print(f"ELAPSED TIME = {stats['elapsed_s']:.4f}s")
    print(f"THROUGHPUT = {stats['samples_per_s']:.2f} {label}/s")
    if cfg.eval_iters > 0:
        params, _, state = trainer.final
        batches = (trainer.synthetic_batch(seed=cfg.seed + 1 + i)
                   for i in range(cfg.eval_iters))
        ev = trainer.evaluate(params, state, batches,
                              iterations=cfg.eval_iters)
        print(f"EVAL loss = {ev['loss']:.6f} "
              f"accuracy = {100.0 * ev['accuracy']:.2f}%")
        stats["eval"] = ev
    #: The trained (params, opt_state, state), for a caller that checks
    #: or evaluates them.
    stats["final"] = trainer.final
    return stats
