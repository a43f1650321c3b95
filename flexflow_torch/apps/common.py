"""Shared app harness: the flag helpers, ``make_optimizer`` and the
plain single-device ``run_training`` of ``flexflow_tpu/apps/common.py``."""

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
  --min-lr F   --lr-gamma F (adam only)   -ll:gpu 1
Every other flag of the JAX package's apps is refused until its slice
of the port lands (ROADMAP.md queue 1)."""

#: The FFConfig flags a training app of this slice reads (each takes a
#: value).
TRAINING_FLAGS = (
    "-b", "--batch-size", "-i", "--iterations", "-e", "--epochs", "-p",
    "--print-freq", "--lr", "--learning-rate", "--wd", "--weight-decay",
    "--dtype", "--seed", "--optimizer", "--momentum", "--lr-schedule",
    "--warmup", "--decay-steps", "--min-lr", "--lr-gamma", "--clip-norm",
    "-ll:gpu", "-ll:tpu",
)

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
    ``TRAINING_FLAGS`` is refused (the JAX parser passes unknown flags
    through; here they would name features this slice lacks), and so
    are more than one device and a dtype other than f32 or bf16."""
    for flag in argv[::2]:
        if flag not in TRAINING_FLAGS:
            raise SystemExit(
                f"flexflow_torch does not support {flag!r} yet: this slice "
                f"of the port trains on one GPU with the plain per-step "
                f"loop; the other training features are queued in "
                f"ROADMAP.md queue 1")
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


def run_training(ff, cfg: FFConfig, label: str = "samples",
                 device="cuda") -> Dict[str, Any]:
    """Build the executor, run ``cfg.epochs x cfg.iterations`` timed
    steps (after one warmup step) on one fixed device-resident synthetic
    batch (the reference's syntheticInput), and print the reference
    throughput lines (``cnn.cc:128-129``, ``dlrm.cc:159-166``).  The
    batch is ``Trainer.synthetic_batch``'s: as in the JAX package, its
    integer inputs are drawn in ``{0, 1}``.  Returns the fit stats, with
    the trained ``(params, opt_state, state)`` under ``"final"``."""
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device=device)
    trainer = Trainer(ex)
    stats = trainer.fit(iterations=cfg.iterations * max(cfg.epochs, 1),
                        warmup=1, log_every=cfg.print_freq)
    print(f"ELAPSED TIME = {stats['elapsed_s']:.4f}s")
    print(f"THROUGHPUT = {stats['samples_per_s']:.2f} {label}/s")
    #: The trained (params, opt_state, state), for a caller that checks
    #: or evaluates them.
    stats["final"] = trainer.final
    return stats
