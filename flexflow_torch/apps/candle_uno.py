"""Candle-Uno training app: the single-GPU path of
``flexflow_tpu/apps/candle_uno.py`` (reference
``examples/candle_uno/candle_uno.cc``), the multi-tower
cancer-drug-response MLP.

Builds ``build_candle_uno`` and trains it on one fixed synthetic batch
through ``run_training`` -> ``Executor.train_step`` -> ``Trainer.fit``
(the dense layers on cuBLAS, the MSE loss in tensor ops), printing the
reference throughput lines.

Flags beyond the common set: ``--dense-layers A-B-C`` (the trunk's
widths, default 1000-1000-1000) and ``--dense-feature-layers A-B-C`` (each
feature tower's).  ``--steps-per-call``, ``--accum-steps``, ``--remat``,
the checkpoint flags, ``--resilient``, ``--telemetry``, ``--trace`` and
``--profiling`` work as on the other apps.  Refused until their slices
land (ROADMAP.md queue 1): ``-d`` (one CSV per input, ``data/csv.py``,
item 12), ``candle_uno_strategy``'s table over more than one rank (item
9d; ``-ll:gpu N`` trains data-parallel), ``-s auto`` and ``--search`` (item 11), ``--elastic`` (item 13).

Example (``bench.py``'s Candle-Uno leg)::

    python -m flexflow_torch.apps.candle_uno -b 512 -i 10 \\
        --dtype bfloat16 --optimizer sgd --lr 0.01 --momentum 0 --wd 0
"""

from __future__ import annotations

import sys
from typing import Optional

from flexflow_torch.apps.common import (
    check_help,
    parse_training_args,
    pop_str,
    run_training,
    spawn_ranks,
)
from flexflow_torch.models.candle_uno import CandleConfig, build_candle_uno


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs on the
    CPU (tests); ``stats_out``, when given, receives the run's stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    full_argv = list(argv)
    try:
        candle = CandleConfig.parse_args(argv)
    except ValueError as e:
        raise SystemExit(str(e))
    for flag in ("--dense-layers", "--dense-feature-layers"):
        pop_str(argv, flag, None)
    cfg = parse_training_args(argv)
    code = spawn_ranks(cfg, "flexflow_torch.apps.candle_uno:main", full_argv,
                       device, stats_out)
    if code is not None:
        return code
    ff = build_candle_uno(batch_size=cfg.batch_size, candle=candle,
                          config=cfg)
    stats = run_training(ff, cfg, device=device)
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
