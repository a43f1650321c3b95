"""DLRM training app: the single-GPU path of ``flexflow_tpu/apps/dlrm.py``
(reference ``examples/DLRM/dlrm.cc``).

Builds the model (``build_dlrm``) from the reference's ``--arch-*``
flags and trains it on one fixed synthetic batch through
``run_training`` -> ``Executor.train_step`` -> ``Trainer.fit``, printing
``THROUGHPUT = ... samples/s`` (``dlrm.cc:165-166``).  With plain SGD
(``--optimizer sgd --momentum 0 --wd 0``) or ``--lazy-sparse-opt``, the
tables train on the row-sparse path: K4 gathers the batch's rows, K5
scatter-adds their updates in place.

Example (``bench.py``'s DLRM leg, the ``run_random.sh`` shape on one
GPU)::

    python -m flexflow_torch.apps.dlrm -b 256 -i 10 --dtype bfloat16 \\
        --optimizer sgd --lr 0.01 --momentum 0 --wd 0 \\
        --arch-sparse-feature-size 64 \\
        --arch-embedding-size 1000000-1000000-1000000-1000000-1000000-1000000-1000000-1000000 \\
        --arch-mlp-bot 64-512-512-64 --arch-mlp-top 576-1024-1024-1024-1

DLRM flags: ``--arch-sparse-feature-size --arch-embedding-size
--arch-mlp-bot --arch-mlp-top --arch-interaction-op cat|dot --sigmoid-bot
--sigmoid-top --loss-threshold --lazy-sparse-opt``.  Without ``--arch-*``
the model is 4 tables x 1000 rows x 16.  Refused until their slices land
(ROADMAP.md queue 1): datasets and streamed traces (``-d``,
``--stream-dataset``, ``--zc-dataset``, ``--prod-trace``, ``--trace-*``),
and ``--shard-embeddings``.  A strategy file (``-s FILE.json``) is
accepted when it puts every op on the one GPU
(``apps.common.load_strategy``).
"""

from __future__ import annotations

import sys
from typing import Optional

from flexflow_torch.apps.common import check_help, parse_training_args, run_training
from flexflow_torch.models.dlrm import DLRMConfig, build_dlrm

#: The DLRM flags, each taking a value (``DLRMConfig.parse_args``).
DLRM_FLAGS = (
    "--arch-sparse-feature-size", "--arch-embedding-size", "--arch-mlp-bot",
    "--arch-mlp-top", "--arch-interaction-op", "--sigmoid-bot",
    "--sigmoid-top", "--loss-threshold",
)

_REFUSED = {
    "--stream-dataset": "the streaming data plane (ROADMAP.md queue 1, item 12)",
    "--zc-dataset": "device-resident datasets (ROADMAP.md queue 1, item 12)",
    "--prod-trace": "production traces (ROADMAP.md queue 1, item 12)",
    "--shard-embeddings": "row-sharded tables (ROADMAP.md queue 1, item 9)",
}


def _refuse(argv) -> None:
    for a in argv:
        why = _REFUSED.get(a)
        if why is None and a.startswith("--trace"):
            why = "traces (ROADMAP.md queue 1, items 7 and 12)"
        if why is not None:
            raise SystemExit(f"flexflow_torch dlrm does not support {a!r} yet: "
                             f"{why} is not ported")


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    _refuse(argv)
    lazy = "--lazy-sparse-opt" in argv
    if lazy:
        argv.remove("--lazy-sparse-opt")
    dlrm_argv = []
    for flag in DLRM_FLAGS:
        while flag in argv:
            i = argv.index(flag)
            dlrm_argv += argv[i:i + 2]
            del argv[i:i + 2]
    cfg = parse_training_args(argv)
    cfg.lazy_sparse_optimizer = lazy
    if any(a.startswith("--arch-") for a in dlrm_argv):
        try:
            dlrm = DLRMConfig.parse_args(dlrm_argv)
        except ValueError as e:
            raise SystemExit(str(e))
    else:
        # The reference's header defaults (dlrm.h:23-32) disagree with
        # each other (top MLP width != interaction width), since its run
        # scripts always pass --arch-*; the JAX app's small consistent
        # shape instead: 4 tables x 1000 rows, 16-dim.
        dlrm = DLRMConfig(sparse_feature_size=16, embedding_size=[1000] * 4,
                          mlp_bot=[16, 64, 16], mlp_top=[16 + 4 * 16, 64, 1])
    try:
        ff = build_dlrm(batch_size=cfg.batch_size, dlrm=dlrm, config=cfg)
    except ValueError as e:
        raise SystemExit(f"dlrm: {e}")
    stats = run_training(ff, cfg, label="samples", device=device)
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
