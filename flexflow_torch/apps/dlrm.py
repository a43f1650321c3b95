"""DLRM training app: the port of ``flexflow_tpu/apps/dlrm.py``
(reference ``examples/DLRM/dlrm.cc``), on one GPU or a world of ranks.

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

With ``--steps-per-call K`` the K steps of a call are one CUDA graph;
``--accum-steps N`` accumulates dense gradients (the tables' too: the
row-sparse path is ``train_step``'s alone, as in the JAX package).

With ``-ll:gpu N`` the app runs on a world of N ranks, a card each
(``apps.common.spawn_ranks``), placed by ``-s FILE.json`` when given
(``apps.common.load_strategy``) and by ``dlrm_strategy`` otherwise: the
stacked tables at ``c = gcd(T, N)``, each rank holding ``T / c`` of them,
and the MLPs data-parallel.  K4 and K5 run on each rank's block of the
tables.  For example, the ``run_random.sh`` shape on two cards, the
tables split between them::

    python -m flexflow_torch.apps.dlrm -ll:gpu 2 -b 256 -i 10 \
        --dtype bfloat16 --optimizer sgd --lr 0.01 --momentum 0 --wd 0 \
        --arch-sparse-feature-size 64 \
        --arch-embedding-size 1000000-1000000-1000000-1000000-1000000-1000000-1000000-1000000 \
        --arch-mlp-bot 64-512-512-64 --arch-mlp-top 576-1024-1024-1024-1

DLRM flags: ``--arch-sparse-feature-size --arch-embedding-size
--arch-mlp-bot --arch-mlp-top --arch-interaction-op cat|dot --sigmoid-bot
--sigmoid-top --loss-threshold --lazy-sparse-opt --shard-embeddings``
(tables of mixed vocabularies each range-sharded over ``gcd(vocab, N)``
ranks).  Without ``--arch-*`` the model is 4 tables x 1000 rows x 16.
Refused until their slices land (ROADMAP.md queue 1): datasets and
streamed traces (``-d``, ``--stream-dataset``, ``--zc-dataset``,
``--prod-trace``, ``--trace-*``).
"""

from __future__ import annotations

import sys
from typing import Optional

from flexflow_torch.apps.common import (
    check_help,
    parse_training_args,
    run_training,
    spawn_ranks,
    world_ranks,
)
from flexflow_torch.models.dlrm import DLRMConfig, build_dlrm, dlrm_strategy

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
}


def _refuse(argv) -> None:
    for a in argv:
        why = _REFUSED.get(a)
        if why is None and a.startswith("--trace-"):
            # --trace-alpha / --trace-burst shape --prod-trace; --trace
            # DIR (the profiler) is a common flag.
            why = "production traces (ROADMAP.md queue 1, item 12)"
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
    full_argv = list(argv)
    switches = {}
    for flag in ("--lazy-sparse-opt", "--shard-embeddings"):
        switches[flag] = flag in argv
        while flag in argv:
            argv.remove(flag)
    dlrm_argv = []
    for flag in DLRM_FLAGS:
        while flag in argv:
            i = argv.index(flag)
            dlrm_argv += argv[i:i + 2]
            del argv[i:i + 2]
    cfg = parse_training_args(argv)
    cfg.lazy_sparse_optimizer = switches["--lazy-sparse-opt"]
    cfg.shard_embeddings = switches["--shard-embeddings"]
    code = spawn_ranks(cfg, "flexflow_torch.apps.dlrm:main", full_argv,
                       device, stats_out)
    if code is not None:
        return code
    ranks = world_ranks(cfg, device)
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
    # JAX's app: ``-s FILE`` first (``run_training`` loads it), else the
    # reference's table-parallel placement.
    stats = run_training(ff, cfg, label="samples", device=device,
                         strategy=dlrm_strategy(
                             ranks, dlrm,
                             shard_embeddings=cfg.shard_embeddings))
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
