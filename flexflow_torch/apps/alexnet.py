"""AlexNet training app: the single-GPU path of
``flexflow_tpu/apps/alexnet.py`` (reference ``alexnet.cc``, launched
by ``cnn.cc``).

Builds AlexNet (``build_alexnet``) and trains it on one fixed synthetic
batch through ``run_training`` -> ``Executor.train_step`` ->
``Trainer.fit``: the convolutions on cuDNN (the plans timed at each
shape's first call, ``ops.conv.time_conv_plans``), the linears on
cuBLAS and the loss through the fused cross-entropy kernel K3.  Prints the
reference throughput lines and ``tp = ... images/s``
(``cnn.cc:128-129``).

Example (``bench.py``'s AlexNet leg)::

    python -m flexflow_torch.apps.alexnet -b 2048 -i 20 --dtype bfloat16

Flags beyond the common set: ``--image-size N`` (default 229, the
reference's).  Refused until their slices land (ROADMAP.md queue 1):
image folders (``-d``, item 12), the strategy searches (``-s auto``,
``--search``, item 11) and strategy files that place an op on more than
the one GPU (item 9).
"""

from __future__ import annotations

import sys
from typing import Optional

from flexflow_torch.apps.common import (
    check_help,
    parse_training_args,
    pop_int,
    run_training,
)
from flexflow_torch.models.alexnet import build_alexnet
from flexflow_torch.ops.conv import time_conv_plans


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    image_size = pop_int(argv, "--image-size", 229)
    cfg = parse_training_args(argv)
    ff = build_alexnet(batch_size=cfg.batch_size, image_size=image_size,
                       config=cfg)
    time_conv_plans(device)
    stats = run_training(ff, cfg, label="images", device=device)
    print(f"tp = {stats['samples_per_s']:.2f} images/s")  # cnn.cc:128-129
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
