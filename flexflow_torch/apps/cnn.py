"""The CNN catalog's training app: the single-GPU path of
``flexflow_tpu/apps/cnn.py`` (reference ``cnn.cc:42-281``, one binary
for many networks).

``--model`` picks AlexNet, VGG-16, Inception-v3, DenseNet-121 or
ResNet-101 (``models/alexnet.py``, ``models/cnn_catalog.py``) at the
reference's image size (229, 224, 299, 224, 224), 1000 classes, and
trains it on one fixed synthetic batch through ``run_training`` ->
``Executor.train_step`` -> ``Trainer.fit``: convolutions on cuDNN (the
plans timed at each shape's first call, ``ops.conv.time_conv_plans``),
DenseNet's BatchNorms in tensor ops with their running statistics as op
state, the loss through the fused cross-entropy kernel K3.  Prints the
reference throughput lines and ``tp = ... images/s`` (``cnn.cc:128-129``).

Example::

    python -m flexflow_torch.apps.cnn --model densenet121 -b 64 -i 10 \\
        --dtype bfloat16 --optimizer sgd --lr 0.01

The common ``--steps-per-call``, ``--accum-steps`` and ``--remat`` apply.
Refused until their slices land (ROADMAP.md queue 1): image folders
(``-d``, item 12) and the strategy searches (``-s auto``, ``--search``,
item 11).  ``-ll:gpu N`` trains on N ranks, data-parallel unless ``-s
FILE.json`` gives other degrees; a file that places ops on subsets of
the devices trains them as pipeline stages (``--microbatches``,
``--pipeline-schedule``).
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
from flexflow_torch.models.alexnet import build_alexnet
from flexflow_torch.models.cnn_catalog import (
    build_densenet121,
    build_inception_v3,
    build_resnet101,
    build_vgg16,
)
from flexflow_torch.ops.conv import time_conv_plans

#: ``--model`` name -> (builder, the reference's image size).
MODELS = {
    "alexnet": (build_alexnet, 229),
    "vgg16": (build_vgg16, 224),
    "inception": (build_inception_v3, 299),
    "densenet121": (build_densenet121, 224),
    "resnet101": (build_resnet101, 224),
}


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    full_argv = list(argv)
    model = pop_str(argv, "--model", "alexnet")
    if model not in MODELS:
        raise SystemExit(f"unknown --model {model!r}; one of {sorted(MODELS)}")
    cfg = parse_training_args(argv)
    code = spawn_ranks(cfg, "flexflow_torch.apps.cnn:main", full_argv,
                       device, stats_out)
    if code is not None:
        return code
    build, image_size = MODELS[model]
    ff = build(batch_size=cfg.batch_size, image_size=image_size, config=cfg)
    time_conv_plans(device)
    stats = run_training(ff, cfg, label="images", device=device)
    print(f"tp = {stats['samples_per_s']:.2f} images/s")  # cnn.cc:128-129
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
