"""NMT training app: the single-GPU path of ``flexflow_tpu/apps/nmt.py``
(reference ``nmt/nmt.cc``), a seq2seq LSTM encoder-decoder.

Builds ``build_nmt`` from the flags and trains it on one fixed synthetic
batch through ``run_training`` -> ``Executor.train_step`` ->
``Trainer.fit``, printing the reference's ``time = %.4fs`` line
(``nmt.cc:77-83``).  The loss runs the fused cross-entropy (K3); with
plain SGD (``--optimizer sgd --momentum 0 --wd 0``) the two word
embeddings train on the row-sparse path (K4 gathers, K5 scatter-adds).

Flags beyond the common set: ``--src-len --tgt-len --vocab --hidden
--layers --dropout`` (reference defaults: seq 20-40, hidden 2048, vocab
32k, ``nmt.cc:44``; dropout 0.2, ``lstm.cu:152``).  ``--steps-per-call``,
``--accum-steps`` and ``--remat`` work as on the other apps.  Refused
until their slices land: ``--pipeline`` (ROADMAP.md queue 1 item 10) and
the strategy search (item 11).

Example (``bench.py``'s NMT leg)::

    python -m flexflow_torch.apps.nmt -b 64 -i 10 --hidden 2048 \\
        --vocab 20480 --dtype bfloat16 --optimizer sgd --lr 0.01 \\
        --momentum 0 --wd 0
"""

from __future__ import annotations

import sys
from typing import Optional

from flexflow_torch.apps.common import (
    check_help,
    parse_training_args,
    pop_float,
    pop_int,
    run_training,
    world_ranks,
)
from flexflow_torch.models.nmt import build_nmt

#: The JAX app's flags this port does not serve yet.
UNPORTED = {
    "--pipeline": "the layer-wise placement through the pipeline executor "
                  "(ROADMAP.md queue 1, item 10)",
}


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    for flag, why in UNPORTED.items():
        if flag in argv:
            raise SystemExit(f"flexflow_torch nmt does not support {flag} "
                             f"yet: {why} is not ported")
    src_len = pop_int(argv, "--src-len", 20)
    tgt_len = pop_int(argv, "--tgt-len", 20)
    vocab = pop_int(argv, "--vocab", 32 * 1024)
    hidden = pop_int(argv, "--hidden", 1024)
    layers = pop_int(argv, "--layers", 2)
    dropout = pop_float(argv, "--dropout", 0.2)  # lstm.cu:152
    cfg = parse_training_args(argv)
    ranks = world_ranks(cfg, device)
    try:
        ff = build_nmt(
            batch_size=cfg.batch_size, src_len=src_len, tgt_len=tgt_len,
            vocab_size=vocab, embed_dim=hidden, hidden_size=hidden,
            num_layers=layers, dropout=dropout, config=cfg,
        )
    except ValueError as e:
        raise SystemExit(f"nmt: {e}")
    # The word embeddings run on a mesh; the LSTM waits for item 9d, and
    # each rank's executor would refuse it: say so before any starts.
    lstm = next(op for op in ff.layers if op.mesh_refusal)
    if ranks > 1:
        raise SystemExit(f"-ll:gpu {ranks}: {lstm.name}: {lstm.mesh_refusal}")
    stats = run_training(ff, cfg, label="sentence-pairs", device=device)
    print(f"time = {stats['elapsed_s']:.4f}s")  # nmt.cc:77-83
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
