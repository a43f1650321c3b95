"""Transformer LM training app: the single-GPU path of
``flexflow_tpu/apps/transformer.py``.

Builds the decoder-only LM (``build_transformer_lm``) and trains it on
one fixed synthetic batch through ``run_training`` →
``Executor.train_step`` → ``Trainer.fit``: attention through the flash
dispatcher ``kernels.flash_attention_lse_auto`` in every layer (the
kernels K1f forward and K1b backward; with ``FF_FLASH_STREAMED=1`` in
the environment, the streamed K1s and K1sb) and the fused cross-entropy
(K3) over the vocabulary.  Prints the reference throughput lines and
``tokens/s``.

Flags beyond the common set: ``--seq --vocab --d-model --heads
--layers`` and ``--experts N`` (every block's MLP a switch-style
mixture-of-experts FFN of N experts, top-1, capacity factor 1.25,
``ops/moe.py``).  The common set includes ``--steps-per-call K`` (K steps
as one CUDA graph), ``--accum-steps N`` and ``--remat``.  ``--dp``,
``--sp`` and ``--tp`` above 1 (hybrid and ring parallelism; with
``--experts``, ``--tp`` shards the experts) are refused: multi-device
strategies are ROADMAP.md queue 1, item 9.

Example (the shape ``bench.py`` trains the LM at)::

    python -m flexflow_torch.apps.transformer -b 16 --seq 2048 --layers 6 \\
        --vocab 32768 --d-model 512 --heads 8 --optimizer adam --lr 1e-4 \\
        --dtype bfloat16 -i 5

Long context (``bench.py``'s 8k leg; its 32k leg is ``-b 1 --seq 32768
-i 3``) on the streamed kernels::

    FF_FLASH_STREAMED=1 python -m flexflow_torch.apps.transformer -b 4 \\
        --seq 8192 --layers 6 --vocab 32768 --d-model 512 --heads 8 \\
        --optimizer adam --lr 1e-4 --dtype bfloat16 -i 5
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
from flexflow_torch.models.transformer import build_transformer_lm


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    seq = pop_int(argv, "--seq", 512)
    vocab = pop_int(argv, "--vocab", 32 * 1024)
    d_model = pop_int(argv, "--d-model", 512)
    heads = pop_int(argv, "--heads", 8)
    layers = pop_int(argv, "--layers", 4)
    parallel = {f: pop_int(argv, f, 1) for f in ("--dp", "--sp", "--tp")}
    experts = pop_int(argv, "--experts", 0)
    wide = [f"{f} {n}" for f, n in parallel.items() if n > 1]
    if wide:
        raise SystemExit(f"flexflow_torch transformer does not support "
                         f"{', '.join(wide)} yet: multi-device strategies "
                         f"are ROADMAP.md queue 1, item 9")
    cfg = parse_training_args(argv)
    try:
        ff = build_transformer_lm(
            batch_size=cfg.batch_size, seq_len=seq, vocab_size=vocab,
            d_model=d_model, num_heads=heads, num_layers=layers,
            moe_experts=experts, config=cfg,
        )
    except ValueError as e:
        raise SystemExit(f"transformer: {e}")
    stats = run_training(ff, cfg, label="sequences", device=device)
    print(f"tokens/s = {stats['samples_per_s'] * seq:.0f}")
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
