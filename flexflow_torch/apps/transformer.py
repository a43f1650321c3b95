"""Transformer LM training app: the port of
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
``ops/moe.py``), ``--dp N``, ``--sp N`` and ``--tp N``
(``transformer_strategy``'s table over ``-ll:gpu`` ranks: ``dp`` splits
the batch of every op, ``sp`` the sequence of the token ops and of
attention, which then runs as a ring (each rank launches K1f and K1b on
its chunk against its own and every earlier rank's), ``tp`` the MLPs' up
projection and ``lm_head``, and with ``--experts`` the experts of every
MoE op; each rank runs K1f, K1b and K3 on its own rows).  The common set
includes ``--steps-per-call K`` (K steps as one CUDA graph),
``--accum-steps N``, ``--remat`` and ``--zero-opt``.

Example (the shape ``bench.py`` trains the LM at)::

    python -m flexflow_torch.apps.transformer -b 16 --seq 2048 --layers 6 \\
        --vocab 32768 --d-model 512 --heads 8 --optimizer adam --lr 1e-4 \\
        --dtype bfloat16 -i 5

Data parallelism over two cards (each rank at batch 8)::

    python -m flexflow_torch.apps.transformer -ll:gpu 2 --dp 2 -b 16 \\
        --seq 2048 --layers 6 --vocab 32768 --d-model 512 --heads 8 \\
        --optimizer adam --lr 1e-4 --dtype bfloat16 -i 5

Ring attention over four cards (each rank a 2048-token chunk)::

    python -m flexflow_torch.apps.transformer -ll:gpu 4 --sp 4 -b 4 \\
        --seq 8192 --layers 6 --vocab 32768 --d-model 512 --heads 8 \\
        --optimizer adam --lr 1e-4 --dtype bfloat16 -i 2

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
    spawn_ranks,
    world_ranks,
)
from flexflow_torch.models.transformer import (
    build_transformer_lm,
    transformer_strategy,
)


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    full_argv = list(argv)
    seq = pop_int(argv, "--seq", 512)
    vocab = pop_int(argv, "--vocab", 32 * 1024)
    d_model = pop_int(argv, "--d-model", 512)
    heads = pop_int(argv, "--heads", 8)
    layers = pop_int(argv, "--layers", 4)
    parallel = {f: pop_int(argv, f, 1) for f in ("--dp", "--sp", "--tp")}
    experts = pop_int(argv, "--experts", 0)
    cfg = parse_training_args(argv)
    code = spawn_ranks(cfg, "flexflow_torch.apps.transformer:main", full_argv,
                       device, stats_out)
    if code is not None:
        return code
    ranks = world_ranks(cfg, device)
    try:
        strategy = transformer_strategy(
            ranks, layers, dp=parallel["--dp"], sp=parallel["--sp"],
            tp=parallel["--tp"], moe=experts > 0)
        ff = build_transformer_lm(
            batch_size=cfg.batch_size, seq_len=seq, vocab_size=vocab,
            d_model=d_model, num_heads=heads, num_layers=layers,
            moe_experts=experts, config=cfg,
        )
    except ValueError as e:
        raise SystemExit(f"transformer: {e}")
    stats = run_training(ff, cfg, label="sequences", device=device,
                         strategy=strategy)
    print(f"tokens/s = {stats['samples_per_s'] * seq:.0f}")
    if stats_out is not None:
        stats_out.update(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
