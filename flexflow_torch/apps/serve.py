"""Transformer LM serving app: the legacy closed-loop path of
``flexflow_tpu/apps/serve.py`` on one GPU.

Builds the transformer LM at serving shapes with fresh seeded weights
and drives the continuous-batching loop (``runtime/serving.py``) over a
synthetic request stream: pad-to-bucket prefill per admission, K-token
fused decode supersteps with one host readback per superstep, and
admission and eviction between supersteps.

Flags beyond the common set:
  --max-seq N        serving context length (cache rows per slot; 64)
  --max-batch N      decode slots (4)
  --decode-steps K   fused decode tokens per readback (8, clamped 20)
  --buckets A,B,..   prefill pad buckets (default max_seq/4, /2, full)
  --requests N       synthetic request count (8)
  --prompt-len LO:HI prompt length range (4:12)
  --max-new N        generation budget per request (16)
  --eos ID           greedy EOS token id (unset = budget-bounded)
  --no-decode-kernel decode through the plain einsum attention
  --vocab --d-model --heads --layers   model shape

Every other flag of the JAX app (paged KV, prefix cache, sharding,
sampling, speculation, the scheduler and fleet, the journal, telemetry,
checkpoints) is refused: those slices are still to be ported
(ROADMAP.md queue 1).

Example::

    python -m flexflow_torch.apps.serve --max-seq 128 --max-batch 8 \\
        --buckets 64,128 --requests 16 --prompt-len 4:32 --max-new 32 \\
        --layers 6 --dtype bfloat16
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from flexflow_torch.apps.common import check_help, pop_int, pop_str
from flexflow_torch.config import FFConfig
from flexflow_torch.models.transformer import build_transformer_lm
from flexflow_torch.runtime.serving import (
    Server,
    ServingExecutor,
    synthetic_requests,
)

_DTYPES = ("float32", "bfloat16")


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats block."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    max_seq = pop_int(argv, "--max-seq", 64)
    max_batch = pop_int(argv, "--max-batch", 4)
    decode_steps = pop_int(argv, "--decode-steps", 8)
    n_requests = pop_int(argv, "--requests", 8)
    max_new = pop_int(argv, "--max-new", 16)
    eos = pop_int(argv, "--eos", -1)
    vocab = pop_int(argv, "--vocab", 32 * 1024)
    d_model = pop_int(argv, "--d-model", 512)
    heads = pop_int(argv, "--heads", 8)
    layers = pop_int(argv, "--layers", 4)
    plen_s = pop_str(argv, "--prompt-len", "4:12")
    buckets_s = pop_str(argv, "--buckets", "")
    no_kernel = "--no-decode-kernel" in argv
    if no_kernel:
        argv.remove("--no-decode-kernel")
    common = []
    for flag in ("--dtype", "--seed"):
        if flag in argv:
            i = argv.index(flag)
            common += argv[i:i + 2]
            del argv[i:i + 2]
    if argv:
        raise SystemExit(
            f"flexflow_torch serve does not support {argv} yet: this slice "
            f"of the port serves the padded, greedy, single-GPU path; the "
            f"other serving features are queued in ROADMAP.md queue 1"
        )
    try:
        cfg = FFConfig.parse_args(common)
    except ValueError as e:
        raise SystemExit(str(e))
    if cfg.compute_dtype not in _DTYPES:
        raise SystemExit(f"--dtype expects one of {_DTYPES}, got "
                         f"{cfg.compute_dtype!r}")
    try:
        lo, hi = (int(v) for v in plen_s.split(":"))
    except ValueError:
        raise SystemExit("--prompt-len expects LO:HI")
    if buckets_s:
        buckets = tuple(int(b) for b in buckets_s.split(","))
    else:
        buckets = tuple(sorted({max(max_seq // 4, hi), max_seq // 2,
                                max_seq}))
    buckets = tuple(b for b in buckets if b <= max_seq)

    ff = build_transformer_lm(
        batch_size=max_batch, seq_len=max_seq, vocab_size=vocab,
        d_model=d_model, num_heads=heads, num_layers=layers, config=cfg,
    )
    sex = ServingExecutor(
        ff, cfg, max_batch=max_batch, max_seq=max_seq, buckets=buckets,
        decode_kernel=False if no_kernel else None, device=device,
    )
    params, state = sex.init(cfg.seed)
    requests = synthetic_requests(
        n_requests, vocab, prompt_len=(lo, hi), max_new_tokens=max_new,
        seed=cfg.seed,
    )
    srv = Server(sex, params, state, decode_steps=decode_steps,
                 eos_id=None if eos < 0 else eos)
    t0 = time.perf_counter()
    results, stats = srv.run(requests)
    elapsed = time.perf_counter() - t0
    if stats_out is not None:
        stats_out.update(stats)
    print(f"requests = {stats['requests']} "
          f"completed = {stats['completed']} failed = {stats['failed']}")
    print(f"time = {elapsed:.4f}s")
    print(f"tokens/s = {stats['tokens_per_s']:.1f}")
    print(f"request latency p50 = {stats['request_latency_ms_p50']:.1f} ms "
          f"p95 = {stats['request_latency_ms_p95']:.1f} ms")
    print(f"decode supersteps = {stats['decode_supersteps']} "
          f"(k={stats['decode_steps_per_call']}, 1 readback per superstep)")
    if stats["failed"]:
        for rid in sorted(results):
            if results[rid].error:
                print(f"request {rid} FAILED: {results[rid].error}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
