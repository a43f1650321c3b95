"""Transformer LM serving app: the closed-loop path of
``flexflow_tpu/apps/serve.py`` on one GPU.

Builds the transformer LM at serving shapes with fresh seeded weights
and drives the continuous-batching loop (``runtime/serving.py``) over a
synthetic request stream: pad-to-bucket prefill per admission, K-token
decode supersteps (one CUDA graph and one host readback per superstep
on a GPU), and admission and eviction between supersteps.

Flags beyond the common set:
  --max-seq N        serving context length (cache rows per slot; 64)
  --max-batch N      decode slots (4)
  --decode-steps K   decode tokens per readback (8, clamped 20)
  --buckets A,B,..   prefill pad buckets (default max_seq/4, /2, full)
  --requests N       synthetic request count (8)
  --prompt-len LO:HI prompt length range (4:12)
  --max-new N        generation budget per request (16)
  --eos ID           greedy EOS token id (unset = budget-bounded)
  --no-decode-kernel decode through the plain einsum attention
  --vocab --d-model --heads --layers   model shape

Capacity flags:
  --kv-block N       paged KV caches: N-token blocks and per-slot block
                     tables instead of pad-to-max_seq rows (0 = padded;
                     N must divide max_seq)
  --kv-blocks N      paged pool size incl. the scratch block (default:
                     the worst case, max_batch * max_seq/kv_block + 1)
  --prefix-cache     prefix sharing on the paged pool (needs --kv-block):
                     resident full-block prompt prefixes are shared at
                     admission, their prefill skipped

Speculation flags:
  --speculate d      draft d tokens and verify d+1 in one round; each
                     round emits accepted+1 tokens (clamped at 20).  The
                     output equals plain decode's.
  --draft-layers L   self-draft through the first L transformer blocks
                     (0 = the full model, acceptance 1.0)

Sampling flags (greedy stays the default):
  --temperature T    temperature sampling on the device (0 = greedy)
  --top-k N          sample among the N largest logits (0 = all)
  --sample-seed S    draws keyed by (S, request id, position): the same
                     tokens whatever the batch or the superstep length

Refused by name, with the ROADMAP.md queue 1 item that brings each:
sharding, checkpoints, the journal and failure model, the scheduler and
fleet, and telemetry.  Any other unknown flag is refused too.

Example::

    python -m flexflow_torch.apps.serve --max-seq 128 --max-batch 8 \\
        --buckets 64,128 --requests 16 --prompt-len 4:32 --max-new 32 \\
        --layers 6 --dtype bfloat16 --kv-block 16 --prefix-cache
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from flexflow_torch.apps.common import check_help, pop_float, pop_int, pop_str
from flexflow_torch.config import FFConfig
from flexflow_torch.models.transformer import build_transformer_lm
from flexflow_torch.runtime.serving import (
    Server,
    ServingExecutor,
    synthetic_requests,
)

_DTYPES = ("float32", "bfloat16")

#: The JAX app's flags this port does not serve yet, with the ROADMAP.md
#: queue 1 item that brings each.
UNPORTED = {
    "--shard": "item 9 (multi-device strategies)",
    "--draft-ckpt": "item 7 (checkpoints)",
    "--ckpt-dir": "item 7 (checkpoints)",
    "--journal": "item 4's next slice (the journal) and item 7",
    "--serve-retries": "item 4's next slice (the failure model) and item 7",
    "--serve-max-restarts": "item 4's next slice (the failure model) and "
                            "item 7",
    "--expire-waiting": "item 4's next slice (the failure model) and item 7",
    "--retry-backoff-ms": "item 4's next slice (the failure model) and "
                          "item 7",
    "--telemetry": "item 7 (telemetry)",
    **{f: "item 8 (the scheduler and fleet)" for f in (
        "--sched", "--workload-trace", "--trace-alpha", "--mean-gap-ms",
        "--burst", "--slo-ms", "--priorities", "--shed-depth",
        "--serve-auto", "--replicas", "--router", "--calibration")},
}


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats block and, under ``"results"``, the
    per-request results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    for flag, item in UNPORTED.items():
        if flag in argv:
            raise SystemExit(f"flexflow_torch serve does not support {flag} "
                             f"yet: it comes with ROADMAP.md queue 1 {item}")
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
    kv_block = pop_int(argv, "--kv-block", 0)
    kv_blocks = pop_int(argv, "--kv-blocks", 0)
    temperature = pop_float(argv, "--temperature", 0.0)
    top_k = pop_int(argv, "--top-k", 0)
    sample_seed = pop_int(argv, "--sample-seed", 0)
    speculate = pop_int(argv, "--speculate", 0)
    draft_layers = pop_int(argv, "--draft-layers", 0)
    switches = {}
    for flag in ("--no-decode-kernel", "--prefix-cache"):
        switches[flag] = flag in argv
        if switches[flag]:
            argv.remove(flag)
    common = []
    for flag in ("--dtype", "--seed"):
        if flag in argv:
            i = argv.index(flag)
            common += argv[i:i + 2]
            del argv[i:i + 2]
    if argv:
        raise SystemExit(
            f"flexflow_torch serve does not support {argv} yet: this slice "
            f"of the port serves the single-GPU path (padded or paged KV, "
            f"prefix cache, sampling, speculation); the other serving "
            f"features are queued in ROADMAP.md queue 1"
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
    if switches["--prefix-cache"] and kv_block <= 0:
        raise SystemExit(
            "--prefix-cache shares blocks of the PAGED pool and needs "
            "--kv-block N")
    if speculate < 0:
        raise SystemExit(f"--speculate expects d >= 0, got {speculate}")
    if draft_layers and not speculate:
        raise SystemExit(
            "--draft-layers configures the DRAFT source and needs "
            "--speculate d to arm speculation")
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
    try:
        sex = ServingExecutor(
            ff, cfg, max_batch=max_batch, max_seq=max_seq, buckets=buckets,
            decode_kernel=False if switches["--no-decode-kernel"] else None,
            device=device, kv_block=kv_block, kv_blocks=kv_blocks or None,
            prefix_cache=switches["--prefix-cache"],
            draft_layers=draft_layers,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    params, state = sex.init(cfg.seed)
    requests = synthetic_requests(
        n_requests, vocab, prompt_len=(lo, hi), max_new_tokens=max_new,
        seed=cfg.seed,
    )
    srv = Server(sex, params, state, decode_steps=decode_steps,
                 eos_id=None if eos < 0 else eos, temperature=temperature,
                 top_k=top_k, sample_seed=sample_seed, speculate=speculate)
    t0 = time.perf_counter()
    results, stats = srv.run(requests)
    elapsed = time.perf_counter() - t0
    if stats_out is not None:
        stats_out.update(stats)
        stats_out["results"] = results
    print(f"requests = {stats['requests']} "
          f"completed = {stats['completed']} failed = {stats['failed']}")
    _print_layout(stats)
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


def _print_layout(stats) -> None:
    if stats.get("kv_layout") == "paged":
        print(f"kv layout = paged ({stats['kv_blocks']} x "
              f"{stats['kv_block']}-token blocks incl. scratch)")
    if stats.get("prefix_cache"):
        print(f"prefix cache = {stats['prefix_hits']} hits "
              f"(rate {stats['prefix_hit_rate'] * 100:.1f}%), "
              f"{stats['prefill_tokens_saved']} prefill tokens saved, "
              f"{stats['kv_cows']} CoW blocks")
    if stats.get("sampled"):
        print("sampling = seeded temperature/top-k (replayable)")
    if stats.get("speculate"):
        print(f"speculation = d={stats['speculate']} "
              f"(draft_layers={stats['draft_layers']}, acceptance "
              f"{stats['spec_acceptance_rate'] * 100:.1f}%, "
              f"{stats['spec_tokens_per_dispatch']:.2f} tokens/"
              f"dispatch, {stats['draft_prefills']} draft prefills)")


if __name__ == "__main__":
    sys.exit(main())
