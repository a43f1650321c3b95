"""Transformer LM serving app: the closed-loop path of
``flexflow_tpu/apps/serve.py`` on one GPU.

Builds the transformer LM at serving shapes, restores its params from a
training checkpoint when ``--ckpt-dir`` names one (the train-to-serve
handoff, ``ServingExecutor.restore``; fresh seeded weights otherwise),
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
  --draft-ckpt PATH  restore the draft's params from their own training
                     checkpoint (same architecture; default: the
                     serving params, a self-draft)

Checkpoint flags:
  --ckpt-dir PATH    serve the params of the latest readable step of a
                     training checkpoint directory (``apps.transformer
                     --ckpt-dir PATH`` at the same model flags)

Sampling flags (greedy stays the default):
  --temperature T    temperature sampling on the device (0 = greedy)
  --top-k N          sample among the N largest logits (0 = all)
  --sample-seed S    draws keyed by (S, request id, position): the same
                     tokens whatever the batch or the superstep length

Failure-model flags of the plain loop:
  --journal PATH     append-only request journal: a run on a journal
                     with records restores its completed requests and
                     resumes its in-flight ones; SIGTERM drains at the
                     next superstep boundary (re-run with the same
                     --journal to serve the rest)
  --dry-run          print the program table (cache, prefill per bucket,
                     decode, spec), traced on meta tensors: no device
                     compute, no kernel launch

Refused by name, with the ROADMAP.md queue 1 item that brings each:
sharding, the scheduler's failure model, the scheduler and fleet, and
the serving loop's telemetry.  Any other unknown flag is refused too.

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
from flexflow_torch.serving.journal import RequestJournal

_DTYPES = ("float32", "bfloat16")

#: The JAX app's flags this port does not serve yet, with the ROADMAP.md
#: queue 1 item that brings each.
UNPORTED = {
    "--shard": "item 9 (multi-device strategies)",
    **{f: "item 8 (the scheduler's failure model)" for f in (
        "--serve-retries", "--serve-max-restarts", "--expire-waiting",
        "--retry-backoff-ms")},
    "--telemetry": "item 7's rest (the serving loop's telemetry events)",
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
    journal_path = pop_str(argv, "--journal", "")
    ckpt_dir = pop_str(argv, "--ckpt-dir", "")
    draft_ckpt = pop_str(argv, "--draft-ckpt", "")
    switches = {}
    for flag in ("--no-decode-kernel", "--prefix-cache", "--dry-run"):
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
    if (draft_ckpt or draft_layers) and not speculate:
        raise SystemExit(
            "--draft-ckpt/--draft-layers configure the DRAFT source and "
            "need --speculate d to arm speculation")
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
            # The dry run traces on meta tensors and needs no device.
            device="meta" if switches["--dry-run"] else device,
            kv_block=kv_block, kv_blocks=kv_blocks or None,
            prefix_cache=switches["--prefix-cache"],
            draft_layers=draft_layers,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    if switches["--dry-run"]:
        return _dry_run(sex, decode_steps, speculate)
    if ckpt_dir:
        step, params, state = sex.restore(ckpt_dir)
        print(f"restored training checkpoint step {step} from {ckpt_dir}")
    else:
        params, state = sex.init(cfg.seed)
    draft_params = None
    if draft_ckpt:
        dstep, draft_params, _ds = sex.restore(draft_ckpt)
        print(f"restored draft checkpoint step {dstep} from {draft_ckpt}")
    requests = synthetic_requests(
        n_requests, vocab, prompt_len=(lo, hi), max_new_tokens=max_new,
        seed=cfg.seed,
    )
    srv = Server(sex, params, state, decode_steps=decode_steps,
                 eos_id=None if eos < 0 else eos, temperature=temperature,
                 top_k=top_k, sample_seed=sample_seed, speculate=speculate,
                 journal=RequestJournal(journal_path) if journal_path
                 else None, draft_params=draft_params)
    t0 = time.perf_counter()
    results, stats = srv.run(requests)
    elapsed = time.perf_counter() - t0
    if stats_out is not None:
        stats_out.update(stats)
        stats_out["results"] = results
    print(f"requests = {stats['requests']} "
          f"completed = {stats['completed']} failed = {stats['failed']}")
    _print_layout(stats)
    if stats.get("drained"):
        print(f"drained: remainder journaled in {journal_path or '?'} "
              f"(re-run with the same --journal to resume)")
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


def _dry_run(sex, decode_steps: int, speculate: int = 0) -> int:
    """The serving dry run: the program table of
    ``ServingExecutor.abstract_programs`` (traced on meta tensors), in
    the JAX app's layout.  JAX's dry run then runs its program audit,
    which comes with ROADMAP.md queue 1 item 14."""
    table = sex.abstract_programs(decode_steps=decode_steps,
                                  speculate=speculate)
    print(f"{'program':<18} {'shape':<28} notes")
    for name, t in sorted(table["cache"].items()):
        print(f"{'cache ' + name:<18} {str(tuple(t.shape)):<28} "
              f"{str(t.dtype).replace('torch.', '')}")
    for bucket in sorted(table["prefill"]):
        print(f"{'prefill L=' + str(bucket):<18} "
              f"{'(1, ' + str(bucket) + ') -> token':<28} "
              f"1 dispatch + 1 fence per admission")
    for bucket in sorted(table.get("prefill_from", {})):
        o = sex.kv_block
        print(f"{'prefill L=' + str(bucket) + ' o=' + str(o):<18} "
              f"{'(1, ' + str(bucket) + ') from row ' + str(o):<28} "
              f"offset prefill (shared prefix skipped)")
    shape = tuple(table["decode"].shape)
    print(f"{'decode k=' + str(shape[0]):<18} {str(shape) + ' tokens':<28} "
          f"1 dispatch + 1 fence per {shape[0]} tokens")
    if speculate:
        shape = tuple(table["spec"].shape)
        print(f"{'spec d=' + str(speculate):<18} "
              f"{str(shape) + ' tokens':<28} 1 dispatch + 1 fence per round "
              f"(<= {speculate + 1} accepted)")
    print("DRY RUN OK (no device compute)")
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
