"""Transformer LM serving app: ``flexflow_tpu/apps/serve.py`` on one
GPU or sharded over a world of ranks, the closed loop and the scheduled
one.

Builds the transformer LM at serving shapes, restores its params from a
training checkpoint when ``--ckpt-dir`` names one (the train-to-serve
handoff, ``ServingExecutor.restore``; fresh seeded weights otherwise),
and drives the continuous-batching loop (``runtime/serving.py``) over a
synthetic request stream: pad-to-bucket prefill per admission, K-token
decode supersteps (one CUDA graph and one host readback per superstep
on a GPU), and admission and eviction between supersteps.  Any
scheduler flag below runs the SLO scheduler (``serving/scheduler.py``)
over the same programs instead.

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
  --shard N,C        shard the decode batch over mesh axis n and the KV
                     heads over c (``ServingExecutor(shard=(n, c))``):
                     outside a world the app runs on a world of N*C ranks
                     (``parallel/launch.py``: gloo on the CPU, NCCL a card
                     a rank when the machine has N*C cards) and prints
                     rank 0's report; with fewer cards it falls back
                     loudly to the single-mesh engine on one.  Each rank
                     writes its own --journal (rank r > 0: PATH.rank{r});
                     --telemetry under more than one rank and --dry-run
                     with --shard are refused (ROADMAP.md items 9d, 14)

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

Scheduler flags (any of them, a fleet flag, or a failure-model flag
below but --journal, runs the SLO scheduler of ``serving/scheduler.py``:
open-loop arrivals on a virtual clock, tier + EDF admission, adaptive
decode k, preemption and shedding; every latency it prints is in virtual
ms):
  --sched POLICY     fifo | slo (slo when another scheduler flag is given)
  --workload-trace [zipf|prod[:alpha=A,prefix=P]]  the open-loop workload
                     (zipf-skewed lengths, bursts) instead of the uniform
                     stream; ``prod`` reads the prompt tokens from the data
                     plane's production trace (``data/trace.py``: id skew
                     A, default 1.2) with the same lengths and arrivals,
                     ``prefix=P`` a shared P-token system-prompt span
  --trace-alpha A    zipf skew of prompt and output lengths (1.5)
  --mean-gap-ms X    mean gap between bursts, virtual ms (8.0)
  --burst N          requests per burst (4)
  --slo-ms X         tier-0 SLO, virtual ms (tier t gets X * (t + 1);
                     unset = best effort)
  --priorities N     priority tiers, 0 highest (1)
  --shed-depth N     shed waiting requests past this queue depth (0 = off)
  --calibration PATH the serving latency model's run log (a file, or a
                     telemetry dir's latest run); default: the latest run
                     under --telemetry's dir, else the model defaults
  --serve-auto       search buckets x k x max_batch x adaptive k (x the
                     paged block and the prefix cache when paged, x d when
                     speculating, x replicas and router for a fleet)
                     against the latency model by simulating the
                     scheduler over the workload, and serve the winner
                     (``serving/search.py``); prints the predicted against
                     the measured p99 and dispatches

Fleet flags (``serving/fleet.py``):
  --replicas N       N scheduled replicas, each with its own executor,
                     caches and decode graphs (replica 0 reuses the app's
                     executor), behind one router on the shared virtual
                     clock; a replica whose restart budget runs out is
                     dropped and its journaled work moves to the
                     survivors; when the last one dies the app exits 78
                     (EXIT_FLEET_FAILURE)
  --router POLICY    least-loaded | tier-aware | affinity (least-loaded)

Failure-model flags:
  --journal PATH     append-only request journal: a run on a journal
                     with records restores its completed requests and
                     resumes its in-flight ones; SIGTERM drains at the
                     next superstep boundary (re-run with the same
                     --journal to serve the rest).  Plain or scheduled;
                     a fleet journals replica i to PATH.r{i}.
  --serve-retries N  retries per request for slot faults (virtual-clock
                     exponential backoff; scheduled)
  --retry-backoff-ms X  backoff base, virtual ms (8.0)
  --serve-max-restarts N  engine-restart budget (default --max-restarts
                     when the failure model is armed); exhausted, the app
                     exits 77 (EXIT_SERVING_FAILURE)
  --expire-waiting   expire waiting requests past their deadline (SLO
                     misses)

Telemetry and checks:
  --telemetry DIR    the run's JSONL event stream under DIR (read it with
                     ``python -m flexflow_torch.obs report|request DIR``)
  --dry-run          print the program table (cache, prefill per bucket,
                     one decode program per k the scheduler may choose,
                     spec), traced on meta tensors: no device compute, no
                     kernel launch

Refused: any flag the JAX app does not take.

Example::

    python -m flexflow_torch.apps.serve --max-seq 128 --max-batch 8 \\
        --buckets 64,128 --requests 16 --prompt-len 4:32 --max-new 32 \\
        --layers 6 --dtype bfloat16 --kv-block 16 --prefix-cache
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

from flexflow_torch.apps.common import check_help, pop_float, pop_int, pop_str
from flexflow_torch.config import FFConfig
from flexflow_torch.models.transformer import build_transformer_lm
from flexflow_torch.parallel import launch
from flexflow_torch.runtime import telemetry as _telemetry
from flexflow_torch.runtime.trainer import relay_safe_steps
from flexflow_torch.runtime.serving import (
    EXIT_SERVING_FAILURE,
    Server,
    ServingCrashLoop,
    ServingExecutor,
    synthetic_requests,
)
from flexflow_torch.serving import (
    EXIT_FLEET_FAILURE,
    ROUTER_POLICIES,
    FleetCrashLoop,
    FleetRouter,
    RequestJournal,
    ScheduledServer,
    SchedulerPolicy,
    ServingConfig,
    ServingLatencyModel,
    ServingResilience,
    SlotShape,
    WorkloadSpec,
    make_workload,
    production_workload,
    search_serving_config,
    uniform_workload,
)

_DTYPES = ("float32", "bfloat16")


def _pop_flag(argv, flag) -> bool:
    if flag in argv:
        argv.remove(flag)
        return True
    return False


def _pop_opt_str(argv, flag):
    """A flag with an optional value: absent None, bare "", ``--flag v``
    "v" (a following ``-...`` token is not taken)."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
        val = argv[i + 1]
        del argv[i:i + 2]
        return val
    del argv[i]
    return ""


def main(argv=None, device="cuda", stats_out: Optional[dict] = None) -> int:
    """Run the app; returns its exit code.  ``device="cpu"`` runs the
    plain kernel versions on the CPU (tests); ``stats_out``, when given,
    receives the run's stats block and, under ``"results"``, the
    per-request results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    check_help(argv, __doc__)
    argv0 = list(argv)
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
    no_kernel = _pop_flag(argv, "--no-decode-kernel")
    prefix_cache = _pop_flag(argv, "--prefix-cache")
    dry_run = _pop_flag(argv, "--dry-run")
    # The scheduler's flags (JAX's names and meanings).
    sched_s = pop_str(argv, "--sched", "")
    workload_trace = _pop_opt_str(argv, "--workload-trace")
    trace_alpha = pop_float(argv, "--trace-alpha", 1.5)
    mean_gap_ms = pop_float(argv, "--mean-gap-ms", 8.0)
    burst = pop_int(argv, "--burst", 4)
    slo_ms = pop_float(argv, "--slo-ms", 0.0)
    priorities = pop_int(argv, "--priorities", 0)
    shed_depth = pop_int(argv, "--shed-depth", 0)
    serve_retries = pop_int(argv, "--serve-retries", 0)
    retry_backoff_ms = pop_float(argv, "--retry-backoff-ms", 8.0)
    serve_max_restarts = pop_int(argv, "--serve-max-restarts", -1)
    expire_waiting = _pop_flag(argv, "--expire-waiting")
    serve_auto = _pop_flag(argv, "--serve-auto")
    router_given = "--router" in argv
    replicas = pop_int(argv, "--replicas", 1)
    router = pop_str(argv, "--router", "least-loaded")
    shard_s = pop_str(argv, "--shard", "")
    common = []
    for flag in ("--dtype", "--seed", "--telemetry", "--calibration",
                 "--max-restarts"):
        if flag in argv:
            i = argv.index(flag)
            common += argv[i:i + 2]
            del argv[i:i + 2]
    if argv:
        raise SystemExit(
            f"flexflow_torch serve does not support {argv} yet: this slice "
            f"of the port serves one GPU (padded or paged KV, prefix cache, "
            f"sampling, speculation, the scheduler and its failure model, "
            f"telemetry); the other serving features are queued in "
            f"ROADMAP.md queue 1"
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
    if sched_s and sched_s not in ("fifo", "slo"):
        raise SystemExit(f"--sched expects fifo|slo, got {sched_s!r}")
    if workload_trace not in (None, "", "zipf") \
            and not workload_trace.startswith("prod"):
        raise SystemExit(
            f"--workload-trace expects nothing, 'zipf' or "
            f"'prod[:alpha=A,prefix=P]', got {workload_trace!r}")
    if prefix_cache and kv_block <= 0:
        raise SystemExit(
            "--prefix-cache shares blocks of the PAGED pool and needs "
            "--kv-block N")
    if speculate < 0:
        raise SystemExit(f"--speculate expects d >= 0, got {speculate}")
    if replicas < 1:
        raise SystemExit(f"--replicas expects N >= 1, got {replicas}")
    if router not in ROUTER_POLICIES:
        raise SystemExit(f"--router expects {'|'.join(ROUTER_POLICIES)}, "
                         f"got {router!r}")
    if (draft_ckpt or draft_layers) and not speculate:
        raise SystemExit(
            "--draft-ckpt/--draft-layers configure the DRAFT source and "
            "need --speculate d to arm speculation")
    shard = None
    if shard_s:
        try:
            sn, sc = (int(v) for v in shard_s.split(","))
        except ValueError:
            raise SystemExit("--shard expects N,C (e.g. --shard 2,2)")
        shard = (sn, sc)
        if dry_run:
            raise SystemExit("--dry-run with --shard (the rank-local "
                             "programs on meta tensors) is ROADMAP.md queue "
                             "1, item 14")
    ranks = launch.world_size() if launch.in_world() or not shard \
        else _shard_ranks(shard, device)
    if ranks > 1 and (cfg.telemetry_dir or os.environ.get("FF_TELEMETRY_DIR")):
        raise SystemExit(f"--shard under {ranks} ranks: --telemetry is "
                         f"ROADMAP.md queue 1, item 9d")
    if ranks > 1 and not launch.in_world():
        return _spawn_shard(argv0, ranks, device, stats_out)
    if buckets_s:
        buckets = tuple(int(b) for b in buckets_s.split(","))
    else:
        buckets = tuple(sorted({max(max_seq // 4, hi), max_seq // 2,
                                max_seq}))
    buckets = tuple(b for b in buckets if b <= max_seq)
    models = {}

    def make_executor():
        """An executor at the current config, which ``--serve-auto`` may
        change; the model is built once per ``max_batch``."""
        if max_batch not in models:
            models[max_batch] = build_transformer_lm(
                batch_size=max_batch, seq_len=max_seq, vocab_size=vocab,
                d_model=d_model, num_heads=heads, num_layers=layers,
                config=cfg)
        try:
            return ServingExecutor(
                models[max_batch], cfg, max_batch=max_batch, max_seq=max_seq,
                buckets=buckets, decode_kernel=False if no_kernel else None,
                # The dry run traces on meta tensors and needs no device.
                device="meta" if dry_run else device,
                kv_block=kv_block, kv_blocks=kv_blocks or None,
                prefix_cache=prefix_cache, draft_layers=draft_layers,
                shard=shard,
            )
        except ValueError as e:
            raise SystemExit(str(e))

    def weights():
        if ckpt_dir:
            step, params, state = sex.restore(ckpt_dir)
            print(f"restored training checkpoint step {step} from {ckpt_dir}")
        else:
            params, state = sex.init(cfg.seed)
        draft_params = None
        if draft_ckpt:
            dstep, draft_params, _ds = sex.restore(draft_ckpt)
            print(f"restored draft checkpoint step {dstep} from "
                  f"{draft_ckpt}")
        return params, state, draft_params

    def journal(path):
        """A journal at ``path``; each rank of a world keeps its own (rank
        r > 0 at ``path.rank{r}``), so no two ranks write one file."""
        if not journal_path:
            return None
        r = launch.rank()
        return RequestJournal(f"{path}.rank{r}" if r else path)

    # Retries, expiry and restarts are scheduler semantics (virtual-clock
    # backoff); the journal alone stays on either path.
    use_sched = bool(sched_s or workload_trace is not None or slo_ms > 0
                     or priorities > 0 or shed_depth > 0 or serve_auto
                     or serve_retries > 0 or serve_max_restarts >= 0
                     or expire_waiting or replicas > 1 or router_given)
    if not use_sched:
        sex = make_executor()
        with _telemetry.maybe_run(cfg, meta={"app": "serve"}):
            if dry_run:
                return _dry_run(sex, [decode_steps], speculate)
            params, state, draft_params = weights()
            requests = synthetic_requests(
                n_requests, vocab, prompt_len=(lo, hi),
                max_new_tokens=max_new, seed=cfg.seed)
            srv = Server(sex, params, state, decode_steps=decode_steps,
                         eos_id=None if eos < 0 else eos,
                         temperature=temperature, top_k=top_k,
                         sample_seed=sample_seed, speculate=speculate,
                         journal=journal(journal_path),
                         draft_params=draft_params)
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
        print(f"request latency p50 = "
              f"{stats['request_latency_ms_p50']:.1f} ms "
              f"p95 = {stats['request_latency_ms_p95']:.1f} ms")
        print(f"decode supersteps = {stats['decode_supersteps']} "
              f"(k={stats['decode_steps_per_call']}, 1 readback per "
              f"superstep)")
        return _report_failures(results, stats)

    # -- the scheduled path (JAX's _run_scheduled) --
    decode_steps = relay_safe_steps(decode_steps, what="decode_steps")
    resilience = ServingResilience(
        max_retries=serve_retries, retry_backoff_ms=retry_backoff_ms,
        max_restarts=(serve_max_restarts if serve_max_restarts >= 0
                      else cfg.max_restarts),
        expire_waiting=expire_waiting,
    ) if (serve_retries > 0 or serve_max_restarts >= 0 or expire_waiting
          or journal_path) else None
    base_slo = slo_ms if slo_ms > 0 else float("inf")
    policy = (SchedulerPolicy.fifo() if sched_s == "fifo"
              else SchedulerPolicy(name="slo", shed_depth=shed_depth))
    with _telemetry.maybe_run(cfg, meta={"app": "serve"}):
        model = _latency_model(cfg)
        if workload_trace is not None:
            spec = WorkloadSpec(
                n_requests=n_requests, vocab=vocab, prompt_len=(lo, hi),
                prompt_alpha=trace_alpha, max_new=(1, max_new),
                output_alpha=trace_alpha, mean_gap_ms=mean_gap_ms,
                burst=burst, priorities=max(priorities, 1),
                slo_ms=base_slo, seed=cfg.seed)
            if workload_trace.startswith("prod"):
                requests = _production_requests(spec, workload_trace)
            else:
                requests = make_workload(spec)
        else:
            requests = uniform_workload(
                n_requests, vocab, prompt_len=(lo, hi),
                max_new_tokens=max_new, seed=cfg.seed, slo_ms=base_slo)
        choice = None
        if serve_auto:
            baseline = ServingConfig(
                buckets=buckets, decode_steps=decode_steps,
                max_batch=max_batch, max_seq=max_seq, policy=policy,
                kv_block=kv_block, kv_blocks=kv_blocks or None,
                prefix_cache=prefix_cache, shard=shard, speculate=speculate,
                replicas=replicas, router=router)
            res = search_serving_config(requests, baseline, model)
            choice = res.chosen
            if choice.config.to_json() == baseline.to_json():
                print("serve-auto: the app's default serving config "
                      "already wins the searched space; keeping it")
            print(res.describe())
            print(f"serve-auto: {model.describe()}")
            c = choice.config
            buckets, decode_steps, max_batch = (c.buckets, c.decode_steps,
                                                c.max_batch)
            policy, kv_block, kv_blocks = c.policy, c.kv_block, \
                c.kv_blocks or 0
            prefix_cache, speculate = c.prefix_cache, c.speculate
            replicas, router = c.replicas, c.router
            _telemetry.current().emit(
                "search", kind="serving", chosen=c.to_json(),
                baseline=res.baseline.config.to_json(),
                predicted_p99_ms=round(choice.predicted_p99_ms, 4),
                baseline_predicted_p99_ms=round(
                    res.baseline.predicted_p99_ms, 4),
                predicted_dispatches=choice.predicted_dispatches,
                latency_model=model.to_json(),
                candidates=len(res.candidates),
                wall_s=round(res.wall_s, 3))
        sex = make_executor()
        srv_proto = ScheduledServer.simulated(
            SlotShape(max_batch=max_batch, max_seq=max_seq, buckets=buckets,
                      kv_block=kv_block, kv_blocks=kv_blocks or None,
                      prefix_cache=prefix_cache),
            decode_steps=decode_steps, policy=policy, latency_model=model)
        if dry_run:
            return _dry_run(sex, srv_proto._k_candidates, speculate,
                            replicas, router)
        params, state, draft_params = weights()

        def make_server(sex_i, journal_i):
            return ScheduledServer(
                sex_i, params, state, decode_steps=decode_steps,
                eos_id=None if eos < 0 else eos, policy=policy,
                latency_model=model, temperature=temperature, top_k=top_k,
                sample_seed=sample_seed, resilience=resilience,
                journal=journal_i, speculate=speculate,
                draft_params=draft_params)

        t0 = time.perf_counter()
        if replicas > 1:
            # Replica 0 reuses the executor built above, each peer gets
            # its own (programs, caches, graphs); params are shared.
            # --journal PATH fans out to PATH.r{i}, the medium of
            # redistribution.
            srv = FleetRouter([
                make_server(sex if i == 0 else make_executor(),
                            journal(f"{journal_path}.r{i}"))
                for i in range(replicas)], router=router)
            try:
                results, stats = srv.run(requests)
            except FleetCrashLoop as e:
                print(f"fleet crash: {e}", file=sys.stderr)
                print(f"exiting {EXIT_FLEET_FAILURE} for the external "
                      f"supervisor (every replica's restart budget "
                      f"exhausted; the per-replica journals carry "
                      f"completed + in-flight state)")
                return EXIT_FLEET_FAILURE
        else:
            srv = make_server(sex, journal(journal_path))
            try:
                results, stats = srv.run(requests)
            except ServingCrashLoop as e:
                print(f"serving crash loop: {e}", file=sys.stderr)
                print(f"exiting {EXIT_SERVING_FAILURE} for the external "
                      f"supervisor (engine restart budget exhausted; the "
                      f"journal carries completed + in-flight state)")
                return EXIT_SERVING_FAILURE
        elapsed = time.perf_counter() - t0
    if stats_out is not None:
        stats_out.update(stats)
        stats_out["results"] = results
        stats_out["decisions"] = srv.decisions
        if replicas > 1:
            stats_out["merged_decisions"] = srv.merged_decisions()
    print(f"policy = {policy.describe()}")
    if replicas > 1:
        print(f"fleet = {stats['replicas']} replicas "
              f"router={stats['router']} "
              f"live={stats['live_replicas']} "
              f"dead={stats['dead_replicas']} "
              f"redistributed={stats['redistributed']}")
    print(f"latency model = {model.describe()}")
    print(f"requests = {stats['requests']} "
          f"completed = {stats['completed']} failed = {stats['failed']} "
          f"shed = {stats['request_sheds']} "
          f"preempted = {stats['request_preempts']}")
    _print_layout(stats)
    print(f"time = {elapsed:.4f}s")
    print(f"tokens/s = {stats['tokens_per_s']:.1f}")
    print(f"queue wait p50 = {stats['queue_wait_ms_p50']:.1f} ms "
          f"p95 = {stats['queue_wait_ms_p95']:.1f} ms "
          f"p99 = {stats['queue_wait_ms_p99']:.1f} ms (virtual)")
    print(f"e2e p50 = {stats['e2e_ms_p50']:.1f} ms "
          f"p99 = {stats['e2e_ms_p99']:.1f} ms (virtual)")
    if "slo_attainment" in stats:
        print(f"SLO attainment = {stats['slo_attainment'] * 100:.1f}%")
    for tier, row in (stats.get("slo_autopsy") or {}).items():
        # Waterfalls: python -m flexflow_torch.obs request DIR
        print(f"slo autopsy tier {tier}: {row['missed']} missed, "
              f"dominant phase = {row['dominant_phase']}")
    print(f"decode supersteps = {stats['decode_supersteps']} "
          f"(k<={stats['decode_steps_per_call']}, 1 dispatch + 1 fence "
          f"per superstep)")
    if stats.get("request_retries") or stats.get("request_expiries") \
            or stats.get("engine_restarts"):
        print(f"failure model: retries = {stats['request_retries']} "
              f"expiries = {stats['request_expiries']} "
              f"engine restarts = {stats['engine_restarts']}")
    if stats.get("degraded_rungs"):
        print(f"DEGRADED: rungs taken = "
              f"{', '.join(stats['degraded_rungs'])}")
    if stats.get("drained"):
        print(f"drained: remainder journaled in {journal_path or '?'} "
              f"(re-run with the same --journal to resume)")
    if choice is not None:
        print(f"serve-auto: predicted e2e p99 "
              f"{choice.predicted_p99_ms:.3f} ms, measured "
              f"{stats['e2e_ms_p99']:.3f} ms (virtual clock); "
              f"predicted dispatches {choice.predicted_dispatches}, "
              f"executed {stats['prefills'] + stats['decode_supersteps']}")
    return _report_failures(results, stats)


def _shard_ranks(shard, device) -> int:
    """The ranks ``--shard N,C`` runs on from outside a world: ``N * C``
    (gloo on the CPU; NCCL a card a rank), or 1 on a machine with fewer
    cards, where the executor falls back loudly to the single-mesh
    engine, as JAX's does."""
    import torch

    n = shard[0] * shard[1]
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n:
        return 1
    return n


def _spawn_shard(argv, n: int, device, stats_out) -> int:
    """The app on each rank of a new world of ``n``; returns the first
    non-zero exit code of the ranks, else 0, with rank 0's stats in
    ``stats_out``."""
    import torch

    kind = torch.device(device).type
    try:
        ranks = launch.run("flexflow_torch.apps.common:rank_app",
                           ("flexflow_torch.apps.serve:main", list(argv),
                            kind), nprocs=n, device=kind)
    except Exception as e:  # a rank's failure, with its traceback above
        raise SystemExit(f"--shard: {type(e).__name__}: {e}")
    if stats_out is not None:
        stats_out.update(ranks[0][1])
    return next((code for code, _ in ranks if code), 0)


def _production_requests(spec, workload_trace: str):
    """``--workload-trace prod[:alpha=A,prefix=P]``: JAX's parsing, then
    ``production_workload``."""
    args = workload_trace[5:] if workload_trace.startswith("prod:") else ""
    kv = dict(p.split("=", 1) for p in args.split(",") if p)
    id_alpha = float(kv.pop("alpha", 1.2))
    shared_prefix = int(kv.pop("prefix", 0))
    if kv:
        raise SystemExit(
            f"--workload-trace prod: unknown args {sorted(kv)} "
            f"(supported: alpha=A, prefix=P)")
    if shared_prefix:
        spec = dataclasses.replace(spec, shared_prefix=shared_prefix)
    return production_workload(spec, id_alpha=id_alpha)


def _latency_model(cfg) -> ServingLatencyModel:
    """The scheduler's latency model, as JAX's ``_latency_model`` resolves
    it: ``--calibration PATH`` (a run log, or a dir's latest run) wins,
    else the latest run under the telemetry dir (not the active run's own
    file, which holds nothing yet); that run's calibration block and
    serving events fit it (``ServingLatencyModel.from_run``).  No run:
    the model defaults."""
    from flexflow_torch.obs.reader import RunLog, latest_run

    active = _telemetry.current().path
    src = cfg.search_calibration or cfg.telemetry_dir or \
        os.environ.get("FF_TELEMETRY_DIR")
    path = latest_run(src, exclude=active) if src and os.path.isdir(src) \
        else src
    if not path or not os.path.isfile(path):
        return ServingLatencyModel()
    return ServingLatencyModel.from_run(RunLog.load(path))


def _dry_run(sex, decode_ks, speculate: int = 0, replicas: int = 1,
             router: str = "least-loaded") -> int:
    """The serving dry run: the program table of
    ``ServingExecutor.abstract_programs`` (traced on meta tensors), in
    the JAX app's layout, with one decode row per k the run may dispatch
    (the scheduler's adaptive candidates).  JAX's dry run then runs its
    program audit, which comes with ROADMAP.md queue 1 item 14."""
    decode_ks = sorted(set(decode_ks))
    table = sex.abstract_programs(decode_steps=decode_ks[-1],
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
    for k in decode_ks:
        shape = (k,) + tuple(table["decode"].shape[1:])
        print(f"{'decode k=' + str(k):<18} {str(shape) + ' tokens':<28} "
              f"1 dispatch + 1 fence per {k} tokens")
    if speculate:
        shape = tuple(table["spec"].shape)
        print(f"{'spec d=' + str(speculate):<18} "
              f"{str(shape) + ' tokens':<28} 1 dispatch + 1 fence per round "
              f"(<= {speculate + 1} accepted)")
    if replicas > 1:
        # Routing is host-side: every replica builds this same program
        # family.
        print(f"fleet: {replicas} replicas (router={router}) x the "
              f"program family above; no extra programs")
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
    if stats.get("shard"):
        n, c = stats["shard"]
        print(f"mesh shard = batch n={n} x heads c={c}")
    if stats.get("sampled"):
        print("sampling = seeded temperature/top-k (replayable)")
    if stats.get("speculate"):
        print(f"speculation = d={stats['speculate']} "
              f"(draft_layers={stats['draft_layers']}, acceptance "
              f"{stats['spec_acceptance_rate'] * 100:.1f}%, "
              f"{stats['spec_tokens_per_dispatch']:.2f} tokens/"
              f"dispatch, {stats['draft_prefills']} draft prefills)")


def _report_failures(results, stats) -> int:
    if stats["failed"]:
        for rid in sorted(results):
            if results[rid].error:
                print(f"request {rid} FAILED: {results[rid].error}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
