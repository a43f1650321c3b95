"""Headline benchmarks of the port on one NVIDIA GPU: the counterpart of
the repo's ``bench.py``.

Run from the root of a checkout on a machine with a CUDA GPU::

    python -m flexflow_torch.bench

Prints ONE JSON line on stdout (everything else goes to stderr), with
``bench.py``'s metric names, formulas and protocols: the primary metric
is AlexNet images/s/chip (batch 2048, 229 x 229 x 3, 1000 classes,
bf16, SGD lr 0.01 momentum 0.9 wd 1e-4, 3 warmup + 20 timed steps);
``extra`` carries the DLRM leg (the ``run_random.sh`` shape on the
row-sparse path, 2 + 10 steps), the LM legs at 2k (2 + 10), 8k (2 + 5)
and 32k (2 + 3), each with its MFU against the H100's dense bf16 peak,
the superstep sweep (``superstep``: ms/step of a small MLP at k = 1, 4,
8 and 16 steps per call, the k > 1 ones as CUDA graphs), the serving leg
(``serving``: bench.py's columns that the port computes, decode
supersteps as CUDA graphs; the scheduler's fifo/slo A/B, tail autopsy,
failure-model, prefix-workload and fleet columns in virtual ms), the NMT
leg (``nmt_pairs_per_s`` and ``nmt_10iter_time_s``: batch 64, 2 layers, hidden = embed = 2048, vocab
20480, seq 20, bf16, SGD lr 0.01, 2 + 10 steps), the Candle-Uno leg
(``candle_samples_per_s``: the reference's widths, batch 512, bf16, SGD
lr 0.01, 2 + 10 steps), the telemetry leg (``telemetry``: bench.py's
fences/step, step-time percentiles and the telemetry-on overhead of a
small MLP) and the card's name and power limit.  Throughput
is ``iterations x batch / elapsed`` with one fence at the end
(``Trainer.fit``); the flops come from
``search/cost_model.py::train_flops``.  A leg that fails becomes
``<leg>_error`` and does not sink the headline.  Without a CUDA device
the line carries ``"value": null`` and the error; nothing is measured
on the CPU.

The pipeline leg (``pipeline``: ``bench.py``'s ms a step of a
layer-wise MLP at S = 2 and 4 stages, m = 4 and 8 microbatches, chunk 1
and m, host-driven and compiled, and k = 8 pipeline supersteps) and the
telemetry leg's ``programs_per_step`` run on a world of one card a rank
over NCCL; on fewer than 2 cards the leg reports ``skipped`` in
``bench.py``'s words and measures nothing.  ``bench.py``'s other legs
(data plane, search, op-parallel) wait for their slices of the port
(ROADMAP.md queue 1).  The leg functions take the device and their
sizes as arguments, so a test can run them small on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import traceback

#: 4xV100 AlexNet target, per chip: the ICML'18-era 1500 img/s total
#: that the repo's BASELINE.json names (the reference publishes no
#: absolute number).  Measured neither on a TPU nor on an H100.
BASELINE_IMGS_PER_SEC_PER_CHIP = 1500.0 / 4.0

#: H100 SXM dense bf16 peak (NVIDIA data sheet).
H100_BF16_PEAK_FLOPS = 989e12

#: The LM legs: (metric prefix, batch, seq, timed iterations), 6 layers
#: (``bench.py:251-308``).
LM_LEGS = (("transformer", 16, 2048, 10), ("transformer_8k", 4, 8192, 5),
           ("transformer_32k", 1, 32768, 3))


def _mfu(ff, samples_per_s: float, batch: int) -> float:
    from flexflow_torch.search.cost_model import train_flops

    return train_flops(ff) / batch * samples_per_s / H100_BF16_PEAK_FLOPS


def bench_alexnet(device="cuda", batch_size: int = 2048,
                  image_size: int = 229, num_classes: int = 1000,
                  iters: int = 20, warmup: int = 3,
                  stats_out: dict | None = None):
    """Returns (images/s per chip, mfu, batch size); ``stats_out``, when
    given, receives the fit stats.  On the GPU cuDNN times its plans
    (``ops.conv.time_conv_plans``) in the warmup steps."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.ops.conv import time_conv_plans
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    time_conv_plans(device)
    cfg = FFConfig(batch_size=batch_size, compute_dtype="bfloat16")
    ff = build_alexnet(batch_size=batch_size, image_size=image_size,
                       num_classes=num_classes, config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(
        lr=0.01, momentum=0.9, weight_decay=1e-4), device=device)
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    if stats_out is not None:
        stats_out.update(stats)
    sps = stats["samples_per_s"]
    return sps, _mfu(ff, sps, batch_size), batch_size


def bench_dlrm(device="cuda", vocab: int = 1_000_000, batch: int = 256,
               iters: int = 10, warmup: int = 2):
    """The ``run_random.sh`` shape (8 x ``vocab`` x 64 tables), plain
    SGD lr 0.01, the tables on the row-sparse path (K4 and K5).  Returns
    (samples/s, mfu).  A failure raises: ``bench.py``'s dense fallback
    would stand a path without K5 in for the one that failed."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.dlrm import build_dlrm, dlrm_random_benchmark_config
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    dlrm = dlrm_random_benchmark_config(num_tables=8)
    dlrm.embedding_size = [vocab] * 8

    cfg = FFConfig(batch_size=batch, compute_dtype="bfloat16",
                   sparse_embedding_updates=True)
    ff = build_dlrm(batch, dlrm, config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(lr=0.01), device=device)
    if not ex._sparse_ops:
        raise RuntimeError("the DLRM tables are not on the row-sparse path")
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    return stats["samples_per_s"], _mfu(ff, stats["samples_per_s"], batch)


def _bench_lm(batch: int, seq: int, iters: int, device="cuda",
              layers: int = 6, vocab: int = 32768, d_model: int = 512,
              heads: int = 8, warmup: int = 2):
    """One GPT-style LM measurement, Adam lr 1e-4.  Returns (tokens/s,
    mfu)."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.optim import AdamOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    cfg = FFConfig(batch_size=batch, compute_dtype="bfloat16")
    ff = build_transformer_lm(batch_size=batch, seq_len=seq, vocab_size=vocab,
                              d_model=d_model, num_heads=heads,
                              num_layers=layers, config=cfg)
    ex = Executor(ff, cfg, optimizer=AdamOptimizer(lr=1e-4), device=device)
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    return stats["samples_per_s"] * seq, _mfu(ff, stats["samples_per_s"], batch)


def bench_superstep(device="cuda", batch: int = 64, width: int = 256,
                    iters: int = 32) -> dict:
    """``bench.py``'s dispatch-amortization sweep (``bench_superstep``)
    at its one-chip TPU sizes: an MLP (``width`` -> ``width`` ReLU -> 8
    classes, SGD lr 0.01 momentum 0.9) whose step is far cheaper than
    its launches, trained ``iters`` steps at k = 1, 4, 8 and 16 steps
    per call (``Trainer.fit(steps_per_call=k)``: at k > 1 one CUDA graph
    per call and one host readback).  Returns ms/step per k and the k =
    8 amortization factor."""
    import torch

    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    ff = FFModel(FFConfig(batch_size=batch, seed=3))
    x = ff.create_tensor((batch, width), name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
    t = ff.dense(x, width, activation="relu", name="fc1")
    t = ff.dense(t, 8, name="fc2")
    ff.softmax(t, lbl, name="softmax")
    ex = Executor(ff, optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
                  device=device)
    out = {"batch_size": batch, "iterations": iters}
    for k in (1, 4, 8, 16):
        stats = Trainer(ex).fit(iterations=iters, warmup=1, steps_per_call=k)
        out[f"k{k}_ms_per_step"] = round(stats["elapsed_s"] / iters * 1e3, 3)
    out["amortization_k8_vs_k1"] = round(
        out["k1_ms_per_step"] / out["k8_ms_per_step"], 3)
    return out


def bench_telemetry(device="cuda", batch: int = 64, width: int = 256,
                    iters: int = 32, ranks: int | None = None) -> dict:
    """``bench.py``'s run-telemetry leg (``bench_telemetry``) at its
    one-chip TPU sizes: bench.py's MLP (``width`` -> ``width`` ReLU -> 8
    classes, SGD lr 0.01 momentum 0.9) trained ``iters`` steps with
    in-memory telemetry (counters and percentiles, no JSONL) and
    without, in two pairs (on, off, on, off) in this process.
    Returns fences/step, the host step-time p50/p95/max of the last
    telemetry run, and the overhead of telemetry over the summed
    elapsed times.  ``FF_TELEMETRY_DIR`` is unset around the legs, so
    the "off" fits are off.  With ``ranks`` >= 2 (by default the
    visible cards), ``programs_per_step``: a two-stage layer-wise run at
    m = 4, chunk 4, on a world of that many ranks
    (:func:`pipeline_programs_rank`); on one device the JAX leg leaves it
    out too."""
    import os

    import torch

    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.telemetry import Telemetry
    from flexflow_torch.runtime.trainer import Trainer

    def build():
        ff = FFModel(FFConfig(batch_size=batch, seed=7))
        x = ff.create_tensor((batch, width), name="x")
        lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
        t = ff.dense(x, width, activation="relu", name="fc1")
        t = ff.dense(t, 8, name="fc2")
        ff.softmax(t, lbl, name="softmax")
        return Executor(ff, optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
                        device=device)

    env_dir = os.environ.pop("FF_TELEMETRY_DIR", None)
    on_s = off_s = 0.0
    try:
        for _ in range(2):
            with Telemetry():
                on = Trainer(build()).fit(iterations=iters, warmup=1)
            off = Trainer(build()).fit(iterations=iters, warmup=1)
            on_s += on["elapsed_s"]
            off_s += off["elapsed_s"]
    finally:
        if env_dir is not None:
            os.environ["FF_TELEMETRY_DIR"] = env_dir
    t = on["telemetry"]
    out = {
        "batch_size": batch,
        "iterations": iters,
        "fences_per_step": t.get("fences_per_step"),
        "step_ms_p50": t.get("step_ms_p50"),
        "step_ms_p95": t.get("step_ms_p95"),
        "step_ms_max": t.get("step_ms_max"),
        "overhead_pct": round((on_s - off_s) / off_s * 100, 2),
    }
    nd = _world_size(device, ranks)
    if nd >= 2:
        out["programs_per_step"] = _pipeline_world(
            "pipeline_programs_rank", device, nd, batch, width)
    return out


def _world_size(device, ranks: int | None) -> int:
    """The ranks of a leg's world: ``ranks``, or the visible cards."""
    import torch

    if ranks is not None:
        return ranks
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def _pipeline_world(body: str, device, nd: int, *args):
    """Rank 0's result of ``body`` on a world of ``nd`` ranks: NCCL a card
    a rank on CUDA, gloo on the CPU."""
    import torch

    from flexflow_torch.parallel import launch

    kind = torch.device(device).type
    return launch.run(f"flexflow_torch.bench:{body}", (kind, *args),
                      nprocs=nd, device=kind)[0]


def _pipeline_mlp(batch: int, width: int, depth: int, seed: int):
    """``bench.py``'s pipeline MLP: ``depth`` ReLU layers of ``width``, an
    8-class head and the loss."""
    import torch

    from flexflow_torch.config import FFConfig
    from flexflow_torch.graph import FFModel

    ff = FFModel(FFConfig(batch_size=batch, seed=seed))
    x = ff.create_tensor((batch, width), name="x")
    lbl = ff.create_tensor((batch,), dtype=torch.int32, name="label")
    t = x
    for i in range(depth):
        t = ff.dense(t, width, activation="relu", name=f"fc{i}")
    t = ff.dense(t, 8, name="head")
    ff.softmax(t, lbl, name="softmax")
    return ff


def _pipeline_store(S: int, nd: int, names):
    """``bench.py``'s layer-wise table: ``names`` in order over ``S``
    stages of ``nd // S`` ranks each, data-parallel within a stage."""
    from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore

    st = StrategyStore(nd)
    per = nd // S
    for i, name in enumerate(names):
        si = min(i * S // len(names), S - 1)
        st.set(name, ParallelConfig(
            n=per, device_ids=tuple(range(si * per, (si + 1) * per))))
    return st


def pipeline_programs_rank(device: str, batch: int, width: int):
    """Rank body of the telemetry leg's ``programs_per_step``
    (``bench.py:575-598``): a two-stage run (``fc0``; ``head`` and the
    loss) at m = 4, chunk 4, 1 + 4 steps under in-memory telemetry."""
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.parallel import launch
    from flexflow_torch.runtime.pipeline import PipelineExecutor
    from flexflow_torch.runtime.telemetry import Telemetry
    from flexflow_torch.runtime.trainer import Trainer

    nd = launch.world_size()
    ff = _pipeline_mlp(batch, width, 1, 7)
    pipe = PipelineExecutor(
        ff, _pipeline_store(2, nd, ["fc0", "head", "softmax"]),
        optimizer=SGDOptimizer(lr=0.01, momentum=0.9), device=device,
        microbatches=4, chunk=4)
    with Telemetry() as ptel:
        _quiet(lambda: Trainer(pipe).fit(iterations=4, warmup=1))
    return ptel.step_summary().get("programs_per_step")


def _quiet(fn):
    """``fn()`` with its report lines swallowed."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def pipeline_rank(device: str, batch: int, width: int, iters: int,
                  stages, micro, k: int) -> dict:
    """Rank body of :func:`bench_pipeline`: ``bench.py``'s sweep on this
    world (``bench.py:398-565``)."""
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.parallel import launch
    from flexflow_torch.runtime.pipeline import PipelineExecutor
    from flexflow_torch.runtime.trainer import Trainer

    nd, depth = launch.world_size(), 4
    names = [f"fc{i}" for i in range(depth)] + ["head", "softmax"]
    ff = _pipeline_mlp(batch, width, depth, 5)

    def fit(S, mb, steps_per_call=1, warmup=1, **kw):
        pipe = PipelineExecutor(
            ff, _pipeline_store(S, nd, names),
            optimizer=SGDOptimizer(lr=0.01, momentum=0.9), device=device,
            microbatches=mb, **kw)
        stats = _quiet(lambda: Trainer(pipe).fit(
            iterations=iters, warmup=warmup, steps_per_call=steps_per_call))
        return round(stats["elapsed_s"] / iters * 1e3, 3), \
            len(pipe.last_schedule)

    out = {}
    sweep = [S for S in stages if S <= nd]
    for S in sweep:
        for mb in micro:
            for c in (1, mb):
                key = f"s{S}_mb{mb}_c{c}"
                out[f"{key}_ms_per_step"], out[f"{key}_programs"] = fit(
                    S, mb, chunk=c)
            key = f"s{S}_mb{mb}_compiled"
            out[f"{key}_ms_per_step"], out[f"{key}_programs"] = fit(
                S, mb, compiled=True)
    S, mb = sweep[-1], micro[-1]
    out["chunk_amortization"] = round(
        out[f"s{S}_mb{mb}_c1_ms_per_step"]
        / out[f"s{S}_mb{mb}_c{mb}_ms_per_step"], 3)
    out["compiled_speedup"] = round(
        out[f"s{S}_mb{mb}_c{mb}_ms_per_step"]
        / out[f"s{S}_mb{mb}_compiled_ms_per_step"], 3)
    # k steps under one fence: host-driven (amortized) and compiled (one
    # fused superstep, a CUDA graph a rank over NCCL).
    out[f"superstep_k{k}_ms_per_step"], _ = fit(
        sweep[0], micro[0], steps_per_call=k, chunk=micro[0])
    out[f"superstep_k{k}_compiled_ms_per_step"], _ = fit(
        sweep[0], micro[0], steps_per_call=k, warmup=k, compiled=True)
    return out


def bench_pipeline(device="cuda", width: int = 256, iters: int = 16,
                   ranks: int | None = None, batch: int | None = None,
                   stages=(2, 4), micro=(4, 8), k: int = 8) -> dict:
    """``bench.py``'s layer-wise pipeline leg (``bench_pipeline``): an
    MLP of four ReLU layers of ``width`` (batch 64 a rank), S stages x m
    microbatches at chunk 1 and m (``*_programs``: the step's events,
    ``2 S ceil(m/c)``) and compiled (1 program a step), then k = 8
    pipeline supersteps host-driven and compiled; ``iters`` timed steps
    after one warmup (a superstep of warmup compiled).  Runs on a world
    of ``ranks`` (the visible cards by default), NCCL a card a rank;
    below 2 it reports why it skipped, in ``bench.py``'s words."""
    nd = _world_size(device, ranks)
    batch = batch or 64 * nd
    out = {"batch_size": batch, "iterations": iters, "n_devices": nd}
    if not [S for S in stages if S <= nd]:
        out["skipped"] = (f"{nd} device(s): pipeline stages need distinct "
                          f"device subsets (>= 2 devices)")
        return out
    out.update(_pipeline_world("pipeline_rank", device, nd, batch, width,
                               iters, tuple(stages), tuple(micro), k))
    return out


#: The serving leg's injected faults (``bench.py``'s): a NaN'd cache row
#: of slot 0 before decode superstep 1, an engine fault before 3.
SCHED_FAULTS = dict(nan_cache_at={1: 0},
                    engine_raise_at={3: "injected engine fault"})


def sched_workload(n_req: int, vocab: int, max_seq: int, max_new: int,
                   shared_prefix: int = 0):
    """``bench.py``'s bursty open-loop workload: 2 x ``n_req`` requests
    of 4 to ``max_seq / 4`` prompt tokens and 2 to ``max_new`` new ones,
    bursts of ``n_req`` 2 virtual ms apart on average, 2 tiers, tier-0
    SLO 60 virtual ms, seed 13; ``shared_prefix`` arms its shared
    system-prompt span."""
    from flexflow_torch.serving import WorkloadSpec, make_workload

    return make_workload(WorkloadSpec(
        n_requests=2 * n_req, vocab=vocab, prompt_len=(4, max_seq // 4),
        max_new=(2, max_new), mean_gap_ms=2.0, burst=n_req, priorities=2,
        slo_ms=60.0, shared_prefix=shared_prefix, seed=13))


def sched_columns(runs: dict) -> dict:
    """``bench.py``'s scheduler columns, its names and formulas, from the
    ``(results, stats)`` of the leg's scheduled runs: ``slo`` and
    ``fifo`` (the A/B and the slo run's tail autopsy), ``failure`` (the
    slo run under :data:`SCHED_FAULTS` with one retry and one restart),
    ``prefix_on`` / ``prefix_off`` (the shared-prefix workload on the
    paged pool with and without the prefix cache).  Every latency column
    is in virtual ms."""
    slo, fifo = runs["slo"][1], runs["fifo"][1]
    out = {k: slo[k] for k in (
        "queue_wait_ms_p50", "queue_wait_ms_p95", "queue_wait_ms_p99",
        "e2e_ms_p99", "slo_attainment", "request_sheds", "request_preempts")}
    out["fifo_queue_wait_ms_p99"] = fifo["queue_wait_ms_p99"]
    out["fifo_slo_attainment"] = fifo["slo_attainment"]
    out["fifo_vs_slo_queue_wait_p99"] = round(
        fifo["queue_wait_ms_p99"] / max(slo["queue_wait_ms_p99"], 1e-9), 3)
    autopsy = slo.get("slo_autopsy") or {}
    out["slo_missed"] = sum(r["missed"] for r in autopsy.values())
    out["slo_dominant_phase"] = {
        tier: row["dominant_phase"] for tier, row in autopsy.items()}
    for k in ("request_retries", "request_expiries", "engine_restarts"):
        out[k] = runs["failure"][1][k]
    (on_res, on), (off_res, off) = runs["prefix_on"], runs["prefix_off"]
    out["prefix_hits"] = on["prefix_hits"]
    out["prefix_hit_rate"] = on["prefix_hit_rate"]
    out["prefill_tokens_saved"] = on["prefill_tokens_saved"]
    out["prefix_kv_cows"] = on["kv_cows"]
    out["prefix_prefills"] = on["prefills"]
    out["prefix_off_prefills"] = off["prefills"]
    out["prefix_match"] = all(
        on_res[r].tokens == off_res[r].tokens for r in off_res)
    return out


def fleet_columns(fleet: dict, loss: dict, slo: dict) -> dict:
    """``bench.py``'s fleet columns, its names and formulas, from the
    stats of the leg's 2-replica least-loaded fleet over the bursty
    workload (``fleet``), of the same fleet with replica 0 killed before
    its decode superstep 1 (``loss``), and of the single-replica slo run
    (``slo``).  Virtual ms."""
    return {
        "fleet_replicas": fleet["replicas"],
        "fleet_router": fleet["router"],
        "fleet_queue_wait_ms_p99": fleet["queue_wait_ms_p99"],
        "fleet_slo_attainment": fleet["slo_attainment"],
        "fleet_vs_single_attainment": round(
            fleet["slo_attainment"] / max(slo["slo_attainment"], 1e-9), 3),
        "fleet_dead_replicas": loss["dead_replicas"],
        "fleet_redistributed": loss["redistributed"],
        "fleet_loss_slo_attainment": loss["slo_attainment"],
    }


def bench_serving(device="cuda", vocab: int = 32768, d_model: int = 512,
                  heads: int = 8, layers: int = 6, max_seq: int = 128,
                  max_batch: int = 8, n_req: int = 16, max_new: int = 32,
                  kv_block: int = 16, dtype: str = "bfloat16",
                  speculate: int = 12) -> dict:
    """``bench.py``'s serving leg (``bench_serving``) at its TPU sizes:
    the LM's continuous-batching loop over 16 synthetic requests (seed
    13, prompts of 4 to max_seq / 4 tokens), each Server run once to warm
    (on CUDA: build and capture its graphs) and once measured.  Columns:
    the K = 1 and K = 8 decode supersteps (tokens/s, decode ms/token,
    their ratio, the K = 8 latencies); the paged layout's capacity (HBM
    per slot, the batch the padded cache's budget admits in each layout)
    and tokens/s at K = 8; the sharded engine at ``shard=(2, 1)``
    (:func:`sharded_serving`: ``sharded_mesh``, its tokens/s and their
    ratio to the K = 8 single-mesh run's; with fewer than two cards the
    executor's fallback engine is the K = 8 run's, whose stats then
    stand for it); a d = ``speculate`` full self-draft against
    plain K = 8 (tokens per decode dispatch, acceptance, and whether the
    tokens match).  Then ``bench.py``'s scheduler columns over its bursty
    workload (2 x ``n_req`` requests, ``mean_gap_ms`` 2, bursts of
    ``n_req``, 2 tiers, ``slo_ms`` 60, seed 13), each ``ScheduledServer``
    run once: the slo policy against fifo (queue wait, e2e p99, SLO
    attainment, sheds, preemptions), the slo run's tail autopsy, the
    failure model (a NaN'd cache before superstep 1 and an engine fault
    before superstep 3 under one retry and one restart), and the
    prefix workload (a ``kv_block``-token shared span) on the paged pool
    with and without the prefix cache; and the fleet columns
    (:func:`fleet_columns`: 2 replicas behind the least-loaded router,
    each with its own executor and journal, with and without the loss of
    replica 0).  Every scheduler latency column is in virtual ms
    (``serving/latency_model.py``, the model defaults)."""
    from flexflow_torch.runtime.serving import (ServingExecutor,
                                                ServingFaultInjector)
    from flexflow_torch.serving import (
        FleetRouter, MemoryJournal, ScheduledServer, SchedulerPolicy,
        ServingResilience)

    lm = dict(vocab=vocab, d_model=d_model, heads=heads, layers=layers,
              max_seq=max_seq, max_batch=max_batch, n_req=n_req,
              max_new=max_new, dtype=dtype)
    ff = _serving_lm(lm)
    buckets = (max_seq // 2, max_seq)
    sex = ServingExecutor(ff, max_batch=max_batch, max_seq=max_seq,
                          buckets=buckets, device=device)
    params, state = sex.init(0)
    out = {"max_batch": max_batch, "max_seq": max_seq, "requests": n_req}

    def measured(engine, **kw):
        return serving_run(engine, params, state, lm, **kw)

    k8_stats = None
    for k in (1, 8):
        _res, stats = measured(sex, decode_steps=k)
        decode_tokens = max(stats["tokens"] - stats["prefills"], 1)
        out[f"k{k}_tokens_per_s"] = round(stats["tokens_per_s"], 1)
        out[f"k{k}_decode_ms_per_token"] = round(
            stats["decode_s"] / decode_tokens * 1e3, 3)
        if k == 8:
            k8_stats = stats
    out["fused_speedup_k8_vs_k1"] = round(
        out["k1_decode_ms_per_token"] / out["k8_decode_ms_per_token"], 3)
    out["request_latency_ms_p50"] = k8_stats["request_latency_ms_p50"]
    out["request_latency_ms_p95"] = k8_stats["request_latency_ms_p95"]
    out["programs_per_decode_superstep"] = k8_stats[
        "programs_per_decode_superstep"]

    sexp = ServingExecutor(ff, max_batch=max_batch, max_seq=max_seq,
                           buckets=buckets, device=device, kv_block=kv_block)
    plen = 4
    out["hbm_per_slot_bytes"] = sex.hbm_per_slot_bytes()
    out["paged_hbm_per_slot_bytes"] = sexp.hbm_per_slot_bytes(plen, max_new)
    budget = sex.cache_total_bytes()
    out["padded_max_admitted_batch"] = sex.max_admissible_batch(
        budget, plen, max_new)
    out["paged_max_admitted_batch"] = sexp.max_admissible_batch(
        budget, plen, max_new)
    out["paged_tokens_per_s"] = round(
        measured(sexp, decode_steps=8)[1]["tokens_per_s"], 1)
    # bench.py's sharded columns at shard=(2, 1): a world of 2 over NCCL
    # where the machine has two cards.  Elsewhere the executor takes JAX's
    # fallback to the single-mesh engine, which is the K = 8 run's, so
    # that run's stats stand for it (``sharded_mesh`` None).
    sstats = sharded_serving(device, lm) or dict(k8_stats, shard=None)
    out["sharded_mesh"] = sstats["shard"]
    out["sharded_tokens_per_s"] = round(sstats["tokens_per_s"], 1)
    out["sharded_vs_single_mesh_tokens_per_s"] = round(
        out["sharded_tokens_per_s"] / max(out["k8_tokens_per_s"], 1e-9), 3)

    plain_res, _ = measured(sex, decode_steps=8)
    spec_res, spec_stats = measured(sex, decode_steps=8, speculate=speculate)
    out["speculate"] = spec_stats["speculate"]
    out["spec_tokens_per_s"] = round(spec_stats["tokens_per_s"], 1)
    out["spec_acceptance_rate"] = spec_stats["spec_acceptance_rate"]
    out["spec_tokens_per_dispatch"] = spec_stats["spec_tokens_per_dispatch"]
    plain_tpd = (k8_stats["tokens"] - k8_stats["prefills"]) / max(
        k8_stats["decode_supersteps"], 1)
    out["plain_tokens_per_dispatch"] = round(plain_tpd, 3)
    out["spec_vs_plain_tokens_per_dispatch"] = round(
        spec_stats["spec_tokens_per_dispatch"] / max(plain_tpd, 1e-9), 3)
    out["spec_match"] = all(
        spec_res[r].tokens == plain_res[r].tokens for r in plain_res)

    # -- the scheduler's columns, bench.py's formulas --
    slo_kw = dict(policy=SchedulerPolicy(name="slo"), decode_steps=8)
    runs = {
        "slo": ScheduledServer(sex, params, state, **slo_kw).run(
            sched_workload(n_req, vocab, max_seq, max_new)),
        "fifo": ScheduledServer(sex, params, state, decode_steps=8,
                                policy=SchedulerPolicy.fifo()).run(
            sched_workload(n_req, vocab, max_seq, max_new)),
        "failure": ScheduledServer(
            sex, params, state, **slo_kw,
            resilience=ServingResilience(max_retries=1, max_restarts=1),
            fault_injector=ServingFaultInjector(**SCHED_FAULTS)).run(
            sched_workload(n_req, vocab, max_seq, max_new)),
    }
    sexpc = ServingExecutor(ff, max_batch=max_batch, max_seq=max_seq,
                            buckets=buckets, device=device,
                            kv_block=kv_block, prefix_cache=True)
    for tag, engine in (("prefix_off", sexp), ("prefix_on", sexpc)):
        runs[tag] = ScheduledServer(engine, params, state, **slo_kw).run(
            sched_workload(n_req, vocab, max_seq, max_new, kv_block))
    out.update(sched_columns(runs))

    # -- the fleet's columns: replica 0 on the leg's executor, replica 1 on
    # its own, the same weights from the same seed --
    sexf = ServingExecutor(ff, max_batch=max_batch, max_seq=max_seq,
                           buckets=buckets, device=device)
    pf, sf = sexf.init(0)

    def fleet(injected):
        return FleetRouter([ScheduledServer(
            ex_i, p_i, s_i, **slo_kw,
            resilience=ServingResilience(max_restarts=0),
            journal=MemoryJournal(),
            fault_injector=ServingFaultInjector(
                engine_raise_at={1: "injected replica death"})
            if injected and i == 0 else None)
            for i, (ex_i, p_i, s_i) in enumerate(
                ((sex, params, state), (sexf, pf, sf)))],
            router="least-loaded").run(
            sched_workload(n_req, vocab, max_seq, max_new))[1]

    out.update(fleet_columns(fleet(False), fleet(True), runs["slo"][1]))
    return out


def _serving_lm(lm: dict):
    """The serving leg's LM at the sizes ``lm`` (:func:`bench_serving`'s
    arguments by name, ``heads`` and ``layers`` its count of each)."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm

    return build_transformer_lm(
        batch_size=lm["max_batch"], seq_len=lm["max_seq"],
        vocab_size=lm["vocab"], d_model=lm["d_model"],
        num_heads=lm["heads"], num_layers=lm["layers"],
        config=FFConfig(batch_size=lm["max_batch"],
                        compute_dtype=lm["dtype"]))


def serving_run(engine, params, state, lm: dict, **server_kw):
    """One ``Server(engine, ...)`` over the leg's ``n_req`` synthetic
    requests (seed 13, prompts of 4 to max_seq / 4 tokens), run once to
    warm (on CUDA: build and capture its graphs outside the measure) and
    once measured: the measured run's ``(results, stats)``."""
    from flexflow_torch.runtime.serving import Server, synthetic_requests

    def reqs():
        return synthetic_requests(lm["n_req"], lm["vocab"],
                                  prompt_len=(4, lm["max_seq"] // 4),
                                  max_new_tokens=lm["max_new"], seed=13)

    srv = Server(engine, params, state, **server_kw)
    srv.run(reqs())
    return srv.run(reqs())


def sharded_serving_rank(lm: dict, device: str = "cuda",
                         shard=(2, 1)) -> dict:
    """The serving leg's K = 8 run (:func:`serving_run`) on this rank's
    ``ServingExecutor(shard=shard)``: the measured run's stats."""
    from flexflow_torch.runtime.serving import ServingExecutor

    ex = ServingExecutor(_serving_lm(lm), max_batch=lm["max_batch"],
                         max_seq=lm["max_seq"],
                         buckets=(lm["max_seq"] // 2, lm["max_seq"]),
                         device=device, shard=shard)
    params, state = ex.init(0)
    return {k: v for k, v in serving_run(ex, params, state, lm,
                                         decode_steps=8)[1].items()
            if k in ("shard", "tokens_per_s", "decode_s",
                     "decode_supersteps", "tokens")}


def sharded_serving(device: str, lm: dict, shard=(2, 1)):
    """:func:`sharded_serving_rank` on a world of ``n * c`` ranks over
    NCCL, one card a rank: rank 0's stats; None where the machine has
    fewer cards (the executor would fall back to one engine, as JAX's
    does on one device)."""
    import torch

    from flexflow_torch.parallel import launch

    n = shard[0] * shard[1]
    if torch.device(device).type != "cuda" or torch.cuda.device_count() < n:
        return None
    return launch.run("flexflow_torch.bench:sharded_serving_rank",
                      (lm, "cuda", shard), nprocs=n, device="cuda")[0]


def bench_nmt(device="cuda", batch: int = 64, hidden: int = 2048,
              vocab: int = 20480, seq: int = 20, iters: int = 10,
              warmup: int = 2, stats_out: dict | None = None):
    """``bench.py:311-336``: the NMT seq2seq LSTM step (``nmt.cc:34-44``
    defaults: batch 64, 2 layers, hidden = embed = 2048, vocab 20480,
    seq 20, bf16, dropout 0.2), SGD lr 0.01 built directly (momentum 0,
    wd 0: the embeddings take the row-sparse path), ``warmup`` + ``iters``
    steps.  Returns (elapsed s, pairs/s, iterations)."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.nmt import build_nmt
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    cfg = FFConfig(batch_size=batch, compute_dtype="bfloat16")
    ff = build_nmt(batch_size=batch, src_len=seq, tgt_len=seq,
                   vocab_size=vocab, embed_dim=hidden, hidden_size=hidden,
                   num_layers=2, config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(lr=0.01), device=device)
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    if stats_out is not None:
        stats_out.update(stats)
    return stats["elapsed_s"], stats["samples_per_s"], iters


def bench_candle(device="cuda", batch: int = 512, iters: int = 10,
                 warmup: int = 2, candle=None,
                 stats_out: dict | None = None) -> float:
    """``bench.py:337-358``: Candle-Uno at the reference's widths
    (``CandleConfig()``: six inputs, 3 x 1000 feature towers and trunk),
    batch 512, bf16, ``SGDOptimizer(lr=0.01)``, ``warmup`` + ``iters``
    steps.  Returns samples/s."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.candle_uno import build_candle_uno
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    cfg = FFConfig(batch_size=batch, compute_dtype="bfloat16")
    ff = build_candle_uno(batch_size=batch, candle=candle, config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(lr=0.01), device=device)
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    if stats_out is not None:
        stats_out.update(stats)
    return stats["samples_per_s"]


def _card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"gpu_name": name.strip(), "gpu_power_limit": limit.strip()}


def _run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's bench measures on the "
                           "GPU only")
    extra = {"platform": "gpu", "n_chips": 1}
    try:
        extra.update(_card())
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        extra["nvidia_smi_error"] = f"{type(e).__name__}: {e}"
    # The apps' report lines go to stderr: stdout carries one JSON line.
    with contextlib.redirect_stdout(sys.stderr):
        per_chip, mfu, batch_size = bench_alexnet()
    extra["batch_size"] = batch_size
    extra["alexnet_mfu"] = round(mfu, 4)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            sps, dlrm_mfu = bench_dlrm()
        extra["dlrm_samples_per_s"] = round(sps, 2)
        extra["dlrm_mfu"] = round(dlrm_mfu, 4)
    except Exception as e:  # DLRM failure must not sink the headline
        extra["dlrm_error"] = f"{type(e).__name__}: {e}"
    for leg, batch, seq, iters in LM_LEGS:
        try:
            with contextlib.redirect_stdout(sys.stderr):
                tps, lm_mfu = _bench_lm(batch, seq, iters)
            extra[f"{leg}_tokens_per_s"] = round(tps, 1)
            extra[f"{leg}_mfu"] = round(lm_mfu, 4)
        except Exception as e:
            extra[f"{leg}_error"] = f"{type(e).__name__}: {e}"
    try:
        with contextlib.redirect_stdout(sys.stderr):
            extra["superstep"] = bench_superstep()
    except Exception as e:
        extra["superstep_error"] = f"{type(e).__name__}: {e}"
    try:
        with contextlib.redirect_stdout(sys.stderr):
            extra["telemetry"] = bench_telemetry()
    except Exception as e:
        extra["telemetry_error"] = f"{type(e).__name__}: {e}"
    try:
        with contextlib.redirect_stdout(sys.stderr):
            extra["pipeline"] = bench_pipeline()
    except Exception as e:
        extra["pipeline_error"] = f"{type(e).__name__}: {e}"
    try:
        with contextlib.redirect_stdout(sys.stderr):
            extra["serving"] = bench_serving()
    except Exception as e:
        extra["serving_error"] = f"{type(e).__name__}: {e}"
    try:
        with contextlib.redirect_stdout(sys.stderr):
            nmt_s, nmt_sps, _iters = bench_nmt()
        extra["nmt_pairs_per_s"] = round(nmt_sps, 2)
        extra["nmt_10iter_time_s"] = round(nmt_s, 4)
    except Exception as e:  # an NMT failure must not sink the headline
        extra["nmt_error"] = f"{type(e).__name__}: {e}"
    try:
        with contextlib.redirect_stdout(sys.stderr):
            extra["candle_samples_per_s"] = round(bench_candle(), 2)
    except Exception as e:  # nor a Candle-Uno failure
        extra["candle_error"] = f"{type(e).__name__}: {e}"
    return {
        "metric": "alexnet_imgs_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "images/s/chip",
        "vs_baseline": round(per_chip / BASELINE_IMGS_PER_SEC_PER_CHIP, 3),
        "extra": extra,
    }


def main() -> int:
    """Print the one JSON line; on a failure of the headline leg (or no
    GPU), ``bench.py``'s error line with ``"value": null``."""
    try:
        result = _run()
    except Exception as e:
        result = {
            "metric": "alexnet_imgs_per_sec_per_chip",
            "value": None,
            "unit": "images/s/chip",
            "vs_baseline": None,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-1500:],
        }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
