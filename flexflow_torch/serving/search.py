"""``--serve-auto``: the serving-config search, the port of
``flexflow_tpu/serving/search.py``, candidate for candidate.

Searches bucket boundaries x decode k x max_batch x the scheduler's
adaptive k (plus the paged block size and the prefix cache when the
baseline is paged, the speculative depth d when the baseline speculates,
and replica count x router policy when the baseline runs a fleet)
against the serving latency model, pricing every candidate by simulating
the real scheduler loop over the real workload
(``ScheduledServer.simulated``, or ``FleetRouter.simulated`` for a fleet
candidate): the decision code that will run the winner, so the predicted
dispatch counts are the executed ones.

Legality is checked when a candidate is built, through
:class:`~flexflow_torch.serving.scheduler.SlotShape`, which mirrors
``ServingExecutor``'s own validation, and the k bounds
(``MAX_DECODE_STEPS_PER_CALL``, the ``relay_safe_steps`` clamp): the
search emits only configs the executor accepts.  The app's own config
competes as a candidate, so the winner's predicted p99 is printed against
it.  The mesh ``shard`` is a deployment fact: every candidate carries the
baseline's, and none is searched.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from flexflow_torch.runtime.serving import Request
from flexflow_torch.runtime.trainer import (
    MAX_STEPS_PER_CALL as MAX_DECODE_STEPS_PER_CALL,
)
from flexflow_torch.serving.fleet import FleetRouter, ROUTER_POLICIES
from flexflow_torch.serving.latency_model import ServingLatencyModel
from flexflow_torch.serving.scheduler import (
    ADAPTIVE_K_CANDIDATES,
    ScheduledServer,
    SchedulerPolicy,
    SlotShape,
)

#: Decode-slot widths the search may propose (with the baseline's, capped
#: by ``max_batch_cap``, the memory budget's stand-in).
BATCH_CANDIDATES = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One executor-legal serving configuration.  Construction is the
    legality check: :class:`SlotShape` runs the executor's bucket and
    paged-pool validation, and the k bounds mirror ``ServingExecutor``
    and the ``relay_safe_steps`` clamp."""

    buckets: Tuple[int, ...]
    decode_steps: int
    max_batch: int
    max_seq: int
    policy: SchedulerPolicy
    #: Cache layout: 0 = padded rows; > 0 = a paged pool of this block
    #: size.
    kv_block: int = 0
    kv_blocks: Optional[int] = None
    #: Prefix sharing on the paged pool (searched on and off).
    prefix_cache: bool = False
    #: Mesh shard (n, c), carried and never searched.
    shard: Optional[Tuple[int, int]] = None
    #: Speculative draft depth (0 = plain fused decode), searched only
    #: when the baseline speculates.
    speculate: int = 0
    #: Fleet shape, searched only when the baseline runs a fleet (its
    #: replica count is the ceiling).
    replicas: int = 1
    router: str = "least-loaded"

    def __post_init__(self):
        shape = self.shape()
        object.__setattr__(self, "buckets", shape.buckets)
        object.__setattr__(self, "kv_blocks", shape.kv_blocks)
        if not (1 <= self.decode_steps <= MAX_DECODE_STEPS_PER_CALL):
            raise ValueError(
                f"decode_steps must be in [1, "
                f"{MAX_DECODE_STEPS_PER_CALL}]: {self.decode_steps}"
            )
        if not (0 <= self.speculate <= MAX_DECODE_STEPS_PER_CALL):
            raise ValueError(
                f"speculate must be in [0, "
                f"{MAX_DECODE_STEPS_PER_CALL}]: {self.speculate}"
            )
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1: {self.replicas}")
        if self.router not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {self.router!r} "
                f"(have: {', '.join(ROUTER_POLICIES)})"
            )

    def shape(self) -> SlotShape:
        return SlotShape(max_batch=self.max_batch, max_seq=self.max_seq,
                         buckets=self.buckets, kv_block=self.kv_block,
                         kv_blocks=self.kv_blocks,
                         prefix_cache=self.prefix_cache)

    def describe(self) -> str:
        bits = (f"buckets={list(self.buckets)} k={self.decode_steps} "
                f"max_batch={self.max_batch}")
        if self.kv_block > 0:
            bits += f" kv={self.kv_blocks}x{self.kv_block}"
        if self.prefix_cache:
            bits += " prefix-cache"
        if self.shard is not None:
            bits += f" shard={self.shard[0]}x{self.shard[1]}"
        if self.speculate > 0:
            bits += f" spec={self.speculate}"
        if self.replicas > 1:
            bits += f" replicas={self.replicas} router={self.router}"
        return bits + f" policy={self.policy.describe()}"

    def to_json(self) -> Dict[str, Any]:
        return {
            "buckets": list(self.buckets),
            "decode_steps": self.decode_steps,
            "max_batch": self.max_batch,
            "max_seq": self.max_seq,
            "policy": self.policy.name,
            "adaptive_k": self.policy.adaptive_k,
            "preempt": self.policy.preempt,
            "shed_depth": self.policy.shed_depth,
            "kv_block": self.kv_block,
            "kv_blocks": self.kv_blocks,
            "prefix_cache": self.prefix_cache,
            "shard": list(self.shard) if self.shard is not None else None,
            "speculate": self.speculate,
            "replicas": self.replicas,
            "router": self.router,
        }


@dataclasses.dataclass
class ScoredConfig:
    config: ServingConfig
    #: The simulated run's stats over the workload (virtual ms).
    predicted_p99_ms: float
    predicted_queue_wait_p99_ms: float
    predicted_attainment: Optional[float]
    predicted_dispatches: int


@dataclasses.dataclass
class ServingSearchResult:
    chosen: ScoredConfig
    baseline: ScoredConfig
    candidates: List[ScoredConfig]
    model: ServingLatencyModel
    wall_s: float

    @property
    def speedup(self) -> float:
        return self.baseline.predicted_p99_ms / max(
            self.chosen.predicted_p99_ms, 1e-9
        )

    def describe(self) -> str:
        c = self.chosen
        return (f"serve-auto: chose {c.config.describe()} — predicted "
                f"e2e p99 {c.predicted_p99_ms:.3f} ms vs baseline "
                f"{self.baseline.predicted_p99_ms:.3f} ms "
                f"({self.speedup:.2f}x) over {len(self.candidates)} "
                f"candidates in {self.wall_s:.2f}s")


def candidate_bucket_sets(
    requests: Sequence[Request],
    max_seq: int,
    baseline: Tuple[int, ...],
) -> List[Tuple[int, ...]]:
    """A small family of bucket boundaries from the workload's own prompt
    lengths; every set ends at ``max_seq``, so coverage never shrinks
    below the baseline's."""
    plens = sorted(len(r.prompt) for r in requests)
    out = {tuple(baseline), (max_seq,)}
    if plens:
        pmax = min(plens[-1], max_seq)
        p50 = min(plens[len(plens) // 2], max_seq)
        out.add(tuple(sorted({pmax, max_seq})))
        out.add(tuple(sorted({p50, pmax, max_seq})))
    return sorted(out)


def candidate_kv_layouts(
    baseline: "ServingConfig",
) -> List[Tuple[int, Optional[int], bool]]:
    """Paged block-size variants at the baseline's pool capacity in
    tokens (the block halved and doubled, the pool re-sized so its memory
    stays), each with the prefix cache off and on.  A padded baseline
    stays padded: the layout is the operator's memory decision."""
    if baseline.kv_block <= 0:
        return [(0, None, False)]
    pool_tokens = (baseline.kv_blocks - 1) * baseline.kv_block
    pairs = {(baseline.kv_block, baseline.kv_blocks)}
    for blk in (baseline.kv_block // 2, baseline.kv_block * 2):
        if blk >= 1 and baseline.max_seq % blk == 0:
            pairs.add((blk, max(pool_tokens // blk, 1) + 1))
    return sorted(
        (blk, n, pfx) for blk, n in pairs for pfx in (False, True)
    )


def _score(config: ServingConfig, requests: Sequence[Request],
           model: ServingLatencyModel) -> ScoredConfig:
    if config.replicas > 1:
        fleet = FleetRouter.simulated(
            config.shape(), config.replicas, router=config.router,
            decode_steps=config.decode_steps, policy=config.policy,
            latency_model=model, speculate=config.speculate,
        )
        _results, stats = fleet.run(list(requests))
    else:
        srv = ScheduledServer.simulated(
            config.shape(), decode_steps=config.decode_steps,
            policy=config.policy, latency_model=model,
            speculate=config.speculate,
        )
        _results, stats = srv.run(list(requests))
    return ScoredConfig(
        config=config,
        predicted_p99_ms=stats["e2e_ms_p99"],
        predicted_queue_wait_p99_ms=stats["queue_wait_ms_p99"],
        predicted_attainment=stats.get("slo_attainment"),
        predicted_dispatches=stats["prefills"] + stats["decode_supersteps"],
    )


def search_serving_config(
    requests: Sequence[Request],
    baseline: ServingConfig,
    model: Optional[ServingLatencyModel] = None,
    max_batch_cap: Optional[int] = None,
) -> ServingSearchResult:
    """Exhaustive search over the bounded candidate space (a few dozen
    compute-free simulations) with a deterministic tie-break.  The
    baseline always competes, and the winner is returned even when it is
    the baseline."""
    t0 = time.time()
    model = model or ServingLatencyModel()
    cap = max_batch_cap or max(baseline.max_batch, max(BATCH_CANDIDATES))
    ks = sorted(
        k for k in set(ADAPTIVE_K_CANDIDATES) | {baseline.decode_steps}
        if 1 <= k <= MAX_DECODE_STEPS_PER_CALL
    )
    batches = sorted(
        b for b in set(BATCH_CANDIDATES) | {baseline.max_batch}
        if 1 <= b <= cap
    )
    bucket_sets = candidate_bucket_sets(
        requests, baseline.max_seq, baseline.buckets
    )
    base_pol = baseline.policy
    kv_layouts = candidate_kv_layouts(baseline)
    # The draft depth is a knob only when the baseline speculates (a
    # plain baseline has no draft source); 0 always competes.
    if baseline.speculate > 0:
        specs = tuple(sorted({
            0, baseline.speculate,
            max(baseline.speculate // 2, 1),
            min(baseline.speculate * 2, MAX_DECODE_STEPS_PER_CALL),
        }))
    else:
        specs = (0,)
    # The fleet's knobs only when the baseline runs a fleet: its replica
    # count is the ceiling, the router is free.
    if baseline.replicas > 1:
        reps = tuple(sorted({1, baseline.replicas,
                             max(baseline.replicas // 2, 1)}))
    else:
        reps = (1,)
    configs: List[ServingConfig] = []
    seen = set()
    for bks in bucket_sets:
        for k in ks:
            for b in batches:
                for kvb, kvn, pfx in kv_layouts:
                    for sp in specs:
                        # d replaces k in spec mode (adaptive k is
                        # bypassed): vary neither alongside d.
                        k_eff = baseline.decode_steps if sp > 0 else k
                        adaptives = (
                            (True, False)
                            if base_pol.name == "slo" and sp == 0
                            else (base_pol.adaptive_k,)
                        )
                        for adaptive in adaptives:
                            pol = dataclasses.replace(
                                base_pol, adaptive_k=adaptive)
                            for rep in reps:
                                routers = ROUTER_POLICIES if rep > 1 \
                                    else (baseline.router,)
                                for rt in routers:
                                    key = (bks, k_eff, b, kvb, kvn,
                                           pfx, sp, adaptive, rep, rt)
                                    if key in seen:
                                        continue
                                    seen.add(key)
                                    configs.append(ServingConfig(
                                        buckets=bks,
                                        decode_steps=k_eff,
                                        max_batch=b,
                                        max_seq=baseline.max_seq,
                                        policy=pol,
                                        kv_block=kvb, kv_blocks=kvn,
                                        prefix_cache=pfx,
                                        shard=baseline.shard,
                                        speculate=sp,
                                        replicas=rep, router=rt,
                                    ))
    if not any(c.to_json() == baseline.to_json() for c in configs):
        configs.append(baseline)

    scored = [_score(c, requests, model) for c in configs]
    baseline_scored = next(
        s for s in scored if s.config.to_json() == baseline.to_json()
    )

    def order(s: ScoredConfig):
        # Best predicted e2e p99; ties to fewer dispatches, then the
        # smaller, simpler config.
        return (
            round(s.predicted_p99_ms, 6),
            s.predicted_dispatches,
            s.config.decode_steps,
            s.config.max_batch,
            len(s.config.buckets),
            s.config.buckets,
            s.config.kv_block,
            not s.config.prefix_cache,
            s.config.speculate,
            not s.config.policy.adaptive_k,
            s.config.replicas,
            s.config.router,
        )

    chosen = min(scored, key=order)
    return ServingSearchResult(
        chosen=chosen, baseline=baseline_scored, candidates=scored,
        model=model, wall_s=time.time() - t0,
    )
