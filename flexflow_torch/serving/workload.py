"""Open-loop serving workloads: the port of
``flexflow_tpu/serving/workload.py``, draw for draw.

Zipf-skewed prompt and output lengths, bursty inter-arrival gaps, a
priority tier per request with an SLO deadline, and optionally a shared
system-prompt span: what the scheduler (``serving/scheduler.py``) admits
against.  Every request draws from its own ``np.random.default_rng([seed,
i])``, exactly as the JAX package's generator does, so the same spec
gives the same requests in both packages, bit for bit, and a decision
trace over them replays.

Arrivals are stamped in virtual milliseconds (``Request.arrival_ms``):
the scheduler's clock advances by modeled program costs
(``serving/latency_model.py``), never by wall time.

``production_workload`` reads its prompt tokens from the data plane's
production trace (``data/trace.py``) with the same length, tier and
arrival draws.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from flexflow_torch.runtime.serving import Request


def _bounded_zipf(rng: np.random.Generator, alpha: float, lo: int,
                  hi: int) -> int:
    """One zipf draw folded into [lo, hi] (``np.minimum`` clamp, 1-based
    shifted to the range floor)."""
    if alpha <= 1.0:
        raise ValueError(f"zipf alpha must be > 1.0, got {alpha}")
    if hi <= lo:
        return lo
    draw = int(np.minimum(rng.zipf(alpha), hi - lo + 1))
    return lo + draw - 1


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything that shapes an open-loop request trace.  Frozen so a
    spec can key caches and ride in telemetry meta verbatim."""

    n_requests: int = 16
    vocab: int = 256
    #: Prompt lengths: zipf(alpha) folded into [lo, hi] — most prompts
    #: short, a heavy tail near hi (the production shape).
    prompt_len: Tuple[int, int] = (4, 12)
    prompt_alpha: float = 1.5
    #: Generation budgets: zipf-folded into [lo, hi] likewise.
    max_new: Tuple[int, int] = (1, 16)
    output_alpha: float = 1.5
    #: Mean inter-arrival gap (virtual ms) between BURSTS; requests
    #: inside a burst arrive back-to-back (gap 0).
    mean_gap_ms: float = 8.0
    #: Burst width: every ``burst`` consecutive requests share one
    #: arrival instant (1 = no bursts, smooth exponential arrivals).
    burst: int = 1
    #: Priority tiers (0 = highest).  Tier is drawn uniformly; tier t
    #: gets deadline ``slo_ms * (t + 1)`` — tighter SLOs on higher
    #: tiers, the shape the EDF ordering exploits.
    priorities: int = 1
    #: Base SLO deadline (virtual ms) for tier 0; inf = best-effort.
    slo_ms: float = float("inf")
    #: Prefix sharing (SERVING.md "Prefix sharing"): a P-token
    #: system-prompt span drawn ONCE per workload (its own rng block,
    #: disjoint from every per-request block); each request
    #: independently shares it with probability ``shared_frac`` —
    #: sharers' prompts become ``span ‖ own_tokens[:plen - P]``.
    #: 0 = off (bit-identical to the pre-knob trace: the share draw
    #: is appended AFTER every existing per-request draw).
    shared_prefix: int = 0
    shared_frac: float = 0.75
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("workload needs at least one request")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.priorities < 1:
            raise ValueError(
                f"priorities must be >= 1, got {self.priorities}"
            )
        if self.mean_gap_ms < 0:
            raise ValueError("mean_gap_ms must be >= 0")
        for name in ("prompt_len", "max_new"):
            lo, hi = getattr(self, name)
            if lo < 1 or hi < lo:
                raise ValueError(
                    f"{name} must be 1 <= lo <= hi, got ({lo}, {hi})"
                )
        if self.shared_prefix < 0:
            raise ValueError(
                f"shared_prefix must be >= 0, got {self.shared_prefix}"
            )
        if not 0.0 <= self.shared_frac <= 1.0:
            raise ValueError(
                f"shared_frac must be in [0, 1], got {self.shared_frac}"
            )


def _shared_span(spec: WorkloadSpec):
    """The workload's one shared system-prompt span (None when the
    knob is off).  Its rng block ``[seed, 0, 0]`` is length-disjoint
    from every per-request ``[seed, i]`` block, so arming the knob
    perturbs no existing draw."""
    if not spec.shared_prefix:
        return None
    rng = np.random.default_rng([spec.seed, 0, 0])
    return rng.integers(
        0, spec.vocab, size=spec.shared_prefix
    ).astype(np.int32)


def _maybe_share(spec: WorkloadSpec, span, rng: np.random.Generator,
                 prompt: np.ndarray) -> np.ndarray:
    """Per-request share draw — APPENDED after every pre-existing
    draw in the request's rng block, so shared_prefix=0 workloads are
    bit-identical to the pre-knob generator.  A sharer's prompt keeps
    ``max(plen, P)`` tokens: the span plus its own tail."""
    if span is None:
        return prompt
    if float(rng.random()) >= spec.shared_frac:
        return prompt
    tail = prompt[: max(len(prompt) - spec.shared_prefix, 0)]
    return np.concatenate([span, tail]).astype(np.int32)


def make_workload(spec: WorkloadSpec) -> List[Request]:
    """The deterministic open-loop trace: requests id-ordered BY
    arrival time (ties by draw order), every field a pure function of
    ``(spec, seed)``."""
    out: List[Request] = []
    t_ms = 0.0
    span = _shared_span(spec)
    for i in range(spec.n_requests):
        rng = np.random.default_rng([spec.seed, i])
        plen = _bounded_zipf(rng, spec.prompt_alpha, *spec.prompt_len)
        prompt = rng.integers(0, spec.vocab, size=plen).astype(np.int32)
        max_new = _bounded_zipf(rng, spec.output_alpha, *spec.max_new)
        tier = int(rng.integers(0, spec.priorities))
        # Burst pacing: the first request of each burst group draws an
        # exponential gap (scaled by the group width so the OFFERED
        # load is burst-invariant); the rest arrive with it.
        if i % spec.burst == 0 and i > 0:
            t_ms += float(rng.exponential(spec.mean_gap_ms * spec.burst))
        prompt = _maybe_share(spec, span, rng, prompt)
        slo = spec.slo_ms * (tier + 1)
        out.append(Request(
            id=i, prompt=prompt, max_new_tokens=max_new,
            arrival_ms=round(t_ms, 3), priority=tier, slo_ms=slo,
        ))
    return out


def production_workload(spec: WorkloadSpec,
                        id_alpha: float = 1.2) -> List[Request]:
    """The production-trace workload (``--workload-trace prod[...]``):
    prompt tokens are read from the data plane's
    :class:`~flexflow_torch.data.trace.ProductionTraceSource` (one id
    column, power-law skewed: a few hot ids dominate every prompt), while
    lengths, budgets, tiers and burst-paced arrivals keep
    :func:`make_workload`'s draws from the same per-request rng block, so
    the two generators differ only in token content.  ``id_alpha`` is the
    source's id skew, apart from the length-shaping ``prompt_alpha``."""
    from flexflow_torch.data.trace import ProductionTraceSource

    hi = spec.prompt_len[1]
    src = ProductionTraceSource(
        num_samples=spec.n_requests * hi, dense_dim=1,
        vocab_sizes=[spec.vocab], alpha=id_alpha, seed=spec.seed,
        block=max(hi, 64),
    )
    out: List[Request] = []
    t_ms = 0.0
    span = _shared_span(spec)
    for i in range(spec.n_requests):
        rng = np.random.default_rng([spec.seed, i])
        plen = _bounded_zipf(rng, spec.prompt_alpha, *spec.prompt_len)
        # Request i owns trace rows [i * hi, i * hi + plen).
        prompt = src.read(i * hi, i * hi + plen)["sparse_input"][:, 0]
        prompt = np.ascontiguousarray(prompt, np.int32)
        rng.integers(0, spec.vocab, size=plen)  # keeps the draws aligned
        max_new = _bounded_zipf(rng, spec.output_alpha, *spec.max_new)
        tier = int(rng.integers(0, spec.priorities))
        if i % spec.burst == 0 and i > 0:
            t_ms += float(rng.exponential(spec.mean_gap_ms * spec.burst))
        prompt = _maybe_share(spec, span, rng, prompt)
        out.append(Request(
            id=i, prompt=prompt, max_new_tokens=max_new,
            arrival_ms=round(t_ms, 3), priority=tier,
            slo_ms=spec.slo_ms * (tier + 1),
        ))
    return out


def uniform_workload(
    n: int,
    vocab: int,
    prompt_len: Tuple[int, int] = (4, 12),
    max_new_tokens: int = 16,
    every_ms: float = 0.0,
    seed: int = 0,
    slo_ms: float = float("inf"),
) -> List[Request]:
    """The prompt stream ``synthetic_requests`` draws (same rng, same
    shapes), with ``arrival_ms = i * every_ms`` on the virtual clock and
    one SLO for every request."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    out = []
    for i in range(n):
        plen = int(rng.integers(lo, hi + 1))
        out.append(Request(
            id=i,
            prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            max_new_tokens=max_new_tokens,
            arrival_ms=round(i * every_ms, 3),
            slo_ms=slo_ms,
        ))
    return out
