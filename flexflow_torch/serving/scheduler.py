"""SLO-aware continuous batcher over the serving runtime: the port of
``flexflow_tpu/serving/scheduler.py``, decision for decision.

``runtime/serving.py`` owns the programs, caches and slots; this layer
replaces the plain Server's closed FIFO admission with a latency-aware
scheduler:

- **Virtual clock.**  Every decision and every latency number runs on a
  deterministic clock in modeled ms (``serving/latency_model.py``):
  admission advances it by ``prefill_ms(bucket)``, a decode superstep by
  ``decode_ms(k)``, and arrivals (``Request.arrival_ms``,
  ``serving/workload.py``) become visible when the clock passes them.
  Queue wait, end-to-end latency and SLO attainment are virtual-clock
  quantities, identical across replays, across boxes and across the two
  packages.  Wall time is measured for the throughput stats; no decision
  reads it.  The host-side scheduling arithmetic is the JAX package's,
  in Python floats and numpy, rounded at the same sites in the same
  order, so the decision logs and the span reconciliation agree to the
  microsecond.
- **Policies.**  ``fifo``: arrival order, fixed decode k, no priorities,
  preemption or shedding (the A/B baseline).  ``slo``: admission by
  (priority tier, deadline), EDF within a tier; decode k adapted against
  the latency model; lowest-tier slots preempted for deadline-infeasible
  waiters; shedding past a queue-depth bound.
- **Adaptive k.**  Per superstep, k minimizes modeled system time per
  useful token, ``decode_ms(k) * (active + waiting) / sum_j min(k,
  remaining_j)``, over :data:`ADAPTIVE_K_CANDIDATES` clamped by
  ``relay_safe_steps``.
- **Preemption.**  A waiting request whose deadline is infeasible under
  natural slot turnover may evict a strictly lower-tier slot: the victim
  re-queues with its generated tokens carried and resumes by a
  re-prefill over ``prompt ‖ carried``, so its greedy output equals the
  unpreempted run's.
- **Shedding.**  Past ``shed_depth`` waiting requests, the worst (largest
  tier, latest deadline) are refused with a ``request_shed`` event.
- **Speculation.**  ``speculate=d`` switches the decode phase to the
  executor's speculative round (``build_spec_step``): the clock advances
  by ``spec_ms(d)`` and each slot consumes ``accepted + 1`` tokens;
  admission pays one draft prefill.  Adaptive k is bypassed.
- **Failure model** (:class:`ServingResilience`): slot faults retry with
  virtual-clock exponential backoff, engine faults (a
  :class:`ServingEngineFault`, nothing else) restart the engine
  (caches, graphs and ledger built anew, in-flight work requeued with
  its tokens carried) against a crash-loop budget, waiting requests past
  their deadline expire, SIGTERM drains at the next boundary, and the
  degraded-mode ladder (``shrink_batch`` / ``shrink_pool`` when the KV
  cache misses the device budget, ``decode_oracle`` after repeated
  decode-phase engine faults) steps down loudly.

On the card the real engine (:class:`_RealEngine`) owns the caches and
ONE set of carry tensors (``pos``, ``tok``, ``req``, ``bt``) and keeps
one decode program per k it uses, each a CUDA graph bound to those same
tensors; host values are copied into the carry before every replay.  An
engine restart drops the graphs and tensors and captures again.

A compute-free **simulate** mode runs the same loop against fabricated
tokens (no torch compute): its decisions and dispatch counts (prefills,
supersteps) equal a real run's with EOS off (in spec mode, with a fully
accepting draft: acceptance values are what a simulation cannot know).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from flexflow_torch.obs import spans as _spans
from flexflow_torch.runtime import telemetry as _telemetry
from flexflow_torch.runtime.serving import (
    Request,
    RequestResult,
    ServingCrashLoop,
    ServingEngineFault,
    ServingExecutor,
    ServingFault,
    _fenced,
    prefix_digests,
)
from flexflow_torch.serving.latency_model import ServingLatencyModel

_log = logging.getLogger("ff.serving.sched")

#: Decode-k candidates the adaptive policy may choose from (unioned
#: with the configured k, filtered to the relay-safe clamp): bounded so
#: an engine keeps at most this many decode graphs.
ADAPTIVE_K_CANDIDATES = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """The scheduler's knobs."""

    name: str = "slo"                 # "fifo" | "slo"
    adaptive_k: bool = True           # slo only: latency-model k choice
    preempt: bool = True              # slo only: tiered eviction
    shed_depth: int = 0               # waiting-queue bound; 0 = off
    max_preempts_per_request: int = 1

    def __post_init__(self):
        if self.name not in ("fifo", "slo"):
            raise ValueError(f"unknown scheduler policy {self.name!r}")
        if self.shed_depth < 0:
            raise ValueError("shed_depth must be >= 0")

    @staticmethod
    def fifo() -> "SchedulerPolicy":
        return SchedulerPolicy(name="fifo", adaptive_k=False,
                               preempt=False, shed_depth=0)

    def describe(self) -> str:
        if self.name == "fifo":
            return "fifo (arrival order, fixed k)"
        bits = ["slo (tier+EDF admission"]
        bits.append("adaptive k" if self.adaptive_k else "fixed k")
        if self.preempt:
            bits.append("preempt")
        if self.shed_depth:
            bits.append(f"shed>{self.shed_depth}")
        return ", ".join(bits) + ")"


@dataclasses.dataclass(frozen=True)
class ServingResilience:
    """The serving failure model's knobs (SERVING.md "Failure model").

    Passing one arms the failure model: slot faults retry with
    virtual-clock exponential backoff instead of erroring the request,
    engine faults restart the engine (caches, graphs and ledger built
    anew, in-flight work requeued with its tokens carried) against a
    crash-loop budget, waiting requests past their deadline expire as SLO
    misses, and SIGTERM drains at the next fence.  ``resilience=None``
    (the default) keeps the plain behaviour: slot faults error out,
    engine faults propagate.

    An engine fault is a :class:`ServingEngineFault` (the injector's
    ``engine_raise_at``).  Every other exception of a program propagates
    under an armed model too: a CUDA error, a kernel's failed launch or
    build, a bug.  The JAX package also restarts on any ``RuntimeError`` or
    ``OSError`` of a program, its runtime's compile and launch failures
    included; on the card such an error is the card's or the kernel's,
    and a restart would hide it.
    """

    #: Per-request retry budget for slot-isolated faults (raised
    #: ServingFault, non-finite fence).  0 = fail fast.
    max_retries: int = 0
    #: Base of the exponential backoff (virtual-clock ms): attempt
    #: ``a`` waits ``retry_backoff_ms * 2**a`` before re-queueing —
    #: deterministic in simulate mode, like every other decision.
    retry_backoff_ms: float = 8.0
    #: Engine-restart budget; exceeding it raises
    #: :class:`~flexflow_torch.runtime.serving.ServingCrashLoop`
    #: (``apps/serve.py`` → ``EXIT_SERVING_FAILURE``).
    max_restarts: int = 0
    #: Deadline-based expiry of WAITING requests: a finite-SLO request
    #: still queued past ``deadline_ms`` is refused and counted as an
    #: SLO miss (attainment stays goodput — expiry can't game the bar).
    expire_waiting: bool = False
    #: Degraded-mode ladder rung: after this many decode-phase engine
    #: faults the decode attention leaves the K6 kernel for the plain
    #: einsum (``ex.decode_kernel = False``; logged, a ``degraded_mode``
    #: event).  0 = never.
    kernel_fault_rung: int = 2
    #: Drain on SIGTERM/SIGINT (``PreemptionHandler``-wired): stop
    #: admissions, journal in-flight work at the next fence, return
    #: cleanly with ``stats["drained"]``.
    drain_on_preempt: bool = True

    def __post_init__(self):
        if self.max_retries < 0 or self.max_restarts < 0:
            raise ValueError("retry/restart budgets must be >= 0")
        if self.retry_backoff_ms <= 0:
            raise ValueError("retry_backoff_ms must be > 0")
        if self.kernel_fault_rung < 0:
            raise ValueError("kernel_fault_rung must be >= 0")


@dataclasses.dataclass(frozen=True)
class SlotShape:
    """The executor surface the simulate mode needs, validated as
    :class:`ServingExecutor` validates it, so a config that simulates is
    a config the executor accepts.  ``kv_block > 0`` switches the
    simulated capacity model to the paged pool: admission is then gated
    by the same :class:`~flexflow_torch.runtime.serving.KVBlockLedger`
    arithmetic the real engine runs."""

    max_batch: int
    max_seq: int
    buckets: Tuple[int, ...]
    kv_block: int = 0
    kv_blocks: Optional[int] = None
    prefix_cache: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        bks = tuple(sorted(set(int(b) for b in self.buckets)))
        if not bks or any(b < 1 or b > self.max_seq for b in bks):
            raise ValueError(
                f"buckets must be in [1, max_seq]: {list(self.buckets)}"
            )
        object.__setattr__(self, "buckets", bks)
        # Mirrors ServingExecutor's paged validation exactly.
        if self.kv_blocks is not None and self.kv_block <= 0:
            raise ValueError("kv_blocks requires kv_block > 0")
        if self.prefix_cache and self.kv_block <= 0:
            raise ValueError(
                "prefix_cache requires the paged layout (kv_block > 0)"
            )
        if self.kv_block > 0:
            if self.max_seq % self.kv_block != 0:
                raise ValueError(
                    f"kv_block {self.kv_block} must divide "
                    f"max_seq {self.max_seq}"
                )
            bps = self.max_seq // self.kv_block
            n_blocks = (self.kv_blocks if self.kv_blocks is not None
                        else self.max_batch * bps + 1)
            if n_blocks < 2:
                raise ValueError(
                    f"kv_blocks must be >= 2 (scratch + pool), "
                    f"got {n_blocks}"
                )
            object.__setattr__(self, "kv_blocks", n_blocks)

    @property
    def paged(self) -> bool:
        return self.kv_block > 0

    def make_ledger(self):
        """The block allocator for the simulated capacity model —
        the SAME class the real engine gates admission with."""
        from flexflow_torch.runtime.serving import KVBlockLedger

        if not self.paged:
            raise ValueError("make_ledger() needs kv_block > 0")
        return KVBlockLedger(self.kv_blocks, self.kv_block, self.max_seq,
                             prefix_cache=self.prefix_cache)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest pad "
            f"bucket {self.buckets[-1]} (max_seq={self.max_seq})"
        )


class _RealEngine:
    """The device engine: the :class:`ServingExecutor` programs on one
    set of caches.  It owns the KV caches (and the draft's under
    speculation) and ONE set of carry tensors, ``pos`` / ``tok`` /
    ``req`` / ``bt``, into which each superstep's host values are copied;
    it keeps one decode program per k and one speculative round, each (on
    CUDA, by default) a CUDA graph bound to those same tensors, captured
    at its first call.  Prefills and installs run eagerly between
    replays; every readback is ``Telemetry.fence`` with its label, and a
    ``program_cost`` goes out at each program's first call."""

    simulated = False

    @torch.inference_mode()
    def __init__(self, ex: ServingExecutor, params, op_state,
                 sample=None, speculate: int = 0, draft_params=None,
                 graph: Optional[bool] = None):
        self.ex = ex
        self.params = params
        self.op_state = op_state
        self.sample = sample
        self.speculate = speculate
        self.graph = graph
        self.caches = ex.init_cache()
        B = ex.max_batch
        self.carry = {n: torch.zeros(shape, dtype=torch.int32,
                                     device=ex.device)
                      for n, shape in (("pos", (B,)), ("tok", (B,)),
                                       ("req", (B,)),
                                       ("bt", (B, ex.blocks_per_slot)))}
        self._fns: Dict[Tuple[str, int], Any] = {}
        if speculate:
            self.draft_params = (draft_params if draft_params is not None
                                 else params)
            self.dcaches = ex.init_draft_cache()

    def _program(self, kind: str, n: int):
        fn = self._fns.get((kind, n))
        if fn is None:
            if kind == "decode":
                fn = self.ex.build_decode_superstep(
                    n, sample=self.sample, graph=self.graph)
            else:
                fn = self.ex.build_spec_step(n, sample=self.sample,
                                             graph=self.graph)
            self._fns[(kind, n)] = fn
        return fn

    @torch.inference_mode()
    def _args(self, pos_vec, tok_vec, block_table, req_ids):
        """Copy the host values into the carry: the program's arguments
        after the caches."""
        dev = self.carry
        dev["pos"].copy_(torch.from_numpy(np.asarray(pos_vec, np.int32)))
        dev["tok"].copy_(torch.from_numpy(np.asarray(tok_vec, np.int32)))
        args = ()
        if block_table is not None:
            dev["bt"].copy_(torch.from_numpy(
                np.asarray(block_table, np.int32)))
            args += (dev["bt"],)
        args += (dev["pos"], dev["tok"])
        if self.sample is not None:
            dev["req"].copy_(torch.from_numpy(np.asarray(req_ids, np.int32)))
            args += (dev["req"],)
        return args

    def prefill(self, prompt: np.ndarray, bucket: int, slot_i: int,
                row: Optional[np.ndarray] = None,
                plen: Optional[int] = None, rid: int = 0,
                offset: int = 0, shared_ids=None):
        """Pad-to-bucket prefill and cache install into ``slot_i`` (padded
        rows, or the ledger's table ``row`` on the paged layout):
        ``(first_token, finite, wall_s)`` after one fence.  ``prompt`` is
        the full (prompt ‖ carried) sequence; ``plen`` / ``rid`` key the
        sampled first token so a resumed position replays the decode's
        draw.  ``offset > 0`` runs the offset prefill of prefix sharing
        (the shared span's K/V gathered from the pool blocks
        ``shared_ids``; ``row`` is then the masked table row, shared
        entries pointing at scratch block 0)."""
        tel = _telemetry.current()
        ex = self.ex
        flen = len(prompt)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :flen] = np.asarray(prompt, np.int32)
        t0 = time.perf_counter()
        if offset:
            pf = ex.build_prefill_from(bucket, offset, sample=self.sample)
            pf_args = (self.params, self.op_state, self.caches,
                       np.asarray(shared_ids, np.int32), padded,
                       np.int32(flen))
        else:
            pf = ex.build_prefill(bucket, sample=self.sample)
            pf_args = (self.params, self.op_state, padded, np.int32(flen))
        if self.sample is not None:
            pf_args += (np.int32(flen if plen is None else plen),
                        np.int32(rid))
        tel.program_cost("prefill", pf,
                         flops=lambda: ex.program_flops(bucket - offset),
                         bucket=bucket)
        rows, tok0, okf = pf(*pf_args)
        tok0, ok = (int(x) for x in _fenced(tel, "prefill", tok0, okf))
        wall = time.perf_counter() - t0
        if ok:
            if row is not None:
                ex.install_paged(self.caches, rows, row)
            else:
                ex.install(self.caches, rows, slot_i)
        return tok0, bool(ok), wall

    def decode(self, pos_vec: np.ndarray, tok_vec: np.ndarray, k: int,
               block_table: Optional[np.ndarray] = None,
               req_ids: Optional[np.ndarray] = None):
        """One k-step decode superstep over the whole slot batch:
        ``(tokens (k, B), finite (k, B), wall_s)`` after one fence."""
        tel = _telemetry.current()
        fn = self._program("decode", k)
        args = self._args(pos_vec, tok_vec, block_table, req_ids)
        t0 = time.perf_counter()
        tel.program_cost(
            "decode_superstep", fn, k=k,
            flops=lambda: self.ex.program_flops(k * self.ex.max_batch))
        *_c, (toks, oks) = fn(self.params, self.op_state, self.caches,
                              *args)
        host_toks, host_oks = _fenced(tel, "decode_superstep", toks, oks)
        return host_toks, host_oks.astype(bool), time.perf_counter() - t0

    def draft_prefill(self, prompt: np.ndarray, bucket: int,
                      slot_i: int):
        """Fill the draft's own cache rows for ``slot_i``: the speculative
        admission's second dispatch, with no fence (nothing is read
        back; the next round synchronizes)."""
        tel = _telemetry.current()
        ex = self.ex
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(prompt)] = np.asarray(prompt, np.int32)
        t0 = time.perf_counter()
        dpf = ex.build_draft_prefill(bucket)
        tel.program_cost("draft_prefill", dpf, bucket=bucket,
                         flops=lambda: ex.program_flops(bucket))
        drows = dpf(self.draft_params, self.op_state, padded)
        ex.install(self.dcaches, drows, slot_i)
        return time.perf_counter() - t0

    def spec(self, pos_vec: np.ndarray, tok_vec: np.ndarray, d: int,
             block_table: Optional[np.ndarray] = None,
             req_ids: Optional[np.ndarray] = None):
        """One speculative round (d + 1 draft and d + 1 verify steps) over
        the whole slot batch: ``(tokens (d+1, B), finite (d+1, B),
        accepted (B,), wall_s)`` after one fence."""
        tel = _telemetry.current()
        fn = self._program("spec", d)
        args = self._args(pos_vec, tok_vec, block_table, req_ids)
        t0 = time.perf_counter()
        tel.program_cost("spec_verify", fn, d=d,
                         flops=lambda: self.ex.program_flops(
                             2 * (d + 1) * self.ex.max_batch))
        *_c, (toks, oks, acc) = fn(self.params, self.draft_params,
                                   self.op_state, self.caches, self.dcaches,
                                   *args)
        host_toks, host_oks, host_acc = _fenced(tel, "spec_verify", toks,
                                                oks, acc)
        return (host_toks, host_oks.astype(bool), host_acc,
                time.perf_counter() - t0)


class _SimEngine:
    """Compute-free engine: fabricated (finite) tokens, zero wall.  Token
    values are synthetic; the quantities decisions read (counts,
    positions, budgets, KV-block reservations) are exact."""

    simulated = True

    def __init__(self, shape: SlotShape):
        self.shape = shape

    def prefill(self, prompt, bucket, slot_i, row=None, plen=None,
                rid=0, offset=0, shared_ids=None):
        return 1, True, 0.0

    def decode(self, pos_vec, tok_vec, k, block_table=None,
               req_ids=None):
        B = len(pos_vec)
        toks = np.ones((k, B), np.int32)
        oks = np.ones((k, B), bool)
        return toks, oks, 0.0

    def draft_prefill(self, prompt, bucket, slot_i):
        return 0.0

    def spec(self, pos_vec, tok_vec, d, block_table=None, req_ids=None):
        # Fabricated FULL acceptance: token values (and hence the
        # accept/reject pattern) are what simulation cannot know, so
        # the exactness contract is stated against a fully-accepting
        # draft (see the module docstring).
        B = len(pos_vec)
        toks = np.ones((d + 1, B), np.int32)
        oks = np.ones((d + 1, B), bool)
        acc = np.full(B, d, np.int64)
        return toks, oks, acc, 0.0


@dataclasses.dataclass
class _SchedSlot:
    request: Request
    pos: int
    last_tok: int
    tokens: List[int]          # tokens generated THIS occupancy
    carried: List[int]         # tokens carried over preemptions
    admit_v: float             # vclock at FIRST admission
    t_wall0: float
    prefill_s: float
    preempts: int = 0

    @property
    def all_tokens(self) -> List[int]:
        return self.carried + self.tokens

    def remaining(self, max_seq: int) -> int:
        budget = self.request.max_new_tokens - len(self.all_tokens)
        return max(min(budget, max_seq - self.pos), 0)


class ScheduledServer:
    """The scheduling loop.  Construct with a real executor
    (:meth:`__init__`) or compute-free (:meth:`simulated`); ``run``
    returns ``(results, stats)`` like the plain ``Server``, with the
    decision log on ``self.decisions`` and the serving events it emitted
    on ``self.span_events``.  ``graph`` as in ``Server``: the decode
    programs are CUDA graphs on CUDA unless it is False."""

    def __init__(
        self,
        executor: ServingExecutor,
        params,
        op_state,
        decode_steps: int = 8,
        eos_id: Optional[int] = None,
        policy: Optional[SchedulerPolicy] = None,
        latency_model: Optional[ServingLatencyModel] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        sample_seed: int = 0,
        resilience: Optional[ServingResilience] = None,
        journal=None,
        fault_injector=None,
        speculate: int = 0,
        draft_params=None,
        graph: Optional[bool] = None,
        _engine=None,
    ):
        from flexflow_torch.runtime.trainer import relay_safe_steps

        self.ex = executor
        self.policy = policy or SchedulerPolicy()
        self.model = latency_model or ServingLatencyModel()
        self.decode_steps = relay_safe_steps(
            decode_steps, what="decode_steps", log=_log
        )
        #: Speculative draft depth (0 = plain fused decode).  The
        #: clamp site stays relay_safe_steps — the draft chain counts
        #: against it like every other fused chain.
        self.speculate = relay_safe_steps(
            speculate, what="speculate", log=_log
        ) if speculate else 0
        self._draft_params = draft_params
        self.graph = graph
        self.eos_id = eos_id
        # In-program sampling (replayable: draws are keyed by
        # (seed, request id, position), so preemption/resume and any
        # batch composition replay the same sequence).
        self.sample = (temperature, top_k, sample_seed) \
            if temperature > 0.0 else None
        #: Failure model (None = fail fast), crash-recovery journal
        #: (``serving/journal.py``) and scheduled faults
        #: (``ServingFaultInjector``: one superstep-indexed plan drives
        #: the real and the simulated loop alike).
        self.resilience = resilience
        self.journal = journal
        self.injector = fault_injector
        #: Degraded-mode ladder state (rungs taken, in order).
        self.degraded_rungs: List[Dict[str, Any]] = []
        self._decode_faults = 0
        self._degraded_oracle = False
        #: The replayable decision trace: one dict per admit / evict /
        #: shed / reject / decode / advance decision, vclock-stamped.
        self.decisions: List[Dict[str, Any]] = []
        #: In-memory copy of every serving telemetry event this instance
        #: emitted (``obs/spans.py``'s input): the run's ``slo_autopsy``
        #: stats block folds these, so the stats and the reader's
        #: reconstruction from the log agree by construction, with
        #: telemetry on or off.
        self.span_events: List[Dict[str, Any]] = []
        self._params, self._op_state = params, op_state
        self.engine = _engine or self._build_engine(initial=True)
        # Bounded k candidate set (an engine keeps one graph per k).
        ks = set(ADAPTIVE_K_CANDIDATES) | {self.decode_steps}
        self._k_candidates = tuple(sorted(
            k for k in ks if 1 <= k <= self.decode_steps
        )) if self.policy.adaptive_k else (self.decode_steps,)

    @classmethod
    def simulated(
        cls,
        shape: SlotShape,
        decode_steps: int = 8,
        policy: Optional[SchedulerPolicy] = None,
        latency_model: Optional[ServingLatencyModel] = None,
        resilience: Optional[ServingResilience] = None,
        journal=None,
        fault_injector=None,
        speculate: int = 0,
    ) -> "ScheduledServer":
        """The compute-free loop (no torch compute): the decisions and
        dispatch counts of a real run of the same (workload, config,
        policy) with EOS off, through retries and engine restarts when
        the same ``fault_injector`` plan drives both.  With
        ``speculate=d`` the simulated draft accepts fully, so the real
        run must have a fully accepting draft to match."""
        return cls(shape, None, None, decode_steps=decode_steps,
                   eos_id=None, policy=policy, latency_model=latency_model,
                   resilience=resilience, journal=journal,
                   fault_injector=fault_injector, speculate=speculate,
                   _engine=_SimEngine(shape))

    # -- engine (re)build + the degraded-mode ladder ------------------------

    def _build_engine(self, initial: bool = False):
        """(Re)build the device engine.  On a restart (``initial`` False)
        the old engine's caches, carry tensors and graphs are dropped and
        the executor's prefill programs with them: the rebuild starts
        from nothing, like a fresh process, and captures its graphs
        again.  Either way the ``DeviceMemoryError`` rung applies: when
        the KV cache misses the device budget, capacity shrinks stepwise
        (padded: halve ``max_batch``; paged: halve the block pool),
        logged and emitted, and only the floor refuses."""
        from flexflow_torch.data.loader import DeviceMemoryError

        if getattr(getattr(self, "engine", None), "simulated", False):
            return _SimEngine(self.ex)
        ex = self.ex
        if not initial:
            self.release()
        while True:
            try:
                return _RealEngine(ex, self._params, self._op_state,
                                   sample=self.sample,
                                   speculate=self.speculate,
                                   draft_params=self._draft_params,
                                   graph=self.graph)
            except DeviceMemoryError:
                if ex.paged:
                    nb = ex.kv_blocks // 2
                    if nb < max(ex.blocks_per_slot + 1, 2):
                        raise  # floor: pool can't hold one worst slot
                    rung = {"rung": "shrink_pool", "kv_blocks": nb,
                            "prev": ex.kv_blocks}
                    ex.kv_blocks = nb
                else:
                    nb = ex.max_batch // 2
                    if ex.shard is not None:
                        # The padded batch splits over 'n': keep it a
                        # multiple of n.
                        n = ex.shard[0]
                        nb = max(nb - nb % n, n)
                    if nb < 1 or nb == ex.max_batch:
                        raise  # floor: one slot still over budget
                    rung = {"rung": "shrink_batch", "max_batch": nb,
                            "prev": ex.max_batch}
                    ex.max_batch = nb
                self.degraded_rungs.append(rung)
                _log.warning(
                    "degraded mode (%s): KV cache over the device "
                    "budget, stepping down %s -> %s before refusing",
                    rung["rung"], rung["prev"],
                    rung.get("max_batch", rung.get("kv_blocks")),
                )
                _telemetry.current().emit("degraded_mode", **rung)

    def release(self) -> None:
        """Drop the device engine (its caches, carry tensors and graphs)
        and the executor's prefill programs: an engine restart before it
        builds anew, a fleet for a dead replica before a survivor runs.
        A simulated engine has nothing to drop."""
        if getattr(self.engine, "simulated", False):
            return
        self.engine = None
        self.ex._prefill_fns.clear()
        self.ex._built.clear()

    # -- policy orderings ---------------------------------------------------

    def _admit_key(self, r: Request):
        if self.policy.name == "fifo":
            return (r.arrival_ms, r.id)
        return (r.priority, r.deadline_ms, r.arrival_ms, r.id)

    @staticmethod
    def _shed_key(r: Request):
        # Worst-first: largest tier, latest deadline, largest id.
        return (r.priority, r.deadline_ms, r.id)

    def _choose_k(self, slots, waiting: int) -> int:
        """Modeled system-time per useful token, argmin over the
        candidate set (smallest k wins ties)."""
        active = [sl for sl in slots if sl is not None]
        if len(self._k_candidates) == 1 or not active:
            return self.decode_steps
        rems = [max(sl.remaining(self._max_seq()), 1) for sl in active]
        payers = len(active) + waiting
        best_k, best_score = None, None
        for k in self._k_candidates:
            useful = sum(min(k, rem) for rem in rems)
            score = self.model.decode_ms(k) * payers / useful
            if best_score is None or score < best_score - 1e-12:
                best_k, best_score = k, score
        return best_k

    def _max_seq(self) -> int:
        return self.ex.max_seq

    def advertised_capacity(self) -> Dict[str, Any]:
        """The capacity a fleet router reads
        (``serving/fleet.py::FleetRouter``): ``slots`` after any degraded rung (the
        rungs shrink ``max_batch`` or the pool in place) and ``degraded``,
        the rungs taken.  The same in real and simulated mode."""
        return {
            "slots": int(self.ex.max_batch),
            "degraded": len(self.degraded_rungs)
            + (1 if self._degraded_oracle else 0),
            "paged": bool(getattr(self.ex, "paged", False)),
        }

    # -- the loop -----------------------------------------------------------

    def run(self, requests: Sequence[Request]):
        from flexflow_torch.runtime.resilience import PreemptionHandler

        tel = _telemetry.current()
        ex, pol, model = self.ex, self.policy, self.model
        B = ex.max_batch
        # Paged KV capacity: admission is gated by the SAME ledger
        # arithmetic on the real and the simulated engine (pure host
        # integers), so simulated dispatch counts stay exact.
        ledger = self.ex.make_ledger() \
            if getattr(self.ex, "paged", False) else None
        block_table = (
            np.zeros((B, ledger.blocks_per_slot), np.int32)
            if ledger is not None else None
        )
        vclock = 0.0
        pending = sorted(requests, key=lambda r: (r.arrival_ms, r.id))
        waiting: List[Request] = []
        slots: List[Optional[_SchedSlot]] = [None] * B
        results: Dict[int, RequestResult] = {}
        #: id -> (first-admission vclock, generated tokens carried
        #: across preemptions, preempt count) for re-queued requests.
        carried: Dict[int, Tuple[Optional[float], List[int], int]] = {}
        qwaits: Dict[int, float] = {}   # id -> queue wait (vclock ms)
        e2es: Dict[int, float] = {}
        slo_oks: Dict[int, bool] = {}
        sheds = preempts = prefills = supersteps = 0
        prefix_hits = full_hits = prefill_tokens_saved = kv_cows = 0
        draft_prefills = spec_accept_total = spec_draft_total = 0
        total_tokens = decode_tokens = 0
        decode_s = 0.0
        t_wall0 = time.perf_counter()
        # -- the failure model (SERVING.md "Failure model") --
        res = self.resilience
        jr = self.journal
        max_retries = res.max_retries if res is not None else 0
        retry_backoff = res.retry_backoff_ms if res is not None else 8.0
        drain_armed = res is not None and res.drain_on_preempt
        retries = expiries = restarts = 0
        drained = False
        superstep_idx = 0
        attempts: Dict[int, int] = {}       # id -> retry attempts
        #: (eligible-at vclock ms, id, request) — kept sorted; drained
        #: back into ``waiting`` by scan_retries.
        retrying: List[Tuple[float, int, Request]] = []
        # -- journal replay: completed requests are NOT re-run,
        # in-flight requests re-enter the queue with carried tokens
        # and resume via the existing re-prefill path.
        if jr is not None:
            st = jr.replay()
            for rid, rec in st.completed.items():
                results[rid] = RequestResult(
                    id=rid, prompt_len=int(rec.get("plen") or 0),
                    tokens=list(rec.get("tokens", [])),
                    error=rec.get("error"),
                    latency_s=float(rec.get("latency_s") or 0.0),
                )
                if rec.get("qw") is not None:
                    qwaits[rid] = float(rec["qw"])
                if rec.get("e2e") is not None:
                    e2es[rid] = float(rec["e2e"])
                if rec.get("slo_ok") is not None:
                    slo_oks[rid] = bool(rec["slo_ok"])
            for rid, toks in st.in_flight.items():
                carried[int(rid)] = (None, list(toks), 0)
            pending = [r for r in pending if r.id not in results]
            if st.completed or st.in_flight:
                _log.info(
                    "journal replay (%s): %d completed restored, %d "
                    "in flight resume with carried tokens%s",
                    jr.path, len(st.completed), len(st.in_flight),
                    " [torn tail tolerated]" if st.torn_tail else "",
                )
        preempt = PreemptionHandler(install=drain_armed)

        def log(d: str, **fields):
            rec = {"d": d, "v": round(vclock, 3)}
            rec.update(fields)
            self.decisions.append(rec)

        span_events = self.span_events

        def sev(name: str, **fields):
            # Every serving event goes out twice: to telemetry (may be
            # the NULL sink) and to the in-memory span buffer the
            # slo_autopsy fold runs on.  One dict append per event —
            # deterministic accounting, zero fences.
            span_events.append({"ev": name, **fields})
            tel.emit(name, **fields)

        def finish_result(r: Request, toks: List[int], err: Optional[str],
                          admit_v: Optional[float], wall0: float,
                          pf_s: float = 0.0):
            # Latency split from the ROUNDED stamps (3 decimals =
            # integer microseconds), so the span layer's telescoped
            # phase totals equal e2e_ms EXACTLY — the obs/spans.py
            # reconciliation contract.
            arr = round(r.arrival_ms, 3)
            end_v = round(vclock, 3)
            e2e = round(end_v - arr, 3)
            qw = e2e if admit_v is None else \
                round(round(admit_v, 3) - arr, 3)
            qwaits[r.id] = qw
            e2es[r.id] = e2e
            fields: Dict[str, Any] = {}
            if math.isfinite(r.slo_ms):
                ok = err is None and e2e <= r.slo_ms
                slo_oks[r.id] = ok
                fields["slo_ok"] = ok
            results[r.id] = RequestResult(
                id=r.id, prompt_len=len(r.prompt), tokens=list(toks),
                error=err, latency_s=time.perf_counter() - wall0,
                prefill_s=pf_s,
            )
            sev("request_end", id=r.id, tokens=len(toks), error=err,
                latency_s=round(results[r.id].latency_s, 6),
                queue_wait_ms=qw, e2e_ms=e2e, arrival_ms=arr,
                vclock_ms=end_v, tier=r.priority, **fields)
            if jr is not None:
                jr.done(r.id, len(r.prompt), len(toks), err,
                        qw=qw, e2e=e2e, slo_ok=fields.get("slo_ok"),
                        latency_s=round(results[r.id].latency_s, 6))

        def finish_slot(slot_i: int, err: Optional[str] = None):
            sl = slots[slot_i]
            finish_result(sl.request, sl.all_tokens, err, sl.admit_v,
                          sl.t_wall0, sl.prefill_s)
            slots[slot_i] = None
            if ledger is not None:
                ledger.free(slot_i)
                block_table[slot_i] = 0

        def slot_done(sl: _SchedSlot) -> bool:
            toks = sl.all_tokens
            if self.eos_id is not None and toks and \
                    toks[-1] == self.eos_id:
                return True
            if len(toks) >= sl.request.max_new_tokens:
                return True
            return sl.pos >= ex.max_seq

        def scan_arrivals():
            while pending and pending[0].arrival_ms <= vclock + 1e-9:
                r = pending.pop(0)
                try:
                    ex.bucket_for(len(r.prompt))
                except ValueError as e:
                    # Infeasible prompt: refuse on arrival with the
                    # complete start/end event pair.
                    sev("request_start", id=r.id,
                        prompt_len=len(r.prompt), bucket=None,
                        slot=None, vclock_ms=round(vclock, 3))
                    log("reject", id=r.id, reason="no_bucket")
                    finish_result(r, [], str(e), None, t_wall0)
                    continue
                if ledger is not None:
                    need = ledger.blocks_for(len(r.prompt),
                                             r.max_new_tokens)
                    if need > ledger.capacity_blocks:
                        sev("request_start", id=r.id,
                            prompt_len=len(r.prompt), bucket=None,
                            slot=None, vclock_ms=round(vclock, 3))
                        log("reject", id=r.id, reason="kv_pool")
                        finish_result(r, [], (
                            f"request needs {need} KV blocks but the "
                            f"paged pool holds {ledger.capacity_blocks}"
                        ), None, t_wall0)
                        continue
                waiting.append(r)

        def projected_free_ms() -> float:
            """Modeled time until a slot frees by natural turnover."""
            rems = [sl.remaining(ex.max_seq) for sl in slots
                    if sl is not None]
            if not rems:
                return 0.0
            if self.speculate:
                d = self.speculate
                return model.spec_ms(d) * math.ceil(
                    max(min(rems), 1) / (d + 1))
            k = self._choose_k(slots, len(waiting))
            return model.decode_ms(k) * math.ceil(max(min(rems), 1) / k)

        def try_preempt(cand: Request) -> Optional[int]:
            """Evict a strictly-lower-tier slot for a deadline-
            infeasible waiter; None = no eviction."""
            nonlocal preempts
            if pol.name != "slo" or not pol.preempt:
                return None
            if not math.isfinite(cand.deadline_ms):
                return None
            slack = cand.deadline_ms - vclock
            bucket = ex.bucket_for(len(cand.prompt))
            # expected_prefill_ms: the prefix-cache-discounted ESTIMATE
            # (defaults make it == prefill_ms).  The vclock still
            # advances by the exact price of the program built.
            if self.speculate:
                d = self.speculate
                need = model.expected_prefill_ms(bucket) + \
                    model.draft_prefill_ms(bucket) + \
                    model.spec_ms(d) * math.ceil(
                        max(cand.max_new_tokens, 1) / (d + 1))
            else:
                need = model.expected_prefill_ms(bucket) + model.decode_ms(
                    self._k_candidates[0]
                ) * math.ceil(max(cand.max_new_tokens, 1)
                              / self._k_candidates[0])
            if slack >= projected_free_ms() + need or slack < need:
                # Feasible by waiting, or already lost: don't evict.
                return None
            victims = [
                (sl.request.priority, sl.request.deadline_ms,
                 sl.request.id, i)
                for i, sl in enumerate(slots)
                if sl is not None
                and sl.request.priority > cand.priority
                and sl.preempts < pol.max_preempts_per_request
                and len(sl.request.prompt) + len(sl.all_tokens)
                    <= ex.buckets[-1]
            ]
            if not victims:
                return None
            _, _, vid, slot_i = max(victims)
            sl = slots[slot_i]
            carried[vid] = (sl.admit_v, sl.all_tokens, sl.preempts + 1)
            preempts += 1
            sev("request_preempt", id=vid, slot=slot_i,
                tier=sl.request.priority, by=cand.id,
                tokens_kept=len(sl.all_tokens),
                vclock_ms=round(vclock, 3))
            log("evict", id=vid, slot=slot_i, by=cand.id,
                kept=len(sl.all_tokens))
            # Re-queue at its original key; the freed slot admits cand.
            waiting.append(sl.request)
            slots[slot_i] = None
            if ledger is not None:
                ledger.free(slot_i)
                block_table[slot_i] = 0
            return slot_i

        def resume_done(r: Request, prior: List[int],
                        admit_v0: Optional[float]) -> bool:
            """A journal-resumed request whose carried sequence is
            already terminal (the crash fell between the last token
            delta and its ``sv_done`` record): finish without
            re-occupying a slot — re-prefilling would over-generate
            past ``max_new_tokens``."""
            terminal = (
                len(prior) >= r.max_new_tokens
                or len(r.prompt) + len(prior) >= ex.max_seq
                or (self.eos_id is not None and prior
                    and prior[-1] == self.eos_id)
            )
            if not terminal:
                return False
            sev("request_start", id=r.id, prompt_len=len(r.prompt),
                bucket=None, slot=None, vclock_ms=round(vclock, 3))
            log("resume_done", id=r.id, tokens=len(prior))
            finish_result(r, prior, None, admit_v0, t_wall0)
            return True

        def admit(r: Request, slot_i: int, plan=None):
            nonlocal vclock, prefills, draft_prefills, total_tokens
            nonlocal prefix_hits, full_hits, prefill_tokens_saved, \
                kv_cows
            waiting.remove(r)
            admit_v0, prior, n_pre = carried.pop(r.id, (vclock, [], 0))
            if prior and resume_done(r, prior, admit_v0):
                return
            # Re-prefill over (prompt ‖ carried) — loss-free resume.
            full = np.concatenate([
                np.asarray(r.prompt, np.int32),
                np.asarray(prior, np.int32),
            ]) if prior else np.asarray(r.prompt, np.int32)
            try:
                bucket = ex.bucket_for(len(full))
            except ValueError as e:
                # Journal-resumed sequence outgrew the largest bucket.
                sev("request_start", id=r.id,
                    prompt_len=len(r.prompt), bucket=None,
                    slot=None, vclock_ms=round(vclock, 3))
                log("reject", id=r.id, reason="resume_bucket")
                finish_result(r, prior, str(e), admit_v0, t_wall0)
                return
            others = [w for w in waiting if w is not r]
            use = plan.use if plan is not None else 0
            fullhit = bool(plan is not None and plan.full_hit)
            pfx_cache = ledger is not None and ledger.prefix_cache
            sev("request_start", id=r.id, prompt_len=len(r.prompt),
                bucket=bucket, slot=slot_i,
                vclock_ms=round(vclock, 3))
            log("admit", id=r.id, slot=slot_i, bucket=bucket,
                tier=r.priority, resumed=len(prior),
                waiting_min_tier=min(
                    (w.priority for w in others), default=None),
                # Prefix-sharing decisions ride the admit record only
                # when the cache is armed, so cache-off decision traces
                # stay byte-identical to the pre-knob scheduler.
                **({"prefix_blocks": use, "prefix_full": fullhit}
                   if pfx_cache else {}),
            )
            digests = (prefix_digests(r.prompt, ledger.block)
                       if pfx_cache else [])
            def rollback(e):
                # Engine-class fault mid-prefill: roll the admission
                # back so the restart path re-queues it cleanly (the
                # ledger free decrements shared refcounts too).
                if ledger is not None:
                    ledger.free(slot_i)
                    block_table[slot_i] = 0
                carried[r.id] = (admit_v0, prior, n_pre)
                waiting.append(r)
                raise ServingEngineFault(str(e)) from e
            if fullhit:
                # -- ZERO-dispatch admission: the whole prompt is
                # resident full blocks and the greedy first token is
                # memoized — no prefill program, no vclock advance.
                row = ledger.alloc(slot_i, ledger.blocks_for(
                    len(r.prompt), r.max_new_tokens),
                    shared=plan.shared)
                block_table[slot_i] = row
                tok0, ok, pf_s = plan.tok0, True, 0.0
                prefix_hits += 1
                full_hits += 1
                prefill_tokens_saved += plan.offset
                sev("prefix_hit", id=r.id, blocks=plan.use,
                    full=True, tokens_saved=plan.offset,
                    vclock_ms=round(vclock, 3))
                if self.speculate:
                    # The draft cache is padded, never shared: its
                    # prefill still runs (and is still priced).
                    vclock += model.draft_prefill_ms(bucket)
                    try:
                        pf_s += self.engine.draft_prefill(
                            full, bucket, slot_i
                        )
                    except ServingEngineFault as e:
                        if res is None:
                            raise
                        rollback(e)
                    draft_prefills += 1
            else:
                vclock += model.prefill_ms(
                    bucket, plan.offset if use else 0
                )
                if self.speculate:
                    vclock += model.draft_prefill_ms(bucket)
                row = masked = None
                if ledger is not None:
                    row = ledger.alloc(slot_i, ledger.blocks_for(
                        len(r.prompt), r.max_new_tokens),
                        shared=(plan.shared if plan is not None
                                else ()))
                    block_table[slot_i] = row
                    # Masked install: shared entries write their
                    # (all-zero) chunks into scratch block 0 — the
                    # donor's blocks are never touched; the table row
                    # keeps the real shared ids for decode.
                    masked = row
                    if use:
                        masked = row.copy()
                        masked[:use] = 0
                try:
                    tok0, ok, pf_s = self.engine.prefill(
                        full, bucket, slot_i, row=masked,
                        plen=len(r.prompt), rid=r.id,
                        offset=(plan.offset if use else 0),
                        shared_ids=(plan.shared if use else None),
                    )
                    if self.speculate and ok:
                        # The draft cache's own prefill — spec mode's
                        # second admission dispatch (no fence).
                        pf_s += self.engine.draft_prefill(
                            full, bucket, slot_i
                        )
                except ServingEngineFault as e:
                    if res is None:
                        raise
                    rollback(e)
                prefills += 1
                if self.speculate and ok:
                    draft_prefills += 1
                if use:
                    prefix_hits += 1
                    prefill_tokens_saved += plan.offset
                    sev("prefill", id=r.id, bucket=bucket,
                        offset=plan.offset, wall_s=round(pf_s, 6),
                        vclock_ms=round(vclock, 3))
                    sev("prefix_hit", id=r.id, blocks=plan.use,
                        full=False, tokens_saved=plan.offset,
                        vclock_ms=round(vclock, 3))
                    if plan.cow:
                        kv_cows += plan.cow
                        sev("kv_cow", id=r.id, blocks=plan.cow,
                            vclock_ms=round(vclock, 3))
                else:
                    sev("prefill", id=r.id, bucket=bucket,
                        wall_s=round(pf_s, 6),
                        vclock_ms=round(vclock, 3))
            if ok and digests:
                # Index only AFTER the fence validated the install
                # (never make never-written blocks shareable);
                # memoize the first token when the prompt is exactly
                # block-aligned and fresh — the future full-hit
                # upgrade.
                ledger.register_prefix(slot_i, digests, start=use)
                if len(full) == len(r.prompt) and \
                        len(r.prompt) % ledger.block == 0 and \
                        not fullhit:
                    ledger.record_next(digests[-1], int(tok0))
            if jr is not None:
                jr.admit(r.id, len(r.prompt),
                         int(tok0) if ok else None, resumed=len(prior))
            sl = _SchedSlot(
                request=r, pos=len(full), last_tok=tok0,
                tokens=[] if not ok else [tok0], carried=list(prior),
                admit_v=admit_v0, t_wall0=t_wall0, prefill_s=pf_s,
                preempts=n_pre,
            )
            slots[slot_i] = sl
            if not ok:
                finish_slot(slot_i, "non-finite logits in prefill")
                return
            total_tokens += 1
            if slot_done(sl):
                finish_slot(slot_i)

        def scan_retries():
            while retrying and retrying[0][0] <= vclock + 1e-9:
                _t, _rid, r = retrying.pop(0)
                waiting.append(r)

        def expire_waiting():
            nonlocal expiries
            if res is None or not res.expire_waiting:
                return
            for r in [w for w in waiting
                      if math.isfinite(w.deadline_ms)
                      and w.deadline_ms < vclock - 1e-9]:
                waiting.remove(r)
                expiries += 1
                _v, prior, _n = carried.pop(r.id, (None, [], 0))
                sev("request_expire", id=r.id,
                    deadline_ms=round(r.deadline_ms, 3),
                    vclock_ms=round(vclock, 3))
                log("expire", id=r.id)
                sev("request_start", id=r.id,
                    prompt_len=len(r.prompt), bucket=None,
                    slot=None, vclock_ms=round(vclock, 3))
                finish_result(r, prior, (
                    f"expired: deadline {r.deadline_ms:.0f}ms passed "
                    f"at vclock {vclock:.0f}ms"
                ), None, t_wall0)

        def slot_fault(slot_i: int, err: str):
            """Slot-class fault: spend a retry (deterministic
            exponential backoff on the virtual clock) or error out."""
            nonlocal retries
            sl = slots[slot_i]
            r = sl.request
            a = attempts.get(r.id, 0)
            if a >= max_retries:
                finish_slot(slot_i, err)
                return
            attempts[r.id] = a + 1
            backoff = retry_backoff * (2 ** a)
            retries += 1
            carried[r.id] = (sl.admit_v, sl.all_tokens, sl.preempts)
            until = round(vclock + backoff, 3)
            retrying.append((until, r.id, r))
            retrying.sort(key=lambda t: (t[0], t[1]))
            # until_ms is the EXACT eligibility instant scan_retries
            # keys on — the span layer's retry-backoff window edge.
            sev("request_retry", id=r.id, attempt=a + 1,
                backoff_ms=round(backoff, 3), until_ms=until,
                error=err, vclock_ms=round(vclock, 3))
            log("retry", id=r.id, attempt=a + 1,
                backoff=round(backoff, 3))
            slots[slot_i] = None
            if ledger is not None:
                ledger.free(slot_i)
                block_table[slot_i] = 0

        def engine_restart(why: str, phase: str):
            """Engine-class fault: requeue every active slot with its
            carried tokens, rebuild programs/caches/ledger from
            scratch, and bound restarts with the crash-loop budget."""
            nonlocal restarts, ledger, block_table, slots, B
            restarts += 1
            budget = res.max_restarts if res is not None else 0
            # requeued rides the event BEFORE the crash-loop raise so
            # a fleet replica death still records which requests were
            # in flight — the span layer's transplant donor edge.
            sev("engine_restart", restart=restarts, phase=phase,
                error=str(why)[:200], vclock_ms=round(vclock, 3),
                requeued=[sl.request.id for sl in slots
                          if sl is not None])
            log("engine_restart", n=restarts, phase=phase)
            _log.warning("serving engine fault (%s): %s — restart "
                         "%d/%d", phase, why, restarts, budget)
            if res is None or restarts > budget:
                raise ServingCrashLoop(
                    f"serving engine restart budget ({budget}) "
                    f"exhausted: {why}"
                )
            # Degraded-mode rung: repeated decode-phase kernel failure
            # -> fall back loudly to the _einsum_decode oracle.
            if phase == "decode" and res.kernel_fault_rung > 0:
                self._decode_faults += 1
                if self._decode_faults >= res.kernel_fault_rung and \
                        not self._degraded_oracle:
                    self._degraded_oracle = True
                    rung = {"rung": "decode_oracle",
                            "after_faults": self._decode_faults}
                    self.degraded_rungs.append(rung)
                    if not getattr(self.engine, "simulated", False):
                        # Before the restart's capture below.
                        self.ex.decode_kernel = False
                    _log.warning(
                        "degraded mode (decode_oracle): %d decode-"
                        "phase engine faults; the K6 decode kernel is "
                        "off, decode attention runs the plain einsum",
                        self._decode_faults)
                    sev("degraded_mode", **rung)
                    log("degraded", rung="decode_oracle")
            for i, sl in enumerate(slots):
                if sl is None:
                    continue
                carried[sl.request.id] = (sl.admit_v, sl.all_tokens,
                                          sl.preempts)
                waiting.append(sl.request)
                slots[i] = None
            self.engine = self._build_engine()
            B = self.ex.max_batch
            slots = [None] * B
            if ledger is not None:
                ledger = self.ex.make_ledger()
                block_table = np.zeros(
                    (B, ledger.blocks_per_slot), np.int32
                )

        preempt.__enter__()
        try:
            while pending or waiting or retrying or \
                    any(sl is not None for sl in slots):
                scan_arrivals()
                scan_retries()
                if preempt.triggered and drain_armed and not drained:
                    # -- drain-on-SIGTERM: stop admissions, journal
                    # in-flight work (already journaled at every
                    # fence), exit cleanly for the supervisor.
                    drained = True
                    n_flight = sum(1 for sl in slots if sl is not None)
                    n_q = len(waiting) + len(pending) + len(retrying)
                    sev("serving_drain", signum=preempt.signum,
                        in_flight=n_flight, queued=n_q,
                        vclock_ms=round(vclock, 3))
                    log("drain", in_flight=n_flight, queued=n_q)
                    _log.warning(
                        "drain: signal %s — %d in flight, %d queued; "
                        "journal %s carries the remainder",
                        preempt.signum, n_flight, n_q,
                        jr.path if jr is not None else "(none)")
                    if jr is not None:
                        jr.drain(n_flight, n_q)
                    break
                expire_waiting()
                if not waiting and \
                        not any(sl is not None for sl in slots):
                    # Idle gap: jump the virtual clock to the next
                    # arrival or retry-eligibility instant.
                    targets = []
                    if pending:
                        targets.append(pending[0].arrival_ms)
                    if retrying:
                        targets.append(retrying[0][0])
                    vclock = max(vclock, min(targets))
                    log("advance")
                    continue

                # -- admissions (vclock moves per prefill; re-scan) --
                engine_down = False
                while waiting:
                    scan_arrivals()
                    scan_retries()
                    expire_waiting()
                    if not waiting:
                        break
                    waiting.sort(key=self._admit_key)
                    cand = waiting[0]
                    slot_i = next(
                        (i for i, sl in enumerate(slots)
                         if sl is None), None
                    )
                    if slot_i is None:
                        slot_i = try_preempt(cand)
                    if slot_i is None:
                        break
                    plan = None
                    if ledger is not None:
                        # Prefix sharing: planned AFTER any preemption
                        # freed blocks (free() may evict index
                        # entries), so the plan admit() executes is the
                        # one priced here.  Shared blocks never leave
                        # the free list — a hit can admit where a miss
                        # would head-of-line wait.
                        plan = ledger.plan_prefix(
                            cand.prompt,
                            total_len=len(cand.prompt) + len(
                                carried.get(cand.id,
                                            (None, [], 0))[1]),
                        )
                        need = ledger.blocks_for(
                            len(cand.prompt), cand.max_new_tokens
                        ) - plan.use
                        if not ledger.can_admit(need):
                            # Free slot but not enough free KV blocks:
                            # head-of-line wait for block turnover (an
                            # active slot finishing frees its
                            # reservation; the pool covers any single
                            # admissible request, so no livelock).
                            # The event makes the previously log-only
                            # blocking visible to the span layer.
                            sev("kv_wait", id=cand.id,
                                need_blocks=need,
                                free_blocks=ledger.free_blocks,
                                vclock_ms=round(vclock, 3))
                            log("kv_wait", id=cand.id,
                                free_blocks=ledger.free_blocks)
                            break
                    try:
                        admit(cand, slot_i, plan)
                    except ServingEngineFault as e:
                        engine_restart(str(e), "prefill")
                        engine_down = True
                        break
                if engine_down:
                    continue

                # -- shed the overload past the queue-depth bound --
                if pol.shed_depth:
                    while len(waiting) > pol.shed_depth:
                        victim = max(waiting, key=self._shed_key)
                        waiting.remove(victim)
                        sheds += 1
                        sev("request_shed", id=victim.id,
                            tier=victim.priority,
                            queue_depth=len(waiting) + 1,
                            vclock_ms=round(vclock, 3))
                        log("shed", id=victim.id, tier=victim.priority)
                        finish_result(
                            victim, [],
                            f"shed: queue depth > {pol.shed_depth}",
                            None, t_wall0,
                        )

                active = [i for i, sl in enumerate(slots)
                          if sl is not None]
                if not active:
                    continue

                # -- injected faults, at the same before-superstep
                # site as the plain Server (superstep_idx counts
                # raised supersteps too, matching its semantics) --
                if self.injector is not None:
                    try:
                        caches = getattr(self.engine, "caches", None)
                        new_caches, sim_nan = \
                            self.injector.before_superstep(
                                superstep_idx, caches,
                                block_table if ledger is not None
                                else None,
                                slot_row=getattr(self.ex, "slot_row", None),
                            )
                        if new_caches is not None:
                            self.engine.caches = new_caches
                    except ServingFault as f:
                        superstep_idx += 1
                        if slots[f.slot] is not None:
                            slot_fault(f.slot, f"raised fault: {f}")
                        continue
                    except ServingEngineFault as e:
                        superstep_idx += 1
                        engine_restart(str(e), "decode")
                        continue
                else:
                    sim_nan = None

                # -- one fused decode superstep (or speculative
                # round) over the whole batch --
                spec_d = self.speculate
                # Per-superstep slot occupancy, by request id — the
                # compact field the span layer pairs the decision's
                # pre-advance stamp with the superstep's post-advance
                # stamp through (one small list per dispatch).
                occ = [slots[i].request.id for i in active]
                if spec_d:
                    # d is a per-run knob;
                    # adaptive-k is a plain-decode concept.
                    k_eff = spec_d + 1
                    sev("sched_decision", d=spec_d,
                        active=len(active), waiting=len(waiting),
                        policy=pol.name, slots=occ,
                        vclock_ms=round(vclock, 3))
                    log("spec", depth=spec_d, active=len(active),
                        waiting=len(waiting))
                else:
                    k = self._choose_k(slots, len(waiting))
                    k_eff = k
                    sev("sched_decision", k=k, active=len(active),
                        waiting=len(waiting), policy=pol.name,
                        slots=occ, vclock_ms=round(vclock, 3))
                    log("decode", k=k, active=len(active),
                        waiting=len(waiting))
                pos_vec = np.array(
                    [sl.pos if sl else 0 for sl in slots], np.int32
                )
                tok_vec = np.array(
                    [sl.last_tok if sl else 0 for sl in slots], np.int32
                )
                req_vec = np.array(
                    [sl.request.id if sl else 0 for sl in slots],
                    np.int32
                )
                vclock += (model.spec_ms(spec_d) if spec_d
                           else model.decode_ms(k))
                try:
                    if spec_d:
                        toks, oks, accs, wall = self.engine.spec(
                            pos_vec, tok_vec, spec_d,
                            block_table=(block_table.copy()
                                         if ledger is not None
                                         else None),
                            req_ids=req_vec,
                        )
                    else:
                        toks, oks, wall = self.engine.decode(
                            pos_vec, tok_vec, k,
                            block_table=(block_table.copy()
                                         if ledger is not None
                                         else None),
                            req_ids=req_vec,
                        )
                        accs = None
                except ServingEngineFault as e:
                    if res is None:
                        raise
                    superstep_idx += 1
                    engine_restart(str(e), "decode")
                    continue
                if sim_nan is not None and \
                        getattr(self.engine, "simulated", False):
                    # The simulated engine has no caches to poison:
                    # mirror the NaN'd slot as non-finite decodes so
                    # sim decisions match the real engine's exactly.
                    oks = np.array(oks, copy=True)
                    oks[:, sim_nan] = False
                decode_s += wall
                supersteps += 1
                superstep_idx += 1
                # Training-superstep accounting: one host program +
                # one fence covered k_eff decode steps
                # (programs/step == 1/k_eff).
                tel.add_programs(1, steps=k_eff)
                if not spec_d:
                    sev("decode_superstep", k=k,
                        active=len(active), wall_s=round(wall, 6),
                        slots=occ, vclock_ms=round(vclock, 3))
                for j in range(k_eff):
                    tel.record_step((supersteps - 1) * k_eff + j,
                                    wall_s=wall / k_eff)
                emitted_round = 0
                for i in active:
                    sl = slots[i]
                    if sl is None:
                        continue
                    err = None
                    appended: List[int] = []
                    if spec_d:
                        n_take = int(accs[i]) + 1
                        spec_accept_total += int(accs[i])
                    else:
                        n_take = k
                    for j in range(n_take):
                        if not bool(oks[j, i]):
                            err = "non-finite logits in decode"
                            break
                        tok = int(toks[j, i])
                        sl.tokens.append(tok)
                        appended.append(tok)
                        sl.pos += 1
                        total_tokens += 1
                        if slot_done(sl):
                            break
                    sl.last_tok = sl.tokens[-1] if sl.tokens else 0
                    decode_tokens += len(appended)
                    emitted_round += len(appended)
                    # Journal the fence-validated token delta BEFORE
                    # any completion record (replay folds in order) —
                    # under speculation ``appended`` holds ACCEPTED
                    # tokens only, so resume semantics are unchanged.
                    if jr is not None and appended:
                        jr.tokens(sl.request.id, appended)
                    if err is not None:
                        slot_fault(i, err)
                    elif slot_done(sl):
                        finish_slot(i)
                if spec_d:
                    acc_round = int(sum(int(accs[i]) for i in active))
                    spec_draft_total += spec_d * len(active)
                    sev("spec_verify", d=spec_d,
                        active=len(active), accepted=acc_round,
                        draft=spec_d * len(active),
                        emitted=emitted_round,
                        wall_s=round(wall, 6), slots=occ,
                        vclock_ms=round(vclock, 3))
        finally:
            preempt.__exit__(None, None, None)
            if jr is not None:
                jr.close()

        elapsed = time.perf_counter() - t_wall0
        # Per-request virtual-clock splits, exposed for the measure
        # tool and tests (per-tier percentile analysis — the class the
        # SLO policy protects is not visible in the global p99).
        self.last_queue_waits = dict(qwaits)
        self.last_e2es = dict(e2es)
        self.last_slo_oks = dict(slo_oks)
        stats = self._stats(results, qwaits, e2es, slo_oks, sheds,
                            preempts, prefills, supersteps,
                            total_tokens, decode_s, elapsed)
        if ledger is not None and ledger.prefix_cache:
            stats["prefix_cache"] = True
            stats["prefix_hits"] = prefix_hits
            stats["prefix_hit_rate"] = round(
                prefix_hits / max(prefills + full_hits, 1), 4
            )
            stats["prefill_tokens_saved"] = prefill_tokens_saved
            stats["kv_cows"] = kv_cows
            if prefix_hits:
                # Same formula and gating as the plain Server loop;
                # reconstruct_summary recomputes both from the raw
                # prefill/prefix_hit events and must match bit-for-bit.
                tel.note_summary(
                    prefix_hit_rate=stats["prefix_hit_rate"],
                    prefill_tokens_saved=prefill_tokens_saved,
                )
        if self.speculate:
            stats["speculate"] = self.speculate
            stats["draft_layers"] = getattr(self.ex, "draft_layers", 0)
            stats["draft_prefills"] = draft_prefills
            stats["spec_acceptance_rate"] = round(
                spec_accept_total / max(spec_draft_total, 1), 4
            )
            stats["spec_tokens_per_dispatch"] = round(
                decode_tokens / max(supersteps, 1), 3
            )
        stats["request_retries"] = retries
        stats["request_expiries"] = expiries
        stats["engine_restarts"] = restarts
        if res is not None or jr is not None:
            stats["drained"] = drained
        if self.degraded_rungs:
            stats["degraded_rungs"] = [
                d["rung"] for d in self.degraded_rungs
            ]
        tel.note_summary(**{
            kk: stats[kk] for kk in (
                "queue_wait_ms_p50", "queue_wait_ms_p95",
                "queue_wait_ms_p99", "request_sheds",
                "request_preempts", "request_retries",
                "request_expiries", "engine_restarts",
                "spec_acceptance_rate", "spec_tokens_per_dispatch",
            ) if kk in stats
        }, **({"slo_attainment": stats["slo_attainment"]}
              if "slo_attainment" in stats else {}))
        # Tail autopsy (OBSERVABILITY.md "Reading a request"): fold
        # the run's OWN emitted serving events through the same span
        # layer a log reader runs, so the stats block and the log-only
        # reconstruction agree bit-for-bit.
        autopsy = _spans.slo_autopsy(
            _spans.build_timelines(span_events))
        if autopsy:
            stats["slo_autopsy"] = autopsy
            tel.note_summary(slo_autopsy=autopsy)
        return results, tel.fold_stats(stats)

    # -- stats --------------------------------------------------------------

    def _stats(self, results, qwaits, e2es, slo_oks, sheds, preempts,
               prefills, supersteps, total_tokens, decode_s, elapsed):
        lats = sorted(
            r.latency_s for r in results.values() if r.error is None
        )

        def pct(vals: List[float], p: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1,
                            int(round(p * (len(vals) - 1))))]

        qs = sorted(qwaits.values())
        es = sorted(e2es.values())
        stats: Dict[str, Any] = {
            "requests": len(results),
            "completed": sum(
                1 for r in results.values() if r.error is None),
            "failed": sum(1 for r in results.values() if r.error),
            "tokens": total_tokens,
            "elapsed_s": elapsed,
            "tokens_per_s": total_tokens / max(elapsed, 1e-9),
            "decode_supersteps": supersteps,
            "decode_steps_per_call": self.decode_steps,
            "decode_s": decode_s,
            "prefills": prefills,
            "policy": self.policy.name,
            "request_latency_ms_p50": round(pct(lats, 0.50) * 1e3, 3),
            "request_latency_ms_p95": round(pct(lats, 0.95) * 1e3, 3),
            "request_latency_ms_p99": round(pct(lats, 0.99) * 1e3, 3),
            # Virtual-clock latency split (deterministic, SERVING.md):
            # the same rounded per-request values the request_end
            # events carry, so obs reconstruction is bit-identical.
            "queue_wait_ms_p50": round(pct(qs, 0.50), 3),
            "queue_wait_ms_p95": round(pct(qs, 0.95), 3),
            "queue_wait_ms_p99": round(pct(qs, 0.99), 3),
            "e2e_ms_p50": round(pct(es, 0.50), 3),
            "e2e_ms_p99": round(pct(es, 0.99), 3),
            "request_sheds": sheds,
            "request_preempts": preempts,
            "programs_per_decode_superstep": 1,
            # Cache-layout columns (SERVING.md "Cache layout"): the
            # executor OR the simulated SlotShape carries them, so
            # predicted and measured stats line up column-for-column.
            "kv_layout": ("paged" if getattr(self.ex, "paged", False)
                          else "padded"),
            "shard": (list(self.ex.shard)
                      if getattr(self.ex, "shard", None) else None),
            "sampled": self.sample is not None,
        }
        if getattr(self.ex, "paged", False):
            stats["kv_block"] = self.ex.kv_block
            stats["kv_blocks"] = self.ex.kv_blocks
        if slo_oks:
            stats["slo_attainment"] = round(
                sum(slo_oks.values()) / len(slo_oks), 4
            )
        return stats
