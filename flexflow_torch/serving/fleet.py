"""Fleet-scale serving: N replicas behind a failure-aware router, the
port of ``flexflow_tpu/serving/fleet.py``, decision for decision.

One :class:`~flexflow_torch.serving.scheduler.ScheduledServer` is one
serving engine; heavy traffic takes N of them.  The :class:`FleetRouter`
fronts the replicas on the same deterministic virtual clock the
single-replica scheduler runs on: arrivals are absolute
(``Request.arrival_ms``), every routing decision is made at the
request's arrival instant against modeled replica load, and the
per-replica decision logs merge into one fleet-wide event queue
(:meth:`FleetRouter.merged_decisions`) ordered by virtual time, so a
fleet run replays on any box exactly like a single-replica run.  The
routing arithmetic is the JAX package's, in Python floats and numpy,
rounded at the same sites, so the two packages route alike.

**Routing policies** (deterministic keys, lowest index breaks ties):

- ``least-loaded``: argmin modeled outstanding ms, where each routed
  request adds ``est_cost / advertised_slots`` to its replica's load; a
  replica on a degraded rung advertises reduced capacity
  (``ScheduledServer.advertised_capacity``) and its load grows faster.
- ``tier-aware``: tier-0 traffic orders replicas by (degraded rungs,
  outstanding), so the latency-critical class prefers the least-degraded
  replica; other tiers fall back to least-loaded.
- ``affinity``: sticky keyed placement, a seeded draw over the live
  replicas keyed by the prompt's prefix hash
  (``default_rng([affinity_seed, first_block_digest])``: the first
  ``kv_block``-token chained digest of ``prefix_digests`` on the paged
  layout, a whole-prompt sha1 otherwise), so requests sharing a
  system-prompt span land on the replica whose prefix cache is warm.

**Replica loss.**  Each replica journals to its own request journal.
When an engine fault exhausts a replica's restart budget its ``run``
raises ``ServingCrashLoop``; the router marks the replica dead, releases
its engine (graphs, caches and carry dropped at once, outside any
capture, before a survivor runs), replays its journal (completed
requests keep their recorded results) and redistributes the unfinished
rest to the survivors: a journaled in-flight prefix is transplanted into
the target survivor's journal (an ``sv_admit`` + ``sv_tokens`` pair), so
the survivor's ordinary journal-replay prelude resumes it by a
re-prefill over ``prompt ‖ carried``.  Replicas share params and greedy
decode follows the full-sequence forward, so a request's tokens do not
depend on the replica that finishes it (in f32; in bf16 a re-prefill
rounds apart from decode).  When the last replica dies the fleet raises
:class:`FleetCrashLoop`, which an app maps to ``EXIT_FLEET_FAILURE``
(78) beside 76 (world) and 77 (one serving engine).

**Simulation.**  :meth:`FleetRouter.simulated` builds the fleet from
``ScheduledServer.simulated`` replicas, each journaling to a
:class:`~flexflow_torch.serving.journal.MemoryJournal`: routing,
redistribution and the journal fold run the same code as the real
fleet, so a simulated fleet is decision- and dispatch-exact through a
replica loss (same fault plans, EOS off), and ``serving/search.py``
prices replica count x router policy with it.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from flexflow_torch.obs import spans as _spans
from flexflow_torch.runtime import telemetry as _telemetry
from flexflow_torch.runtime.serving import (
    Request,
    RequestResult,
    ServingCrashLoop,
    prefix_digests,
)
from flexflow_torch.serving.journal import JournalState, MemoryJournal
from flexflow_torch.serving.scheduler import ScheduledServer

_log = logging.getLogger("ff.serving.fleet")

#: Router admission policies (deterministic).
ROUTER_POLICIES = ("least-loaded", "tier-aware", "affinity")

#: Exit code for a fleet-wide crash (every replica dead), beside 76
#: (the elastic world) and 77 (one serving engine).
EXIT_FLEET_FAILURE = 78


class FleetCrashLoop(RuntimeError):
    """Every replica of the fleet is dead with work left: an app exits
    ``EXIT_FLEET_FAILURE`` (78) for an external supervisor."""


#: Per-run scheduler counters summed across replica runs into the fleet
#: stats (a crashed run contributes nothing, in real and simulated
#: fleets alike).
_AGG_KEYS = (
    "prefills", "decode_supersteps", "request_sheds",
    "request_preempts", "request_retries", "request_expiries",
    "engine_restarts",
)


class FleetRouter:
    """N ``ScheduledServer`` replicas behind deterministic routing and
    journal-backed redistribution (the module docstring has the story)."""

    def __init__(self, replicas: Sequence[ScheduledServer],
                 router: str = "least-loaded", affinity_seed: int = 0):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        if router not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {router!r} "
                f"(have: {', '.join(ROUTER_POLICIES)})"
            )
        self.replicas: List[ScheduledServer] = list(replicas)
        self.router = router
        self.affinity_seed = int(affinity_seed)
        #: The fleet's replayable decision log (route / redistribute /
        #: replica_loss), virtual-clock stamped like each replica's
        #: ``ScheduledServer.decisions``.
        self.decisions: List[Dict[str, Any]] = []
        #: Indices of the replicas marked dead, in death order.
        self.dead: List[int] = []
        self.redistributed = 0
        self.replica_stats: List[Optional[Dict[str, Any]]] = \
            [None] * len(self.replicas)
        self._load = [0.0] * len(self.replicas)
        self._owned: List[Dict[int, Request]] = \
            [{} for _ in self.replicas]
        #: The fleet-merged serving event stream in telemetry-stream order
        #: (router events between each replica's contiguous run blocks):
        #: the input of the fleet's ``slo_autopsy``, equal to folding the
        #: log on disk.
        self.span_events: List[Dict[str, Any]] = []
        self._span_taken = [0] * len(self.replicas)

    @classmethod
    def simulated(
        cls,
        shape,
        n_replicas: int,
        router: str = "least-loaded",
        decode_steps: int = 8,
        policy=None,
        latency_model=None,
        resilience=None,
        fault_injectors: Optional[Dict[int, Any]] = None,
        speculate: int = 0,
        journals: Optional[Sequence[Any]] = None,
        affinity_seed: int = 0,
    ) -> "FleetRouter":
        """The compute-free fleet: ``n_replicas`` simulated servers on one
        ``SlotShape``, each journaling to a ``MemoryJournal`` (or the
        caller's ``journals[i]``); ``fault_injectors`` maps a replica's
        index to its ``ServingFaultInjector`` plan."""
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        reps = []
        for i in range(int(n_replicas)):
            jr = journals[i] if journals is not None else MemoryJournal()
            reps.append(ScheduledServer.simulated(
                shape, decode_steps=decode_steps, policy=policy,
                latency_model=latency_model, resilience=resilience,
                journal=jr,
                fault_injector=(fault_injectors or {}).get(i),
                speculate=speculate,
            ))
        return cls(reps, router=router, affinity_seed=affinity_seed)

    # -- the fleet-merged span stream ---------------------------------------

    def _sev(self, tel, name: str, **fields) -> None:
        """A router-level serving event: telemetry and the merged span
        stream."""
        self.span_events.append({"ev": name, **fields})
        tel.emit(name, **fields)

    def _collect_spans(self, i: int) -> None:
        """Fold replica ``i``'s serving events since the last collect into
        the merged stream, right after each of its runs (crashed or not),
        so each replica's block stays contiguous and in execution order,
        as in the telemetry stream."""
        buf = self.replicas[i].span_events
        self.span_events.extend(buf[self._span_taken[i]:])
        self._span_taken[i] = len(buf)

    # -- routing ------------------------------------------------------------

    def _est_cost_ms(self, srv: ScheduledServer, r: Request) -> float:
        """Modeled serial cost of one request on one replica, the unit of
        load: prefill and decode rounds at the replica's k (``spec_ms``
        rounds when it speculates)."""
        model = srv.model
        try:
            bucket = srv.ex.bucket_for(len(r.prompt))
        except ValueError:
            bucket = max(srv.ex.buckets)
        new = max(int(r.max_new_tokens), 1)
        if srv.speculate:
            rounds = -(-new // (srv.speculate + 1))
            return (model.expected_prefill_ms(bucket)
                    + model.draft_prefill_ms(bucket)
                    + model.spec_ms(srv.speculate) * rounds)
        k = max(srv.decode_steps, 1)
        return model.expected_prefill_ms(bucket) \
            + model.decode_ms(k) * (-(-new // k))

    def _affinity_key(self, r: Request) -> int:
        """The sticky key: the prompt's first-block chained digest on the
        paged layout (the prefix-cache index key), a whole-prompt sha1
        otherwise."""
        ex = self.replicas[0].ex
        blk = int(getattr(ex, "kv_block", 0) or 0)
        toks = np.asarray(r.prompt, np.int64)
        if blk > 0 and len(toks) >= blk:
            digest = prefix_digests(toks, blk)[0]
        else:
            digest = hashlib.sha1(toks.tobytes()).digest()
        return int.from_bytes(digest[:8], "big")

    def _route(self, r: Request, live: List[int]) -> int:
        """The replica for ``r`` at its arrival instant, from modeled load
        and advertised capacity (host arithmetic only)."""
        t = float(r.arrival_ms)
        cand = sorted(live)
        if self.router == "affinity":
            rng = np.random.default_rng(
                [self.affinity_seed, self._affinity_key(r)]
            )
            i = cand[int(rng.integers(0, len(cand)))]
        else:
            best_i, best_key = None, None
            for i in cand:
                cap = self.replicas[i].advertised_capacity()
                out = max(self._load[i] - t, 0.0)
                if self.router == "tier-aware" and r.priority == 0:
                    key = (cap["degraded"], out, i)
                else:
                    key = (out, i)
                if best_key is None or key < best_key:
                    best_i, best_key = i, key
            i = best_i
        slots = max(
            self.replicas[i].advertised_capacity()["slots"], 1
        )
        self._load[i] = max(self._load[i], t) + \
            self._est_cost_ms(self.replicas[i], r) / slots
        return i

    # -- replica loss and redistribution ------------------------------------

    def _on_replica_loss(self, i: int, why: str, live: List[int],
                         queue: Dict[int, List[Request]],
                         results: Dict[int, RequestResult],
                         qwaits, e2es, slo_oks, tel) -> None:
        live.remove(i)
        self.dead.append(i)
        srv = self.replicas[i]
        # Free its engine now: its graphs die here, between runs, never
        # during a survivor's capture.
        srv.release()
        st = srv.journal.replay() if srv.journal is not None \
            else JournalState(completed={}, in_flight={})
        # Completed requests keep their journaled results, never re-run,
        # with their metrics restored as a journal resume restores them.
        for rid, rec in st.completed.items():
            if rid in results:
                continue
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
        remaining = [r for rid, r in sorted(self._owned[i].items())
                     if rid not in results]
        v = round(float(srv.decisions[-1]["v"]), 3) \
            if srv.decisions else 0.0
        self.decisions.append({
            "d": "replica_loss", "v": v, "replica": i,
            "in_flight": len(st.in_flight),
            "redistributed": len(remaining), "survivors": len(live),
        })
        self._sev(tel, "replica_loss", replica=i, error=str(why)[:200],
                  completed=len(st.completed),
                  in_flight=len(st.in_flight),
                  redistributed=len(remaining), survivors=len(live),
                  vclock_ms=v)
        _log.warning(
            "replica %d dead (%s): %d journaled complete, %d in "
            "flight; redistributing %d request(s) across %d "
            "survivor(s)", i, why, len(st.completed),
            len(st.in_flight), len(remaining), len(live),
        )
        if not live:
            return  # the caller raises FleetCrashLoop
        for r in remaining:
            toks = st.in_flight.get(r.id)
            j = self._route(r, live)
            if toks:
                try:
                    # The resume re-prefills over prompt ‖ carried: the
                    # whole prefix must fit a survivor bucket.
                    self.replicas[j].ex.bucket_for(
                        len(r.prompt) + len(toks))
                except ValueError:
                    _log.warning(
                        "request %d's carried prefix (%d prompt + %d "
                        "generated) exceeds replica %d's largest pad "
                        "bucket: dropping the prefix; the request "
                        "restarts from its prompt and regenerates the "
                        "same tokens", r.id, len(r.prompt), len(toks), j,
                    )
                    toks = None
            if toks:
                jr = self.replicas[j].journal
                if jr is not None:
                    # Transplant the dead replica's fence-validated
                    # prefix: the survivor's replay prelude resumes it.
                    jr.admit(r.id, len(r.prompt), None,
                             resumed=len(toks))
                    jr.tokens(r.id, list(toks))
                else:
                    _log.warning(
                        "replica %d has no journal: request %d restarts "
                        "from its prompt on redistribution (same output, "
                        "the carried prefix regenerated)", j, r.id,
                    )
            queue[j].append(r)
            self._owned[j][r.id] = r
            del self._owned[i][r.id]
            self.redistributed += 1
            self.decisions.append({
                "d": "redistribute", "v": round(float(r.arrival_ms), 3),
                "id": r.id, "from": i, "to": j,
                "carried": len(toks or ()),
            })
            self._sev(tel, "replica_route", id=r.id, replica=j,
                      policy=self.router, redistributed=True,
                      vclock_ms=round(float(r.arrival_ms), 3))

    # -- the fleet loop -----------------------------------------------------

    def run(self, requests: Sequence[Request]):
        """Route, run every live replica on the shared virtual timeline,
        absorb replica losses; returns ``(results, stats)`` merged across
        the fleet.  Raises :class:`FleetCrashLoop` when the last replica
        dies with work left."""
        tel = _telemetry.current()
        t0 = time.perf_counter()
        n = len(self.replicas)
        live = [i for i in range(n) if i not in self.dead]
        queue: Dict[int, List[Request]] = {i: [] for i in range(n)}
        for r in sorted(requests, key=lambda r: (r.arrival_ms, r.id)):
            i = self._route(r, live)
            queue[i].append(r)
            self._owned[i][r.id] = r
            self.decisions.append({
                "d": "route", "v": round(float(r.arrival_ms), 3),
                "id": r.id, "replica": i,
            })
            self._sev(tel, "replica_route", id=r.id, replica=i,
                      policy=self.router,
                      vclock_ms=round(float(r.arrival_ms), 3))
        results: Dict[int, RequestResult] = {}
        qwaits: Dict[int, float] = {}
        e2es: Dict[int, float] = {}
        slo_oks: Dict[int, bool] = {}
        agg = {k: 0 for k in _AGG_KEYS}
        rounds = 0
        while True:
            rounds += 1
            crashed = []
            for i in list(live):
                if rounds > 1 and not queue[i]:
                    continue
                batch, queue[i] = queue[i], []
                try:
                    res_i, st_i = self.replicas[i].run(batch)
                except ServingCrashLoop as e:
                    # What the dying replica emitted up to the crash: the
                    # transplant's donor segment.
                    self._collect_spans(i)
                    crashed.append((i, str(e)))
                    continue
                self._collect_spans(i)
                results.update(res_i)
                srv = self.replicas[i]
                qwaits.update(srv.last_queue_waits)
                e2es.update(srv.last_e2es)
                slo_oks.update(srv.last_slo_oks)
                self.replica_stats[i] = st_i
                for k in _AGG_KEYS:
                    agg[k] += int(st_i.get(k) or 0)
            if not crashed:
                break
            for i, why in crashed:
                self._on_replica_loss(i, why, live, queue, results,
                                      qwaits, e2es, slo_oks, tel)
            if not live:
                tel.emit("fleet_state", replicas=n, live=0,
                         dead=len(self.dead), router=self.router,
                         redistributed=self.redistributed,
                         requests=len(results), rounds=rounds)
                raise FleetCrashLoop(
                    f"all {n} replicas dead (last: {crashed[-1][1]}) "
                    "— unserved work remains, no peer can absorb it"
                )
        elapsed = time.perf_counter() - t0
        self.last_queue_waits = dict(qwaits)
        self.last_e2es = dict(e2es)
        self.last_slo_oks = dict(slo_oks)
        stats = self._stats(results, qwaits, e2es, slo_oks, agg,
                            live, rounds, elapsed)
        tel.emit("fleet_state", replicas=n, live=len(live),
                 dead=len(self.dead), router=self.router,
                 redistributed=self.redistributed,
                 requests=len(results), rounds=rounds)
        tel.note_summary(fleet_replicas=n,
                         fleet_dead_replicas=len(self.dead),
                         fleet_redistributed=self.redistributed,
                         **({"slo_autopsy": stats["slo_autopsy"]}
                            if "slo_autopsy" in stats else {}))
        return results, stats

    # -- stats and the merged event queue -----------------------------------

    def _stats(self, results, qwaits, e2es, slo_oks, agg, live,
               rounds, elapsed) -> Dict[str, Any]:
        def pct(vals: List[float], p: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1,
                            int(round(p * (len(vals) - 1))))]

        qs = sorted(qwaits.values())
        es = sorted(e2es.values())
        tokens = sum(len(r.tokens) for r in results.values())
        r0 = self.replicas[0]
        stats: Dict[str, Any] = {
            "requests": len(results),
            "completed": sum(
                1 for r in results.values() if r.error is None),
            "failed": sum(1 for r in results.values() if r.error),
            "tokens": tokens,
            "elapsed_s": elapsed,
            "tokens_per_s": tokens / max(elapsed, 1e-9),
            "decode_steps_per_call": r0.decode_steps,
            "policy": r0.policy.name,
            "router": self.router,
            "replicas": len(self.replicas),
            "live_replicas": len(live),
            "dead_replicas": len(self.dead),
            "redistributed": self.redistributed,
            "rounds": rounds,
            "replica_capacity": [
                0 if i in self.dead
                else self.replicas[i].advertised_capacity()["slots"]
                for i in range(len(self.replicas))
            ],
            "queue_wait_ms_p50": round(pct(qs, 0.50), 3),
            "queue_wait_ms_p95": round(pct(qs, 0.95), 3),
            "queue_wait_ms_p99": round(pct(qs, 0.99), 3),
            "e2e_ms_p50": round(pct(es, 0.50), 3),
            "e2e_ms_p99": round(pct(es, 0.99), 3),
            "programs_per_decode_superstep": 1,
            "kv_layout": ("paged" if getattr(r0.ex, "paged", False)
                          else "padded"),
            "shard": (list(r0.ex.shard)
                      if getattr(r0.ex, "shard", None) else None),
            "sampled": r0.sample is not None,
        }
        if getattr(r0.ex, "paged", False):
            stats["kv_block"] = r0.ex.kv_block
            stats["kv_blocks"] = r0.ex.kv_blocks
        stats.update(agg)
        if slo_oks:
            stats["slo_attainment"] = round(
                sum(slo_oks.values()) / len(slo_oks), 4
            )
        if any(st and st.get("drained") for st in self.replica_stats):
            stats["drained"] = True
        # The fleet's tail autopsy over the merged span stream: a
        # transplanted request folds with its donor segment archived.
        autopsy = _spans.slo_autopsy(
            _spans.build_timelines(self.span_events))
        if autopsy:
            stats["slo_autopsy"] = autopsy
        return stats

    def merged_decisions(self) -> List[Dict[str, Any]]:
        """The one merged fleet event queue: router and per-replica
        decisions by virtual-clock stamp (router entries first at equal
        instants, then replica index, then source order)."""
        merged = []
        for seq, d in enumerate(self.decisions):
            merged.append(
                (float(d.get("v", 0.0)), -1, seq,
                 dict(d, src="router"))
            )
        for i, srv in enumerate(self.replicas):
            for seq, d in enumerate(srv.decisions):
                merged.append(
                    (float(d.get("v", 0.0)), i, seq,
                     dict(d, src=f"replica{i}"))
                )
        merged.sort(key=lambda t: (t[0], t[1], t[2]))
        return [d for _, _, _, d in merged]
