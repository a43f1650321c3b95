"""The port's serving fleet and config search (``flexflow_torch/serving/
fleet.py``, ``search.py``), held against the JAX package's on the CPU.

- The simulated fleet makes JAX's decisions: ``decisions``,
  ``merged_decisions()``, the virtual-clock stats and the merged span
  events (wall fields left out) are equal, exactly, for the three routers
  with and without a replica loss, and the dead replica's transplanted
  journal records are JAX's.
- Routing: affinity sends a shared-prefix group to one replica, the
  tier-aware router steers tier 0 off a degraded replica, a replica with
  fewer slots takes less of the load.
- The real fleet on a tiny f32 LM with JAX's weights carried over: its
  greedy tokens, decisions and journal records equal JAX's real fleet's
  (JAX's executor on ``decode_kernel=False``, its einsum decode), with
  and without a replica loss; after the loss the tokens equal an
  unfaulted single-replica port run's; inside the port the simulated
  fleet decides and dispatches as the real one; the dead replica's
  engine is released.
- The search: ``ServingConfig`` validates as JAX's, and
  ``search_serving_config`` ranks JAX's candidates with JAX's predicted
  p99 and dispatches and picks JAX's config, single, paged and fleet;
  the chosen config runs on a real port executor with the predicted
  dispatches.
- The app: ``--replicas``, ``--router``, ``--journal`` fanned out,
  ``--serve-auto``, the dry run's fleet line, exit 78 when every replica
  dies, ``--workload-trace prod`` on JAX's production workload, and the
  chaos scenario ``replica_loss``.
"""

import weakref

import jax
import numpy as np
import pytest

from flexflow_tpu import serving as jsv
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime import serving as jrs
from flexflow_torch import serving as tsv
from flexflow_torch.apps import serve as tserve
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.runtime import chaos
from flexflow_torch.runtime import serving as trs
from flexflow_torch.weights import params_from_numpy

V, D, H, L, S = 64, 32, 2, 2, 32

#: Stats that do not read the wall clock.
VIRT = ("requests", "completed", "failed", "tokens", "decode_steps_per_call",
        "policy", "router", "replicas", "live_replicas", "dead_replicas",
        "redistributed", "rounds", "replica_capacity", "queue_wait_ms_p50",
        "queue_wait_ms_p95", "queue_wait_ms_p99", "e2e_ms_p50", "e2e_ms_p99",
        "programs_per_decode_superstep", "kv_layout", "shard", "sampled",
        "kv_block", "kv_blocks", "prefills", "decode_supersteps",
        "request_sheds", "request_preempts", "request_retries",
        "request_expiries", "engine_restarts", "slo_attainment", "drained",
        "slo_autopsy")
#: Event and record fields that carry wall time.
WALL = ("wall_s", "latency_s", "prefill_s")

BURSTY = dict(n_requests=12, vocab=V, prompt_len=(3, 6), max_new=(2, 10),
              mean_gap_ms=1.0, burst=6, priorities=3, slo_ms=60.0, seed=5)


def _virt(stats):
    return {k: stats[k] for k in VIRT if k in stats}


def _strip(recs):
    return [{k: v for k, v in e.items() if k not in WALL} for e in recs]


def _req(pkg, rid, plen, max_new, arrival_ms=0.0, priority=0,
         slo_ms=float("inf")):
    return pkg.Request(id=rid,
                       prompt=np.arange(1, plen + 1, dtype=np.int32) * 3 % V,
                       max_new_tokens=max_new, arrival_ms=arrival_ms,
                       priority=priority, slo_ms=slo_ms)


def _sim_fleet(pkg, rt, n=2, router="least-loaded", loss=False, shape=None,
               **kw):
    inj = {0: rt.ServingFaultInjector(engine_raise_at={1: "sim death"})} \
        if loss else None
    return pkg.FleetRouter.simulated(
        shape or pkg.SlotShape(max_batch=2, max_seq=S, buckets=(8, S)), n,
        router=router, decode_steps=4,
        policy=pkg.SchedulerPolicy(name="slo"),
        resilience=pkg.ServingResilience(max_restarts=0) if loss else None,
        fault_injectors=inj, **kw)


def _outcome(fleet, res, stats):
    return (fleet.decisions, fleet.merged_decisions(), _virt(stats),
            _strip(fleet.span_events), fleet.dead,
            {i: (r.tokens, r.error) for i, r in res.items()},
            [_strip(getattr(r.journal, "records", []))
             for r in fleet.replicas])


# -- the simulated fleet against JAX's ----------------------------------------


@pytest.mark.parametrize("loss", [False, True])
@pytest.mark.parametrize("router", ["least-loaded", "tier-aware", "affinity"])
def test_simulated_fleet_matches_jax(router, loss):
    out = []
    for pkg, rt in ((jsv, jrs), (tsv, trs)):
        fleet = _sim_fleet(pkg, rt, 3, router, loss)
        res, stats = fleet.run(pkg.make_workload(pkg.WorkloadSpec(**BURSTY)))
        out.append(_outcome(fleet, res, stats))
    assert out[0] == out[1]
    decisions, _m, stats, *_ = out[1]
    assert stats["completed"] == BURSTY["n_requests"]
    assert stats["dead_replicas"] == (1 if loss else 0)
    if loss:
        assert stats["redistributed"] > 0 and any(
            d["carried"] for d in decisions if d["d"] == "redistribute")


def test_paged_prefix_fleet_and_fleet_crash_match_jax():
    """The paged fleet with the prefix cache (the affinity key is the first
    block's digest) and a fleet whose every replica dies."""
    out = []
    for pkg, rt in ((jsv, jrs), (tsv, trs)):
        shape = pkg.SlotShape(max_batch=2, max_seq=S, buckets=(8, 16, S),
                              kv_block=8, prefix_cache=True)
        fleet = _sim_fleet(pkg, rt, 2, "affinity", loss=True, shape=shape)
        res, st = fleet.run(pkg.make_workload(pkg.WorkloadSpec(
            **dict(BURSTY, shared_prefix=8, prompt_len=(4, 12)))))
        dead = pkg.FleetRouter.simulated(
            shape, 2, decode_steps=4,
            resilience=pkg.ServingResilience(max_restarts=0),
            fault_injectors={i: rt.ServingFaultInjector(
                engine_raise_at={1: "x"}) for i in range(2)})
        with pytest.raises(pkg.FleetCrashLoop) as e:
            dead.run(pkg.make_workload(pkg.WorkloadSpec(**BURSTY)))
        out.append((_outcome(fleet, res, st), str(e.value), dead.dead,
                    dead.decisions))
    assert out[0] == out[1]
    assert "all 2 replicas dead" in out[1][1] and sorted(out[1][2]) == [0, 1]
    assert tsv.EXIT_FLEET_FAILURE == jsv.EXIT_FLEET_FAILURE == 78


def test_router_validation_matches_jax():
    for pkg in (jsv, tsv):
        with pytest.raises(ValueError, match="at least one"):
            pkg.FleetRouter([])
        with pytest.raises(ValueError, match="unknown router"):
            _sim_fleet(pkg, None, router="round-robin")
        with pytest.raises(ValueError, match="n_replicas"):
            pkg.FleetRouter.simulated(
                pkg.SlotShape(max_batch=2, max_seq=S, buckets=(8,)), 0)
    assert tsv.ROUTER_POLICIES == jsv.ROUTER_POLICIES


# -- routing ------------------------------------------------------------------


def test_affinity_keeps_a_shared_prefix_group_on_one_replica():
    homes = []
    for pkg, rt in ((jsv, jrs), (tsv, trs)):
        fleet = _sim_fleet(pkg, rt, 3, "affinity", shape=pkg.SlotShape(
            max_batch=2, max_seq=S, buckets=(8, S), kv_block=8, kv_blocks=17,
            prefix_cache=True))
        span, other = np.arange(1, 9), np.arange(9, 17)

        def shared(rid, tail, base=span):
            return rt.Request(id=rid, prompt=np.concatenate(
                [base, tail]).astype(np.int32), max_new_tokens=4,
                arrival_ms=float(rid))

        fleet.run([shared(0, [30]), shared(1, [31, 32]), shared(2, []),
                   shared(3, [40], other), shared(4, [], other),
                   _req(rt, 5, 3, 4, 5.0), _req(rt, 6, 3, 4, 6.0)])
        homes.append({d["id"]: d["replica"] for d in fleet.decisions
                      if d["d"] == "route"})
    assert homes[0] == homes[1]
    got = homes[1]
    assert got[0] == got[1] == got[2] and got[3] == got[4]
    assert got[5] == got[6]


def test_tier_aware_avoids_a_degraded_replica_and_slots_weigh_load():
    fleet = _sim_fleet(tsv, trs, 2, "tier-aware")
    fleet.replicas[0].degraded_rungs.append({"rung": "decode_oracle"})
    reqs = [_req(trs, i, 4, 4, priority=i % 2, slo_ms=60.0)
            for i in range(6)]
    fleet.run(reqs)
    routed = {d["id"]: d["replica"] for d in fleet.decisions
              if d["d"] == "route"}
    assert all(routed[r.id] == 1 for r in reqs if r.priority == 0)
    assert any(routed[r.id] == 0 for r in reqs if r.priority == 1)
    fleet = _sim_fleet(tsv, trs, 2)
    fleet.replicas[0].ex = tsv.SlotShape(max_batch=1, max_seq=S,
                                         buckets=(8, S))
    fleet.run([_req(trs, i, 4, 8) for i in range(8)])
    routed = [d["replica"] for d in fleet.decisions if d["d"] == "route"]
    assert routed.count(1) > routed.count(0)


# -- the real fleet -----------------------------------------------------------


@pytest.fixture(scope="module")
def lms():
    kw = dict(batch_size=2, seq_len=S, vocab_size=V, d_model=D, num_heads=H,
              num_layers=L)
    jlm = jbuild(config=JConfig(batch_size=2), **kw)
    tlm = tbuild(config=TConfig(batch_size=2), **kw)
    jex = jrs.ServingExecutor(jlm, max_batch=2, max_seq=S, buckets=(8, S),
                              decode_kernel=False)
    jparams, jstate = jex.init(seed=0)
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jex, jparams, jstate, tlm, tparams


def _real_fleet(pkg, rt, executors, params, state, loss, router):
    inj = rt.ServingFaultInjector(engine_raise_at={1: "replica down"})
    return pkg.FleetRouter([pkg.ScheduledServer(
        ex, params, state, decode_steps=4,
        policy=pkg.SchedulerPolicy(name="slo"),
        resilience=pkg.ServingResilience(max_restarts=0),
        journal=pkg.MemoryJournal(),
        fault_injector=inj if loss and i == 0 else None)
        for i, ex in enumerate(executors)], router=router)


def _small(pkg):
    return pkg.make_workload(pkg.WorkloadSpec(
        n_requests=8, vocab=V, prompt_len=(3, 6), max_new=(2, 8),
        mean_gap_ms=1.0, burst=4, priorities=2, slo_ms=60.0, seed=7))


@pytest.mark.parametrize("loss,router", [(False, "least-loaded"),
                                         (True, "least-loaded"),
                                         (True, "affinity")])
def test_real_fleet_matches_jax_and_its_simulation(lms, loss, router):
    jex, jparams, jstate, tlm, tparams = lms
    # JAX's replicas share one executor (its programs compile once); the
    # port's each have their own, as the app builds them.
    jfleet = _real_fleet(jsv, jrs, [jex, jex], jparams, jstate, loss, router)
    jres, jst = jfleet.run(_small(jsv))
    texs = [trs.ServingExecutor(tlm, max_batch=2, max_seq=S, buckets=(8, S),
                                device="cpu") for _ in range(2)]
    tfleet = _real_fleet(tsv, trs, texs, tparams, {}, loss, router)
    engine0 = weakref.ref(tfleet.replicas[0].engine)
    tres, tst = tfleet.run(_small(tsv))
    assert not [i for i, r in tres.items() if r.error]
    assert {i: r.tokens for i, r in tres.items()} == \
        {i: r.tokens for i, r in jres.items()}
    assert _outcome(tfleet, tres, tst) == _outcome(jfleet, jres, jst)
    # Inside the port: the simulated fleet decides and dispatches alike.
    sim = _sim_fleet(tsv, trs, 2, router, loss)
    _sres, sst = sim.run(_small(tsv))
    assert sim.decisions == tfleet.decisions
    assert sim.merged_decisions() == tfleet.merged_decisions()
    assert (sst["prefills"], sst["decode_supersteps"]) == \
        (tst["prefills"], tst["decode_supersteps"])
    if loss:
        assert tfleet.dead == [0] and tst["redistributed"] > 0
        assert tfleet.replicas[0].engine is None and engine0() is None
        assert tfleet.replicas[1].engine is not None
        one = tsv.ScheduledServer(texs[1], tparams, {}, decode_steps=4,
                                  policy=tsv.SchedulerPolicy(name="slo"))
        base, _ = one.run(_small(tsv))
        assert {i: r.tokens for i, r in tres.items()} == \
            {i: r.tokens for i, r in base.items()}


@pytest.mark.parametrize("graph", [False, True])
def test_chaos_replica_loss(tmp_path, graph):
    """``chaos.scenario_replica_loss`` on the chaos stack with JAX's
    params, eager and as graphs (a loop of steps on the CPU)."""
    lm = jbuild(config=JConfig(batch_size=2), **chaos.SERVING_MODEL)
    sex = jrs.ServingExecutor(lm, max_batch=2, max_seq=32, buckets=(8,))
    params = jax.device_get(sex.init(seed=0)[0])
    ok, detail = chaos.scenario_replica_loss(str(tmp_path), device="cpu",
                                             graph=graph, params=params)
    assert ok, detail


# -- the config search --------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(replicas=0), dict(replicas=2, router="round-robin"),
    dict(decode_steps=0), dict(decode_steps=21), dict(speculate=-1),
    dict(buckets=(8, 64)), dict(kv_block=5), dict(prefix_cache=True),
    dict(kv_blocks=4)])
def test_serving_config_validation_matches_jax(bad):
    msgs = []
    for pkg in (jsv, tsv):
        kw = dict(buckets=(8, S), decode_steps=8, max_batch=2, max_seq=S,
                  policy=pkg.SchedulerPolicy(name="slo"))
        kw.update(bad)
        with pytest.raises(ValueError) as e:
            pkg.ServingConfig(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # The mesh shard is carried, as JAX's is.
    sharded = [pkg.ServingConfig(buckets=(8,), decode_steps=8, max_batch=2,
                                 max_seq=S, policy=pkg.SchedulerPolicy(),
                                 shard=(2, 1)) for pkg in (jsv, tsv)]
    assert sharded[1].to_json() == sharded[0].to_json()
    assert sharded[1].describe() == sharded[0].describe()
    assert sharded[1].to_json()["shard"] == [2, 1]


SEARCHES = {
    "single": dict(),
    "fleet": dict(replicas=2),
    "paged": dict(kv_block=8, prefix_cache=True),
    "spec": dict(speculate=2),
    "fifo": dict(policy="fifo", replicas=2, router="affinity"),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_search_matches_jax(name):
    got = []
    for pkg in (jsv, tsv):
        kw = dict(SEARCHES[name])
        pol = pkg.SchedulerPolicy.fifo() if kw.pop("policy", "slo") == \
            "fifo" else pkg.SchedulerPolicy(name="slo")
        base = pkg.ServingConfig(buckets=(8, S), decode_steps=8, max_batch=2,
                                 max_seq=S, policy=pol, **kw)
        reqs = pkg.make_workload(pkg.WorkloadSpec(**dict(
            BURSTY, shared_prefix=8 if "kv_block" in kw else 0)))
        res = pkg.search_serving_config(reqs, base, max_batch_cap=4)
        got.append(([(s.config.to_json(), s.predicted_p99_ms,
                      s.predicted_queue_wait_p99_ms, s.predicted_attainment,
                      s.predicted_dispatches) for s in res.candidates],
                    res.chosen.config.to_json(), res.baseline.config.to_json(),
                    res.describe().rsplit(" in ", 1)[0]))
    assert got[0] == got[1]
    if name in ("fleet", "fifo"):
        assert {c[0]["replicas"] for c in got[1][0]} == {1, 2}


def test_the_chosen_config_runs_on_a_real_executor(lms):
    """The fleet search's winner builds a real executor (a fleet of them
    when it keeps two replicas) and executes the predicted dispatches."""
    _jex, _jp, _js, tlm, tparams = lms
    base = tsv.ServingConfig(buckets=(8, S), decode_steps=8, max_batch=2,
                             max_seq=S, policy=tsv.SchedulerPolicy(name="slo"),
                             replicas=2)
    res = tsv.search_serving_config(_small(tsv), base, max_batch_cap=4)
    c = res.chosen.config
    lm = tbuild(batch_size=c.max_batch, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L,
                config=TConfig(batch_size=c.max_batch))
    reps = [tsv.ScheduledServer(
        trs.ServingExecutor(lm, max_batch=c.max_batch, max_seq=S,
                            buckets=c.buckets, device="cpu",
                            kv_block=c.kv_block, kv_blocks=c.kv_blocks,
                            prefix_cache=c.prefix_cache),
        tparams, {}, decode_steps=c.decode_steps, policy=c.policy)
        for _ in range(c.replicas)]
    srv = tsv.FleetRouter(reps, router=c.router) if c.replicas > 1 \
        else reps[0]
    res_run, st = srv.run(_small(tsv))
    assert st["completed"] == 8
    assert st["prefills"] + st["decode_supersteps"] == \
        res.chosen.predicted_dispatches
    assert st["e2e_ms_p99"] == res.chosen.predicted_p99_ms


# -- the app ------------------------------------------------------------------


#: The app's seed (``FFConfig``'s default).
SEED = TConfig().seed

_APP = ["--vocab", str(V), "--d-model", str(D), "--heads", str(H),
        "--layers", str(L), "--max-seq", str(S), "--max-batch", "2",
        "--buckets", f"8,16,{S}", "--requests", "6", "--max-new", "10",
        "--decode-steps", "4"]


def test_serve_app_fleet_with_journals(tmp_path, capsys):
    path = str(tmp_path / "j.jsonl")
    fleet, one = {}, {}
    assert tserve.main(_APP + ["--replicas", "2", "--router", "affinity",
                               "--journal", path], device="cpu",
                       stats_out=fleet) == 0
    out = capsys.readouterr().out
    assert "fleet = 2 replicas router=affinity live=2 dead=0 " \
           "redistributed=0" in out
    assert (tmp_path / "j.jsonl.r0").exists() and \
        (tmp_path / "j.jsonl.r1").exists()
    assert not (tmp_path / "j.jsonl").exists()
    assert tserve.main(_APP + ["--sched", "slo"], device="cpu",
                       stats_out=one) == 0
    assert {i: r.tokens for i, r in fleet["results"].items()} == \
        {i: r.tokens for i, r in one["results"].items()}
    sim = tsv.FleetRouter.simulated(
        tsv.SlotShape(max_batch=2, max_seq=S, buckets=(8, 16, S)), 2,
        router="affinity", decode_steps=4,
        policy=tsv.SchedulerPolicy(name="slo"),
        resilience=tsv.ServingResilience(max_restarts=0))
    sim.run(tsv.uniform_workload(6, V, prompt_len=(4, 12),
                                 max_new_tokens=10, seed=SEED))
    assert fleet["decisions"] == sim.decisions
    assert fleet["merged_decisions"] == sim.merged_decisions()


def test_serve_app_exits_78_when_every_replica_dies(monkeypatch, capsys):
    class Doomed(tsv.ScheduledServer):
        def __init__(self, *a, **kw):
            kw["fault_injector"] = trs.ServingFaultInjector(
                engine_raise_at={0: "injected"})
            super().__init__(*a, **kw)

    monkeypatch.setattr(tserve, "ScheduledServer", Doomed)
    assert tserve.main(_APP + ["--replicas", "2", "--serve-max-restarts",
                               "0"], device="cpu") == 78
    cap = capsys.readouterr()
    assert "exiting 78 for the external supervisor" in cap.out
    assert "fleet crash: all 2 replicas dead" in cap.err


def test_serve_app_serve_auto(capsys):
    stats = {}
    assert tserve.main(_APP + ["--serve-auto", "--replicas", "2",
                               "--workload-trace", "--priorities", "2",
                               "--slo-ms", "40"], device="cpu",
                       stats_out=stats) == 0
    out = capsys.readouterr().out.splitlines()
    chose = next(ln for ln in out if ln.startswith("serve-auto: chose "))
    epilogue = out[-1]
    assert epilogue.startswith("serve-auto: predicted e2e p99 ")
    pred = int(epilogue.split("predicted dispatches ")[1].split(",")[0])
    assert pred == int(epilogue.rsplit("executed ", 1)[1]) == \
        stats["prefills"] + stats["decode_supersteps"]
    # JAX's search over the same workload picks the same config.
    spec = jsv.WorkloadSpec(n_requests=6, vocab=V, prompt_len=(4, 12),
                            prompt_alpha=1.5, max_new=(1, 10),
                            output_alpha=1.5, mean_gap_ms=8.0, burst=4,
                            priorities=2, slo_ms=40.0, seed=SEED)
    base = jsv.ServingConfig(buckets=(8, 16, S), decode_steps=4, max_batch=2,
                             max_seq=S, policy=jsv.SchedulerPolicy(name="slo"),
                             replicas=2)
    want = jsv.search_serving_config(jsv.make_workload(spec), base)
    assert chose.rsplit(" in ", 1)[0] == \
        want.describe().rsplit(" in ", 1)[0]


def test_serve_app_fleet_dry_run(capsys):
    assert tserve.main(_APP + ["--dry-run", "--replicas", "2", "--router",
                               "tier-aware"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "fleet: 2 replicas (router=tier-aware) x the program family " \
           "above; no extra programs" in out
    assert "DRY RUN OK" in out


def test_serve_app_production_trace(monkeypatch):
    """``--workload-trace prod:alpha=1.1,prefix=4`` serves JAX's
    production workload: the same prompts, arrivals and tiers."""
    seen = []
    real = tserve.production_workload

    def spy(spec, id_alpha):
        seen.append(real(spec, id_alpha=id_alpha))
        return seen[-1]

    monkeypatch.setattr(tserve, "production_workload", spy)
    stats = {}
    assert tserve.main(_APP + ["--workload-trace", "prod:alpha=1.1,prefix=4",
                               "--priorities", "2"], device="cpu",
                       stats_out=stats) == 0
    want = jsv.production_workload(jsv.WorkloadSpec(
        n_requests=6, vocab=V, prompt_len=(4, 12), prompt_alpha=1.5,
        max_new=(1, 10), output_alpha=1.5, mean_gap_ms=8.0, burst=4,
        priorities=2, slo_ms=float("inf"), seed=SEED, shared_prefix=4),
        id_alpha=1.1)
    (got,) = seen
    assert len(got) == len(want) == stats["completed"]
    for a, b in zip(got, want):
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.arrival_ms, a.priority, a.max_new_tokens, a.slo_ms) == \
            (b.arrival_ms, b.priority, b.max_new_tokens, b.slo_ms)
