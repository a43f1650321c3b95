"""The port's SLO scheduler, workloads and latency model
(``flexflow_torch/serving/``), held against the JAX package's on the CPU.

- ``make_workload`` / ``uniform_workload`` give JAX's requests, request
  for request and bit for bit, and refuse what JAX refuses with JAX's
  messages.
- The simulated ``ScheduledServer`` makes JAX's decisions: ``decisions``,
  ``span_events`` (wall fields left out) and the virtual-clock stats are
  equal, exactly, for fifo and slo, shedding, tiers, preemption, the
  paged pool with prefix sharing, speculation, and retries, expiry and
  restarts driven by the injector's simulate mode.
- On a tiny f32 LM with JAX's weights carried over
  (``weights.params_from_numpy``), the real scheduled run's greedy tokens
  equal JAX's ``ScheduledServer``'s for slo, fifo, preemption, paged with
  prefix sharing, speculation d = 2, and a retry plus a restart; inside
  the port the simulated run's decisions and dispatches equal the real
  run's.  JAX's executor runs ``decode_kernel=False`` (its einsum decode:
  the Pallas kernel runs only interpreted on the CPU, and its tokens are
  pinned to the einsum's by ``tests/test_serving.py``).
- Telemetry on and off give the same tokens and the same fences.
- The degraded rungs (``decode_oracle``, ``shrink_batch``), the app's
  scheduled path, its dry run and exit 77 on a crash loop.
"""

import functools

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
from flexflow_torch.runtime import serving as trs
from flexflow_torch.runtime import telemetry as ttel
from flexflow_torch.weights import params_from_numpy

V, D, H, L, S = 64, 32, 2, 2, 64

#: Virtual-clock and accounting stats: everything but wall time.
VIRT = ("requests", "completed", "failed", "tokens", "decode_supersteps",
        "prefills", "request_sheds", "request_preempts", "queue_wait_ms_p50",
        "queue_wait_ms_p95", "queue_wait_ms_p99", "e2e_ms_p50", "e2e_ms_p99",
        "slo_attainment", "slo_autopsy", "request_retries",
        "request_expiries", "engine_restarts", "drained", "degraded_rungs",
        "prefix_hits", "prefix_hit_rate", "prefill_tokens_saved", "kv_cows",
        "draft_prefills", "spec_acceptance_rate", "spec_tokens_per_dispatch",
        "policy", "kv_layout", "kv_block", "kv_blocks", "shard", "sampled",
        "decode_steps_per_call", "programs_per_decode_superstep")
#: Event fields that carry wall time.
WALL = ("wall_s", "latency_s")

BURSTY = dict(n_requests=16, vocab=V, prompt_len=(3, 6), max_new=(2, 10),
              mean_gap_ms=1.0, burst=8, priorities=3, slo_ms=60.0, seed=5)
#: The real-engine workload: 8 requests in bursts of 4 over 2 tiers.
SMALL = dict(n_requests=8, vocab=V, prompt_len=(3, 6), max_new=(2, 8),
             mean_gap_ms=1.0, burst=4, priorities=2, slo_ms=60.0, seed=7)


def _virt(stats):
    return {k: stats[k] for k in VIRT if k in stats}


def _strip(events):
    return [{k: v for k, v in e.items() if k not in WALL} for e in events]


def _req(pkg, rid, plen, max_new, arrival_ms=0.0, priority=0,
         slo_ms=float("inf")):
    return pkg.Request(id=rid,
                       prompt=np.arange(1, plen + 1, dtype=np.int32) * 3 % V,
                       max_new_tokens=max_new, arrival_ms=arrival_ms,
                       priority=priority, slo_ms=slo_ms)


def _both(fn):
    """``fn(serving package, runtime.serving module)`` for JAX and the
    port."""
    return fn(jsv, jrs), fn(tsv, trs)


# -- workloads ------------------------------------------------------------------


WORKLOADS = [
    BURSTY,
    dict(BURSTY, priorities=1, slo_ms=float("inf"), burst=1),
    dict(n_requests=12, vocab=32768, prompt_len=(4, 32), max_new=(2, 32),
         mean_gap_ms=2.0, burst=12, priorities=2, slo_ms=60.0, seed=13),
    dict(n_requests=12, vocab=32768, prompt_len=(4, 32), max_new=(2, 32),
         mean_gap_ms=2.0, burst=12, priorities=2, slo_ms=60.0, seed=13,
         shared_prefix=16),
    dict(BURSTY, shared_prefix=4, shared_frac=0.5, prompt_alpha=2.5),
]


def _same_requests(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.id == y.id
        assert x.prompt.dtype == y.prompt.dtype
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.arrival_ms, x.priority, x.slo_ms) == \
            (y.max_new_tokens, y.arrival_ms, y.priority, y.slo_ms)


@pytest.mark.parametrize("spec", WORKLOADS)
def test_make_workload_matches_jax(spec):
    j, t = _both(lambda p, r: p.make_workload(p.WorkloadSpec(**spec)))
    _same_requests(j, t)


def test_uniform_workload_matches_jax():
    kw = dict(prompt_len=(3, 9), max_new_tokens=7, every_ms=2.5, seed=4,
              slo_ms=40.0)
    j, t = _both(lambda p, r: p.uniform_workload(6, V, **kw))
    _same_requests(j, t)


@pytest.mark.parametrize("bad", [
    dict(prompt_alpha=1.0), dict(prompt_len=(6, 3)), dict(priorities=0),
    dict(n_requests=0), dict(burst=0), dict(mean_gap_ms=-1.0),
    dict(shared_prefix=-1), dict(shared_frac=1.5)])
def test_workload_validation_matches_jax(bad):
    msgs = []
    for pkg in (jsv, tsv):
        with pytest.raises(ValueError) as e:
            pkg.make_workload(pkg.WorkloadSpec(**bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec,alpha", [
    (BURSTY, 1.2), (dict(BURSTY, shared_prefix=4), 1.1),
    (WORKLOADS[2], 1.5)])
def test_production_workload_matches_jax(spec, alpha):
    """Prompt tokens read from the production trace, lengths, budgets,
    tiers and arrivals from ``make_workload``'s draws: JAX's requests bit
    for bit."""
    j, t = _both(lambda p, r: p.production_workload(p.WorkloadSpec(**spec),
                                                    id_alpha=alpha))
    _same_requests(j, t)
    plain = tsv.make_workload(tsv.WorkloadSpec(**spec))
    assert [r.arrival_ms for r in t] == [r.arrival_ms for r in plain]
    assert any(not np.array_equal(a.prompt, b.prompt)
               for a, b in zip(t, plain))


def test_production_trace_source_matches_jax():
    """``ProductionTraceSource`` and ``SyntheticStreamSource`` read JAX's
    rows, at any chunk boundary."""
    from flexflow_tpu.data import stream as jstream
    from flexflow_tpu.data import trace as jtrace
    from flexflow_torch.data import stream as tstream
    from flexflow_torch.data import trace as ttrace

    kw = dict(num_samples=300, dense_dim=3, vocab_sizes=[50, 7], alpha=1.3,
              seed=4, block=64)
    specs = {"x": ((2,), np.float32), "ids": ((3,), np.int32)}
    for jsrc, tsrc in (
            (jtrace.ProductionTraceSource(**kw),
             ttrace.ProductionTraceSource(**kw)),
            (jstream.SyntheticStreamSource(specs, 300, seed=2, block=64,
                                           int_high={"ids": 9}),
             tstream.SyntheticStreamSource(specs, 300, seed=2, block=64,
                                           int_high={"ids": 9}))):
        assert tsrc.specs() == jsrc.specs()
        for lo, hi in ((0, 64), (50, 200), (250, 400)):
            a, b = jsrc.read(lo, hi), tsrc.read(lo, hi)
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="alpha"):
        ttrace.ProductionTraceSource(10, 1, [5], alpha=1.0)


# -- the simulated scheduler against JAX's -----------------------------------------


def _sim_case(name):
    """``(shape kwargs, server kwargs builder, requests builder)``."""
    burst = lambda p, r: p.make_workload(p.WorkloadSpec(**BURSTY))
    two = dict(max_batch=2, max_seq=32, buckets=(8, 32))
    slo = lambda p, r, **k: dict(policy=p.SchedulerPolicy(name="slo", **k))
    if name == "slo":
        return two, slo, burst
    if name == "fifo":
        return two, lambda p, r: dict(policy=p.SchedulerPolicy.fifo()), burst
    if name == "shed":
        return two, functools.partial(slo, shed_depth=3), burst
    if name == "preempt":
        return (dict(max_batch=1, max_seq=32, buckets=(8, 32)),
                lambda p, r: dict(slo(p, r), decode_steps=8),
                lambda p, r: [_req(r, 0, 4, 40, 0.0, priority=1),
                              _req(r, 1, 4, 4, 5.0, priority=0,
                                   slo_ms=20.0)])
    if name == "kv_wait":
        return (dict(max_batch=2, max_seq=64, buckets=(8, 64), kv_block=16,
                     kv_blocks=5), slo,
                lambda p, r: [_req(r, 0, 4, 30), _req(r, 1, 4, 30, 1.0),
                              _req(r, 2, 4, 8, 2.0)])
    if name == "prefix":
        return (dict(max_batch=2, max_seq=64, buckets=(8, 64), kv_block=8,
                     kv_blocks=9, prefix_cache=True), slo,
                lambda p, r: [_req(r, 0, 8, 4, 0.0), _req(r, 1, 8, 8, 0.0),
                              _req(r, 2, 12, 20, 1.0),
                              _req(r, 3, 8, 40, 2.0)])
    if name == "prefix_workload":
        return (dict(max_batch=2, max_seq=32, buckets=(16, 32), kv_block=8,
                     prefix_cache=True), slo,
                lambda p, r: p.make_workload(p.WorkloadSpec(
                    **dict(BURSTY, shared_prefix=8, prompt_len=(4, 12)))))
    if name == "spec":
        return two, lambda p, r: dict(slo(p, r), speculate=2), burst
    if name == "retry_restart":
        return two, lambda p, r: dict(
            slo(p, r),
            resilience=p.ServingResilience(max_retries=1, max_restarts=1),
            fault_injector=r.ServingFaultInjector(
                nan_cache_at={1: 0}, engine_raise_at={3: "sim death"})), burst
    if name == "retry_backoff":
        return two, lambda p, r: dict(
            slo(p, r), resilience=p.ServingResilience(max_retries=2),
            fault_injector=r.ServingFaultInjector(
                nan_cache_at={0: 0, 1: 0})), \
            lambda p, r: [_req(r, 0, 4, 6)]
    if name == "expire":
        return two, lambda p, r: dict(
            slo(p, r), resilience=p.ServingResilience(expire_waiting=True)), \
            lambda p, r: [_req(r, 0, 4, 12), _req(r, 1, 4, 12),
                          _req(r, 2, 4, 4, priority=1, slo_ms=1.0)]
    if name == "crash_loop":
        return two, lambda p, r: dict(
            slo(p, r), resilience=p.ServingResilience(max_restarts=1),
            fault_injector=r.ServingFaultInjector(
                engine_raise_at={1: "a", 2: "b"})), burst
    raise KeyError(name)


SIM_CASES = ("slo", "fifo", "shed", "preempt", "kv_wait", "prefix",
             "prefix_workload", "spec", "retry_restart", "retry_backoff",
             "expire", "crash_loop")


@pytest.mark.parametrize("name", SIM_CASES)
def test_simulated_scheduler_matches_jax(name):
    shape, server_kw, requests = _sim_case(name)
    out = []
    for pkg, rt in ((jsv, jrs), (tsv, trs)):
        kw = dict(decode_steps=4)
        kw.update(server_kw(pkg, rt))
        srv = pkg.ScheduledServer.simulated(pkg.SlotShape(**shape), **kw)
        try:
            res, stats = srv.run(requests(pkg, rt))
            got = ({i: (r.tokens, r.error) for i, r in res.items()},
                   _virt(stats))
        except rt.ServingCrashLoop as e:
            got = str(e)
        out.append((got, srv.decisions, _strip(srv.span_events),
                    srv.degraded_rungs))
    assert out[0] == out[1]
    stats = out[1][0][1] if isinstance(out[1][0], tuple) else {}
    want = {"shed": ("request_sheds", 1), "preempt": ("request_preempts", 1),
            "retry_restart": ("engine_restarts", 1),
            "retry_backoff": ("request_retries", 2),
            "expire": ("request_expiries", 1),
            "prefix": ("prefix_hits", 2), "prefix_workload": ("prefix_hits", 1)}
    if name in want:
        key, least = want[name]
        assert stats[key] >= least, (name, stats)
    if name == "kv_wait":
        assert any(d["d"] == "kv_wait" for d in out[1][1])
    if name == "crash_loop":
        assert "restart budget (1) exhausted" in out[1][0]


def test_policy_and_shape_validation_match_jax():
    for pkg in (jsv, tsv):
        with pytest.raises(ValueError, match="unknown scheduler policy"):
            pkg.SchedulerPolicy(name="lifo")
        with pytest.raises(ValueError, match="retry_backoff_ms"):
            pkg.ServingResilience(retry_backoff_ms=0.0)
        with pytest.raises(ValueError, match="divide"):
            pkg.SlotShape(max_batch=2, max_seq=32, buckets=(8,), kv_block=5)
        with pytest.raises(ValueError, match="paged layout"):
            pkg.SlotShape(max_batch=2, max_seq=32, buckets=(8,),
                          prefix_cache=True)
    assert tsv.ADAPTIVE_K_CANDIDATES == (1, 2, 4, 8, 16)


# -- the real engine against JAX's ---------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    """JAX's and the port's executors (padded, and paged with the prefix
    cache) on one tiny LM, and their params: JAX's, carried over."""
    kw = dict(batch_size=2, seq_len=S, vocab_size=V, d_model=D, num_heads=H,
              num_layers=L)
    jlm = jbuild(config=JConfig(batch_size=2), **kw)
    tlm = tbuild(config=TConfig(batch_size=2), **kw)
    ex = dict(max_batch=2, max_seq=S, buckets=(8, S))
    paged = dict(ex, kv_block=8, kv_blocks=17, prefix_cache=True)
    jpad = jrs.ServingExecutor(jlm, decode_kernel=False, **ex)
    jparams, jstate = jpad.init(seed=0)
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return {
        "jax": (jpad, jrs.ServingExecutor(jlm, decode_kernel=False, **paged),
                jparams, jstate),
        "torch": (trs.ServingExecutor(tlm, device="cpu", **ex),
                  trs.ServingExecutor(tlm, device="cpu", **paged),
                  tparams, {}),
        "models": (jlm, tlm),
    }


def _real_case(name):
    """``(paged, server kwargs builder, requests builder)``."""
    small = lambda p, r: p.make_workload(p.WorkloadSpec(**SMALL))
    slo = lambda p, r: dict(policy=p.SchedulerPolicy(name="slo"))
    if name == "slo":
        return False, slo, small
    if name == "fifo":
        return False, lambda p, r: dict(policy=p.SchedulerPolicy.fifo()), small
    if name == "preempt":
        return False, slo, lambda p, r: [
            _req(r, 0, 4, 40, 0.0, priority=1),
            _req(r, 1, 4, 40, 0.0, priority=1),
            _req(r, 2, 4, 4, 5.0, priority=0, slo_ms=30.0)]
    if name == "prefix":
        return True, slo, lambda p, r: [
            _req(r, 0, 8, 4, 0.0), _req(r, 1, 8, 8, 0.0),
            _req(r, 2, 12, 20, 1.0), _req(r, 3, 8, 30, 2.0)]
    if name == "spec":
        return False, lambda p, r: dict(slo(p, r), speculate=2), small
    if name == "retry_restart":
        return False, lambda p, r: dict(
            slo(p, r),
            resilience=p.ServingResilience(max_retries=1, max_restarts=1),
            fault_injector=r.ServingFaultInjector(
                nan_cache_at={1: 0}, engine_raise_at={3: "boom"})), small
    raise KeyError(name)


@pytest.mark.parametrize("name", ("slo", "fifo", "preempt", "prefix", "spec",
                                  "retry_restart"))
def test_real_scheduled_tokens_match_jax_and_sim(stacks, name):
    paged, server_kw, requests = _real_case(name)
    runs = {}
    for side, pkg, rt in (("jax", jsv, jrs), ("torch", tsv, trs)):
        pad, pgd, params, state = stacks[side]
        srv = pkg.ScheduledServer(pgd if paged else pad, params, state,
                                  decode_steps=4, **server_kw(pkg, rt))
        res, stats = srv.run(requests(pkg, rt))
        runs[side] = (srv, res, stats)
    jsrv, jres, jst = runs["jax"]
    tsrv, tres, tst = runs["torch"]
    assert not [i for i, r in tres.items() if r.error]
    assert {i: r.tokens for i, r in tres.items()} == \
        {i: r.tokens for i, r in jres.items()}
    assert tsrv.decisions == jsrv.decisions
    assert _virt(tst) == _virt(jst)
    # Inside the port: the simulated run decides and dispatches alike.
    shape = tsv.SlotShape(**{k: getattr(tsrv.ex, k) for k in (
        "max_batch", "max_seq", "buckets", "kv_block", "prefix_cache")},
        kv_blocks=tsrv.ex.kv_blocks or None)
    kw = server_kw(tsv, trs)
    sim = tsv.ScheduledServer.simulated(
        shape, decode_steps=4, **{k: v for k, v in kw.items()
                                  if k != "temperature"})
    _r, sst = sim.run(requests(tsv, trs))
    assert sim.decisions == tsrv.decisions
    assert (sst["prefills"], sst["decode_supersteps"]) == \
        (tst["prefills"], tst["decode_supersteps"])
    assert _virt(sst)["tokens"] == tst["tokens"]
    want = {"preempt": "request_preempts", "prefix": "prefix_hits",
            "retry_restart": "engine_restarts"}
    if name in want:
        assert tst[want[name]] >= 1
    if name == "spec":
        assert tst["spec_acceptance_rate"] == 1.0
    assert "degraded_rungs" not in tst


def test_cross_policy_and_plain_server_parity(stacks):
    """Scheduling changes when, never what: slo, fifo and the plain
    ``Server`` give every request the same greedy tokens."""
    pad, _pgd, params, _ = stacks["torch"]
    reqs = lambda: tsv.make_workload(tsv.WorkloadSpec(**SMALL))
    out = {}
    for pol in (tsv.SchedulerPolicy.fifo(), tsv.SchedulerPolicy(name="slo")):
        res, _ = tsv.ScheduledServer(pad, params, {}, decode_steps=4,
                                     policy=pol).run(reqs())
        out[pol.name] = {i: r.tokens for i, r in res.items()}
    res, _ = trs.Server(pad, params, {}, decode_steps=4).run(reqs())
    out["plain"] = {i: r.tokens for i, r in res.items()}
    assert out["fifo"] == out["slo"] == out["plain"]


def test_telemetry_keeps_tokens_and_fences(stacks, tmp_path, monkeypatch):
    """With telemetry on and off the scheduled run makes the same fences
    (``_readback`` calls) and serves the same tokens; the log's
    reconstruction equals the run's stats, and every program's
    ``program_cost`` carries cost-model flops."""
    from flexflow_torch.obs.reader import RunLog

    pad, _pgd, params, _ = stacks["torch"]
    calls = []
    real = trs._readback
    monkeypatch.setattr(trs, "_readback",
                        lambda v: (calls.append(1), real(v))[1])

    def run():
        calls.clear()
        srv = tsv.ScheduledServer(
            pad, params, {}, decode_steps=4,
            policy=tsv.SchedulerPolicy(name="slo", shed_depth=3))
        res, st = srv.run(tsv.make_workload(tsv.WorkloadSpec(**BURSTY)))
        return {i: r.tokens for i, r in res.items()}, st, len(calls)

    off_tokens, off_st, off_fences = run()
    tel = ttel.Telemetry(str(tmp_path))
    with tel:
        on_tokens, on_st, on_fences = run()
    assert on_tokens == off_tokens and on_fences == off_fences
    assert off_fences == off_st["prefills"] + off_st["decode_supersteps"]
    log = RunLog.load(tel.path)
    assert not log.unknown_events and log.exit == "clean"
    assert len(log.select("sched_decision")) == on_st["decode_supersteps"]
    assert len(log.select("request_shed")) == on_st["request_sheds"] > 0
    assert len(log.select("fence")) == on_fences
    rec, summ = log.reconstruct_summary(), log.summary()
    for k in ("queue_wait_ms_p50", "queue_wait_ms_p95", "queue_wait_ms_p99",
              "request_sheds", "request_preempts", "slo_attainment",
              "slo_autopsy"):
        assert rec.get(k) == summ.get(k) == on_st[k], k
    assert summ["programs_per_step"] == round(
        on_st["decode_supersteps"] / sum(
            d["k"] for d in log.select("sched_decision")), 4)
    costs = log.select("program_cost")
    assert {e["kind"] for e in costs} == {"prefill", "decode_superstep"}
    assert all(e["source"] == "cost_model" and e["flops"] > 0 for e in costs)


@pytest.mark.parametrize("error", ["cuda", "launch", "build"])
def test_a_device_error_is_not_an_engine_restart(monkeypatch, error):
    """Only a ServingEngineFault restarts the engine.  A CUDA error, the
    kernels' own launch failure (``ops/kernels.py::_raise_on``) and
    their failed build propagate under an armed failure model, twice
    over the decode-oracle rung's count, with no restart and no degraded
    rung; an injected engine fault restarts it."""
    from flexflow_torch.ops import kernels

    def server():
        return tsv.ScheduledServer.simulated(
            tsv.SlotShape(max_batch=2, max_seq=32, buckets=(8, 32)),
            decode_steps=4,
            resilience=tsv.ServingResilience(max_restarts=3))

    def boom(*a, **k):
        if error == "cuda":
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        if error == "launch":
            kernels._raise_on(719, "flash_decode")
        raise RuntimeError("nvcc failed for csrc/flash_decode.cu:\nerror")

    srv = server()
    monkeypatch.setattr(srv.engine, "decode", boom)
    for _ in range(2 * srv.resilience.kernel_fault_rung):
        with pytest.raises(RuntimeError) as got:
            srv.run([_req(trs, 0, 4, 6)])
        assert not isinstance(got.value, trs.ServingEngineFault)
    assert not [d for d in srv.decisions
                if d["d"] in ("engine_restart", "degraded")]
    assert srv.degraded_rungs == []
    srv = server()
    calls = []

    def once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise trs.ServingEngineFault("an engine fault of the program")
        return type(srv.engine).decode(srv.engine, *a, **k)

    monkeypatch.setattr(srv.engine, "decode", once)
    res, st = srv.run([_req(trs, 0, 4, 6)])
    assert st["engine_restarts"] == 1 and res[0].error is None


def test_bf16_prefix_tokens_agree_on_one_attention_route():
    """In bf16, at ``bench.py``'s geometry and workload on a narrow LM,
    the prefix cache's greedy tokens equal those without it, request for
    request, on the default route: the offset prefill's tail attends
    through the dispatcher over the bucket's span
    (``MultiHeadAttention._attend_offset``), as a fresh prefill of the
    same bucket does (K1f's plain version here).  When the tail attended
    through an f32 einsum of its own, two sharers' tokens moved at this
    geometry."""
    from flexflow_torch import bench

    lm = tbuild(batch_size=8, seq_len=128, vocab_size=512, d_model=64,
                num_heads=H, num_layers=L,
                config=TConfig(batch_size=8, compute_dtype="bfloat16"))

    def ex(on):
        return trs.ServingExecutor(lm, max_batch=8, max_seq=128,
                                   buckets=(64, 128), device="cpu",
                                   kv_block=16, prefix_cache=on)

    def server(on):
        return tsv.ScheduledServer(ex(on), params, {}, decode_steps=8,
                                   policy=tsv.SchedulerPolicy(name="slo"))

    params, _ = ex(False).init(0)
    reqs = lambda: bench.sched_workload(16, 512, 128, 32, 16)  # noqa: E731
    on = server(True)
    got = {False: server(False).run(reqs())[0], True: on.run(reqs())[0]}
    sharers = {e["id"] for e in on.span_events if e["ev"] == "prefix_hit"}
    assert len(sharers) >= 8
    assert {i: r.tokens for i, r in got[True].items()} == \
        {i: r.tokens for i, r in got[False].items()}
    assert all(r.error is None for r in got[True].values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offset_prefill_tail_equals_a_fresh_prefill(dtype):
    """The offset prefill of a prompt over its own resident prefix writes
    the tail's K/V rows of every layer bit for bit as a fresh prefill of
    the same prompt and bucket does, and picks the same first token, at
    every block offset, in f32 and bf16."""
    import torch

    lm = tbuild(batch_size=2, seq_len=128, vocab_size=V, d_model=64,
                num_heads=4, num_layers=L,
                config=TConfig(batch_size=2, compute_dtype=dtype))
    ex = trs.ServingExecutor(lm, max_batch=2, max_seq=128, buckets=(64, 128),
                             device="cpu", kv_block=16, prefix_cache=True)
    params, state = ex.init(0)
    for bucket in (64, 128):
        n = bucket - 3
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = np.random.default_rng(bucket).integers(0, V, n)
        rows, tok, _ok = ex.build_prefill(bucket)(params, state, padded,
                                                  np.int32(n))
        pool = ex.init_cache()
        table = np.arange(1, 9, dtype=np.int32)
        ex.install_paged(pool, rows, table)
        for o in range(16, n, 16):
            got, tok_o, ok = ex.build_prefill_from(bucket, o)(
                params, state, pool, table[:o // 16], padded, np.int32(n))
            assert bool(ok) and int(tok_o) == int(tok)
            for name, r in rows.items():
                for kv in ("k", "v"):
                    assert got[name][kv].dtype == r[kv].dtype
                    assert torch.equal(got[name][kv][o:n], r[kv][o:n]), \
                        (bucket, o, name, kv)


# -- the degraded rungs ----------------------------------------------------------


def test_decode_oracle_rung_after_kernel_faults(stacks):
    """After ``kernel_fault_rung`` decode-phase engine faults the engine
    restarts with ``decode_kernel=False`` (logged, ``degraded_mode``);
    the tokens equal an unfaulted run's.  No fault, no rung."""
    _jlm, tlm = stacks["models"]
    params = stacks["torch"][2]
    reqs = lambda: [_req(trs, 0, 4, 6), _req(trs, 1, 5, 6)]

    def ex():
        return trs.ServingExecutor(tlm, max_batch=2, max_seq=S,
                                   buckets=(8, S), device="cpu",
                                   decode_kernel=True)

    clean = tsv.ScheduledServer(
        ex(), params, {}, decode_steps=4,
        resilience=tsv.ServingResilience(max_restarts=3))
    base, st = clean.run(reqs())
    assert "degraded_rungs" not in st and clean.ex.decode_kernel is True
    faulted_ex = ex()
    srv = tsv.ScheduledServer(
        faulted_ex, params, {}, decode_steps=4,
        resilience=tsv.ServingResilience(max_restarts=3, kernel_fault_rung=2),
        fault_injector=trs.ServingFaultInjector(
            engine_raise_at={0: "kernel fault 1", 1: "kernel fault 2"}))
    res, st = srv.run(reqs())
    assert st["engine_restarts"] == 2
    assert st["degraded_rungs"] == ["decode_oracle"]
    assert faulted_ex.decode_kernel is False
    assert {i: r.tokens for i, r in res.items()} == \
        {i: r.tokens for i, r in base.items()}


def test_shrink_batch_rung_under_the_device_budget(stacks, monkeypatch):
    """A KV cache over ``FF_DEVICE_MEM_BYTES`` halves ``max_batch`` before
    refusing, as JAX's rung does."""
    _jlm, tlm = stacks["models"]
    params = stacks["torch"][2]
    ex = trs.ServingExecutor(tlm, max_batch=4, max_seq=S, buckets=(8, S),
                             device="cpu")
    per_slot = ex.hbm_per_slot_bytes()
    monkeypatch.setenv("FF_DEVICE_MEM_BYTES", str(2 * per_slot))
    srv = tsv.ScheduledServer(ex, params, {}, decode_steps=4)
    assert srv.degraded_rungs == [
        {"rung": "shrink_batch", "max_batch": 2, "prev": 4}]
    assert srv.advertised_capacity() == {"slots": 2, "degraded": 1,
                                         "paged": False}
    res, st = srv.run([_req(trs, i, 4, 4) for i in range(3)])
    assert st["completed"] == 3 and st["degraded_rungs"] == ["shrink_batch"]
    monkeypatch.setenv("FF_DEVICE_MEM_BYTES", str(per_slot // 2))
    from flexflow_torch.data.loader import DeviceMemoryError

    with pytest.raises(DeviceMemoryError):
        tsv.ScheduledServer(trs.ServingExecutor(
            tlm, max_batch=4, max_seq=S, buckets=(8, S), device="cpu"),
            params, {}, decode_steps=4)


# -- the app ---------------------------------------------------------------------


_APP = ["--vocab", str(V), "--d-model", str(D), "--heads", str(H),
        "--layers", "1", "--max-seq", "32", "--max-batch", "2",
        "--decode-steps", "4", "--requests", "6", "--max-new", "6",
        "--prompt-len", "3:6", "--buckets", "8,32", "--seed", "1"]


def test_serve_app_scheduled_path(capsys, tmp_path):
    stats = {}
    argv = _APP + ["--workload-trace", "--slo-ms", "20", "--priorities", "2",
                   "--shed-depth", "3", "--telemetry", str(tmp_path)]
    # A shed request is a failed one: exit 1, as JAX's app exits.
    assert tserve.main(argv, device="cpu", stats_out=stats) == 1
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if "FAILED" in ln] == \
        [f"request {i} FAILED: shed: queue depth > 3"
         for i, r in sorted(stats["results"].items()) if r.error]
    for line in ("policy = slo (tier+EDF admission, adaptive k, preempt, "
                 "shed>3)", "shed = ", "preempted = ", "(virtual)",
                 "SLO attainment = ", "slo autopsy tier ",
                 "latency model = serving latency model (uncalibrated"):
        assert line in out, line
    assert stats["policy"] == "slo" and stats["requests"] == 6
    sim = tsv.ScheduledServer.simulated(
        tsv.SlotShape(max_batch=2, max_seq=32, buckets=(8, 32)),
        decode_steps=4, policy=tsv.SchedulerPolicy(name="slo", shed_depth=3))
    sim.run(tsv.make_workload(tsv.WorkloadSpec(
        n_requests=6, vocab=V, prompt_len=(3, 6), max_new=(1, 6),
        burst=4, priorities=2, slo_ms=20.0, seed=1)))
    assert stats["decisions"] == sim.decisions
    # A second run fits its latency model on the first run's log.
    assert tserve.main(_APP + ["--sched", "fifo", "--telemetry",
                               str(tmp_path)], device="cpu") == 0
    out = capsys.readouterr().out
    assert "policy = fifo" in out and "calibrated from " in out


def test_serve_app_failure_flags_and_crash_loop_exit(capsys, monkeypatch,
                                                     tmp_path):
    argv = _APP + ["--serve-retries", "1", "--retry-backoff-ms", "4",
                   "--expire-waiting", "--journal",
                   str(tmp_path / "j.jsonl")]
    stats = {}
    assert tserve.main(argv, device="cpu", stats_out=stats) == 0
    assert stats["drained"] is False and stats["request_retries"] == 0
    capsys.readouterr()
    made = []

    class Faulted(tsv.ScheduledServer):
        """The app's server with an engine fault before superstep 0."""

        def __init__(self, *a, **kw):
            if kw.get("_engine") is None:
                kw["fault_injector"] = trs.ServingFaultInjector(
                    engine_raise_at={0: "injected"})
                made.append(self)
            super().__init__(*a, **kw)

    monkeypatch.setattr(tserve, "ScheduledServer", Faulted)
    assert tserve.main(_APP + ["--serve-max-restarts", "0"],
                       device="cpu") == trs.EXIT_SERVING_FAILURE == 77
    assert "exiting 77" in capsys.readouterr().out
    assert made[0].resilience.max_restarts == 0


@pytest.mark.parametrize("argv,item", [
    (["--shard", "2,1", "--dry-run"], "item 14"),
    (["--sched", "lifo"], "fifo|slo"),
    (["--workload-trace", "prod:beta=2"], "unknown args"),
    (["--router", "round-robin"], "least-loaded|tier-aware|affinity"),
    (["--replicas", "0"], "N >= 1")])
def test_serve_app_refuses_what_later_items_bring(argv, item):
    with pytest.raises(SystemExit, match=item):
        tserve.main(_APP + argv, device="cpu")


def test_serve_app_scheduled_dry_run_lists_every_k(capsys):
    argv = list(_APP)
    argv[argv.index("--decode-steps") + 1] = "8"
    assert tserve.main(argv + ["--sched", "slo", "--dry-run"],
                       device="cpu") == 0
    out = capsys.readouterr().out
    assert "DRY RUN OK" in out
    for k in (1, 2, 4, 8):
        assert f"decode k={k} " in out
    assert "decode k=16" not in out
