"""Sharded serving (``ServingExecutor(shard=(n, c))``) across worlds of
ranks, held against the JAX package's single-mesh and sharded engines
and against the port's own one-engine runs.

The LM is ``tests/test_serving.py``'s (vocab 64, d_model 32, 2 heads, 2
layers, max_seq 16), at 4 slots, with JAX's ``init(seed=0)`` parameters
carried over through numpy and their 2-D weights scaled by ``SHARP`` so
that greedy tokens vary from step to step (at the raw init most of them
repeat one token).  One world of 2 (gloo, CPU ranks of one thread) runs
``(2, 1)`` and ``(1, 2)``, one world of 4 runs ``(2, 2)``, each case
through ``flexflow_torch.tools.mesh_smoke.serve_cases``.  In f32:

- padded and paged, the greedy tokens equal JAX's single-mesh engine's
  and JAX's sharded engine's (8 XLA CPU devices), exactly;
- the teacher-forced decode logits are within ``DECODE_TOL`` of JAX's
  full forward (``test_sharded_decode_matches_full_forward``);
- a request served alone equals the same request served in the batch;
- sampled tokens, speculation at d = 2 (padded and paged), the prefix
  cache on the sharded pool, a ``ScheduledServer`` run and a 2-replica
  ``FleetRouter`` run (tokens and decisions), a one-rank checkpoint
  restored on every rank and a NaN'd cache row of a slot that one rank
  holds (only that request fails) each equal the port's one-engine run;
- ``init`` in a world draws every parameter whole and bit-equal to the
  one-rank draw;
- the planted faults (rank 1 keeps its own partial product instead of
  the ``c`` all-reduce; rank 1 concatenates the gathered tokens in the
  wrong order) break the token equality;
- JAX's checks and fallback, the degraded ``shrink_batch`` rung, the app
  and the bench entry's sharded columns.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from flexflow_torch.apps import serve as tserve
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.parallel import launch
from flexflow_torch.runtime import serving as tserving
from flexflow_torch.runtime.checkpoint import CheckpointManager
from flexflow_torch.tools import mesh_smoke
from flexflow_torch.weights import params_from_numpy
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime import serving as jserving
from flexflow_tpu.runtime.executor import Executor as JExecutor

V, D, H, L, S, B = 64, 32, 2, 2, 16, 4
BUCKETS = (8, S)
DECODE_TOL = 1e-4
SHARP = 4.0
WORLD_S = 240
SHARDS = [(2, 1), (1, 2), (2, 2)]
LAYOUTS = {"padded": 0, "paged": 4}
MODEL_KW = dict(batch_size=B, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L)
TEACHER_PREFIX, TEACHER_BUCKET = 6, 8
#: Per-rank padded cache bytes of 6 slots over (2, 1) are 24576, of 2
#: slots 8192: the budget takes the shrink_batch rung from 6 to 2.
DEGRADE_BYTES = "10000"


def _tag(shard):
    return "one" if shard is None else f"{shard[0]}x{shard[1]}"


def _as_tuples(reqs):
    return [(r.id, r.prompt.tolist(), r.max_new_tokens, r.arrival_ms)
            for r in reqs]


REQS = _as_tuples(tserving.synthetic_requests(
    6, V, prompt_len=(3, 9), max_new_tokens=6, seed=1))
#: Staggered arrivals for the scheduler and the fleet.
SCHED_REQS = [r[:3] + (2.0 * i,) for i, r in enumerate(REQS)]


def _prefix_reqs():
    """Four prompts that share an 8-token prefix (two 4-token blocks) with
    1-4 tokens of their own, then the prefix itself twice (a full hit)."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, V, size=8).tolist()
    out = [(i, base + rng.integers(0, V, size=i + 1).tolist(), 4)
           for i in range(4)]
    return out + [(4, base, 4), (5, base, 4)]


TEACHER = np.random.default_rng(0).integers(0, V, size=S).astype(np.int32)


def _ex(layout, **kw):
    return dict(max_seq=S, buckets=BUCKETS, kv_block=LAYOUTS[layout], **kw)


def _cases(shard, ckpt=None):
    """The cases of one shard (``None``: the one-engine references)."""
    t = _tag(shard)
    plain = dict(decode_steps=4)
    cases = [
        dict(name=f"greedy-padded-{t}", ex=_ex("padded"), requests=REQS,
             server_kw=plain, init_digest=True,
             teacher=(TEACHER, TEACHER_PREFIX, TEACHER_BUCKET)),
        dict(name=f"greedy-paged-{t}", ex=_ex("paged"), requests=REQS,
             server_kw=plain),
        dict(name=f"alone-padded-{t}", ex=_ex("padded"), requests=REQS[:1],
             server_kw=plain),
        dict(name=f"alone-paged-{t}", ex=_ex("paged"), requests=REQS[1:2],
             server_kw=plain),
        dict(name=f"sampled-{t}", ex=_ex("padded"), requests=REQS,
             server_kw=dict(plain, temperature=0.8, top_k=8, sample_seed=3)),
        dict(name=f"spec-padded-{t}", ex=_ex("padded"), requests=REQS,
             server_kw=dict(plain, speculate=2)),
        dict(name=f"spec-paged-{t}", ex=_ex("paged"), requests=REQS,
             server_kw=dict(plain, speculate=2)),
        dict(name=f"prefix-{t}", ex=_ex("paged", prefix_cache=True),
             requests=_prefix_reqs(), server_kw=plain),
        dict(name=f"sched-{t}", ex=_ex("padded"), requests=SCHED_REQS,
             server="sched", server_kw=plain),
        dict(name=f"fleet-{t}", ex=_ex("padded"), requests=SCHED_REQS,
             server="fleet", server_kw=plain),
        # Superstep 1 NaNs slot 2: rank 1's first row under n = 2.
        dict(name=f"nan-{t}", ex=_ex("padded"), requests=REQS,
             server_kw=plain, nan_cache_at={1: 2}),
    ]
    if shard is None:
        return cases
    cases.append(dict(name=f"ckpt-{t}", ex=_ex("padded"), requests=REQS,
                      server_kw=plain, ckpt=ckpt))
    if shard[1] > 1:
        cases.append(dict(name=f"fault-reduce-{t}", ex=_ex("padded"),
                          requests=REQS, server_kw=plain,
                          fault="skip_c_all_reduce"))
    if shard[0] > 1:
        cases += [
            dict(name=f"fault-gather-{t}", ex=_ex("padded"), requests=REQS,
                 server_kw=plain, fault="gather_order"),
            dict(name=f"degrade-{t}", ex=_ex("padded", max_batch=6),
                 requests=SCHED_REQS, server="sched", server_kw=plain,
                 env={"FF_DEVICE_MEM_BYTES": DEGRADE_BYTES}),
        ]
    return [dict(c, shard=shard) for c in cases]


#: JAX's checks, raised inside a world of 2.
ERROR_CASES = [
    dict(name="err-batch", shard=(2, 1), ex=_ex("padded", max_batch=3),
         expect_error=True),
    dict(name="err-heads", shard=(1, 2), ex=_ex("padded"),
         model=dict(num_heads=1), expect_error=True),
    dict(name="err-world", shard=(2, 2), ex=_ex("padded"), expect_error=True),
]


# -- the JAX side --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    lm = jbuild(config=JConfig(batch_size=B), **MODEL_KW)
    sex = jserving.ServingExecutor(lm, max_batch=B, max_seq=S,
                                   buckets=BUCKETS, decode_kernel=False)
    params, state = sex.init(seed=0)
    sharp = jax.tree.map(lambda a: np.asarray(a) * SHARP if a.ndim == 2
                         else np.asarray(a), jax.device_get(params))
    return lm, sharp, state


@pytest.fixture(scope="module")
def np_params(jax_side):
    return jax_side[1]


@pytest.fixture(scope="module")
def jax_tokens(jax_side):
    """Greedy tokens of JAX's engines: single-mesh and sharded, padded and
    paged."""
    lm, sharp, state = jax_side
    out = {}
    for shard in [None] + SHARDS:
        for layout, kvb in LAYOUTS.items():
            ex = jserving.ServingExecutor(lm, max_batch=B, max_seq=S,
                                          buckets=BUCKETS, kv_block=kvb,
                                          decode_kernel=False, shard=shard)
            assert ex.shard == shard
            res, stats = jserving.Server(
                ex, ex._place(sharp), ex._place(state), decode_steps=4).run(
                    [jserving.Request(id=i, prompt=np.asarray(p, np.int32),
                                      max_new_tokens=m)
                     for i, p, m, _t in REQS])
            assert stats["failed"] == 0
            out[shard, layout] = {rid: r.tokens for rid, r in res.items()}
    return out


@pytest.fixture(scope="module")
def jax_full_logits(jax_side):
    lm, sharp, _state = jax_side
    ex = JExecutor(lm, config=lm.config)
    params, _opt, state = ex.init(seed=0)
    params = jax.tree.map(lambda a, b: jax.device_put(b, a.sharding),
                          params, sharp)
    toks = np.zeros((B, S), np.int32)
    toks[0] = TEACHER
    _, outs = ex.forward_step(params, state, {
        "tokens": toks, "label": np.zeros((B, S), np.int32)})
    return np.asarray(outs["lm_head:out"])[0]


# -- the port's worlds -----------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(np_params, tmp_path_factory):
    """A one-rank training checkpoint of the sharpened parameters."""
    path = str(tmp_path_factory.mktemp("serving_mesh_ckpt"))
    with CheckpointManager(path) as ck:
        ck.save(1, params_from_numpy(np_params, "cpu"), None, {})
    return path


def _by_name(ranks):
    return [{r["name"]: r for r in rank} for rank in ranks]


@pytest.fixture(scope="module")
def one(np_params):
    """The port's one-engine runs, in this process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = mesh_smoke.serve_cases(MODEL_KW, np_params, _cases(None))
    finally:
        torch.set_num_threads(threads)
    return {r["name"][:-len("-one")]: r for r in got}


@pytest.fixture(scope="module")
def world2(np_params, ckpt):
    cases = _cases((2, 1), ckpt) + _cases((1, 2), ckpt) + ERROR_CASES
    return _by_name(launch.run(
        "flexflow_torch.tools.mesh_smoke:serve_cases",
        (MODEL_KW, np_params, cases, "cpu"), nprocs=2, device="cpu",
        timeout_s=WORLD_S))


@pytest.fixture(scope="module")
def world4(np_params, ckpt):
    return _by_name(launch.run(
        "flexflow_torch.tools.mesh_smoke:serve_cases",
        (MODEL_KW, np_params, _cases((2, 2), ckpt), "cpu"), nprocs=4,
        device="cpu", timeout_s=WORLD_S))


@pytest.fixture(scope="module")
def ranks(request):
    """Every rank's results of a shard's world."""
    def of(shard):
        world = request.getfixturevalue("world4" if shard == (2, 2)
                                        else "world2")
        return [{k[:-len(_tag(shard)) - 1]: v for k, v in rank.items()
                 if k.endswith("-" + _tag(shard))} for rank in world]
    return of


# -- tokens and logits -----------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("shard", SHARDS, ids=_tag)
def test_sharded_greedy_equals_jax_engines(ranks, jax_tokens, one, shard,
                                           layout):
    want = jax_tokens[None, layout]
    assert want == jax_tokens[shard, layout]
    assert one[f"greedy-{layout}"]["tokens"] == want
    assert len({t for toks in want.values() for t in toks}) > 4
    n, c = shard
    for r in ranks(shard):
        got = r[f"greedy-{layout}"]
        assert got["shard"] == shard and got["stats"]["shard"] == list(shard)
        assert got["stats"]["failed"] == 0 and not got["jax_imported"]
        assert got["tokens"] == want
        # The rank's share: prefills on its h/c heads, the padded decode's
        # K6 on its (B/n, h/c) block; the paged decode runs no K6.
        assert {s[:2] for s in got["shapes"]["flash_attention_lse_auto"]} \
            == {(1, H // c)}
        assert got["shapes"].get("flash_decode", []) == (
            [(B // n, H // c, D // H)] if layout == "padded" else [])


@pytest.mark.parametrize("shard", SHARDS, ids=_tag)
def test_sharded_decode_logits_match_jax_full_forward(ranks, jax_full_logits,
                                                      shard):
    for r in ranks(shard):
        tok0, logits = r["greedy-padded"]["teacher"]
        assert tok0 == int(np.argmax(jax_full_logits[TEACHER_PREFIX - 1]))
        err = float(np.max(np.abs(logits
                                  - jax_full_logits[TEACHER_PREFIX:])))
        assert err <= DECODE_TOL, f"sharded decode drift {err}"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("shard", SHARDS, ids=_tag)
def test_request_alone_equals_batched(ranks, shard, layout):
    rid = 0 if layout == "padded" else 1
    for r in ranks(shard):
        alone = r[f"alone-{layout}"]["tokens"]
        assert list(alone) == [rid]
        assert alone[rid] == r[f"greedy-{layout}"]["tokens"][rid]


@pytest.mark.parametrize("case", ["sampled", "spec-padded", "spec-paged",
                                  "prefix", "ckpt"])
@pytest.mark.parametrize("shard", SHARDS, ids=_tag)
def test_features_equal_one_engine(ranks, one, shard, case):
    want = one["greedy-padded" if case == "ckpt" else case]
    for r in ranks(shard):
        got = r[case]
        assert got["stats"]["failed"] == 0 and got["shard"] == shard
        assert got["tokens"] == want["tokens"]
    if case.startswith("spec"):
        assert got["tokens"] == one[f"greedy-{case[5:]}"]["tokens"]
        assert got["stats"]["spec_acceptance_rate"] == 1.0
    if case == "prefix":
        assert got["stats"]["prefix_hits"] == want["stats"]["prefix_hits"] > 0
    if case == "sampled":
        assert got["tokens"] != one["greedy-padded"]["tokens"]


@pytest.mark.parametrize("server", ["sched", "fleet"])
@pytest.mark.parametrize("shard", SHARDS, ids=_tag)
def test_scheduler_and_fleet_decide_as_one_engine(ranks, one, shard, server):
    want = one[server]
    assert want["stats"]["failed"] == 0
    for r in ranks(shard):
        got = r[server]
        assert got["decisions"] == want["decisions"]
        assert got["tokens"] == want["tokens"]
        assert got["stats"]["shard"] == list(shard)


def test_init_in_a_world_draws_every_parameter_whole(world2, world4):
    from flexflow_torch.runtime.serving import ServingExecutor

    lm = tbuild(config=TConfig(batch_size=B), **MODEL_KW)
    want = mesh_smoke.digest(ServingExecutor(lm, max_batch=B,
                                             device="cpu").init(0)[0])
    for world in (world2, world4):
        for rank in world:
            for name, r in rank.items():
                if name.startswith("greedy-padded"):
                    assert r["init_digest"] == want, name


@pytest.mark.parametrize("shard", SHARDS, ids=_tag)
def test_nan_cache_fails_only_its_slot(ranks, one, shard):
    base = one["greedy-padded"]["tokens"]
    want = one["nan"]
    bad = [rid for rid, e in want["errors"].items() if e]
    assert len(bad) == 1 and "non-finite" in want["errors"][bad[0]]
    for r in ranks(shard):
        got = r["nan"]
        assert got["errors"] == want["errors"]
        assert {k: v for k, v in got["tokens"].items() if k not in bad} == \
            {k: v for k, v in base.items() if k not in bad}


@pytest.mark.parametrize("fault,shard", [
    ("reduce", (1, 2)), ("reduce", (2, 2)), ("gather", (2, 1)),
    ("gather", (2, 2))], ids=lambda v: v if isinstance(v, str) else _tag(v))
def test_planted_faults_break_the_tokens(ranks, one, fault, shard):
    """Each fault keeps the collectives matched (the world does not hang)
    and changes tokens on the faulty rank or on every rank."""
    want = one["greedy-padded"]["tokens"]
    got = [r[f"fault-{fault}"]["tokens"] for r in ranks(shard)]
    assert got[0] != want or got[1] != want


def test_degraded_rung_keeps_the_batch_a_multiple_of_n(ranks, one):
    for r in ranks((2, 1)):
        got = r["degrade"]
        assert [d["rung"] for d in got["degraded"]] == ["shrink_batch"]
        assert got["degraded"][0]["prev"] == 6 and got["max_batch"] == 2
        assert got["rows"] in ((0, 1), (1, 2))
        assert got["tokens"] == one["sched"]["tokens"]


def test_checks_raise_with_jax_words(world2):
    for rank in world2:
        assert "shard batch degree n=2 must divide max_batch=3" in \
            rank["err-batch"]["error"]
        assert "shard head degree c=2 must divide num_heads of every " \
            "attention op" in rank["err-heads"]["error"]
        assert "needs a world of 4 ranks" in rank["err-world"]["error"]


def test_sharded_falls_back_without_a_world(caplog):
    lm = tbuild(config=TConfig(batch_size=2), **dict(MODEL_KW, batch_size=2))
    with caplog.at_level(logging.WARNING, logger="ff.serving"):
        ex = tserving.ServingExecutor(lm, max_batch=2, max_seq=S,
                                      buckets=(8,), shard=(64, 2),
                                      device="cpu")
    assert ex.shard is None
    assert any("falling back to the single-mesh engine" in r.message
               for r in caplog.records)
    with pytest.raises(ValueError, match="n\\*c >= 2"):
        tserving.ServingExecutor(lm, max_batch=2, shard=(1, 1), device="cpu")


# -- the app and the bench entry ---------------------------------------------------


def test_serve_app_shard_runs_a_world(capfd, tmp_path):
    journal = str(tmp_path / "journal")
    stats = {}
    argv = ["--vocab", str(V), "--d-model", str(D), "--heads", str(H),
            "--layers", str(L), "--max-seq", str(S), "--max-batch", "2",
            "--buckets", "8,16", "--requests", "3", "--prompt-len", "3:9",
            "--max-new", "5", "--decode-steps", "4", "--seed", "1",
            "--shard", "2,1", "--journal", journal]
    assert tserve.main(argv, device="cpu", stats_out=stats) == 0
    out = capfd.readouterr().out
    assert "mesh shard = batch n=2 x heads c=1" in out
    assert out.count("requests = 3 completed = 3 failed = 0") == 1
    assert stats["shard"] == [2, 1] and stats["tokens"] == 15
    assert sorted(p.name for p in tmp_path.iterdir()) == ["journal",
                                                         "journal.rank1"]


def test_bench_sharded_columns_on_a_world():
    kw = dict(vocab=V, d_model=D, heads=H, layers=L, max_seq=32, max_batch=4,
              n_req=4, max_new=6, dtype="float32")
    got = launch.run("flexflow_torch.bench:sharded_serving_rank", (kw, "cpu"),
                     nprocs=2, device="cpu", timeout_s=WORLD_S)
    assert got[0]["shard"] == [2, 1] and got[0]["tokens_per_s"] > 0
    assert got[0]["tokens"] == got[1]["tokens"] == 4 * 6
