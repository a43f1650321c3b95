"""The port's serving features (paged KV, prefix cache, keyed sampling,
speculation, the decode superstep as a graph) held against the JAX
package and against the port's own invariants, on the CPU at
``V, D, H, L, S = 64, 32, 2, 2, 16`` with 4-token KV blocks.

JAX's ``ServingExecutor.init(seed=0)`` parameters cross into the port
through ``params_from_numpy``.  Against JAX, in f32: the ledger's rows,
plans, refcounts and free lists exactly; ``prefix_digests`` byte for
byte; paged decode logits within ``DECODE_TOL`` (1e-4,
``tests/test_serving.py``); the capacity helpers' numbers exactly; the
keyed draw's keys and bits exactly and its Gumbel noise within one f32
ulp of ``max(|g|, 1)`` (``torch.log`` and XLA's ``log`` round apart);
greedy, paged, prefix-shared, speculative and sampled tokens exactly.
Inside the port, with both sides on ``decode_kernel=False`` as JAX's
fixtures: paged decode logits bit for bit equal to padded; shared
prefix tokens equal to unshared (only tokens are held here, as JAX
holds them; ``tests/test_torch_sched.py`` holds the offset prefill's
tail rows bit for bit); speculative tokens equal to plain;
sampled tokens that replay across K, batch composition and reruns; and
the graph form of the decode superstep and of the speculative round
equal to the eager form bit for bit, updating ``pos`` and ``tok`` in
place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime import serving as jserving
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import DeviceMemoryError
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.runtime import keyed_random
from flexflow_torch.runtime import serving as tserving
from flexflow_torch.weights import params_from_numpy

V, D, H, L, S = 64, 32, 2, 2, 16
BUCKETS = (8, S)
KV_BLOCK = 4
DECODE_TOL = 1e-4
SAMPLE = dict(temperature=0.8, top_k=8, sample_seed=3)


def _model_kw():
    return dict(batch_size=2, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L)


@pytest.fixture(scope="module")
def jlm():
    return jbuild(config=JConfig(batch_size=2), **_model_kw())


@pytest.fixture(scope="module")
def tlm():
    return tbuild(config=TConfig(batch_size=2), **_model_kw())


def _jex(jlm, **kw):
    return jserving.ServingExecutor(jlm, max_batch=2, max_seq=S,
                                    buckets=BUCKETS, decode_kernel=False, **kw)


def _tex(tlm, **kw):
    return tserving.ServingExecutor(tlm, max_batch=2, max_seq=S,
                                    buckets=BUCKETS, decode_kernel=False,
                                    device="cpu", **kw)


@pytest.fixture(scope="module")
def jw(jlm):
    return _jex(jlm).init(seed=0)


@pytest.fixture(scope="module")
def tparams(jw):
    return params_from_numpy(jax.device_get(jw[0]), device="cpu")


@pytest.fixture(scope="module")
def tex(tlm):
    return {"padded": _tex(tlm), "paged": _tex(tlm, kv_block=KV_BLOCK),
            "prefix": _tex(tlm, kv_block=KV_BLOCK, prefix_cache=True)}


@pytest.fixture(scope="module")
def jex(jlm):
    return {"padded": _jex(jlm), "paged": _jex(jlm, kv_block=KV_BLOCK),
            "prefix": _jex(jlm, kv_block=KV_BLOCK, prefix_cache=True)}


def _serve_t(ex, params, reqs, **kw):
    res, stats = tserving.Server(ex, params, {}, **kw).run(
        [tserving.Request(r, np.asarray(p, np.int32), m) for r, p, m in reqs])
    return res, stats


def _serve_j(ex, w, reqs, **kw):
    res, stats = jserving.Server(ex, w[0], w[1], **kw).run(
        [jserving.Request(id=r, prompt=np.asarray(p, np.int32),
                          max_new_tokens=m) for r, p, m in reqs])
    return res, stats


def _toks(res):
    assert all(r.error is None for r in res.values()), \
        {k: r.error for k, r in res.items()}
    return {k: r.tokens for k, r in res.items()}


def _spec_reqs():
    return [(0, [5, 9, 2], 7), (1, [3, 1, 4, 1, 5], 6), (2, [31, 3, 3, 7], 5)]


def _prefix_reqs(tails, max_new=5):
    """Requests sharing an 8-token span (two full blocks), each with its
    own ``tails[i]``-token suffix (0 = the bare span)."""
    rng = np.random.default_rng(5)
    span = rng.integers(0, V, size=8)
    out = []
    for i, t in enumerate(tails):
        tail = rng.integers(0, V, size=t)
        out.append((i, np.concatenate([span, tail]), max_new))
    return out


# -- the host-side ledger ----------------------------------------------------


def _ledger_trace(mod, seed: int):
    """One seeded sequence of plan / alloc / register / record / free
    calls on ``mod``'s ledger, logging every plan, row and the free list,
    refcounts and index after each call."""
    rng = np.random.default_rng(seed)
    led = mod.KVBlockLedger(13, KV_BLOCK, S, prefix_cache=True)
    span = rng.integers(0, V, size=8)
    held, log = set(), []
    for _ in range(80):
        op, slot = int(rng.integers(0, 3)), int(rng.integers(0, 4))
        if op < 2 and slot not in held:
            cut = (4, 8, 8, 3, 6)[int(rng.integers(0, 5))]
            tail = rng.integers(0, V, size=(0, 0, 2, 5)[int(rng.integers(0, 4))])
            prompt = np.concatenate([span[:cut], tail]).astype(np.int32)
            need = led.blocks_for(len(prompt), int(rng.integers(1, 8)))
            plan = led.plan_prefix(prompt)
            log.append(("plan", plan.use, plan.cow, plan.offset,
                        plan.full_hit, plan.tok0, tuple(plan.shared), need))
            if need > led.capacity_blocks or not led.can_admit(need - plan.use):
                continue
            log.append(("row", tuple(led.alloc(slot, need, shared=plan.shared))))
            held.add(slot)
            dig = mod.prefix_digests(prompt, KV_BLOCK)
            led.register_prefix(slot, dig, start=plan.use)
            if dig and len(prompt) % KV_BLOCK == 0 and not plan.full_hit:
                led.record_next(dig[-1], int(rng.integers(0, V)))
        elif slot in held:
            led.free(slot)
            held.discard(slot)
        log.append(("state", tuple(led._free), tuple(sorted(led._ref.items())),
                    tuple(sorted((k.hex(), b) for k, b in led._index.items())),
                    led.free_blocks))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_matches_jax(seed):
    jlog, tlog = _ledger_trace(jserving, seed), _ledger_trace(tserving, seed)
    assert tlog == jlog
    assert any(e[0] == "plan" and e[1] > 0 for e in tlog)   # sharing ran
    assert any(e[0] == "plan" and e[4] for e in tlog)       # a full hit


@pytest.mark.parametrize("block", [1, 4, 5])
def test_prefix_digests_match_jax(block):
    rng = np.random.default_rng(block)
    for n in (0, 3, 8, 17):
        toks = rng.integers(0, 2 ** 31 - 1, size=n).astype(np.int32)
        assert tserving.prefix_digests(toks, block) == \
            jserving.prefix_digests(toks, block)


def test_ledger_unit_contract():
    """JAX's ledger unit tests (reuse lowest first, refcounts, the CoW
    clamp, the full hit, index eviction at the last free) on the port."""
    led = tserving.KVBlockLedger(9, 4, S)
    assert led.capacity_blocks == 8 and led.blocks_per_slot == 4
    assert led.blocks_for(3, 6) == 3 and led.blocks_for(10, 100) == 4
    r0, r1 = led.alloc(0, 3), led.alloc(1, 3)
    assert list(r0) == [1, 2, 3, 0] and list(r1) == [4, 5, 6, 0]
    assert led.free_blocks == 2 and not led.can_admit(3)
    led.free(0)
    assert list(led.alloc(0, 2)) == [1, 2, 0, 0]
    with pytest.raises(RuntimeError, match="already holds"):
        led.alloc(0, 1)

    led = tserving.KVBlockLedger(9, 4, S, prefix_cache=True)
    prompt = np.arange(1, 9, dtype=np.int32)
    dig = tserving.prefix_digests(prompt, 4)
    row = led.alloc(0, 3)
    led.register_prefix(0, dig)
    plan = led.plan_prefix(prompt)
    assert (plan.use, plan.cow, plan.offset, plan.full_hit) == (1, 1, 4, False)
    led.record_next(dig[-1], 7)
    plan2 = led.plan_prefix(prompt)
    assert plan2.full_hit and plan2.tok0 == 7 and plan2.offset == 8
    assert plan2.shared == (int(row[0]), int(row[1]))
    led.alloc(1, 3, shared=plan2.shared)
    led.free(0)
    assert led.plan_prefix(prompt).full_hit
    led.free(1)
    assert led.plan_prefix(prompt).use == 0
    assert led.free_blocks == led.capacity_blocks
    assert list(led.alloc(0, 2)) == [1, 2, 0, 0]


# -- paged KV ----------------------------------------------------------------


def _paged_decode_logits(ex, params, state, toks, prefix: int):
    """Prefill ``prefix`` tokens into bucket 8, then decode feeding the
    true next tokens; returns (first token, per-step (V,) logits)."""
    padded = np.zeros((1, 8), np.int32)
    padded[0, :prefix] = toks[0, :prefix]
    rows, tok0, ok = ex.build_prefill(8)(params, state, padded,
                                         np.int32(prefix))
    assert bool(np.asarray(ok))
    led = ex.make_ledger() if ex.paged else None
    caches = ex.init_cache()
    if led is not None:
        row = led.alloc(0, led.blocks_for(prefix, S))
        bt = np.zeros((2, led.blocks_per_slot), np.int32)
        bt[0] = row
        caches = ex.install_paged(caches, rows, row)
    else:
        caches = ex.install(caches, rows, 0)
    dec = ex.build_decode_superstep(1, return_logits=True)
    pos = np.array([prefix, 0], np.int32)
    out = []
    for t in range(prefix, S):
        tokv = np.array([toks[0, t], 0], np.int32)
        args = (caches,) + ((bt,) if led is not None else ()) + (pos, tokv)
        caches, pos_d, _t, (_nxt, okf, logits) = dec(params, state, *args)
        assert bool(np.asarray(okf)[0, 0])
        out.append(np.asarray(logits)[0, 0])
        pos = np.asarray(pos_d)
    return int(np.asarray(tok0)), np.stack(out)


@pytest.fixture(scope="module")
def true_tokens():
    return np.random.default_rng(0).integers(0, V, size=(1, S)).astype(np.int32)


def test_paged_decode_logits_match_jax(jlm, jex, jw, tex, tparams, true_tokens):
    ex = JExecutor(jlm, config=jlm.config)
    p, _o, st = ex.init(seed=0)
    _, outs = ex.forward_step(p, st, {"tokens": true_tokens,
                                      "label": np.zeros((1, S), np.int32)})
    full = np.asarray(outs["lm_head:out"])[0]
    jtok, jlog = _paged_decode_logits(jex["paged"], jw[0], jw[1],
                                      true_tokens, 6)
    ttok, tlog = _paged_decode_logits(tex["paged"], tparams, {},
                                      true_tokens, 6)
    assert ttok == jtok == int(np.argmax(full[5]))
    assert float(np.max(np.abs(tlog - jlog))) <= DECODE_TOL
    assert float(np.max(np.abs(tlog - full[6:]))) <= DECODE_TOL


def test_paged_decode_bit_identical_to_padded(tex, tparams, true_tokens):
    """Both sides run ``_einsum_decode`` on (B, max_seq, h, hd) views of
    the same K/V: the logits agree bit for bit."""
    a = _paged_decode_logits(tex["padded"], tparams, {}, true_tokens, 6)
    b = _paged_decode_logits(tex["paged"], tparams, {}, true_tokens, 6)
    assert a[0] == b[0]
    assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))


def test_paged_vs_padded_greedy_parity(tex, jex, tparams, jw):
    reqs = [(0, [5, 9, 2], 6), (1, [3, 1, 4, 1, 5], 4), (2, [31, 3, 3, 7], 7)]
    base = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4)[0])
    pg, stats = _serve_t(tex["paged"], tparams, reqs, decode_steps=4)
    assert stats["kv_layout"] == "paged" and stats["kv_block"] == KV_BLOCK
    assert stats["kv_blocks"] == 2 * S // KV_BLOCK + 1
    assert _toks(pg) == base
    assert _toks(_serve_j(jex["paged"], jw, reqs, decode_steps=4)[0]) == base
    alone = _serve_t(tex["paged"], tparams, [reqs[1]], decode_steps=4)[0]
    assert _toks(alone)[1] == base[1]


def test_paged_eviction_block_table_reuse(tlm, tex, tparams):
    """A pool too small for two concurrent requests: the waiter admits
    only after an eviction frees blocks and reuses them; the tokens equal
    the roomy pool's.  A request larger than the whole pool is refused."""
    reqs = [(0, [1, 2, 3], 6), (1, [4, 5, 6], 6), (2, [7, 8, 9], 6)]
    tight, stats = _serve_t(_tex(tlm, kv_block=4, kv_blocks=5), tparams,
                            reqs, decode_steps=4)
    assert stats["completed"] == 3 and stats["failed"] == 0
    assert _toks(tight) == _toks(
        _serve_t(tex["paged"], tparams, reqs, decode_steps=4)[0])
    big, _ = _serve_t(_tex(tlm, kv_block=4, kv_blocks=4), tparams,
                      [(9, [1, 2, 3, 4, 5, 6, 7], 30)], decode_steps=4)
    assert "KV blocks" in big[9].error


def test_capacity_helpers_match_jax(jlm, tlm):
    cases = [{}, dict(kv_block=4), dict(kv_block=8, kv_blocks=5)]
    for dtype in ("float32", "bfloat16"):
        jl = jbuild(config=JConfig(batch_size=2, compute_dtype=dtype),
                    **_model_kw())
        tl = tbuild(config=TConfig(batch_size=2, compute_dtype=dtype),
                    **_model_kw())
        for kw in cases:
            j, t = _jex(jl, **kw), _tex(tl, **kw)
            assert t.cache_total_bytes() == j.cache_total_bytes()
            assert t._bytes_per_token == j._bytes_per_token
            assert t.hbm_per_slot_bytes() == j.hbm_per_slot_bytes()
            assert t.hbm_per_slot_bytes(2, 1) == j.hbm_per_slot_bytes(2, 1)
            for budget in (4096, 40000, 10 ** 6):
                assert t.max_admissible_batch(budget, 2, 1) == \
                    j.max_admissible_batch(budget, 2, 1)
            assert (t.kv_blocks, t.blocks_per_slot) == \
                (j.kv_blocks, j.blocks_per_slot)


def test_paged_capacity_under_budget(tlm, monkeypatch):
    padded = tserving.ServingExecutor(tlm, max_batch=4, max_seq=S,
                                      buckets=(8,), device="cpu")
    budget = padded.cache_total_bytes() // 2
    monkeypatch.setenv("FF_DEVICE_MEM_BYTES", str(budget))
    with pytest.raises(DeviceMemoryError, match="paged"):
        padded.init_cache()
    blocks = budget // (4 * padded._bytes_per_token)
    paged = tserving.ServingExecutor(tlm, max_batch=4, max_seq=S,
                                     buckets=(8,), device="cpu", kv_block=4,
                                     kv_blocks=blocks)
    paged.init_cache()
    assert paged.max_admissible_batch(budget, 2, 1) >= \
        2 * padded.max_admissible_batch(budget, 2, 1)


def test_paged_args_are_checked(tlm):
    with pytest.raises(ValueError, match="divide"):
        _tex(tlm, kv_block=5)
    with pytest.raises(ValueError, match="kv_blocks needs"):
        _tex(tlm, kv_blocks=9)
    with pytest.raises(ValueError, match="paged"):
        _tex(tlm, prefix_cache=True)


# -- the keyed draw ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_keyed_draw_matches_jax(seed):
    for rid in (0, 1, 77):
        for pos in (0, 5, 127):
            jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                       rid), pos)
            tk = keyed_random.fold_in(
                keyed_random.fold_in(keyed_random.key(seed),
                                     torch.tensor(rid)), torch.tensor(pos))
            np.testing.assert_array_equal(
                tk.numpy(), np.asarray(jax.random.key_data(jk)).astype(np.int64))
            np.testing.assert_array_equal(
                keyed_random.bits(tk, 300).numpy(),
                np.asarray(jax.random.bits(jk, (300,), jnp.uint32)).astype(
                    np.int64))
            jg = np.asarray(jax.random.gumbel(jk, (300,), jnp.float32))
            tg = keyed_random.gumbel(tk, 300).numpy()
            assert np.all(np.abs(tg - jg) <= np.spacing(
                np.maximum(np.abs(jg), 1.0).astype(np.float32)))
            lg = np.random.default_rng(rid + pos).standard_normal(
                300).astype(np.float32)
            assert int(keyed_random.categorical(tk, torch.from_numpy(lg))) == \
                int(jax.random.categorical(jk, jnp.asarray(lg)))


def test_keyed_draw_is_batched_per_row():
    """Rows of a batched draw are the draws of their own keys."""
    base = keyed_random.key(3)
    rids, pos = torch.tensor([4, 0, 9]), torch.tensor([1, 2, 3])
    kk = keyed_random.fold_in(keyed_random.fold_in(base, rids), pos)
    b = keyed_random.bits(kk, 50)
    for i in range(3):
        ki = keyed_random.fold_in(keyed_random.fold_in(base, rids[i]), pos[i])
        assert torch.equal(b[i], keyed_random.bits(ki, 50))
    with pytest.raises(ValueError):
        keyed_random.key(-1)


# -- sampling ----------------------------------------------------------------


def test_sampled_tokens_match_jax_server(tex, jex, tparams, jw):
    reqs = [(0, [5, 9, 2], 6), (1, [3, 1, 4], 6), (2, [8, 8], 5)]
    for layout in ("padded", "paged"):
        t, tstats = _serve_t(tex[layout], tparams, reqs, decode_steps=4,
                             **SAMPLE)
        j, _ = _serve_j(jex[layout], jw, reqs, decode_steps=4, **SAMPLE)
        assert tstats["sampled"] is True
        assert _toks(t) == _toks(j)


def test_sampling_replayable(tex, tparams):
    reqs = [(0, [5, 9, 2], 6), (1, [3, 1, 4], 6)]
    a = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4,
                       **SAMPLE)[0])
    assert _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4,
                          **SAMPLE)[0]) == a
    assert _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=2,
                          **SAMPLE)[0]) == a
    alone = _toks(_serve_t(tex["padded"], tparams, [reqs[1]], decode_steps=4,
                           **SAMPLE)[0])
    assert alone[1] == a[1]
    other = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4,
                           **dict(SAMPLE, sample_seed=4))[0])
    assert other != a
    greedy = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4)[0])
    assert greedy != a


def test_sampling_greedy_default(tex, tparams):
    reqs = [(0, [5, 9, 2], 6)]
    g1, stats = _serve_t(tex["padded"], tparams, reqs, decode_steps=4)
    g2, _ = _serve_t(tex["padded"], tparams, reqs, decode_steps=4,
                     temperature=0.0, top_k=8)
    assert stats["sampled"] is False and _toks(g1) == _toks(g2)
    with pytest.raises(ValueError, match="temperature"):
        tex["padded"].build_decode_superstep(2, sample=(0.0, 8, 3))


# -- the prefix cache --------------------------------------------------------


@pytest.mark.parametrize("tails", [(0, 0), (0, 1), (0, 3), (0, 4), (3, 3)])
def test_prefix_shared_greedy_parity(tex, jex, tparams, jw, tails):
    reqs = _prefix_reqs(tails)
    base = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4)[0])
    shared, stats = _serve_t(tex["prefix"], tparams, reqs, decode_steps=4)
    assert stats["prefix_cache"] is True and stats["prefix_hits"] >= 1
    assert _toks(shared) == base
    assert _toks(_serve_j(jex["prefix"], jw, reqs, decode_steps=4)[0]) == base


def test_prefix_full_hit_zero_dispatch(tex, tparams):
    reqs = _prefix_reqs((0, 0))
    base = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4)[0])
    shared, stats = _serve_t(tex["prefix"], tparams, reqs, decode_steps=4)
    assert stats["prefills"] == 1                  # the donor's only
    assert stats["prefix_hits"] == 1 and stats["prefix_hit_rate"] == 0.5
    assert stats["prefill_tokens_saved"] == 8
    assert _toks(shared) == base


def test_prefix_cow_divergence(tex, tparams):
    rng = np.random.default_rng(5)
    span = rng.integers(0, V, size=8)
    tail = rng.integers(0, V, size=4)
    reqs = [(0, np.concatenate([span, tail]), 4), (1, span, 4)]
    base = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4)[0])
    shared, stats = _serve_t(tex["prefix"], tparams, reqs, decode_steps=4)
    assert stats["kv_cows"] >= 1 and stats["prefix_hits"] >= 1
    assert _toks(shared) == base


def test_prefix_sampled_parity(tex, tparams):
    for tails in ((0, 0), (0, 3)):
        reqs = _prefix_reqs(tails)
        base = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4,
                              **SAMPLE)[0])
        shared, stats = _serve_t(tex["prefix"], tparams, reqs,
                                 decode_steps=4, **SAMPLE)
        assert stats["sampled"] and stats["prefix_hits"] >= 1
        assert _toks(shared) == base


def test_prefix_sharers_survive_donor_eviction(tex, tparams):
    """The donor finishes first and is evicted; the sharer decodes on
    against the shared blocks (its refcount holds them) and a third
    request shares them after the donor is gone."""
    reqs = [(i, p, m) for (i, p, _), m in zip(_prefix_reqs((3, 1, 2)),
                                              (2, 7, 4))]
    base = _toks(_serve_t(tex["padded"], tparams, reqs, decode_steps=4)[0])
    shared, stats = _serve_t(tex["prefix"], tparams, reqs, decode_steps=4)
    assert stats["prefix_hits"] == 2
    assert _toks(shared) == base


def test_prefill_from_is_checked(tex):
    with pytest.raises(ValueError, match="paged"):
        tex["paged"].build_prefill_from(S, 4)
    for bad in (0, 2, 16):
        with pytest.raises(ValueError, match="offset"):
            tex["prefix"].build_prefill_from(S, bad)


# -- speculation -------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_spec_tokens(tex, jex, tparams, jw):
    base = _toks(_serve_t(tex["padded"], tparams, _spec_reqs(),
                          decode_steps=4)[0])
    assert _toks(_serve_j(jex["padded"], jw, _spec_reqs(),
                          decode_steps=4)[0]) == base
    return base


@pytest.mark.parametrize("layout", ["padded", "paged"])
@pytest.mark.parametrize("d", [1, 3, 8])
def test_spec_greedy_parity_matrix(tex, tparams, plain_spec_tokens, layout, d):
    plain, pstats = _serve_t(tex[layout], tparams, _spec_reqs(),
                             decode_steps=4)
    sp, stats = _serve_t(tex[layout], tparams, _spec_reqs(), decode_steps=4,
                         speculate=d)
    assert stats["speculate"] == d and stats["draft_layers"] == 0
    assert stats["draft_prefills"] == stats["prefills"]
    assert stats["spec_acceptance_rate"] == 1.0
    assert _toks(sp) == _toks(plain) == plain_spec_tokens
    if d + 1 > pstats["decode_steps_per_call"]:
        assert stats["decode_supersteps"] < pstats["decode_supersteps"]


def test_spec_tokens_match_jax_server(tex, jex, tparams, jw):
    t, tstats = _serve_t(tex["paged"], tparams, _spec_reqs(), decode_steps=4,
                         speculate=3)
    j, jstats = _serve_j(jex["paged"], jw, _spec_reqs(), decode_steps=4,
                         speculate=3)
    assert _toks(t) == _toks(j)
    for key in ("decode_supersteps", "spec_acceptance_rate",
                "spec_tokens_per_dispatch", "draft_prefills"):
        assert tstats[key] == jstats[key], key


def test_spec_truncated_draft_parity(tlm, tparams, plain_spec_tokens):
    ex = _tex(tlm, draft_layers=1)
    assert len(ex._draft_cache_specs) == 1          # blk1's attention skipped
    sp, stats = _serve_t(ex, tparams, _spec_reqs(), decode_steps=4,
                         speculate=4)
    assert stats["draft_layers"] == 1
    assert 0.0 <= stats["spec_acceptance_rate"] <= 1.0
    assert _toks(sp) == plain_spec_tokens
    with pytest.raises(ValueError, match="draft_layers"):
        _tex(tlm, draft_layers=3)


def test_spec_rejecting_draft_still_exact(tex, tparams, plain_spec_tokens):
    bad = tex["padded"].init(seed=99)[0]
    sp, stats = _serve_t(tex["padded"], tparams, _spec_reqs(),
                         decode_steps=4, speculate=4, draft_params=bad)
    assert stats["spec_acceptance_rate"] < 1.0
    assert _toks(sp) == plain_spec_tokens


def test_spec_sampled_parity(tex, tparams):
    base = _toks(_serve_t(tex["padded"], tparams, _spec_reqs(),
                          decode_steps=4, **SAMPLE)[0])
    for layout, d in (("padded", 2), ("paged", 4)):
        sp, stats = _serve_t(tex[layout], tparams, _spec_reqs(),
                             decode_steps=4, speculate=d, **SAMPLE)
        assert stats["sampled"] is True
        assert _toks(sp) == base
    alone = _toks(_serve_t(tex["padded"], tparams, [_spec_reqs()[1]],
                           decode_steps=4, speculate=4, **SAMPLE)[0])
    assert alone[1] == base[1]


def test_spec_clamp_matches_jax(tex, jex, tparams, jw):
    t = tserving.Server(tex["padded"], tparams, {}, speculate=64)
    j = jserving.Server(jex["padded"], jw[0], jw[1], speculate=64)
    assert t.speculate == j.speculate == 20
    with pytest.raises(ValueError):
        tex["padded"].build_spec_step(0)


# -- the graph form ----------------------------------------------------------


def _prefilled(ex, params, prompts):
    """Caches with ``prompts`` prefilled into slots 0.., the block table
    (paged), and the (pos, tok) host vectors."""
    caches = ex.init_cache()
    led = ex.make_ledger() if ex.paged else None
    bt = np.zeros((ex.max_batch, ex.blocks_per_slot), np.int32)
    pos = np.zeros(ex.max_batch, np.int32)
    tok = np.zeros(ex.max_batch, np.int32)
    for i, p in enumerate(prompts):
        padded = np.zeros((1, 8), np.int32)
        padded[0, :len(p)] = p
        rows, tok0, _ok = ex.build_prefill(8)(params, {}, padded,
                                              np.int32(len(p)))
        if led is not None:
            bt[i] = led.alloc(i, led.blocks_for(len(p), S))
            ex.install_paged(caches, rows, bt[i])
        else:
            ex.install(caches, rows, i)
        pos[i], tok[i] = len(p), int(tok0)
    return caches, bt, pos, tok


@pytest.mark.parametrize("form", ["padded", "paged", "sampled", "spec"])
def test_graph_form_equals_eager(tex, tparams, form):
    """On the CPU a ``StepGraph`` loops; its form still takes the carry
    as tensors, updates ``pos`` and ``tok`` in place and hands the same
    tensors back, as the graph on the card must."""
    ex = tex["paged" if form == "paged" else "padded"]
    sample = (0.8, 8, 3) if form == "sampled" else None
    runs = {}
    for graph in (False, True):
        caches, bt, pos, tok = _prefilled(ex, tparams, [[5, 9, 2], [3, 1]])
        with torch.inference_mode():
            pos_t, tok_t = torch.from_numpy(pos), torch.from_numpy(tok)
            carry = [pos_t, tok_t]
            if ex.paged:
                carry = [torch.from_numpy(bt)] + carry
            if sample is not None:
                carry.append(torch.tensor([7, 2], dtype=torch.int32))
        if form == "spec":
            fn = ex.build_spec_step(3, graph=graph)
            dcaches = ex.init_draft_cache()
            for i, p in enumerate([[5, 9, 2], [3, 1]]):
                padded = np.zeros((1, 8), np.int32)
                padded[0, :len(p)] = p
                ex.install(dcaches, ex.build_draft_prefill(8)(tparams, {},
                                                              padded), i)
            outs = []
            for _ in range(2):
                _c, _d, p_out, t_out, res = fn(tparams, tparams, {}, caches,
                                               dcaches, *carry)
                outs.append([r.clone() for r in res])
        else:
            fn = ex.build_decode_superstep(3, return_logits=True,
                                           sample=sample, graph=graph)
            assert (fn.graph is not None) == graph
            outs = []
            for _ in range(2):
                _c, p_out, t_out, res = fn(tparams, {}, caches, *carry)
                outs.append([r.clone() for r in res])
        assert p_out is pos_t and t_out is tok_t
        runs[graph] = (outs, caches, pos_t.clone(), tok_t.clone())
    (oa, ca, pa, ta), (ob, cb, pb, tb) = runs[False], runs[True]
    assert torch.equal(pa, pb) and torch.equal(ta, tb)
    for xa, xb in zip(sum(oa, []), sum(ob, [])):
        assert torch.equal(xa, xb)
    rows = slice(1, None) if ex.paged else slice(None)  # block 0: scratch
    for name in ca:
        for kv in ("k", "v"):
            assert torch.equal(ca[name][kv][rows], cb[name][kv][rows])


def test_decode_carry_tensors_are_checked(tex, tparams):
    ex = tex["padded"]
    fn = ex.build_decode_superstep(2)
    caches = ex.init_cache()
    with pytest.raises(ValueError, match="int32"):
        fn(tparams, {}, caches, torch.zeros(2, dtype=torch.int64),
           torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="arguments"):
        fn(tparams, {}, caches, np.zeros(2, np.int32))


def test_features_run_without_jax():
    """The app with every feature, in a fresh process where ``jax`` and
    ``flexflow_tpu`` cannot be imported."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flexflow_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from flexflow_torch.apps import serve\n"
        "sys.exit(serve.main(['--vocab', '64', '--d-model', '32', '--heads',\n"
        "    '2', '--layers', '2', '--max-seq', '16', '--max-batch', '2',\n"
        "    '--buckets', '8,16', '--requests', '3', '--kv-block', '4',\n"
        "    '--prefix-cache', '--speculate', '2', '--draft-layers', '1',\n"
        "    '--temperature', '0.7', '--top-k', '8'], device='cpu'))\n"
    )
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "completed = 3 failed = 0" in r.stdout


def test_sampled_prefill_of_a_resumed_position_matches_jax(jex, jw, tex,
                                                           tparams):
    """The sampled prefill draws the first token only at a position past
    the prompt (a resume over prompt + carried tokens), with the key of
    that position: JAX's token there; greedy at a fresh admission."""
    padded = np.zeros((1, 8), np.int32)
    padded[0, :6] = [5, 9, 2, 41, 17, 3]
    sample = (0.8, 8, 3)
    for plen in (6, 4):
        j = jex["padded"].build_prefill(8, sample=sample)(
            jw[0], jw[1], padded, np.int32(6), np.int32(plen), np.int32(2))
        t = tex["padded"].build_prefill(8, sample=sample)(
            tparams, {}, padded, np.int32(6), np.int32(plen), np.int32(2))
        assert int(np.asarray(t[1])) == int(np.asarray(j[1]))
    greedy = tex["padded"].build_prefill(8)(tparams, {}, padded, np.int32(6))
    fresh = tex["padded"].build_prefill(8, sample=sample)(
        tparams, {}, padded, np.int32(6), np.int32(6), np.int32(2))
    assert int(greedy[1]) == int(fresh[1])
