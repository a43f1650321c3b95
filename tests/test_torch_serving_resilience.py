"""The failure model of the port's plain serving loop (ROADMAP item 4):
the fault injector, the request journal and its resume, the drain on
SIGTERM and the dry-run program table, held against the JAX package and
inside the port on the CPU.

Four of JAX's chaos scenarios, ported into
``flexflow_torch/runtime/chaos.py``, run as port tests on the scenarios'
own stack (vocab 32, d_model 16, 2
heads, 1 layer, 2 slots, max_seq 32; the JAX parameters carried
across), each on the padded and the paged layout and with ``graph=False``
and ``graph=True`` (on the CPU the graph form runs its steps as a loop,
``runtime/graphs.py``; ``chip_smoke.py``'s phase 21 holds the replay on
the card).  Every comparison of tokens is exact: the survivors of a
faulted run and the merged output of a drained-then-resumed run equal
the unfaulted run token for token, and the unfaulted port run equals
JAX's.  Journals cross between the packages in both directions, a torn
tail included.
"""

import functools
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime import serving as jserving
from flexflow_tpu.serving import journal as jjournal
from flexflow_torch.apps import serve as tserve
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.ops import kernels
from flexflow_torch.runtime import chaos
from flexflow_torch.runtime import serving as tserving
from flexflow_torch.runtime.resilience import PreemptionHandler
from flexflow_torch.serving import journal as tjournal
from flexflow_torch.weights import params_from_numpy

MODEL = dict(batch_size=2, seq_len=32, vocab_size=32, d_model=16,
             num_heads=2, num_layers=1)
RECOVERY_BUCKETS = (8, 16, 32)


def _requests():
    """``chaos._serving_requests``: 4 requests, prompts of 3-6 tokens,
    12 new tokens each, seed 7."""
    return tserving.synthetic_requests(4, 32, prompt_len=(3, 6),
                                       max_new_tokens=12, seed=7)


@pytest.fixture(scope="module")
def jax_params():
    lm = jbuild(config=JConfig(batch_size=2), **MODEL)
    sex = jserving.ServingExecutor(lm, max_batch=2, max_seq=32, buckets=(8,))
    params, _state = sex.init(seed=0)
    return jax.device_get(params)


def _stack(jax_params, kv_block=0, buckets=(8,), prefix_cache=False):
    lm = tbuild(config=TConfig(batch_size=2), **MODEL)
    sex = tserving.ServingExecutor(lm, max_batch=2, max_seq=32,
                                   buckets=buckets, device="cpu",
                                   kv_block=kv_block,
                                   prefix_cache=prefix_cache)
    return sex, params_from_numpy(jax_params, device="cpu")


def _serve(stack, requests, **kw):
    sex, params = stack
    return tserving.Server(sex, params, {}, decode_steps=4, **kw).run(requests)


def _tokens(results):
    return {rid: list(r.tokens) for rid, r in results.items()}


def _failed(results):
    return sorted(rid for rid, r in results.items() if r.error)


LAYOUTS = [0, 8]   # padded, paged with 8-token blocks
GRAPH = [False, True]


@pytest.fixture(scope="module")
def base(jax_params):
    """The unfaulted padded run: its tokens, which JAX's Server gives
    too."""
    res, _ = _serve(_stack(jax_params), _requests())
    assert not _failed(res)
    lm = jbuild(config=JConfig(batch_size=2), **MODEL)
    jsex = jserving.ServingExecutor(lm, max_batch=2, max_seq=32, buckets=(8,))
    jres, _ = jserving.Server(jsex, jsex.init(seed=0)[0], {},
                              decode_steps=4).run(_requests())
    assert _tokens(res) == _tokens(jres)
    return _tokens(res)


# -- the chaos scenarios (flexflow_torch/runtime/chaos.py) ------------------------


@pytest.mark.parametrize("graph", GRAPH)
@pytest.mark.parametrize("kv_block", LAYOUTS)
def test_decode_fault_isolates_the_faulted_slots(jax_params, base, kv_block,
                                                 graph, tmp_path):
    """``chaos.scenario_serving_decode_fault``: a NaN'd cache row
    (padded) or first block (paged) before superstep 1 and a raise before
    superstep 3: requests 0 and 2 error out, 1 and 3 keep the unfaulted
    tokens (``base``: JAX's too)."""
    ok, detail = chaos.scenario_serving_decode_fault(
        str(tmp_path), device="cpu", layouts=(kv_block,), graph=graph,
        params=jax_params)
    assert ok, detail


@pytest.mark.parametrize("graph", GRAPH)
@pytest.mark.parametrize("kv_block", LAYOUTS)
def test_sigterm_drains_and_the_journal_resumes(jax_params, base, kv_block,
                                                graph, tmp_path):
    """``chaos.scenario_serving_sigterm_drain``: SIGTERM before superstep
    1 on a journaled Server drains at the next boundary with no error and
    work left; a fresh Server on the journal serves the rest, the merged
    output equals the undrained run, and SIGTERM's default handling is
    back."""
    ok, detail = chaos.scenario_serving_sigterm_drain(
        str(tmp_path), device="cpu", layouts=(kv_block,), graph=graph,
        params=jax_params)
    assert ok, detail


@pytest.mark.parametrize("graph", GRAPH)
@pytest.mark.parametrize("kv_block", LAYOUTS)
def test_spec_fault_isolates_at_the_verify_fence(jax_params, base, kv_block,
                                                 graph, tmp_path):
    """``chaos.scenario_serving_spec_fault``: speculation (full
    self-draft, d = 4), clean, gives plain decode's tokens; under the
    fault matrix requests 0 and 2 error out at the verify fence and 1 and
    3 keep the unspeculated tokens."""
    ok, detail = chaos.scenario_serving_spec_fault(
        str(tmp_path), device="cpu", layouts=(kv_block,), graph=graph,
        params=jax_params)
    assert ok, detail


@pytest.mark.parametrize("graph", GRAPH)
def test_prefix_donor_crash_leaves_the_sharers_intact(jax_params, graph,
                                                      tmp_path):
    """``chaos.scenario_prefix_donor_eviction``: requests 0-2 share an
    8-token block; the donor (0) is raised out before superstep 1 while
    sharer 1 still points at its block.  The refcount keeps the block,
    the index survives (r2 still hits), and every sharer equals the
    unshared padded oracle; the paged run with the cache off equals it
    too."""
    ok, detail = chaos.scenario_prefix_donor_eviction(
        str(tmp_path), device="cpu", graph=graph, params=jax_params)
    assert ok, detail


# -- engine faults, journals across packages ---------------------------------


def _crash_requests():
    """``tests/test_serving.py``'s crash-resume workload: 0 finishes in
    superstep 0, 1 is in flight at the crash, 2 was just admitted, 3 is
    queued."""
    prompts = ([5, 9, 2], [3, 1, 4, 2], [7, 7], [2, 4, 6])
    budgets = (2, 5, 5, 5)
    return [tserving.Request(i, np.array(p, np.int32), b)
            for i, (p, b) in enumerate(zip(prompts, budgets))]


@functools.lru_cache(maxsize=None)
def _jax_stack(kv_block):
    """One JAX executor per layout for the module: its compiled programs
    are reused by every Server on it."""
    lm = jbuild(config=JConfig(batch_size=2), **MODEL)
    sex = jserving.ServingExecutor(lm, max_batch=2, max_seq=32,
                                   buckets=RECOVERY_BUCKETS,
                                   kv_block=kv_block)
    return sex, sex.init(seed=0)[0]


def _jax_server(kv_block=0, **kw):
    sex, params = _jax_stack(kv_block)
    return jserving.Server(sex, params, {}, decode_steps=2, **kw)


def _jax_requests():
    return [jserving.Request(r.id, r.prompt, r.max_new_tokens)
            for r in _crash_requests()]


def _tear(path):
    """Cut the journal's last line in half: a crash mid-append."""
    with open(path, "rb") as f:
        raw = f.read().rstrip(b"\n")
    last = raw.splitlines()[-1]
    with open(path, "wb") as f:
        f.write(raw[: len(raw) - len(last) // 2])


SAMPLED = dict(temperature=0.7, top_k=5, sample_seed=3)


@pytest.mark.parametrize("tear", [False, True])
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("kv_block", LAYOUTS)
def test_journal_written_by_jax_resumes_in_the_port(jax_params, kv_block,
                                                    sample, tear, tmp_path):
    """JAX's Server crashes on an engine fault at superstep 1 with a
    journal; the port's Server replays it: completed requests restored,
    the in-flight ones resumed by a re-prefill over prompt ‖ carried
    (the sampled prefill's keyed draw when sampling), and every sequence
    equals the uncrashed run's."""
    kw = SAMPLED if sample else {}
    stack = _stack(jax_params, kv_block, buckets=RECOVERY_BUCKETS)
    sex, params = stack
    base, _ = tserving.Server(sex, params, {}, decode_steps=2,
                              **kw).run(_crash_requests())
    path = str(tmp_path / "j.jsonl")
    with pytest.raises(jserving.ServingEngineFault):
        _jax_server(kv_block, journal=jjournal.RequestJournal(path),
                    fault_injector=jserving.ServingFaultInjector(
                        engine_raise_at={1: "crash"}), **kw).run(
            _jax_requests())
    st = tjournal.RequestJournal(path).replay()
    assert 0 in st.completed and st.in_flight
    if tear:
        _tear(path)
        assert tjournal.RequestJournal(path).replay().torn_tail
    res, stats = tserving.Server(sex, params, {}, decode_steps=2,
                                 journal=tjournal.RequestJournal(path),
                                 **kw).run(_crash_requests())
    assert stats["drained"] is False and not _failed(res)
    assert _tokens(res) == _tokens(base)


@pytest.mark.parametrize("tear", [False, True])
@pytest.mark.parametrize("kv_block", LAYOUTS)
def test_journal_written_by_the_port_resumes_in_jax(jax_params, kv_block,
                                                    tear, tmp_path):
    """The reverse: the port crashes (its ServingEngineFault propagates,
    as JAX's plain loop lets it), JAX's Server replays the port's
    journal and ends with JAX's uncrashed tokens."""
    jbase, _ = _jax_server(kv_block).run(_jax_requests())
    path = str(tmp_path / "j.jsonl")
    stack = _stack(jax_params, kv_block, buckets=RECOVERY_BUCKETS)
    sex, params = stack
    inj = tserving.ServingFaultInjector(engine_raise_at={1: "crash"})
    with pytest.raises(tserving.ServingEngineFault, match="crash"):
        tserving.Server(sex, params, {}, decode_steps=2, fault_injector=inj,
                        journal=tjournal.RequestJournal(path)).run(
            _crash_requests())
    assert inj.fired == [("engine", 1, -1)]
    if tear:
        _tear(path)
    st = jjournal.RequestJournal(path).replay()
    assert 0 in st.completed and st.torn_tail is tear
    res, _ = _jax_server(kv_block,
                         journal=jjournal.RequestJournal(path)).run(
        _jax_requests())
    assert _tokens(res) == _tokens(jbase)


def test_resume_of_a_finished_request_needs_no_prefill(jax_params,
                                                       tmp_path):
    """A journaled request whose tokens already reach its budget (the
    crash fell before its done record) is restored without a prefill."""
    path = str(tmp_path / "j.jsonl")
    jr = tjournal.RequestJournal(path)
    req = _crash_requests()[0]
    jr.admit(0, len(req.prompt), 4)
    jr.tokens(0, [6])
    jr.close()
    res, stats = tserving.Server(
        *_stack(jax_params, buckets=RECOVERY_BUCKETS), {}, decode_steps=2,
        journal=tjournal.RequestJournal(path)).run([req])
    assert res[0].tokens == [4, 6] and res[0].error is None
    assert stats["prefills"] == 0
    assert tjournal.RequestJournal(path).replay().completed[0]["tokens"] \
        == [4, 6]


# -- the journal's fold --------------------------------------------------------

EVENT_LISTS = [
    [],
    [{"ev": "sv_admit", "id": 0, "plen": 3, "tok": 7, "resumed": 0},
     {"ev": "sv_tokens", "id": 0, "toks": [9, 2]},
     {"ev": "sv_done", "id": 0, "plen": 3, "n": 3, "error": None,
      "latency_s": 0.5, "qw": 1.5},
     {"ev": "sv_admit", "id": 1, "plen": 4, "tok": 5, "resumed": 0},
     {"ev": "sv_tokens", "id": 1, "toks": [8]},
     {"ev": "sv_drain", "in_flight": 1, "queued": 1}],
    [{"ev": "sv_admit", "id": 2, "plen": 2, "resumed": 0},
     {"ev": "sv_done", "id": 2, "plen": 2, "n": 0,
      "error": "non-finite logits in prefill"},
     {"ev": "sv_done", "id": 3, "plen": 9, "n": 0, "error": "too long"},
     {"ev": "sv_admit", "id": 4, "plen": 3, "tok": 1, "resumed": 2},
     {"ev": "sv_tokens", "id": 4, "toks": []}],
    [{"ev": "sv_admit", "id": 5, "plen": 3, "tok": 1, "resumed": 0},
     {"ev": "sv_future", "id": 5},
     {"ev": "sv_future", "id": 6},
     {"ev": "sv_other"},
     {"ev": "sv_tokens", "id": 5, "toks": [2, 3]}],
]


@pytest.mark.parametrize("events", EVENT_LISTS)
def test_fold_journal_events_matches_jax(events):
    with pytest.warns() if any(e["ev"] not in tjournal.KNOWN_KINDS
                               for e in events) else _no_warning():
        got = tjournal.fold_journal_events([dict(e) for e in events])
    with pytest.warns() if got.unknown_kinds else _no_warning():
        want = jjournal.fold_journal_events([dict(e) for e in events])
    assert got.completed == want.completed
    assert got.in_flight == want.in_flight
    assert got.drained == want.drained and got.empty == want.empty
    assert got.unknown_kinds == want.unknown_kinds
    assert tjournal.KNOWN_KINDS == jjournal.KNOWN_KINDS


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_journal_files_match_jax_byte_for_byte(tmp_path):
    """The same writes give the same file in both packages, and each
    reads the other's, garbled and torn lines tolerated alike."""
    paths = []
    for mod, name in ((tjournal, "t.jsonl"), (jjournal, "j.jsonl")):
        jr = mod.RequestJournal(str(tmp_path / name))
        jr.admit(0, 3, 7)
        jr.tokens(0, [9, 2])
        jr.done(0, 3, 3, None, latency_s=0.25)
        jr.admit(1, 4, None, resumed=2)
        jr.drain(1, 0)
        jr.close()
        paths.append(jr.path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    with open(paths[0], "a") as f:
        f.write("garbage\n")
        f.write('{"ev": "sv_tokens", "id": 1, "toks": [4]}\n')
        f.write('{"ev":"sv_tok')
    mine, theirs = (tjournal.RequestJournal(paths[0]).replay(),
                    jjournal.RequestJournal(paths[0]).replay())
    for st in (mine, theirs):
        assert st.torn_tail and st.malformed == 1 and st.drained
        assert st.completed[0]["tokens"] == [7, 9, 2]
        assert st.in_flight == {1: [4]}
    missing = tjournal.RequestJournal(str(tmp_path / "none.jsonl")).replay()
    assert missing.empty and not missing.torn_tail
    mem = tjournal.MemoryJournal()
    mem.admit(3, 2, 1)
    mem.tokens(3, [5])
    assert mem.replay().in_flight == {3: [1, 5]}


# -- the injector, the handler, the request ----------------------------------


def test_injector_layouts_and_simulate_mode():
    caches = {"a": {"k": torch.zeros(3, 4, 2, 2), "v": torch.zeros(3, 4, 2, 2)},
              "b": {"k": torch.zeros(3, 4, 2, 2), "v": torch.zeros(3, 4, 2, 2)}}
    k_ptr = caches["a"]["k"].data_ptr()
    inj = tserving.ServingFaultInjector(nan_cache_at={0: 1, 1: 0, 2: 2})
    out, slot = inj.before_superstep(0, caches)   # padded: slot 1's row
    assert out is caches and slot == 1
    assert caches["a"]["k"][1].isnan().all()
    assert not caches["a"]["k"][[0, 2]].isnan().any()
    assert not caches["a"]["v"].isnan().any() and \
        not caches["b"]["k"].isnan().any()
    assert caches["a"]["k"].data_ptr() == k_ptr   # in place
    for c in caches.values():
        c["k"].zero_()
    table = np.array([[2, 1], [0, 0]], np.int32)  # slot 1 owns no block
    out, slot = inj.before_superstep(1, caches, table)
    assert slot == 0 and caches["a"]["k"][2].isnan().all()
    assert not caches["a"]["k"][[0, 1]].isnan().any()
    caches["a"]["k"].zero_()
    inj2 = tserving.ServingFaultInjector(nan_cache_at={0: 1})
    out, slot = inj2.before_superstep(0, caches, table)
    assert slot is None and not caches["a"]["k"].isnan().any()
    assert inj.before_superstep(2, None) == (None, 2)
    assert inj.before_superstep(3, caches) == (caches, None)
    assert [m for m, _, _ in inj.fired] == ["nan_cache"] * 3
    with pytest.raises(tserving.ServingFault) as e:
        tserving.ServingFaultInjector(raise_at={0: 1}).before_superstep(0, {})
    assert e.value.slot == 1
    assert tserving.EXIT_SERVING_FAILURE == jserving.EXIT_SERVING_FAILURE == 77
    assert issubclass(tserving.ServingCrashLoop, RuntimeError)


def test_request_deadline():
    r = tserving.Request(0, np.array([1], np.int32), arrival_ms=5.0,
                         slo_ms=20.0)
    assert r.deadline_ms == 25.0 == jserving.Request(
        0, r.prompt, arrival_ms=5.0, slo_ms=20.0).deadline_ms
    assert tserving.Request(1, r.prompt).deadline_ms == float("inf")


def test_preemption_handler_second_sigint_restores_the_default():
    with PreemptionHandler() as h:
        assert not h.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.triggered and h.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    with pytest.raises(KeyboardInterrupt):
        with PreemptionHandler() as h:
            os.kill(os.getpid(), signal.SIGINT)
            assert h.triggered
            os.kill(os.getpid(), signal.SIGINT)
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


def test_preemption_handler_off_the_main_thread_is_never_triggered():
    seen = {}

    def body():
        with PreemptionHandler() as h:
            seen["installed"] = bool(h._previous)
            seen["triggered"] = h.triggered

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen == {"installed": False, "triggered": False}


# -- the dry run -----------------------------------------------------------------


@pytest.mark.parametrize("layout", ["padded", "paged", "prefix"])
@pytest.mark.parametrize("speculate", [0, 2])
def test_dry_run_table_matches_jax(layout, speculate):
    """``abstract_programs`` on meta tensors: the table's keys and every
    shape and dtype as JAX's ``jax.eval_shape`` table gives them, with no
    kernel launch."""
    kw = {"padded": {}, "paged": dict(kv_block=4),
          "prefix": dict(kv_block=4, prefix_cache=True)}[layout]
    lm_kw = dict(MODEL, num_layers=2)
    jlm = jbuild(config=JConfig(batch_size=2), **lm_kw)
    jsex = jserving.ServingExecutor(jlm, max_batch=2, max_seq=32,
                                    buckets=(8, 32), **kw)
    want = jsex.abstract_programs(decode_steps=4, speculate=speculate)
    tlm = tbuild(config=TConfig(batch_size=2), **lm_kw)
    tsex = tserving.ServingExecutor(tlm, max_batch=2, max_seq=32,
                                    buckets=(8, 32), device="meta", **kw)
    before = [k.launches for k in kernels.KERNELS]
    got = tsex.abstract_programs(decode_steps=4, speculate=speculate)
    assert [k.launches for k in kernels.KERNELS] == before
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        if isinstance(t, dict):
            assert sorted(t) == sorted(want[name])
            for k, v in t.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[name][k].shape)
                assert str(v.dtype).replace("torch.", "") == \
                    str(want[name][k].dtype)
        else:
            assert tuple(t.shape) == tuple(want[name].shape)
    assert tuple(got["decode"].shape) == (4, 2)


def test_dry_run_app_prints_the_table(capsys):
    assert tserve.main(["--vocab", "64", "--d-model", "32", "--heads", "2",
                        "--layers", "1", "--max-seq", "16", "--max-batch",
                        "2", "--decode-steps", "4", "--speculate", "2",
                        "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "DRY RUN OK" in out and "decode k=4" in out and "spec d=2" in out
    assert "cache blk0_attn" in out and "prefill L=" in out


# -- the app's --journal -------------------------------------------------------


def test_serve_app_journal(capsys, tmp_path):
    """``--journal``: a second run on a finished journal restores every
    request without a prefill and prints the same results."""
    path = str(tmp_path / "serve.jsonl")
    argv = ["--vocab", "64", "--d-model", "32", "--heads", "2", "--layers",
            "2", "--max-seq", "16", "--max-batch", "2", "--buckets", "8,16",
            "--requests", "3", "--prompt-len", "3:6", "--max-new", "5",
            "--decode-steps", "4", "--seed", "1", "--journal", path]
    first, second = {}, {}
    assert tserve.main(argv, device="cpu", stats_out=first) == 0
    assert tserve.main(argv, device="cpu", stats_out=second) == 0
    out = capsys.readouterr().out
    assert "drained:" not in out
    assert first["prefills"] == 3 and second["prefills"] == 0
    assert first["drained"] is False and second["drained"] is False
    assert {r: v.tokens for r, v in second["results"].items()} == \
        {r: v.tokens for r, v in first["results"].items()}
    assert tjournal.RequestJournal(path).replay().completed.keys() == {0, 1, 2}
