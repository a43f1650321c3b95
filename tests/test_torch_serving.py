"""The port's serving slice as a whole, held against the JAX package.

The JAX ``ServingExecutor.init(seed=0)`` parameters are carried into
the port with ``params_from_numpy`` (nothing transposed); both packages
then serve the same tokens on the CPU.  Bars, in f32:

- the full-sequence forward agrees with JAX's within ``DECODE_TOL``;
- per-step decode logits agree with the JAX executor's within
  ``DECODE_TOL`` (1e-4, ``tests/test_serving.py``), for a prefill in
  bucket 8 and in bucket 16 (which reaches the Pallas flash forward);
- the port's own decode stays within ``DECODE_TOL`` of its full forward;
- greedy tokens equal the JAX ``Server``'s (``decode_kernel=True``)
  exactly for six synthetic requests.

Also here: the import rule (the port and ``chip_smoke.py`` import no JAX
and nothing of ``flexflow_tpu``), the app's flag surface, and the
device rule (CUDA unless the caller asks for the CPU).
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime import serving as jserving
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_tpu.runtime.trainer import relay_safe_steps as j_relay_safe_steps
from flexflow_torch.apps import serve as tserve
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.runtime import serving as tserving
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.trainer import relay_safe_steps as t_relay_safe_steps
from flexflow_torch.weights import params_from_numpy

V, D, H, L, S = 64, 32, 2, 2, 16
BUCKETS = (8, 16)
DECODE_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model_kw():
    return dict(batch_size=2, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L)


@pytest.fixture(scope="module")
def jax_side():
    lm = jbuild(config=JConfig(batch_size=2), **_model_kw())
    sex = jserving.ServingExecutor(lm, max_batch=2, max_seq=S,
                                   buckets=BUCKETS, decode_kernel=True)
    params, state = sex.init(seed=0)
    return lm, sex, params, state


@pytest.fixture(scope="module")
def torch_side(jax_side):
    _lm, _sex, jparams, _state = jax_side
    lm = tbuild(config=TConfig(batch_size=2), **_model_kw())
    sex = tserving.ServingExecutor(lm, max_batch=2, max_seq=S,
                                   buckets=BUCKETS, device="cpu")
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return lm, sex, params, {}


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, V, size=(1, S)).astype(np.int32)


@pytest.fixture(scope="module")
def full_logits(jax_side, torch_side, tokens):
    jlm = jax_side[0]
    tlm, _tsex, tparams, _ = torch_side
    ex = JExecutor(jlm, config=jlm.config)
    # The training executor's own init (seed 0): the same values the
    # serving init placed on one device, laid out for its mesh.
    jparams, _opt, jstate = ex.init(seed=0)
    _, outs = ex.forward_step(
        jparams, jstate, {"tokens": tokens, "label": np.zeros((1, S), np.int32)})
    touts = TExecutor(tlm, device="cpu").forward_step(tparams, {"tokens": tokens})
    return np.asarray(outs["lm_head:out"]), touts["lm_head:out"].numpy()


def test_params_cross_over_untransposed(jax_side, torch_side):
    jparams = jax.device_get(jax_side[2])
    tparams = torch_side[2]
    assert sorted(jparams) == sorted(tparams)
    for op, group in jparams.items():
        for name, arr in group.items():
            np.testing.assert_array_equal(tparams[op][name].numpy(), arr)


def test_full_forward_matches_jax(full_logits):
    jl, tl = full_logits
    assert tl.shape == jl.shape == (1, S, V)
    assert float(np.max(np.abs(tl - jl))) <= DECODE_TOL


def _decode_logits(sex, params, state, tokens, prefix, bucket):
    """Prefill ``prefix`` tokens into ``bucket``, then decode feeding the
    true next tokens; returns (first token, per-step (V,) logits)."""
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :prefix] = tokens[0, :prefix]
    rows, tok0, ok = sex.build_prefill(bucket)(params, state, padded,
                                               np.int32(prefix))
    assert bool(ok)
    caches = sex.install(sex.init_cache(), rows, 0)
    dec = sex.build_decode_superstep(1, return_logits=True)
    pos = np.array([prefix, 0], np.int32)
    out = []
    for t in range(prefix, S):
        tokv = np.array([tokens[0, t], 0], np.int32)
        caches, pos_d, _t, (_nxt, okf, logits) = dec(params, state, caches,
                                                     pos, tokv)
        assert bool(np.asarray(okf)[0, 0])
        out.append(np.asarray(logits)[0, 0])
        pos = np.asarray(pos_d)
    return int(tok0), np.stack(out)


@pytest.mark.parametrize("prefix,bucket", [(6, 8), (12, 16)])
def test_decode_logits_match_jax(jax_side, torch_side, tokens, full_logits,
                                 prefix, bucket):
    _lm, jsex, jparams, jstate = jax_side
    _tlm, tsex, tparams, tstate = torch_side
    jtok, jlog = _decode_logits(jsex, jparams, jstate, tokens, prefix, bucket)
    ttok, tlog = _decode_logits(tsex, tparams, tstate, tokens, prefix, bucket)
    assert ttok == jtok
    assert float(np.max(np.abs(tlog - jlog))) <= DECODE_TOL
    # The port's own decode against its own full-sequence forward.
    _jl, tl = full_logits
    assert ttok == int(np.argmax(tl[0, prefix - 1]))
    assert float(np.max(np.abs(tlog - tl[0, prefix:]))) <= DECODE_TOL


def test_synthetic_requests_match_jax():
    jr = jserving.synthetic_requests(6, V, prompt_len=(3, 12),
                                     max_new_tokens=7, seed=3)
    tr = tserving.synthetic_requests(6, V, prompt_len=(3, 12),
                                     max_new_tokens=7, seed=3)
    assert [(r.id, r.max_new_tokens) for r in jr] == \
        [(r.id, r.max_new_tokens) for r in tr]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_greedy_tokens_match_jax_server(jax_side, torch_side):
    """Six requests over two slots (admission, eviction, the context
    limit at max_seq 16): every generated token equals JAX's."""
    _lm, jsex, jparams, jstate = jax_side
    _tlm, tsex, tparams, tstate = torch_side
    kw = dict(prompt_len=(3, 12), max_new_tokens=7, seed=3)
    jres, jstats = jserving.Server(jsex, jparams, jstate, decode_steps=4).run(
        jserving.synthetic_requests(6, V, **kw))
    tres, tstats = tserving.Server(tsex, tparams, tstate, decode_steps=4).run(
        tserving.synthetic_requests(6, V, **kw))
    assert sorted(tres) == sorted(jres) == list(range(6))
    for rid in jres:
        assert tres[rid].error is None
        assert tres[rid].tokens == jres[rid].tokens, rid
    for key in ("requests", "completed", "failed", "tokens", "prefills",
                "decode_supersteps", "decode_steps_per_call"):
        assert tstats[key] == jstats[key], key


def test_plain_decode_gives_the_same_tokens(jax_side, torch_side):
    """decode_kernel=False (the einsum decode) and the kernel route
    (its plain version on the CPU) generate the same tokens."""
    _tlm, tsex, tparams, tstate = torch_side
    plain = tserving.ServingExecutor(tsex.model, max_batch=2, max_seq=S,
                                     buckets=BUCKETS, decode_kernel=False,
                                     device="cpu")
    reqs = tserving.synthetic_requests(4, V, prompt_len=(2, 9),
                                       max_new_tokens=9, seed=5)
    a, _ = tserving.Server(tsex, tparams, tstate, decode_steps=3).run(reqs)
    b, _ = tserving.Server(plain, tparams, tstate, decode_steps=3).run(reqs)
    assert {r: a[r].tokens for r in a} == {r: b[r].tokens for r in b}


def test_oversized_prompt_is_rejected_not_served(torch_side):
    _tlm, tsex, tparams, tstate = torch_side
    reqs = [tserving.Request(0, np.arange(S + 1, dtype=np.int32) % V, 4),
            tserving.Request(1, np.array([1, 2, 3], np.int32), 4)]
    res, stats = tserving.Server(tsex, tparams, tstate).run(reqs)
    assert res[0].error and "bucket" in res[0].error
    assert res[1].error is None and len(res[1].tokens) == 4
    assert stats["completed"] == 1 and stats["failed"] == 1


@pytest.mark.parametrize("k", [-3, 0, 1, 8, 20, 21, 100])
def test_decode_steps_clamp_matches_jax(k):
    assert t_relay_safe_steps(k) == j_relay_safe_steps(k)


def test_config_parse_matches_jax():
    argv = ["-b", "32", "--dtype", "bfloat16", "--seed", "7", "-ll:gpu", "2",
            "--lr", "0.5", "--steps-per-call", "4", "--unknown-flag"]
    assert vars(TConfig.parse_args(argv)) == vars(JConfig.parse_args(argv))


_APP_ARGV = ["--vocab", str(V), "--d-model", str(D), "--heads", str(H),
             "--layers", str(L), "--max-seq", str(S), "--max-batch", "2",
             "--buckets", "8,16", "--requests", "3", "--prompt-len", "3:9",
             "--max-new", "5", "--decode-steps", "4", "--seed", "1"]


def test_serve_app_on_cpu(capsys):
    stats = {}
    assert tserve.main(_APP_ARGV, device="cpu", stats_out=stats) == 0
    out = capsys.readouterr().out
    assert "requests = 3 completed = 3 failed = 0" in out
    assert "tokens/s = " in out and "decode supersteps = " in out
    assert stats["tokens"] == 15 and stats["prefills"] == 3


@pytest.mark.parametrize("flag", [["--kv-block", "4"], ["--speculate", "2"],
                                  ["--temperature", "0.7"], ["--telemetry", "d"],
                                  ["--dry-run"], ["--dtype", "float16"]])
def test_serve_app_refuses_unported_flags(flag):
    with pytest.raises(SystemExit):
        tserve.main(_APP_ARGV + flag, device="cpu")


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(_APP_ARGV)
    lm = tbuild(config=TConfig(batch_size=2), **_model_kw())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.ServingExecutor(lm, max_batch=2)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "flexflow_torch")):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_neither_jax_nor_the_jax_package():
    srcs = _port_sources()
    assert len(srcs) > 15
    bad = []
    for path in srcs:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "flexflow_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {n}")
    assert not bad, bad
