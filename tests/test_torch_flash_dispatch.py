"""The port's flash dispatcher and streamed kernels on the CPU, held
against the JAX package.

On a CPU tensor ``kernels.flash_attention_lse_streamed`` (K1s forward,
K1sb backward) runs its plain versions, the ones K1f/K1b share; the
JAX side runs ``pallas_kernels.flash_attention_lse_streamed`` and the
other Pallas forms in interpret mode, as ``tests/test_pallas.py`` does.
The plain-torch formulations around the kernels (``merge_lse``, the
chunked and blocked forms) and the dispatcher's routing are pinned the
same way, then the slice as a whole: an Adam step and a 3-step app run
of a small LM with ``FF_FLASH_STREAMED`` on in both packages.

Tolerances: f32 within 1e-5 (``TOL``, the K1f/K1b tests' bar); the
bf16 forward element by element as its test states, bf16 lse within
1e-4; the LM step with ``test_torch_training.py``'s bars.  The CUDA kernels
are held against the same plain versions on the card by chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import optim as joptim
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.ops import pallas_kernels as pk
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_torch import optim as toptim
from flexflow_torch.apps import transformer as tapp
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.data.loader import synthetic_host_batch
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.ops import attention as tattn
from flexflow_torch.ops import kernels
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.weights import params_from_numpy

TOL = 1e-5


def _arrays(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


SHAPE = (1, 2, 256, 64)


# ---------------------------------------------------------------------------
# K1s / K1sb against JAX's streamed form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_streamed_forward_matches_jax_streamed(causal):
    q, k, v = _arrays(1 + int(causal), SHAPE, SHAPE, SHAPE)
    o_j, lse_j = pk.flash_attention_lse_streamed(
        *(jnp.asarray(a) for a in (q, k, v)), causal, block_q=64, block_k=64)
    before = kernels.flash_attention_lse_streamed.launches
    o_t, lse_t = kernels.flash_attention_lse_streamed(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    assert kernels.flash_attention_lse_streamed.launches == before  # plain
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=0)


def test_streamed_forward_bf16_matches_jax_streamed():
    """bf16: JAX's streamed kernel rounds ``p`` to bf16 against its running
    row maximum (64-key blocks), the plain version against the row's
    final maximum, so a term may move by 2^-8 of itself before the sum;
    each element of ``o`` is held within ``2^-7 |o| + 2^-8 mass``, mass =
    the f32 attention over ``|v|`` (chip_smoke.py's ``TOL_ELEM`` for
    K1f)."""
    q, k, v = _arrays(3, SHAPE, SHAPE, SHAPE)
    o_j, lse_j = pk.flash_attention_lse_streamed(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), True,
        block_q=64, block_k=64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o_t, lse_t = kernels.flash_attention_lse_streamed(tq, tk, tv, True)
    assert o_t.dtype == torch.bfloat16
    mass = kernels.flash_attention_lse_plain(tq.float(), tk.float(),
                                             tv.float().abs(), True)[0]
    want = np.asarray(o_j.astype(jnp.float32))
    err = np.abs(o_t.float().numpy() - want)
    assert np.all(err <= 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * mass.numpy())
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_streamed_backward_matches_jax_streamed(causal):
    """The Function's backward (K1sb's plain version on the CPU) against
    ``jax.vjp`` of JAX's streamed form, cotangents on ``o`` and ``lse``."""
    q, k, v, g_o = _arrays(4 + int(causal), SHAPE, SHAPE, SHAPE, SHAPE)
    (g_lse,) = _arrays(6, SHAPE[:3])
    _, vjp = jax.vjp(
        lambda a, b, c: pk.flash_attention_lse_streamed(a, b, c, causal,
                                                        None, 64, 64),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = kernels.flash_attention_lse_streamed_bwd.launches
    o, lse = kernels.flash_attention_lse_streamed(tq, tk, tv, causal)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(
        (o * torch.from_numpy(g_o)).sum() + (lse * torch.from_numpy(g_lse)).sum(),
        (tq, tk, tv))
    assert kernels.flash_attention_lse_streamed_bwd.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_streamed_kernels_never_fall_back(which):
    """Meta tensors (an unsupported device) are refused, not computed by
    the plain versions."""
    x = torch.empty((1, 2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        if which == "fwd":
            kernels.flash_attention_lse_streamed(x, x, x, True)
        else:
            lse = torch.empty((1, 2, 16), device="meta")
            kernels.flash_attention_lse_streamed_bwd(x, x, x, x, lse, x)


def test_stream_gate():
    ok = kernels.flash_stream_supported
    for hd in (32, 64, 128):
        assert ok((4, 8, 8192, hd), torch.bfloat16)
        assert ok((1, 8, 1, hd), torch.float32)
    assert not ok((1, 1, 64, 16), torch.float32)        # head dim
    assert not ok((1, 1, 64, 64), torch.float16)        # dtype
    assert not ok((65536, 1, 64, 64), torch.float32)    # b * h
    assert not ok((1, 64, 64), torch.float32)


@pytest.mark.parametrize("shape, dtype, limit", [
    ((1, 1, 64 * 65535 + 1, 64), torch.bfloat16, "65535 64-row tiles"),
    ((1, 1, 64 * 65535, 64), torch.bfloat16, None),
    ((1, 1, 64 * 65535 + 1, 64), torch.float32, None),
    ((512, 64, 65536, 32), torch.bfloat16, "2\\^31"),
    ((512, 64, 65536, 32), torch.float32, None)])
def test_streamed_backward_refuses_k1b_limits(shape, dtype, limit):
    """The streamed gate takes any t, but the bf16 streamed backward
    launches K1b's wgmma pair: its check names the pair's limit that
    refuses, the one K1f/K1b's own gate applies.  (The f32 streamed
    forward, on ``csrc/flash_stream.cu``, takes every such shape.)"""
    q = torch.empty(shape, dtype=dtype, device="meta")
    if dtype == torch.float32:
        kernels._stream_check("fwd", q)
    assert kernels.flash_stream_supported(shape, dtype)
    if limit is None:
        kernels._stream_check("bwd", q, backward=True)
    else:
        with pytest.raises(ValueError, match=limit):
            kernels._stream_check("bwd", q, backward=True)
    assert kernels.flash_supported(shape, dtype) == (
        kernels._k1b_limit(shape, dtype) is None)


@pytest.mark.parametrize("shape, dtype, limit", [
    ((1, 1, 64 * 65535 + 1, 64), torch.bfloat16, "65535 64-row tiles"),
    ((1, 1, 64 * 65535, 64), torch.bfloat16, None),
    ((1, 1, 64 * 65535 + 1, 64), torch.float32, None),
    ((512, 64, 65536, 32), torch.bfloat16, "2\\^31"),
    ((512, 64, 65536, 32), torch.float32, None)])
def test_streamed_forward_refuses_k1f_limits(shape, dtype, limit):
    """The bf16 streamed forward launches K1f's wgmma kernel: a shape the
    streamed gate takes but that kernel cannot (more than 65535 64-row
    tiles, or b h t rows past its tensor maps' 2^31) is refused before any
    launch, naming the limit; the f32 forward keeps the streamed gate."""
    q = torch.empty(shape, dtype=dtype, device="meta")
    assert kernels.flash_stream_supported(shape, dtype)
    if limit is None:
        kernels._stream_check("fwd", q)
    else:
        with pytest.raises(ValueError, match="K1f's wgmma kernel.*" + limit):
            kernels._stream_check("fwd", q)


@pytest.mark.parametrize("streamed, dtype, entry", [
    (True, torch.bfloat16, ("flash_fwd", "ff_flash_fwd")),
    (True, torch.float32, ("flash_stream", "ff_flash_stream_fwd")),
    (False, torch.bfloat16, ("flash_fwd", "ff_flash_fwd")),
    (False, torch.float32, ("flash_fwd", "ff_flash_fwd"))])
def test_forward_entry(streamed, dtype, entry):
    """The bf16 streamed forward (K1s) launches K1f's wgmma kernel; the f32
    one keeps the FMA kernel of ``csrc/flash_stream.cu``."""
    assert kernels.fwd_entry(streamed, dtype) == entry


@pytest.mark.parametrize("streamed, dtype, entry", [
    (True, torch.bfloat16, ("flash_bwd", "ff_flash_bwd")),
    (True, torch.float32, ("flash_stream", "ff_flash_stream_bwd")),
    (False, torch.bfloat16, ("flash_bwd", "ff_flash_bwd")),
    (False, torch.float32, ("flash_bwd", "ff_flash_bwd"))])
def test_backward_entry(streamed, dtype, entry):
    """The bf16 streamed backward (K1sb) launches K1b's wgmma pair; the f32
    one keeps the FMA passes of ``csrc/flash_stream.cu``."""
    assert kernels.bwd_entry(streamed, dtype) == entry


def test_flash_stream_keeps_only_the_f32_backward():
    """``csrc/flash_stream.cu``'s backward passes take f32 operands only
    and its C entry refuses any other dtype: no bf16 mma.sync K1sb."""
    with open(f"{kernels._SRC_DIR}/flash_stream.cu") as fh:
        src = fh.read()
    assert "stream_dq_kernel(const float* __restrict__ q," in src
    assert "stream_dkv_kernel(const float* __restrict__ q," in src
    entry = src.split('extern "C" int ff_flash_stream_bwd(', 1)[1]
    assert "if (dtype != ff::kFloat32) return (int)cudaErrorInvalidValue;" \
        in entry.split("}", 1)[0]


def test_flash_stream_keeps_only_the_f32_forward():
    """``csrc/flash_stream.cu``'s forward takes f32 operands only and its
    C entry refuses any other dtype: no bf16 mma.sync K1s, and nothing of
    the file is instantiated for bf16."""
    with open(f"{kernels._SRC_DIR}/flash_stream.cu") as fh:
        src = fh.read()
    assert "stream_fwd_kernel(const float* __restrict__ q," in src
    entry = src.split('extern "C" int ff_flash_stream_fwd(', 1)[1]
    assert "if (dtype != ff::kFloat32) return (int)cudaErrorInvalidValue;" \
        in entry.split("}", 1)[0]
    attrs = src.split('extern "C" int ff_flash_stream_attrs(', 1)[1]
    assert "dtype != ff::kFloat32" in attrs.split("}", 1)[0]
    code = re.sub(r"//[^\n]*", "", src)
    assert "__nv_bfloat16" not in code and "mma_bf16" not in code


def test_k1f_mutant_is_held_through_the_streamed_entry():
    """A dropped key tile in K1f must fail through K1s too, which launches
    it in bf16, at both long-context shapes."""
    from flexflow_torch.tools import stream_numerics as sn

    assert [(n, m[1]) for n, m in sn.MUTANTS.items()
            if m[0] == "flash_fwd.cu"] == [
        ("k1f-drops-key-tile", "k1f"), ("v2-edge-128-key-columns", "v2")]
    streamed = [c for c in sn.MUTANT_CASES["k1f"] if c[2] == "stream"]
    assert streamed == [((4, 8, 8192, 64), "bfloat16", "stream"),
                        ((1, 8, 32768, 64), "bfloat16", "stream")]


def test_stream_mutants_each_match_the_source_once():
    """The planted faults of ``tools/stream_numerics.py`` still find the
    lines they replace in ``csrc/flash_stream.cu`` (the f32 K1sb's now),
    held at f32 cases through the streamed entry; the faults in K1b's
    wgmma pair are also held through the streamed entry in bf16, which
    launches that pair."""
    from flexflow_torch.tools import stream_numerics as sn

    with open(f"{kernels._SRC_DIR}/flash_stream.cu") as fh:
        src = fh.read()
    stream = {name: reps for name, (source, group, reps)
              in sn.MUTANTS.items() if source == "flash_stream.cu"}
    assert len(stream) == 3
    for name, reps in stream.items():
        assert sn.MUTANTS[name][1] == "stream"
        for old, new in reps:
            assert src.count(old) == 1, (name, old)
            assert old != new
    assert {case[1:] for case in sn.MUTANT_CASES["stream"]} == {
        ("float32", "stream")}
    wgmma = [m[1] for m in sn.MUTANTS.values() if m[0] == "flash_bwd.cu"]
    assert wgmma == ["k1b"] * 3 + ["b2"]  # b2: the race's, on K1b's pair
    assert ((4, 8, 8192, 64), "bfloat16", "stream") in sn.MUTANT_CASES["k1b"]


@pytest.mark.parametrize("causal", [True, False])
def test_stream_numerics_reference_matches_the_plain_backward(causal):
    """The f64 backward ``tools/stream_numerics.py`` holds the kernels
    against is the plain backward's function: in f32 (no bf16 casts) the
    two agree within ``TOL`` of the largest gradient."""
    from flexflow_torch.tools.stream_numerics import _reference

    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        17 + int(causal), (1, 2, 100, 32), (1, 2, 100, 32), (1, 2, 100, 32),
        (1, 2, 100, 32)))
    g_lse = torch.from_numpy(_arrays(19, (1, 2, 100))[0])
    o, lse = kernels.flash_attention_lse_plain(q, k, v, causal)
    want = kernels.flash_attention_lse_bwd_plain(q, k, v, o, lse, do, g_lse,
                                                 causal)
    got = _reference(q, k, v, o, lse, do, g_lse, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * float(w.abs().max()))


# ---------------------------------------------------------------------------
# the plain-torch formulations around the kernels
# ---------------------------------------------------------------------------


def test_merge_lse_matches_jax_including_an_empty_partial():
    o1, o2 = _arrays(7, (2, 3, 5, 4), (2, 3, 5, 4))
    l1, l2 = _arrays(8, (2, 3, 5), (2, 3, 5))
    l2[0, 1, :] = -1e30   # an empty partial: its weight is 0
    l1[1, 2, 3] = -1e30
    want = pk.merge_lse(*(jnp.asarray(a) for a in (o1, l1, o2, l2)))
    got = kernels.merge_lse(*(torch.from_numpy(a) for a in (o1, l1, o2, l2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[0][0, 1].numpy(), o1[0, 1])


def _fwd_and_grads(fn, q, k, v, g_o, g_lse):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = fn(tq, tk, tv)
    grads = torch.autograd.grad(
        (o * torch.from_numpy(g_o)).sum() + (lse * torch.from_numpy(g_lse)).sum(),
        (tq, tk, tv))
    return [o.detach(), lse.detach(), *grads]


def _jax_fwd_and_grads(fn, q, k, v, g_o, g_lse):
    (o, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [o, lse, *vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))]


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_matches_jax(causal):
    """t = 256 in chunks of 64: outputs and gradients (through K1f's
    Function and the merges) against JAX's chunked form."""
    q, k, v, g_o = _arrays(9 + int(causal), SHAPE, SHAPE, SHAPE, SHAPE)
    (g_lse,) = _arrays(11, SHAPE[:3])
    want = _jax_fwd_and_grads(
        lambda a, b, c: pk.flash_attention_lse_chunked(a, b, c, causal,
                                                       chunk=64),
        q, k, v, g_o, g_lse)
    got = _fwd_and_grads(
        lambda a, b, c: kernels.flash_attention_lse_chunked(a, b, c, causal,
                                                            chunk=64),
        q, k, v, g_o, g_lse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="chunk"):
        kernels.flash_attention_lse_chunked(*(torch.from_numpy(a)
                                              for a in (q, k, v)), causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [96, 100])
def test_blocked_matches_jax(t, causal):
    """Blocks of 32 over t = 96 and the ragged 100 (tails padded and
    masked): outputs and gradients against JAX's blocked form."""
    shape = (1, 2, t, 16)
    q, k, v, g_o = _arrays(12 + t, shape, shape, shape, shape)
    (g_lse,) = _arrays(13, shape[:3])
    want = _jax_fwd_and_grads(
        lambda a, b, c: pk.attention_lse_blocked(a, b, c, causal, 32, 32),
        q, k, v, g_o, g_lse)
    got = _fwd_and_grads(
        lambda a, b, c: kernels.attention_lse_blocked(a, b, c, causal, 32, 32),
        q, k, v, g_o, g_lse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the routing table
# ---------------------------------------------------------------------------


def _sentinels(monkeypatch):
    """Replace each formulation the dispatcher can take with a recorder."""
    calls = []
    for name in ("flash_attention_lse_streamed", "flash_attention_lse",
                 "flash_attention_lse_chunked", "attention_lse_blocked"):
        real = getattr(kernels, name)

        def sentinel(q, *a, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(q, *a, **kw)

        monkeypatch.setattr(kernels, name, sentinel)
    return calls


@pytest.mark.parametrize("streamed,force,shape,route", [
    (True, 0, (1, 2, 256, 64), "flash_attention_lse_streamed"),
    (True, 0, (1, 2, 100, 32), "flash_attention_lse_streamed"),  # ragged t
    (False, 0, (1, 2, 256, 64), "flash_attention_lse"),
    (True, 0, (1, 2, 64, 16), "flash_attention_lse"),  # hd outside K1s's gate
    (False, 0, (1, 2, 5, 8), "flash_attention_lse"),   # t < 16: no einsum branch
    (False, 64, (1, 2, 256, 64), "flash_attention_lse_chunked"),
    (False, 64, (1, 2, 100, 64), "flash_attention_lse"),  # 64 does not divide t
    (False, 0, (1, 1, 4096, 136), "attention_lse_blocked"),
    (False, 0, (1, 2, 16, 4), None),
])
def test_dispatch_routes(monkeypatch, streamed, force, shape, route):
    calls = _sentinels(monkeypatch)
    monkeypatch.setattr(kernels, "_STREAMED", streamed)
    monkeypatch.setattr(kernels, "_FORCE_CHUNK", force)
    q = torch.zeros(shape)
    res = kernels.flash_attention_lse_auto(q, q, q, True)
    if route is None:
        assert res is None and calls == []
        return
    assert calls[0] == route
    assert res[0].shape == shape and res[1].shape == shape[:3]


def test_dense_attention_without_a_kernel_takes_the_einsum(monkeypatch):
    """hd = 4: the dispatcher returns None and ``_attend_dense`` runs the
    einsum, as JAX's ``_attend_dense`` does."""
    seen = []
    real = tattn._einsum_attention

    def einsum(q, k, v, causal):
        seen.append(q.shape)
        return real(q, k, v, causal)

    monkeypatch.setattr(tattn, "_einsum_attention", einsum)
    lm = tbuild(batch_size=1, seq_len=16, vocab_size=32, d_model=8,
                num_heads=2, num_layers=1, config=TConfig(batch_size=1))
    mha = next(op for op in lm.layers
               if isinstance(op, tattn.MultiHeadAttention))
    x = torch.from_numpy(_arrays(14, (1, 16, 8))[0])
    y = mha._attend_dense(x, x, x, torch.float32)
    assert seen == [(1, 2, 16, 4)] and y.shape == (1, 16, 8)


@pytest.mark.parametrize("t,hd", [(64, 4), (4096, 136)])
def test_unkernelled_head_dims_do_not_raise_off_the_cpu(t, hd):
    """A head dim no Hopper kernel takes, on a tensor off the CPU (meta
    stands in for CUDA): before the dispatcher, the dense path went to
    K1f's wrapper and raised in ``_check_cuda``; now it takes JAX's route,
    the einsum below t = 4096 and the blocked form from there."""
    q = torch.empty((1, 1, t, hd), device="meta")
    assert not kernels.flash_supported(q.shape, q.dtype)
    with pytest.raises(ValueError):   # K1f's wrapper refuses it
        kernels.flash_attention_lse(q, q, q, True)
    mha = tattn.MultiHeadAttention.__new__(tattn.MultiHeadAttention)
    mha.attrs = dict(num_heads=1, causal=True)
    x = torch.empty((1, t, hd), device="meta")
    y = mha._attend_dense(x, x, x, torch.float32)
    assert y.shape == (1, t, hd) and y.device.type == "meta"


# ---------------------------------------------------------------------------
# the padded decode's route around K6's gate (queue 3's decode fault)
# ---------------------------------------------------------------------------


_K6, _EINSUM_DECODE = kernels.flash_decode, tattn._einsum_decode


def _decode_route(monkeypatch, hd, decode_kernel=None, dtype=torch.float32):
    """``_decode_attend`` on meta tensors (the card's stand-in): which of
    K6's wrapper and the einsum it reached, recorded before any launch."""
    seen = []
    real_k6, real_einsum = _K6, _EINSUM_DECODE

    def k6(*a):
        seen.append("k6")
        return real_k6(*a)

    def einsum(*a):
        seen.append("einsum")
        return real_einsum(*a)

    monkeypatch.setattr(kernels, "flash_decode", k6)
    monkeypatch.setattr(tattn, "_einsum_decode", einsum)
    mha = tattn.MultiHeadAttention.__new__(tattn.MultiHeadAttention)
    mha.decode_kernel = decode_kernel
    B, S, h = 2, 16, 2
    q = torch.empty((B, h, hd), dtype=dtype, device="meta")
    ck = torch.empty((B, S, h, hd), dtype=dtype, device="meta")
    pos = torch.zeros((B,), dtype=torch.int32, device="meta")
    before = real_k6.launches
    with kernels.shapes_only():   # K6 takes meta: gate checked, no launch
        out = mha._decode_attend(q, ck, ck, pos)
    assert out.shape == (B, h, hd) and real_k6.launches == before
    return seen


@pytest.mark.parametrize("hd,route", [(4, "einsum"), (12, "einsum"),
                                      (64, "k6"), (256, "einsum")])
def test_decode_routes_around_k6s_gate(monkeypatch, hd, route):
    """``decode_kernel=None`` takes K6 where its gate holds (hd a multiple
    of 8 in [8, 128]) and the einsum elsewhere, as JAX's
    ``_decode_attend`` asks ``flash_decode_supported``; before, hd 4, 12
    and 256 went to K6's wrapper and raised on the card."""
    shape = (2, 16, 2, hd)
    assert kernels.flash_decode_supported(shape, torch.float32) == \
        (route == "k6")
    assert kernels.flash_decode_supported(shape, torch.bfloat16) == \
        (route == "k6")
    assert _decode_route(monkeypatch, hd) == [route]
    # JAX's gate takes hd >= 8: hd 12 and 256 differ by design.
    assert pk.flash_decode_supported(shape, jnp.float32) == (hd >= 8)


def test_decode_kernel_true_and_false(monkeypatch):
    """True launches K6 (and so raises outside its gate on the card);
    False is the einsum at any head dim; a dtype K6 is not built for
    takes the einsum under None.  Outside the dry run's mode a meta
    tensor is no card, and K6's wrapper refuses it."""
    with pytest.raises(ValueError, match="head dim 12"):
        _decode_route(monkeypatch, 12, decode_kernel=True)
    q = torch.empty((2, 2, 64), device="meta")
    c = torch.empty((2, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        kernels.flash_decode(q, c, c, torch.ones((2,), dtype=torch.int32,
                                                 device="meta"))
    assert _decode_route(monkeypatch, 64, decode_kernel=False) == ["einsum"]
    assert _decode_route(monkeypatch, 64, dtype=torch.float16) == ["einsum"]
    assert not kernels.flash_decode_supported((16, 2, 64), torch.float32)


@pytest.mark.parametrize("d_model,heads", [(8, 2), (24, 2)])
def test_decode_logits_at_unkernelled_head_dims_match_jax(d_model, heads):
    """The LM at hd 4 and hd 12: a prefill of 6 tokens and 10 decode
    steps fed the true next tokens, logits within
    ``tests/test_torch_serving.py``'s ``DECODE_TOL`` (1e-4) of JAX's
    (hd 4 on JAX's einsum, hd 12 on its Pallas kernel in interpret
    mode)."""
    from flexflow_tpu.runtime import serving as jserving
    from flexflow_torch.runtime import serving as tserving

    V_, S_, prefix = 64, 16, 6
    kw = dict(batch_size=2, seq_len=S_, vocab_size=V_, d_model=d_model,
              num_heads=heads, num_layers=2)
    jlm = jbuild(config=JConfig(batch_size=2), **kw)
    jsex = jserving.ServingExecutor(jlm, max_batch=2, max_seq=S_, buckets=(8,))
    jparams, _ = jsex.init(seed=0)
    tlm = tbuild(config=TConfig(batch_size=2), **kw)
    tsex = tserving.ServingExecutor(tlm, max_batch=2, max_seq=S_, buckets=(8,),
                                    device="cpu")
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(4).integers(0, V_, size=S_).astype(np.int32)

    def run(sex, params):
        padded = np.zeros((1, 8), np.int32)
        padded[0, :prefix] = toks[:prefix]
        rows, tok0, _ok = sex.build_prefill(8)(params, {}, padded,
                                               np.int32(prefix))
        caches = sex.install(sex.init_cache(), rows, 0)
        dec = sex.build_decode_superstep(1, return_logits=True)
        pos, out = np.array([prefix, 0], np.int32), []
        for t in range(prefix, S_):
            caches, pos_d, _t, (_n, okf, logits) = dec(
                params, {}, caches, pos, np.array([toks[t], 0], np.int32))
            assert bool(np.asarray(okf)[0, 0])
            out.append(np.asarray(logits)[0, 0])
            pos = np.asarray(pos_d)
        return int(tok0), np.stack(out)

    jtok, jlog = run(jsex, jparams)
    ttok, tlog = run(tsex, tparams)
    assert ttok == jtok
    assert float(np.max(np.abs(tlog - jlog))) <= 1e-4


# ---------------------------------------------------------------------------
# the slice as a whole: the LM with the streamed dispatch on
# ---------------------------------------------------------------------------

V, D, H, L, B, S = 512, 64, 2, 2, 2, 32   # hd 32: inside both streamed gates
LR = 1e-3


def _lm_kw():
    return dict(batch_size=B, seq_len=S, vocab_size=V, d_model=D,
                num_heads=H, num_layers=L)


@pytest.fixture
def streamed_on(monkeypatch):
    """The flag on in both packages, and recorders of each streamed call."""
    monkeypatch.setattr(pk, "_STREAMED", True)
    monkeypatch.setattr(kernels, "_STREAMED", True)
    seen = {"jax": 0, "torch": 0}
    jreal, treal = pk.flash_attention_lse_streamed, \
        kernels.flash_attention_lse_streamed

    def jsent(*a, **kw):
        seen["jax"] += 1
        return jreal(*a, **kw)

    def tsent(*a, **kw):
        seen["torch"] += 1
        return treal(*a, **kw)

    monkeypatch.setattr(pk, "flash_attention_lse_streamed", jsent)
    monkeypatch.setattr(kernels, "flash_attention_lse_streamed", tsent)
    return seen


def test_streamed_adam_step_matches_jax(streamed_on):
    """One Adam step of a 2-layer LM, both packages on their streamed
    forms: loss within 1e-5, every gradient within 1e-5 of its tensor's
    largest magnitude plus 1e-7, the updated parameters within 1e-3 lr
    where |g| is not rounding noise and 2 lr elsewhere (the bars of
    ``test_torch_training.py``)."""
    jlm = jbuild(config=JConfig(batch_size=B, seed=0), **_lm_kw())
    jex = JExecutor(jlm, config=jlm.config,
                    optimizer=joptim.AdamOptimizer(lr=LR),
                    devices=jax.devices()[:1])
    params, _, state = jax.device_get(jex.init(seed=0))
    tlm = tbuild(config=TConfig(batch_size=B, seed=0), **_lm_kw())
    batch = synthetic_host_batch(tlm, np.random.default_rng(1),
                                 {"tokens": V, "label": V})
    jb = jex.shard_batch(batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jex._loss_fn, has_aux=True))(params, state, jb)
    jnew, _, _, _ = jex.train_step(jax.tree.map(jnp.asarray, params),
                                   jex.optimizer.init(params), state, jb)
    jgrads, jnew = jax.device_get(jgrads), jax.device_get(jnew)
    assert streamed_on["jax"] >= L

    tex = TExecutor(tlm, config=tlm.config,
                    optimizer=toptim.AdamOptimizer(lr=LR), device="cpu")
    loss, _, _, grads = tex.loss_and_grads(params_from_numpy(params, "cpu"),
                                           {}, batch)
    assert streamed_on["torch"] == L
    assert abs(float(loss) - float(jloss)) <= 1e-5
    for op, group in jgrads.items():
        for k, want in group.items():
            got = grads[op][k].numpy()
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= 1e-5 * scale + 1e-7, \
                (op, k)
    tp = params_from_numpy(params, "cpu")
    tp, _, _, _ = tex.train_step(tp, tex.optimizer.init(tp), {}, batch)
    for op, group in jnew.items():
        for k, want in group.items():
            g = np.abs(jgrads[op][k])
            big = g >= max(1e-4 * g.max(), 1e-6)
            diff = np.abs(tp[op][k].detach().numpy() - want)
            assert diff[big].max(initial=0.0) <= 1e-3 * LR, (op, k)
            assert diff.max() <= 2 * LR, (op, k)


def test_streamed_app_on_cpu(streamed_on):
    stats = {}
    argv = ["-b", "2", "--seq", "64", "--layers", "2", "--vocab", "128",
            "--d-model", "64", "--heads", "2", "--optimizer", "adam", "--lr",
            "1e-2", "-i", "3", "--seed", "3"]
    assert tapp.main(argv, device="cpu", stats_out=stats) == 0
    losses = stats["step_losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert streamed_on["torch"] == 2 * 4   # every layer of every step
