"""The port's kernel wrappers on the CPU, held against the JAX kernels.

On a CPU tensor each wrapper in ``flexflow_torch/ops/kernels.py`` runs
its plain PyTorch version; those versions are pinned here against the
Pallas kernels of ``flexflow_tpu/ops/pallas_kernels.py`` run in
interpret mode (as the JAX package's own tests run them on the CPU), on
the same numpy inputs, in f32 within 1e-5.  The CUDA kernels themselves
are held against the same plain versions on the GPU by chip_smoke.py.
"""

import inspect
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops import pallas_kernels
from flexflow_torch.ops import kernels

TOL = 1e-5


def _qkv(seed, shape):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


#: (t, hd) cases of the two plain-vs-Pallas flash tests: hd 16 at three
#: lengths, then the head dims the bf16 CUDA kernels pad to a tile width
#: of 32, 64 or 128 (8, 24, 72) and the widths themselves (64, 128).
FLASH_T_HD = [(16, 16), (32, 16), (64, 16), (16, 8), (16, 24), (16, 64),
              (16, 72), (16, 128)]
FLASH_T_HD_IDS = [str(t) if hd == 16 else f"{t}-hd{hd}"
                  for t, hd in FLASH_T_HD]


def _hd_seed(hd):
    return 0 if hd == 16 else 1000 + hd


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t, hd", FLASH_T_HD, ids=FLASH_T_HD_IDS)
def test_flash_attention_plain_matches_pallas(t, hd, causal):
    q, k, v = _qkv(t + int(causal) + _hd_seed(hd), (2, 2, t, hd))
    o_j, lse_j = pallas_kernels.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    before = kernels.flash_attention_lse.launches
    o_t, lse_t = kernels.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert kernels.flash_attention_lse.launches == before  # plain, no launch
    assert o_t.dtype == torch.float32 and lse_t.shape == (2, 2, t)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("t", [1, 5, 8, 80])
def test_flash_attention_plain_any_length_matches_einsum(t):
    """Lengths the Pallas kernel does not take (t < 16, ragged) against
    the JAX einsum oracle its dense path falls back to."""
    q, k, v = _qkv(100 + t, (1, 2, t, 16))
    want = jattn._einsum_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True)
    got, _ = kernels.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_flash_decode_plain_matches_pallas():
    r = np.random.default_rng(1)
    B, S, h, hd = 4, 32, 2, 16
    q = r.standard_normal((B, h, hd)).astype(np.float32)
    ck = r.standard_normal((B, S, h, hd)).astype(np.float32)
    cv = r.standard_normal((B, S, h, hd)).astype(np.float32)
    lens = np.array([1, 7, 32, 17], np.int32)
    want = pallas_kernels.flash_decode(jnp.asarray(q), jnp.asarray(ck),
                                       jnp.asarray(cv), jnp.asarray(lens))
    before = kernels.flash_decode.launches
    got = kernels.flash_decode(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), torch.from_numpy(lens))
    assert kernels.flash_decode.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def _bf16_agree(got: torch.Tensor, want) -> None:
    """bf16 outputs of the same cast points: equal but for rare one-ulp
    flips where the two f32 sums round across a bf16 boundary.  (Leaving
    out the cast of p to bf16 before P.V flips a quarter or more.)"""
    a = got.float().numpy()
    b = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert np.abs(a - b).max() <= 2.0 ** -7
    assert (a != b).mean() < 0.05


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_bf16_matches_pallas(causal):
    q, k, v = _qkv(3, (2, 2, 64, 16))
    o_j, lse_j = pallas_kernels.flash_attention_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal)
    o_t, lse_t = kernels.flash_attention_lse(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal)
    _bf16_agree(o_t, o_j)
    assert lse_t.dtype == torch.float32
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4,
                               rtol=0)


def test_flash_decode_plain_bf16_matches_pallas():
    r = np.random.default_rng(4)
    arrays = [r.standard_normal(s).astype(np.float32)
              for s in ((4, 2, 16), (4, 32, 2, 16), (4, 32, 2, 16))]
    lens = np.array([1, 7, 32, 17], np.int32)
    want = pallas_kernels.flash_decode(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), jnp.asarray(lens))
    got = kernels.flash_decode(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrays),
        torch.from_numpy(lens))
    _bf16_agree(got, want)


def _decode_arrays(seed, B=4, S=64, h=2, hd=16):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, h, hd), (B, S, h, hd), (B, S, h, hd))]


#: Slots of length 1 and S = 64, and two between.
DECODE_LENS = np.array([1, 7, 64, 33], np.int32)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_flash_decode_split_plain_matches_pallas(splits):
    """K6's split-K formulation (per-chunk partials, merged in chunk
    order) computes the Pallas decode's function: f32 within ``TOL``, at
    1, 2, 3 and S / 8 chunks (a slot of one key leaves every chunk but
    the first empty)."""
    q, ck, cv = _decode_arrays(5)
    want = pallas_kernels.flash_decode(jnp.asarray(q), jnp.asarray(ck),
                                       jnp.asarray(cv), jnp.asarray(DECODE_LENS))
    got = kernels.flash_decode_split_plain(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(DECODE_LENS), splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_flash_decode_split_plain_bf16_matches_pallas(splits):
    """bf16: each chunk rounds p against its own maximum, the Pallas
    kernel against its running maximum (here one 64-key block: the row's
    maximum), so a term may move by 2^-8 of itself before the f32 sums:
    each element within ``2^-7 |o| + 2^-8 mass``, mass the f32 decode over
    ``|v|`` (``chip_smoke.py``'s rule for K6 on the card), and never more
    than one bf16 ulp of 1 apart.  With one chunk the rounding points are
    the same, and the two agree as the one-pass plain version does."""
    arrays = _decode_arrays(6)
    want = pallas_kernels.flash_decode(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays),
        jnp.asarray(DECODE_LENS))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    lens = torch.from_numpy(DECODE_LENS)
    got = kernels.flash_decode_split_plain(tq, tk, tv, lens, splits)
    if splits == 1:
        _bf16_agree(got, want)
    mass = kernels.flash_decode_plain(tq.float(), tk.float(),
                                      tv.float().abs(), lens).numpy()
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert got.dtype == torch.bfloat16 and err.max() <= 2.0 ** -7
    assert np.all(err <= 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * mass)


@pytest.mark.parametrize("splits", [5, 7, 10, 64])
def test_flash_decode_split_plain_takes_ragged_and_empty_chunks(splits):
    """Chunk lengths that do not divide S (the last chunk short) and chunk
    counts that leave trailing chunks with no key at all agree with the
    one-pass plain version."""
    q, ck, cv = (torch.from_numpy(a) for a in _decode_arrays(7, S=61))
    lens = torch.tensor([61, 1, 30, 59], dtype=torch.int32)
    want = kernels.flash_decode_plain(q, ck, cv, lens)
    got = kernels.flash_decode_split_plain(q, ck, cv, lens, splits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape, splits", [
    ((8, 128, 8), 4),       # the serve shape: 32-key chunks, 256 CTAs
    ((4, 4096, 8), 17),     # a long cache: 241-key chunks, 544 CTAs
    ((1, 4096, 8), 66),
    ((2, 1000, 4), 31),     # 33-key chunks, the last one 10
    ((33, 256, 8), 2),      # B h = 264
    ((66, 64, 8), 1),       # B h = 528: one CTA per (b, head)
    ((1, 32768, 1), 128),   # the most splits
    ((1, 31, 1), 1),        # under two 32-key chunks
    ((2, 8, 2), 1)])
def test_decode_splits(shape, splits):
    """K6's split count comes from (B, S, h) alone: four CTAs per SM of an
    H100 where chunks of 32 keys or more allow it, at most 128 splits,
    and every chunk of ceil(S / splits) keys starting before S."""
    B, S, h = shape
    n = kernels.decode_splits(B, S, h)
    assert n == splits
    chunk = -(-S // n)
    assert (n - 1) * chunk < S and (n == 1 or chunk >= 32)


def _decode_code():
    with open(os.path.join(kernels._SRC_DIR, "flash_decode.cu")) as fh:
        return re.sub(r"//[^\n]*", "", fh.read())


def test_flash_decode_only_atomic_is_the_integer_ticket():
    """K6 merges its splits in a fixed order, so two launches give the
    same bits: its one atomic is the integer ticket of each (b, head),
    and the launch leaves the ticket at 0."""
    code = _decode_code()
    assert re.findall(r"\batomic\w*\([^;]*|\bred\.|\batom\.", code) == [
        "atomicAdd(tickets + bh, 1u)"]
    assert "unsigned int* __restrict__ tickets" in code
    assert "tickets[bh] = 0u;" in code
    assert "__threadfence();" in code


def test_flash_decode_reaches_no_library():
    code = _decode_code().lower()
    for banned in ("cublas", "cudnn", "cutlass", "cute/", "torch/"):
        assert banned not in code, banned


@pytest.mark.parametrize("which", ["fwd", "decode"])
def test_non_cpu_tensors_never_fall_back(which):
    """A tensor off the CPU goes to the kernel or raises: never to the
    plain version (meta tensors stand in for an unsupported device)."""
    if which == "fwd":
        x = torch.empty((1, 2, 16, 16), device="meta")
        with pytest.raises(ValueError, match="needs CUDA"):
            kernels.flash_attention_lse(x, x, x, True)
    else:
        q = torch.empty((2, 2, 16), device="meta")
        c = torch.empty((2, 8, 2, 16), device="meta")
        lens = torch.ones((2,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="needs CUDA"):
            kernels.flash_decode(q, c, c, lens)


def test_library_key_follows_source(tmp_path, monkeypatch):
    """An edited source (or shared header) names a new library, so it
    rebuilds instead of loading a stale one."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels._SRC_DIR, src)
    monkeypatch.setattr(kernels, "_SRC_DIR", str(src))
    first = {n: kernels._lib_path(n) for n in kernels._SOURCES}
    with open(src / "flash_decode.cu", "a") as f:
        f.write("\n// edited\n")
    assert kernels._lib_path("flash_decode") != first["flash_decode"]
    assert kernels._lib_path("flash_fwd") == first["flash_fwd"]
    with open(src / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert kernels._lib_path("flash_fwd") != first["flash_fwd"]


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    assert not any(f.endswith(".so")
                   for f in os.listdir(tmp_path / "build"))


# ---------------------------------------------------------------------------
# K1b: the flash backward, and the autograd Function around K1f/K1b
# ---------------------------------------------------------------------------


def _cotangents(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(shape[:3]).astype(np.float32))


def _jax_flash_vjp(q, k, v, g_o, g_lse, causal, dtype=jnp.float32):
    import jax

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(
        lambda a, b, c: pallas_kernels.flash_attention_lse(a, b, c, causal),
        *args)
    return vjp((jnp.asarray(g_o, dtype), jnp.asarray(g_lse)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t, hd", FLASH_T_HD, ids=FLASH_T_HD_IDS)
def test_flash_backward_plain_matches_pallas(t, hd, causal):
    """K1b's plain version against ``jax.vjp`` of the Pallas kernels
    (interpret mode), with non-zero cotangents of both ``o`` and ``lse``;
    f32 within 1e-5."""
    shape = (2, 2, t, hd)
    assert pallas_kernels.flash_supported(shape, jnp.float32)
    q, k, v = _qkv(200 + t + int(causal) + _hd_seed(hd), shape)
    g_o, g_lse = _cotangents(300 + t + _hd_seed(hd), shape)
    want = _jax_flash_vjp(q, k, v, g_o, g_lse, causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = kernels.flash_attention_lse_plain(tq, tk, tv, causal)
    before = kernels.flash_attention_lse_bwd.launches
    got = kernels.flash_attention_lse_bwd(tq, tk, tv, o, lse,
                                          torch.from_numpy(g_o),
                                          torch.from_numpy(g_lse), causal)
    assert kernels.flash_attention_lse_bwd.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_bf16_matches_pallas(causal):
    """bf16: the same cast points (p and ds rounded to bf16 before their
    products, f32 sums rounded once).  Both sides round f32 sums taken in
    another order, so a gradient may differ by one bf16 ulp at its own
    magnitude; at most 5% of the entries differ."""
    shape = (2, 2, 64, 16)
    assert pallas_kernels.flash_supported(shape, jnp.bfloat16)
    q, k, v = _qkv(7, shape)
    g_o, g_lse = _cotangents(8, shape)
    want = _jax_flash_vjp(q, k, v, g_o, g_lse, causal, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, lse = kernels.flash_attention_lse_plain(tq, tk, tv, causal)
    got = kernels.flash_attention_lse_bwd(
        tq, tk, tv, o, lse, torch.from_numpy(g_o).to(torch.bfloat16),
        torch.from_numpy(g_lse), causal)
    for g, w in zip(got, want):
        a = g.float().numpy()
        b = np.asarray(w.astype(jnp.float32))
        assert g.dtype == torch.bfloat16
        assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-6)
        assert (a != b).mean() < 0.05


@pytest.mark.parametrize("t", [1, 5, 80])
def test_flash_backward_plain_any_length_matches_einsum(t):
    """Lengths the Pallas kernels do not take, against the gradients of
    the JAX einsum oracle (no lse cotangent: the oracle returns ``o``)."""
    import jax

    shape = (1, 2, t, 16)
    q, k, v = _qkv(400 + t, shape)
    g_o, _ = _cotangents(500 + t, shape)
    _, vjp = jax.vjp(lambda a, b, c: jattn._einsum_attention(a, b, c, True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g_o))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = kernels.flash_attention_lse(tq, tk, tv, True)
    got = kernels.flash_attention_lse_bwd(tq, tk, tv, o, lse,
                                          torch.from_numpy(g_o), None, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_flash_attention_is_differentiated_through_its_function():
    """On the CPU, ``flash_attention_lse`` goes through its autograd
    Function, whose backward is the explicit plain K1b formula: the
    gradients equal ``flash_attention_lse_bwd_plain`` bit for bit, and
    agree with torch's autograd through the plain forward within 1e-5."""
    shape = (2, 2, 24, 16)
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(9, shape))
    g_o, g_lse = (torch.from_numpy(a) for a in _cotangents(10, shape))
    o, lse = kernels.flash_attention_lse(q, k, v, True)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    assert lse.grad_fn is o.grad_fn
    got = torch.autograd.grad((o * g_o).sum() + (lse * g_lse).sum(),
                              (q, k, v))
    want = kernels.flash_attention_lse_bwd_plain(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), g_o,
        g_lse, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    po, plse = kernels.flash_attention_lse_plain(q, k, v, True)
    auto = torch.autograd.grad((po * g_o).sum() + (plse * g_lse).sum(),
                               (q, k, v))
    for g, w in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=0)


def test_flash_attention_lse_cotangent_alone():
    """Only ``lse`` used: ``g_o`` is zero and delta is ``-g_lse``."""
    shape = (1, 2, 16, 8)
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(11, shape))
    _, g_lse = _cotangents(12, shape)
    _, lse = kernels.flash_attention_lse(q, k, v, False)
    got = torch.autograd.grad((lse * torch.from_numpy(g_lse)).sum(), (q, k, v))
    want = _jax_flash_vjp(*(x.detach().numpy() for x in (q, k, v)),
                          np.zeros(shape, np.float32), g_lse, False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# K3: the fused softmax cross-entropy
# ---------------------------------------------------------------------------


def _xent_inputs(seed, n=64, v=1024):
    r = np.random.default_rng(seed)
    logits = (3 * r.standard_normal((n, v))).astype(np.float32)
    labels = r.integers(0, v, n).astype(np.int32)
    labels[:3] = (0, v - 1, v // 2)  # the vocabulary's edges and its middle
    return logits, labels


def test_softmax_xent_plain_matches_pallas():
    """K3's plain forward and backward against ``softmax_xent`` and its
    VJP (Pallas, interpret mode) at a shape the JAX gate admits: ``nll``,
    ``lse`` and ``dlogits`` within 1e-5, ``pred`` exactly."""
    import jax

    n, v = 64, 1024
    assert pallas_kernels.xent_supported(n, v)
    logits, labels = _xent_inputs(13, n, v)
    r = np.random.default_rng(14)
    g_nll = r.standard_normal(n).astype(np.float32)
    g_lse = r.standard_normal(n).astype(np.float32)
    (jnll, jlse, jpred), vjp = jax.vjp(
        lambda x: pallas_kernels.softmax_xent(x, jnp.asarray(labels)),
        jnp.asarray(logits))
    (jd,) = vjp((jnp.asarray(g_nll), jnp.asarray(g_lse),
                 np.zeros(n, jax.dtypes.float0)))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    before = (kernels.softmax_xent.launches, kernels.softmax_xent_bwd.launches)
    nll, lse, pred = kernels.softmax_xent(tl, tlab)
    d = kernels.softmax_xent_bwd(tl, tlab, lse, torch.from_numpy(g_nll),
                                 torch.from_numpy(g_lse))
    assert (kernels.softmax_xent.launches,
            kernels.softmax_xent_bwd.launches) == before
    assert pred.dtype == torch.int32
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL, rtol=0)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=TOL, rtol=0)


def test_softmax_xent_pred_breaks_ties_at_the_first_index():
    """Planted equal maxima, inside one vocabulary block and across
    blocks: ``pred`` is the first index, as ``jnp.argmax`` gives and as
    the Pallas kernel's strict '>' across blocks keeps it."""
    n, v = 16, 1024
    logits, labels = _xent_inputs(15, n, v)
    top = logits.max() + 1.0
    ties = {0: (5, 700), 1: (600, 100), 2: (511, 512), 3: (1023, 0),
            4: (7, 9, 1000)}
    for row, cols in ties.items():
        logits[row, list(cols)] = top
    want = np.asarray(pallas_kernels.softmax_xent(jnp.asarray(logits),
                                                  jnp.asarray(labels))[2])
    _, _, pred = kernels.softmax_xent(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_array_equal(pred.numpy(), want)
    np.testing.assert_array_equal(pred.numpy(), logits.argmax(axis=1))
    assert [int(pred[r]) for r in ties] == [min(c) for c in ties.values()]


def test_softmax_xent_is_differentiated_through_its_function():
    """On the CPU the loss kernel is differentiated by its Function's
    explicit backward (``softmax_xent_bwd_plain``), equal to torch's
    autograd through the plain forward within 1e-5."""
    logits, labels = _xent_inputs(16, 32, 96)
    x = torch.from_numpy(logits).requires_grad_(True)
    lab = torch.from_numpy(labels)
    nll, lse, pred = kernels.softmax_xent(x, lab)
    assert type(nll.grad_fn).__name__ == "_SoftmaxXentBackward"
    assert not pred.requires_grad
    w = torch.linspace(-1, 1, 32)
    (got,) = torch.autograd.grad((nll * w).sum() + lse.sum() * 0.5, x)
    pn, pl, _ = kernels.softmax_xent_plain(x, lab)
    (auto,) = torch.autograd.grad((pn * w).sum() + pl.sum() * 0.5, x)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), atol=TOL, rtol=0)


def test_softmax_xent_bf16_reads_logits_in_their_dtype():
    """bf16 logits: the values equal the f32 computation on the widened
    logits (the widening is exact), and the gradient is that f32
    gradient rounded once to bf16."""
    logits, labels = _xent_inputs(17, 16, 100)
    xb = torch.from_numpy(logits).to(torch.bfloat16)
    lab = torch.from_numpy(labels)
    nll, lse, pred = kernels.softmax_xent(xb, lab)
    fn, fl, fp = kernels.softmax_xent(xb.float(), lab)
    assert torch.equal(nll, fn) and torch.equal(lse, fl)
    assert torch.equal(pred, fp)
    g = torch.full((16,), 1 / 16)
    d = kernels.softmax_xent_bwd(xb, lab, lse, g)
    assert d.dtype == torch.bfloat16
    assert torch.equal(d, kernels.softmax_xent_bwd(xb.float(), lab, fl,
                                                   g).to(torch.bfloat16))


@pytest.mark.parametrize("which", ["bwd", "xent", "xent_bwd"])
def test_training_kernels_never_fall_back(which):
    """Meta tensors (an unsupported device) are refused, not computed
    by the plain versions."""
    with pytest.raises(ValueError, match="needs CUDA"):
        if which == "bwd":
            x = torch.empty((1, 2, 16, 16), device="meta")
            lse = torch.empty((1, 2, 16), device="meta")
            kernels.flash_attention_lse_bwd(x, x, x, x, lse, x)
        else:
            lg = torch.empty((4, 32), device="meta")
            lab = torch.empty((4,), dtype=torch.int32, device="meta")
            if which == "xent":
                kernels.softmax_xent(lg, lab)
            else:
                kernels.softmax_xent_bwd(lg, lab, torch.empty((4,),
                                                              device="meta"))


# K3's two forms on the card: the chooser, the layouts the checks plant
# ties at, the row-group body and its planted faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v, want", [
    (1000, ("rows", 8, 32, "16-byte")),      # AlexNet's (2048, 1000)
    (10, ("rows", 32, 8, "scalar")),         # (64, 10)
    (32768, ("cta", 1, 256, "16-byte")),     # the LM's (32768, 32768)
    (1001, ("rows", 8, 32, "scalar")),
    (64, ("rows", 32, 8, "16-byte")),
    (100, ("rows", 16, 16, "scalar")),
    (128, ("rows", 16, 16, "16-byte")),
    (8192, ("rows", 8, 32, "16-byte")),
    (8193, ("cta", 1, 256, "scalar")),
    (32771, ("cta", 1, 256, "scalar"))])
def test_xent_form_picks_row_groups_for_short_rows(v, want):
    """The row-group form (8, 16 or 32 lanes a row, 256 / lanes rows a
    CTA) up to the crossover, a CTA per row above it; the same at any
    number of rows."""
    assert tuple(kernels._xent_form(v)) == want
    assert kernels._xent_form(v) == kernels.XentForm(*want)


@pytest.mark.parametrize("force", ["rows", "cta"])
def test_xent_scalar_loads_only_when_v_is_not_a_multiple_of_8(force):
    """Either form takes 16-byte vectors when V % 8 == 0 and single
    elements otherwise, at every V; ``force`` takes every V."""
    for v in list(range(1, 300)) + [999, 1000, 1001, 32768, 32771]:
        f = kernels._xent_form(v, force)
        assert f.form == force
        assert (f.loads == "scalar") == (v % 8 != 0), v
        assert f.rows_per_cta * (f.lanes_per_row if force == "rows" else 1) \
            == (kernels._XENT_THREADS if force == "rows" else 1)


def test_xent_crossover_is_the_one_perf_records():
    """The chooser's crossover is the one PERF.md reports from the sweep,
    and the forms' C entries take 0 (a CTA per row) or the lanes a row."""
    with open(os.path.join(os.path.dirname(kernels._PKG_DIR),
                           "PERF.md")) as fh:
        perf = fh.read()
    assert (f"`_XENT_ROWS_MAX_V` = {kernels._XENT_ROWS_MAX_V}" in perf)
    cross = kernels._XENT_ROWS_MAX_V
    assert kernels._xent_form(cross).form == "rows"
    assert kernels._xent_form(cross + 1).form == "cta"
    assert kernels._xent_lanes(kernels._xent_form(cross + 8)) == 0
    assert kernels._xent_lanes(kernels._xent_form(cross - 8)) == 32
    with pytest.raises(ValueError, match="form 'warp'"):
        kernels._xent_form(1000, "warp")


@pytest.mark.parametrize("form", ["rows", "cta", None])
def test_xent_entries_in_either_form_run_the_plain_version_on_the_cpu(form):
    """On the CPU the forward and backward in either form are the plain
    versions, and launch nothing."""
    logits, labels = _xent_inputs(18, 16, 1000)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    g = torch.full((16,), 1 / 16)
    before = (kernels.softmax_xent.launches, kernels.softmax_xent_bwd.launches)
    got = kernels._xent_fwd(x, lab, form)
    d = kernels._xent_bwd(x, lab, got[1], g, g, form)
    assert (kernels.softmax_xent.launches,
            kernels.softmax_xent_bwd.launches) == before
    for a, b in zip(got, kernels.softmax_xent_plain(x, lab)):
        assert torch.equal(a, b)
    assert torch.equal(d, kernels.softmax_xent_bwd_plain(x, lab, got[1], g, g))


@pytest.mark.parametrize("v", [1000, 10])
def test_softmax_xent_plain_matches_the_jax_unfused_loss(v):
    """At a classifier's class counts the JAX loss op takes its unfused
    path (its kernel's gate refuses them): per row, ``nll`` is that path's
    loss within 1e-5 and ``pred`` its argmax exactly (the op counts a row
    correct against the port's pred), with equal maxima planted where the
    CUDA forms split a row."""
    import chip_smoke
    import flexflow_tpu.ops as jops
    from flexflow_tpu.ops.base import TensorSpec as JSpec

    n = 24
    assert not pallas_kernels.xent_supported(1, v)
    logits, labels = _xent_inputs(19 + v, n, v)
    ties = chip_smoke._xent_tie_cols(v)
    top = logits.max() + 1.0
    for r, cols in enumerate(ties):
        logits[r, list(cols)] = top
    nll, _, pred = kernels.softmax_xent(torch.from_numpy(logits),
                                        torch.from_numpy(labels))
    assert [int(pred[r]) for r in range(len(ties))] == [min(c) for c in ties]
    jop = jops.SoftmaxCrossEntropy(
        "softmax", JSpec("lg", (1, v), jnp.float32, ("n", None)),
        JSpec("lb", (1,), jnp.int32, ("n",)))
    for r in range(n):
        row = jnp.asarray(logits[r:r + 1])
        for lab, check in ((labels[r], "nll"), (int(pred[r]), "pred")):
            (loss, m, _), _ = jop.forward(
                {}, [row, jnp.asarray([lab], jnp.int32)], {}, False)
            if check == "nll":
                np.testing.assert_allclose(float(nll[r]), float(loss),
                                           atol=TOL, rtol=0)
            else:
                assert int(m["train_correct"]) == 1, (r, int(pred[r]))


def _xent_layouts():
    """(form, vector width, threads a row) of every way the CUDA forms
    split a row: row groups of 8, 16 or 32 lanes over bf16 and f32
    16-byte vectors or single elements; a CTA of 256 threads over
    8-element vectors or single elements."""
    rows = [("rows", w, lanes) for w in (8, 4, 1) for lanes in (8, 16, 32)]
    return rows + [("cta", w, 256) for w in (8, 1)]


@pytest.mark.parametrize("v", [1000, 1001, 8184, 32768, 32771])
def test_planted_ties_cover_every_split_of_a_row(v):
    """chip_smoke's planted equal maxima lie, for every layout of both
    forms, inside one vector, across two threads of a row and across two
    vectors of one thread (where a thread has two), and at the row's two
    ends."""
    import chip_smoke

    sets = chip_smoke._xent_tie_cols(v)
    assert (v - 1, 0) in sets
    for form, w, lanes in _xent_layouts():
        where = [[(c // w % lanes, c // w) for c in cols] for cols in sets]
        same_vec = any(len({vec for _, vec in s}) < len(s) for s in where)
        two_lanes = any(len({ln for ln, _ in s}) > 1 for s in where)
        one_lane = any(len({ln for ln, _ in s}) < len({vec for _, vec in s})
                       for s in where)
        assert two_lanes, (form, w, lanes)
        # A thread holds two vectors of the row only past one stride.
        assert one_lane or v <= w * lanes, (form, w, lanes)
        assert same_vec or w == 1, (form, w, lanes)


def _xent_code():
    with open(os.path.join(kernels._SRC_DIR, "softmax_xent.cu")) as fh:
        return re.sub(r"//[^\n]*", "", fh.read())


def test_xent_row_groups_load_first_and_merge_by_shuffles_alone():
    """The row-group forward loads the label and the lane's whole tile
    before its first reduction and merges with warp shuffles only (no
    shared memory, no barrier); the backward loads the row's scalars and
    the tile before its first store; the CTA per row loads the label
    before its walk."""
    code = _xent_code()
    fwd = code.split("xent_rows_fwd_kernel(", 1)[1].split("\n}\n", 1)[0]
    assert fwd.index("labels[row]") < fwd.index("load_tile<") \
        < fwd.index("> cm")
    assert "__shfl_xor_sync" in fwd and "__shfl_sync" in fwd
    assert "__shared__" not in fwd and "__syncthreads" not in fwd
    bwd = code.split("xent_rows_bwd_kernel(", 1)[1].split("\n}\n", 1)[0]
    assert max(bwd.index(s) for s in ("labels[row]", "lse[row]", "g_nll[row]",
                                      "g_lse[row]")) \
        < bwd.index("load_tile<") < bwd.index("store_vec(")
    cta = code.split("xent_fwd_kernel(", 1)[1].split("\n}\n", 1)[0]
    assert cta.index("labels[row]") < cta.index("absorb(")
    assert "x[lab]" not in cta


def test_k3_mutants_are_held_at_alexnet_and_v1001():
    """The three planted row-group faults (ties to the larger index, a
    lane's last vector dropped, the backward's one-hot dropped in a lane's
    second vector) each edit a line of ``softmax_xent.cu`` once and are
    held at (2048, 1000) bf16 and (2048, 1001) f32."""
    from flexflow_torch.tools import stream_numerics as sn

    k3 = {n: m for n, m in sn.MUTANTS.items() if m[1] == "k3"}
    assert len(k3) == 3
    with open(os.path.join(kernels._SRC_DIR, "softmax_xent.cu")) as fh:
        text = fh.read()
    for source, _, edits in k3.values():
        assert source == "softmax_xent.cu"
        assert all(text.count(old) == 1 and old != new for old, new in edits)
    assert sn.MUTANT_CASES["k3"] == (((2048, 1000), "bfloat16", "xent"),
                                     ((2048, 1001), "float32", "xent"))


# ---------------------------------------------------------------------------
# K4 / K5: the embedding row gather and scatter-add
# ---------------------------------------------------------------------------


def _rows_inputs(seed, r, d, idx):
    g = np.random.default_rng(seed)
    return (g.standard_normal((r, d)).astype(np.float32),
            np.asarray(idx, np.int32),
            g.standard_normal((len(idx), d)).astype(np.float32))


#: Duplicate ids at distance 1 (7, 7), 2 (3 _ 3) and 5 (11 ... 11), the
#: table's first and last rows, and ids that share a 128-lane row of the
#: JAX kernel's packed layout.
_DUP_IDS = [7, 7, 3, 0, 3, 11, 39, 1, 2, 4, 11, 5, 38]


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_gather_rows_plain_matches_pallas(d):
    table, idx, _ = _rows_inputs(50 + d, 40, d, _DUP_IDS)
    want = pallas_kernels.gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                      interpret=True)
    before = kernels.gather_rows.launches
    got = kernels.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert kernels.gather_rows.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # a copy


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_scatter_add_rows_plain_matches_pallas(d):
    """f32 within 1e-6 relative plus 1e-6: the Pallas kernel adds runs of
    equal ids to the table one after another, the port sums a row's
    updates first and adds once, so duplicates round in another order."""
    table, idx, upd = _rows_inputs(60 + d, 40, d, _DUP_IDS)
    want = pallas_kernels.scatter_add_rows(jnp.asarray(table), jnp.asarray(idx),
                                           jnp.asarray(upd), interpret=True)
    t = torch.from_numpy(table.copy())
    before = kernels.scatter_add_rows.launches
    out = kernels.scatter_add_rows(t, torch.from_numpy(idx), torch.from_numpy(upd))
    assert out is t and kernels.scatter_add_rows.launches == before
    np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_scatter_add_rows_empty_batch_is_a_no_op():
    table, _, _ = _rows_inputs(70, 40, 64, [])
    want = pallas_kernels.scatter_add_rows(
        jnp.asarray(table), jnp.zeros((0,), jnp.int32),
        jnp.zeros((0, 64), jnp.float32), interpret=True)
    t = torch.from_numpy(table.copy())
    kernels.scatter_add_rows(t, torch.zeros((0,), dtype=torch.int32),
                             torch.zeros((0, 64)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.numpy(), table)
    assert kernels.gather_rows(t, torch.zeros((0,), dtype=torch.int64)).shape \
        == (0, 64)


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_scatter_add_rows_sums_each_row_in_batch_order(id_dtype):
    """The exact arithmetic the CUDA kernel shares: per row, the updates
    summed in f32 from 0 in batch order, then added to the row once
    (a numpy loop does the same float32 operations); bit for bit, and
    bit-identical across calls."""
    g = np.random.default_rng(71)
    table = g.standard_normal((50, 24)).astype(np.float32)
    idx = g.integers(0, 6, 200)
    upd = (g.standard_normal((200, 24)) * 10.0 ** g.integers(-3, 4, (200, 1))
           ).astype(np.float32)
    want = table.copy()
    for row in np.unique(idx):
        acc = np.zeros(24, np.float32)
        for i in np.flatnonzero(idx == row):
            acc = acc + upd[i]
        want[row] = want[row] + acc
    runs = []
    for _ in range(2):
        t = torch.from_numpy(table.copy())
        kernels.scatter_add_rows(t, torch.from_numpy(idx).to(id_dtype),
                                 torch.from_numpy(upd))
        runs.append(t.numpy())
    np.testing.assert_array_equal(runs[0], want)
    np.testing.assert_array_equal(runs[1], runs[0])


def test_row_kernels_out_of_range_ids():
    """An id outside [0, R) gathers a NaN row and its update is dropped.
    JAX agrees for ids >= R (``jnp.take``'s fill, ``.at[].add``'s drop);
    a negative id, which JAX wraps, is out of range in the port."""
    table, _, upd = _rows_inputs(72, 10, 8, [0, 0, 0, 0])
    idx = np.array([3, 10, 12, -1], np.int32)
    got = kernels.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx[:3]), axis=0))
    np.testing.assert_array_equal(got.numpy()[:3], want)
    assert np.isnan(got.numpy()[1:]).all()
    t = torch.from_numpy(table.copy())
    kernels.scatter_add_rows(t, torch.from_numpy(idx), torch.from_numpy(upd))
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(idx[:3])].add(upd[:3]))
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("which", ["gather", "scatter"])
def test_row_kernels_never_fall_back(which):
    table = torch.empty((10, 8), device="meta")
    ids = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        if which == "gather":
            kernels.gather_rows(table, ids)
        else:
            kernels.scatter_add_rows(table, ids, torch.empty((4, 8),
                                                             device="meta"))


def test_row_kernels_refuse_bad_shapes():
    t = torch.zeros((10, 8))
    with pytest.raises(ValueError, match="int32 or int64"):
        kernels.gather_rows(t, torch.zeros((3,)))
    with pytest.raises(ValueError, match="updates must be"):
        kernels.scatter_add_rows(t, torch.zeros((3,), dtype=torch.int32),
                                 torch.zeros((3, 9)))


@pytest.mark.parametrize("case", ["float ids", "2-d ids", "1-d table",
                                  "update rows", "update dtype"])
def test_scatter_add_rows_refuses_bad_operands(case):
    """Off the CPU (``meta`` tensors: no kernel can run) the wrapper
    refuses what K5 does not take before it plans a launch."""
    meta = dict(device="meta")
    table = torch.empty((10, 8), **meta)
    ids = torch.zeros((4,), dtype=torch.int64, **meta)
    upd = torch.empty((4, 8), **meta)
    match = "updates must be"
    if case == "float ids":
        ids, match = torch.zeros((4,), **meta), "int32 or int64"
    elif case == "2-d ids":
        ids, match = torch.zeros((4, 1), dtype=torch.int64, **meta), "table must be"
    elif case == "1-d table":
        table, match = torch.empty((10,), **meta), "table must be"
    elif case == "update rows":
        upd = torch.empty((5, 8), **meta)
    else:
        upd = torch.empty((4, 8), dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match=match):
        kernels.scatter_add_rows(table, ids, upd)


@pytest.mark.parametrize("n, plan", [
    (1, (1, 1)), (16, (1, 1)), (17, (1, 2)), (2048, (1, 128)),
    (4096, (1, 132)), (4097, (2, 132)), (32768, (2, 132))])
def test_scatter_plan_follows_n_alone(n, plan):
    """K5's route and grid come from n alone (reading the ids back would
    sync the device): one launch up to the cap, where one CTA's shared
    memory holds the grouping arrays of every id, then a counting launch
    and the binning launch over a scratch."""
    assert kernels.scatter_plan(n) == plan


def _row_code():
    with open(os.path.join(kernels._SRC_DIR, "embedding_rows.cu")) as fh:
        text = fh.read()
    return re.sub(r"//[^\n]*", "", text)


def test_scatter_add_rows_cuda_branch_has_no_library_sort():
    """K5 bins its ids itself: past the CPU branch the wrapper names no
    sort and passes the ids in batch order, and the kernel has no atomics
    (none float, so two launches give the same bits)."""
    src = inspect.getsource(kernels.scatter_add_rows)
    cuda = src.split("return scatter_add_rows_plain(table, ids, upd)", 1)[1]
    for name in ("sort", "perm", "unique"):
        assert name not in cuda, name
    assert "ids.data_ptr()" in cuda
    code = _row_code()
    assert re.findall(r"\batomic\w*|\bred\.|\batom\.", code) == []



# ---------------------------------------------------------------------------
# K4 over several tables: the lazy optimizers' param and state rows
# ---------------------------------------------------------------------------


def _three_tables(seed, r, d):
    g = np.random.default_rng(seed)
    return [g.standard_normal((r, d)).astype(np.float32) for _ in range(3)]


def _bits(x):
    return torch.as_tensor(x).contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("d", [32, 64])
def test_gather_rows_multi_plain_matches_pallas(d, id_dtype):
    """Each output of the three-table entry is JAX's gather of its table
    (the Pallas kernel in interpret mode), bit for bit, and a CPU call
    launches nothing."""
    tables = _three_tables(80 + d, 40, d)
    idx = np.asarray(_DUP_IDS, id_dtype)
    before = (kernels.gather_rows.launches, kernels.gather_rows_multi.launches)
    got = kernels.gather_rows_multi([torch.from_numpy(t) for t in tables],
                                    torch.from_numpy(idx))
    assert (kernels.gather_rows.launches,
            kernels.gather_rows_multi.launches) == before
    assert len(got) == 3
    for t, out in zip(tables, got):
        want = pallas_kernels.gather_rows(jnp.asarray(t), jnp.asarray(idx),
                                          interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["out of range", "D=16", "D=65",
                                  "one table", "two tables"])
def test_gather_rows_multi_equals_separate_gathers(case):
    """The same bits as one ``gather_rows_plain`` call per table, NaN rows
    of out-of-range ids included, at widths the CUDA kernel takes in its
    16-byte and 4-byte forms; and ``gather_rows`` is the one-table case."""
    d = {"D=16": 16, "D=65": 65}.get(case, 8)
    k = {"one table": 1, "two tables": 2}.get(case, 3)
    tables = [torch.from_numpy(t) for t in _three_tables(90, 10, d)][:k]
    idx = [3, 10, 12, -1, 0, 9, 3] if case == "out of range" else [4, 0, 4, 9]
    ids = torch.tensor(idx, dtype=torch.int64)
    got = kernels.gather_rows_multi(tables, ids)
    assert len(got) == k
    for t, out in zip(tables, got):
        np.testing.assert_array_equal(_bits(out),
                                      _bits(kernels.gather_rows_plain(t, ids)))
        np.testing.assert_array_equal(_bits(out),
                                      _bits(kernels.gather_rows(t, ids)))
    if case == "out of range":
        assert all(bool(out[1:4].isnan().all()) for out in got)
    assert [o.shape for o in kernels.gather_rows_multi_plain(tables, ids)] \
        == [o.shape for o in got]


@pytest.mark.parametrize("case, match", [
    ("shape", "one \\(R, D\\)"), ("width", "one \\(R, D\\)"),
    ("dtype", "one dtype"), ("device", "one device"),
    ("none", "1 to 3 tables"), ("four", "1 to 3 tables")])
def test_gather_rows_multi_refuses_mismatched_tables(case, match):
    """Tables that differ in shape, dtype or device, or too few or too
    many of them, raise naming the gate, on every device."""
    t = torch.zeros((10, 8))
    other = {"shape": torch.zeros((11, 8)), "width": torch.zeros((10, 4)),
             "dtype": torch.zeros((10, 8), dtype=torch.float64),
             "device": torch.zeros((10, 8), device="meta")}.get(case)
    tables = {"none": [], "four": [t] * 4}.get(case, [t, t, other])
    with pytest.raises(ValueError, match=match):
        kernels.gather_rows_multi(tables, torch.zeros((3,), dtype=torch.int64))


def test_gather_rows_multi_never_falls_back():
    """Off the CPU (``meta``: no kernel can run) the entry launches or
    raises, as ``gather_rows`` does."""
    tables = [torch.empty((10, 8), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="needs CUDA"):
        kernels.gather_rows_multi(tables,
                                  torch.zeros((4,), dtype=torch.int32,
                                              device="meta"))


@pytest.mark.parametrize("n, log_g, ctas", [
    (2048, 4, 128),     # the DLRM step: 16 threads an id, 128 CTAs
    (1, 4, 1), (1, 0, 1), (16, 4, 1), (17, 4, 2),
    (2048, 2, 32),      # D = 16
    (32768, 5, 528),    # the LM's token table: one wave, threads loop
    (10 ** 6, 4, 528)])
def test_gather_grid_is_at_most_one_wave(n, log_g, ctas):
    """K4's grid from n, the threads per id and the SM count alone: a
    thread per (id, vector) up to four CTAs of 256 threads per SM."""
    assert kernels.gather_ctas(n, log_g, 132) == ctas
    assert ctas <= 132 * kernels._GATHER_CTAS_PER_SM
    assert ctas * kernels._GATHER_THREADS >= min(
        n << log_g, 132 * kernels._GATHER_CTAS_PER_SM * 256)


def test_gather_kernel_issues_every_table_load_before_its_stores():
    """K4 takes up to three tables a launch, and each thread issues its
    loads from every table before its first store; the wrapper's grid
    constants are the kernel's."""
    code = _row_code()
    body = code.split("gather_regs_kernel(", 1)[1].split("\n}\n", 1)[0]
    loads, stores = body.index("__ldg(src_row<V>"), body.index("p.out[u]")
    assert loads < stores
    assert "kMaxTables = 3" in code and kernels._GATHER_MAX_TABLES == 3
    assert f"kThreads = {kernels._GATHER_THREADS}" in code
    assert "cp.async.bulk" not in code and "__shfl" not in body


def test_k4_mutant_is_held_at_the_dlrm_shape_and_d65():
    """The planted K4 fault (the third table's rows read from the first)
    edits the line the kernel takes its source rows from, and is held
    through the one- and three-table entries at the DLRM table and at
    D = 65 (the 4-byte body)."""
    from flexflow_torch.tools import stream_numerics as sn

    source, group, edits = sn.MUTANTS["k4-table-2-reads-table-0"]
    assert source == "embedding_rows.cu" and group == "k4"
    with open(os.path.join(kernels._SRC_DIR, source)) as fh:
        text = fh.read()
    assert all(text.count(old) == 1 and old != new for old, new in edits)
    assert sn.MUTANT_CASES["k4"] == (((8_000_000, 64), "float32", "gather"),
                                     ((100_000, 65), "float32", "gather"))
