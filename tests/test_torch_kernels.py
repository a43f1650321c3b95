"""The port's kernel wrappers on the CPU, held against the JAX kernels.

On a CPU tensor each wrapper in ``flexflow_torch/ops/kernels.py`` runs
its plain PyTorch version; those versions are pinned here against the
Pallas kernels of ``flexflow_tpu/ops/pallas_kernels.py`` run in
interpret mode (as the JAX package's own tests run them on the CPU), on
the same numpy inputs, in f32 within 1e-5.  The CUDA kernels themselves
are held against the same plain versions on the GPU by chip_smoke.py.
"""

import os
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 32, 64])
def test_flash_attention_plain_matches_pallas(t, causal):
    q, k, v = _qkv(t + int(causal), (2, 2, t, 16))
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
