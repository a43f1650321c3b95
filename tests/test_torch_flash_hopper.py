"""The bf16 K1f/K1b redesign for Hopper, on the CPU.

The CUDA kernels themselves (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``
on the machinery of ``csrc/wgmma_tile.cuh``) run only on the card, where
``chip_smoke.py`` holds them against the plain versions.  Here:

- the gate ``flash_supported`` is pinned to a literal copy of its rule:
  the redesign changes no shape the kernels take;
- the plain versions, which the card holds the new kernels against, agree
  with the Pallas kernels (interpret mode) in bf16 at the head dims the
  new kernels pad to a tile width of 32, 64 or 128;
- the sources keep the properties the port promises: no float atomics in
  the backward (two launches give the same bits), the bf16 products by
  wgmma on TMA-fed shared memory behind mbarriers;
- every planted fault of ``stream_numerics --mutants`` still names a line
  that exists exactly once in its source, and K1f's tiles fit shared
  memory at every tile width.

The tile width is chosen in the C dispatch by head dim (hd <= 32: 32, <=
64: 64, else 128), not in Python; the card holds each width (phases 1
and 2 run hd 8, 24, 72 and 128 at ragged lengths).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops import pallas_kernels
from flexflow_torch.ops import kernels
from flexflow_torch.tools import stream_numerics

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "flexflow_torch", "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _code(name):
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", _source(name), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


# ---------------------------------------------------------------------------
# the gate does not change
# ---------------------------------------------------------------------------


def _gate_rule(shape, dtype):
    """``flash_supported`` as it stood before the redesign, copied."""
    if len(shape) != 4:
        return False
    _, _, t, hd = shape
    return (dtype in (torch.float32, torch.bfloat16) and t >= 1
            and hd % 8 == 0 and 8 <= hd <= 128 and -(-t // 64) <= 65535)


@pytest.mark.parametrize("rank", [3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_supported_truth_table(rank, dtype):
    for hd in range(0, 137):
        for t in (0, 1, 16, 70000, 64 * 65535, 64 * 65535 + 1):
            shape = (2, 3, t, hd) if rank == 4 else \
                (2, t, hd) if rank == 3 else (1, 2, 3, t, hd)
            assert kernels.flash_supported(shape, dtype) == \
                _gate_rule(shape, dtype), (shape, dtype)


@pytest.mark.parametrize("hd", [8, 24, 32, 64, 72, 128])
def test_flash_supported_takes_every_padded_head_dim(hd):
    assert kernels.flash_supported((1, 2, 1, hd), torch.bfloat16)
    assert kernels.flash_supported((1, 2, 130, hd), torch.bfloat16)
    assert not kernels.flash_supported((1, 2, 130, hd + 4), torch.bfloat16)


# ---------------------------------------------------------------------------
# the plain versions in bf16 at the padded head dims, against Pallas
# ---------------------------------------------------------------------------


def _inputs(seed, shape):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [8, 24, 72, 128])
def test_flash_forward_plain_bf16_matches_pallas(hd, causal):
    """bf16 at the head dims the CUDA kernel pads: the same cast points on
    both sides (f32 scores, p rounded to bf16 before P.V), f32 sums in
    another order, so ``o`` may differ by one bf16 ulp of itself plus
    2^-8 of the terms behind it; lse within 1e-5 of its own size."""
    shape = (1, 2, 32, hd)
    q, k, v, _ = _inputs(hd + int(causal), shape)
    o_j, lse_j = pallas_kernels.flash_attention_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o_t, lse_t = kernels.flash_attention_lse(tq, tk, tv, causal)
    mass = kernels.flash_attention_lse_plain(tq, tk, tv.abs(), causal)[0]
    want = np.asarray(o_j.astype(jnp.float32))
    got = o_t.float().numpy()
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * mass.float().numpy()
    assert o_t.dtype == torch.bfloat16
    assert np.all(np.abs(got - want) <= tol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [8, 24, 72, 128])
def test_flash_backward_plain_bf16_padded_head_dims(hd, causal):
    """The bf16 backward's plain version at the padded head dims against
    ``jax.vjp`` of the Pallas kernels: both round p and ds to bf16 before
    their products, so a gradient may differ by one bf16 ulp of itself
    plus 2^-7 of its largest term (a p or ds rounded the other way)."""
    import jax

    shape = (1, 2, 32, hd)
    q, k, v, g_o = _inputs(50 + hd + int(causal), shape)
    g_lse = np.random.default_rng(hd).standard_normal(shape[:3]).astype(
        np.float32)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    _, vjp = jax.vjp(
        lambda a, b, c: pallas_kernels.flash_attention_lse(a, b, c, causal),
        *args)
    want = vjp((jnp.asarray(g_o, jnp.bfloat16), jnp.asarray(g_lse)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, lse = kernels.flash_attention_lse_plain(tq, tk, tv, causal)
    got = kernels.flash_attention_lse_bwd(
        tq, tk, tv, o, lse, torch.from_numpy(g_o).to(torch.bfloat16),
        torch.from_numpy(g_lse), causal)
    for g, w in zip(got, want):
        a = g.float().numpy()
        b = np.asarray(w.astype(jnp.float32))
        assert g.dtype == torch.bfloat16 and a.shape == shape
        assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b)
                      + 2.0 ** -7 * np.abs(b).max() + 1e-6)


# ---------------------------------------------------------------------------
# what the sources promise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["flash_bwd.cu", "flash_fwd.cu",
                                    "wgmma_tile.cuh"])
@pytest.mark.parametrize("atomic", ["atomicAdd", "atomicCAS", "red.global",
                                    "red.shared", "red.async", "atom.",
                                    "cp.reduce.async"])
def test_no_float_atomics(source, atomic):
    """Two launches of the flash kernels on the same inputs give the same
    bits: no atomic adds (the order of a sum by atomics changes from run to
    run)."""
    assert atomic not in _code(source)


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd.cu"])
def test_bf16_kernels_run_on_the_hopper_machinery(source):
    """The bf16 kernels take their operands from TMA loads behind mbarriers
    and multiply by wgmma, through wgmma_tile.cuh; the library kernels and
    torch are not reached from CUDA."""
    code = _code(source)
    assert '#include "wgmma_tile.cuh"' in code
    for call in ("Tile<", "mma_ss_n64(", "mma_rs", "ring->wait(",
                 "ring->release(", "ring->acquire(", "reg_alloc<",
                 "reg_dealloc<", "__grid_constant__ CUtensorMap"):
        assert call in code, call
    for banned in ("cublas", "cudnn", "torch/", "cutlass", "cute/"):
        assert banned not in code.lower(), banned


def test_wgmma_tile_issues_the_hopper_instructions():
    code = _code("wgmma_tile.cuh")
    for ptx in ("cp.async.bulk.tensor.3d", "mbarrier.try_wait.parity",
                "mbarrier.arrive.expect_tx", "wgmma.mma_async",
                "wgmma.fence", "wgmma.commit_group", "wgmma.wait_group",
                "setmaxnreg.inc", "setmaxnreg.dec", "cuTensorMapEncodeTiled"):
        assert ptx in code, ptx
    assert "-lcuda" not in code


@pytest.mark.parametrize("source, kernel", [
    ("flash_fwd.cu", "_fwd_kernel"), ("flash_bwd.cu", "_dq_kernel"),
    ("flash_bwd.cu", "_dkv_kernel"), ("flash_fwd.cu", "_fwd_stream_kernel"),
    ("flash_stream.cu", "_fwd_stream_kernel"),
    ("flash_decode.cu", "_decode_kernel")])
def test_sources_name_the_kernel_they_replace(source, kernel):
    head = _source(source).split("#include")[0]
    assert f"pallas_kernels.py::{kernel}" in head or f"::{kernel}" in head
    assert "Bound." in head


# ---------------------------------------------------------------------------
# the planted faults still find their lines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(stream_numerics.MUTANTS))
def test_mutant_edits_apply_once(name):
    source, pair, edits = stream_numerics.MUTANTS[name]
    assert pair in stream_numerics.MUTANT_CASES
    text = _source(source)
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        assert new != old


def _constant(source, name):
    m = re.search(rf"constexpr int {name} = (\d+);", _code(source))
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("hdp", [32, 64, 128])
def test_k1f_tiles_fit_shared_memory(hdp):
    """K1f's q tile and its K/V ring (128-key tiles, three stages) at each
    tile width, plus the ring's barriers and the 1024-byte alignment, fit
    the 227 KiB of shared memory a Hopper block may take."""
    bm, bn = _constant("flash_fwd.cu", "kWgBM"), _constant("flash_fwd.cu",
                                                           "kWgBN")
    stages = _constant("flash_fwd.cu", "kStages")
    assert (bm, bn, stages) == (128, 128, 3)
    tile = lambda rows: rows * hdp * 2  # bf16, every panel
    smem = tile(bm) + 2 * stages * tile(bn) + 2 * stages * 8 + 8 + 1024
    assert smem <= 227 * 1024


def test_k1_mutants_cover_each_new_kernel():
    """A dropped key tile in K1f, in K1b's dq pass, a dropped query tile
    in its dk/dv pass and bf16 scores in both passes."""
    k1 = {n: m for n, m in stream_numerics.MUTANTS.items()
          if m[0] in ("flash_fwd.cu", "flash_bwd.cu")}
    assert {m[1] for m in k1.values()} == {"k1f", "k1b"}
    assert len(k1) == 4
    for group in ("k1f", "k1b"):
        shapes = [s for s, dt, entry in stream_numerics.MUTANT_CASES[group]
                  if entry == "k1"]
        assert shapes == [(16, 8, 2048, 64), (4, 8, 8192, 64)]
