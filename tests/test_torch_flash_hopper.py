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
  memory at every tile width;
- the race's bf16 v3 and v4 (``csrc/flash_probe.cu``) run on the same
  machinery, share K1f's two products (``csrc/flash_wg.cuh``) rather
  than copy them, fit shared memory at every (hd, block), and are held by
  the card at shapes whose key tiles wrap their ring across its passes;
- the race's bf16 v2 and b2 are K1f's kernel and K1b's pair themselves
  (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``): templated on the key
  tile (and, for b2's dq pass, on reading the caller's delta), they fit
  shared memory at every (hd, block) with their ring's depth, the ring
  protocol is sound at every depth they use, and no bf16 code is left on
  the race's ``mma.sync`` machinery (``csrc/mma_tile.cuh``).

The tile width is chosen in the C dispatch by head dim (hd <= 32: 32, <=
64: 64, else 128), not in Python; the card holds each width (phases 1
and 2 run hd 8, 24, 72 and 128 at ragged lengths).
"""

import os
import random
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
                                    "wgmma_tile.cuh", "flash_wg.cuh",
                                    "flash_probe.cu", "flash_probe_bwd.cu"])
@pytest.mark.parametrize("atomic", ["atomicAdd", "atomicCAS", "red.global",
                                    "red.shared", "red.async", "atom.",
                                    "cp.reduce.async"])
def test_no_float_atomics(source, atomic):
    """Two launches of the flash kernels on the same inputs give the same
    bits: no atomic adds (the order of a sum by atomics changes from run to
    run)."""
    assert atomic not in _code(source)


#: The calls through which each bf16 kernel issues its wgmma products: its
#: own, or the forward products of flash_wg.cuh, which it must then call.
_PRODUCTS = {
    "flash_bwd.cu": ("mma_ss_n64(", "mma_rs"),
    "flash_fwd.cu": ("issue_scores<", "issue_pv<"),
    "flash_probe.cu": ("issue_scores<", "issue_pv<"),
}


@pytest.mark.parametrize("source", sorted(_PRODUCTS))
def test_bf16_kernels_run_on_the_hopper_machinery(source):
    """The bf16 kernels take their operands from TMA loads behind mbarriers
    and multiply by wgmma, through wgmma_tile.cuh; the library kernels and
    torch are not reached from CUDA.  Every call is looked for in the
    source's own text; the forward kernels' products are their calls of
    flash_wg.cuh, which issues them by wgmma.  wgmma_tile.cuh, which
    defines the calls, is not searched."""
    code = _code(source)
    assert '#include "wgmma_tile.cuh"' in code
    for call in _PRODUCTS[source] + (
            "Tile<", "ring->wait(", "ring->release(", "ring->acquire(",
            "reg_alloc<", "reg_dealloc<", "__grid_constant__ CUtensorMap"):
        assert call in code, call
    if "issue_pv<" in _PRODUCTS[source]:
        assert '#include "flash_wg.cuh"' in code
        shared = _code("flash_wg.cuh")
        assert "mma_ss_n64(" in shared and "mma_rs<" in shared
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
          if m[1] in ("k1f", "k1b")}
    assert {m[0] for m in k1.values()} == {"flash_fwd.cu", "flash_bwd.cu"}
    assert len(k1) == 4
    for group in ("k1f", "k1b"):
        shapes = [s for s, dt, entry in stream_numerics.MUTANT_CASES[group]
                  if entry == "k1"]
        assert shapes == [(16, 8, 2048, 64), (4, 8, 8192, 64)]


# ---------------------------------------------------------------------------
# the race's bf16 v3 and v4 on K1f's machinery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["issue_scores", "issue_pv"])
def test_forward_products_are_shared_not_copied(fn):
    """K1f and the two-pass kernel issue their S = Q K^T and O += P V
    through flash_wg.cuh, templated on the key tile; neither defines its
    own."""
    define = re.compile(rf"__device__ __forceinline__ void {fn}\(")
    homes = [f for f in sorted(os.listdir(CSRC))
             if define.search(_code(f))]
    assert homes == ["flash_wg.cuh"]
    for source in ("flash_fwd.cu", "flash_probe.cu"):
        assert '#include "flash_wg.cuh"' in _code(source)
        assert f"{fn}<HD" in _code(source)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("hd", [64, 128])
def test_two_pass_tiles_fit_shared_memory(hd, block):
    """The two-pass kernel's 128-row q tile and its K/V ring (K1f's depth
    of three stages, key tiles of the race's block), plus the ring's
    barriers, the q barrier and the 1024-byte alignment, fit the 227 KiB
    a Hopper block may take: 224 KiB at hd 128 and block 128, as K1f."""
    bm, stages = (_constant("flash_probe.cu", n) for n in ("kWgBM",
                                                           "kStages"))
    assert (bm, stages) == (128, 3)
    tile = lambda rows: rows * hd * 2  # bf16, every panel
    smem = tile(bm) + 2 * stages * tile(block) + 2 * stages * 8 + 8 + 1024
    assert smem <= 227 * 1024
    assert f"TwoPassSmem<{hd}, {block}>::kBytes <=" in _code("flash_probe.cu")


def _tiles_per_cta(t, block, causal):
    """Key tiles each 128-row CTA of v3 and v4 streams per pass."""
    ctas = range(0, t, 128)
    v3 = [-(-(min(t, q0 + 128) if causal else t) // block) for q0 in ctas]
    return v3, [-(-t // block)] * len(v3)


def test_ring_wrap_cases_wrap_the_ring():
    """Each shape that holds the ring across its two passes (phase 15's
    ``PROBE_WRAP``, the ring mutant's cases) has, at both blocks and for
    v3 and v4, a CTA whose key tiles per pass are not a multiple of twice
    the ring's depth: a tile counter restarted for pass 2 then waits on
    the wrong phase (``test_ring_model_restart_faults``)."""
    import chip_smoke

    depth = _constant("flash_probe.cu", "kStages")
    cases = [(s, c) for s, c in chip_smoke.PROBE_WRAP]
    cases += [(s, pair == "race-causal") for s, _, pair in
              stream_numerics.MUTANT_CASES["race"]]
    assert ((1, 2, 640, 128), True) in cases
    assert ((1, 2, 450, 64), False) in cases
    for shape, causal in cases:
        for block in (64, 128):
            for tiles in _tiles_per_cta(shape[-2], block, causal):
                assert any(n % (2 * depth) for n in tiles), (shape, block,
                                                             tiles)


def test_race_mutants_cover_the_two_pass_kernel():
    """A ring whose pass 2 restarts the tile counter, held by K1f's rule
    at the wrapping shapes (causal and not) and the 2k race shape; v4
    skipping its tiles above the diagonal, held by the NaN at the last
    key (causal).  Both run each case in a child process."""
    race = {n: m for n, m in stream_numerics.MUTANTS.items()
            if m[0] == "flash_probe.cu"}
    assert {n: m[1] for n, m in race.items()} == {
        "race-ring-restarts": "race", "v4-skips-above-diagonal": "poison"}
    assert set(stream_numerics.CHILD_GROUPS) == {"race", "poison"}
    assert {pair for _, _, pair in stream_numerics.MUTANT_CASES["race"]} \
        == {"race-causal", "race-full"}
    for group in ("race", "poison"):
        shapes = [s for s, dt, _ in stream_numerics.MUTANT_CASES[group]]
        assert (16, 8, 2048, 64) in shapes and (1, 2, 640, 128) in shapes
        assert all(dt == "bfloat16" for _, dt, _ in
                   stream_numerics.MUTANT_CASES[group])


def test_every_mbarrier_wait_traps():
    """One wait serves every ring and barrier of the bf16 kernels (K1f,
    K1b and the race's two-pass kernel run on the same machinery): it
    traps once a phase has not come within its bound, so a fault of a
    ring's phases fails the launch instead of hanging the card.  No source
    spins on an mbarrier of its own."""
    tile = _code("wgmma_tile.cuh")
    assert "@p trap;" in tile and "%%globaltimer_lo" in tile
    assert tile.count("mbarrier.try_wait.parity") == 2  # bar_try, bar_wait
    assert "template <int S>\nstruct Ring" in tile
    for source in _PRODUCTS:
        code = _code(source)
        assert "mbarrier.try_wait" not in code and "Ring<kStages>;" in code


# ---------------------------------------------------------------------------
# a model of the two-pass kernel's mbarrier ring
# ---------------------------------------------------------------------------


class _Bar:
    """An mbarrier: a phase completes when all its arrivals are in and
    every byte announced with them has landed."""

    def __init__(self, count):
        self.count = self.pending = count
        self.tx = self.phase = 0

    def arrive(self, tx=0):
        self.pending -= 1
        self.tx += tx
        self._step()

    def land(self, tx):
        self.tx -= tx
        self._step()

    def _step(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def done(self, parity):
        """``mbarrier.try_wait.parity``: the phase of that parity is over."""
        return self.phase % 2 != parity


def _ring_faults(nk, nk_wg, p2, seed, depth=3, warps=8, passes=2):
    """The ring protocol of ``wg_two_pass_kernel`` (``flash_probe.cu``)
    under one random schedule: the producer acquires tile ``J`` (stage ``J
    % depth``, parity ``(J / depth) & 1``) and loads K (pass 1) or K and V
    (pass 2) into it; each consumer warp waits for every tile, reads those
    of its warpgroup's ``nk_wg`` and releases each.  Pass 1 takes tiles 0
    .. nk - 1, pass 2 ``p2`` .. ``p2 + nk - 1`` (the kernel: ``p2 = nk``).
    With ``passes=1`` it is the one pass of K1f's kernel (v2) and of each
    kernel of K1b's pair (b2).  Returns the faults seen: a stale read, a
    load into a stage being read, a deadlock, loads still in flight when
    the consumers are done."""
    rnd = random.Random(seed)
    full = [_Bar(1) for _ in range(depth)]
    empty = [_Bar(warps) for _ in range(depth)]
    held = [None] * depth
    flight, reading, faults = [], {}, set()

    def tiles():
        for p, base in ((0, 0), (1, p2))[:passes]:
            for j in range(nk):
                yield p, j, (base + j) % depth, (base + j) // depth % 2

    def producer():
        for p, j, st, par in tiles():
            while not empty[st].done(par ^ 1):
                yield False
            if st in reading.values():
                faults.add("overwrite")
            full[st].arrive(tx=1 + p)
            flight.append((st, (p, j), 1 + p))
            yield True

    def consumer(w):
        for p, j, st, par in tiles():
            while not full[st].done(par):
                yield False
            if j < nk_wg[w // 4]:
                if held[st] != (p, j):
                    faults.add("stale")
                reading[w] = st
                yield True
                del reading[w]
            empty[st].arrive()
            yield True

    threads = {-1: producer(), **{w: consumer(w) for w in range(warps)}}
    while any(w >= 0 for w in threads):
        moves = [("load", i) for i in range(len(flight))] + \
            [("run", w) for w in threads]
        rnd.shuffle(moves)
        for kind, x in moves:
            if kind == "load":
                st, tag, tx = flight.pop(x)
                held[st] = tag
                full[st].land(tx)
                break
            try:
                if next(threads[x]):
                    break
            except StopIteration:
                del threads[x]
                break
        else:
            faults.add("deadlock")
            break
    if flight and "deadlock" not in faults:
        faults.add("in flight")
    return faults


def test_ring_model_one_counter_is_sound():
    """With one tile counter through both passes no schedule reads a
    stale tile, overwrites a stage in use, deadlocks or leaves a load in
    flight, whatever the key tiles per pass and the warpgroups' shares."""
    for nk in range(1, 8):
        for a in range(nk + 1):
            for b in range(a, nk + 1):
                for seed in range(4):
                    assert not _ring_faults(nk, (a, b), nk, seed), (nk, a, b)


@pytest.mark.parametrize("nk", range(1, 13))
def test_ring_model_restart_faults(nk):
    """A counter restarted for pass 2 (``stream_numerics``'s
    ``race-ring-restarts``) finds its phases only when the tiles per pass
    are a multiple of twice the depth; otherwise some schedule reads stale
    tiles or deadlocks (which the kernel's waits turn into a trap)."""
    faults = set()
    for seed in range(20):
        faults |= _ring_faults(nk, (nk, nk), 0, seed)
    assert bool(faults) == (nk % 6 != 0), (nk, faults)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("depth", [2, 3])
def test_ring_model_is_sound_at_every_depth_used(depth, passes):
    """The rings of the wgmma kernels have three stages, or two where
    three do not fit (b2 at hd 128 and block 128, both passes): one tile
    counter through every pass of a kernel is sound at both depths."""
    for nk in range(1, 8):
        for a in range(nk + 1):
            for b in range(a, nk + 1):
                for seed in range(3):
                    assert not _ring_faults(nk, (a, b), nk, seed, depth=depth,
                                            passes=passes), (nk, a, b)


@pytest.mark.parametrize("nk", range(1, 9))
def test_ring_model_restart_faults_at_depth_two(nk):
    """At depth two a counter restarted for a second pass finds its phases
    only when the tiles per pass are a multiple of four: no kernel may
    restart it, at either depth."""
    faults = set()
    for seed in range(20):
        faults |= _ring_faults(nk, (nk, nk), 0, seed, depth=2)
    assert bool(faults) == (nk % 4 != 0), (nk, faults)


# ---------------------------------------------------------------------------
# the race's bf16 v2 and b2 on K1f's kernel and K1b's pair
# ---------------------------------------------------------------------------


_SMEM_MAX = 227 * 1024


def _ring_bytes(depth):
    return 2 * 8 * depth  # the full and empty mbarriers of each stage


def _v2_smem(hd, block):
    """``K1fSmem<hd, block>``: the 128-row q tile, three stages of K and V
    tiles of ``block`` rows, the ring, the q barrier, 1024 to align."""
    tile = lambda rows: rows * hd * 2
    return tile(128) + 2 * 3 * tile(block) + _ring_bytes(3) + 8 + 1024


def _b2_smem(hd, block, depth):
    """(``DqSmem``, ``DkvSmem``) of ``csrc/flash_bwd.cu`` at a ring of
    ``depth`` stages: the dq pass's Q and dO tiles and its streamed K and V
    tiles of ``block`` keys; the dk/dv pass's 128-key K and V tiles, its
    streamed Q and dO tiles of ``block`` rows and their lse and delta slots
    (``2 block`` floats each)."""
    tile = lambda rows: rows * hd * 2
    dq = 2 * tile(128) + 2 * depth * tile(block)
    dkv = 2 * tile(128) + 2 * depth * tile(block) + depth * 2 * 2 * block * 4
    extra = _ring_bytes(depth) + 8 + 1024
    return dq + extra, dkv + extra


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("hd", [64, 128])
def test_row_state_tiles_fit_shared_memory(hd, block):
    """v2 (K1f's kernel at key tiles of ``block``) keeps K1f's three
    stages at every (hd, block); b2's passes take three stages where they
    fit and two where they do not, which is hd 128 at block 128 only (three
    stages of 128-row K/V, or Q/dO, tiles take 192 KiB beside 64 KiB of
    resident tiles).  Each instantiation fits the 227 KiB a Hopper block
    may take, and the sources assert it."""
    assert _v2_smem(hd, block) <= _SMEM_MAX
    assert f"K1fSmem<{hd}, {block}>::kBytes <= 227 * 1024" in _code(
        "flash_fwd.cu")
    depth = 3 if max(_b2_smem(hd, block, 3)) <= _SMEM_MAX else 2
    assert depth == (2 if (hd, block) == (128, 128) else 3)
    assert max(_b2_smem(hd, block, depth)) <= _SMEM_MAX
    code = " ".join(_code("flash_bwd.cu").split())
    if depth == 3:
        assert (f"dq_stages<{hd}, {block}>() == 3 && "
                f"dkv_stages<{hd}, {block}>() == 3") in code
    else:
        assert (f"DqS<{hd}, {block}>::kBytes <= kSmemMax && "
                f"DkvS<{hd}, {block}>::kBytes <= kSmemMax") in code
    assert "? 3 : 2" in code and "kSmemMax = 227 * 1024;" in code


def test_v2_is_k1fs_kernel_without_the_lse():
    """One forward kernel serves K1f, the bf16 K1s and the race's v2: K1f
    instantiates it at 128-key tiles with the lse store, v2 at the race's
    block without it; the lse is stored only under the flag."""
    code = _code("flash_fwd.cu")
    assert code.count("__global__") == 2  # the f32 FMA kernel and this one
    assert "template <int HDP, int BN, bool LSE>\n__global__" in code
    assert "launch_wg<HDP, kWgBN, true>" in code
    assert "launch_wg<HD, BN, false>" in code
    assert "if (LSE && tq == 0) lse[" in code
    entry = code[code.index('extern "C" int ff_flash_fwd_row_state('):]
    assert "nullptr" in entry[:entry.index("#undef")]


def test_b2_dq_pass_reads_the_callers_delta():
    """b2 is K1b's pair with a delta-in flag on the dq pass: with it the
    pass reads ``delta`` for its own rows and writes none, and reads
    neither ``o`` nor ``g_lse`` (the entry hands it null pointers); without
    it (K1b) the pass reduces ``rowsum(o do) - g_lse`` and writes it.  The
    dk/dv pass is one kernel for both."""
    code = _code("flash_bwd.cu")
    assert "template <int HDP, int BN, bool DIN>\n__global__" in code
    assert "template <int HDP, int QN>\n__global__" in code
    din = code[code.index("if constexpr (DIN) {"):code.index("} else {",
                                                             code.index("if constexpr (DIN) {"))]
    assert "delta[base + rows[h]]" in din
    assert "] =" not in din.replace("dl[h] =", "")
    k1b = code[code.index("} else {", code.index("if constexpr (DIN) {")):]
    k1b = k1b[:k1b.index("float ls2[2];")]
    assert "if (lane == 0) delta[base + row] = a;" in k1b
    assert "launch_wg<HDP, kWgBN, false>(FF_BWD_ARGS)" in code
    entry = code[code.index('extern "C" int ff_flash_bwd_row_state('):]
    entry = " ".join(entry[:entry.index("#undef")].replace("\\", " ").split())
    assert ("launch_wg<HD, BN, true>(q, k, v, nullptr, dout, lse_f, "
            "nullptr, delta_f,") in entry
    assert code.count("__global__") == 4  # f32 dq, dkv; the wgmma pair


def test_no_bf16_is_left_on_the_mma_sync_machinery():
    """After v2 and b2 moved to the wgmma kernels no bf16 launch reaches
    ``mma_tile.cuh``: it keeps no bf16 product (``mma.sync``, ``ldmatrix``
    and the bf16 packing are gone), and its users instantiate f32 only
    (their entries refuse any other dtype)."""
    tile = _code("mma_tile.cuh")
    for gone in ("mma.sync", "ldmatrix", "bfloat16", "pack_bf16", "ld32",
                 "mma_bf16", "ldsm_x4_trans"):
        assert gone not in tile, gone
    for source in ("flash_probe.cu", "flash_probe_bwd.cu", "flash_stream.cu"):
        code = _code(source)
        assert '#include "mma_tile.cuh"' in code
        assert "FF_PROBE_TYPE" not in code
    probe_f32 = _code("flash_probe.cu")
    probe_f32 = probe_f32[probe_f32.index('extern "C" int ff_flash_probe_fwd('):]
    assert "dtype != ff::kFloat32" in probe_f32[:probe_f32.index("#define")]
    assert "dtype != ff::kFloat32" in _code("flash_probe_bwd.cu")
    assert "__nv_bfloat16" not in _code("flash_probe_bwd.cu")
    assert "launch_variant<HD, BN>(" in _code("flash_probe.cu")
    assert "launch_bwd<HD, BN>(" in _code("flash_probe_bwd.cu")


def test_row_state_mutants_cover_v2_and_b2():
    """v2 masking its edge tiles at 128-key columns (wrong at block 64
    only, so K1f is untouched) and b2's dq pass reading the next row's
    delta (the delta-in branch only, so K1b is untouched), each held at
    the 2k race shape and at hd 128, causal, in-process (neither can
    trap)."""
    row = {n: m for n, m in stream_numerics.MUTANTS.items()
           if m[1] in ("v2", "b2")}
    assert {n: (m[0], m[1]) for n, m in row.items()} == {
        "v2-edge-128-key-columns": ("flash_fwd.cu", "v2"),
        "b2-dq-delta-row-off": ("flash_bwd.cu", "b2")}
    for group in ("v2", "b2"):
        cases = stream_numerics.MUTANT_CASES[group]
        assert [s for s, _, _ in cases] == [(16, 8, 2048, 64), (1, 2, 640, 128)]
        assert all(dt == "bfloat16" and pair == group for _, dt, pair in cases)
        assert group not in stream_numerics.CHILD_GROUPS
    (old, new), = row["v2-edge-128-key-columns"][2]
    assert "j * BN" in old and "j * kWgBN" in new
    (old, new), = row["b2-dq-delta-row-off"][2]
    din = _code("flash_bwd.cu")
    din = din[din.index("if constexpr (DIN) {"):]
    assert old.strip() in din[:din.index("} else {")]
