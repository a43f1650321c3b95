"""The port's kernel race (P1, P2) on the CPU, held against the JAX probes.

On a CPU tensor the wrappers of ``flexflow_torch.ops.probe_kernels`` run
their plain versions; the JAX side runs the Pallas probe kernels of
``tools/probe_flash_variants.py`` (``_v2_kernel``, ``_v3_kernel``,
``_v4_kernel`` through ``_call``) and ``tools/probe_flash_bwd_variants.py``
(``_bwd_call_lanes``) in interpret mode, imported with ``tools/`` on
``sys.path``.  Then the races' scaffolding (``parse_dims_blocks`` against
the JAX one, the variant keys) and the races themselves on the CPU,
untimed.  Tolerance: f32 within 1e-5 (``TOL``, the K1f/K1b tests' bar).
The CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py`` (phase 15).
"""

import functools
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "tools") not in sys.path:
    sys.path.append(os.path.join(ROOT, "tools"))

import probe_common as jcommon  # noqa: E402  (tools/, the JAX probes)
import probe_flash_bwd_variants as jbwd  # noqa: E402
import probe_flash_variants as jfwd  # noqa: E402

from flexflow_tpu.ops import pallas_kernels as pk  # noqa: E402
from flexflow_torch.ops import kernels  # noqa: E402
from flexflow_torch.ops import probe_kernels as probe  # noqa: E402
from flexflow_torch.tools import (probe_common, probe_flash_bwd_variants,  # noqa: E402
                                  probe_flash_variants)

TOL = 1e-5
BH, T, BLOCK = 2, 256, 128


def _arrays(seed, n, shape):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# P1: v2, v3, v4 against the Pallas probe kernels
# ---------------------------------------------------------------------------


def _jax_variant(name, hd, causal):
    """(kernel, scratch) for ``jfwd._call`` at block 128."""
    scale = 1.0 / math.sqrt(hd)
    if name == "v2":
        return functools.partial(jfwd._v2_kernel, block_k=BLOCK,
                                 causal=causal, scale=scale), None
    if name == "v3":
        return (functools.partial(jfwd._v3_kernel, block_k=BLOCK,
                                  causal=causal, scale=scale),
                [jfwd.pltpu.VMEM((BLOCK, T), jnp.float32)])
    return functools.partial(jfwd._v4_kernel, causal=causal,
                             scale=scale), None


WRAPPERS = {"v2": probe.flash_fwd_row_state, "v3": probe.flash_fwd_two_pass,
            "v4": probe.flash_fwd_full_row}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("name", ["v2", "v3", "v4"])
def test_forward_variant_matches_jax_probe(name, hd, causal):
    q, k, v = _arrays(10 + hd + int(causal), 3, (BH, T, hd))
    kernel, scratch = _jax_variant(name, hd, causal)
    o_j = jfwd._call(kernel, *(jnp.asarray(a) for a in (q, k, v)), BLOCK,
                     scratch)
    fn = WRAPPERS[name]
    before = fn.launches
    o_t = fn(*(torch.from_numpy(a) for a in (q, k, v)), causal, BLOCK)
    assert fn.launches == before  # the plain version, no kernel
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL,
                               rtol=0)


def test_forward_plain_versions_are_k1f():
    """The three forward variants compute one function, K1f's ``o``; each
    wrapper's plain version is that function, on ``(bh, t, hd)`` and
    ``(b, h, t, hd)`` operands."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(3, 3, (1, 2, 80, 64)))
    want = kernels.flash_attention_lse_plain(q, k, v, True)[0]
    for plain, fn in ((probe.flash_fwd_row_state_plain, WRAPPERS["v2"]),
                      (probe.flash_fwd_two_pass_plain, WRAPPERS["v3"]),
                      (probe.flash_fwd_full_row_plain, WRAPPERS["v4"])):
        assert torch.equal(plain(q, k, v, True), want)
        assert torch.equal(fn(q, k, v, True, 64), want)
        assert torch.equal(fn(q[0], k[0], v[0], True, 64), want[0])


# ---------------------------------------------------------------------------
# P2: b2 against the Pallas probe kernels and K1b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_bwd_row_state_matches_jax_lanes(hd, causal):
    q, k, v, do = _arrays(20 + hd + int(causal), 4, (BH, T, hd))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = pk._fwd_call(jq, jk, jv, causal, True)
    delta = jnp.broadcast_to(
        jnp.sum(o * jdo, axis=-1, keepdims=True), (BH, T, pk.LSE_LANES))
    lanes = jbwd._bwd_call_lanes(jq, jk, jv, jdo, lse, delta, causal, True)
    prod = pk._bwd_call(jq, jk, jv, jdo, lse, delta, causal, True)
    before = probe.flash_bwd_row_state.launches
    got = probe.flash_bwd_row_state(
        *(torch.from_numpy(a) for a in (q, k, v, do)),
        torch.from_numpy(np.array(lse[..., 0])),
        torch.from_numpy(np.array(delta[..., 0])), causal, BLOCK)
    assert probe.flash_bwd_row_state.launches == before
    for g, a, b in zip(got, lanes, prod):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=TOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_row_state_plain_is_k1b_given_delta(dtype):
    """b2's plain version from ``delta = rowsum(o do) - g_lse`` gives K1b's
    plain gradients bit for bit."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _arrays(5, 4, (1, 2, 96, 64)))
    g_lse = torch.from_numpy(_arrays(6, 1, (1, 2, 96))[0])
    o, lse = kernels.flash_attention_lse_plain(q, k, v, True)
    want = kernels.flash_attention_lse_bwd_plain(q, k, v, o, lse, do, g_lse,
                                                 True)
    delta = (o.float() * do.float()).sum(dim=-1) - g_lse
    got = probe.flash_bwd_row_state(q, k, v, do, lse, delta, True, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype,block,gate", [
    ((2, 64, 32), torch.float32, 64, "head dim 32"),
    ((2, 64, 64), torch.float32, 256, "block 256"),
    ((2, 64, 64), torch.float16, 64, "dtype torch.float16"),
    ((2, 0, 64), torch.float32, 64, "t = 0"),
    ((64, 64), torch.float32, 64, "(..., t, hd)"),
])
def test_gate_names_what_it_refuses(shape, dtype, block, gate):
    why = probe.probe_unsupported(shape, dtype, block)
    assert why is not None and gate in why
    x = torch.zeros(shape, dtype=dtype)
    for fn in WRAPPERS.values():
        with pytest.raises(ValueError, match="race kernels' gate"):
            fn(x, x, x, True, block)
    with pytest.raises(ValueError, match="race kernels' gate"):
        probe.flash_bwd_row_state(x, x, x, x, x[..., 0].float(),
                                  x[..., 0].float(), True, block)


def test_gate_takes_every_instantiated_shape():
    for hd in probe.PROBE_HEAD_DIMS:
        for block in probe.PROBE_BLOCKS:
            for t in (1, 80, 130, 2048):
                for dt in (torch.float32, torch.bfloat16):
                    assert probe.probe_unsupported((4, 2, t, hd), dt,
                                                   block) is None


def test_race_kernels_join_the_counters():
    assert probe.KERNELS[:len(kernels.KERNELS)] == kernels.KERNELS
    assert set(probe.PROBE_KERNELS) <= set(probe.KERNELS)
    assert {"flash_probe", "flash_probe_bwd"} <= set(kernels._SOURCES)


# ---------------------------------------------------------------------------
# the races' scaffolding against the JAX one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["4", "8", "8192", "64"],
    ["--blocks", "64"],
    ["--blocks=128,64"],
    ["1", "8", "32768", "64", "--blocks", "128"],
    ["--blocks", "64,128", "2", "2", "256", "128"],
    ["--bocks", "64"],
    ["1", "2", "3"],
    ["--blocks"],
])
def test_parse_dims_blocks_matches_jax(argv):
    def parse(fn):
        try:
            return fn(list(argv))
        except SystemExit:
            return "exit"
    want = parse(lambda a: jcommon.parse_dims_blocks(
        a, default_blocks=(64, 128)))
    assert parse(probe_common.parse_dims_blocks) == want


@pytest.mark.parametrize("argv", [["--blocks", "256"], ["--blocks=64,512"]])
def test_parse_dims_blocks_refuses_blocks_not_instantiated(argv):
    assert jcommon.parse_dims_blocks(argv)[1]  # JAX's takes any block
    with pytest.raises(SystemExit, match="not instantiated"):
        probe_common.parse_dims_blocks(argv)


def test_forward_race_keys_are_the_jax_race_keys():
    want = list(jfwd.variants(T, 64, BLOCK, BLOCK, jnp.float32))
    got = list(probe_flash_variants.variants(BLOCK))
    assert got == [("v5_sdpa" if n == "v5_stock" else n) for n in want]


@pytest.mark.parametrize("tool", [probe_flash_variants,
                                  probe_flash_bwd_variants])
def test_race_without_cuda_exits_nonzero(tool, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["1", "2", "128", "64"]) != 0
    assert "block" not in capsys.readouterr().out


@pytest.mark.parametrize("tool,names", [
    (probe_flash_variants, ["v1_base", "v2_lanes", "v3_twopass",
                            "v4_fullrow", "v5_sdpa", "v6_stream", "v2_lanes",
                            "v3_twopass", "v4_fullrow"]),
    (probe_flash_bwd_variants, ["b1_prod", "b2_lanes", "b3_stream",
                                "b4_sdpa", "b2_lanes"]),
])
def test_race_on_the_cpu(tool, names, capsys):
    """The races end to end: each on the CPU (plain versions and the
    SDPA yardstick, untimed) runs every variant once per block (the
    block-free ones at the first block), each within 2^-5 of its
    reference slice's largest magnitude."""
    rows = []
    assert tool.main(["1", "2", "128", "64"], device="cpu",
                     rows_out=rows) == 0
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert r["unsupported"] is None and r["ms"] is None
        assert r["calls"] == 1 and r["err"] <= 2.0 ** -5 * r["scale"]
    assert "not measured (CPU)" in capsys.readouterr().out


def test_race_prints_unsupported_rows():
    rows = []
    assert probe_flash_variants.main(["1", "2", "64", "32", "--blocks", "64"],
                                     device="cpu", rows_out=rows) == 0
    refused = {r["name"]: r["unsupported"] for r in rows if r["unsupported"]}
    assert set(refused) == {"v2_lanes", "v3_twopass", "v4_fullrow"}
    assert all("head dim 32" in why for why in refused.values())


def test_sdpa_stays_out_of_the_port_path():
    """SDPA is the races' yardstick only: no module under ops, runtime,
    models or apps names it."""
    pkg = os.path.join(ROOT, "flexflow_torch")
    for sub in ("ops", "runtime", "models", "apps"):
        for dirpath, _, files in os.walk(os.path.join(pkg, sub)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(dirpath, f)) as fh:
                        assert "scaled_dot_product_attention" not in \
                            fh.read(), f


# ---------------------------------------------------------------------------
# v3 and v4 on the wgmma machinery: the route, the gate, the formulations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", [0, 1, 2])
def test_probe_entry_routes_by_variant_and_dtype(variant, dtype):
    """Every bf16 variant runs on the wgmma/TMA machinery: v2 on K1f's
    kernel (csrc/flash_fwd.cu), v3 and v4 on the two-pass kernel
    (csrc/flash_probe.cu); every f32 variant launches the race's
    mma_tile.cuh kernels in csrc/flash_probe.cu (wgmma takes f32 only as
    TF32).  Each entry is in the library the route names and loads with
    the forward variants' one C signature."""
    lib, entry = probe.probe_entry(variant, dtype)
    if dtype == torch.float32:
        assert (lib, entry) == ("flash_probe", "ff_flash_probe_fwd")
    elif variant == 0:
        assert (lib, entry) == ("flash_fwd", "ff_flash_fwd_row_state")
    else:
        assert (lib, entry) == ("flash_probe", "ff_flash_probe_fwd_wg")
    assert lib in kernels._SOURCES
    with open(os.path.join(ROOT, "flexflow_torch", "csrc", f"{lib}.cu")) as fh:
        assert f'extern "C" int {entry}(int variant,' in fh.read()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_probe_entry_routes_by_dtype(dtype):
    """bf16 b2 launches K1b's wgmma pair with the dq pass reading the
    caller's delta (csrc/flash_bwd.cu); f32 b2 the FMA kernels of
    csrc/flash_probe_bwd.cu.  Both entries take b2's one C signature."""
    lib, entry = probe.bwd_probe_entry(dtype)
    want = (("flash_bwd", "ff_flash_bwd_row_state")
            if dtype == torch.bfloat16
            else ("flash_probe_bwd", "ff_flash_probe_bwd"))
    assert (lib, entry) == want and lib in kernels._SOURCES
    with open(os.path.join(ROOT, "flexflow_torch", "csrc", f"{lib}.cu")) as fh:
        text = fh.read()
    sig = text[text.index(f'extern "C" int {entry}('):]
    sig = " ".join(sig[:sig.index("{")].split())
    assert sig.endswith("void* dq, void* dk, void* dv, int bh, int t, int "
                        "hd, int causal, float scale, int dtype, int block, "
                        "void* stream)"), sig


def test_b2_hands_over_aligned_row_buffers():
    """b2's kernels read lse and delta by TMA boxes, which need a 16-byte
    aligned base: the wrapper's ``_dense`` copies a buffer whose base is
    not (a contiguous view at an odd storage offset) and keeps one that
    is."""
    flat = torch.arange(1 + 2 * 3 * 80, dtype=torch.float32)
    view = flat[1:].view(2, 3, 80)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = kernels._dense(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    aligned = flat[:-1].view(2, 3, 80)
    assert kernels._dense(aligned).data_ptr() == aligned.data_ptr()


def _gate_rule(shape, dtype, block):
    """``probe_unsupported`` as it stood before the wgmma route, copied:
    the new route takes every shape the old one took."""
    if len(shape) < 3:
        return False
    t, hd = shape[-2], shape[-1]
    return (dtype in (torch.float32, torch.bfloat16) and hd in (64, 128)
            and block in (64, 128) and t >= 1
            and 1 <= math.prod(shape[:-2]) <= 65535)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("block", [32, 64, 128, 256])
def test_probe_gate_is_unchanged(dtype, block):
    for shape in [(1, 1, 64), (64, 1, 128), (2, 3, 640, 128), (65535, 5, 64),
                  (65536, 5, 64), (256, 256, 2, 64), (2, 0, 64),
                  (0, 4, 64), (3, 7, 96), (1, 1 << 20, 128), (16, 8, 2048)]:
        assert (probe.probe_unsupported(shape, dtype, block) is None) == \
            _gate_rule(shape, dtype, block), (shape, dtype, block)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", ["v3", "v4"])
def test_forward_variant_bf16_matches_jax_probe(name, causal):
    """bf16 at hd 128 and block 128, the widest tiles of the wgmma route:
    the plain version the card holds v3 and v4 against agrees with
    ``_v3_kernel`` / ``_v4_kernel`` (interpret mode), both with K1f's
    cast points, within one bf16 ulp of each element plus 2^-8 of the
    terms behind it (K1f's rule: p may round the other way)."""
    hd = 128
    q, k, v = _arrays(30 + int(causal), 3, (BH, T, hd))
    kernel, scratch = _jax_variant(name, hd, causal)
    o_j = jfwd._call(kernel, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     BLOCK, scratch)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o_t = WRAPPERS[name](tq, tk, tv, causal, BLOCK)
    mass = kernels.flash_attention_lse_plain(tq, tk, tv.abs(), causal)[0]
    want = np.asarray(o_j.astype(jnp.float32))
    got = o_t.float().numpy()
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * mass.float().numpy()
    assert o_t.dtype == torch.bfloat16
    assert np.all(np.abs(got - want) <= tol)


def test_nan_at_the_last_key_reaches_every_row_of_v4_only():
    """What ``chip_smoke._probe_poison`` holds the card's v3 and v4 to,
    on the Pallas formulations: with a NaN in ``v`` at the last key,
    causal, ``_v4_kernel``'s one product over the whole row multiplies it
    by every row's ``p`` (an exact 0 above the diagonal), so every row of
    ``o`` is NaN, as in the plain version; ``_v3_kernel`` stops each q
    block at its diagonal, so only the last block's rows are NaN."""
    hd = 64
    q, k, v = _arrays(40, 3, (BH, T, hd))
    v[:, T - 1, :] = np.nan
    rows = {}
    for name in ("v3", "v4"):
        kernel, scratch = _jax_variant(name, hd, True)
        o = np.asarray(jfwd._call(kernel, *(jnp.asarray(a) for a in (q, k, v)),
                                  BLOCK, scratch))
        rows[name] = np.isnan(o).any(-1)
    plain = probe.flash_fwd_full_row_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), True)
    assert rows["v4"].all() and bool(plain.isnan().any(-1).all())
    assert rows["v3"][:, T - BLOCK:].all()
    assert not rows["v3"][:, :T - BLOCK].any()


# ---------------------------------------------------------------------------
# kernel_race: the other checkout's race kernels
# ---------------------------------------------------------------------------


def test_kernel_race_refuses_without_a_checkout_or_a_card(monkeypatch,
                                                          capsys):
    from flexflow_torch.tools import kernel_race

    assert kernel_race.main([]) == 2
    assert "usage" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_race.main(["--against", ROOT]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_race_binds_the_other_probe_kernels_to_their_kernels():
    """``kernel_race`` times another checkout's v3 and v4: its
    ``probe_kernels.py`` must launch through its own ``kernels.py`` (its
    libraries, built from its sources), and loading it must leave this
    checkout's modules in place."""
    import flexflow_torch.ops as ops
    from flexflow_torch.tools import kernel_race

    theirs = kernel_race._other_kernels(ROOT)
    other = kernel_race._other_probe(ROOT, theirs)
    assert other.kernels is theirs and other._load is theirs._load
    assert theirs is not kernels and theirs._libs is not kernels._libs
    assert ops.kernels is kernels
    assert sys.modules["flexflow_torch.ops.kernels"] is kernels
    assert probe.kernels is kernels
    q, k, v = (torch.from_numpy(a) for a in _arrays(5, 3, (2, 80, 64)))
    for name in ("flash_fwd_two_pass", "flash_fwd_full_row"):
        assert torch.equal(getattr(other, name)(q, k, v, True, 64),
                           getattr(probe, name)(q, k, v, True, 64))


def test_kernel_race_calls_k1b_alike_in_both_checkouts():
    """``kernel_race`` holds K1b's ``dq``, ``dk``, ``dv`` to the other
    checkout's bit for bit through one call of ``flash_attention_lse_bwd``
    on both modules; on the CPU both give the plain version's bits."""
    from flexflow_torch.tools import kernel_race

    theirs = kernel_race._other_kernels(ROOT)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _arrays(6, 4, (1, 2, 80, 64)))
    o, lse = kernels.flash_attention_lse(q, k, v, True)
    g_lse = torch.ones_like(lse)
    mine, other = (m.flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse,
                                             True)
                   for m in (kernels, theirs))
    assert all(torch.equal(a, c) for a, c in zip(mine, other))


@pytest.mark.parametrize("t", [1, 80, 2048, 8192])
def test_race_products_count_the_score_pairs_each_variant_multiplies(t):
    """The bound of the products a variant does (``chip_smoke.py`` phase
    15, ``kernel_race``): v3 multiplies each causal pair three times (two
    Q K^T, one P V), v4 each of the t^2 pairs three times, the others each
    causal pair twice."""
    import chip_smoke

    pairs = t * (t + 1) // 2
    unit = 2 * pairs  # the causal function's products, in score pairs
    got = {name: chip_smoke.race_products(name, t) * unit
           for name in ("flash_fwd_two_pass", "flash_fwd_full_row",
                        "flash_fwd_row_state")}
    assert got["flash_fwd_two_pass"] == pytest.approx(3 * pairs)
    assert got["flash_fwd_full_row"] == pytest.approx(3 * t * t)
    assert got["flash_fwd_row_state"] == pytest.approx(unit)
