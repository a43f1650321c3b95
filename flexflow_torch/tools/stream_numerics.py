"""Numerics of the streamed flash kernels (K1s, K1sb) and of the split-K
decode (K6) on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m flexflow_torch.tools.stream_numerics [--mutants [--groups G,...]]

It prints, for the bf16 kernels (K1f of ``csrc/flash_fwd.cu``, which is
also the bf16 K1s; K1b of ``csrc/flash_bwd.cu``, which is also the bf16
K1sb):

1. ``scores``: the error of the tensor-core score against the f64 dot,
   read from the lse at t = 1 (where lse is the scaled score itself),
   through K1s's entry and K1f's (the same kernel in bf16), in units of
   2^-24 of ``scale sum |q_i k_i|``.
2. ``flips``: the share of p values that K1b and the plain version round
   to bf16 otherwise than p rounded from f64 scores.  Each is read from
   the backward's dv with ``do`` the identity at t = hd, where ``dv^T`` is
   exactly the rounded p.
3. ``f64``: dq, dk and dv of K1b and the plain version against an f64
   backward with the same cast points, and K1b against the plain version
   (phase 12 of ``chip_smoke.py``).  For each: the least ``arel`` that
   ``|got - want| <= 2^-7 |want| + arel * mass`` needs (``mass`` as
   ``chip_smoke._flash_bwd_mass``), and the reading of
   ``chip_smoke.TOL_ELEM["stream_bwd"]`` (above 1 fails).
4. With ``--mutants``: copies of a source with a planted fault, built
   beside the real ones under ``flexflow_torch/_build/mutants/``
   (``MUTANTS``), each held through the entry points that reach it
   (``MUTANT_CASES``), element by element against the plain versions
   (``TOL_ELEM["fwd"]`` and ``["stream_bwd"]``, as phases 1, 2 and 12 of
   ``chip_smoke.py`` hold them): in ``flash_stream.cu`` bf16 scores in the
   f32 K1sb, a key tile dropped from its dq pass, a query tile dropped
   from its dk/dv pass, through ``flash_attention_lse_streamed`` at f32
   shapes; in ``flash_bwd.cu`` the same three faults in the wgmma pair,
   through K1b's entry at (16, 8, 2048, 64) and (4, 8, 8192, 64) and
   through K1sb's at (4, 8, 8192, 64) and (1, 8, 32768, 64) bf16 (the
   plain versions one head at a time); in ``flash_fwd.cu`` a key tile
   dropped from K1f, through K1f's entry at the same two shapes and
   through K1s's at (4, 8, 8192, 64) and (1, 8, 32768, 64) bf16; in
   ``flash_decode.cu`` a merge that skips the last non-empty split, at
   phase 1's two timed decode cases in f32 and bf16 (``_decode_close``);
   in ``flash_probe.cu`` the bf16 two-pass kernel (v3, v4) restarting its
   ring's tile counter for pass 2, held by K1f's rule at both blocks at
   the shapes that wrap the ring (``chip_smoke.PROBE_WRAP``) and at the
   2k race shape, and v4 skipping its key tiles above the diagonal (so
   computing v3), held by ``chip_smoke._probe_poison`` (a NaN at the last
   key must reach every row of v4) at (1, 2, 640, 128) and the 2k race
   shape.  Each case of those two runs in a child process of its own
   (``--case``): a ring fault may end in the trap of the ring's wait,
   which poisons the process's CUDA context.  In ``flash_fwd.cu`` the
   race's bf16 v2 (K1f's kernel at the race's key tile) masking its edge
   tiles at the columns of 128-key tiles, held at block 64; in
   ``flash_bwd.cu`` b2's dq pass (K1b's, reading the caller's delta)
   reading the delta of the next row, held at both blocks: each against
   the plain version at (16, 8, 2048, 64) and (1, 2, 640, 128), causal.
   In ``embedding_rows.cu`` K4 reading the third table's rows from the
   first, held bit for bit through ``gather_rows`` and the three-table
   ``gather_rows_multi`` at a table of the DLRM shape and one of D = 65.
   In ``softmax_xent.cu`` K3's row groups merging equal maxima to the
   larger index, a lane dropping its last vector when V is not a multiple
   of the group's stride, and the backward dropping the one-hot term
   where the label lies in a lane's second vector, each held in the
   row-group form of K3's forward and backward against the plain
   versions (``chip_smoke._xent_hold``) at (2048, 1000) bf16 and (2048,
   1001) f32, with planted ties and labels.
   The unmutated kernels must pass and each mutant must fail at every
   case; the exit code is 1 otherwise.  ``--mutants --groups k3,k4`` runs
   only the planted faults of those groups of ``MUTANT_CASES`` (and not
   parts 1-3).

The card's name and power limit come first.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import torch


def _line(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def _log2(x: float) -> str:
    return f"2^{math.log2(x):.2f}" if x > 0 else "0"


def scores(kernels, hd: int, n: int = 8192) -> None:
    g = torch.Generator(device="cuda").manual_seed(10 + hd)
    q, k, v = (torch.randn((1, n, 1, hd), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(hd)
    prod = q.double() * k.double()
    dot = prod.sum(-1) * scale
    unit = prod.abs().sum(-1) * scale * 2.0 ** -24
    with torch.no_grad():
        for name, fn in (("K1s", kernels.flash_attention_lse_streamed),
                         ("K1f", kernels.flash_attention_lse)):
            lse = fn(q, k, v, True)[1].double()
            e = (lse - dot) / unit
            _line("scores", f"hd {hd} {name}: |err| max {e.abs().max().item():.3f}, "
                  f"mean {e.abs().mean().item():.4f}, signed mean "
                  f"{e.mean().item():+.4f} (units of 2^-24 scale sum |q k|, "
                  f"{n} dots)")


def flips(kernels, hd: int, heads: int = 2048) -> None:
    g = torch.Generator(device="cuda").manual_seed(20 + hd)
    t = hd
    bf16 = torch.bfloat16
    q, k, v = (torch.randn((1, heads, t, hd), generator=g, device="cuda")
               .to(bf16) for _ in range(3))
    do = torch.eye(t, device="cuda", dtype=bf16).expand(1, heads, t, hd)
    do = do.contiguous()
    po, plse = kernels.flash_attention_lse_plain(q, k, v, False)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(hd)
    ref = torch.exp(s - plse.double()[..., None]).float().to(bf16).float()
    got = {
        "K1b": kernels.flash_attention_lse_bwd(q, k, v, po, plse, do, None,
                                               False)[2],
        "plain": kernels.flash_attention_lse_bwd_plain(q, k, v, po, plse, do,
                                                       None, False)[2],
    }
    p = {name: dv.transpose(-1, -2).float() for name, dv in got.items()}
    for name, pk in p.items():
        diff = pk != ref
        up = (pk > ref).float().sum().item()
        _line("flips", f"hd {hd} {name} vs f64: {diff.float().mean().item():.3e} "
              f"of {diff.numel()} p values round the other way ({int(up)} up, "
              f"{int(diff.sum().item() - up)} down)")
    diff = p["K1b"] != p["plain"]
    _line("flips", f"hd {hd} K1b vs plain: {diff.float().mean().item():.3e}")


def _reference(q, k, v, o, lse, do, g_lse, causal):
    """dq, dk, dv of the flash backward in f64 with the plain version's
    cast points (p and ds rounded to bf16 before their products)."""
    b, h, t, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = tuple(torch.empty((b, h, t, hd), device=q.device) for _ in range(3))
    cols = torch.arange(t, device=q.device)
    for i in range(b):
        for j in range(h):
            qd, kd, vd, od, dod = (x[i, j].double() for x in (q, k, v, o, do))
            s = qd @ kd.T * scale
            if causal:
                s.masked_fill_(cols[None, :] > cols[:, None], -math.inf)
            p = torch.exp(s - lse[i, j, :, None].double())
            delta = (od * dod).sum(-1) - g_lse[i, j].double()
            ds = p * (dod @ vd.T - delta[:, None])
            pr = p.float().to(q.dtype).double()
            dsr = ds.float().to(q.dtype).double()
            del s, p, ds
            out[0][i, j] = dsr @ kd * scale
            out[1][i, j] = dsr.T @ qd * scale
            out[2][i, j] = pr.T @ dod
            del pr, dsr
    return out


def _arel(got, want, mass) -> float:
    err = (got.float() - want.float()).abs() - 2.0 ** -7 * want.float().abs()
    return (err / mass).clamp_min(0).max().item()


def f64_hold(kernels, shape) -> None:
    import chip_smoke as cs

    g = torch.Generator(device="cuda").manual_seed(30)
    bf16, f32 = torch.bfloat16, torch.float32
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(bf16)
                   for _ in range(4))
    g_lse = torch.randn(shape[:3], generator=g, device="cuda", dtype=f32)
    fwd = lambda *x: kernels.flash_attention_lse_plain(*x, True)
    po, plse = cs._per_row(fwd, q, k, v)
    got = {
        "K1b": kernels.flash_attention_lse_bwd(q, k, v, po, plse, do, g_lse,
                                               True),
        "plain": cs._per_row(
            lambda *x: kernels.flash_attention_lse_bwd_plain(*x, True),
            q, k, v, po, plse, do, g_lse),
    }
    ref = _reference(q, k, v, po, plse, do, g_lse, True)
    masses = cs._flash_bwd_mass(q, k, v, po, plse, do, g_lse, True)
    tops = cs._flash_bwd_top(q, k, v, po, plse, do, g_lse, True)
    rtol, arel, atop = cs.TOL_ELEM["stream_bwd"]["bfloat16"]
    pairs = [(name, "f64", got[name], ref) for name in got]
    pairs.append(("K1b", "plain", got["K1b"], got["plain"]))
    for name, against, grads, want in pairs:
        parts = []
        for key, a, w, m, tp in zip(("dq", "dk", "dv"), grads, want, masses,
                                    tops):
            need = _arel(a, w, m)
            reading = cs._close(a, w, m, rtol, arel, tp, atop)
            parts.append(f"{key} arel {_log2(need)}, rule {reading:.3g}")
        _line("f64", f"{shape} {name} vs {against}: " + "; ".join(parts))
    del got, ref, masses, tops


#: Planted faults: name -> (the source in csrc/ it edits, the cases of
#: ``MUTANT_CASES`` it is held at, (old, new) replacements).
MUTANTS = {
    # The f32 K1sb's two passes round the score to bf16 before the exp.
    "bf16-scores": ("flash_stream.cu", "stream", [
        ("expf(s[nt][e] * scale - ls[h])",
         "expf(__bfloat162float(__float2bfloat16(s[nt][e])) * scale - ls[h])"),
        ("expf(p[nt][e] * scale - ls[c])",
         "expf(__bfloat162float(__float2bfloat16(p[nt][e])) * scale - ls[c])"),
    ]),
    # The dq pass skips the first key tile of every q tile but the first.
    "dq-drops-key-tile": ("flash_stream.cu", "stream", [
        ("    warp_pv<kBN, HD>(acc, s, kt, kLd, wbuf);\n    __syncthreads();\n"
         "  }\n  store_rows<T, HD>(dq",
         "    if (j > 0 || nk == 1) warp_pv<kBN, HD>(acc, s, kt, kLd, wbuf);\n"
         "    __syncthreads();\n  }\n  store_rows<T, HD>(dq"),
    ]),
    # The dk/dv pass skips the last query tile of every key tile but the
    # last.
    "dkv-drops-q-tile": ("flash_stream.cu", "stream", [
        ("    warp_pv<BN, HD>(adv, p, dot, kLd, wbuf);",
         "    if (i + 1 < ni || i == i0) warp_pv<BN, HD>(adv, p, dot, kLd, wbuf);"),
        ("    warp_pv<BN, HD>(adk, p, qt, kLd, wbuf);",
         "    if (i + 1 < ni || i == i0) warp_pv<BN, HD>(adk, p, qt, kLd, wbuf);"),
    ]),
    # K1b's two passes round the score to bf16 before the exp.
    "k1b-bf16-scores": ("flash_bwd.cu", "k1b", [
        ("exp2_approx(fmaf(s[i], sl2, -ls2[h]))",
         "exp2_approx(fmaf(__bfloat162float(__float2bfloat16(s[i])), sl2, "
         "-ls2[h]))"),
        ("exp2_approx(fmaf(s[i2], sl2, -ls2))",
         "exp2_approx(fmaf(__bfloat162float(__float2bfloat16(s[i2])), sl2, "
         "-ls2))"),
    ]),
    # K1b's dq pass skips the first key tile of every warpgroup that has
    # more than one.
    "k1b-dq-drops-key-tile": ("flash_bwd.cu", "k1b", [
        ("if (j > 0) issue_dq<HDP, BN>(acc, da, ks + R::stage(j - 1) * KT::kBytes);",
         "if (j > 1) issue_dq<HDP, BN>(acc, da, ks + R::stage(j - 1) * KT::kBytes);"),
    ]),
    # K1b's dk/dv pass skips the last query tile of every key tile but the
    # last.
    "k1b-dkv-drops-q-tile": ("flash_bwd.cu", "k1b", [
        ("            !(causal && qi0 + kSubQ - 1 < kr0)) {",
         "            !(causal && qi0 + kSubQ - 1 < kr0) &&\n"
         "            (i + 1 < nq || i == i0)) {"),
    ]),
    # K1f drops the P V product of the first key tile of every warpgroup
    # that has more than one.
    "k1f-drops-key-tile": ("flash_fwd.cu", "k1f", [
        ("        issue_pv<HDP, BN>(acc, pa, vs + R::stage(j - 1) * "
         "KT::kBytes);",
         "        if (j != 1)\n"
         "          issue_pv<HDP, BN>(acc, pa,\n"
         "                            vs + R::stage(j - 1) * KT::kBytes);"),
    ]),
    # The bf16 two-pass kernel restarts the ring's tile counter for pass 2,
    # in the producer and the consumers alike: pass 2 then waits on the
    # phases of pass 1's tiles.
    "race-ring-restarts": ("flash_probe.cu", "race", [
        ("  const int p2 = nk;  // pass 2's first tile on the ring",
         "  const int p2 = 0;  // pass 2's first tile on the ring"),
    ]),
    # v4's consumer warpgroups stop at their causal diagonal: v4 computes
    # v3, the same o by another formulation.
    "v4-skips-above-diagonal": ("flash_probe.cu", "poison", [
        ("    const int kend_wg = skip ? min(t, r.r0 + 64) : t;",
         "    const int kend_wg = causal ? min(t, r.r0 + 64) : t;"),
    ]),
    # b2's dq pass (K1b's with the caller's delta) reads the delta of the
    # row after each of its rows (the last row's own).
    "b2-dq-delta-row-off": ("flash_bwd.cu", "b2", [
        ("        dl[h] = rows[h] < t ? delta[base + rows[h]] : 0.f;",
         "        dl[h] = rows[h] < t ? delta[base + min(rows[h] + 1, t - 1)]"
         " : 0.f;"),
    ]),
    # v2 on K1f's kernel masks its edge tiles past the first at the columns
    # of K1f's 128-key tiles: wrong at block 64 only.
    "v2-edge-128-key-columns": ("flash_fwd.cu", "v2", [
        ("        softmax_tile<kS>(s, m, l, corr, j * BN, t, causal, edge(j), "
         "rows,",
         "        softmax_tile<kS>(s, m, l, corr, j * kWgBN, t, causal, "
         "edge(j), rows,"),
    ]),
    # K4 reads the third table's rows from the first table.
    "k4-table-2-reads-table-0": ("embedding_rows.cu", "k4", [
        ("  return reinterpret_cast<const V*>(p.table[t]) + (size_t)row * cols;",
         "  return reinterpret_cast<const V*>(p.table[t == 2 ? 0 : t]) +\n"
         "         (size_t)row * cols;"),
    ]),
    # K3's row groups merge equal maxima to the larger index.
    "k3-merge-prefers-larger-index": ("softmax_xent.cu", "k3", [
        ("const bool take = om > mx || (om == mx && oi < ix);",
         "const bool take = om > mx || (om == mx && oi > ix);"),
    ]),
    # K3's row groups: a lane drops its last vector of the row when V is
    # not a multiple of the group's stride (lanes x vector width).
    "k3-lane-drops-last-vector": ("softmax_xent.cu", "k3", [
        ("    const bool in = c < v;  // the lane's vector k lies in the row",
         "    const bool in = c < v && (v % (L * W) == 0 || c + L * W < v);"),
    ]),
    # K3's row-group backward drops the one-hot term where the label lies
    # in a lane's second vector.
    "k3-bwd-drops-second-vector-onehot": ("softmax_xent.cu", "k3", [
        ("r[i] = expf(r[i] - ls) * g - (c + e == lab ? gn : 0.f);",
         "r[i] = expf(r[i] - ls) * g - (c + e == lab && k != 1 ? gn : 0.f);"),
    ]),
    # K6's merge gives the last non-empty split (the one that holds key
    # lengths[b] - 1) weight 0.
    "k6-merge-skips-last-split": ("flash_decode.cu", "k6", [
        ("      const float c = expf(mm - mn), wt = expf(mi - mn);",
         "      const float c = expf(mm - mn),\n"
         "                  wt = i * chunk < len && (i + 1) * chunk >= len\n"
         "                           ? 0.f : expf(mi - mn);"),
    ]),
}
#: The cases (shape, dtype, the entry points: for
#: ``chip_smoke._flash_parts`` the kernel pair, ``stream`` K1s/K1sb or
#: ``k1`` K1f/K1b, all causal and against the plain versions; ``decode``
#: K6 at a cache shape of ``chip_smoke.DECODE_CASES``) that each group of
#: mutants is held at: the f32 K1s/K1sb as phase 12 holds them; K1f as
#: phase 1 does at the 2k training and 8k long-context shapes, and through
#: K1s's entry at 8k and 32k, the bf16 streamed forward; K1b's wgmma pair
#: there through K1b's entry and at 8k and 32k through K1sb's, the bf16
#: streamed backward; K6 at phase 1's two timed cases; the bf16 two-pass
#: kernel at ``chip_smoke.PROBE_WRAP`` and the 2k race shape (``race-*``:
#: v3 and v4 at both blocks by K1f's rule, causal or not) and with a NaN
#: at the last key (``poison``: ``chip_smoke._probe_poison``); the bf16 v2
#: and b2 (``v2``, ``b2``: :func:`_row_state_parts`) at the 2k race shape
#: and at hd 128 over 640 rows, causal; K4 (``gather``:
#: :func:`_gather_parts`) at tables of (R, D) = the DLRM shape and D = 65.
MUTANT_CASES = {
    "stream": (((2, 8, 1024, 64), "float32", "stream"),
               ((1, 4, 1024, 128), "float32", "stream")),
    "k1f": (((16, 8, 2048, 64), "bfloat16", "k1"),
            ((4, 8, 8192, 64), "bfloat16", "k1"),
            ((4, 8, 8192, 64), "bfloat16", "stream"),
            ((1, 8, 32768, 64), "bfloat16", "stream")),
    "k1b": (((16, 8, 2048, 64), "bfloat16", "k1"),
            ((4, 8, 8192, 64), "bfloat16", "k1"),
            ((4, 8, 8192, 64), "bfloat16", "stream"),
            ((1, 8, 32768, 64), "bfloat16", "stream")),
    "k6": (((8, 128, 8, 64), "float32", "decode"),
           ((8, 128, 8, 64), "bfloat16", "decode"),
           ((4, 4096, 8, 64), "float32", "decode"),
           ((4, 4096, 8, 64), "bfloat16", "decode")),
    "race": (((1, 2, 640, 128), "bfloat16", "race-causal"),
             ((1, 2, 450, 64), "bfloat16", "race-full"),
             ((16, 8, 2048, 64), "bfloat16", "race-causal")),
    "poison": (((1, 2, 640, 128), "bfloat16", "poison"),
               ((16, 8, 2048, 64), "bfloat16", "poison")),
    "v2": (((16, 8, 2048, 64), "bfloat16", "v2"),
           ((1, 2, 640, 128), "bfloat16", "v2")),
    "b2": (((16, 8, 2048, 64), "bfloat16", "b2"),
           ((1, 2, 640, 128), "bfloat16", "b2")),
    "k4": (((8_000_000, 64), "float32", "gather"),
           ((100_000, 65), "float32", "gather")),
    "k3": (((2048, 1000), "bfloat16", "xent"),
           ((2048, 1001), "float32", "xent")),
}
#: Groups whose cases each run in a child process (``--case``).
CHILD_GROUPS = ("race", "poison")


def _two_pass_parts(cs, kernels, probe, q, k, v, causal) -> dict:
    """v3 and v4 at every block against the plain version (one head at a
    time) by K1f's rule (``chip_smoke.TOL_ELEM["fwd"]``): {"v3 b64", ...:
    worst element ratio, above 1 fails}."""
    with torch.no_grad():
        fwd = lambda c: cs._per_row(
            lambda x, y, z: kernels.flash_attention_lse_plain(x, y, z,
                                                              causal),
            q, k, c, heads=True)[0]
        po, mass = fwd(v), fwd(v.abs())
        rule = cs.TOL_ELEM["fwd"][cs._dtype_name(q.dtype)]
        return {f"{name} b{block}": cs._close(fn(q, k, v, causal, block), po,
                                              mass, *rule)
                for name, fn in (("v3", probe.flash_fwd_two_pass),
                                 ("v4", probe.flash_fwd_full_row))
                for block in probe.PROBE_BLOCKS}


def _row_state_parts(cs, kernels, probe, pair, q, k, v, do, g_lse) -> dict:
    """The race's bf16 v2 (``pair`` "v2": at block 64, by K1f's rule
    ``chip_smoke.TOL_ELEM["fwd"]``) or b2 ("b2": at both blocks, from the
    plain forward's lse and ``delta = rowsum(o do) - g_lse``, by
    ``TOL_ELEM["stream_bwd"]``) against the plain versions one head at a
    time, causal: {part: worst element ratio, above 1 fails}."""
    with torch.no_grad():
        fwd = lambda c: cs._per_row(
            lambda x, y, z: kernels.flash_attention_lse_plain(x, y, z, True),
            q, k, c, heads=True)
        po, plse = fwd(v)
        if pair == "v2":
            o = probe.flash_fwd_row_state(q, k, v, True, 64)
            return {"v2 b64 o": cs._close(o, po, fwd(v.abs())[0],
                                          *cs.TOL_ELEM["fwd"]["bfloat16"])}
        delta = (po.float() * do.float()).sum(dim=-1) - g_lse
        want = cs._per_row(
            lambda *x: kernels.flash_attention_lse_bwd_plain(*x, True),
            q, k, v, po, plse, do, g_lse, heads=True)
        masses = cs._flash_bwd_mass(q, k, v, po, plse, do, g_lse, True)
        tops = cs._flash_bwd_top(q, k, v, po, plse, do, g_lse, True)
        rule = cs.TOL_ELEM["stream_bwd"]["bfloat16"]
        parts = {}
        for block in probe.PROBE_BLOCKS:
            got = probe.flash_bwd_row_state(q, k, v, do, plse, delta, True,
                                            block)
            for key, a, w, m, tp in zip(("dq", "dk", "dv"), got, want,
                                        masses, tops):
                parts[f"b2 b{block} {key}"] = cs._close(a, w, m, rule[0],
                                                        rule[1], tp, rule[2])
        return parts


def _gather_parts(kernels, table, ids) -> dict:
    """K4 through ``gather_rows`` (one table) and ``gather_rows_multi``
    (three different tables) against the plain
    versions bit for bit: {part: 0 when every bit agrees, else inf}."""
    tables = (table, table.neg(), table * 0.5)
    pairs = [("one table", kernels.gather_rows(table, ids),
              kernels.gather_rows_plain(table, ids))]
    pairs += [(f"table {k} of 3", got, want) for k, (got, want) in enumerate(
        zip(kernels.gather_rows_multi(tables, ids),
            kernels.gather_rows_multi_plain(tables, ids)))]
    torch.cuda.synchronize()
    return {name: 0.0 if torch.equal(got.view(torch.int32),
                                     want.view(torch.int32)) else math.inf
            for name, got, want in pairs}


def _xent_inputs(cs, g, shape, dt):
    """K3's mutant inputs: ``chip_smoke._xent_inputs`` (planted ties where
    the forms split a row, labels at the row's edges, in a warp lane's
    second vector and one out of range), the nll cotangent 1 / N and a
    random lse cotangent."""
    n, v = shape
    x, labels, _ = cs._xent_inputs(torch, g, n, v, dt)
    return (x, labels, torch.full((n,), 1.0 / n, device="cuda"),
            torch.randn((n,), generator=g, device="cuda"))


def _xent_parts(cs, kernels, x, labels, g_nll, g_lse) -> dict:
    """K3's row groups, where the planted faults lie, against the plain
    versions (``chip_smoke._xent_hold``): nll and lse as shares of
    ``TOL_XENT``, dlogits of ``TOL_XENT_BWD``'s element rule, pred 0 when
    exact, else inf; above 1 fails."""
    errs, _ = cs._xent_hold(torch, kernels, x, labels, g_nll, g_lse, "rows")
    ratio = lambda e: e if math.isfinite(e) else math.inf
    return {"nll": ratio(errs["nll"] / cs.TOL_XENT),
            "lse": ratio(errs["lse"] / cs.TOL_XENT),
            "dlogits": ratio(errs["dlogits"]),
            "pred": 0.0 if errs["pred"] == 0 else math.inf}


def case(root: str, group: str, index: int) -> int:
    """Case ``index`` of a child group in this process, on the kernels
    built from ``root``'s ``csrc`` (``-``: this checkout's): prints ``CASE
    {part: worst element ratio}`` (or ``{"error": ...}`` when a launch
    fails) and returns 0 (1 on an error)."""
    import chip_smoke as cs
    from flexflow_torch.ops import kernels
    from flexflow_torch.ops import probe_kernels as probe

    if root != "-":
        kernels._SRC_DIR = os.path.join(root, "csrc")
        kernels._BUILD_DIR = os.path.join(root, "build")
    shape, dt, pair = MUTANT_CASES[group][index]
    g = torch.Generator(device="cuda").manual_seed(40 + index)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               .to(getattr(torch, dt)) for _ in range(3))
    try:
        if pair == "poison":
            calls = {fn.__name__: 0 for fn in probe.PROBE_KERNELS}
            parts = {f"{key} b{block}": val for block in probe.PROBE_BLOCKS
                     for key, val in cs._probe_poison(
                         torch, kernels, probe, q, k, v, block,
                         calls).items()}
        else:
            parts = _two_pass_parts(cs, kernels, probe, q, k, v,
                                    pair == "race-causal")
        torch.cuda.synchronize()
    except RuntimeError as err:  # a trap of the ring's wait, a bad launch
        print("CASE " + json.dumps({"error": str(err)[:300]}), flush=True)
        return 1
    print("CASE " + json.dumps(parts), flush=True)
    return 0


def _child_case(root: str, group: str, index: int) -> dict:
    """:func:`case` in a child process; a child that prints no result
    gives ``{"error": ...}``."""
    cmd = [sys.executable, "-m", "flexflow_torch.tools.stream_numerics",
           "--case", root, group, str(index)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    except subprocess.TimeoutExpired:
        return {"error": "no result within 900 s"}
    for line in p.stdout.splitlines():
        if line.startswith("CASE "):
            return json.loads(line[len("CASE "):])
    return {"error": f"exit {p.returncode}: {p.stderr[-300:]}"}


def _variant_dir(kernels, name: str, source: str, edits) -> str:
    """A copy of csrc/ under ``_build/mutants/<name>`` with the (old, new)
    ``edits`` made to ``source`` (each ``old`` must occur once)."""
    root = os.path.join(kernels._BUILD_DIR, "mutants", name)
    src = os.path.join(root, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(kernels._SRC_DIR, src)
    path = os.path.join(src, source)
    with open(path) as fh:
        text = fh.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} found "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    return root


def mutants(kernels, groups=tuple(MUTANT_CASES)) -> list:
    """Holds the unmutated kernels and every mutant of ``groups`` (of
    ``MUTANT_CASES``) at its cases; returns what went wrong (an unmutated
    case that fails, a mutant case that passes)."""
    import chip_smoke as cs
    from flexflow_torch.ops import probe_kernels as probe

    g = torch.Generator(device="cuda").manual_seed(40)
    lengths = dict(cs.DECODE_CASES)
    inputs = {}

    def randn(shape, dt="float32"):
        x = torch.randn(shape, generator=g, device="cuda")
        return x.to(getattr(torch, dt))

    for group in groups:
        for shape, dt, pair in MUTANT_CASES[group]:
            if group in CHILD_GROUPS or (shape, dt) in inputs:
                continue
            if pair == "xent":
                inputs[shape, dt] = _xent_inputs(cs, g, shape, dt)
            elif pair == "gather":  # 2048 ids, a few out of range
                ids = torch.randint(0, shape[0], (2048,), generator=g,
                                    device="cuda")
                ids[::97] = -1
                inputs[shape, dt] = (randn(shape), ids)
            elif pair == "decode":
                B, S, h, hd = shape
                inputs[shape, dt] = (
                    randn((B, h, hd), dt), randn(shape, dt), randn(shape, dt),
                    torch.tensor(lengths[shape], dtype=torch.int32,
                                 device="cuda"))
            else:
                inputs[shape, dt] = [randn(shape, dt) for _ in range(4)] + [
                    randn(shape[:3])]
    real = (kernels._SRC_DIR, kernels._BUILD_DIR)
    runs = [(None, group) for group in groups]
    runs += [(name, MUTANTS[name][1]) for name in MUTANTS
             if MUTANTS[name][1] in groups]
    wrong = []
    for name, group in runs:
        lib = None
        try:
            if name is not None:
                source, _, edits = MUTANTS[name]
                lib = source[:-len(".cu")]
                root = _variant_dir(kernels, name, source, edits)
                kernels._libs.pop(lib, None)
                kernels._SRC_DIR = os.path.join(root, "csrc")
                kernels._BUILD_DIR = os.path.join(root, "build")
            for index, (shape, dt, pair) in enumerate(MUTANT_CASES[group]):
                if group in CHILD_GROUPS:
                    parts = _child_case(root if name else "-", group, index)
                elif pair == "decode":
                    q, ck, cv, lens = inputs[shape, dt]
                    o = kernels.flash_decode(q, ck, cv, lens)
                    po = kernels.flash_decode_plain(q, ck, cv, lens)
                    parts = {"o": cs._decode_close(kernels, q, ck, cv, lens,
                                                   o, po)}
                elif pair == "gather":
                    parts = _gather_parts(kernels, *inputs[shape, dt])
                elif pair == "xent":
                    parts = _xent_parts(cs, kernels, *inputs[shape, dt])
                elif pair in ("v2", "b2"):
                    q, k, v, do, g_lse = inputs[shape, dt]
                    parts = _row_state_parts(cs, kernels, probe, pair, q, k,
                                             v, do, g_lse)
                else:
                    q, k, v, do, g_lse = inputs[shape, dt]
                    parts, _ = cs._flash_parts(torch, kernels, q, k, v, do,
                                               g_lse, True, pair)
                fails = "error" in parts or max(parts.values()) > 1.0
                if fails != (name is not None):
                    wrong.append(f"{name or 'unmutated'} {shape} {dt} {pair}")
                _line("mutants", f"{name or 'unmutated'} ({group}) {shape} "
                      f"{dt} through {pair}: " + ", ".join(
                          f"{k} {v:.3g}" if isinstance(v, float) else
                          f"{k} {v}" for k, v in parts.items())
                      + " of the element tolerance: "
                      + ("FAILS" if fails else "passes"))
                torch.cuda.empty_cache()
        finally:
            kernels._SRC_DIR, kernels._BUILD_DIR = real
            if lib is not None:
                kernels._libs.pop(lib, None)
    shutil.rmtree(os.path.join(real[1], "mutants"), ignore_errors=True)
    _line("mutants", "every unmutated case passes and every mutant fails at "
          "every case" if not wrong else f"WRONG: {wrong}")
    return wrong


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("stream_numerics: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--case"]:
        return case(argv[1], argv[2], int(argv[3]))
    from flexflow_torch.ops import kernels

    from flexflow_torch.tools.probe_common import card

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    kernels.build()
    if argv[:2] == ["--mutants", "--groups"]:
        return 1 if mutants(kernels, tuple(argv[2].split(","))) else 0
    for hd in kernels._STREAM_HEAD_DIMS:
        scores(kernels, hd)
    for hd in kernels._STREAM_HEAD_DIMS:
        flips(kernels, hd)
    for shape in ((16, 8, 2048, 64), (4, 8, 8192, 64)):
        f64_hold(kernels, shape)
        torch.cuda.empty_cache()
    if "--mutants" in argv and mutants(kernels):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
