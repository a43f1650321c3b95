"""This checkout's K4, K6, bf16 K1s, K1f, K1b, the race's bf16 v2, v3, v4
and b2, and K3 beside another checkout's, in one process on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m flexflow_torch.tools.kernel_race --against DIR [--only PARTS]

``PARTS`` is a comma-separated subset of ``PARTS`` (gather, decode,
streamed, race, xent, xent-sweep); all run by default.

``DIR`` is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Its
``flexflow_torch/ops/kernels.py`` is loaded under another module name and
builds its own libraries from ``DIR``'s sources into ``DIR``'s build
directory.  Each kernel is then timed against the other checkout's in
turns (``chip_smoke._pair_ms``: theirs, ours, ours, theirs, the median
device time of 20 runs each), beside one PyTorch call for the same
function and the bound, at the main path's shapes:

- K4 (``gather_rows``, and ``gather_rows_multi`` over three tables
  against three of the other checkout's launches) at the DLRM shape
  ((8 x 10^6, 64) f32, 2048 uniform ids), three ways in turns: one launch
  between events (``chip_smoke._pair_ms``), and the chain slope
  (``chip_smoke._chain_ms``) warm (the same ids at every call) and cold (a
  new id vector at every call, ``chip_smoke.GATHER_COLD`` of them: rows
  from HBM); beside ``F.embedding`` and the launch floor (the chain slope
  of ``torch.cuda._sleep(0)``); every output bit-identical to the other
  checkout's first;
- K6 (``flash_decode``) at phase 1's two timed cases
  (``chip_smoke.DECODE_TIMED``), f32 and bf16, with this checkout's split
  count, beside SDPA's masked call;
- K1s (``flash_attention_lse_streamed``) at the long-context shapes (4, 8,
  8192, 64) and (1, 8, 32768, 64) bf16 causal, beside SDPA;
- K1f (``flash_attention_lse``) and the race's v2
  (``flash_fwd_row_state``), v3 (``flash_fwd_two_pass``) and v4
  (``flash_fwd_full_row``) of ``flexflow_torch/ops/probe_kernels.py`` at
  the race's shapes (``chip_smoke.PROBE_RACE``: (16, 8, 2048, 64) and (4,
  8, 8192, 64) bf16 causal), the variants at both blocks, beside SDPA,
  the bound of the causal function and the bound of the products each
  variant does (``chip_smoke.race_products``);
- K1b (``flash_attention_lse_bwd``) and the race's b2
  (``flash_bwd_row_state``, from the race's ``delta = rowsum(o do) -
  g_lse``) at the same shapes, b2 at both blocks, beside SDPA's backward
  and the backward's bound.
  The other checkout's ``probe_kernels.py`` is loaded bound to its own
  ``kernels.py``;
- K3 (``softmax_xent``, ``softmax_xent_bwd``) at AlexNet's (2048, 1000)
  and the LM's (32768, 32768) bf16, by one launch and by chain slope,
  beside ``F.cross_entropy`` (and its backward), the bound and the launch
  floor; then the sweep: chain slopes of this checkout's two forms and
  the other checkout's kernel at N = 2048 over ``XENT_SWEEP`` classes in
  bf16 (where the forms cross: ``kernels._XENT_ROWS_MAX_V``) and f32.

Before the times, each pair is held together: K6's outputs by
``chip_smoke._decode_close`` against the plain version on both sides;
K1s's ``o`` and ``lse``, and v2's, v3's and v4's ``o``, by twice K1f's
element rule against each other; b2's ``dq``, ``dk`` and ``dv`` by twice
K1b's (``chip_smoke.TOL_ELEM["stream_bwd"]``); K1f's ``o`` and ``lse`` and
K1b's ``dq``, ``dk`` and ``dv`` must be bit-identical; K3's nll and lse
within ``chip_smoke.TOL_XENT``, its dlogits (from one lse) by
``TOL_XENT_BWD``'s element rule and pred exactly (the sums run in another
order, so the bits may differ).  Whether this
checkout's v2 at block 128 gives K1f's ``o`` bit for bit is printed too.
The card's name and power limit come first.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch


def _other_kernels(root: str):
    """``root``'s ``flexflow_torch/ops/kernels.py`` as its own module."""
    path = os.path.join(root, "flexflow_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _other_probe(root: str, theirs):
    """``root``'s ``flexflow_torch/ops/probe_kernels.py`` as its own
    module, bound to ``theirs`` (``root``'s ``kernels.py``, from
    :func:`_other_kernels`) in place of this checkout's."""
    import flexflow_torch.ops as ops
    from flexflow_torch.ops import kernels as ours

    name = "flexflow_torch.ops.kernels"
    path = os.path.join(root, "flexflow_torch", "ops", "probe_kernels.py")
    spec = importlib.util.spec_from_file_location("other_probe_kernels",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = ops.kernels = theirs
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules[name] = ops.kernels = ours
    return mod


def decode(cs, ours, theirs, F) -> None:
    g = torch.Generator(device="cuda").manual_seed(50)
    lengths = dict(cs.DECODE_CASES)
    for shape in cs.DECODE_TIMED:
        B, S, h, hd = shape
        lens = torch.tensor(lengths[shape], dtype=torch.int32, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((B, h, hd), generator=g, device="cuda").to(dt)
            ck, cv = (torch.randn(shape, generator=g, device="cuda").to(dt)
                      for _ in range(2))
            po = ours.flash_decode_plain(q, ck, cv, lens)
            held = {name: cs._decode_close(ours, q, ck, cv, lens,
                                           mod.flash_decode(q, ck, cv, lens),
                                           po)
                    for name, mod in (("ours", ours), ("theirs", theirs))}
            cs._check(max(held.values()) <= 1.0,
                      f"flash_decode {shape}: {held} of the tolerance")
            t_theirs, t_ours = cs._pair_ms(
                lambda: theirs.flash_decode(q, ck, cv, lens),
                lambda: ours.flash_decode(q, ck, cv, lens))
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            t_lib = cs._device_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
                attn_mask=mask))
            keys = sum(lengths[shape])
            size = q.element_size()
            bound, by = cs._bound_ms(
                2 * keys * h * hd * size + 2 * B * h * hd * size + 4 * B,
                4 * h * hd * keys, cs._dtype_name(dt))
            print(f"[kernel-race] flash_decode {shape} {cs._dtype_name(dt)}: "
                  f"ours ({ours.decode_splits(B, S, h)} splits) {t_ours:.6f} "
                  f"ms, theirs {t_theirs:.6f} ms ({t_theirs / t_ours:.2f}x), "
                  f"sdpa masked {t_lib:.6f}, bound {bound:.6f} by {by}; "
                  f"elements {held['ours']:.3g} / {held['theirs']:.3g} of "
                  f"the tolerance", flush=True)


def streamed(cs, ours, theirs, F) -> None:
    g = torch.Generator(device="cuda").manual_seed(51)
    bf16 = torch.bfloat16
    for shape in ((4, 8, 8192, 64), (1, 8, 32768, 64)):
        b, h, t, hd = shape
        reps = 5 if t >= 32768 else 20
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(bf16)
                   for _ in range(3))
        with torch.no_grad():
            o, lse = ours.flash_attention_lse_streamed(q, k, v, True)
            to, tlse = theirs.flash_attention_lse_streamed(q, k, v, True)
            mass = ours.flash_attention_lse(q, k, v.abs(), True)[0]
            held = cs._close(o, to, mass, *(2 * x for x in
                                            cs.TOL_ELEM["fwd"]["bfloat16"]))
            e_lse = (lse - tlse).abs().max().item()
            cs._check(held <= 1.0 and e_lse <= cs.TOL_LSE,
                      f"K1s {shape}: {held} of twice the element tolerance, "
                      f"lse err {e_lse}")
            del o, lse, to, tlse, mass
            t_theirs, t_ours = cs._pair_ms(
                lambda: theirs.flash_attention_lse_streamed(q, k, v, True),
                lambda: ours.flash_attention_lse_streamed(q, k, v, True),
                reps)
            t_lib = cs._device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), reps)
        flops = 4 * b * h * hd * t * (t + 1) // 2
        bound, by = cs._bound_ms(4 * b * h * t * hd * 2 + b * h * t * 4,
                                 flops, "bfloat16")
        pct = 100 * flops / (t_ours * 1e-3) / cs.PEAK_FLOPS["bfloat16"]
        print(f"[kernel-race] flash_attention_lse_streamed {shape} bf16 "
              f"causal: ours {t_ours:.6f} ms ({pct:.1f}% of 989 TFLOP/s), "
              f"theirs {t_theirs:.6f} ms ({t_theirs / t_ours:.2f}x), sdpa "
              f"{t_lib:.6f}, bound {bound:.6f} by {by}; o {held:.3g} of "
              f"twice the element tolerance, lse err {e_lse:.3g}",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def race(cs, ours, theirs, ours_probe, theirs_probe, F) -> None:
    g = torch.Generator(device="cuda").manual_seed(52)
    rtol, arel = cs.TOL_ELEM["fwd"]["bfloat16"]
    for shape in cs.PROBE_RACE:
        b, h, t, hd = shape
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        pairs = t * (t + 1) // 2
        nbytes = 4 * b * h * t * hd * 2
        flops = 4 * b * h * hd * pairs
        bound, by = cs._bound_ms(nbytes, flops, "bfloat16")
        with torch.no_grad():
            t_lib = cs._device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            o, lse = ours.flash_attention_lse(q, k, v, True)
            same = all(torch.equal(a, c) for a, c in zip(
                (o, lse), theirs.flash_attention_lse(q, k, v, True)))
            cs._check(same, f"K1f {shape}: not bit-identical to the other "
                      f"checkout's")
            t_theirs, t_ours = cs._pair_ms(
                lambda: theirs.flash_attention_lse(q, k, v, True),
                lambda: ours.flash_attention_lse(q, k, v, True))
            print(f"[kernel-race] flash_attention_lse {shape} bf16 causal: "
                  f"ours {t_ours:.6f} ms, theirs {t_theirs:.6f} ms "
                  f"({t_theirs / t_ours:.3f}x), bit-identical; sdpa "
                  f"{t_lib:.6f}, bound {bound:.6f} by {by}", flush=True)
            v2_is_k1f = torch.equal(
                ours_probe.flash_fwd_row_state(q, k, v, True, 128), o)
            mass = ours.flash_attention_lse(q, k, v.abs(), True)[0]
            for name in ("flash_fwd_row_state", "flash_fwd_two_pass",
                         "flash_fwd_full_row"):
                done, _ = cs._bound_ms(
                    nbytes, cs.race_products(name, t) * flops, "bfloat16")
                mine, other = (getattr(p, name)
                               for p in (ours_probe, theirs_probe))
                for block in ours_probe.PROBE_BLOCKS:
                    held = cs._close(mine(q, k, v, True, block),
                                     other(q, k, v, True, block), mass,
                                     2 * rtol, 2 * arel)
                    cs._check(held <= 1.0, f"{name} {shape} block {block}: "
                              f"{held} of twice the element tolerance")
                    t_theirs, t_ours = cs._pair_ms(
                        lambda: other(q, k, v, True, block),
                        lambda: mine(q, k, v, True, block))
                    print(f"[kernel-race] {name} {shape} bf16 causal block "
                          f"{block}: ours {t_ours:.6f} ms, theirs "
                          f"{t_theirs:.6f} ms ({t_theirs / t_ours:.2f}x), "
                          f"sdpa {t_lib:.6f}, bound {bound:.6f} by {by} (the "
                          f"causal function), {done:.6f} (the products it "
                          f"does); o {held:.3g} of twice the element "
                          f"tolerance", flush=True)
            print(f"[kernel-race] flash_fwd_row_state {shape} block 128: o "
                  f"{'is' if v2_is_k1f else 'is NOT'} K1f's bit for bit",
                  flush=True)
            del mass
            do = torch.randn(shape, generator=g, device="cuda").to(q.dtype)
            g_lse = torch.randn(lse.shape, generator=g, device="cuda")
            bwd = lambda m: m.flash_attention_lse_bwd(q, k, v, o, lse, do,
                                                      g_lse, True)
            same = all(torch.equal(a, c) for a, c in zip(bwd(ours),
                                                         bwd(theirs)))
            cs._check(same, f"K1b {shape}: not bit-identical to the other "
                      f"checkout's")
            t_theirs, t_ours = cs._pair_ms(lambda: bwd(theirs),
                                           lambda: bwd(ours))
        qs, ks, vs = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        sd = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        t_lib = cs._device_ms(lambda: torch.autograd.grad(
            sd, (qs, ks, vs), do, retain_graph=True))
        del qs, ks, vs, sd
        bound, by = cs._bound_ms(7 * b * h * t * hd * 2 + 2 * b * h * t * 4,
                                 10 * b * h * hd * pairs, "bfloat16")
        print(f"[kernel-race] flash_attention_lse_bwd {shape} bf16 "
              f"causal: ours {t_ours:.6f} ms, theirs {t_theirs:.6f} ms "
              f"({t_theirs / t_ours:.3f}x), bit-identical; sdpa backward "
              f"{t_lib:.6f}, bound {bound:.6f} by {by}", flush=True)
        with torch.no_grad():
            delta = (o.float() * do.float()).sum(dim=-1) - g_lse
            masses = cs._flash_bwd_mass(q, k, v, o, lse, do, g_lse, True)
            tops = cs._flash_bwd_top(q, k, v, o, lse, do, g_lse, True)
            brtol, barel, batop = cs.TOL_ELEM["stream_bwd"]["bfloat16"]
            mine, other = (p.flash_bwd_row_state
                           for p in (ours_probe, theirs_probe))
            for block in ours_probe.PROBE_BLOCKS:
                call = lambda fn: fn(q, k, v, do, lse, delta, True, block)
                held = max(cs._close(a, c, m, 2 * brtol, 2 * barel, tp,
                                     2 * batop)
                           for a, c, m, tp in zip(call(mine), call(other),
                                                  masses, tops))
                cs._check(held <= 1.0, f"flash_bwd_row_state {shape} block "
                          f"{block}: {held} of twice the element tolerance")
                t_theirs, t_ours = cs._pair_ms(lambda: call(other),
                                               lambda: call(mine))
                print(f"[kernel-race] flash_bwd_row_state {shape} bf16 "
                      f"causal block {block}: ours {t_ours:.6f} ms, theirs "
                      f"{t_theirs:.6f} ms ({t_theirs / t_ours:.2f}x), sdpa "
                      f"backward {t_lib:.6f}, bound {bound:.6f} by {by}; "
                      f"dq, dk, dv {held:.3g} of twice the element "
                      f"tolerance", flush=True)
        del q, k, v, o, lse, do, g_lse, delta, masses, tops
        torch.cuda.empty_cache()


def _pair_chain(cs, a, b):
    """Chain-slope ms (``chip_smoke._chain_ms``) of ``a(i)`` and ``b(i)``
    timed in turns (a, b, b, a), each the mean of its two."""
    ta = cs._chain_ms(a)
    tb = (cs._chain_ms(b) + cs._chain_ms(b)) / 2
    return (ta + cs._chain_ms(a)) / 2, tb


def gather(cs, ours, theirs, F) -> None:
    """K4 at the DLRM shape, one table and three, against the other
    checkout's K4 (three of its launches for three tables) by one launch
    and by the chain slope warm and cold, beside ``F.embedding`` and the
    launch floor; every output bit-identical to the other checkout's
    first."""
    g = torch.Generator(device="cuda").manual_seed(53)
    c = cs.DLRM
    R, D, n = c["tables"] * c["vocab"], c["dim"], c["batch"] * c["tables"]
    table = torch.randn((R, D), generator=g, device="cuda")
    tables = (table, table.neg(), table * 0.5)
    ids = torch.randint(0, R, (n,), generator=g, device="cuda")
    cold = [torch.randint(0, R, (n,), generator=g, device="cuda")
            for _ in range(cs.GATHER_COLD)]
    turn = [0]

    def feed(kind):
        if kind == "warm":
            return ids
        turn[0] += 1
        return cold[turn[0] % len(cold)]

    mine = {1: lambda i: [ours.gather_rows(table, i)],
            3: lambda i: ours.gather_rows_multi(tables, i)}
    other = {k: (lambda i, k=k: [theirs.gather_rows(t, i)
                                 for t in tables[:k]]) for k in (1, 3)}
    floor = cs._chain_ms(lambda _: torch.cuda._sleep(0))
    lib = {kind: cs._chain_ms(lambda _, kind=kind: F.embedding(feed(kind),
                                                              table))
           for kind in ("warm", "cold")}
    lib1 = cs._device_ms(lambda: F.embedding(ids, table))
    print(f"[kernel-race] gather_rows: launch floor (chain slope of "
          f"torch.cuda._sleep(0)) {floor:.6f} ms; F.embedding "
          f"{lib1:.6f} single launch, {lib['warm']:.6f} warm, "
          f"{lib['cold']:.6f} cold", flush=True)
    for k in (1, 3):
        for i in (ids, cold[0]):
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(mine[k](i), other[k](i)))
            cs._check(same, f"gather_rows, {k} tables: not bit-identical to "
                      f"the other checkout's")
        for kind in ("single launch", "warm", "cold"):
            if kind == "single launch":
                t_theirs, t_ours = cs._pair_ms(lambda: other[k](ids),
                                               lambda: mine[k](ids))
            else:
                t_theirs, t_ours = _pair_chain(
                    cs, lambda _: other[k](feed(kind)),
                    lambda _: mine[k](feed(kind)))
            what = ("one table" if k == 1 else
                    "three tables (theirs: three launches)")
            print(f"[kernel-race] gather_rows (8000000, 64) 2048 ids, {what}, "
                  f"{kind}: ours {t_ours:.6f} ms, theirs {t_theirs:.6f} ms "
                  f"({t_theirs / t_ours:.2f}x), bit-identical", flush=True)
    del table, tables, cold
    torch.cuda.empty_cache()


def _xent_inputs(g, n: int, v: int, dtype=torch.bfloat16):
    """Logits (3 randn, in ``dtype``), int32 labels over every class, the
    nll cotangent 1 / n and a random lse cotangent."""
    x = (3.0 * torch.randn((n, v), generator=g, device="cuda")).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    gn = torch.full((n,), 1.0 / n, device="cuda")
    gl = torch.randn((n,), generator=g, device="cuda")
    return x, labels, gn, gl


def _xent_agree(cs, x, labels, gn, a, b, what: str) -> str:
    """Holds two K3 results ``(nll, lse, pred, dlogits)`` to each other:
    nll and lse within ``TOL_XENT``, dlogits by ``TOL_XENT_BWD``'s
    element rule, pred exact; returns the readings."""
    e_nll = (a[0] - b[0]).abs().max().item()
    e_lse = (a[1] - b[1]).abs().max().item()
    e_d = cs._xent_bwd_close(a[3], b[3], labels, gn,
                             cs.TOL_XENT_BWD[cs._dtype_name(x.dtype)])
    same = torch.equal(a[2], b[2])
    cs._check(e_nll <= cs.TOL_XENT and e_lse <= cs.TOL_XENT and e_d <= 1.0
              and same, f"{what}: nll err {e_nll}, lse err {e_lse}, dlogits "
              f"{e_d} of the element tolerance, pred equal: {same}")
    return (f"nll err {e_nll:.3g}, lse err {e_lse:.3g}, dlogits {e_d:.3g} of "
            f"the element tolerance, pred equal")


def xent(cs, ours, theirs, F) -> None:
    """K3 forward and backward at AlexNet's (2048, 1000) and the LM's
    (32768, 32768) bf16 against the other checkout's, by one launch and
    by chain slope, in turns, beside ``F.cross_entropy`` and the launch
    floor; both sides' outputs held to each other first (the backward
    from the same lse)."""
    g = torch.Generator(device="cuda").manual_seed(54)
    floor = cs._chain_ms(lambda _: torch.cuda._sleep(0))
    print(f"[kernel-race] softmax_xent: launch floor (chain slope of "
          f"torch.cuda._sleep(0)) {floor:.6f} ms", flush=True)
    for n, v in ((2048, 1000), (32768, 32768)):
        x, labels, gn, gl = _xent_inputs(g, n, v)
        lse = ours.softmax_xent(x, labels)[1]
        out = {}
        for side, mod in (("ours", ours), ("theirs", theirs)):
            nll, lse_s, pred = mod.softmax_xent(x, labels)
            out[side] = (nll, lse_s, pred,
                         mod.softmax_xent_bwd(x, labels, lse, gn, gl))
        held = _xent_agree(cs, x, labels, gn, out["ours"], out["theirs"],
                           f"softmax_xent ({n}, {v})")
        del out
        form = cs._form_name(ours._xent_form(v))
        lab64 = labels.long()
        xr = x.detach().clone().requires_grad_(True)
        ce = F.cross_entropy(xr, lab64, reduction="none")
        gce = gn.to(ce.dtype)
        parts = {
            "softmax_xent": (
                lambda m: m.softmax_xent(x, labels),
                lambda: F.cross_entropy(x, lab64, reduction="none"),
                cs._bound_ms(n * v * 2 + 16 * n, 4 * n * v, "float32")),
            "softmax_xent_bwd": (
                lambda m: m.softmax_xent_bwd(x, labels, lse, gn, gl),
                lambda: torch.autograd.grad(ce, xr, gce, retain_graph=True),
                cs._bound_ms(2 * n * v * 2 + 16 * n, 4 * n * v, "float32")),
        }
        for name, (call, lib, (bound, by)) in parts.items():
            t_theirs, t_ours = cs._pair_ms(lambda: call(theirs),
                                           lambda: call(ours))
            c_theirs, c_ours = _pair_chain(cs, lambda _: call(theirs),
                                           lambda _: call(ours))
            t_lib, c_lib = cs._device_ms(lib), cs._chain_ms(lambda _: lib())
            print(f"[kernel-race] {name} ({n}, {v}) bf16, ours {form}: one "
                  f"launch ours {t_ours:.6f} ms, theirs {t_theirs:.6f} "
                  f"({t_theirs / t_ours:.3f}x); chain slope ours "
                  f"{c_ours:.6f}, theirs {c_theirs:.6f} "
                  f"({c_theirs / c_ours:.3f}x); F.cross_entropy"
                  f"{' backward' if 'bwd' in name else ''} {t_lib:.6f} / "
                  f"{c_lib:.6f}; bound {bound:.6f} by {by}; floor "
                  f"{floor:.6f}; {held}", flush=True)
        del x, labels, gn, gl, lse, xr, ce, gce
        torch.cuda.empty_cache()


#: The sweep's class counts: where K3's two forms cross.
XENT_SWEEP = (10, 100, 1000, 2048, 4096, 8192, 16384, 32768)


def xent_sweep(cs, ours, theirs) -> None:
    """K3's chain slopes at N = 2048 over ``XENT_SWEEP`` in each of this
    checkout's forms (row groups, a CTA per row) and the other
    checkout's, in bf16 (the crossover's) and f32, each form held to the
    other checkout's outputs first; the chooser's form beside them."""
    g = torch.Generator(device="cuda").manual_seed(55)
    n = 2048
    for dt, v in ((dt, v) for dt in (torch.bfloat16, torch.float32)
                  for v in XENT_SWEEP):
        x, labels, gn, gl = _xent_inputs(g, n, v, dt)
        lse = theirs.softmax_xent(x, labels)[1]
        ref = theirs.softmax_xent(x, labels) + (
            theirs.softmax_xent_bwd(x, labels, lse, gn, gl),)
        calls = {"theirs": (lambda: theirs.softmax_xent(x, labels),
                            lambda: theirs.softmax_xent_bwd(x, labels, lse,
                                                            gn, gl))}
        for form in cs.XENT_FORMS:
            calls[form] = (
                lambda form=form: ours._xent_fwd(x, labels, form),
                lambda form=form: ours._xent_bwd(x, labels, lse, gn, gl,
                                                 form))
            _xent_agree(cs, x, labels, gn,
                        calls[form][0]() + (calls[form][1](),), ref,
                        f"softmax_xent ({n}, {v}) {dt} {form}")
        slopes = {side: [cs._chain_ms(lambda _: fn()) for fn in fns]
                  for side, fns in calls.items()}
        chosen = ours._xent_form(v).form
        print(f"[kernel-race] softmax_xent sweep ({n}, {v}) "
              f"{cs._dtype_name(dt)}, chain "
              f"slope fwd / bwd ms: " + ", ".join(
                  f"{side} {f:.6f} / {b:.6f}" for side, (f, b) in
                  slopes.items()) + f"; the chooser takes {chosen}",
              flush=True)
        del x, labels, gn, gl, lse, ref
    torch.cuda.empty_cache()


#: The parts of the race, in the order they run (``--only`` picks some).
PARTS = ("gather", "decode", "streamed", "race", "xent", "xent-sweep")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = PARTS
    if len(argv) == 4 and argv[2] == "--only":
        only = tuple(argv[3].split(","))
        argv = argv[:2]
    if (len(argv) != 2 or argv[0] != "--against"
            or not set(only) <= set(PARTS)):
        print(f"usage: python3 -m flexflow_torch.tools.kernel_race --against "
              f"DIR [--only PART[,PART]] (parts: {', '.join(PARTS)})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_race: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as cs
    from flexflow_torch.ops import kernels as ours
    from flexflow_torch.ops import probe_kernels as ours_probe
    from flexflow_torch.tools.probe_common import card

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    root = os.path.abspath(argv[1])
    theirs = _other_kernels(root)
    theirs_probe = _other_probe(root, theirs)
    libs = ("softmax_xent",)
    if not set(only) <= {"xent", "xent-sweep"}:
        libs += ("flash_fwd", "flash_bwd", "flash_stream", "flash_decode",
                 "flash_probe", "flash_probe_bwd", "embedding_rows")
    ours.build(libs)
    theirs.build(libs)
    runs = {
        "gather": lambda: gather(cs, ours, theirs, F),
        "decode": lambda: decode(cs, ours, theirs, F),
        "streamed": lambda: streamed(cs, ours, theirs, F),
        "race": lambda: race(cs, ours, theirs, ours_probe, theirs_probe, F),
        "xent": lambda: xent(cs, ours, theirs, F),
        "xent-sweep": lambda: xent_sweep(cs, ours, theirs),
    }
    for part in PARTS:
        if part in only:
            runs[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
