"""Shared scaffolding of the port's kernel races
(:mod:`flexflow_torch.tools.probe_flash_variants` and
:mod:`flexflow_torch.tools.probe_flash_bwd_variants`).

A race times each variant by the slope of a dependent chain: ``x = f(x)``
run ``n1`` and ``n2`` times, each length bracketed by CUDA events and
fenced by ``torch.cuda.synchronize()``, the best of ``reps`` runs per
length, and the per-iteration time the difference over ``n2 - n1``.  The
slope cancels what a chain pays once (the first launch's latency, the
host's lead before the card starts), retrying once and giving NaN rather
than a number when noise still swamps the signal.
"""

from __future__ import annotations

import sys

import torch

from flexflow_torch.ops.probe_kernels import PROBE_BLOCKS


def parse_dims_blocks(argv, default_dims=(16, 8, 2048, 64),
                      default_blocks=PROBE_BLOCKS):
    """``[b h t hd] [--blocks 64,128]`` with both flag forms; unknown
    flags, a wrong count of dims and a block the kernels do not
    instantiate are errors (a typo must not silently measure defaults)."""
    blocks = list(default_blocks)
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--blocks"):
            if "=" in a:
                val = a.split("=", 1)[1]
            elif i + 1 < len(argv):
                i += 1
                val = argv[i]
            else:
                sys.exit("--blocks expects a comma-separated list")
            blocks = [int(x) for x in val.split(",")]
        elif a.startswith("--"):
            sys.exit(f"unknown flag {a!r} (only --blocks is supported)")
        else:
            rest.append(a)
        i += 1
    if rest and len(rest) != 4:
        sys.exit(f"expected 4 positional dims (b h t hd), got {rest}")
    bad = [x for x in blocks if x not in PROBE_BLOCKS]
    if bad:
        sys.exit(f"blocks {bad} are not instantiated (the kernels take "
                 f"{', '.join(map(str, PROBE_BLOCKS))})")
    dims = tuple(int(x) for x in rest) if len(rest) == 4 else default_dims
    return dims, blocks


def chain_slope_ms(make_run, x0, n1, n2, reps=3):
    """Per-iteration ms on the card from the slope between two chain
    lengths.

    ``make_run(n)`` returns a callable of one argument that runs n
    dependent iterations ``x = f(x)``; ``x0`` seeds the chain.  Retries
    once on a non-positive slope, then returns NaN rather than garbage.
    """

    def timed(n):
        run = make_run(n)
        run(x0)  # warm: the first call may build and load its library
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(x0)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    for _ in range(2):
        ms = (timed(n2) - timed(n1)) / (n2 - n1)
        if ms > 0:
            return ms
    return float("nan")


#: Dense bf16 peak of one H100 SXM (NVIDIA's data sheet), the races' "%".
PEAK_BF16_FLOPS = 989e12


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip()


def run_race(variants, blocks, block_free, feed, flops, chain, timed):
    """Run and print one race.

    ``variants(block)`` gives ``{name: (fn, x0)}``: ``fn(x)`` returns a
    tuple of ``(bh, t, hd)`` outputs and ``x0`` is the operand the chain
    feeds back; ``feed(outs)`` makes the next one.  For each block, each
    variant (those in ``block_free`` at the first block only) is called
    once on ``x0``: its outputs' first 64 rows of the first head are held
    against the first variant's (the largest absolute difference), then,
    if ``timed``, it is timed by :func:`chain_slope_ms` over ``chain``
    lengths.  A ``ValueError`` (a kernel's gate) makes the row
    ``unsupported``: no other variant stands in.  Returns one dict per
    row: block, name, ms (None untimed), err, scale (the reference
    slice's largest magnitude), calls (of ``fn``) and unsupported."""
    rows, ref = [], None
    for block in blocks:
        for name, (fn, x0) in variants(block).items():
            if name in block_free and block != blocks[0]:
                continue
            row = dict(block=block, name=name, ms=None, err=None, scale=None,
                       calls=0, unsupported=None)
            rows.append(row)

            def counted(x, fn=fn, row=row):
                row["calls"] += 1
                return fn(x)

            head = f"block {block:4d} {name:10s}:"
            try:
                outs = counted(x0)
            except ValueError as e:
                row["unsupported"] = str(e)
                print(f"{head} unsupported: {e}", flush=True)
                continue
            got = torch.cat([o[0, :64].float() for o in outs])
            if ref is None:
                ref = got
            row["err"] = (got - ref).abs().max().item()
            row["scale"] = ref.abs().max().item()
            if not timed:
                print(f"{head} not measured (CPU) maxerr {row['err']:.3g}",
                      flush=True)
                continue

            def make_run(n, counted=counted):
                def run(x):
                    for _ in range(n):
                        x = feed(counted(x))
                    return x
                return run

            row["ms"] = chain_slope_ms(make_run, x0, *chain)
            pct = flops / (row["ms"] * 1e-3) / PEAK_BF16_FLOPS * 100
            print(f"{head} {row['ms']:9.4f} ms ({pct:5.2f}% of 989 TFLOP/s) "
                  f"maxerr {row['err']:.3g}", flush=True)
    return rows
