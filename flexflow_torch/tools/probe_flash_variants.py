"""The flash-forward variant race (P1) on the card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 -m flexflow_torch.tools.probe_flash_variants [b h t hd] [--blocks 64,128]

The port of ``tools/probe_flash_variants.py``: the same variants, keys and
report, on Hopper kernels.  Each computes ``o`` of causal softmax attention
on the same bf16 ``(b h, t, hd)`` inputs:

  v1_base     K1f, ``kernels.flash_attention_lse`` (the control)
  v2_lanes    the row state, ``probe_kernels.flash_fwd_row_state``
  v3_twopass  two passes, no corrections, ``flash_fwd_two_pass``
  v4_fullrow  one softmax over each whole masked row, ``flash_fwd_full_row``
  v5_sdpa     ``F.scaled_dot_product_attention``, the yardstick (the JAX
              race's ``v5_stock`` ran jax's own library kernel)
  v6_stream   K1s, ``kernels.flash_attention_lse_streamed``

For each block (the race kernels' key tile) it prints one row per variant:
the ms per call by :func:`probe_common.chain_slope_ms` over chains of 4
and 16 calls (each feeding its ``o`` back as ``q``), the share of the
989 TFLOP/s bf16 peak for ``2 b h t^2 hd`` FLOPs (the causal forward's two
products over half the square), and the largest error against ``v1_base``
over the first 64 rows of the first head.  v1, v5 and v6 take no block
and run at the first block only.  A variant whose gate refuses the shape
prints ``unsupported: <gate>``.  The card's name and power limit come
first.  Without a card it exits 2; ``main(argv, device="cpu")`` runs the
plain versions and checks the errors without timing anything.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from flexflow_torch.ops import kernels, probe_kernels
from flexflow_torch.tools.probe_common import (card, parse_dims_blocks,
                                               run_race)

#: Variants that take no block.
BLOCK_FREE = ("v1_base", "v5_sdpa", "v6_stream")
#: Chain lengths of the slope.
CHAIN = (4, 16)


def _unfold(fn):
    """``fn`` over ``(1, bh, t, hd)`` views of ``(bh, t, hd)`` operands."""
    def run(q, k, v):
        shape = q.shape
        return fn(*(x.view(1, *shape) for x in (q, k, v))).view(shape)
    return run


def variants(block: int = 64):
    """``{name: fn(q, k, v) -> o}`` over ``(bh, t, hd)`` operands, in the
    JAX race's order, with ``v5_sdpa`` in place of ``v5_stock``."""
    pk = probe_kernels
    return {
        "v1_base": _unfold(
            lambda q, k, v: kernels.flash_attention_lse(q, k, v, True)[0]),
        "v2_lanes": lambda q, k, v: pk.flash_fwd_row_state(q, k, v, True,
                                                           block),
        "v3_twopass": lambda q, k, v: pk.flash_fwd_two_pass(q, k, v, True,
                                                            block),
        "v4_fullrow": lambda q, k, v: pk.flash_fwd_full_row(q, k, v, True,
                                                            block),
        "v5_sdpa": _unfold(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "v6_stream": _unfold(
            lambda q, k, v: kernels.flash_attention_lse_streamed(
                q, k, v, True)[0]),
    }


def main(argv=None, device: str = "cuda", rows_out=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    (b, h, t, hd), blocks = parse_dims_blocks(argv)
    timed = device != "cpu"
    if timed and not torch.cuda.is_available():
        print("probe_flash_variants: no CUDA device", file=sys.stderr)
        return 2
    print(card() if timed else "CPU: the plain versions, untimed", flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((b * h, t, hd), generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))

    def race_variants(block):
        return {name: (lambda x, fn=fn: (fn(x, k, v),), q)
                for name, fn in variants(block).items()}

    with torch.no_grad():
        rows = run_race(race_variants, blocks, BLOCK_FREE,
                        lambda outs: outs[0], 2.0 * b * h * t * t * hd,
                        CHAIN, timed)
    if rows_out is not None:
        rows_out.extend(dict(row, shape=(b, h, t, hd)) for row in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
