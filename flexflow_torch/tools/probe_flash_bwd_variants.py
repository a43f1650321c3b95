"""The flash-backward variant race (P2) on the card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 -m flexflow_torch.tools.probe_flash_bwd_variants [b h t hd] [--blocks 64,128]

The port of ``tools/probe_flash_bwd_variants.py``.  Each variant computes
``(dq, dk, dv)`` of causal softmax attention on the same bf16 ``(b h, t,
hd)`` inputs, from K1f's ``o`` and ``lse``:

  b1_prod     K1b, ``kernels.flash_attention_lse_bwd`` (the control)
  b2_lanes    the row-state backward, ``probe_kernels.flash_bwd_row_state``,
              with the caller's ``delta = rowsum(o do)``
  b3_stream   K1sb, ``kernels.flash_attention_lse_streamed_bwd``
  b4_sdpa     the backward of ``F.scaled_dot_product_attention``, the
              yardstick

Each call of a kernel variant feeds ``dq + dk + dv`` back as ``q``; the
yardstick's graph is built once, so its chain feeds the sum back as the
cotangent ``do`` (its time does not depend on the values).  The rows are
the forward race's: ms by :func:`probe_common.chain_slope_ms` over chains
of 2 and 8 calls, the share of 989 TFLOP/s for ``7 b h t^2 hd`` FLOPs (dq's
three products and dk/dv's four over half the square), and the largest
error of all three cotangents against ``b1_prod`` over the first 64 rows
of the first head.  b1, b3 and b4 take no block and run at the first block
only.  Without a card it exits 2; ``main(argv, device="cpu")`` runs the
plain versions untimed.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from flexflow_torch.ops import kernels, probe_kernels
from flexflow_torch.tools.probe_common import (card, parse_dims_blocks,
                                               run_race)

#: Variants that take no block.
BLOCK_FREE = ("b1_prod", "b3_stream", "b4_sdpa")
#: Chain lengths of the slope.
CHAIN = (2, 8)


def variants(block, q, k, v, do, o, lse, delta):
    """``{name: (fn, x0)}``: ``fn(x)`` gives ``(dq, dk, dv)`` over ``(bh,
    t, hd)`` operands and ``x0`` is the operand its chain feeds back
    (``q``; the yardstick's ``do``).  ``o``, ``lse`` and ``delta`` are the
    forward's, ``(bh, t, hd)``, ``(bh, t)`` and ``(bh, t)``."""
    shape = q.shape

    def unfold(bwd):
        def run(x):
            ops = (x, k, v, o, lse, do)
            grads = bwd(*(y.view(1, *y.shape) for y in ops), None, True)
            return tuple(grad.view(shape) for grad in grads)
        return run

    qs, ks, vs = (x.detach().view(1, *shape).requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_bwd(x):
        grads = torch.autograd.grad(out, (qs, ks, vs), x.view(1, *shape),
                                    retain_graph=True)
        return tuple(grad.view(shape) for grad in grads)

    return {
        "b1_prod": (unfold(kernels.flash_attention_lse_bwd), q),
        "b2_lanes": (lambda x: probe_kernels.flash_bwd_row_state(
            x, k, v, do, lse, delta, True, block), q),
        "b3_stream": (unfold(kernels.flash_attention_lse_streamed_bwd), q),
        "b4_sdpa": (sdpa_bwd, do),
    }


def main(argv=None, device: str = "cuda", rows_out=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    (b, h, t, hd), blocks = parse_dims_blocks(argv)
    timed = device != "cpu"
    if timed and not torch.cuda.is_available():
        print("probe_flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    print(card() if timed else "CPU: the plain versions, untimed", flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn((b * h, t, hd), generator=g, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    with torch.no_grad():
        o, lse = kernels.flash_attention_lse(
            *(x.view(1, b * h, t, hd) for x in (q, k, v)), True)
    o, lse = o.view(q.shape), lse.view(b * h, t)
    delta = (o.float() * do.float()).sum(dim=-1)
    rows = run_race(
        lambda block: variants(block, q, k, v, do, o, lse, delta), blocks,
        BLOCK_FREE, lambda outs: (outs[0] + outs[1] + outs[2]).to(q.dtype),
        7.0 * b * h * t * t * hd, CHAIN, timed)
    if rows_out is not None:
        rows_out.extend(dict(row, shape=(b, h, t, hd)) for row in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
