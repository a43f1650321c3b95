"""Analytic forward flops of an op: the flops part of
``flexflow_tpu/search/cost_model.py`` (``FWD_BWD_FACTOR``, ``OpCost``,
``op_cost``).

The bench entry's MFU divides these flops by the step time.  The byte,
sync and device-model parts, which rank strategies in the search, come
with the search (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
import math

from flexflow_torch.ops import (
    Embedding,
    MultiEmbedding,
    MultiHeadAttention,
    Op,
    PositionEmbedding,
    WordEmbedding,
)

#: Lookup-table ops: the forward is a gather, so the table contracts
#: nothing.
LOOKUP_OPS = (Embedding, MultiEmbedding, WordEmbedding, PositionEmbedding)

#: fwd+bwd multiplier: the backward is about twice the forward's flops
#: (a data and a weight gradient per forward product).
FWD_BWD_FACTOR = 3.0


@dataclasses.dataclass
class OpCost:
    flops: float  # forward flops


def op_cost(op: Op) -> OpCost:
    """Forward flops of one op from its declared shapes: every weight of
    ``prod(W)`` elements (2-D or more) is contracted against each of the
    output's positions not tagged ``c``, ``2 * prod(out dims not 'c') *
    prod(W)``, which is exact for a conv (``2 N Ho Wo kh kw Cin Cout``)
    and a linear.  Attention has its explicit formula (its output carries
    no ``c`` tag): the q/k/v/o projections and the ``O(seq^2)`` scores
    and values."""
    out = op.outputs[0]
    non_c = 1.0
    for ext, ax in zip(out.shape, out.dim_axes):
        if ax != "c":
            non_c *= ext
    flops = 0.0
    if not isinstance(op, LOOKUP_OPS + (MultiHeadAttention,)):
        for spec in op.param_specs().values():
            if len(spec.shape) >= 2:
                flops += 2.0 * non_c * float(math.prod(spec.shape))
    if isinstance(op, MultiHeadAttention):
        b, s, d = op.inputs[0].shape
        flops += 8.0 * b * s * float(d) ** 2
        flops += 4.0 * b * float(s) ** 2 * d
    return OpCost(flops=flops)


def train_flops(ff) -> float:
    """Analytic flops of one train step of the graph ``ff``: the forward
    of every op times ``FWD_BWD_FACTOR`` (``bench.py::_train_flops``)."""
    return FWD_BWD_FACTOR * sum(op_cost(op).flops for op in ff.layers)
