"""Operator base classes: the port of ``flexflow_tpu/ops/base.py``.

An op is a node in the graph: it declares its parameters (shape, dtype,
initializer), infers its output specs at build time, and implements
``forward(params, xs, state, training)`` on torch tensors with the same
contract as the JAX package, so graphs, parameter dicts and the serving
state protocol carry over name for name.  Embedding ops also implement
the row-sparse gradient protocol (``sparse_*``) that the executor's
sparse train step drives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_torch.initializers import Initializer


@dataclasses.dataclass
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    initializer: Initializer
    #: Semantic axis per dim (the JAX package's sharding tags); kept so
    #: the specs read alike, unused on one device.
    dim_axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if not self.dim_axes:
            self.dim_axes = tuple(None for _ in self.shape)


@dataclasses.dataclass
class TensorSpec:
    """Symbolic tensor in the op graph."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    dim_axes: Tuple[Optional[str], ...]
    producer: Optional["Op"] = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self):
        return (f"TensorSpec({self.name}, {self.shape}, {self.dtype}, "
                f"axes={self.dim_axes})")


class Op:
    """Graph node: owns name, inputs, outputs, params."""

    #: Set True for ops producing a scalar loss contribution + metrics.
    is_loss = False
    #: Loss ops are exempt from per-layer remat (``--remat``): a
    #: terminal loss is cheap to keep.  A loss op heavy enough to be
    #: worth recomputing opts back in with True.
    allow_remat = False

    def __init__(self, name: str, inputs: Sequence[TensorSpec]):
        self.name = name
        self.inputs: List[TensorSpec] = list(inputs)
        self.outputs: List[TensorSpec] = []

    def param_specs(self) -> Dict[str, ParamSpec]:
        return {}

    def state_specs(self) -> Dict[str, ParamSpec]:
        """Mutable state that is not trained (Dropout's RNG key).  A
        training forward returns the new values and the executor writes
        them into the state's tensors in place."""
        return {}

    # -- sparse-gradient protocol -----------------------------------------
    #
    # Embedding-style ops (output == gathered rows, up to a linear
    # aggregation) opt in by returning their table keys from
    # ``sparse_keys``.  The executor then differentiates with respect to
    # the GATHERED ROWS instead of the table and applies the row gradient
    # with an in-place scatter-add, so no table-sized gradient ever
    # exists (``flexflow_tpu/ops/base.py``'s protocol; the row kernels
    # are K4/K5 in ``ops/kernels.py``).

    def sparse_keys(self) -> Tuple[str, ...]:
        """Param keys eligible for row-sparse updates (() = none)."""
        return ()

    def sparse_ok(self) -> bool:
        """Whether the sparse path is valid for this op (one device: the
        JAX package's placement check has nothing to check here)."""
        return True

    def sparse_rows(self, params, xs):
        """Gather: params + graph inputs -> the rows (small)."""
        raise NotImplementedError

    def sparse_forward(self, rows, xs, state, training):
        """Forward given pre-gathered rows; must not touch the table."""
        raise NotImplementedError

    def sparse_apply(self, params, xs, row_grads, lr):
        """Scatter the row gradients in place: ``table[ids] += -lr * g``."""
        raise NotImplementedError

    def sparse_flat_ids(self, params, xs):
        """Row ids of every gathered row into the ``(R, D)`` flat view of
        the (single) sparse table, ``table.reshape(-1, last_dim)``; the
        shape of ``row_grads[..., 0]``.  Lets the executor sum
        duplicate-id row gradients generically (exact global-norm
        clipping; one lazy momentum/Adam update per unique row)."""
        raise NotImplementedError

    def forward(
        self,
        params: Dict[str, torch.Tensor],
        xs: Sequence[torch.Tensor],
        state: Dict[str, Any],
        training: bool,
    ):
        """Returns (ys: list of tensors, new_state dict)."""
        raise NotImplementedError

    def _make_output(self, shape, dtype, dim_axes, idx: int = 0) -> TensorSpec:
        t = TensorSpec(
            name=f"{self.name}:out{idx}" if idx else f"{self.name}:out",
            shape=tuple(shape),
            dtype=dtype,
            dim_axes=tuple(dim_axes),
            producer=self,
        )
        self.outputs.append(t)
        return t
