"""Operator base classes: the port of ``flexflow_tpu/ops/base.py``.

An op is a node in the graph: it declares its parameters (shape, dtype,
initializer), infers its output specs at build time, and implements
``forward(params, xs, state, training)`` on torch tensors with the same
contract as the JAX package, so graphs, parameter dicts and the serving
state protocol carry over name for name.  Embedding ops also implement
the row-sparse gradient protocol (``sparse_*``) that the executor's
sparse train step drives.

Under a mesh of more than one rank (``parallel/mesh.py``) the executor
binds each op to the plan and its ``ParallelConfig`` (``bind_mesh``),
reshards each input into the spec the op asks for (``input_spec``) and
records the spec the op's outputs come out in (``output_spec``); an op
then computes on its local blocks, issuing its own collectives where its
work needs them (``parallel/collectives.py``).  By default an op takes
and gives every tensor in the spec of its own tags, which is right for
elementwise work; ops whose work reads a whole dim override the specs.
An op that sets ``mesh_refusal`` raises under more than one rank.
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
    #: Semantic axis per dim (the JAX package's sharding tags): the
    #: parameter's spec under a mesh (``MeshPlan.spec``).
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

    #: Set to the ROADMAP.md item that brings this op to a mesh of more
    #: than one rank; the executor raises naming it.
    mesh_refusal: Optional[str] = None
    #: The binding of ``bind_mesh`` (None until the executor binds).
    _plan = _pc = _world = None

    def __init__(self, name: str, inputs: Sequence[TensorSpec]):
        self.name = name
        self.inputs: List[TensorSpec] = list(inputs)
        self.outputs: List[TensorSpec] = []

    # -- mesh binding -------------------------------------------------------

    def bind_mesh(self, plan, pc, world=None) -> None:
        """Called by the executor before ``forward`` with the MeshPlan,
        this op's ParallelConfig and the rank's ``World`` (None on one
        device), as JAX's ``Op.bind_mesh``."""
        self._plan, self._pc, self._world = plan, pc, world

    def _spec(self, dim_axes, shape):
        return self._plan.spec(self._pc, dim_axes, shape)

    def input_spec(self, i: int, frm):
        """The spec this op reads input ``i`` in; ``frm`` is the spec its
        producer left it in."""
        t = self.inputs[i]
        return self._spec(t.dim_axes, t.shape)

    def output_spec(self, j: int):
        """The spec output ``j`` comes out in."""
        t = self.outputs[j]
        return self._spec(t.dim_axes, t.shape)

    def param_spec(self, key: str):
        """The spec parameter (or state) ``key`` is held in."""
        spec = {**self.param_specs(), **self.state_specs()}[key]
        return self._spec(self.mesh_tags(spec, self._plan, self._pc),
                          spec.shape)

    def mesh_tags(self, spec: "ParamSpec", plan, pc):
        """The tags parameter ``spec`` is placed by under ``plan`` and
        ``pc``: its own, unless the op runs a tagged dim whole under that
        placement (an embedding table whose rows the ``c`` degree does not
        divide, ``ops/embedding.py``)."""
        return spec.dim_axes

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

    def sparse_ok(self, plan, pc) -> bool:
        """Whether the sparse path is valid under this placement (JAX's
        signature; every placement of the port's embedding ops is)."""
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
