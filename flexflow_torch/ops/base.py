"""Operator base classes: the port of ``flexflow_tpu/ops/base.py``.

An op is a node in the graph: it declares its parameters (shape, dtype,
initializer), infers its output specs at build time, and implements
``forward(params, xs, state, training)`` on torch tensors with the same
contract as the JAX package, so graphs, parameter dicts and the serving
state protocol carry over name for name.
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

    def __init__(self, name: str, inputs: Sequence[TensorSpec]):
        self.name = name
        self.inputs: List[TensorSpec] = list(inputs)
        self.outputs: List[TensorSpec] = []

    def param_specs(self) -> Dict[str, ParamSpec]:
        return {}

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
