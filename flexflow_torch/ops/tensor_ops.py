"""Structural tensor operators: the ``Add`` of
``flexflow_tpu/ops/tensor_ops.py`` (the others come with later slices)."""

from __future__ import annotations

from flexflow_torch.ops.base import Op, TensorSpec


class Add(Op):
    """Elementwise sum (residual connections in transformer blocks)."""

    def __init__(self, name: str, a: TensorSpec, b: TensorSpec):
        super().__init__(name, [a, b])
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}: add needs one shape and dtype, got "
                             f"{a.shape}/{a.dtype} and {b.shape}/{b.dtype}")
        self._make_output(a.shape, a.dtype, a.dim_axes)

    def forward(self, params, xs, state, training):
        a, b = xs
        return [a + b], state
