"""Structural tensor operators: ``Concat``, ``Add``, ``Reshape``,
``DotInteraction`` and ``Dropout`` of ``flexflow_tpu/ops/tensor_ops.py``
(the others come with later slices).

Under a mesh ``Add`` and ``Concat`` read every input in their output's
spec, ``Reshape`` and ``DotInteraction`` split the sample dim only, and
``Dropout`` keeps the rank's block of the global batch's mask."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from flexflow_torch.initializers import RngKeyInitializer
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.runtime import keyed_random


class Concat(Op):
    def __init__(self, name: str, inputs: Sequence[TensorSpec], axis: int):
        super().__init__(name, inputs)
        ndim = inputs[0].ndim
        if axis < 0:
            axis += ndim
        self.axis = axis
        for t in inputs:
            if t.ndim != ndim or any(t.shape[d] != inputs[0].shape[d]
                                     for d in range(ndim) if d != axis):
                raise ValueError(f"concat {name}: {t.shape} does not match "
                                 f"{inputs[0].shape} off axis {axis}")
        out_shape = list(inputs[0].shape)
        out_shape[axis] = sum(t.shape[axis] for t in inputs)
        # The concatenated dim inherits no sharding tag; the others keep
        # the first input's.
        dim_axes = list(inputs[0].dim_axes)
        dim_axes[axis] = None
        self._make_output(tuple(out_shape), inputs[0].dtype, tuple(dim_axes))

    def input_spec(self, i, frm):
        return self.output_spec(0)

    def forward(self, params, xs, state, training):
        return [torch.cat(list(xs), dim=self.axis)], state


class Add(Op):
    """Elementwise sum (residual connections in transformer blocks)."""

    def __init__(self, name: str, a: TensorSpec, b: TensorSpec):
        super().__init__(name, [a, b])
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}: add needs one shape and dtype, got "
                             f"{a.shape}/{a.dtype} and {b.shape}/{b.dtype}")
        self._make_output(a.shape, a.dtype, a.dim_axes)

    def input_spec(self, i, frm):
        return self.output_spec(0)

    def forward(self, params, xs, state, training):
        a, b = xs
        return [a + b], state


class Reshape(Op):
    """Free-form reshape; the batch dim must be preserved."""

    def __init__(self, name: str, x: TensorSpec, shape: Sequence[int],
                 dim_axes: Optional[Sequence[Optional[str]]] = None):
        super().__init__(name, [x])
        shape = tuple(shape)
        if shape[0] != x.shape[0] or math.prod(shape) != math.prod(x.shape):
            raise ValueError(f"{name}: cannot reshape {x.shape} to {shape} "
                             f"(the batch dim must be kept)")
        if dim_axes is None:
            dim_axes = ("n",) + tuple(None for _ in shape[1:])
        self._make_output(shape, x.dtype, tuple(dim_axes))

    def _sample_only(self, t):
        return self._spec((t.dim_axes[0],) + (None,) * (t.ndim - 1), t.shape)

    def input_spec(self, i, frm):
        return self._sample_only(self.inputs[0])

    def output_spec(self, j):
        return self._sample_only(self.outputs[0])

    def forward(self, params, xs, state, training):
        (x,) = xs
        # The sample dim may shrink (a smaller batch than declared).
        return [x.reshape((x.shape[0],) + self.outputs[0].shape[1:])], state


class DotInteraction(Op):
    """DLRM pairwise-dot feature interaction: dense features (batch, d)
    and stacked embeddings (batch, T, d) -> the dense features followed by
    the strictly-lower-triangular pairwise dots of the T+1 feature vectors,
    in ``tril_indices(k=-1)`` order: (batch, d + (T+1)T/2)."""

    def __init__(self, name: str, dense: TensorSpec, sparse: TensorSpec):
        super().__init__(name, [dense, sparse])
        if dense.ndim != 2 or sparse.ndim != 3 or \
                dense.shape[0] != sparse.shape[0] or \
                dense.shape[1] != sparse.shape[2]:
            raise ValueError(f"{name}: needs dense (b, d) and sparse (b, T, d), "
                             f"got {dense.shape} and {sparse.shape}")
        b, t, d = sparse.shape
        f = t + 1
        self._pairs: Dict[torch.device, torch.Tensor] = {}
        self._make_output((b, d + f * (f - 1) // 2), dense.dtype, ("n", None))

    def input_spec(self, i, frm):
        t = self.inputs[i]
        return self._spec(("n",) + (None,) * (t.ndim - 1), t.shape)

    def _tril(self, f: int, device) -> torch.Tensor:
        """Flat indices ``i*f + j`` of the pairs ``j < i`` (row-major),
        made on the device once."""
        idx = self._pairs.get(device)
        if idx is None:
            li, lj = torch.tril_indices(f, f, offset=-1, device=device)
            idx = self._pairs[device] = li * f + lj
        return idx

    def forward(self, params, xs, state, training):
        dense, sparse = xs
        feats = torch.cat([dense[:, None, :], sparse], dim=1)      # (b, F, d)
        dots = torch.bmm(feats, feats.transpose(1, 2))              # (b, F, F)
        f = feats.shape[1]
        pairs = dots.reshape(dots.shape[0], f * f)[:, self._tril(f, dots.device)]
        return [torch.cat([dense, pairs.to(dense.dtype)], dim=1)], state


class Dropout(Op):
    """Inverted dropout with JAX's masks: the op keeps a threefry key as
    state ``rng``; each training step splits it (``keyed_random.split``)
    and keeps ``bernoulli(sub, 1 - rate, shape)`` over the global batch's
    shape (the rank's block of it under a mesh, since JAX's draw does not
    depend on the sharding), the bits
    ``jax.random`` draws from the same key, then ``y = where(keep, x / (1
    - rate), 0)`` in x's dtype (the divisor a tensor of x's dtype, as JAX
    divides by the weakly typed constant).  The new key comes back as
    state, and the executor writes it into the state's tensor in place,
    so a captured superstep advances it on the device.  Eval and rate 0
    are the identity."""

    def __init__(self, name: str, x: TensorSpec, rate: float):
        super().__init__(name, [x])
        if not 0.0 <= rate < 1.0:  # also rejects nan
            raise ValueError(
                f"dropout {name}: rate must be in [0, 1), got {rate}")
        self.attrs = dict(rate=rate)
        self._make_output(x.shape, x.dtype, x.dim_axes)

    def state_specs(self) -> Dict[str, ParamSpec]:
        return {"rng": ParamSpec((2,), torch.int64, RngKeyInitializer())}

    def forward(self, params, xs, state, training):
        (x,) = xs
        rate = self.attrs["rate"]
        if not training or rate == 0.0:
            return [x], state
        new_key, sub = keyed_random.split(state["rng"])
        if self._world is None:
            keep = keyed_random.bernoulli(sub, 1.0 - rate, x.shape)
        else:
            spec = self.output_spec(0)
            shape = [n * self._plan.size(a) for n, a in zip(x.shape, spec)]
            keep = keyed_random.bernoulli(sub, 1.0 - rate, shape)[
                self._plan.local_slices(spec, shape, self._world.rank)]
        scale = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
        return [torch.where(keep, x / scale, 0)], {"rng": new_key}
