"""Fully-connected (dense) operator: the port of
``flexflow_tpu/ops/linear.py``.

The kernel is stored ``(out, in)``, out-dim-major like the reference
(``linear.cu``), and the forward is ``y = x @ kernel.T``; the product
goes to ``torch.matmul`` (cuBLAS), as the JAX package left it to XLA.

Under a ``c`` split the kernel's ``out/c`` rows (and the bias's) are the
rank's, the output is split on ``c``, and the input is whole along the
contraction on every rank: JAX pins that layout (``linear.py:69-90``) so
that every mesh sums each output over the whole contraction in one
product, never as partial products plus a reduction.  An input that
arrives split on the contraction over the kernel's own ``c`` axes is
all-gathered here (its backward reduce-scatters); a whole one passes
through ``copy_to`` (its backward all-reduces), since each rank's rows
give only a part of the input's gradient.
"""

from __future__ import annotations

from typing import Dict, Optional

from flexflow_torch.initializers import GlorotUniform, ZeroInitializer
from flexflow_torch.ops.activations import apply_activation, check_activation
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.parallel import collectives


class Linear(Op):
    def __init__(
        self,
        name: str,
        x: TensorSpec,
        out_dim: int,
        activation: Optional[str] = None,
        use_bias: bool = True,
        kernel_initializer=None,
        bias_initializer=None,
    ):
        super().__init__(name, [x])
        if x.ndim < 2:
            raise ValueError(f"linear input must be (batch, ..., features), "
                             f"got {x.shape}")
        check_activation(activation)
        self.in_dim = x.shape[-1]
        self.attrs = dict(out_dim=out_dim, activation=activation,
                          use_bias=use_bias)
        self.kernel_initializer = kernel_initializer or GlorotUniform()
        self.bias_initializer = bias_initializer or ZeroInitializer()
        self._make_output(
            x.shape[:-1] + (out_dim,), x.dtype, x.dim_axes[:-1] + ("c",)
        )

    def param_specs(self) -> Dict[str, ParamSpec]:
        out_dim = self.attrs["out_dim"]
        specs = {
            "kernel": ParamSpec((out_dim, self.in_dim), self.outputs[0].dtype,
                                self.kernel_initializer, ("c", None))
        }
        if self.attrs["use_bias"]:
            specs["bias"] = ParamSpec((out_dim,), self.outputs[0].dtype,
                                      self.bias_initializer, ("c",))
        return specs

    def _c_axes(self):
        return self.param_spec("kernel")[0]

    def input_spec(self, i, frm):
        want = self._spec(self.inputs[0].dim_axes[:-1] + (None,),
                          self.inputs[0].shape)
        c = self._c_axes()
        if c and tuple(frm[:-1]) == tuple(want[:-1]) and tuple(frm[-1]) == c:
            return tuple(frm)  # gathered in forward, reduce-scattered back
        return want

    def forward(self, params, xs, state, training):
        (x,) = xs
        if self._world is not None and self._c_axes():
            c = self._c_axes()
            x = (collectives.all_gather(x, -1, self._world, c)
                 if x.shape[-1] != self.in_dim
                 else collectives.copy_to(x, self._world, c))
        y = x @ params["kernel"].T
        if self.attrs["use_bias"]:
            y = y + params["bias"]
        return [apply_activation(y, self.attrs["activation"])], state
