"""Fully-connected (dense) operator: the single-device path of
``flexflow_tpu/ops/linear.py``.

The kernel is stored ``(out, in)``, out-dim-major like the reference
(``linear.cu``), and the forward is ``y = x @ kernel.T``; the product
goes to ``torch.matmul`` (cuBLAS), as the JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional

from flexflow_torch.initializers import GlorotUniform, ZeroInitializer
from flexflow_torch.ops.activations import apply_activation, check_activation
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec


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

    def forward(self, params, xs, state, training):
        (x,) = xs
        y = x @ params["kernel"].T
        if self.attrs["use_bias"]:
            y = y + params["bias"]
        return [apply_activation(y, self.attrs["activation"])], state
