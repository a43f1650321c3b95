"""Batch normalization: the port of ``flexflow_tpu/ops/norm.py``.

Batch statistics over ``(n, h, w)`` in f32, the variance as ``E[x^2] -
mean^2``, and running statistics ``m * old + (1 - m) * batch`` cast back
to the input's dtype, as the JAX op writes them.  ``F.batch_norm`` is
not that function: its running variance is the unbiased one, its
momentum is ``1 - m`` and its statistics come from another reduction,
so the op is written in tensor ops.  The running statistics are op
state: a training forward returns the new values and the executor
copies them into the state's tensors in place (so a captured superstep
advances them, and ``--remat``'s recompute does not advance them twice).

Under an ``n``, ``h`` or ``w`` split each rank sums ``x`` and ``x^2``
over its block and all-reduces the sums over those axes before JAX's
``E[x^2] - mean^2``: the global batch's statistics, which GSPMD computes
for the JAX op.  A ``c`` split keeps its channels local.
"""

from __future__ import annotations

from typing import Dict

import torch

from flexflow_torch.initializers import OnesInitializer, ZeroInitializer
from flexflow_torch.ops.activations import apply_activation
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.parallel import collectives


class BatchNorm(Op):
    def __init__(
        self,
        name: str,
        x: TensorSpec,
        relu: bool = False,
        momentum: float = 0.9,
        eps: float = 1e-5,
    ):
        super().__init__(name, [x])
        if x.ndim != 4:
            raise ValueError(f"batch_norm {name}: input must be NHWC, got "
                             f"{x.shape}")
        self.attrs = dict(relu=relu, momentum=momentum, eps=eps)
        self.channels = x.shape[3]
        self._make_output(x.shape, x.dtype, ("n", "h", "w", "c"))

    def param_specs(self) -> Dict[str, ParamSpec]:
        c = self.channels
        dt = self.outputs[0].dtype
        return {
            "scale": ParamSpec((c,), dt, OnesInitializer(), ("c",)),
            "bias": ParamSpec((c,), dt, ZeroInitializer(), ("c",)),
        }

    def state_specs(self) -> Dict[str, ParamSpec]:
        c = self.channels
        dt = self.outputs[0].dtype
        return {
            "running_mean": ParamSpec((c,), dt, ZeroInitializer(), ("c",)),
            "running_var": ParamSpec((c,), dt, OnesInitializer(), ("c",)),
        }

    def forward(self, params, xs, state, training):
        (x,) = xs
        eps = self.attrs["eps"]
        xf = x.float()
        split = (collectives.axes_of(self.input_spec(0, None)[:3])
                 if self._world is not None else ())
        if training and split:
            sums = torch.stack([xf.sum(dim=(0, 1, 2)),
                                xf.square().sum(dim=(0, 1, 2))])
            sums = collectives.copy_to(
                collectives.all_reduce(sums, self._world, split),
                self._world, split)
            count = x.shape[0] * x.shape[1] * x.shape[2] * \
                self._plan.size(split)
            mean = sums[0] / count
            var = sums[1] / count - mean.square()
        elif training:
            mean = xf.mean(dim=(0, 1, 2))
            var = xf.square().mean(dim=(0, 1, 2)) - mean.square()
        if training:
            m = self.attrs["momentum"]
            # JAX multiplies the state by m in the state's dtype (a weak
            # Python scalar takes the array's type), so m is rounded to
            # it first; (1 - m) meets the f32 statistics in f32.
            m_dt = float(torch.tensor(m, dtype=x.dtype))
            with torch.no_grad():
                new_state = {
                    k: (state[k] * m_dt + (1 - m) * batch.detach()).to(x.dtype)
                    for k, batch in (("running_mean", mean),
                                     ("running_var", var))
                }
        else:
            mean = state["running_mean"].float()
            var = state["running_var"].float()
            new_state = state
        inv = torch.reciprocal(torch.sqrt(var + eps))
        y = (xf - mean) * inv * params["scale"].float() + params["bias"].float()
        y = y.to(x.dtype)
        if self.attrs["relu"]:
            y = apply_activation(y, "relu")
        return [y], new_state
