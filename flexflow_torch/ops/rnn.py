"""Recurrent operators: the LSTM of ``flexflow_tpu/ops/rnn.py`` on one
device.

One op spans the whole sequence.  The input projection ``x @ wx + b``
is hoisted out of the recurrence into one ``(batch * t, in) x (in, 4h)``
product; the recurrence keeps only ``h @ wh`` per step, a loop over
``t`` in Python (JAX's ``lax.scan``), gates i, f, g, o.  Both are plain
products that JAX leaves to XLA and no Pallas kernel, so here they go to
``torch.matmul`` (cuBLAS).  The sequence-parallel pipeline of the JAX op
(the ``s`` degree, over which ``num_microbatches`` splits the batch)
comes with ROADMAP.md queue 1, item 9d (the LSTM's pipeline); on
one device, as in JAX at ``s = 1``, ``num_microbatches`` is kept and
unused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from flexflow_torch.initializers import GlorotUniform, ZeroInitializer
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec


def _lstm_chunk(wx, wh, b, forget_bias, h0, c0, x):
    """The cell over a ``(batch, t, in)`` chunk: ``((hT, cT), ys)``,
    ``ys`` ``(batch, t, h)``.  ``forget_bias`` is a 0-d tensor of x's
    dtype (JAX's ``jnp.asarray(forget_bias, x.dtype)``)."""
    xw = x @ wx + b                                      # (batch, t, 4h)
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        z = xw[:, t] + h @ wh
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return (h, c), torch.stack(ys, dim=1)


class LSTM(Op):
    """LSTM over ``(batch, seq, features)`` with an optional initial
    state ``(h0, c0)``.  Outputs: ``y (batch, seq, hidden)``, ``hT`` and
    ``cT (batch, hidden)``.  Params ``wx (in, 4h)``, ``wh (h, 4h)`` and
    ``bias (4h,)`` with JAX's initializers and layouts."""

    mesh_refusal = "the LSTM's sequence pipeline, ROADMAP.md queue 1, item 9d"

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        hidden_size: int,
        initial_state: Optional[Tuple[TensorSpec, TensorSpec]] = None,
        forget_bias: float = 1.0,
        num_microbatches: Optional[int] = None,
        kernel_initializer=None,
        bias_initializer=None,
    ):
        inputs = [x] if initial_state is None else [x, *initial_state]
        super().__init__(name, inputs)
        if x.ndim != 3:
            raise ValueError(f"lstm input must be (batch, seq, features), "
                             f"got {x.shape}")
        batch, seq, in_dim = x.shape
        if initial_state is not None:
            for t in initial_state:
                if t.shape != (batch, hidden_size):
                    raise ValueError(
                        f"initial state must be ({batch}, {hidden_size}), "
                        f"got {t.shape}")
        self.attrs = dict(hidden_size=hidden_size, forget_bias=forget_bias,
                          num_microbatches=num_microbatches,
                          has_initial_state=initial_state is not None)
        self.in_dim = in_dim
        self.kernel_initializer = kernel_initializer or GlorotUniform()
        self.bias_initializer = bias_initializer or ZeroInitializer()
        self._make_output((batch, seq, hidden_size), x.dtype, ("n", "s", None))
        self._make_output((batch, hidden_size), x.dtype, ("n", None), idx=1)
        self._make_output((batch, hidden_size), x.dtype, ("n", None), idx=2)

    def param_specs(self) -> Dict[str, ParamSpec]:
        h = self.attrs["hidden_size"]
        dtype = self.outputs[0].dtype
        return {
            "wx": ParamSpec((self.in_dim, 4 * h), dtype,
                            self.kernel_initializer),
            "wh": ParamSpec((h, 4 * h), dtype, self.kernel_initializer),
            "bias": ParamSpec((4 * h,), dtype, self.bias_initializer),
        }

    def forward(self, params, xs, state, training):
        x = xs[0]
        if self.attrs["has_initial_state"]:
            h0, c0 = xs[1], xs[2]
        else:
            h0 = c0 = torch.zeros((x.shape[0], self.attrs["hidden_size"]),
                                  dtype=x.dtype, device=x.device)
        fb = torch.full((), self.attrs["forget_bias"], dtype=x.dtype,
                        device=x.device)
        (hT, cT), ys = _lstm_chunk(params["wx"], params["wh"], params["bias"],
                                   fb, h0, c0, x)
        return [ys, hT, cT], state
