"""Token embedding: the dense forward of
``flexflow_tpu/ops/embedding.py::WordEmbedding``.

The JAX forward is ``jnp.take`` (no Pallas kernel), so the port gathers
with ``torch.nn.functional.embedding``.  The table keeps its own dtype
(f32 under the graph's dtype rule) and the gathered rows are cast to the
output dtype, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from flexflow_torch.initializers import NormInitializer
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec


class WordEmbedding(Op):
    """Token embedding over (batch, seq) int ids -> (batch, seq, dim)."""

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        num_entries: int,
        out_dim: int,
        dtype=torch.float32,
        out_dtype=None,
        kernel_initializer=None,
    ):
        super().__init__(name, [x])
        if x.ndim != 2:
            raise ValueError(f"word embedding input must be (batch, seq), "
                             f"got {x.shape}")
        self.attrs = dict(num_entries=num_entries, out_dim=out_dim)
        self.kernel_initializer = kernel_initializer or NormInitializer(0.0, 0.01)
        self.table_dtype = dtype
        self._make_output((x.shape[0], x.shape[1], out_dim), out_dtype or dtype,
                          ("n", "s", None))

    def param_specs(self) -> Dict[str, ParamSpec]:
        a = self.attrs
        return {
            "table": ParamSpec((a["num_entries"], a["out_dim"]),
                               self.table_dtype, self.kernel_initializer)
        }

    def forward(self, params, xs, state, training):
        (idx,) = xs
        rows = F.embedding(idx, params["table"])
        return [rows.to(self.outputs[0].dtype)], state
