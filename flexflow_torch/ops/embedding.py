"""Embedding operators: the single-device port of
``flexflow_tpu/ops/embedding.py``.

``Embedding`` (one table, bag sum/avg), ``MultiEmbedding`` (T tables of
one vocabulary stacked into a ``(T, V, D)`` parameter), ``HeteroEmbedding``
(tables of different vocabularies concatenated by rows, with per-table
offsets) and ``WordEmbedding`` (token embedding).  The dense forward
gathers with ``torch.nn.functional.embedding`` (the JAX forward is
``jnp.take``; autograd gives the scatter-add gradient).  Each op also
implements the row-sparse protocol of ``ops/base.py``: the executor
gathers the rows with K4 (``kernels.gather_rows``), differentiates with
respect to them, and scatter-adds ``-lr * g`` into the table in place
with K5 (``kernels.scatter_add_rows``); the lazy optimizers gather the
unique rows of the table and of its state in one K4 launch
(``kernels.gather_rows_multi``).  The tables keep their own
dtype (f32 under the graph's rule) and the rows are cast to the output
dtype, as in the reference.

Row-sharded tables (``shard_rows``, ``--shard-embeddings``) are refused
until ROADMAP.md queue 1, item 9b, and so are the stacked tables under
more than one rank.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from flexflow_torch.initializers import Initializer, NormInitializer
from flexflow_torch.ops import kernels
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec


def _refuse_shard_rows(name: str, shard_rows: bool) -> None:
    if shard_rows:
        raise NotImplementedError(
            f"{name}: row-sharded embedding tables (shard_rows, "
            f"--shard-embeddings) are ROADMAP.md queue 1, item 9b")


def _gather_dispatch(table, flat_ids):
    """``table (R, D) [flat_ids] -> flat_ids.shape + (D,)`` by K4: the
    kernel on a CUDA table, its plain version on a CPU one (the wrapper's
    device rule).  The executor's sparse path only: the result carries
    no autograd history."""
    rows = kernels.gather_rows(table, flat_ids.reshape(-1))
    return rows.reshape(flat_ids.shape + (table.shape[1],))


def _scatter_add_dispatch(table, flat_ids, upd):
    """``table[flat_ids] += upd`` in place by K5 (kernel on CUDA, plain
    version on the CPU); returns ``table``."""
    d = table.shape[1]
    return kernels.scatter_add_rows(table, flat_ids.reshape(-1),
                                    upd.to(table.dtype).reshape(-1, d))


class Embedding(Op):
    """Single-table embedding lookup with bag aggregation: int ids
    (batch, bag) -> (batch, out_dim), summed or averaged over the bag."""

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        num_entries: int,
        out_dim: int,
        aggr: str = "sum",
        dtype=torch.float32,
        out_dtype=None,
        kernel_initializer=None,
        shard_rows: bool = False,
    ):
        super().__init__(name, [x])
        _refuse_shard_rows(name, shard_rows)
        if x.ndim != 2:
            raise ValueError(f"embedding input must be (batch, bag), got "
                             f"{x.shape}")
        if aggr not in ("sum", "avg"):
            raise ValueError(f"{name}: aggr must be sum or avg, got {aggr!r}")
        self.attrs = dict(num_entries=num_entries, out_dim=out_dim, aggr=aggr)
        self.kernel_initializer = kernel_initializer or NormInitializer(0.0, 0.01)
        self.table_dtype = dtype
        self._make_output((x.shape[0], out_dim), out_dtype or dtype, ("n", "c"))

    def param_specs(self) -> Dict[str, ParamSpec]:
        a = self.attrs
        return {"table": ParamSpec((a["num_entries"], a["out_dim"]),
                                   self.table_dtype, self.kernel_initializer,
                                   (None, "c"))}

    def forward(self, params, xs, state, training):
        (idx,) = xs
        return self.sparse_forward(F.embedding(idx, params["table"]), xs,
                                   state, training)

    def sparse_keys(self):
        return ("table",)

    def sparse_rows(self, params, xs):
        (idx,) = xs
        return _gather_dispatch(params["table"], idx)

    def sparse_forward(self, rows, xs, state, training):
        y = rows.sum(dim=1) if self.attrs["aggr"] == "sum" else rows.mean(dim=1)
        return [y.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        (idx,) = xs
        _scatter_add_dispatch(params["table"], idx, -lr * row_grads)
        return params

    def sparse_flat_ids(self, params, xs):
        (idx,) = xs
        return idx


class MultiEmbedding(Op):
    """T same-shaped tables stacked into one ``(T, V, D)`` parameter (the
    DLRM form): int ids (batch, T) -> (batch, T, D), row ``idx[b, t]`` of
    table ``t``.  The flat row of ``(b, t)`` in the ``(T*V, D)`` view is
    ``t*V + idx[b, t]``, computed in int64."""

    mesh_refusal = "the stacked DLRM tables, ROADMAP.md queue 1, item 9b"

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        num_tables: int,
        num_entries: int,
        out_dim: int,
        dtype=torch.float32,
        out_dtype=None,
        kernel_initializer=None,
    ):
        super().__init__(name, [x])
        if x.ndim != 2 or x.shape[1] != num_tables:
            raise ValueError(f"{name}: ids must be (batch, {num_tables}), "
                             f"got {x.shape}")
        self.attrs = dict(num_tables=num_tables, num_entries=num_entries,
                          out_dim=out_dim)
        self.kernel_initializer = kernel_initializer or NormInitializer(0.0, 0.01)
        self.table_dtype = dtype
        self._make_output((x.shape[0], num_tables, out_dim), out_dtype or dtype,
                          ("n", "c", None))

    def param_specs(self) -> Dict[str, ParamSpec]:
        a = self.attrs
        return {"tables": ParamSpec(
            (a["num_tables"], a["num_entries"], a["out_dim"]),
            self.table_dtype, self.kernel_initializer, ("c", None, None))}

    @staticmethod
    def _flat(tables):
        t, v, d = tables.shape
        return tables.reshape(t * v, d)

    def _flat_ids(self, tables, idx):
        t, v, _ = tables.shape
        return (torch.arange(t, dtype=torch.int64, device=idx.device)[None, :]
                * v + idx.long())

    def forward(self, params, xs, state, training):
        (idx,) = xs
        tables = params["tables"]
        rows = F.embedding(self._flat_ids(tables, idx), self._flat(tables))
        return self.sparse_forward(rows, xs, state, training)

    def sparse_keys(self):
        return ("tables",)

    def sparse_rows(self, params, xs):
        (idx,) = xs
        tables = params["tables"]
        return _gather_dispatch(self._flat(tables), self._flat_ids(tables, idx))

    def sparse_forward(self, rows, xs, state, training):
        return [rows.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        (idx,) = xs
        tables = params["tables"]
        _scatter_add_dispatch(self._flat(tables), self._flat_ids(tables, idx),
                              -lr * row_grads)
        return params

    def sparse_flat_ids(self, params, xs):
        (idx,) = xs
        return self._flat_ids(params["tables"], idx)


class _HeteroTableInit(Initializer):
    """Per-table ``U(-1/sqrt(V_t), 1/sqrt(V_t))`` rows (``dlrm.cc:41-47``)
    and zero padding rows: one uniform draw scaled by a per-row range."""

    def __init__(self, offsets, vocab_sizes):
        self.offsets, self.vocab_sizes = offsets, vocab_sizes

    def __call__(self, gen, shape, dtype):
        scale = torch.zeros((shape[0],), dtype=torch.float32)
        for off, v in zip(self.offsets, self.vocab_sizes):
            scale[off:off + v] = 1.0 / math.sqrt(v)
        u = torch.empty(tuple(shape), dtype=torch.float32).uniform_(
            -1.0, 1.0, generator=gen)
        return (u * scale[:, None]).to(dtype)


class HeteroEmbedding(Op):
    """T tables of different vocabularies concatenated by rows into one
    ``(rows, D)`` parameter, ``rows`` the vocabulary total padded to a
    multiple of ``pad_to``: int ids (batch, T) -> (batch, T, D), row
    ``offsets[t] + idx[b, t]``.  Padding rows are never indexed."""

    mesh_refusal = "the stacked DLRM tables, ROADMAP.md queue 1, item 9b"

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        vocab_sizes,
        out_dim: int,
        dtype=torch.float32,
        out_dtype=None,
        pad_to: int = 128,
    ):
        super().__init__(name, [x])
        vocab_sizes = tuple(int(v) for v in vocab_sizes)
        if x.ndim != 2 or x.shape[1] != len(vocab_sizes):
            raise ValueError(f"{name}: ids must be (batch, {len(vocab_sizes)}), "
                             f"got {x.shape}")
        total = sum(vocab_sizes)
        rows = ((total + pad_to - 1) // pad_to) * pad_to
        offsets = tuple(sum(vocab_sizes[:i]) for i in range(len(vocab_sizes)))
        self.attrs = dict(vocab_sizes=vocab_sizes, out_dim=out_dim, rows=rows,
                          offsets=offsets)
        self.table_dtype = dtype
        self._offsets: Dict[torch.device, torch.Tensor] = {}
        self._make_output((x.shape[0], len(vocab_sizes), out_dim),
                          out_dtype or dtype, ("n", None, None))

    def param_specs(self) -> Dict[str, ParamSpec]:
        a = self.attrs
        return {"table": ParamSpec(
            (a["rows"], a["out_dim"]), self.table_dtype,
            _HeteroTableInit(a["offsets"], a["vocab_sizes"]), ("c", None))}

    def sparse_flat_ids(self, params, xs):
        """The global row ids ``offsets[t] + idx[b, t]`` (int64); the
        offsets are copied to the device once, so a step copies
        nothing from the host."""
        (idx,) = xs
        off = self._offsets.get(idx.device)
        if off is None:
            off = torch.tensor(self.attrs["offsets"], dtype=torch.int64,
                               device=idx.device)
            self._offsets[idx.device] = off
        return idx.long() + off[None, :]

    def forward(self, params, xs, state, training):
        rows = F.embedding(self.sparse_flat_ids(params, xs), params["table"])
        return self.sparse_forward(rows, xs, state, training)

    def sparse_keys(self):
        return ("table",)

    def sparse_rows(self, params, xs):
        return _gather_dispatch(params["table"], self.sparse_flat_ids(params, xs))

    def sparse_forward(self, rows, xs, state, training):
        return [rows.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        _scatter_add_dispatch(params["table"], self.sparse_flat_ids(params, xs),
                              -lr * row_grads)
        return params


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
        shard_rows: bool = False,
    ):
        super().__init__(name, [x])
        _refuse_shard_rows(name, shard_rows)
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
        return self.sparse_forward(F.embedding(idx, params["table"]), xs,
                                   state, training)

    def sparse_keys(self):
        return ("table",)

    def sparse_rows(self, params, xs):
        (idx,) = xs
        return _gather_dispatch(params["table"], idx)

    def sparse_forward(self, rows, xs, state, training):
        return [rows.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        (idx,) = xs
        _scatter_add_dispatch(params["table"], idx, -lr * row_grads)
        return params

    def sparse_flat_ids(self, params, xs):
        (idx,) = xs
        return idx
