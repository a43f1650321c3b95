"""Embedding operators: the port of ``flexflow_tpu/ops/embedding.py``.

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

Under a world of ranks a table whose leading parameter dim is tagged
``c`` (``MultiEmbedding``'s stacked T dim, ``HeteroEmbedding``'s rows,
``Embedding`` and ``WordEmbedding`` under ``shard_rows`` /
``--shard-embeddings``) is range-sharded over the op's ``c`` axes when
the ``c`` degree divides its leading extent (``_row_sharding``), and
runs replicated otherwise (``mesh_tags``), by JAX's rule.  Each rank
holds rows ``[start, start + R)`` of the flat ``(rows, D)`` view
(``_shard_offset``).  The lookup is JAX's ``_sharded_gather``: each rank
takes the ids in its range as a masked local gather (zero rows
elsewhere) and an all-reduce over the ``c`` axes assembles full rows,
never a full-table all-gather; its backward is the local masked
scatter-add into the rank's block of the gradient, with no collective.
On the executor's sparse path the local gather is K4 with the rank's
window (``row_start``).  The row-sparse update (``_scatter_add_dispatch``)
first all-gathers the batch's ids and updates over the op's ``n`` axes
in rank order, so every rank sees the global batch in batch order; a
replicated table then takes all of it with K5 (every replica the same
bits), a sharded one the rows in its window (K5 with ``row_start``).
Both directions are exact against the replicated forms: the all-reduce
adds zeros, and K5 sums each row's updates in batch order either way.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from flexflow_torch.initializers import Initializer, NormInitializer
from flexflow_torch.ops import kernels
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.parallel import collectives


def _rows_of(spec: ParamSpec, plan, pc):
    """``(c_axes, c_deg, local_rows)`` when a table of ``spec`` is
    row-range sharded under ``plan`` and ``pc``, else None: its leading
    dim is tagged ``c``, the ``c`` degree is above 1 and divides the
    leading extent (JAX's ``_row_sharding``).  ``local_rows`` counts rows
    of the flat ``(prod(shape[:-1]), D)`` view."""
    if not spec.dim_axes or spec.dim_axes[0] != "c" or plan is None \
            or pc is None:
        return None
    (c_axes, c_deg), = plan.local_degrees(pc, "c")
    if c_deg <= 1 or not c_axes or spec.shape[0] % c_deg:
        return None
    return c_axes, c_deg, math.prod(spec.shape[:-1]) // c_deg


def _row_sharding(op: Op, key: str):
    """:func:`_rows_of` for ``op``'s parameter ``key`` under its bound
    placement."""
    return _rows_of(op.param_specs()[key], op._plan, op._pc)


def _row_mesh_tags(spec: ParamSpec, plan, pc):
    """A table tagged ``c`` on its leading dim that the ``c`` degree does
    not divide runs replicated (JAX's rule: its lookup is then the plain
    take), so its leading tag is dropped."""
    if spec.dim_axes and spec.dim_axes[0] == "c" and plan is not None \
            and _rows_of(spec, plan, pc) is None:
        return (None,) + tuple(spec.dim_axes[1:])
    return spec.dim_axes


def _shard_offset(op: Op, shard) -> int:
    """The first flat row this rank holds: its block index over the ``c``
    axes times the block's rows."""
    c_axes, _, local_rows = shard
    return op._world.index(c_axes) * local_rows


def _note_shard_event(op: Op, event: str, **fields) -> None:
    """One telemetry event per (op, event) when a run's telemetry is on:
    the sharded gather and combine announce themselves the first time
    they run."""
    noted = op.__dict__.setdefault("_shard_events", set())
    if event in noted:
        return
    noted.add(event)
    from flexflow_torch.runtime import telemetry

    telemetry.current().emit(event, op=op.name, **fields)


def _id_axes(op: Op, flat_ids) -> tuple:
    """The mesh axes this rank's block of ``flat_ids`` is split on:
    batch-shaped ids keep their leading dim on the op's ``n`` axes (the
    spec it reads its ids in), a 1-D vector of unique ids is
    replicated."""
    if op._world is None or flat_ids.dim() < 2:
        return ()
    return tuple(op.input_spec(0, None)[0])


def gather_batch(op: Op, flat_ids, rows):
    """``(ids, rows)`` of the global batch: this rank's ids and row
    tensors (batch-shaped, their leading dim the batch) all-gathered over
    the op's ``n`` axes in rank order, so every rank holds them in batch
    order; the tensors themselves where the ids are not split."""
    axes = _id_axes(op, flat_ids)
    if not axes:
        return flat_ids, rows
    w = op._world
    return w.all_gather(flat_ids, 0, axes), w.all_gather(rows, 0, axes)


def _sharded_gather(op: Op, table, flat_ids, shard):
    """The dense forward's lookup of a row-sharded ``table (R, D)``: a
    masked local gather (zero rows for ids outside the rank's window)
    and an all-reduce over the ``c`` axes, whose backward is the
    identity, so the table's gradient is the local masked scatter-add of
    the whole cotangent (JAX's transpose, with no collective)."""
    c_axes, c_deg, local_rows = shard
    loc = flat_ids.long() - _shard_offset(op, shard)
    ok = (loc >= 0) & (loc < local_rows)
    rows = F.embedding(torch.where(ok, loc, 0), table)
    rows = torch.where(ok[..., None], rows, 0.0)
    _note_shard_event(op, "embedding_gather", shards=int(c_deg),
                      rows_per_shard=int(local_rows), combine="all_reduce")
    return collectives.all_reduce(rows, op._world, c_axes)


def _gather_dispatch(op: Op, table, flat_ids):
    """``table (R, D) [flat_ids] -> flat_ids.shape + (D,)`` by K4: the
    kernel on a CUDA table, its plain version on a CPU one (the wrapper's
    device rule); a row-sharded table's rank gathers its window and the
    rows are all-reduced over the ``c`` axes.  The executor's sparse path
    only: the result carries no autograd history."""
    ids = flat_ids.reshape(-1)
    shard = _row_sharding(op, op.sparse_keys()[0])
    if shard is None:
        rows = kernels.gather_rows(table, ids)
    else:
        _note_shard_event(op, "embedding_gather", shards=int(shard[1]),
                          rows_per_shard=int(shard[2]), combine="all_reduce")
        rows = op._world.all_reduce(kernels.gather_rows(
            table, ids, row_start=_shard_offset(op, shard)), shard[0])
    return rows.reshape(flat_ids.shape + (table.shape[1],))


def _scatter_add_dispatch(op: Op, table, flat_ids, upd):
    """``table[flat_ids] += upd`` in place by K5 (kernel on CUDA, plain
    version on the CPU) over the global batch (:func:`gather_batch`); a
    row-sharded table's rank takes the rows in its window.  Returns
    ``table``."""
    ids, upd = gather_batch(op, flat_ids, upd.to(table.dtype))
    return scatter_add_global(op, table, ids, upd)


def scatter_add_global(op: Op, table, ids, upd):
    """:func:`_scatter_add_dispatch` on ids and updates that are the
    global batch's already, the same on every rank (the pipeline gathers
    each microbatch's with :func:`gather_batch` and concatenates them in
    microbatch order)."""
    d = table.shape[1]
    shard = _row_sharding(op, op.sparse_keys()[0])
    if shard is not None:
        _note_shard_event(op, "embedding_combine", shards=int(shard[1]),
                          rows_per_shard=int(shard[2]),
                          combine="local_scatter_add")
    return kernels.scatter_add_rows(
        table, ids.reshape(-1), upd.to(table.dtype).reshape(-1, d),
        row_start=None if shard is None else _shard_offset(op, shard))


def _lookup(op: Op, table, flat_ids):
    """The dense forward's rows ``table (R, D) [flat_ids]``: the sharded
    gather when the op's table is row-sharded, else ``F.embedding``."""
    shard = _row_sharding(op, op.sparse_keys()[0])
    if shard is not None:
        return _sharded_gather(op, table, flat_ids, shard)
    return F.embedding(flat_ids, table)


class _RowTables:
    """The placement rule of the tables that may be row-sharded."""

    def mesh_tags(self, spec, plan, pc):
        return _row_mesh_tags(spec, plan, pc)


class Embedding(_RowTables, Op):
    """Single-table embedding lookup with bag aggregation: int ids
    (batch, bag) -> (batch, out_dim), summed or averaged over the bag.

    ``shard_rows=True`` (``--shard-embeddings``) tags the table
    ``("c", None)`` instead of the column split ``(None, "c")``: a ``c``
    degree then shards the vocabulary, and the output loses its ``c`` tag
    (the all-reduce assembles full rows)."""

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
        if x.ndim != 2:
            raise ValueError(f"embedding input must be (batch, bag), got "
                             f"{x.shape}")
        if aggr not in ("sum", "avg"):
            raise ValueError(f"{name}: aggr must be sum or avg, got {aggr!r}")
        self.attrs = dict(num_entries=num_entries, out_dim=out_dim, aggr=aggr)
        self.kernel_initializer = kernel_initializer or NormInitializer(0.0, 0.01)
        self.table_dtype = dtype
        self.shard_rows = bool(shard_rows)
        self._make_output((x.shape[0], out_dim), out_dtype or dtype,
                          ("n", None) if self.shard_rows else ("n", "c"))

    def param_specs(self) -> Dict[str, ParamSpec]:
        a = self.attrs
        return {"table": ParamSpec((a["num_entries"], a["out_dim"]),
                                   self.table_dtype, self.kernel_initializer,
                                   ("c", None) if self.shard_rows
                                   else (None, "c"))}

    def forward(self, params, xs, state, training):
        (idx,) = xs
        return self.sparse_forward(_lookup(self, params["table"], idx), xs,
                                   state, training)

    def sparse_keys(self):
        return ("table",)

    def sparse_rows(self, params, xs):
        (idx,) = xs
        return _gather_dispatch(self, params["table"], idx)

    def sparse_forward(self, rows, xs, state, training):
        y = rows.sum(dim=1) if self.attrs["aggr"] == "sum" else rows.mean(dim=1)
        return [y.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        (idx,) = xs
        _scatter_add_dispatch(self, params["table"], idx, -lr * row_grads)
        return params

    def sparse_flat_ids(self, params, xs):
        (idx,) = xs
        return idx


class MultiEmbedding(_RowTables, Op):
    """T same-shaped tables stacked into one ``(T, V, D)`` parameter (the
    DLRM form): int ids (batch, T) -> (batch, T, D), row ``idx[b, t]`` of
    table ``t``.  The flat row of ``(b, t)`` in the ``(T*V, D)`` view is
    ``t*V + idx[b, t]``, computed in int64.  The stacked dim is tagged
    ``c``: a strategy ``{"c": T}`` gives the reference's one table per
    device (``dlrm_strategy.cc:5-36``), each rank's ``T/c`` tables a
    window of the flat view."""

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
        v = self.attrs["num_entries"]
        return (torch.arange(self.attrs["num_tables"], dtype=torch.int64,
                             device=idx.device)[None, :] * v + idx.long())

    def output_spec(self, j: int):
        """Full rows of every table on each rank: the output is whole on
        its ``T`` dim (the all-reduce assembles the rows of a sharded
        table, and a replicated one gathers all of them)."""
        spec = super().output_spec(j)
        return (spec[0], ()) + tuple(spec[2:])

    def forward(self, params, xs, state, training):
        (idx,) = xs
        tables = params["tables"]
        rows = _lookup(self, self._flat(tables), self._flat_ids(tables, idx))
        return self.sparse_forward(rows, xs, state, training)

    def sparse_keys(self):
        return ("tables",)

    def sparse_rows(self, params, xs):
        (idx,) = xs
        tables = params["tables"]
        return _gather_dispatch(self, self._flat(tables),
                                self._flat_ids(tables, idx))

    def sparse_forward(self, rows, xs, state, training):
        return [rows.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        (idx,) = xs
        tables = params["tables"]
        _scatter_add_dispatch(self, self._flat(tables),
                              self._flat_ids(tables, idx), -lr * row_grads)
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


class HeteroEmbedding(_RowTables, Op):
    """T tables of different vocabularies concatenated by rows into one
    ``(rows, D)`` parameter, ``rows`` the vocabulary total padded to a
    multiple of ``pad_to``: int ids (batch, T) -> (batch, T, D), row
    ``offsets[t] + idx[b, t]``.  Padding rows are never indexed.  The row
    dim is tagged ``c``: a ``c`` degree that divides the padded rows
    shards row ranges regardless of table boundaries."""

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
        rows = _lookup(self, params["table"], self.sparse_flat_ids(params, xs))
        return self.sparse_forward(rows, xs, state, training)

    def sparse_keys(self):
        return ("table",)

    def sparse_rows(self, params, xs):
        return _gather_dispatch(self, params["table"],
                                self.sparse_flat_ids(params, xs))

    def sparse_forward(self, rows, xs, state, training):
        return [rows.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        _scatter_add_dispatch(self, params["table"],
                              self.sparse_flat_ids(params, xs),
                              -lr * row_grads)
        return params


class WordEmbedding(_RowTables, Op):
    """Token embedding over (batch, seq) int ids -> (batch, seq, dim).
    ``shard_rows=True`` (``--shard-embeddings``) tags the table
    ``("c", None)``, so a ``c`` degree shards the vocabulary; the table is
    replicated otherwise."""

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
        if x.ndim != 2:
            raise ValueError(f"word embedding input must be (batch, seq), "
                             f"got {x.shape}")
        self.attrs = dict(num_entries=num_entries, out_dim=out_dim)
        self.kernel_initializer = kernel_initializer or NormInitializer(0.0, 0.01)
        self.table_dtype = dtype
        self.shard_rows = bool(shard_rows)
        self._make_output((x.shape[0], x.shape[1], out_dim), out_dtype or dtype,
                          ("n", "s", None))

    def param_specs(self) -> Dict[str, ParamSpec]:
        a = self.attrs
        return {
            "table": ParamSpec((a["num_entries"], a["out_dim"]),
                               self.table_dtype, self.kernel_initializer,
                               ("c", None) if self.shard_rows else ())
        }

    def forward(self, params, xs, state, training):
        (idx,) = xs
        return self.sparse_forward(_lookup(self, params["table"], idx), xs,
                                   state, training)

    def sparse_keys(self):
        return ("table",)

    def sparse_rows(self, params, xs):
        (idx,) = xs
        return _gather_dispatch(self, params["table"], idx)

    def sparse_forward(self, rows, xs, state, training):
        return [rows.to(self.outputs[0].dtype)], state

    def sparse_apply(self, params, xs, row_grads, lr):
        (idx,) = xs
        _scatter_add_dispatch(self, params["table"], idx, -lr * row_grads)
        return params

    def sparse_flat_ids(self, params, xs):
        (idx,) = xs
        return idx
