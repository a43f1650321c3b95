"""Graph executor: parameter init, the forward over the op graph, and the
dense train step, on one device or on each rank of a mesh.

The port of ``flexflow_tpu/runtime/executor.py``:

- ``init_params`` returns the params on the device, and ``init``
  ``(params, opt_state, state)`` for training;
- ``forward`` runs the ops (every op, or those given) and returns
  ``(loss, metrics, new_state, env)``;
- ``train_step`` is one iteration (forward, backward by autograd through
  the kernels' ``torch.autograd.Function``s, ``--clip-norm``, the
  optimizer update) and returns ``(params, opt_state, state, metrics)``.
  Parameters and optimizer state are updated IN PLACE, the torch form of
  the JAX step's buffer donation; the metrics stay device tensors, so a
  step never waits on the device;
- ``eval_step`` and the eval ``forward_step`` (every non-loss output);
- ``--remat``: each non-loss op runs under
  ``torch.utils.checkpoint`` in a training forward, its activations
  dropped and recomputed in the backward (from a copy of the op's state
  as the step found it, so Dropout recomputes the step's mask);
- op state (Dropout's RNG key): made by ``init`` from each op's
  ``state_specs``; a training forward writes an op's new state into
  the state's tensors IN PLACE, so a captured superstep advances it;
- gradient accumulation (``accum_train_step``): one optimizer update
  from the mean gradient of ``accum_steps`` stacked microbatches;
- the superstep (``build_superstep``): k train steps (or accumulated
  steps) as one CUDA graph replayed from the host in one launch, their
  metrics stacked ``(k, ...)`` (``runtime/graphs.py``).

The row-sparse embedding path (``_sparse_ops``): when the config enables
it and the optimizer's rule allows it, an embedding op's rows are
gathered (K4), autograd differentiates with respect to those rows only,
and the row gradients are scatter-added into the table in place (K5), so
no table-sized gradient exists.  Plain SGD scatters ``-lr * g`` per
occurrence; lazy momentum/Adam (``--lazy-sparse-opt``) sum the gradients
per unique row and scatter-add deltas of the parameter and state rows.

Under a world of ranks (``parallel/launch.py``) the executor binds a
``MeshPlan`` of the world's size and each op's ``ParallelConfig`` (the
strategy's, data parallelism for an op it does not name), as JAX's does
(``executor.py:108-131``, ``:357``), and every rank runs the same program
on its blocks: shard_map done by hand.

- ``init`` draws the full parameters from the seed, as on one device;
  each rank keeps its block of each (``MeshPlan.local_slices``).
  ``shard_batch`` keeps the rank's block of a host (numpy) batch; a
  tensor batch is taken as the rank's block already.
- The forward reshards each input from its producer's spec to the spec
  its consumer reads (``Op.input_spec``, ``collectives.reshard``), JAX's
  ``_reshard_input``.
- Each parameter's gradient is all-reduced over every mesh axis on which
  the parameter is replicated but its op's work is split (the axes of
  the op's input specs); the ``--clip-norm`` norm sums the squares of a
  sharded parameter over its shards and counts a replicated one once;
  the loss ops reduce the loss and metrics over the mesh, so
  ``train_loss`` is the global batch's mean.
- ZeRO-1 (``--zero-opt``, JAX's ``executor.py:203-261``): the optimizer
  state is born split on its leading dim over the op's data-parallel
  axes, appended after the parameter's own leading-dim axes (each rank
  then holds the state of rows it holds; JAX sorts them into mesh order,
  which GSPMD realizes with a shuffle).  The gradients over those axes
  are reduce-scattered, each rank updates its slice, and the parameter
  is all-gathered.
- The row-sparse step runs on each rank's tables (``ops/embedding.py``):
  the ids and row gradients of the batch are all-gathered over each
  op's ``n`` axes in rank order, a replicated table takes the whole
  batch with K5 (every replica the same bits), a row-sharded one the
  rows in its window.  The unique row sums (the clip norm's squares,
  the lazy optimizers' steps) are taken over that global batch, so they
  are the same on every rank and the clip norm counts them once.  Lazy
  momentum and Adam keep the table's state split as the table is; each
  rank gathers and scatters the unique rows it holds (K4 and K5 with its
  window).  Under ZeRO-1 the row-sparse tables' state keeps the table's
  own split: JAX's lazy step reads it whole through GSPMD, so the values
  are the same.
- The ``s`` degree splits the sequence: the ops that read it whole
  split their work along it themselves (ring attention,
  ``ops/attention.py``; the LSTM's pipeline, ``ops/rnn.py``).
- The training machinery runs on every rank (JAX's single controller
  makes each of its decisions once; here every rank makes it the same
  way):

  - gradient accumulation sums each rank's unreduced microbatch
    gradients in f32 and reduces their mean once (``_dense_update``:
    the all-reduce, or ZeRO-1's reduce-scatter, then the world's clip
    norm and one update);
  - ``--remat`` recomputes an op's forward in the backward, its
    collectives (the ring's shifts, the MoE's reduce-scatter and
    all-gathers) issued again by every rank in the same order;
  - a superstep's stacked inputs are cut to the rank's blocks after
    their leading step (and microbatch) dims (``stack_steps``); over
    NCCL on CUDA the k steps are one CUDA graph with their collectives
    captured, over gloo a loop (``superstep_graph``);
  - snapshots hold whole tensors whatever the strategy
    (``snapshot_layout``: every rank gathers before rank 0 writes, and
    each rank cuts its blocks out of what it restores);
  - ``agree`` ORs the host's flags (a preemption, a failed step) over the
    world, so every rank takes the same branch.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.ops import embedding, kernels
from flexflow_torch.ops.base import Op
from flexflow_torch.parallel import collectives, launch
from flexflow_torch.parallel.distributed import build_hybrid_mesh_plan
from flexflow_torch.parallel.mesh import replicated
from flexflow_torch.parallel.strategy import StrategyStore
from flexflow_torch.runtime.graphs import StepGraph

Tree = Dict[str, Dict[str, torch.Tensor]]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another.  Raises when CUDA is asked for and absent: an
    entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flexflow_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the "
            "CPU"
        )
    return dev


def _unique_row_sums(flat_ids, flat_g):
    """Sum the row gradients of duplicate ids: ``(uids, gsum, mask)``,
    each of the fixed size ``n`` so nothing waits on the device.  The ids
    are sorted stably; slot ``i`` holds sorted id ``uids[i]``, and where
    ``mask[i]`` (the last slot of each run of equal ids) ``gsum[i]`` is
    the run's summed gradient, elsewhere zeros.  That is what the dense
    scatter-add gradient holds per touched row, at batch size.  The sums
    come from a segmented scan (log2 n passes of elementwise adds) in a
    fixed order: deterministic, with no float atomics."""
    n = flat_ids.shape[0]
    uids, order = torch.sort(flat_ids, stable=True)
    acc = flat_g.index_select(0, order)
    first = torch.ones(n, dtype=torch.bool, device=flat_ids.device)
    first[1:] = uids[1:] != uids[:-1]
    seg = torch.cumsum(first.int(), 0)
    off = 1
    while off < n:
        same = (seg[off:] == seg[:-off])[:, None]
        acc = torch.cat([acc[:off],
                         acc[off:] + torch.where(same, acc[:-off], 0.0)])
        off *= 2
    mask = torch.ones(n, dtype=torch.bool, device=flat_ids.device)
    mask[:-1] = first[1:]
    return uids, torch.where(mask[:, None], acc, 0.0), mask


def _merge_metrics(acc: Dict[str, torch.Tensor],
                   m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(acc)
    for k, v in m.items():
        out[k] = out[k] + v if k in out else v
    return out


def mean_metrics(metrics: Dict[str, torch.Tensor], count: Optional[int] = None,
                 stacked: bool = False) -> Dict[str, torch.Tensor]:
    """Count-aware reduction of per-microbatch metrics: integer metrics
    are counts and sum, float metrics are means and average.
    ``stacked=True`` reduces a leading microbatch axis; otherwise the
    metrics are already summed over ``count`` microbatches and the float
    entries are scaled by the float32 reciprocal of ``count`` (a
    multiply, as the JAX package writes it)."""
    if stacked:
        return {k: v.float().mean(dim=0) if v.is_floating_point()
                else v.sum(dim=0) for k, v in metrics.items()}
    inv = float(np.float32(1.0) / np.float32(count))
    return {k: v * inv if v.is_floating_point() else v
            for k, v in metrics.items()}


_WORLDS: Dict[tuple, "collectives.World"] = {}


def _world_for(plan) -> "collectives.World":
    """The rank's ``World`` for ``plan``, made once per mesh shape (its
    groups are made by every rank together)."""
    key = (plan.axis_names, plan.axis_sizes)
    if key not in _WORLDS:
        _WORLDS[key] = collectives.World(plan)
    return _WORLDS[key]


class Executor:
    def __init__(self, model: FFModel, config: Optional[FFConfig] = None,
                 optimizer=None, device=None,
                 strategy: Optional[StrategyStore] = None):
        self.model = model
        self.config = config or model.config
        self.device = resolve_device(device)
        #: None for an executor that only runs forwards; ``init`` and
        #: ``train_step`` need one (``apps.common.make_optimizer`` builds
        #: it from the flags).
        self.optimizer = optimizer
        nd = launch.world_size()
        self.plan = build_hybrid_mesh_plan(nd, max(self.config.granules, 1))
        self.strategy = strategy or StrategyStore.data_parallel(nd)
        self.strategy.check_full_mesh()
        #: The rank's World in a world of ranks (one included), else None:
        #: one device, no spec bookkeeping at all.
        self.world = _world_for(self.plan) if launch.in_world() else None
        if nd > 1:
            for op in self.model.layers:
                self.plan.assign(self._pc(op))  # InfeasibleStrategyError
        #: Per op, the mesh axes its work is split on (``_op_work_axes``).
        self._work_axes: Dict[str, tuple] = {}

    def _pc(self, op: Op):
        return self.strategy.find(op.name)

    def _bind(self, op: Op) -> Op:
        op.bind_mesh(self.plan, self._pc(op), self.world)
        return op

    def _param_spec(self, op: Op, spec):
        pc = self._pc(op)
        return self.plan.spec(pc, op.mesh_tags(spec, self.plan, pc),
                              spec.shape)

    @functools.cached_property
    def _batch_specs(self) -> Dict[str, tuple]:
        """Each input's spec: the one its first consumer reads it in (the
        mapper slicing the loader over the consumer's tasks)."""
        out = {}
        for t in self.model.input_tensors:
            out[t.name] = replicated(t.ndim)
            for op in self.model.layers:
                if t in op.inputs:
                    out[t.name] = self._bind(op).input_spec(
                        op.inputs.index(t), replicated(t.ndim))
                    break
        return out

    def _op_inputs(self, op: Op, env) -> List[torch.Tensor]:
        """``op``'s inputs from ``env`` (the batch's blocks), each in the
        spec the op reads it in."""
        if self.world is None:
            return [env[t.name] for t in op.inputs]
        return [collectives.reshard(env[t.name], self._batch_specs[t.name],
                                    op.input_spec(i, self._batch_specs[
                                        t.name]), self.world)
                for i, t in enumerate(op.inputs)]

    def _require_optimizer(self, what: str):
        if self.optimizer is None:
            raise ValueError(
                f"Executor.{what} needs an optimizer: pass optimizer="
                f"make_optimizer(cfg) (flexflow_torch.apps.common)")
        return self.optimizer

    # -- initialization ------------------------------------------------------

    def draw_params_and_state(self, seed: Optional[int] = None):
        """The full ``(params, state)`` on the host, drawn from a
        ``torch.Generator`` seeded with ``seed`` (default
        ``config.seed``): op by op, its params and then its state, key by
        key in sorted order: the JAX package's order, not its values."""
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        params: Tree = {}
        state: Tree = {}
        for op in self.model.layers:
            for tree, specs in ((params, op.param_specs()),
                                (state, op.state_specs())):
                if specs:
                    tree[op.name] = {k: specs[k].initializer(
                        gen, specs[k].shape, specs[k].dtype)
                        for k in sorted(specs)}
        return params, state

    def init_params_and_state(self, seed: Optional[int] = None):
        """Fresh ``(params, state)``, each ``{op_name: {key: tensor}}`` on
        the device: the rank's blocks of :meth:`draw_params_and_state`'s."""
        params, state = self.draw_params_and_state(seed)
        out = []
        for tree, specs_of in ((params, lambda op: op.param_specs()),
                               (state, lambda op: op.state_specs())):
            out.append({op.name: {k: self._local(op, specs_of(op)[k],
                                                 tree[op.name][k])
                                  for k in tree[op.name]}
                        for op in self.model.layers if op.name in tree})
        return tuple(out)

    def _local(self, op: Op, spec, full: torch.Tensor) -> torch.Tensor:
        """The rank's block of a full parameter (or state) on the device,
        a tensor of its own (``full`` is never trained in place)."""
        if self.world is not None:
            full = full[self.plan.local_slices(
                self._param_spec(op, spec), full.shape, self.world.rank)]
        return full.to(self.device, memory_format=torch.contiguous_format,
                       copy=True)

    def param_specs(self) -> Dict[str, Dict[str, tuple]]:
        """``{op: {key: spec}}`` of every parameter, and of the op state
        under the same keys' op (``weights.params_from_numpy`` cuts full
        arrays by these)."""
        out: Dict[str, Dict[str, tuple]] = {}
        for op in self.model.layers:
            specs = {**op.param_specs(), **op.state_specs()}
            if specs:
                out[op.name] = {k: self._param_spec(op, v)
                                for k, v in specs.items()}
        return out

    def zero_specs(self) -> Dict[str, Dict[str, tuple]]:
        """``{op: {key: spec}}`` of the optimizer state's parameter-shaped
        leaves: the parameter's spec under plain training, with
        ``--zero-opt`` its leading dim further split over the op's
        data-parallel axes (appended minor-most, see the module
        docstring)."""
        out: Dict[str, Dict[str, tuple]] = {}
        for op in self.model.layers:
            if op.param_specs():
                out[op.name] = {}
                for k, v in op.param_specs().items():
                    spec = self._param_spec(op, v)
                    extra = self._zero_axes(op, v)
                    out[op.name][k] = ((spec[0] + extra,) + spec[1:]
                                       if extra else spec)
        return out

    @torch.no_grad()
    def gather_full(self, tree, specs=None):
        """The full tensors of a ``{op: {key: block}}`` tree (parameters,
        op state, or with ``specs=zero_specs()`` the optimizer state's
        moments), reassembled on every rank; the tree itself on one
        device."""
        if self.world is None:
            return tree
        specs = specs or self.param_specs()
        return {op: {k: collectives.reshard(v, specs[op][k],
                                            replicated(v.dim()), self.world)
                     for k, v in group.items()}
                for op, group in tree.items()}

    def _zero_axes(self, op: Op, spec) -> tuple:
        """The data-parallel axes ZeRO-1 splits a parameter's optimizer
        state over: those JAX's spec adds to the leading dim
        (``MeshPlan.spec(extra_leading_axes=...)``) along which the
        parameter is replicated and its gradient a partial sum."""
        if not self.config.zero_sharded_optimizer or self.world is None \
                or not spec.shape or op in self._sparse_ops:
            return ()
        pc = self._pc(op)
        own = self._param_spec(op, spec)
        jax_spec = self.plan.spec(pc, op.mesh_tags(spec, self.plan, pc),
                                  spec.shape,
                                  extra_leading_axes=self.plan.assign(pc).get(
                                      "n", ()))
        work = self._op_work_axes(op)
        return tuple(a for a in jax_spec[0]
                     if a not in own[0] and a in work
                     and a not in collectives.axes_of(own))

    def _op_work_axes(self, op: Op) -> tuple:
        """The mesh axes of the specs ``op`` reads its inputs in: its
        work is split on them.  (``Linear`` may read a contraction split
        on its own ``c`` axes, which split its kernel as well, so they
        never reduce a gradient.)"""
        if op.name not in self._work_axes:
            self._bind(op)
            self._work_axes[op.name] = collectives.axes_of(*(
                op.input_spec(i, replicated(t.ndim))
                for i, t in enumerate(op.inputs)))
        return self._work_axes[op.name]

    def init_params(self, seed: Optional[int] = None) -> Tree:
        """The params of :meth:`init_params_and_state`."""
        return self.init_params_and_state(seed)[0]

    def init(self, seed: Optional[int] = None):
        """Fresh ``(params, opt_state, state)`` for training; ``state``
        holds the op state (``{}`` when no op keeps any)."""
        opt = self._require_optimizer("init")
        params, state = self.init_params_and_state(seed)
        if self.config.zero_sharded_optimizer and self.world is not None:
            # Born split: the moments of each rank's slice only.
            return params, opt.init(self._zero_views(params)), state
        return params, opt.init(params), state

    def _zero_views(self, tree):
        """Each parameter's ZeRO-1 slice as a view of the rank's block
        (the whole block where no data-parallel axis splits it)."""
        out = {}
        for op in self.model.layers:
            if op.name not in tree:
                continue
            out[op.name] = {}
            for k, v in op.param_specs().items():
                p = tree[op.name][k]
                extra = self._zero_axes(op, v)
                out[op.name][k] = self.world.block(p, 0, extra) if extra \
                    else p
        return out

    def shard_batch(self, batch: Mapping[str, Any],
                    lead: int = 0) -> Dict[str, torch.Tensor]:
        """A host batch as tensors on the device, each in its input's
        dtype.  Under a mesh a host (numpy) array is the global batch and
        the rank keeps its block of it, cut on the dims after the
        ``lead`` leading ones (a superstep's steps, an accumulated step's
        microbatches), which stay whole; a tensor is taken as the rank's
        block already."""
        out = {}
        for t in self.model.input_tensors:
            if t.name not in batch:
                continue
            v = batch[t.name]
            if self.world is not None and not isinstance(v, torch.Tensor):
                v = np.asarray(v)
                v = v[(slice(None),) * lead + self.plan.local_slices(
                    self._batch_specs[t.name], v.shape[lead:],
                    self.world.rank)]
            out[t.name] = torch.as_tensor(v).to(self.device, t.dtype)
        return out

    def agree(self, *flags: bool) -> tuple:
        """The host's ``flags`` OR-ed over the world (one small
        collective on the host), so every rank takes the same branch;
        the flags themselves on one device."""
        if self.world is None:
            return tuple(bool(f) for f in flags)
        return self.world.agree(*flags)

    def snapshot_layout(self) -> Optional["SnapshotLayout"]:
        """The layout hook of ``CheckpointManager`` under a world (whole
        tensors on disk, the rank's blocks in memory); None on one
        device, where the two are the same."""
        return None if self.world is None else SnapshotLayout(self)

    # -- forward -------------------------------------------------------------

    def _inputs(self, batch, names) -> Dict[str, torch.Tensor]:
        """The batch's inputs among ``names`` on the device, shapes
        checked."""
        env = self.shard_batch({t.name: batch[t.name]
                                for t in self.model.input_tensors
                                if t.name in names})
        for t in self.model.input_tensors:
            # The sample dim may shrink; feature dims are structural.
            strict = 1 if (t.dim_axes and t.dim_axes[0] == "n") else 0
            shape = t.shape if self.world is None else \
                self.plan.local_shape(self._batch_specs[t.name], t.shape)
            if t.name in env and \
                    tuple(env[t.name].shape[strict:]) != shape[strict:]:
                raise ValueError(f"input {t.name}: expected {shape}, got "
                                 f"{tuple(env[t.name].shape)}")
        return env

    def forward(self, params, state, batch: Mapping[str, Any],
                training: bool, layers: Optional[List] = None,
                rows_override: Optional[Mapping[str, torch.Tensor]] = None):
        """Run the op graph, or the ops in ``layers`` (in graph order);
        ``batch`` needs only the inputs they read.  Returns ``(loss,
        metrics, new_state, env)``; ``env`` maps every tensor name to its
        value, except the loss ops' outputs, which no op reads and the
        port does not compute (``ops/losses.py``).  ``rows_override``
        maps an op name to its pre-gathered embedding rows: that op runs
        ``sparse_forward`` and never touches its table."""
        layers = self.model.layers if layers is None else layers
        rows_override = rows_override or {}
        env = self._inputs(batch, {t.name for op in layers for t in op.inputs})
        specs = {} if self.world is None else {
            k: self._batch_specs[k] for k in env}
        total_loss = None
        metrics: Dict[str, torch.Tensor] = {}
        new_state: Dict[str, Any] = {}
        for op in layers:
            self._bind(op)
            if self.world is None:
                xs = [env[t.name] for t in op.inputs]
            else:
                xs = [collectives.reshard(env[t.name], specs[t.name],
                                          op.input_spec(i, specs[t.name]),
                                          self.world)
                      for i, t in enumerate(op.inputs)]
            s = state.get(op.name, {})
            if op.name in rows_override:
                result, s_new = op.sparse_forward(rows_override[op.name], xs,
                                                  s, training)
            elif self.config.remat and training and (
                    not op.is_loss or op.allow_remat):
                # Per-layer rematerialization (jax.checkpoint in the JAX
                # package): the op's activations are dropped after the
                # forward and recomputed in the backward.  The recompute
                # reads a copy of the op's state as this step found it
                # (the state itself advances in place below), so a
                # Dropout draws the step's mask again; torch's RNG state
                # is not kept (no op uses it, and reading it would break
                # a CUDA graph capture).
                s_step = {k: v.clone() for k, v in s.items()}
                result, s_new = torch.utils.checkpoint.checkpoint(
                    op.forward, params.get(op.name, {}), xs, s_step,
                    training, use_reentrant=False, preserve_rng_state=False)
                if s_new is s_step:
                    s_new = s
            else:
                result, s_new = op.forward(params.get(op.name, {}), xs, s,
                                           training)
            if op.is_loss:
                loss, m, ys = result
                total_loss = loss if total_loss is None else total_loss + loss
                metrics = _merge_metrics(metrics, m)
            else:
                ys = result
            for j, (t, y) in enumerate(zip(op.outputs, ys)):
                env[t.name] = y
                if self.world is not None:
                    specs[t.name] = op.output_spec(j)
            if s and s_new is not s:
                # The op's new state goes into its state's tensors in
                # place: a captured step must hand back the tensors it
                # was given.
                with torch.no_grad():
                    for k, v in s_new.items():
                        s[k].copy_(v)
                new_state[op.name] = s
            elif s_new:
                new_state[op.name] = s_new
        if total_loss is None:
            total_loss = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        return total_loss, metrics, new_state, env

    @torch.inference_mode()
    def forward_step(self, params, batch,
                     state=None) -> Dict[str, torch.Tensor]:
        """Eval forward over the non-loss ops, returning every non-loss
        op output by tensor name (``outs["lm_head:out"]`` is the LM's
        full-sequence logits).  ``batch`` needs only the inputs those
        ops read (an LM's labels feed its loss alone); ``state`` is the
        op state an eval forward reads (BatchNorm's running
        statistics)."""
        layers = [op for op in self.model.layers if not op.is_loss]
        _, _, _, env = self.forward(params, state or {}, batch,
                                    training=False, layers=layers)
        return {t.name: env[t.name] for op in layers for t in op.outputs}

    # -- steps ---------------------------------------------------------------

    def loss_and_grads(self, params, state, batch):
        """``(loss, metrics, new_state, grads)`` of one training forward
        and backward; ``grads`` has the params' structure and dtypes
        (zeros for a parameter the loss does not reach, as JAX gives).
        Under a mesh each gradient is the rank's block of the global
        batch's gradient."""
        loss, metrics, new_state, grads, _ = self._grads(params, state, batch)
        return loss, metrics, new_state, self._reduce_grads(grads)

    def _reduce_grads(self, grads, zero: bool = False):
        """All-reduce each gradient over the axes on which its parameter
        is replicated but its op's work is split (bucketed by axes and
        dtype: one collective per bucket).  With ``zero`` the op's ZeRO-1
        axes are reduce-scattered along the leading dim instead, and the
        result is the rank's ZeRO slice of each gradient."""
        if self.world is None:
            return grads
        out = {op: dict(g) for op, g in grads.items()}
        buckets: Dict[tuple, List[tuple]] = {}
        for op in self.model.layers:
            if op.name not in grads:
                continue
            work = self._op_work_axes(op)
            for k, spec in op.param_specs().items():
                own = collectives.axes_of(self._param_spec(op, spec))
                red = tuple(a for a in work if a not in own)
                extra = self._zero_axes(op, spec) if zero else ()
                if extra:
                    out[op.name][k] = self.world.reduce_scatter(
                        grads[op.name][k], 0, extra)
                    red = tuple(a for a in red if a not in extra)
                if red:
                    g = out[op.name][k]
                    buckets.setdefault((red, g.dtype), []).append(
                        (op.name, k))
        for (axes, _), items in buckets.items():
            flat = torch.cat([out[o][k].reshape(-1) for o, k in items])
            flat = self.world.all_reduce(flat, axes)
            for (o, k), part in zip(items, flat.split(
                    [out[o][k].numel() for o, k in items])):
                out[o][k] = part.view_as(out[o][k])
        return out

    def _grads(self, params, state, batch, rows=None):
        """The forward and one ``torch.autograd.grad`` over the params and
        the pre-gathered ``rows`` (op name -> rows, made leaves here):
        ``(loss, metrics, new_state, grads, row_grads)``."""
        rows = {k: r.requires_grad_(True) for k, r in (rows or {}).items()}
        leaves = [p.requires_grad_(True) for g in params.values()
                  for p in g.values()]
        loss, metrics, new_state, env = self.forward(
            params, state, batch, training=True, rows_override=rows)
        del env  # free what autograd does not keep before the backward
        flat = torch.autograd.grad(loss, leaves + list(rows.values()),
                                   allow_unused=True)
        it = iter(flat)
        grads = {}
        for op, group in params.items():
            grads[op] = {}
            for k, p in group.items():
                g = next(it)
                grads[op][k] = torch.zeros_like(p) if g is None else g
        row_grads = {}
        for op, r in rows.items():
            g = next(it)
            row_grads[op] = torch.zeros_like(r) if g is None else g
        return loss.detach(), metrics, new_state, grads, row_grads

    def _clip_scale(self, grads, extra_sq=0.0):
        """The --clip-norm factor ``min(1, c / ||g||)`` over the global L2
        norm of ``grads`` plus ``extra_sq`` (the sparse ops' squared
        per-unique-row sums): one f32 device scalar, nothing read back.
        One formula for the dense and the sparse step.  Under a mesh the
        squares of a gradient split over some axes are summed over them
        (its spec's, or its ZeRO slice's with ``--zero-opt``); a
        replicated one counts once."""
        if self.world is None:
            sq = extra_sq + sum(g.float().square().sum()
                                for group in grads.values()
                                for g in group.values())
        else:
            by_axes: Dict[tuple, Any] = {}
            specs = (self.zero_specs() if self.config.zero_sharded_optimizer
                     else self.param_specs())
            for op, group in grads.items():
                for k, g in group.items():
                    axes = collectives.axes_of(specs[op][k])
                    by_axes[axes] = by_axes.get(axes, 0.0) + \
                        g.float().square().sum()
            sq = extra_sq
            for axes, part in by_axes.items():
                sq = sq + self.world.all_reduce(part, axes)
        return torch.clamp(self.config.clip_norm
                           * torch.rsqrt(torch.clamp(sq, min=1e-30)), max=1.0)

    @staticmethod
    def _scaled(grads, scale):
        return {op: {k: (g.float() * scale).to(g.dtype)
                     for k, g in group.items()}
                for op, group in grads.items()}

    @functools.cached_property
    def _sparse_ops(self) -> List[Op]:
        """Ops taking the row-sparse update path: embedding ops whose
        params are all sparse keys, f32 (a narrower table would round per
        duplicate in the scatter, unlike the dense update's one rounding)
        and indexed straight from the batch, when the config enables the
        path and the optimizer's rule allows it."""
        if not self.config.sparse_embedding_updates or \
                not getattr(self.optimizer, "supports_sparse_rows", False):
            return []
        input_names = {t.name for t in self.model.input_tensors}
        out = []
        for op in self.model.layers:
            keys, specs = op.sparse_keys(), op.param_specs()
            if keys and set(keys) == set(specs) and \
                    all(s.dtype == torch.float32 for s in specs.values()) and \
                    all(t.name in input_names for t in op.inputs) and \
                    op.sparse_ok(self.plan, self._pc(op)):
                out.append(op)
        return out

    def train_step(self, params, opt_state, state, batch):
        """One iteration: forward, backward, clip, optimizer update in
        place.  Returns ``(params, opt_state, state, metrics)``."""
        self._require_optimizer("train_step")
        if self._sparse_ops:
            return self._sparse_train_step(params, opt_state, state, batch)
        _loss, metrics, new_state, grads, _ = self._grads(params, state, batch)
        opt_state, _ = self._dense_update(params, opt_state, grads)
        return params, opt_state, new_state, metrics

    def _dense_update(self, params, opt_state, grads, extra_sq=0.0):
        """Reduce ``grads`` over the mesh, clip them (the norm taking
        ``extra_sq`` too) and update ``params`` in place; under ZeRO-1
        each rank updates its slice and the slices are all-gathered into
        the parameters.  Returns ``(opt_state, clip scale or None)``."""
        opt = self.optimizer
        zero = self.config.zero_sharded_optimizer and self.world is not None
        grads = self._reduce_grads(grads, zero=zero)
        scale = None
        if self.config.clip_norm and self.config.clip_norm > 0.0:
            scale = self._clip_scale(grads, extra_sq)
            grads = self._scaled(grads, scale)
        if not zero:
            _, opt_state = opt.update(params, opt_state, grads)
            return opt_state, scale
        views = self._zero_views(params)
        _, opt_state = opt.update(views, opt_state, grads)
        with torch.no_grad():
            for op in self.model.layers:
                if op.name not in params:
                    continue
                for k, spec in op.param_specs().items():
                    extra = self._zero_axes(op, spec)
                    if extra:
                        params[op.name][k].copy_(self.world.all_gather(
                            views[op.name][k], 0, extra))
        return opt_state, scale

    def _sparse_train_step(self, params, opt_state, state, batch):
        """The train step with the sparse ops' tables updated row-wise
        (``flexflow_tpu/runtime/executor.py``'s sparse step): the rows
        are gathered, the dense params and the rows differentiated in one
        backward, the dense params updated first (the sparse tables'
        optimizer state filtered out and put back), then the tables.
        Under a mesh the unique row sums are taken over the global batch
        (``embedding.gather_batch``), the same on every rank."""
        opt = self.optimizer
        ops = [self._bind(op) for op in self._sparse_ops]
        names = {op.name for op in ops}
        env = self._inputs(batch, {t.name for op in ops for t in op.inputs})
        xs = {op.name: self._op_inputs(op, env) for op in ops}
        with torch.no_grad():
            rows = {op.name: op.sparse_rows(params[op.name], xs[op.name])
                    for op in ops}
        dense = {k: v for k, v in params.items() if k not in names}
        _loss, metrics, new_state, dg, rg = self._grads(dense, state, batch,
                                                        rows)
        stateless = opt.stateless_sparse
        clip = self.config.clip_norm > 0.0
        uniq = {}
        if clip or not stateless:
            with torch.no_grad():
                for op in ops:
                    ids, g = embedding.gather_batch(
                        op, op.sparse_flat_ids(params[op.name], xs[op.name]),
                        rg[op.name])
                    uniq[op.name] = _unique_row_sums(
                        ids.reshape(-1), g.reshape(-1, g.shape[-1]))
        extra_sq = sum(gsum.square().sum() for _, gsum, _ in uniq.values()) \
            if clip else 0.0
        opt_dense = opt.map_param_states(
            opt_state, lambda tree: {k: v for k, v in tree.items()
                                     if k not in names})
        new_opt, scale = self._dense_update(dense, opt_dense, dg, extra_sq)
        if new_opt is not None:
            new_opt = opt.restore_param_states(new_opt, opt_state, names)
        with torch.no_grad():
            for op in ops:
                if stateless:
                    g = rg[op.name] if scale is None else rg[op.name] * scale
                    op.sparse_apply(params[op.name], xs[op.name], g, opt.lr)
                else:
                    new_opt = self._sparse_stateful_apply(
                        op, params[op.name], new_opt, uniq[op.name], scale)
        return params, new_opt, new_state, metrics

    def _sparse_stateful_apply(self, op, op_params, opt_state, uniq, scale):
        """Lazy momentum/Adam row update of one sparse op, in place:
        gather the unique rows of the param and of its optimizer state
        (one K4 launch for all of them),
        run the optimizer's row step, scatter-add the deltas back (so the
        state becomes ``v + (v_new - v)``, as in JAX).  Masked slots
        carry exact-zero deltas into row 0.  Returns the optimizer
        state."""
        opt = self.optimizer
        uids, gsum, mask = uniq
        if scale is not None:
            gsum = gsum * scale
        key = op.sparse_keys()[0]
        table = op_params[key]
        flat = table.reshape(-1, table.shape[-1])
        safe = torch.where(mask, uids, 0)
        bufs = {k: b.reshape(-1, b.shape[-1]) for k, b in
                opt.sparse_state_buffers(opt_state, op.name, key).items()}
        # A row-sharded table's rank steps the unique rows it holds: its
        # window of the table and of the state, the same split.
        tables = [flat, *bufs.values()]
        shard = embedding._row_sharding(op, key)
        if shard is None:
            p_rows, *rows = kernels.gather_rows_multi(tables, safe)
        else:
            p_rows, *rows = kernels.gather_rows_multi(
                tables, safe, row_start=embedding._shard_offset(op, shard))
        buf_rows = dict(zip(bufs, rows))
        d_p, d_bufs = opt.sparse_row_step(p_rows, gsum, buf_rows,
                                          t=opt.sparse_step_count(opt_state))
        m = mask[:, None]
        embedding._scatter_add_dispatch(op, flat, safe,
                                        torch.where(m, d_p, 0.0))
        for k, b in bufs.items():
            embedding._scatter_add_dispatch(op, b, safe,
                                            torch.where(m, d_bufs[k], 0.0))
        if bufs:
            opt_state = opt.with_sparse_state_buffers(
                opt_state, op.name, key,
                {k: b.reshape(table.shape) for k, b in bufs.items()})
        return opt_state

    # -- gradient accumulation -------------------------------------------

    def accum_train_step(self, accum_steps: int):
        """A train step over ``accum_steps`` stacked microbatches: one
        optimizer update from the mean of the per-microbatch gradients.

        Each input arrives shaped ``(accum_steps,) + t.shape`` (see
        :meth:`stack_microbatches`).  Losses are batch means, so the mean
        of the microbatch gradients is the full-batch gradient; one
        microbatch's activations are alive at a time.  Integer metrics
        (counts) sum over the microbatches, float ones average.  The
        gradients are always dense: the row-sparse embedding path
        (``_sparse_ops``) applies to ``train_step`` only, as in the JAX
        package.  With nothing to compile, this is also the JAX
        package's ``_build_accum_step``: the per-step body of
        :meth:`build_superstep` with ``accum_steps > 1``."""
        for op in self.model.layers:
            if op.is_loss and getattr(op, "reduction", "mean") != "mean":
                # A sum-reduced loss would need the gradients' sum; the
                # mean below would shrink its step by accum_steps.
                raise ValueError(
                    f"gradient accumulation requires mean-reduction "
                    f"losses; {op.name!r} uses {op.reduction!r}")
        self._require_optimizer("accum_train_step")
        self.check_microbatches(accum_steps)

        def step(params, opt_state, state, stacked):
            acc, ms = None, []
            for i in range(accum_steps):
                _, m, state, grads, _ = self._grads(
                    params, state, {k: v[i] for k, v in stacked.items()})
                ms.append(m)
                if acc is None:  # f32 sums, in microbatch order
                    acc = {op: {k: g.float() for k, g in group.items()}
                           for op, group in grads.items()}
                else:
                    for op, group in grads.items():
                        for k, g in group.items():
                            acc[op][k].add_(g)
            grads = {op: {k: (a / accum_steps).to(params[op][k].dtype)
                          for k, a in group.items()}
                     for op, group in acc.items()}
            metrics = mean_metrics({k: torch.stack([m[k] for m in ms])
                                    for k in ms[0]}, stacked=True)
            # The mean reduced once over the mesh, clipped over the
            # world, one update (ZeRO-1's included).
            opt_state, _ = self._dense_update(params, opt_state, grads)
            return params, opt_state, state, metrics

        return step

    def check_microbatches(self, accum_steps: int) -> None:
        """Raise when a microbatch of the batch does not split over an
        op's ``n`` degree (``--accum-steps`` under a mesh)."""
        batch = self.model.input_tensors[0].shape[0]
        micro = batch // max(accum_steps, 1)
        for op in self.model.layers:
            n = self._pc(op).degree("n")
            if accum_steps > 1 and micro % n:
                raise ValueError(
                    f"--accum-steps {accum_steps}: a microbatch of {micro} "
                    f"samples does not split over op {op.name!r}'s n = {n}")

    @staticmethod
    def stack_microbatches(batch: Mapping[str, Any], accum_steps: int):
        """Reshape a ``(accum * b, ...)`` batch (tensors or numpy arrays)
        into the ``(accum, b, ...)`` layout :meth:`accum_train_step`
        takes."""
        out = {}
        for k, v in batch.items():
            if v.shape[0] % accum_steps:
                raise ValueError(f"input {k}: batch {v.shape[0]} is not a "
                                 f"multiple of accum_steps={accum_steps}")
            out[k] = v.reshape((accum_steps, v.shape[0] // accum_steps)
                               + tuple(v.shape[1:]))
        return out

    # -- superstep execution ---------------------------------------------

    @property
    def superstep_fused(self) -> bool:
        """Whether ``steps_per_call > 1`` runs as one superstep here (the
        trainer routes on it, as the JAX package's does on
        ``strategy.superstep_capable()``): always, since every strategy
        the port runs spans the full mesh (``check_full_mesh``)."""
        return True

    @property
    def superstep_graph(self) -> bool:
        """Whether a superstep is one CUDA graph here: on CUDA, on one
        device or a world over NCCL (its collectives are captured); over
        gloo, whose collectives cannot be, the k steps run as a loop."""
        return self.device.type == "cuda" and (
            self.world is None or self.world.backend != "gloo"
            or self.plan.num_devices == 1)

    def build_superstep(self, k: int, accum_steps: int = 1):
        """K full train steps (accumulated steps with ``accum_steps >
        1``) as one callable ``(params, opt_state, state, stacked) ->
        (params, opt_state, state, ms)``: ``stacked`` holds every input
        shaped ``(k, ...)`` (:meth:`stack_steps`), ``ms`` every metric
        stacked ``(k, ...)``, so one host readback gives every step's
        loss.  On CUDA the k steps are one CUDA graph, run eagerly and
        captured at the first call and replayed at every later one
        (``runtime/graphs.py``: the params and optimizer state are
        updated in place, a call on other tensors than the captured ones
        raises, a failed capture raises, and ``ms`` holds until the next
        call; ``capture`` records the graph without running it);
        elsewhere, and over gloo under a world (``superstep_graph``), they
        run as a loop.  Under NCCL the graph holds the steps' collectives
        and the first call's eager steps make NCCL's communicators before
        the capture.  Each call of this method builds a new graph; the
        caller clamps ``k`` with ``trainer.relay_safe_steps``."""
        if k < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {k}")
        step = (self.accum_train_step(accum_steps) if accum_steps > 1
                else self.train_step)
        return StepGraph(step, k, self.device, graph=self.superstep_graph,
                         capture_error_mode="global" if self.world is None
                         else "thread_local")

    @staticmethod
    def metrics_row(ms: Dict[str, Any], j: int) -> Dict[str, Any]:
        """Step ``j``'s metrics from a superstep's stacked ``(k, ...)``
        metrics (host or device)."""
        return {key: v[j] for key, v in ms.items()}

    def stack_steps(self, batches: Sequence[Mapping[str, Any]],
                    accum_steps: int = 1) -> Dict[str, torch.Tensor]:
        """Stack k per-step batches (numpy arrays or tensors) into the
        ``(k, ...)`` device tensors :meth:`build_superstep` takes, each in
        its input's dtype; with ``accum_steps > 1`` each step first takes
        the ``(accum, b, ...)`` microbatch layout.  Integer inputs (ids,
        labels) are staged first, as the JAX package stages them.  Under a
        mesh numpy batches are global and the rank keeps its block of
        each, cut after the leading step (and microbatch) dims, JAX's
        placement "under unsharded leading dims"; tensors are taken as
        the rank's blocks already."""
        if accum_steps > 1:
            batches = [self.stack_microbatches(b, accum_steps)
                       for b in batches]
        lead = 2 if accum_steps > 1 else 1
        dtypes = {t.name: t.dtype for t in self.model.input_tensors}
        names = sorted(batches[0],
                       key=lambda n: dtypes[n].is_floating_point)
        out = {}
        for name in names:
            vals = [b[name] for b in batches]
            if all(isinstance(v, np.ndarray) for v in vals):
                stacked = self.shard_batch({name: np.stack(vals)}, lead)[name]
            else:
                stacked = torch.stack([torch.as_tensor(v).to(self.device)
                                       for v in vals])
            out[name] = stacked.to(self.device, dtypes[name])
        return out

    @torch.no_grad()
    def eval_step(self, params, state, batch):
        """Read-only forward: ``(loss, metrics)``."""
        loss, metrics, _, _ = self.forward(params, state, batch,
                                           training=False)
        return loss, metrics


class SnapshotLayout:
    """The executor's side of a snapshot under a world of ranks
    (``CheckpointManager.layout``): on disk every tensor is whole, as one
    device holds it, so a snapshot restores under any strategy and any
    number of ranks; in memory each rank holds its blocks.

    - ``full`` reassembles the parameters, op state and optimizer state
      on every rank (``Executor.gather_full``'s reshard: by
      ``param_specs()`` for the parameters and op state, by
      ``zero_specs()`` for the optimizer's parameter-shaped leaves, which
      are the parameter's spec without ``--zero-opt``); every rank calls
      it, before rank 0 writes;
    - ``full_shape`` and ``cut`` give a saved tensor's whole shape and the
      rank's block of it, by the same specs, for ``restore``;
    - ``broadcast_int`` hands rank 0's choice (the step to restore) to
      every rank.

    A leaf the specs do not name (Adam's step count) is replicated."""

    def __init__(self, ex: Executor):
        self.world = ex.world
        self.rank = ex.world.rank
        self._ex = ex
        self._specs = {"params": ex.param_specs(), "state": ex.param_specs(),
                       "opt_state": ex.zero_specs()}
        self._shapes = {}
        for op in ex.model.layers:
            for k, spec in {**op.param_specs(), **op.state_specs()}.items():
                self._shapes[(op.name, k)] = tuple(spec.shape)

    def _key(self, path: str):
        parts = path.split("/")
        return tuple(parts[-2:]) if len(parts) >= 2 else None

    def _spec(self, item: str, path: str, t: torch.Tensor):
        key = self._key(path)
        if key is not None:
            spec = self._specs[item].get(key[0], {}).get(key[1])
            if spec is not None:
                return spec
        return replicated(t.dim())

    @torch.no_grad()
    def full(self, item: str, flat: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """The whole tensors of ``item``'s flat ``{path: block}`` map."""
        return {path: collectives.reshard(t, self._spec(item, path, t),
                                          replicated(t.dim()), self.world)
                for path, t in flat.items()}

    def full_shape(self, item: str, path: str, t: torch.Tensor) -> tuple:
        """The whole shape of the tensor whose block ``t`` is."""
        return self._shapes.get(self._key(path), tuple(t.shape))

    def cut(self, item: str, path: str, full: torch.Tensor) -> torch.Tensor:
        """The rank's block of a whole saved tensor."""
        spec = self._spec(item, path, full)
        return full[self._ex.plan.local_slices(spec, full.shape, self.rank)]

    def broadcast_int(self, value: int) -> int:
        return self.world.broadcast_int(value)
