"""Layer-wise (inter-op) pipeline parallelism over subsets of the ranks:
the port of ``flexflow_tpu/runtime/pipeline.py``'s host-driven pipeline.

The reference places ops on explicit device lists (``gpu[]`` of
``ParallelConfig``, ``include/config.h:39-48``); its NMT app pins the
encoder to GPUs {0, 1} and the decoder to {2, 3} (``nmt/nmt.cc:269-308``),
and its README's AlexNet table reuses GPU 0 in five layers.  A strategy's
``device_ids`` cut the op graph into *stages* (:func:`derive_stages`):
maximal consecutive runs of ops with one placement tuple, so ``[0, 2, 1,
3]`` is a stage of its own beside ``[0, 1, 2, 3]``.

In the port each rank is one process (``parallel/launch.py``).  A stage
runs on exactly its ranks: its own ``Executor`` over a ``MeshPlan`` of
``len(device_ids)`` devices, bound to a ``World`` over those ranks (plan
index ``i`` is global rank ``device_ids[i]``), its intra-stage degrees
applied inside it.  Every rank builds every stage's World, in stage
order (``dist.new_group`` is collective over the default group), and
the executors of the stages it belongs to; a rank in no stage walks the
schedule and joins only the world-wide steps.

**The step** (``train_step``): the batch splits into ``microbatches``
equal row blocks; ``build_schedule`` orders the ``(F|B, stage,
microbatch)`` events (``gpipe``: every forward, then every backward;
``1f1b``: JAX's slot simulation of Megatron-LM's schedule, at most ``S -
si`` microbatches live on stage ``si``).  Every rank walks the one event
list in the same order and enters a stage's collectives only for the
events of its own stages, so no rank ever posts a receive out of the
global order.

- A forward stores only the stage's inputs and the stage state it ran
  with; the backward recomputes the stage forward under autograd from
  them (remat at stage boundaries) and runs ``torch.autograd.grad`` on
  ``(outs, loss)`` with the received cotangents and the loss seed ``1 /
  m``, so the microbatch sum of the gradients is the batch's mean.
  Stage state (Dropout's key) threads through the microbatches in
  microbatch order, and a recompute reads the state its forward read, so
  it draws the forward's masks.  A microbatch's stored inputs are freed
  once its backward has run (1f1b's memory bound).
- **The hand-offs.**  A boundary tensor is gathered whole over the
  producing stage's group, its first rank sends it to each consuming
  rank that is not a producer rank (one ``batch_isend_irecv`` a
  hand-off, at the consumer's forward event), and each consumer cuts its
  block under its own spec (``MeshPlan.local_slices``).  A cotangent goes
  the other way at the consumer's backward event: gathered whole in the
  consumer stage, sent back, cut by the producer; a skip connection read
  by several later stages sums its cotangents on the producer in arrival
  order (JAX's ``_collect_douts``).  A rank in both stages copies
  locally.  Over gloo, whose send and receive take CPU tensors only, a
  CUDA tensor is staged through the host; over NCCL it goes from card to
  card.  The first hand-off of a tensor sends its shape and dtype ahead.
- **The step's tail** (``_finish_step``): each stage's gradients, summed
  over microbatches in microbatch order, are reduced over its own mesh;
  ``--clip-norm`` takes the global norm over every stage (each stage's
  squared norm counted once, by its first rank, folded in stage order in
  f32 as JAX's ``_clip_scale_f32_host``), then each stage updates on its
  own ranks.  The metrics come from the last stage and are broadcast from
  its first rank, so every rank reads and decides alike.
- **The row-sparse carry.**  A stage whose executor's ``_sparse_ops``
  gate holds (an embedding reading its ids straight from the batch under
  a sparse-capable optimizer) takes the row path on its own ranks: its
  backward gathers the rows (K4), differentiates them, and the step's
  tail scatter-adds the row gradients of every microbatch, gathered over
  the op's ``n`` axes and concatenated in microbatch order (K5), or runs
  the lazy optimizers' row step; a row-sharded table works on its window
  (``row_start``).

Parameters, optimizer state and op state are per stage, ``{si: {op:
...}}``, as in JAX, each rank holding its own stages' blocks.  ``init``
draws the whole model once from the seed, as one executor draws it, and
each stage keeps its ops' share, so a pipeline starts where the one
executor starts (JAX seeds stage ``si`` with ``seed + si``; the port's
draws never equal JAX's values anyway, and tests carry JAX's parameters
across, ``weights.pipeline_params_from_numpy``).  Snapshots hold whole
tensors under one executor's names (``snapshot_layout``), so a pipeline
run's snapshot restores under the one executor and the other way round.

Not ported here (ROADMAP.md item 10b): the chunked stage programs
(``--pipeline-chunk``), the compiled whole-step pipeline
(``--pipeline-compiled``) and so fused pipeline supersteps; each raises
naming the item.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.ops import embedding
from flexflow_torch.ops.base import Op, TensorSpec
from flexflow_torch.parallel import collectives, launch
from flexflow_torch.parallel.mesh import build_mesh_plan, replicated
from flexflow_torch.parallel.strategy import StrategyStore
from flexflow_torch.runtime import telemetry as _telemetry
from flexflow_torch.runtime.executor import (
    Executor,
    SnapshotLayout,
    _merge_metrics,
    _unique_row_sums,
    _world_for,
    draw_params_and_state,
    mean_metrics,
    resolve_device,
)

_log = logging.getLogger("ff.pipeline")

#: Where the chunked and the compiled pipeline come from.
ITEM_10B = ("the chunked and the compiled pipeline are ROADMAP.md "
            "queue 1, item 10b")


class PlacementError(ValueError):
    pass


@dataclasses.dataclass
class Stage:
    index: int
    device_ids: Tuple[int, ...]
    ops: List[Op]
    #: tensors flowing INTO this stage from earlier stages or the batch
    in_names: List[str]
    #: tensors this stage produces that later stages consume
    out_names: List[str]


class _StageModel:
    """The slice of an FFModel a stage's Executor reads."""

    def __init__(self, config: FFConfig, layers: List[Op],
                 input_tensors: List[TensorSpec]):
        self.config = config
        self.layers = layers
        self.input_tensors = input_tensors


def derive_stages(model: FFModel, strategy: StrategyStore) -> List[Stage]:
    """Group ops into pipeline stages by their ``device_ids`` (JAX's
    function, line for line).  An op without a placement inherits the
    placement of its most downstream producer (graph position), one
    reading only the batch the first placed list; a stage is a maximal
    consecutive run of ops with one placement tuple; a device repeated
    inside one stage is refused; stages sharing devices are allowed, with
    a warning (they serialize)."""
    producer: Dict[str, Op] = {}
    for op in model.layers:
        for t in op.outputs:
            producer[t.name] = op
    explicit: Dict[str, Tuple[int, ...]] = {}
    for op in model.layers:
        ids = strategy.find(op.name).device_ids
        if ids is not None:
            explicit[op.name] = tuple(ids)
    if not explicit:
        raise PlacementError("no op in the strategy carries device_ids")
    first_list = next(iter(explicit.values()))

    order = {op.name: i for i, op in enumerate(model.layers)}
    list_of_op: Dict[str, Tuple[int, ...]] = {}
    for op in model.layers:
        if op.name in explicit:
            list_of_op[op.name] = explicit[op.name]
            continue
        inherited, best = None, -1
        for t in op.inputs:
            p = producer.get(t.name)
            if p is not None and p.name in list_of_op and \
                    order[p.name] > best:
                best = order[p.name]
                inherited = list_of_op[p.name]
        list_of_op[op.name] = inherited if inherited is not None \
            else first_list

    placements: List[Tuple[int, ...]] = []
    stage_of_op: Dict[str, int] = {}
    for op in model.layers:
        ids = list_of_op[op.name]
        if not placements or placements[-1] != ids:
            placements.append(ids)
        stage_of_op[op.name] = len(placements) - 1

    for si, ids in enumerate(placements):
        if len(set(ids)) != len(ids):
            raise PlacementError(
                f"stage {si} repeats a device in its device_ids {ids}; "
                f"each device may appear once per stage")
    seen: Dict[int, int] = {}
    overlaps: List[Tuple[int, int, int]] = []
    for si, ids in enumerate(placements):
        for d in ids:
            if d in seen and seen[d] != si:
                overlaps.append((d, seen[d], si))
            else:
                seen[d] = si
    if overlaps:
        d, a, b = overlaps[0]
        _log.warning(
            "stage device sets overlap (device %d serves stages %d and %d"
            "%s): stages sharing devices serialize — layer-wise placement "
            "semantics are preserved but there is no pipeline overlap "
            "between them",
            d, a, b,
            f", +{len(overlaps) - 1} more" if len(overlaps) > 1 else "")

    stages: List[Stage] = []
    for si, ids in enumerate(placements):
        ops = [op for op in model.layers if stage_of_op[op.name] == si]
        if not ops:
            raise PlacementError(f"stage {si} ({ids}) has no ops")
        local_out = {t.name for op in ops for t in op.outputs}
        in_names: List[str] = []
        for op in ops:
            for t in op.inputs:
                if t.name not in local_out and t.name not in in_names:
                    in_names.append(t.name)
        later_needs = {t.name for op in model.layers
                       if stage_of_op[op.name] > si for t in op.inputs}
        out_names = [n for n in local_out if n in later_needs]
        stages.append(Stage(si, ids, ops, in_names, sorted(out_names)))
    return stages


def build_schedule(schedule: str, S: int, m: int
                   ) -> List[Tuple[str, int, int]]:
    """The step's event list ``("F"|"B", stage, microbatch)`` (JAX's
    ``PipelineExecutor.build_schedule``).  ``gpipe``: every forward, then
    every backward.  ``1f1b``: stage ``si`` runs ``min(m, S - 1 - si)``
    warmup forwards, then one backward one forward, then drains; the
    per-stage sequences merge by a slot simulation in which an event
    fires in the first slot after its dependency (F on the previous
    stage's F, B on the next stage's B, same microbatch)."""
    if schedule == "gpipe":
        return ([("F", si, mi) for mi in range(m) for si in range(S)]
                + [("B", si, mi) for mi in range(m)
                   for si in range(S - 1, -1, -1)])
    if schedule != "1f1b":
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    seqs: List[List[Tuple[str, int]]] = []
    for si in range(S):
        w = min(m, S - 1 - si)
        seq = [("F", j) for j in range(w)]
        for j in range(m - w):
            seq.append(("F", j + w))
            seq.append(("B", j))
        seq += [("B", j) for j in range(m - w, m)]
        seqs.append(seq)
    done: set = set()
    ptr = [0] * S
    events: List[Tuple[str, int, int]] = []
    while any(ptr[si] < len(seqs[si]) for si in range(S)):
        fired: List[Tuple[str, int, int]] = []
        for si in range(S):
            if ptr[si] >= len(seqs[si]):
                continue
            kind, mi = seqs[si][ptr[si]]
            dep = (None if (kind == "F" and si == 0)
                   or (kind == "B" and si == S - 1)
                   else (kind, si - 1 if kind == "F" else si + 1, mi))
            if dep is None or dep in done:
                fired.append((kind, si, mi))
                ptr[si] += 1
        if not fired:  # cannot happen for well-formed sequences
            raise RuntimeError("pipeline schedule deadlock")
        events.extend(fired)
        done.update(fired)
    return events


def _clip_scale_f32(sqs: Sequence[torch.Tensor], clip: float) -> torch.Tensor:
    """JAX's ``_clip_scale_f32_host`` on the device: the stages' squared
    norms folded in stage order in f32, then ``min(1, c / max(sqrt(total),
    1e-15))``."""
    total = sqs[0].float()
    for x in sqs[1:]:
        total = total + x.float()
    c = torch.full((), clip, dtype=torch.float32, device=total.device)
    return torch.minimum(torch.ones_like(total),
                         c / torch.clamp(torch.sqrt(total), min=1e-15))


class StagedBatch:
    """A batch cut for this rank: ``blocks[si][mi]`` holds the rank's
    block of microbatch ``mi`` of every batch input stage ``si`` reads,
    for each stage the rank belongs to; ``rows`` is a microbatch's row
    count (``PipelineExecutor.shard_batch``)."""

    def __init__(self, blocks: Dict[int, List[Dict[str, torch.Tensor]]],
                 rows: int, units: int):
        self.blocks = blocks
        self.rows = rows
        self.units = units


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64, torch.uint8, torch.bool)


class PipelineExecutor:
    """Runs an FFModel whose strategy places ops on subsets of the ranks
    (module docstring).  ``microbatches`` splits the batch; 1 is the
    reference's plain layer-wise placement.  ``accum_steps > 1`` is
    lowered onto the microbatch loop, as JAX lowers it: ``a`` groups of
    ``m`` microbatches are ``a * m`` microbatches.  ``chunk > 1`` and
    ``compiled=True`` are ROADMAP.md item 10b and raise.

    The optimizer is shared by the stages; parameters, optimizer state and
    op state are updated in place, as the one executor updates them."""

    def __init__(self, model: FFModel, strategy: StrategyStore,
                 config: Optional[FFConfig] = None, optimizer=None,
                 device=None, microbatches: int = 1, schedule: str = "1f1b",
                 chunk: int = 1, compiled: bool = False,
                 accum_steps: int = 1):
        self.model = model
        self.config = config or model.config
        if getattr(self.config, "zero_sharded_optimizer", False):
            raise PlacementError(
                "--zero-opt supports the full-mesh Executor only: ZeRO "
                "moment sharding is per-op over the op's data-parallel "
                "mesh axes, and layer-wise strategies would need it "
                "PER-SUBMESH (each stage's moments split over that "
                "stage's own devices) — not implemented; layer-wise "
                "strategies keep replicated optimizer state")
        if chunk != 1:
            raise ValueError(f"pipeline chunk {chunk}: {ITEM_10B}; the "
                             f"host-driven pipeline runs one stage program "
                             f"a microbatch (chunk 1)")
        if compiled:
            raise ValueError(f"the compiled whole-step pipeline: "
                             f"{ITEM_10B}; the host-driven pipeline runs "
                             f"without it")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.accum_steps = accum_steps
        if accum_steps > 1:
            _log.info("accum_steps=%d on a layer-wise strategy: lowered onto "
                      "the microbatch loop (%d x %d = %d microbatches per "
                      "optimizer step)", accum_steps, accum_steps,
                      microbatches, accum_steps * microbatches)
            microbatches = accum_steps * microbatches
        if microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {microbatches}")
        self.microbatches = microbatches
        self.schedule = schedule
        self.optimizer = optimizer
        self.strategy = strategy
        self.stages = derive_stages(model, strategy)
        if not launch.in_world():
            raise PlacementError(
                f"a layer-wise strategy over {strategy.num_devices} devices "
                f"runs one process per rank: start a world of "
                f"{strategy.num_devices} (flexflow_torch.parallel.launch, "
                f"-ll:gpu {strategy.num_devices})")
        n = launch.world_size()
        for st in self.stages:
            for d in st.device_ids:
                if d >= n:
                    raise PlacementError(
                        f"stage {st.index} places on device {d} but only {n} "
                        f"devices exist")
        self.device = resolve_device(device)
        #: Dispatch-order events of the last ``train_step``.
        self.last_schedule: List[Tuple[str, int, int]] = []

        self._spec_of: Dict[str, TensorSpec] = {
            t.name: t for op in model.layers for t in op.outputs}
        for t in model.input_tensors:
            self._spec_of[t.name] = t
        self._producer: Dict[str, Op] = {
            t.name: op for op in model.layers for t in op.outputs}
        self._graph_inputs = {t.name for t in model.input_tensors}
        self._stage_of_tensor = {t.name: st.index for st in self.stages
                                 for op in st.ops for t in op.outputs}
        #: The last stage reading each boundary tensor.
        self._last_reader: Dict[str, int] = {}
        for st in self.stages:
            for nm in st.in_names:
                if nm not in self._graph_inputs:
                    self._last_reader[nm] = st.index

        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        #: The world-wide World (its host group agrees the host's
        #: decisions, once for the whole world); then every stage's, in
        #: stage order, on every rank.
        self.world = _world_for(build_mesh_plan(n))
        self.stage_ex: List[Optional[Executor]] = []
        for st in self.stages:
            _world_for(build_mesh_plan(len(st.device_ids)), st.device_ids)
            if self.rank not in st.device_ids:
                self.stage_ex.append(None)
                continue
            table = {op.name: dataclasses.replace(strategy.find(op.name),
                                                  device_ids=None)
                     for op in st.ops if op.name in strategy.table}
            sub = StrategyStore(len(st.device_ids), table)
            sub_model = _StageModel(self.config, st.ops,
                                    [self._spec_of[x] for x in st.in_names])
            self.stage_ex.append(Executor(sub_model, self.config,
                                          optimizer=optimizer,
                                          device=self.device, strategy=sub,
                                          ranks=st.device_ids))
        #: The stages this rank belongs to.
        self.mine = [st.index for st in self.stages
                     if self.stage_ex[st.index] is not None]
        self._fwd_ops = [[op for op in st.ops if not op.is_loss]
                         for st in self.stages]
        self.check_microbatches()
        # NCCL's first use of a group must be collective over all of it:
        # one all-reduce on the default group before any hand-off.
        if self.backend == "nccl":
            dist.all_reduce(torch.zeros(1, device=self.device))
        #: Seconds spent in hand-offs while ``timed`` (each one waits for
        #: the device before it starts and before it returns).
        self.timed = False
        self.handoff_s = 0.0
        self._meta: Dict[tuple, tuple] = {}
        self._shared_meta: Dict[tuple, list] = {}

    # -- the executor's surface ------------------------------------------

    @property
    def superstep_fused(self) -> bool:
        """False: k host-driven steps cannot fuse into one program (the
        trainer amortizes the fence instead, ``_fit_superstep_pipeline``;
        the compiled step is item 10b)."""
        return False

    def _require_optimizer(self):
        if self.optimizer is None:
            raise ValueError("PipelineExecutor.train_step needs an optimizer:"
                             " pass optimizer=make_optimizer(cfg) "
                             "(flexflow_torch.apps.common)")
        return self.optimizer

    def check_microbatches(self) -> None:
        """Raise when the batch does not split into the microbatches, or a
        microbatch over an op's ``n`` degree in its stage."""
        batch = self.model.input_tensors[0].shape[0]
        m = self.microbatches
        if batch % m:
            raise ValueError(f"--microbatches {m}: the batch ({batch}) must "
                             f"split into that many equal microbatches")
        for st in self.stages:
            for op in st.ops:
                # An op the table does not name runs data-parallel over
                # its stage's devices.
                n = self.strategy.table[op.name].degree("n") \
                    if op.name in self.strategy.table else len(st.device_ids)
                if (batch // m) % n:
                    raise ValueError(
                        f"--microbatches {m}: a microbatch of {batch // m} "
                        f"samples does not split over op {op.name!r}'s n = "
                        f"{n} in stage {st.index}")

    def build_schedule(self, S: int, m: int) -> List[Tuple[str, int, int]]:
        return build_schedule(self.schedule, S, m)

    def agree(self, *flags: bool) -> tuple:
        """The host's flags OR-ed over the world (every rank calls it)."""
        return self.world.agree(*flags)

    def init(self, seed: Optional[int] = None):
        """Fresh ``(params, opt_state, state)``, each ``{si: tree}`` over
        the rank's stages: the whole model drawn once from ``seed``, each
        stage keeping the rank's blocks of its ops'."""
        self._require_optimizer()
        drawn = draw_params_and_state(self.model, self.config, seed)
        params, opt_state, state = {}, {}, {}
        for si in self.mine:
            params[si], opt_state[si], state[si] = \
                self.stage_ex[si].init(drawn=drawn)
        return params, opt_state, state

    def shard_batch(self, batch) -> StagedBatch:
        """A global host batch (numpy arrays, or tensors read as such) cut
        for this rank: each microbatch's rows, then each of the rank's
        stages' block of the inputs it reads (its executor's
        ``shard_batch``)."""
        if isinstance(batch, StagedBatch):
            return batch
        host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in batch.items()}
        total = next(iter(host.values())).shape[0]
        m = self.microbatches
        if total % m:
            raise PlacementError(f"batch dim {total} is not divisible by "
                                 f"microbatches={m}")
        rows = total // m
        blocks = {}
        for si in self.mine:
            ex, st = self.stage_ex[si], self.stages[si]
            names = [x for x in st.in_names
                     if x in self._graph_inputs and x in host]
            blocks[si] = [ex.shard_batch({x: host[x][mi * rows:(mi + 1)
                                                     * rows]
                                          for x in names})
                          for mi in range(m)]
        return StagedBatch(blocks, rows, m)

    # -- hand-offs -------------------------------------------------------

    def _timed(self, fn):
        if not self.timed:
            return fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.handoff_s += time.perf_counter() - t0
        return out

    def _p2p(self, key, src: int, dsts: List[int],
             t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Rank ``src`` sends ``t`` to every rank of ``dsts`` (one
        ``batch_isend_irecv``); returns ``t`` on ``src``, the received
        tensor on a rank of ``dsts``, None elsewhere.  The first hand-off
        under ``key`` sends the shape and dtype ahead."""
        me = self.rank
        if me != src and me not in dsts:
            return None
        if not dsts:
            return t
        where = torch.device("cpu") if self.backend == "gloo" \
            else self.device

        def exchange(send, recv):
            ops = ([dist.P2POp(dist.isend, send, d) for d in dsts]
                   if me == src else [dist.P2POp(dist.irecv, recv, src)])
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        def run():
            if key not in self._meta:
                hdr = torch.zeros(10, dtype=torch.int64, device=where)
                if me == src:
                    hdr[0], hdr[1] = t.dim(), _DTYPES.index(t.dtype)
                    hdr[2:2 + t.dim()] = torch.tensor(t.shape)
                exchange(hdr, hdr)
                h = hdr.tolist()
                self._meta[key] = (tuple(h[2:2 + h[0]]), _DTYPES[h[1]])
            shape, dtype = self._meta[key]
            if me == src:
                exchange(t.contiguous().to(where), None)
                return t
            buf = torch.empty(shape, dtype=dtype, device=where)
            exchange(None, buf)
            return buf.to(self.device)

        return self._timed(run)

    def _cut(self, si: int, name: str, whole: torch.Tensor) -> torch.Tensor:
        """Stage ``si``'s block of a whole boundary tensor, under the spec
        its first reader there reads it in."""
        ex = self.stage_ex[si]
        spec = ex._batch_specs[name]
        return whole[ex.plan.local_slices(spec, whole.shape,
                                          ex.world.rank)].contiguous()

    def _whole(self, si: int, x: torch.Tensor, spec) -> torch.Tensor:
        """The whole of stage ``si``'s block ``x`` (under ``spec``),
        gathered over the stage's group."""
        ex = self.stage_ex[si]
        with torch.no_grad():
            return self._timed(lambda: collectives.reshard(
                x, spec, replicated(x.dim()), ex.world))

    def _out_spec(self, si: int, name: str):
        op = self._producer[name]
        j = [t.name for t in op.outputs].index(name)
        return self.stage_ex[si]._bind(op).output_spec(j)

    def _forward_in(self, si: int, mi: int, name: str, rows: int,
                    wholes: List[Dict[str, torch.Tensor]]):
        """The hand-off of boundary tensor ``name`` into stage ``si`` for
        microbatch ``mi``: its block on the ranks of ``si``, None
        elsewhere."""
        p = self._stage_of_tensor[name]
        prod = self.stages[p].device_ids
        cons = self.stages[si].device_ids
        dsts = [r for r in cons if r not in prod]
        got = self._p2p(("F", name, si, rows), prod[0], dsts,
                        wholes[mi].get(name) if self.rank == prod[0]
                        else None)
        if self.rank in prod:
            got = wholes[mi][name]
        if si == self._last_reader[name]:
            wholes[mi].pop(name, None)
        return None if self.rank not in cons else self._cut(si, name, got)

    def _backward_out(self, si: int, mi: int, rows: int,
                      dxs: Optional[Dict[str, torch.Tensor]],
                      dout_back: List[Dict[str, List[torch.Tensor]]]):
        """Stage ``si``'s input cotangents of microbatch ``mi`` back to
        their producers, whole, each appended to the producer's list."""
        for name in self._diffable(si):
            p = self._stage_of_tensor[name]
            prod = self.stages[p].device_ids
            cons = self.stages[si].device_ids
            whole = None
            if self.rank in cons:
                ex = self.stage_ex[si]
                whole = self._whole(si, dxs[name], ex._batch_specs[name])
            got = self._p2p(("B", name, si, rows), cons[0],
                            [r for r in prod if r not in cons],
                            whole if self.rank == cons[0] else None)
            if self.rank in prod:
                dout_back[mi].setdefault(name, []).append(
                    whole if self.rank in cons else got)

    def _collect_douts(self, si: int, mi: int, dout_back, out_meta):
        """The stage's output cotangents of one microbatch, on its own
        blocks: the contributions of the later stages cut and summed in
        arrival order (a skip connection's several), zeros for an output
        none of them differentiates."""
        ex = self.stage_ex[si]
        douts = {}
        for name in self.stages[si].out_names:
            contribs = dout_back[mi].pop(name, None)
            if contribs:
                spec = self._out_spec(si, name)
                parts = [g[ex.plan.local_slices(spec, g.shape,
                                                ex.world.rank)]
                         for g in contribs]
                total = parts[0]
                for q in parts[1:]:
                    total = total + q
                douts[name] = total
            else:
                shape, dtype = out_meta[name]
                douts[name] = torch.zeros(shape, dtype=dtype,
                                          device=self.device)
        return douts

    # -- the stage programs ------------------------------------------------

    def _diffable(self, si: int) -> List[str]:
        """Stage inputs that need cotangents: produced by an earlier stage
        and floating point (ids and labels carry none)."""
        return [x for x in self.stages[si].in_names
                if x not in self._graph_inputs
                and self._spec_of[x].dtype.is_floating_point]

    def _loss_seed(self, m: int) -> float:
        """The loss cotangent of one microbatch: ``1/m`` in f32, so the
        microbatches' summed gradients are the batch's mean."""
        return float(np.float32(1.0) / np.float32(m))

    def _stage_fwd(self, si: int, params, state, inputs):
        """The stage's training forward, no autograd: its boundary outputs
        (the rank's blocks).  The op state advances in place.  The loss
        ops are left to the backward's recompute, which reads their
        loss and metrics (no later stage reads a loss op's output)."""
        ex, st = self.stage_ex[si], self.stages[si]
        with torch.no_grad():
            _, _, _, env = ex.forward(params, state, inputs, training=True,
                                      layers=self._fwd_ops[si])
        return {x: env[x] for x in st.out_names}

    def _stage_bwd(self, si: int, params, state, inputs, douts, dloss):
        """Recompute the stage forward from its stored ``inputs`` and
        ``state`` under autograd and differentiate ``(outs, loss)``
        against ``(douts, dloss)``.  Returns ``(dparams, dxs, metrics,
        sparse)``: ``dparams`` over the dense params, ``dxs`` the
        diffable inputs' cotangents, ``sparse`` each row-sparse op's
        ``(ids, row grads)`` (batch-shaped) of this microbatch."""
        ex, st = self.stage_ex[si], self.stages[si]
        sparse_ops = ex._sparse_ops
        names = {op.name for op in sparse_ops}
        diff = self._diffable(si)
        xs = {k: (v.detach().requires_grad_(True) if k in diff else v)
              for k, v in inputs.items()}
        rows, ids = {}, {}
        with torch.no_grad():
            for op in sparse_ops:
                op_xs = ex._op_inputs(ex._bind(op), inputs)
                rows[op.name] = op.sparse_rows(params[op.name], op_xs)
                ids[op.name] = op.sparse_flat_ids(params[op.name], op_xs)
        rows = {k: r.requires_grad_(True) for k, r in rows.items()}
        dense = {k: v for k, v in params.items() if k not in names}
        leaves = [p.requires_grad_(True) for g in dense.values()
                  for p in g.values()]
        with torch.enable_grad():
            loss, metrics, _, env = ex.forward(dense, state, xs,
                                               training=True,
                                               rows_override=rows)
            targets, seeds = [], []
            for x in st.out_names:
                if env[x].requires_grad:
                    targets.append(env[x])
                    seeds.append(douts[x].to(env[x].dtype))
            if loss.requires_grad:
                targets.append(loss)
                seeds.append(torch.full((), dloss, dtype=loss.dtype,
                                        device=loss.device))
            wrt = leaves + [xs[k] for k in diff] + list(rows.values())
            flat = torch.autograd.grad(targets, wrt, seeds,
                                       allow_unused=True) \
                if targets else [None] * len(wrt)
        del env
        it = iter(flat)
        dparams = {}
        for op, g in dense.items():
            dparams[op] = {}
            for k, p in g.items():
                d = next(it)
                dparams[op][k] = torch.zeros_like(p) if d is None else d
        dxs = {}
        for k in diff:
            d = next(it)
            dxs[k] = torch.zeros_like(xs[k]) if d is None else d
        sparse = {}
        for op in sparse_ops:
            d = next(it)
            r = rows[op.name]
            sparse[op.name] = (ids[op.name],
                               torch.zeros_like(r) if d is None else d)
        return dparams, dxs, {k: v.detach() for k, v in metrics.items()}, \
            sparse

    # -- the step ----------------------------------------------------------

    def train_step(self, params, opt_state, state, batch):
        """One optimizer step over the microbatches: the schedule's events,
        then ``_finish_step``.  Returns ``(params, opt_state, state,
        metrics)``; params and states are updated in place and the metrics
        (the last stage's, broadcast) are device tensors on every rank."""
        self._require_optimizer()
        batch = self.shard_batch(batch)
        grads, sparse, metrics = self._run_microbatched(params, state, batch)
        return self._finish_step(params, opt_state, state, grads, sparse,
                                 metrics)

    def _run_microbatched(self, params, state, batch: StagedBatch):
        """The event loop: one stage program per ``(stage, microbatch)``
        event, every rank walking the same list."""
        m, S = self.microbatches, len(self.stages)
        tel = _telemetry.current()
        events = self.build_schedule(S, m)
        self.last_schedule = events
        tel.add_programs(len(events))
        dloss = self._loss_seed(m)
        wholes: List[Dict[str, torch.Tensor]] = [{} for _ in range(m)]
        stage_inputs: List[List[Any]] = [[None] * S for _ in range(m)]
        fwd_state: List[List[Any]] = [[None] * S for _ in range(m)]
        out_meta: List[List[Any]] = [[None] * S for _ in range(m)]
        dout_back: List[Dict[str, List[torch.Tensor]]] = [
            {} for _ in range(m)]
        grads: Dict[int, Any] = {}
        sparse_acc: Dict[int, List[Any]] = {si: [] for si in self.mine}
        metrics_acc: Dict[str, torch.Tensor] = {}
        for kind, si, mi in events:
            st = self.stages[si]
            ex = self.stage_ex[si]
            if kind == "F":
                inputs = dict(batch.blocks[si][mi]) if ex is not None \
                    else None
                for x in st.in_names:
                    if x not in self._graph_inputs:
                        blk = self._forward_in(si, mi, x, batch.rows, wholes)
                        if ex is not None:
                            inputs[x] = blk
                if ex is None:
                    continue
                stage_inputs[mi][si] = inputs
                fwd_state[mi][si] = {op: {k: v.clone() for k, v in g.items()}
                                     for op, g in state[si].items()}
                tel.program_cost("pipeline_stage_fwd", st, flops=functools.
                                 partial(self._stage_flops, si, False),
                                 stage=si)
                outs = self._stage_fwd(si, params[si], state[si], inputs)
                out_meta[mi][si] = {x: (tuple(y.shape), y.dtype)
                                    for x, y in outs.items()}
                for x, y in outs.items():
                    wholes[mi][x] = self._whole(si, y, self._out_spec(si, x))
                continue
            dxs = None
            if ex is not None:
                douts = self._collect_douts(si, mi, dout_back,
                                            out_meta[mi][si])
                tel.program_cost("pipeline_stage_bwd", st, flops=functools.
                                 partial(self._stage_flops, si, True),
                                 stage=si)
                dparams, dxs, mets, sp = self._stage_bwd(
                    si, params[si], fwd_state[mi][si], stage_inputs[mi][si],
                    douts, dloss)
                # The remat inputs and state this backward read are done
                # with (1f1b's memory bound).
                stage_inputs[mi][si] = fwd_state[mi][si] = None
                out_meta[mi][si] = None
                if si not in grads:  # f32 sums, in microbatch order
                    grads[si] = {op: {k: g.float() for k, g in grp.items()}
                                 for op, grp in dparams.items()}
                else:
                    for op, grp in dparams.items():
                        for k, g in grp.items():
                            grads[si][op][k].add_(g.float())
                if sp:
                    sparse_acc[si].append(sp)
                if si == S - 1:
                    metrics_acc = _merge_metrics(metrics_acc, mets)
            self._backward_out(si, mi, batch.rows, dxs, dout_back)
        return grads, sparse_acc, metrics_acc

    def _stage_flops(self, si: int, backward: bool) -> float:
        """The cost model's flops of one stage program on one microbatch
        (the backward recomputes the forward: ``FWD_BWD_FACTOR`` times
        it)."""
        from flexflow_torch.search.cost_model import FWD_BWD_FACTOR, op_cost

        fwd = sum(op_cost(op).flops for op in self.stages[si].ops) \
            / self.microbatches
        return FWD_BWD_FACTOR * fwd if backward else fwd

    def _sparse_global(self, si: int, pieces):
        """Each row-sparse op's ``(ids, row grads)`` over the whole step:
        every microbatch's gathered over the op's ``n`` axes
        (``embedding.gather_batch``), concatenated in microbatch order
        and flattened; the same on every rank of the stage."""
        ex = self.stage_ex[si]
        out = {}
        for op in ex._sparse_ops:
            ids, gs = [], []
            for sp in pieces:
                i, g = embedding.gather_batch(ex._bind(op), *sp[op.name])
                ids.append(i.reshape(-1))
                gs.append(g.reshape(-1, g.shape[-1]))
            out[op.name] = (torch.cat(ids), torch.cat(gs))
        return out

    def _finish_step(self, params, opt_state, state, grads, sparse_acc,
                     metrics_acc):
        """The step's tail: each stage's gradients in its parameters'
        dtypes and reduced over its mesh, the global ``--clip-norm`` over
        every stage, each stage's update on its own ranks (row updates on
        a row-sparse stage), and the last stage's metrics meaned over the
        microbatches and broadcast."""
        opt = self.optimizer
        m, S = self.microbatches, len(self.stages)
        clip = self.config.clip_norm > 0.0
        stateless = getattr(opt, "stateless_sparse", True)
        dense, rows, uniq, sq = {}, {}, {}, {}
        for si in self.mine:
            ex = self.stage_ex[si]
            names = {op.name for op in ex._sparse_ops}
            g = {op: {k: a.to(params[si][op][k].dtype) for k, a in grp.items()}
                 for op, grp in grads.get(si, {}).items()}
            dense[si] = ex._reduce_grads(g)
            rows[si] = self._sparse_global(si, sparse_acc[si]) \
                if names and sparse_acc[si] else {}
            uniq[si] = {}
            if rows[si] and (clip or not stateless):
                with torch.no_grad():
                    uniq[si] = {n: _unique_row_sums(*rows[si][n])
                                for n in rows[si]}
            if clip:
                extra = sum(gsum.square().sum()
                            for _, gsum, _ in uniq[si].values()) \
                    if uniq[si] else 0.0
                sq[si] = ex._grad_sq(dense[si], extra)
        scale = None
        if clip:
            # Each stage's squared norm once (its first rank's), summed
            # over the world, folded in stage order.
            vec = torch.zeros(S, dtype=torch.float32, device=self.device)
            for si in self.mine:
                if self.stages[si].device_ids[0] == self.rank:
                    vec[si] = sq[si]
            dist.all_reduce(vec)
            scale = _clip_scale_f32(list(vec.unbind(0)),
                                    self.config.clip_norm)
        for si in self.mine:
            ex = self.stage_ex[si]
            g = dense[si]
            if scale is not None:
                g = Executor._scaled(g, scale)
            names = {op.name for op in ex._sparse_ops}
            if not names:
                _, opt_state[si] = opt.update(params[si], opt_state[si], g)
                continue
            dp = {k: v for k, v in params[si].items() if k not in names}
            od = opt.map_param_states(opt_state[si], lambda tree: {
                k: v for k, v in tree.items() if k not in names})
            _, new_opt = opt.update(dp, od, g)
            if new_opt is not None:
                new_opt = opt.restore_param_states(new_opt, opt_state[si],
                                                   names)
            with torch.no_grad():
                for op in ex._sparse_ops:
                    if op.name not in rows[si]:
                        continue
                    ex._bind(op)
                    if stateless:
                        ids, rg = rows[si][op.name]
                        if scale is not None:
                            rg = rg * scale
                        key = op.sparse_keys()[0]
                        table = params[si][op.name][key]
                        embedding.scatter_add_global(
                            op, table.view(-1, table.shape[-1]), ids,
                            -opt.lr * rg)
                    else:
                        new_opt = ex._sparse_stateful_apply(
                            op, params[si][op.name], new_opt,
                            uniq[si][op.name], scale)
            opt_state[si] = new_opt
        metrics = self._share(S - 1, "train", mean_metrics(
            metrics_acc, count=m) if S - 1 in self.mine else None)
        return params, opt_state, state, metrics

    def _share(self, si: int, kind: str, tree: Optional[Dict[str, Any]]
               ) -> Dict[str, torch.Tensor]:
        """Stage ``si``'s first rank's ``tree`` of tensors on every rank:
        its names, shapes and dtypes once (host group), then one
        broadcast of the values packed in f64 (exact for f32, bf16 and
        integer counts)."""
        src = self.stages[si].device_ids[0]
        key = (si, kind)
        meta = self._shared_meta.get(key)
        if meta is None:
            box = [[(k, tuple(v.shape), v.dtype) for k, v in
                    sorted(tree.items())] if self.rank == src else None]
            dist.broadcast_object_list(box, src=src,
                                       group=self.world._host)
            meta = self._shared_meta[key] = box[0]
        dev = self.device
        if self.rank == src:
            flat = torch.cat([tree[k].reshape(-1).to(dev, torch.float64)
                              for k, _, _ in meta]) if meta else \
                torch.zeros(0, dtype=torch.float64, device=dev)
        else:
            flat = torch.empty(sum(int(np.prod(s)) for _, s, _ in meta),
                               dtype=torch.float64, device=dev)
        if meta:
            dist.broadcast(flat, src=src)
        out, at = {}, 0
        for k, shape, dtype in meta:
            n = int(np.prod(shape))
            out[k] = flat[at:at + n].reshape(shape).to(dtype)
            at += n
        return out

    @torch.no_grad()
    def eval_step(self, params, state, batch):
        """Read-only forward over the microbatches, stage by stage:
        ``(loss, metrics)``, the loss ops' stages' losses summed and their
        metrics merged in stage order (JAX's ``eval_step``), each meaned
        over the microbatches."""
        batch = self.shard_batch(batch)
        m, S = batch.units, len(self.stages)
        losses: Dict[int, Any] = {}
        mets: Dict[int, Dict[str, torch.Tensor]] = {}
        wholes: List[Dict[str, torch.Tensor]] = [{} for _ in range(m)]
        for mi in range(m):
            for st in self.stages:
                si, ex = st.index, self.stage_ex[st.index]
                inputs = dict(batch.blocks[si][mi]) if ex is not None \
                    else None
                for x in st.in_names:
                    if x not in self._graph_inputs:
                        blk = self._forward_in(si, mi, x, batch.rows, wholes)
                        if ex is not None:
                            inputs[x] = blk
                if ex is None:
                    continue
                loss, mt, _, env = ex.forward(params[si], state[si], inputs,
                                              training=False)
                if any(op.is_loss for op in st.ops):
                    losses[si] = loss if si not in losses else \
                        losses[si] + loss
                    mets[si] = _merge_metrics(mets.get(si, {}), mt)
                for x in st.out_names:
                    wholes[mi][x] = self._whole(si, env[x],
                                                self._out_spec(si, x))
        total, metrics = None, {}
        for st in self.stages:
            if not any(op.is_loss for op in st.ops):
                continue
            si = st.index
            mine = None
            if si in self.mine:
                mine = dict(mean_metrics(mets[si], count=m),
                            __loss=losses[si] * float(
                                np.float32(1.0) / np.float32(m)))
            got = self._share(si, "eval", mine)
            loss = got.pop("__loss")
            total = loss if total is None else total + loss
            metrics = _merge_metrics(metrics, got)
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=self.device)
        return total, metrics

    # -- snapshots and whole tensors ---------------------------------------

    def snapshot_layout(self) -> "PipelineLayout":
        return PipelineLayout(self)

    def gather_full(self, tree, everywhere: bool = False):
        """The whole tensors of a per-stage ``{si: {op: {key: block}}}``
        tree (params or op state) as one ``{op: {key: tensor}}`` tree of
        CPU tensors on rank 0 (``{}`` elsewhere), or on every rank with
        ``everywhere``; every rank calls it."""
        flat = PipelineLayout(self).full("params", {
            f"{si}/{op}/{k}": v for si, g in tree.items()
            for op, grp in g.items() for k, v in grp.items()})
        if everywhere:
            box = [flat if self.rank == 0 else None]
            dist.broadcast_object_list(box, src=0, group=self.world._host)
            flat = box[0]
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for path, v in flat.items():
            op, k = path.split("/")
            out.setdefault(op, {})[k] = v
        return out


class PipelineLayout:
    """A pipeline's side of a snapshot (``CheckpointManager.layout``): on
    disk every tensor is whole and named as one executor names it (the
    stage index dropped: ``0/m/conv1/kernel`` is ``m/conv1/kernel``; each
    stage's Adam step count is the one ``t``), so a snapshot restores
    under any strategy, pipeline or not.

    - ``full`` gathers each stage's tensors whole over its group and its
      first rank sends them to rank 0 (host group), stage by stage;
      every rank calls it for every item (``every_item``), rank 0
      returns the whole map;
    - ``select`` maps the saved whole tensors onto a rank's template
      paths (only its own stages'); ``full_shape`` and ``cut`` are each
      stage executor's layout's."""

    every_item = True

    def __init__(self, pipe: PipelineExecutor):
        self.pipe = pipe
        self.world = pipe.world
        self.rank = pipe.rank
        self._stage = {si: SnapshotLayout(pipe.stage_ex[si])
                       for si in pipe.mine}

    @staticmethod
    def _split(path: str):
        si, _, rest = path.partition("/")
        return int(si), rest

    @torch.no_grad()
    def full(self, item: str, flat: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        pipe = self.pipe
        out: Dict[str, torch.Tensor] = {}
        by_stage: Dict[int, Dict[str, torch.Tensor]] = {}
        for path, t in flat.items():
            si, rest = self._split(path)
            by_stage.setdefault(si, {})[rest] = t
        for st in pipe.stages:
            si, ids = st.index, st.device_ids
            whole = None
            if si in pipe.mine:
                lay = self._stage[si]
                whole = {k: v.detach().cpu() for k, v in lay.full(
                    item, by_stage.get(si, {})).items()}
            if 0 not in ids:
                if self.rank == ids[0]:
                    dist.send_object_list([whole], dst=0,
                                          group=self.world._host)
                elif self.rank == 0:
                    box = [None]
                    dist.recv_object_list(box, src=ids[0],
                                          group=self.world._host)
                    whole = box[0]
            if self.rank == 0:
                for k, v in whole.items():
                    out.setdefault(k, v)
        return out

    def select(self, item: str, saved: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``{template path: saved whole tensor}`` for this rank's
        template paths; a path the snapshot lacks is left out (the
        caller's key check names it)."""
        out = {}
        for path in want:
            rest = self._split(path)[1]
            if rest in saved:
                out[path] = saved[rest]
        return out

    def full_shape(self, item: str, path: str, t: torch.Tensor) -> tuple:
        si, rest = self._split(path)
        return self._stage[si].full_shape(item, rest, t)

    def cut(self, item: str, path: str, full: torch.Tensor) -> torch.Tensor:
        si, rest = self._split(path)
        return self._stage[si].cut(item, rest, full)

    def broadcast_int(self, value: int) -> int:
        return self.world.broadcast_int(value)


def make_executor(model: FFModel, strategy: Optional[StrategyStore] = None,
                  **kwargs):
    """The runtime of a strategy (JAX's ``make_executor``): the
    ``PipelineExecutor`` when some op's ``device_ids`` are a proper subset
    of the devices, else the plain ``Executor`` (with JAX's warning when
    explicit ids span the whole mesh).  ``chunk > 1`` and
    ``compiled=True`` raise, naming ROADMAP.md item 10b: the port does
    not fall back."""
    mb = kwargs.pop("microbatches", 1)
    sched = kwargs.pop("schedule", "1f1b")
    chunk = kwargs.pop("chunk", 1)
    compiled = kwargs.pop("compiled", False)
    accum = kwargs.pop("accum_steps", 1)
    if strategy is not None and any(
            pc.device_ids is not None for pc in strategy.table.values()):
        nd = strategy.num_devices
        if any(len(set(pc.device_ids)) < nd
               for pc in strategy.table.values()
               if pc.device_ids is not None):
            return PipelineExecutor(model, strategy, microbatches=mb,
                                    schedule=sched, chunk=chunk,
                                    compiled=compiled, accum_steps=accum,
                                    **kwargs)
        _log.warning("strategy device_ids span the full mesh; explicit "
                     "ordering is realized by mesh coordinates "
                     "(placement-equivalent)")
    return Executor(model, strategy=strategy, **kwargs)
