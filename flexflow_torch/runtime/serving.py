"""Inference serving: ServingExecutor and the closed-loop Server.

The single-device core of ``flexflow_tpu/runtime/serving.py``:

- **Prefill** (:meth:`ServingExecutor.build_prefill`, one per pad
  bucket): the full-sequence causal forward over a zero-padded prompt,
  filling per-layer ``(1, max_seq, heads, d_head)`` cache rows and
  returning the first token (greedy) and a finiteness flag.  With the
  prefix cache a prompt whose leading full blocks are resident runs the
  offset prefill (:meth:`build_prefill_from`) over its tail only, or no
  prefill at all when the whole prompt and its first token are known.
- **Decode superstep** (:meth:`build_decode_superstep`): K single-token
  steps over the whole slot batch, token selection on the device
  (greedy, or the keyed temperature / top-k draw of
  ``runtime/keyed_random.py``), and ONE host readback of the ``(K, B)``
  tokens and finiteness flags per superstep (:func:`_fenced`).  On
  CUDA the K steps are one CUDA graph (``runtime/graphs.py::StepGraph``,
  the port's counterpart of JAX's one ``lax.scan`` dispatch): its carry
  ``(caches, pos, tok, block_table, req_ids)`` is updated in place.
- **Speculative round** (:meth:`build_spec_step`): d + 1 draft steps on
  the draft's own padded caches, d + 1 verify steps through the decode
  step's body, the longest matching prefix accepted on the device; one
  CUDA graph on CUDA.  The emitted tokens equal plain decode's whatever
  the draft proposes.
- **Cache layouts**: padded ``(max_batch, max_seq, h, hd)`` per layer, or
  paged (``kv_block > 0``): a pool of ``(kv_blocks, kv_block, h, hd)``
  per layer with block 0 as scratch, per-slot block tables, and
  admission gated by the host-side :class:`KVBlockLedger`, which also
  holds the prefix cache's refcounts and content-hash index.
- **Server.run**: FIFO admission into ``max_batch`` slots between
  supersteps (prefill + install, the head-of-line wait when the pool is
  short), one decode superstep or speculative round over the batch,
  per-slot consumption with the EOS, budget and context limits,
  eviction, and the stats block.
- **Failure model of the plain loop**: :class:`ServingFaultInjector`
  (a NaN'd cache row or block, a raised slot fault, an engine fault,
  SIGTERM, keyed by superstep), the request journal
  (``flexflow_torch/serving/journal.py``: completed requests restored,
  in-flight ones resumed by a re-prefill over ``prompt ‖ carried``),
  and the drain on SIGTERM (``runtime/resilience.py::
  PreemptionHandler``) at a superstep boundary.
- **Dry run** (:meth:`ServingExecutor.abstract_programs`): every
  program traced on ``meta`` tensors, no device compute.
- **Train to serve** (:meth:`ServingExecutor.restore`): a training
  checkpoint's params and op state onto the serving device
  (``runtime/checkpoint.py``).
- **Telemetry**: the JAX package's serving events (OBSERVABILITY.md):
  ``serving_program`` at the first build of each program,
  ``request_start`` / ``request_end``, ``prefill`` (``bucket``,
  ``wall_s``), ``prefix_hit``, ``kv_cow``, ``decode_superstep`` (``k``,
  ``active``, ``slots``, ``wall_s``), ``spec_verify`` and
  ``serving_drain``, and a ``program_cost`` per program with its flops
  from ``search/cost_model.py::serving_flops``.  Each dispatch's one
  readback goes through ``Telemetry.fence``, so the fences are the same
  with telemetry on and off; every event is emitted on the host between
  dispatches, never inside a captured graph.

- **Sharded serving** (``shard=(n, c)``): inside a world of ``n * c``
  ranks (``parallel/launch.py``) the padded slot batch splits over mesh
  axis ``n`` and the heads over ``c``; the paged pool splits its heads
  over ``c`` and ``n`` replicates it, as the JAX package places them
  (``("n", None, "c", None)`` and ``(None, None, "c", None)``).  Each
  rank runs its share with explicit collectives: the attention ops
  project and attend the rank's ``h/c`` heads and all-reduce their
  output over ``c`` (``ops/attention.py``), every other op runs on the
  rank's rows, and a padded decode superstep or speculative round
  all-gathers its chosen tokens, finiteness flags (and logits) over
  ``n`` once at its end, so the ``(K, B)`` readback is the whole batch's
  on every rank.  Host state stays whole and identical on every rank
  (the carry, the block table, the ledger, the loops' decisions); a
  prefill runs on every rank and installs only into the rank's own
  slots.  Under a shard the programs run eagerly (gloo's collectives
  cannot be captured).  Outside such a world the executor warns and
  falls back to the single-mesh engine, as JAX's does on too few
  devices.

The SLO scheduler over these programs is ``serving/scheduler.py``, and
the fleet of replicas behind a router ``serving/fleet.py::FleetRouter``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import os
import re
import signal
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.data.loader import DeviceMemoryError, _device_bytes_limit
from flexflow_torch.graph import FFModel
from flexflow_torch.ops import kernels
from flexflow_torch.ops.attention import MultiHeadAttention, PositionEmbedding
from flexflow_torch.parallel import launch
from flexflow_torch.parallel.mesh import build_mesh_plan
from flexflow_torch.parallel.strategy import ParallelConfig
from flexflow_torch.runtime import keyed_random
from flexflow_torch.runtime import telemetry as _telemetry
from flexflow_torch.runtime.executor import Executor, _world_for, resolve_device
from flexflow_torch.runtime.graphs import StepGraph
from flexflow_torch.runtime.resilience import PreemptionHandler
from flexflow_torch.runtime.trainer import relay_safe_steps

_log = logging.getLogger("ff.serving")

#: ``(temperature, top_k, seed)`` of the keyed draw; None is greedy.
Sample = Optional[Tuple[float, int, int]]


class ServingFault(RuntimeError):
    """A raised fault attributed to one decode slot: the loop errors out
    that slot's request and keeps serving the rest."""

    def __init__(self, slot: int, msg: str = ""):
        super().__init__(msg or f"injected serving fault in slot {slot}")
        self.slot = slot


class ServingEngineFault(RuntimeError):
    """A fault of the engine, not of one slot (a program raised, the
    cache pool is suspect).  The plain loop lets it propagate: that is
    the crash the request journal recovers from."""


class ServingCrashLoop(RuntimeError):
    """The engine-restart budget is exhausted (the scheduler's failure
    model, ``serving/scheduler.py``, raises it); an app maps it to
    :data:`EXIT_SERVING_FAILURE`."""


#: Process exit code of an unrecoverable serving engine: restarting the
#: same process is pointless (beside the elastic world's 76).
EXIT_SERVING_FAILURE = 77


class ServingFaultInjector:
    """Scheduled faults for the serving loop, keyed by decode-superstep
    index (the JAX package's ``ServingFaultInjector``; each fault is also
    a ``fault`` event of the current run telemetry).

    - ``nan_cache_at``: ``{superstep: slot}``: before that superstep the
      slot's layer-0 K cache row (padded) or its first owned pool block
      (paged; never scratch block 0) becomes NaN, so its logits go
      non-finite and the finiteness flag at the readback errors the
      request out.  Written in place into the cache tensors a decode
      graph captured, between two replays.
    - ``raise_at``: ``{superstep: slot}``: a :class:`ServingFault`
      before the dispatch; the superstep does not run.
    - ``engine_raise_at``: ``{superstep: message}``: a
      :class:`ServingEngineFault` before the dispatch.
    - ``preempt_at``: ``{superstep}``: SIGTERM to this process before
      the dispatch; a drain-armed Server drains at the next boundary.

    Each fires once.  ``fired`` logs ``(mode, superstep, slot or -1)``.
    """

    def __init__(self, nan_cache_at: Optional[Dict[int, int]] = None,
                 raise_at: Optional[Dict[int, int]] = None,
                 engine_raise_at: Optional[Dict[int, str]] = None,
                 preempt_at: Optional[Sequence[int]] = None):
        self.nan_cache_at = dict(nan_cache_at or {})
        self.raise_at = dict(raise_at or {})
        self.engine_raise_at = dict(engine_raise_at or {})
        self.preempt_at = set(preempt_at or ())
        self.fired: List[Tuple[str, int, int]] = []

    def before_superstep(self, idx: int, caches, block_table=None,
                         slot_row=None):
        """Returns ``(caches, nan_slot)``, the caches (NaN'd in place)
        and the slot whose cache was NaN'd (None otherwise); may raise
        :class:`ServingFault` or :class:`ServingEngineFault` or SIGTERM
        the process.  ``caches=None`` (a compute-free caller) returns the
        target slot alone.  ``block_table`` (host ``(B, nblk)`` int32)
        selects the paged layout: the slot's first owned block is NaN'd,
        and a slot that owns none is left alone.  ``slot_row``
        (:meth:`ServingExecutor.slot_row`) maps a slot to its row of a
        sharded padded cache: a rank that does not hold the slot NaNs
        nothing and reports the slot all the same (its owner NaN'd it)."""
        if idx in self.preempt_at:
            self.preempt_at.discard(idx)
            self.fired.append(("preempt", idx, -1))
            os.kill(os.getpid(), signal.SIGTERM)
        if idx in self.engine_raise_at:
            msg = self.engine_raise_at.pop(idx)
            self.fired.append(("engine", idx, -1))
            _telemetry.current().emit("fault", mode="serving_engine",
                                      superstep=idx, slot=None)
            raise ServingEngineFault(
                msg or f"injected engine fault at superstep {idx}")
        if idx in self.raise_at:
            slot = self.raise_at.pop(idx)
            self.fired.append(("raise", idx, slot))
            _telemetry.current().emit("fault", mode="serving_raise",
                                      superstep=idx, slot=slot)
            raise ServingFault(slot)
        if idx in self.nan_cache_at:
            slot = self.nan_cache_at.pop(idx)
            self.fired.append(("nan_cache", idx, slot))
            _telemetry.current().emit("fault", mode="serving_nan",
                                      superstep=idx, slot=slot)
            if caches is None:
                return None, slot
            k = caches[next(iter(caches))]["k"]
            dest = slot
            if block_table is not None:
                dest = int(block_table[slot][0])
                if dest == 0:  # the slot owns no block: nothing to NaN
                    return caches, None
            elif slot_row is not None:
                dest = slot_row(slot)
                if dest is None:  # another rank holds the slot's row
                    return caches, slot
            with torch.inference_mode():
                k[dest].fill_(float("nan"))
            return caches, slot
        return caches, None


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival_ms`` / ``priority`` /
    ``slo_ms`` are the open-loop scheduler's fields
    (``serving/scheduler.py``): arrival on its virtual clock, the priority
    tier (0 highest) and the end-to-end deadline in virtual ms (inf: best
    effort).  The closed loop admits every request at run start."""

    id: int
    prompt: np.ndarray  # 1-D int32 token ids
    max_new_tokens: int = 16
    arrival_ms: float = 0.0
    priority: int = 0
    slo_ms: float = float("inf")

    @property
    def deadline_ms(self) -> float:
        return self.arrival_ms + self.slo_ms


def prefix_digests(tokens, block: int) -> List[bytes]:
    """Chained per-block content hashes of a prompt's FULL blocks, the
    prefix-cache index key: ``h_0 = sha1(block_0)``, ``h_j =
    sha1(h_{j-1} || block_j)``, token ids as int64 bytes.  K/V at row r
    depends only on tokens ``[0, r]``, so two prompts that agree on the
    first ``(j+1) * block`` tokens have equal K/V in block j."""
    toks = np.asarray(tokens, np.int64)
    out: List[bytes] = []
    prev = b""
    for j in range(len(toks) // int(block)):
        blk = toks[j * block:(j + 1) * block].tobytes()
        out.append(hashlib.sha1(prev + blk).digest())
        prev = out[-1]
    return out


@dataclasses.dataclass(frozen=True)
class PrefixPlan:
    """Admission plan from :meth:`KVBlockLedger.plan_prefix`.

    ``use`` resident prefix blocks are SHARED (refcount++); ``cow``
    matched blocks are recomputed privately instead (the copy-on-write
    clamp: the prefill must compute the last prompt token's logits, so a
    fully covered prompt without a memoized first token re-runs its
    final block); ``offset = use * block`` is the first row the offset
    prefill computes.  ``full_hit``: the whole prompt is covered AND its
    first token memoized (``tok0``), so no prefill runs.  ``shared`` are
    the pool block ids to reference, in order."""

    use: int
    cow: int
    offset: int
    full_hit: bool
    tok0: Optional[int] = None
    shared: Tuple[int, ...] = ()


class KVBlockLedger:
    """Host-side free-list accounting for the paged KV pool, in pure
    integer arithmetic (the JAX package's scheduler simulates admission
    with the same ledger).

    Block 0 is the SCRATCH block, never allocated: inactive slots' table
    rows point at it, and decode writes past a slot's reservation land
    there; no active slot's masked attention reads it.  Freed blocks are
    reused lowest first (the free list stays sorted), so allocation is
    the same in every replay.

    ``prefix_cache=True`` arms prefix sharing: every block carries a
    refcount, and an index maps a prompt's chained full-block digests
    (:func:`prefix_digests`) to resident blocks.  :meth:`plan_prefix`
    finds the longest resident prefix; :meth:`alloc` takes the shared
    blocks (refcount++) and allocates only the tail; :meth:`free` returns
    a block at refcount 0 and drops its index entry."""

    def __init__(self, num_blocks: int, block: int, max_seq: int,
                 prefix_cache: bool = False):
        if block < 1 or max_seq % block:
            raise ValueError(
                f"kv_block must divide max_seq: block={block}, "
                f"max_seq={max_seq}"
            )
        if num_blocks < 2:
            raise ValueError(
                f"paged pool needs >= 2 blocks (scratch + 1), got "
                f"{num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self.block = int(block)
        self.max_seq = int(max_seq)
        #: Table-row width: worst-case blocks a slot could reference.
        self.blocks_per_slot = self.max_seq // self.block
        self.prefix_cache = bool(prefix_cache)
        self._free: List[int] = list(range(1, self.num_blocks))
        self._held: Dict[int, List[int]] = {}
        #: Per-block reference counts (1 for private blocks, > 1 shared).
        self._ref: Dict[int, int] = {}
        #: Chained digest -> resident block (live blocks only).
        self._index: Dict[bytes, int] = {}
        #: Reverse map for index cleanup at free time.
        self._digest_of: Dict[int, bytes] = {}
        #: Full-prompt digest -> memoized first token (the full hit).
        #: Outlives eviction: a full hit also needs every block resident.
        self._next_tok: Dict[bytes, int] = {}

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Blocks to RESERVE at admission: every position the request can
        write (prompt + generated + the first-token feedback row), capped
        at the context limit, so a slot never exhausts the pool while it
        decodes."""
        toks = min(int(prompt_len) + int(max_new_tokens) + 1, self.max_seq)
        return -(-toks // self.block)

    def can_admit(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    def plan_prefix(self, prompt,
                    total_len: Optional[int] = None) -> PrefixPlan:
        """Longest resident prefix of ``prompt``; ``total_len`` is the
        prefill length when it exceeds the prompt (a resume).  The
        no-share plan when the cache is off or nothing matches."""
        plen = len(prompt)
        flen = int(total_len) if total_len is not None else plen
        if not self.prefix_cache or plen < self.block:
            return PrefixPlan(0, 0, 0, False)
        digests = prefix_digests(prompt, self.block)
        matched: List[int] = []
        for dgst in digests:
            blk = self._index.get(dgst)
            if blk is None:
                break
            matched.append(blk)
        m = len(matched)
        if m == 0:
            return PrefixPlan(0, 0, 0, False)
        if flen == plen == m * self.block:
            tok0 = self._next_tok.get(digests[m - 1])
            if tok0 is not None:
                return PrefixPlan(m, 0, m * self.block, True,
                                  int(tok0), tuple(matched))
        # The offset prefill computes the last real token's row, so the
        # shared span stops at flen - 1: a fully covered prompt without a
        # first-token memo recomputes its final block (copy-on-write).
        use = min(m, (flen - 1) // self.block)
        return PrefixPlan(use, m - use, use * self.block, False,
                          None, tuple(matched[:use]))

    def alloc(self, slot: int, n_blocks: int,
              shared: Sequence[int] = ()) -> np.ndarray:
        """Reserve ``n_blocks`` in all for ``slot``: the ``shared``
        resident blocks first (refcount++), then fresh ones from the free
        list.  Returns the slot's ``(blocks_per_slot,)`` int32 table row,
        unreserved entries pointing at scratch block 0."""
        shared = list(shared)
        if slot in self._held:
            raise RuntimeError(f"slot {slot} already holds KV blocks")
        fresh_n = int(n_blocks) - len(shared)
        if fresh_n < 0:
            raise ValueError(
                f"alloc: {len(shared)} shared blocks exceed the "
                f"{n_blocks}-block reservation"
            )
        if fresh_n > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: need {fresh_n} blocks, "
                f"{len(self._free)} free of {self.capacity_blocks}"
            )
        got, self._free = self._free[:fresh_n], self._free[fresh_n:]
        for b in shared:
            self._ref[b] += 1
        for b in got:
            self._ref[b] = 1
        held = shared + got
        self._held[slot] = held
        row = np.zeros((self.blocks_per_slot,), np.int32)
        row[: len(held)] = held
        return row

    def free(self, slot: int) -> None:
        got = self._held.pop(slot, None)
        if not got:
            return
        released: List[int] = []
        for b in got:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                released.append(b)
                dgst = self._digest_of.pop(b, None)
                if dgst is not None and self._index.get(dgst) == b:
                    del self._index[dgst]
        if released:
            self._free = sorted(self._free + released)

    def register_prefix(self, slot: int, digests: Sequence[bytes],
                        start: int = 0) -> None:
        """Index ``slot``'s installed full-prompt blocks (``digests[start:]``
        onto held blocks ``start..``) for later admissions to share; only
        after the prefill's readback validated them.  The first writer of
        a digest wins."""
        if not self.prefix_cache:
            return
        held = self._held.get(slot, [])
        for j in range(int(start), len(digests)):
            if j >= len(held):
                break
            dgst = digests[j]
            if dgst in self._index:
                continue
            self._index[dgst] = held[j]
            self._digest_of[held[j]] = dgst

    def record_next(self, digest: bytes, tok: int) -> None:
        """Memoize the first token after a block-aligned fresh prefill:
        a later identical admission becomes a full hit."""
        if self.prefix_cache:
            self._next_tok[bytes(digest)] = int(tok)


@dataclasses.dataclass
class RequestResult:
    id: int
    prompt_len: int
    tokens: List[int]            # generated token ids, in order
    error: Optional[str] = None  # None = completed cleanly
    latency_s: float = 0.0       # eligible -> finished wall time
    prefill_s: float = 0.0


@dataclasses.dataclass
class _Slot:
    request: Request
    pos: int                 # position of the NEXT token to decode
    last_tok: int            # token fed to the next decode step
    tokens: List[int]        # tokens generated in this occupancy
    t_eligible: float
    prefill_s: float
    #: Tokens carried from an earlier (crashed or drained) run through
    #: the journal: the re-prefill over ``prompt ‖ carried`` resume.
    carried: List[int] = dataclasses.field(default_factory=list)

    @property
    def all_tokens(self) -> List[int]:
        return self.carried + self.tokens


def _readback(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """ONE device-to-host copy of int/bool tensors (as int32), split back
    into their shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors])
    flat = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(tuple(t.shape)))
        i += n
    return out


def _fenced(tel, label: str, *tensors: torch.Tensor) -> List[np.ndarray]:
    """The fence that ends a prefill, a decode superstep or a speculative
    round: :func:`_readback` through ``tel.fence`` (with telemetry on
    also timed and a ``fence`` event; no fence of its own)."""
    return tel.fence(tensors, label, read=_readback)


def _f32(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a one-element f32 tensor on ``like``'s device: a
    tensor divisor keeps true division, as ``jnp`` divides (CUDA turns a
    division by a host scalar into a product with its reciprocal)."""
    return torch.full((1,), value, dtype=torch.float32, device=like.device)


def _check_sample(sample: Sample) -> Sample:
    if sample is None:
        return None
    temperature, top_k, seed = sample
    if float(temperature) <= 0.0:
        raise ValueError(f"sampling needs temperature > 0, got "
                         f"{temperature} (greedy is sample=None)")
    return float(temperature), int(top_k), int(seed)


class ServingExecutor:
    """Forward-only serving programs for an FFModel transformer LM on one
    device, or on a rank's share of a world of ranks (``shard``).

    Capacity and drafting knobs, as the JAX executor's:

    - ``kv_block`` / ``kv_blocks``: paged KV caches, a pool of
      ``kv_blocks`` blocks of ``kv_block`` positions per layer (block 0
      scratch), per-slot block tables, admission through
      :class:`KVBlockLedger`.  ``kv_block=0`` keeps the padded layout;
      ``kv_blocks=None`` is the worst case (every slot at ``max_seq``)
      plus scratch.
    - ``prefix_cache``: prefix sharing on the paged pool.
    - ``draft_layers``: the speculative draft runs only the first L
      ``blk{i}_`` transformer blocks (the skipped ones pass the residual
      stream through); 0 runs the whole graph as the draft.
    - ``shard=(n, c)``: sharded serving (the module docstring) inside a
      world of exactly ``n * c`` ranks, with JAX's checks (``n * c >=
      2``; ``n`` divides ``max_batch`` on the padded layout; ``c``
      divides every attention op's heads); a world of another size
      raises.  Outside a world the executor warns on ``ff.serving`` and
      falls back to the single-mesh engine (``self.shard`` None), as
      JAX's does on a box with too few devices.  Parameters stay whole
      on every rank (:meth:`init`, :meth:`restore`: a one-rank training
      checkpoint serves sharded with no conversion).
    """

    def __init__(
        self,
        model: FFModel,
        config: Optional[FFConfig] = None,
        max_batch: int = 4,
        max_seq: Optional[int] = None,
        buckets: Optional[Sequence[int]] = None,
        decode_kernel: Optional[bool] = None,
        device=None,
        kv_block: int = 0,
        kv_blocks: Optional[int] = None,
        draft_layers: int = 0,
        prefix_cache: bool = False,
        shard: Optional[Tuple[int, int]] = None,
    ):
        self.model = model
        self.config = config or model.config
        self.device = resolve_device(device)
        self._layers = [op for op in model.layers if not op.is_loss]
        loss_ops = model.loss_ops
        if loss_ops:
            self._logits_name = loss_ops[-1].inputs[0].name
        else:
            self._logits_name = self._layers[-1].outputs[0].name
        consumed = {t.name for op in self._layers for t in op.inputs}
        feed = [t for t in model.input_tensors if t.name in consumed]
        if len(feed) != 1:
            raise ValueError(
                f"serving drives single-input token LMs; the non-loss graph "
                f"consumes inputs {[t.name for t in feed]}"
            )
        self._tokens_name = feed[0].name
        self.attn_ops = [op for op in self._layers
                         if isinstance(op, MultiHeadAttention)]
        if not self.attn_ops:
            raise ValueError("serving needs at least one MultiHeadAttention "
                             "op (the KV-cache protocol lives there)")
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq or feed[0].shape[1])
        bks = sorted(set(int(b) for b in (buckets or (self.max_seq,))))
        if any(b < 1 or b > self.max_seq for b in bks):
            raise ValueError(f"buckets must be in [1, max_seq]: {bks}")
        self.buckets: Tuple[int, ...] = tuple(bks)
        self.decode_kernel = decode_kernel
        #: Per-attention-op cache specs: name -> (heads, d_head, dtype).
        self._cache_specs: Dict[str, Tuple[int, int, torch.dtype]] = {}
        for op in self.attn_ops:
            d = op.inputs[0].shape[-1]
            h = op.attrs["num_heads"]
            self._cache_specs[op.name] = (h, d // h, op.outputs[0].dtype)
        # -- paged KV layout --
        self.kv_block = int(kv_block or 0)
        self.paged = self.kv_block > 0
        if self.paged:
            if self.max_seq % self.kv_block:
                raise ValueError(
                    f"kv_block must divide max_seq: kv_block="
                    f"{self.kv_block}, max_seq={self.max_seq}"
                )
            self.blocks_per_slot = self.max_seq // self.kv_block
            worst = self.max_batch * self.blocks_per_slot + 1
            self.kv_blocks = int(kv_blocks) if kv_blocks else worst
            if self.kv_blocks < 2:
                raise ValueError(
                    f"kv_blocks must be >= 2 (scratch + 1), got "
                    f"{self.kv_blocks}"
                )
        else:
            if kv_blocks:
                raise ValueError("kv_blocks needs kv_block > 0 (paged mode)")
            self.blocks_per_slot = 0
            self.kv_blocks = 0
        # -- prefix sharing --
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and not self.paged:
            raise ValueError(
                "prefix_cache needs the paged KV layout (kv_block > 0): "
                "sharing is block-table indirection, and the padded layout "
                "has no blocks to share"
            )
        # -- sharded serving: the padded batch on 'n', the heads on 'c';
        # the paged pool has no batch axis, so 'n' replicates it --
        self._plan = self._pc = self._world = None
        if shard is not None:
            n, c = int(shard[0]), int(shard[1])
            if n < 1 or c < 1 or n * c < 2:
                raise ValueError(f"shard=(n, c) needs n*c >= 2, got {shard}")
            if not launch.in_world():
                _log.warning(
                    "sharded decode needs %d devices, have %d (this process "
                    "is not a rank of a world, parallel/launch.py): falling "
                    "back to the single-mesh engine", n * c, 1)
            else:
                if launch.world_size() != n * c:
                    raise ValueError(
                        f"shard=({n}, {c}) needs a world of {n * c} ranks, "
                        f"this one has {launch.world_size()}")
                if not self.paged and self.max_batch % n:
                    raise ValueError(
                        f"shard batch degree n={n} must divide "
                        f"max_batch={self.max_batch}")
                bad = [name for name, (h, _hd, _dt)
                       in self._cache_specs.items() if h % c]
                if bad:
                    raise ValueError(
                        f"shard head degree c={c} must divide num_heads of "
                        f"every attention op; offenders: {bad}")
                self._plan = build_mesh_plan(n * c)
                self._pc = ParallelConfig(n=n, c=c)
                self._world = _world_for(self._plan)
                #: The mesh axes 'n' takes: a padded superstep's
                #: readback is all-gathered over them in rank order.
                self._n_axes = self._plan.assign(self._pc)["n"]
        self.shard = ((self._pc.n, self._pc.c) if self._pc is not None
                      else None)
        # -- speculative drafting: the first ``draft_layers`` blk{i}_
        # blocks; the skipped ones pass the residual stream through --
        self.draft_layers = int(draft_layers or 0)
        blk_of: Dict[str, int] = {}
        for op in self._layers:
            m = re.match(r"blk(\d+)_", op.name)
            if m:
                blk_of[op.name] = int(m.group(1))
        n_blocks = max(blk_of.values()) + 1 if blk_of else 0
        if self.draft_layers:
            if not blk_of:
                raise ValueError(
                    "draft_layers needs blk{i}_-named transformer blocks "
                    "(models/transformer.py naming); this graph has none"
                )
            if not 1 <= self.draft_layers <= n_blocks:
                raise ValueError(
                    f"draft_layers must be in [1, {n_blocks}], got "
                    f"{self.draft_layers}"
                )
        self._draft_skip = frozenset(
            name for name, i in blk_of.items()
            if self.draft_layers and i >= self.draft_layers
        )
        #: The draft's own (always padded) cache specs: the attention ops
        #: the truncation keeps.
        self._draft_cache_specs = {
            name: spec for name, spec in self._cache_specs.items()
            if name not in self._draft_skip
        }
        self._prefill_fns: Dict[Any, Any] = {}
        #: Program keys whose ``serving_program`` event went out (JAX
        #: emits one at each program's first build; a scheduler's engine
        #: restart clears this with the prefill cache).
        self._built: set = set()

    def init(self, seed: Optional[int] = None):
        """Fresh ``(params, op_state)`` on the serving device, whole on
        every rank (the throwaway executor's default strategy is data
        parallel)."""
        params = Executor(self.model, config=self.config,
                          device=self.device).init_params(seed)
        return params, {}

    # -- params / checkpoint handoff ---------------------------------------

    def _templates(self):
        """``(params, None, op_state)`` templates on the serving device,
        from the init path training uses, so a training snapshot restores
        into the same structure.  The optimizer's template is None: the
        snapshot's optimizer state (whatever the optimizer was) is read
        and dropped."""
        params, state = Executor(self.model, config=self.config,
                                 device=self.device).init_params_and_state()
        return params, None, state

    def restore(self, ckpt_dir: str, step: Optional[int] = None):
        """The train-to-serve handoff: ``(step, params, op_state)`` of a
        training checkpoint directory (the latest readable step, or
        ``step``), restored into tensors on the serving device."""
        from flexflow_torch.runtime.checkpoint import CheckpointManager

        with CheckpointManager(ckpt_dir, read_only=True) as ck:
            got, params, _opt, state = ck.restore(
                templates=self._templates(), step=step)
        return got, params, state

    # -- capacity ------------------------------------------------------------

    @property
    def _bytes_per_token(self) -> int:
        """Bytes one cached position costs across all layers (K and V)."""
        return sum(2 * h * hd * torch.empty((), dtype=dt).element_size()
                   for (h, hd, dt) in self._cache_specs.values())

    def cache_total_bytes(self) -> int:
        """Bytes :meth:`init_cache` allocates on this rank (the budget
        estimate): under a shard the paged pool's share of ``c`` and the
        padded cache's of ``n * c``."""
        if self.paged:
            total = self.kv_blocks * self.kv_block * self._bytes_per_token
            return total // self.shard[1] if self.shard else total
        total = self.max_batch * self.max_seq * self._bytes_per_token
        return total // (self.shard[0] * self.shard[1]) if self.shard \
            else total

    def hbm_per_slot_bytes(self, prompt_len: Optional[int] = None,
                           max_new_tokens: Optional[int] = None) -> int:
        """KV-cache bytes one slot costs.  Padded: the worst-case
        ``max_seq`` row whatever the request.  Paged: the blocks the
        ledger reserves for a ``(prompt_len, max_new_tokens)`` request
        (default: the worst case)."""
        if not self.paged:
            return self.max_seq * self._bytes_per_token
        if prompt_len is None:
            blocks = self.blocks_per_slot
        else:
            led = KVBlockLedger(self.kv_blocks, self.kv_block, self.max_seq)
            blocks = led.blocks_for(
                prompt_len,
                self.max_seq if max_new_tokens is None else max_new_tokens)
        return blocks * self.kv_block * self._bytes_per_token

    def max_admissible_batch(self, budget_bytes: int, prompt_len: int,
                             max_new_tokens: int) -> int:
        """Concurrent slots a cache budget admits for uniform
        ``(prompt_len, max_new_tokens)`` requests: padded by worst-case
        rows, paged by the block pool the budget holds."""
        if not self.paged:
            return budget_bytes // (self.max_seq * self._bytes_per_token)
        block_bytes = self.kv_block * self._bytes_per_token
        pool_blocks = budget_bytes // block_bytes - 1  # scratch
        led = KVBlockLedger(self.kv_blocks, self.kv_block, self.max_seq)
        need = led.blocks_for(prompt_len, max_new_tokens)
        return max(pool_blocks, 0) // need

    def make_ledger(self) -> KVBlockLedger:
        """The paged pool's host-side accounting (raises unless paged)."""
        if not self.paged:
            raise ValueError("make_ledger() needs kv_block > 0 (paged mode)")
        return KVBlockLedger(self.kv_blocks, self.kv_block, self.max_seq,
                             prefix_cache=self.prefix_cache)

    def _budget_check(self):
        """Refuse before allocating when the KV cache cannot fit the
        device budget (``FF_DEVICE_MEM_BYTES``, else the card's memory)."""
        limit = _device_bytes_limit(self.device)
        if limit is None:
            return
        total = self.cache_total_bytes()
        if total > limit:
            layout = (
                f"paged pool ({self.kv_blocks} x {self.kv_block}-token "
                f"blocks)" if self.paged else
                f"padded ({self.max_batch} slots x {self.max_seq} rows)"
            )
            hint = (
                "shrink kv_blocks or kv_block" if self.paged else
                "switch to the paged layout (kv_block > 0) so the cache "
                "scales with the generated length instead of worst-case "
                "max_seq"
            )
            raise DeviceMemoryError(
                f"KV cache needs {total} bytes/device ({layout}) but the "
                f"device budget is {limit} bytes (FF_DEVICE_MEM_BYTES / "
                f"the device's memory): {hint}"
            )

    # -- the rank's share ------------------------------------------------------

    @property
    def _rows(self) -> slice:
        """The slots this rank runs: its ``n`` block of the padded batch,
        else the whole batch (the paged layout, ``n`` = 1, no shard)."""
        if not self.shard or self.paged or self.shard[0] == 1:
            return slice(0, self.max_batch)
        b = self.max_batch // self.shard[0]
        i = self._world.index(self._n_axes)
        return slice(i * b, (i + 1) * b)

    def slot_row(self, slot: int) -> Optional[int]:
        """``slot``'s row of this rank's padded caches (the main model's
        and the draft's), or None when another rank holds it."""
        rows = self._rows
        return slot - rows.start if rows.start <= slot < rows.stop else None

    def _local(self, specs):
        """Cache specs cut to the rank's ``h/c`` heads."""
        c = self.shard[1] if self.shard else 1
        return {name: (h // c, hd, dt) for name, (h, hd, dt) in specs.items()}

    # -- caches -------------------------------------------------------------

    def _zeros(self, specs, lead: Tuple[int, int]):
        """Zeroed K/V over ``lead`` for each op of ``specs``, at the
        rank's heads."""
        return {
            name: {
                "k": torch.zeros(lead + (h, hd), dtype=dt, device=self.device),
                "v": torch.zeros(lead + (h, hd), dtype=dt, device=self.device),
            }
            for name, (h, hd, dt) in self._local(specs).items()
        }

    @torch.inference_mode()
    def init_cache(self):
        """Zeroed per-layer caches: padded ``{op: {"k"/"v": (max_batch,
        max_seq, heads, d_head)}}``, or paged the block pool
        ``(kv_blocks, kv_block, heads, d_head)``; under a shard the
        rank's block, ``(max_batch / n, max_seq, heads / c, d_head)`` or
        ``(kv_blocks, kv_block, heads / c, d_head)``."""
        self._budget_check()
        if self.paged:
            return self._zeros(self._cache_specs,
                               (self.kv_blocks, self.kv_block))
        rows = self._rows
        return self._zeros(self._cache_specs,
                           (rows.stop - rows.start, self.max_seq))

    @torch.inference_mode()
    def init_draft_cache(self):
        """The draft's own caches, always padded ``(max_batch, max_seq,
        h, hd)`` over the layers the truncation keeps: an acceleration
        structure that costs acceptance, never correctness.  Under a
        shard the rank's block: its ``n`` rows on the padded layout, every
        row on the paged one (JAX shards the heads only there)."""
        rows = self._rows
        return self._zeros(self._draft_cache_specs,
                           (rows.stop - rows.start, self.max_seq))

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest pad bucket "
            f"{self.buckets[-1]} (max_seq={self.max_seq})"
        )

    # -- the forward walk ---------------------------------------------------

    def _forward(self, params, op_state, tokens, caches, pos,
                 block_table=None, skip=None, chunk: int = 0):
        """Forward over the non-loss graph in inference mode: attention
        ops get their caches, ``pos`` and (paged) ``block_table`` through
        ``state`` (the ``ops/attention.py`` KV-cache protocol), position
        embeddings get ``pos``; every other op runs its eval forward.
        ``skip`` (the truncated draft) names ops whose outputs are their
        first input; ``chunk`` starts a multi-token call at absolute row
        ``chunk`` of an already populated cache (the offset prefill).
        Returns ``(logits, caches)``."""
        env: Dict[str, Any] = {self._tokens_name: tokens}
        new_caches: Dict[str, Any] = {}
        for op in self._layers:
            if skip and op.name in skip:
                passed = env[op.inputs[0].name]
                for t in op.outputs:
                    env[t.name] = passed
                continue
            # JAX's binding: the serving shard's plan on the attention
            # ops only (their c-split heads); every other op runs
            # mesh-less on the rank's rows, whatever a training executor
            # last bound on these shared op objects.
            if isinstance(op, MultiHeadAttention):
                op.bind_mesh(self._plan, self._pc, self._world)
                op.decode_kernel = self.decode_kernel
            else:
                op.bind_mesh(None, None, None)
            xs = [env[t.name] for t in op.inputs]
            s = dict(op_state.get(op.name, {}))
            if op.name in caches:
                s["cache_k"] = caches[op.name]["k"]
                s["cache_v"] = caches[op.name]["v"]
                s["pos"] = pos
                if block_table is not None:
                    s["block_table"] = block_table
                if chunk:
                    s["chunk"] = int(chunk)
            elif isinstance(op, PositionEmbedding):
                s["pos"] = pos
                if chunk:
                    s["chunk"] = int(chunk)
            ys, s_new = op.forward(params.get(op.name, {}), xs, s,
                                   training=False)
            if op.name in caches:
                new_caches[op.name] = {"k": s_new["cache_k"],
                                       "v": s_new["cache_v"]}
            for t, y in zip(op.outputs, ys):
                env[t.name] = y
        return env[self._logits_name], new_caches

    # -- token selection ----------------------------------------------------

    def _picker(self, sample: Sample):
        """THE token selection of the decode superstep and of the
        speculative draft and verify steps: greedy argmax, or the keyed
        temperature / top-k draw whose key is ``fold_in(fold_in(key(seed),
        req_id), pos)``, a pure function of (seed, request, position).
        ``(logits (B, V), req_ids (B,), pos (B,)) -> (B,) int32``."""
        if sample is None:
            def pick_greedy(logits, req_ids, pos):
                return torch.argmax(logits, dim=-1).to(torch.int32)

            return pick_greedy
        temperature, top_k, seed = sample
        base = keyed_random.key(seed, self.device)  # made outside any graph

        def pick_sampled(logits, req_ids, pos):
            kk = keyed_random.fold_in(keyed_random.fold_in(base, req_ids), pos)
            lg = logits.float() / _f32(logits, temperature)
            if 0 < top_k < lg.shape[-1]:
                kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
                lg = torch.where(lg >= kth, lg, torch.full_like(lg, -np.inf))
            return keyed_random.categorical(kk, lg).to(torch.int32)

        return pick_sampled

    def _pick_first(self, sample: Sample):
        """THE prefill first-token selection of :meth:`build_prefill` and
        :meth:`build_prefill_from`: greedy, or (sampled) the keyed draw at
        ``length - 1`` for a resumed position (``length > prompt_len``);
        a fresh admission stays greedy, since decode samples only the
        positions past the prompt."""
        pick = self._picker(sample)

        def pick_first(last, length: int, plen, rid):
            if sample is None or length <= plen:
                return torch.argmax(last, dim=-1).to(torch.int32)
            ids = torch.full((1,), int(rid), dtype=torch.int32,
                             device=last.device)
            pos = torch.full((1,), int(length) - 1, dtype=torch.int32,
                             device=last.device)
            return pick(last[None], ids, pos)[0]

        return pick_first

    # -- programs -----------------------------------------------------------

    def _announce(self, key, **fields) -> None:
        """One ``serving_program`` event at the first build of ``key``."""
        if key not in self._built:
            self._built.add(key)
            _telemetry.current().emit("serving_program", **fields)

    @property
    def _layout(self) -> str:
        return "paged" if self.paged else "padded"

    def program_flops(self, tokens: int) -> float:
        """Analytic forward flops of a program over ``tokens`` token
        positions (``search/cost_model.py::serving_flops``): the
        ``program_cost`` events' number."""
        from flexflow_torch.search.cost_model import serving_flops

        return serving_flops(self.model, tokens)

    def _tokens(self, tokens, shape: Tuple[int, int]) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device)
        if tuple(tokens.shape) != shape:
            raise ValueError(f"prefill takes {shape} tokens, got "
                             f"{tuple(tokens.shape)}")
        return tokens.to(torch.int32)

    def build_prefill(self, bucket: int, sample: Sample = None):
        """The prefill for one pad bucket: ``(params, op_state, tokens (1,
        bucket), length[, prompt_len, req_id]) -> (cache_rows,
        first_token, finite)``.  ``cache_rows`` are ``(max_seq, h, hd)``
        per layer (rows past ``bucket`` zero), ready for :meth:`install`
        or :meth:`install_paged`; ``first_token`` and ``finite`` stay on
        the device.  ``sample`` selects the sampled first token of
        :meth:`_pick_first` (it needs ``prompt_len`` and ``req_id``)."""
        sample = _check_sample(sample)
        key = (bucket, sample)
        fn = self._prefill_fns.get(key)
        if fn is not None:
            return fn
        pick_first = self._pick_first(sample)

        @torch.inference_mode()
        def prefill(params, op_state, tokens, length, plen=None, rid=None):
            tokens = self._tokens(tokens, (1, bucket))
            caches = self._zeros(self._cache_specs, (1, self.max_seq))
            pos = torch.zeros((1,), dtype=torch.int32, device=self.device)
            logits, caches = self._forward(params, op_state, tokens, caches,
                                           pos)
            last = logits[0, int(length) - 1]
            tok = pick_first(last, int(length), plen, rid)
            ok = torch.isfinite(last.float()).all()
            rows = {name: {"k": c["k"][0], "v": c["v"][0]}
                    for name, c in caches.items()}
            return rows, tok, ok

        self._prefill_fns[key] = prefill
        self._announce(("prefill",) + key, kind="prefill", bucket=int(bucket),
                       sampled=sample is not None)
        return prefill

    def build_prefill_from(self, bucket: int, offset: int,
                           sample: Sample = None):
        """The offset prefill of prefix sharing (paged + ``prefix_cache``):
        :meth:`build_prefill` started at row ``offset``, the shared span's
        K/V gathered from resident pool blocks instead of recomputed.
        ``(params, op_state, pool, shared_ids (offset / kv_block,), tokens
        (1, bucket), length[, prompt_len, req_id]) -> (cache_rows,
        first_token, finite)``; ``pool`` is only read, and ``cache_rows``
        are zero over ``[0, offset)`` (the masked install writes those
        chunks into scratch block 0).  K/V at row r depends only on tokens
        ``[0, r]``, so the gathered rows equal what this prompt's own
        prefill would write.  The tail attends on the fresh prefill's
        route over the same span (``MultiHeadAttention._attend_offset``:
        its queries at their absolute rows of a zero query over the
        bucket, through the dispatcher, so K1f on the card), so with the
        cache in the compute dtype its rows, logits and token are those of
        the unshared prefill, as long as the projections round alike at
        ``bucket - offset`` rows as at ``bucket``."""
        if not self.paged or not self.prefix_cache:
            raise ValueError("build_prefill_from needs paged + prefix_cache")
        o = int(offset)
        if o < self.kv_block or o % self.kv_block or o >= bucket:
            raise ValueError(
                f"offset must be a multiple of kv_block={self.kv_block} in "
                f"[kv_block, bucket): offset={o}, bucket={bucket}"
            )
        sample = _check_sample(sample)
        key = ("from", bucket, o, sample)
        fn = self._prefill_fns.get(key)
        if fn is not None:
            return fn
        pick_first = self._pick_first(sample)

        @torch.inference_mode()
        def prefill(params, op_state, pool, shared_ids, tokens, length,
                    plen=None, rid=None):
            tokens = self._tokens(tokens, (1, bucket))
            ids = torch.as_tensor(np.asarray(shared_ids), dtype=torch.long,
                                  device=self.device)
            caches = self._zeros(self._cache_specs, (1, self.max_seq))
            for name, (h, hd, _dt) in self._local(self._cache_specs).items():
                for kv in ("k", "v"):
                    caches[name][kv][0, :o] = pool[name][kv][ids].reshape(
                        o, h, hd)
            pos = torch.full((1,), o, dtype=torch.int32, device=self.device)
            logits, caches = self._forward(params, op_state, tokens[:, o:],
                                           caches, pos, chunk=o)
            last = logits[0, int(length) - 1 - o]
            tok = pick_first(last, int(length), plen, rid)
            ok = torch.isfinite(last.float()).all()
            rows = {name: {"k": c["k"][0], "v": c["v"][0]}
                    for name, c in caches.items()}
            return rows, tok, ok

        self._prefill_fns[key] = prefill
        self._announce(key, kind="prefill_from", bucket=int(bucket), offset=o,
                       sampled=sample is not None)
        return prefill

    def build_draft_prefill(self, bucket: int):
        """The draft's prefill: ``(draft_params, op_state, tokens (1,
        bucket)) -> draft cache rows``, the truncated forward over the
        padded prompt, for :meth:`install` into :meth:`init_draft_cache`.
        Nothing is read back: a wrong draft row only costs acceptance."""
        key = ("draft", bucket)
        fn = self._prefill_fns.get(key)
        if fn is not None:
            return fn

        @torch.inference_mode()
        def prefill(params, op_state, tokens):
            tokens = self._tokens(tokens, (1, bucket))
            caches = self._zeros(self._draft_cache_specs, (1, self.max_seq))
            pos = torch.zeros((1,), dtype=torch.int32, device=self.device)
            _logits, caches = self._forward(params, op_state, tokens, caches,
                                            pos, skip=self._draft_skip)
            return {name: {"k": c["k"][0], "v": c["v"][0]}
                    for name, c in caches.items()}

        self._prefill_fns[key] = prefill
        self._announce(key, kind="draft_prefill", bucket=int(bucket),
                       draft_layers=self.draft_layers)
        return prefill

    @torch.inference_mode()
    def install(self, caches, rows, slot: int):
        """Copy a prefilled cache row into ``slot`` of every layer's K
        and V (a padded cache or the draft's), in place; returns
        ``caches``.  Under a shard only the rank that holds the slot
        writes (:meth:`slot_row`)."""
        row = self.slot_row(slot)
        if row is None:
            return caches
        for name, r in rows.items():
            caches[name]["k"][row].copy_(r["k"])
            caches[name]["v"][row].copy_(r["v"])
        return caches

    @torch.inference_mode()
    def install_paged(self, caches, rows, table_row):
        """The paged :meth:`install`: the prefilled ``(max_seq, h, hd)``
        rows cut into ``kv_block`` chunks and scattered into the pool
        blocks of ``table_row``, in place (entries 0 write their chunks
        into scratch block 0); returns ``caches``."""
        row = torch.as_tensor(np.asarray(table_row), dtype=torch.long,
                              device=self.device)
        for name, r in rows.items():
            for kv in ("k", "v"):
                c = caches[name][kv]
                c[row] = r[kv].to(c.dtype).reshape((-1,) + tuple(c.shape[1:]))
        return caches

    def _carry(self, x) -> torch.Tensor:
        """A ``(B,)`` or ``(B, nblk)`` int32 argument on the serving
        device: a tensor as it is (updated in place), host values copied
        into a new one."""
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.int32 or x.device.type != self.device.type:
                raise ValueError(f"decode carry tensors are int32 on "
                                 f"{self.device}, got {x.dtype} on {x.device}")
            return x
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=self.device)

    def _graph(self, graph: Optional[bool]) -> bool:
        """The ``graph`` option: by default on CUDA; never under a shard
        (gloo's collectives cannot be captured; NCCL's in the decode graph
        are ROADMAP.md item 1)."""
        if self.shard is not None:
            if graph:
                raise ValueError(
                    f"shard={self.shard}: the sharded programs run eagerly "
                    f"(graph=False); capturing their collectives is "
                    f"ROADMAP.md queue 1, item 1")
            return False
        return self.device.type == "cuda" if graph is None else bool(graph)

    def _split_args(self, args, sample, what: str):
        want = 2 + int(self.paged) + int(sample is not None)
        if len(args) != want:
            raise ValueError(
                f"{what} takes {'block_table, ' if self.paged else ''}pos, "
                f"tok{', req_ids' if sample is not None else ''} after the "
                f"caches: {want} arguments, got {len(args)}")
        args = [self._carry(a) for a in args]
        bt = args.pop(0) if self.paged else None
        rids = args.pop() if sample is not None else None
        return bt, args[0], args[1], rids

    def build_decode_superstep(self, k: int, return_logits: bool = False,
                               sample: Sample = None,
                               graph: Optional[bool] = None):
        """K single-token decode steps over the whole slot batch:
        ``(params, op_state, caches, [block_table (B, nblk),] pos (B,),
        tok (B,)[, req_ids (B,)]) -> (caches, pos, tok, (tokens (K, B),
        finite (K, B)[, logits (K, B, V)]))``, the token chosen on the
        device by :meth:`_picker` and nothing read back inside.  Each step
        writes its K/V at ``pos`` and advances ``pos = min(pos + 1,
        max_seq - 1)``; the caches, ``pos`` and ``tok`` are updated in
        place (host values in become new tensors).

        ``graph`` (default: on CUDA) runs the K steps through a
        :class:`StepGraph`: the first call runs them eagerly and captures
        them, every later call replays the graph and must pass the same
        tensors (a call with others raises).  The stacked outputs of a
        replay are the graph's own tensors, valid until the next call.
        ``graph=False`` is the eager loop, the oracle the graph is held
        against.  A graph form is built anew on every call of this
        method (it binds to the tensors of its first call); the eager
        form has nothing to bind.

        Under a shard the K steps run eagerly on the rank's slots
        (:attr:`_rows`) and the stacked outputs are all-gathered over
        ``n`` once at the end, after which ``tok`` holds the whole
        batch's last tokens on every rank."""
        if k < 1:
            raise ValueError(f"decode steps per call must be >= 1, got {k}")
        sample = _check_sample(sample)
        graph = self._graph(graph)
        S = self.max_seq
        pick = self._picker(sample)
        rows = self._rows

        def step(params, op_state, caches, block_table, pos, tok, req_ids,
                 _inputs):
            p, t = pos[rows], tok[rows]
            logits, _ = self._forward(params, op_state, t[:, None], caches,
                                      p, block_table=block_table)
            logits = logits[:, 0]                                # (B, V)
            nxt = pick(logits, None if req_ids is None else req_ids[rows], p)
            out = {"tokens": nxt,
                   "finite": torch.isfinite(logits.float()).all(dim=-1)}
            if return_logits:
                out["logits"] = logits
            t.copy_(nxt)
            pos.copy_(torch.clamp(pos + 1, max=S - 1))
            return params, op_state, caches, block_table, pos, tok, req_ids, out

        runner = StepGraph(step, k, self.device) if graph else None
        self._announce(("decode", k, return_logits, sample), kind="decode",
                       k=int(k), layout=self._layout,
                       sharded=self.shard is not None,
                       sampled=sample is not None)

        @torch.inference_mode()
        def superstep(params, op_state, caches, *args):
            bt, pos, tok, rids = self._split_args(args, sample, "decode")
            carry = (params, op_state, caches, bt, pos, tok, rids)
            if runner is not None:
                *_carry, outs = runner(*carry, {})
            else:
                steps = []
                for _ in range(k):
                    *carry, out = step(*carry, {})
                    steps.append(out)
                outs = {n: torch.stack([o[n] for o in steps]) for n in steps[0]}
                if rows != slice(0, self.max_batch):
                    # One all-gather over n for the int outputs, one for
                    # the logits; then the carry's tokens are whole.
                    both = self._world.all_gather(torch.stack(
                        [outs["tokens"], outs["finite"].to(torch.int32)]), 2,
                        self._n_axes)
                    outs["tokens"], outs["finite"] = both[0], both[1].bool()
                    if return_logits:
                        outs["logits"] = self._world.all_gather(
                            outs["logits"], 1, self._n_axes)
                    tok.copy_(outs["tokens"][-1])
            res = (outs["tokens"], outs["finite"])
            if return_logits:
                res += (outs["logits"],)
            return caches, pos, tok, res

        superstep.graph = runner
        return superstep

    def build_spec_step(self, d: int, sample: Sample = None,
                        graph: Optional[bool] = None):
        """One speculative round: d draft steps on the draft's own padded
        caches propose ``t_1..t_d``, then d + 1 verify steps score ``[tok,
        t_1..t_d]`` through the decode step's body, and the longest
        matching prefix is accepted on the device.

        ``(params, draft_params, op_state, caches, dcaches, [block_table,]
        pos, tok[, req_ids]) -> (caches, dcaches, pos, tok, (tokens (d+1,
        B), finite (d+1, B), accepted (B,)))``; ``pos`` and ``tok`` come
        back advanced past the accepted tokens and the correction token,
        in place.  The verify step at each position is the decode step at
        that position (same forward, same clamped position walk, same
        :meth:`_picker`), so the emitted tokens equal sequential decode's
        whatever the draft proposes; acceptance decides only how many a
        round emits.  Rejected rows need no rollback: the ``<= pos`` mask
        hides them until the position walk overwrites them.  The draft
        runs d + 1 steps: the last one writes the draft cache's row of the
        last proposal (a fully accepted round would otherwise leave it
        empty), and its own proposal is dropped.  ``d`` goes through
        ``relay_safe_steps``; ``graph`` as in
        :meth:`build_decode_superstep` (one graph per round)."""
        if d < 1:
            raise ValueError(
                f"speculate depth must be >= 1, got {d} (plain decode is "
                f"build_decode_superstep)")
        d = relay_safe_steps(d, what="speculate", log=_log)
        sample = _check_sample(sample)
        graph = self._graph(graph)
        S = self.max_seq
        pick = self._picker(sample)
        rows = self._rows

        def spec_round(params, draft_params, op_state, caches, dcaches,
                       block_table, pos, tok, req_ids, _inputs):
            # The rank's slots (the whole batch off a padded shard).
            pos_r, tok_r = pos[rows], tok[rows]
            rids = None if req_ids is None else req_ids[rows]
            p, t = pos_r, tok_r
            proposals = []
            for _ in range(d + 1):
                logits, _ = self._forward(draft_params, op_state, t[:, None],
                                          dcaches, p, skip=self._draft_skip)
                t = pick(logits[:, 0], rids, p)
                proposals.append(t)
                p = torch.clamp(p + 1, max=S - 1)
            draft_toks = torch.stack(proposals[:d])             # (d, B)
            tok_seq = torch.cat([tok_r[None], draft_toks])      # (d+1, B)
            p = pos_r
            ys, oks = [], []
            for i in range(d + 1):
                logits, _ = self._forward(params, op_state, tok_seq[i][:, None],
                                          caches, p, block_table=block_table)
                logits = logits[:, 0]
                ys.append(pick(logits, rids, p))
                oks.append(torch.isfinite(logits.float()).all(dim=-1))
                p = torch.clamp(p + 1, max=S - 1)
            ys, oks = torch.stack(ys), torch.stack(oks)
            matches = (draft_toks == ys[:d]).to(torch.int32)
            accepted = torch.cumprod(matches, dim=0).sum(dim=0).to(torch.int32)
            if rows != slice(0, self.max_batch):
                # One all-gather over n: the whole batch's round.
                both = self._world.all_gather(torch.cat(
                    [ys, oks.to(torch.int32), accepted[None]]), 1,
                    self._n_axes)
                ys, oks, accepted = (both[:d + 1], both[d + 1:-1].bool(),
                                     both[-1])
            nxt = ys.gather(0, accepted[None].long())[0]
            pos.copy_(torch.clamp(pos + accepted + 1, max=S - 1))
            tok.copy_(nxt)
            return (params, draft_params, op_state, caches, dcaches,
                    block_table, pos, tok, req_ids,
                    {"tokens": ys, "finite": oks, "accepted": accepted})

        runner = StepGraph(spec_round, 1, self.device) if graph else None
        self._announce(("spec", d, sample), kind="spec", d=int(d),
                       draft_layers=self.draft_layers, layout=self._layout,
                       sharded=self.shard is not None,
                       sampled=sample is not None)

        @torch.inference_mode()
        def spec(params, draft_params, op_state, caches, dcaches, *args):
            bt, pos, tok, rids = self._split_args(args, sample, "spec")
            carry = (params, draft_params, op_state, caches, dcaches, bt, pos,
                     tok, rids)
            if runner is not None:
                *_carry, outs = runner(*carry, {})
                outs = {n: v[0] for n, v in outs.items()}
            else:
                *_carry, outs = spec_round(*carry, {})
            return (caches, dcaches, pos, tok,
                    (outs["tokens"], outs["finite"], outs["accepted"]))

        spec.graph = runner
        return spec


    # -- compute-free mode ---------------------------------------------------

    def abstract_programs(self, decode_steps: int = 8, speculate: int = 0):
        """The serving dry run: every program traced on ``meta`` tensors
        (shapes and dtypes only, under ``kernels.shapes_only``; no device
        compute, no kernel launch, the kernels' gates still checked), the
        counterpart of JAX's
        ``jax.eval_shape`` over the same programs.  Returns the program
        table ``{"cache": {op: (kv shape) tensor}, "prefill": {bucket:
        first-token tensor}, "decode": (K, B) tokens}``, with
        ``"prefill_from"`` (the offset prefill at offset ``kv_block`` per
        bucket above it) under the prefix cache and ``"spec"`` (the (d+1,
        B) verified tokens) with ``speculate=d``; every tensor is on
        ``meta``.  The decode runs eagerly (a graph needs a card).  A
        sharded engine's dry run is ROADMAP.md queue 1, item 14."""
        if self.shard is not None:
            raise ValueError(
                f"the dry run of a sharded engine (shard={self.shard}) is "
                f"ROADMAP.md queue 1, item 14")
        meta = torch.device("meta")
        B, S = self.max_batch, self.max_seq
        params = {}
        for op in self.model.layers:
            specs = op.param_specs()
            if specs:
                params[op.name] = {k: torch.empty(sp.shape, dtype=sp.dtype,
                                                  device=meta)
                                   for k, sp in specs.items()}

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=meta)

        def prompt(bucket):  # host tokens, as the loop passes them
            return np.zeros((1, bucket), np.int32)

        def cache_of(specs, lead):
            return {name: {kv: torch.empty(lead + (h, hd), dtype=dt,
                                           device=meta) for kv in ("k", "v")}
                    for name, (h, hd, dt) in specs.items()}

        lead = (self.kv_blocks, self.kv_block) if self.paged else (B, S)
        device, self.device = self.device, meta
        try:
            with kernels.shapes_only():
                caches = cache_of(self._cache_specs, lead)
                out: Dict[str, Any] = {
                    "cache": {n: c["k"] for n, c in caches.items()},
                    "prefill": {}}
                for bucket in self.buckets:
                    _rows, tok, _ok = self.build_prefill(bucket)(
                        params, {}, prompt(bucket), bucket)
                    out["prefill"][bucket] = tok
                bt = (ints(B, self.blocks_per_slot),) if self.paged else ()
                dec = self.build_decode_superstep(decode_steps, graph=False)
                _c, _p, _t, (toks, _ok) = dec(params, {}, caches, *bt,
                                              ints(B), ints(B))
                out["decode"] = toks
                if self.paged and self.prefix_cache:
                    out["prefill_from"] = {}
                    o = self.kv_block
                    for bucket in self.buckets:
                        if bucket <= o:
                            continue
                        _rows, tok, _ok = self.build_prefill_from(bucket, o)(
                            params, {}, caches, np.zeros((1,), np.int32),
                            prompt(bucket), bucket)
                        out["prefill_from"][bucket] = tok
                if speculate:
                    dcaches = cache_of(self._draft_cache_specs, (B, S))
                    for bucket in self.buckets:
                        self.build_draft_prefill(bucket)(params, {},
                                                         prompt(bucket))
                    spec = self.build_spec_step(speculate, graph=False)
                    *_c, (ys, _ok, _acc) = spec(params, params, {}, caches,
                                                dcaches, *bt, ints(B),
                                                ints(B))
                    out["spec"] = ys
        finally:
            self.device = device
        return out


class Server:
    """Closed-loop FIFO serving over a :class:`ServingExecutor`.

    ``run(requests)`` admits requests into free slots (prefill, or a
    prefix-cache hit, and the cache install), runs one decode superstep
    of K steps (or, with ``speculate=d``, one speculative round) over the
    batch, consumes the read-back tokens per slot (EOS / budget / context
    limits), evicts finished slots, and repeats.  Returns ``(results,
    stats)``.

    ``temperature > 0`` samples with the keyed draw of ``(sample_seed,
    request id, position)``; greedy is the default.  ``draft_params``
    (default: the serving params) drive the speculative draft.  The
    Server keeps its caches, its persistent ``pos`` / ``tok`` / block
    table / request-id tensors and its decode program across runs (each
    run zeroes the caches), so on CUDA the graph captured in the first
    run replays in the next.  ``graph`` as in
    :meth:`ServingExecutor.build_decode_superstep`.

    The failure model of the plain loop, as JAX's:
    ``fault_injector`` (:class:`ServingFaultInjector`) fires before the
    supersteps it names; a :class:`ServingFault` errors out its slot's
    request only, a :class:`ServingEngineFault` propagates.
    ``journal`` (``serving/journal.py::RequestJournal``) records each
    admission, each superstep's tokens and each completion; a run on a
    journal with records restores the completed requests without
    re-running them and resumes the in-flight ones by a re-prefill over
    ``prompt ‖ carried``.  A journal arms ``drain_on_preempt``: on
    SIGTERM or SIGINT the run stops at the next superstep boundary with
    its in-flight work journaled (``stats["drained"]``), and a run on
    the same journal serves the rest."""

    def __init__(self, executor: ServingExecutor, params, op_state,
                 decode_steps: int = 8, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, speculate: int = 0,
                 draft_params=None, graph: Optional[bool] = None,
                 fault_injector: Optional[ServingFaultInjector] = None,
                 journal=None, drain_on_preempt: bool = False):
        self.ex = executor
        self.params = params
        self.op_state = op_state
        self.decode_steps = relay_safe_steps(decode_steps,
                                             what="decode_steps", log=_log)
        #: Speculative draft depth d (0 = the plain decode superstep).
        self.speculate = (relay_safe_steps(speculate, what="speculate",
                                           log=_log) if speculate else 0)
        self.draft_params = draft_params if draft_params is not None \
            else params
        self.eos_id = eos_id
        self.sample: Sample = (
            (float(temperature), int(top_k), int(sample_seed))
            if temperature > 0.0 else None
        )
        self.graph = graph
        self.injector = fault_injector
        self.journal = journal
        self.drain_on_preempt = bool(drain_on_preempt) or journal is not None
        #: ``(program, caches, dcaches, carry)`` of this Server: the decode
        #: superstep or speculative round, the KV caches (paged: the
        #: pool), the draft's caches (None unless speculating) and the
        #: persistent ``{"pos", "tok", "req", "bt"}`` int32 tensors the
        #: host's values are copied into before each call.  Made at the
        #: first run; each later run zeroes the caches in place.
        self.engine = None

    @torch.inference_mode()
    def _engine_state(self):
        ex = self.ex
        if self.engine is None:
            if self.speculate:
                fn = ex.build_spec_step(self.speculate, sample=self.sample,
                                        graph=self.graph)
                dcaches = ex.init_draft_cache()
            else:
                fn = ex.build_decode_superstep(self.decode_steps,
                                               sample=self.sample,
                                               graph=self.graph)
                dcaches = None
            B = ex.max_batch
            carry = {n: torch.zeros(shape, dtype=torch.int32,
                                    device=ex.device)
                     for n, shape in (("pos", (B,)), ("tok", (B,)),
                                      ("req", (B,)),
                                      ("bt", (B, ex.blocks_per_slot)))}
            self.engine = (fn, ex.init_cache(), dcaches, carry)
        else:
            _fn, caches, dcaches, _carry = self.engine
            for c in (caches, dcaches or {}):
                for kv in c.values():
                    kv["k"].zero_()
                    kv["v"].zero_()
        return self.engine

    def run(self, requests: Sequence[Request]):
        tel = _telemetry.current()
        ex = self.ex
        B, k = ex.max_batch, self.decode_steps
        spec_d = self.speculate
        step_fn, caches, dcaches, dev = self._engine_state()
        ledger = ex.make_ledger() if ex.paged else None
        block_table = (np.zeros((B, ledger.blocks_per_slot), np.int32)
                       if ledger is not None else None)
        slots: List[Optional[_Slot]] = [None] * B
        queue = collections.deque(requests)
        results: Dict[int, RequestResult] = {}
        superstep_idx = 0
        total_tokens = decode_tokens = supersteps = prefills = 0
        prefix_hits = full_hits = prefill_tokens_saved = kv_cows = 0
        draft_prefills = spec_accept_total = spec_draft_total = 0
        decode_s = 0.0
        t_run0 = time.perf_counter()
        # -- journal replay: completed requests are restored, in-flight
        # ones resume with their validated tokens carried --
        jr = self.journal
        carried_map: Dict[int, List[int]] = {}
        if jr is not None:
            st = jr.replay()
            for rid, rec in st.completed.items():
                results[rid] = RequestResult(
                    id=rid, prompt_len=int(rec.get("plen") or 0),
                    tokens=list(rec.get("tokens", [])),
                    error=rec.get("error"),
                    latency_s=float(rec.get("latency_s") or 0.0))
            carried_map = {int(rid): list(t)
                           for rid, t in st.in_flight.items()}
            queue = collections.deque(r for r in queue
                                      if r.id not in results)
            if not st.empty:
                _log.info("journal replay (%s): %d completed restored, %d "
                          "in flight resume with carried tokens%s", jr.path,
                          len(st.completed), len(carried_map),
                          " [torn tail tolerated]" if st.torn_tail else "")
        drained = False
        preempt = PreemptionHandler(install=self.drain_on_preempt)

        def finish(slot_i: int, error: Optional[str] = None):
            sl = slots[slot_i]
            toks = sl.all_tokens
            lat = time.perf_counter() - sl.t_eligible
            results[sl.request.id] = RequestResult(
                id=sl.request.id, prompt_len=len(sl.request.prompt),
                tokens=list(toks), error=error, latency_s=lat,
                prefill_s=sl.prefill_s,
            )
            tel.emit("request_end", id=sl.request.id, tokens=len(toks),
                     error=error, latency_s=round(lat, 6))
            if jr is not None:
                jr.done(sl.request.id, len(sl.request.prompt), len(toks),
                        error, latency_s=round(lat, 6))
            if ledger is not None:
                ledger.free(slot_i)
                block_table[slot_i] = 0
            slots[slot_i] = None

        def slot_done(sl: _Slot) -> bool:
            toks = sl.all_tokens
            if self.eos_id is not None and toks and toks[-1] == self.eos_id:
                return True
            if len(toks) >= sl.request.max_new_tokens:
                return True
            return sl.pos >= ex.max_seq  # context limit

        def reject(r: Request, err: str):
            # A complete start/end pair in the log, as for a served one.
            tel.emit("request_start", id=r.id, prompt_len=len(r.prompt),
                     bucket=None, slot=None)
            lat = time.perf_counter() - t_run0
            results[r.id] = RequestResult(
                id=r.id, prompt_len=len(r.prompt), tokens=[], error=err,
                latency_s=lat)
            tel.emit("request_end", id=r.id, tokens=0, error=err,
                     latency_s=round(lat, 6))
            if jr is not None:
                jr.done(r.id, len(r.prompt), 0, err, latency_s=round(lat, 6))

        def resume_complete(r: Request, prior: List[int]) -> bool:
            """A journaled in-flight request that had already finished
            (the crash fell between its token record and its done
            record): its result is restored without a prefill."""
            plen = len(r.prompt)
            if len(prior) < r.max_new_tokens and \
                    plen + len(prior) < ex.max_seq and \
                    not (self.eos_id is not None and prior and
                         prior[-1] == self.eos_id):
                return False
            tel.emit("request_start", id=r.id, prompt_len=plen, bucket=None,
                     slot=None)
            lat = time.perf_counter() - t_run0
            results[r.id] = RequestResult(
                id=r.id, prompt_len=plen, tokens=list(prior), error=None,
                latency_s=lat)
            tel.emit("request_end", id=r.id, tokens=len(prior), error=None,
                     latency_s=round(lat, 6))
            if jr is not None:
                jr.done(r.id, plen, len(prior), None, latency_s=round(lat, 6))
            return True

        preempt.__enter__()
        try:
            while queue or any(slots):
                if preempt.triggered and self.drain_on_preempt:
                    # -- the drain: no more admissions; the in-flight
                    # work is journaled at the last fence, and a run on
                    # the journal serves the rest --
                    drained = True
                    n_flight = sum(1 for sl in slots if sl is not None)
                    tel.emit("serving_drain", signum=preempt.signum,
                             in_flight=n_flight, queued=len(queue))
                    _log.warning("drain: signal %s; %d in flight journaled, "
                                 "%d queued; resume from the journal to "
                                 "serve the rest", preempt.signum, n_flight,
                                 len(queue))
                    if jr is not None:
                        jr.drain(n_flight, len(queue))
                    break
                # -- admissions (between decode supersteps) --
                while queue and None in slots:
                    r = queue[0]
                    plen = len(r.prompt)
                    prior = carried_map.get(r.id, [])
                    flen = plen + len(prior)
                    if prior and resume_complete(r, prior):
                        queue.popleft()
                        carried_map.pop(r.id, None)
                        continue
                    try:
                        bucket = ex.bucket_for(flen)
                    except ValueError as e:
                        queue.popleft()
                        carried_map.pop(r.id, None)
                        reject(r, str(e))
                        continue
                    plan = None
                    if ledger is not None:
                        need = ledger.blocks_for(plen, r.max_new_tokens)
                        if need > ledger.capacity_blocks:
                            queue.popleft()
                            reject(r, f"request needs {need} KV blocks but "
                                      f"the paged pool holds "
                                      f"{ledger.capacity_blocks}")
                            continue
                        # Shared blocks stay off the free list: admission
                        # needs only the tail's.
                        plan = ledger.plan_prefix(r.prompt, total_len=flen)
                        if not ledger.can_admit(need - plan.use):
                            # Head-of-line wait until a slot frees blocks
                            # (FIFO; the whole pool covers any admissible
                            # request, so this cannot livelock).
                            break
                    queue.popleft()
                    carried_map.pop(r.id, None)
                    slot_i = slots.index(None)
                    tel.emit("request_start", id=r.id, prompt_len=plen,
                             bucket=bucket, slot=slot_i)
                    # The prefill runs over prompt ‖ carried: a resumed
                    # request continues where its journal stopped.
                    padded = np.zeros((1, bucket), np.int32)
                    padded[0, :plen] = np.asarray(r.prompt, np.int32)
                    if prior:
                        padded[0, plen:flen] = np.asarray(prior, np.int32)
                    digests = (prefix_digests(r.prompt, ledger.block)
                               if ledger is not None and ledger.prefix_cache
                               else [])
                    sargs = ((np.int32(plen), np.int32(r.id))
                             if self.sample is not None else ())
                    t0 = time.perf_counter()
                    if plan is not None and plan.full_hit:
                        # No prefill at all: every block resident and the
                        # first token memoized.
                        tok0, ok, rows, pf_s = plan.tok0, True, None, 0.0
                        prefix_hits += 1
                        full_hits += 1
                        prefill_tokens_saved += plan.offset
                        tel.emit("prefix_hit", id=r.id, blocks=plan.use,
                                 full=True, tokens_saved=plan.offset)
                    elif plan is not None and plan.use > 0:
                        # Partial hit: gather the shared span, compute the
                        # tail.
                        pf = ex.build_prefill_from(bucket, plan.offset,
                                                   sample=self.sample)
                        tel.program_cost(
                            "prefill", pf, flops=lambda: ex.program_flops(
                                bucket - plan.offset), bucket=bucket)
                        rows, tok0, okf = pf(
                            self.params, self.op_state, caches,
                            np.asarray(plan.shared, np.int32), padded,
                            np.int32(flen), *sargs)
                        tok0, ok = (int(x) for x in
                                    _fenced(tel, "prefill", tok0, okf))
                        pf_s = time.perf_counter() - t0
                        prefills += 1
                        prefix_hits += 1
                        prefill_tokens_saved += plan.offset
                        tel.emit("prefill", id=r.id, bucket=bucket,
                                 offset=plan.offset, wall_s=round(pf_s, 6))
                        tel.emit("prefix_hit", id=r.id, blocks=plan.use,
                                 full=False, tokens_saved=plan.offset)
                        if plan.cow:
                            kv_cows += plan.cow
                            tel.emit("kv_cow", id=r.id, blocks=plan.cow)
                    else:
                        # A sampled run prefills through the sampled
                        # first token, so a resumed position replays the
                        # decode's keyed draw (greedy when flen == plen).
                        pf = ex.build_prefill(bucket, sample=self.sample)
                        tel.program_cost(
                            "prefill", pf, bucket=bucket,
                            flops=lambda: ex.program_flops(bucket))
                        rows, tok0, okf = pf(self.params, self.op_state,
                                             padded, np.int32(flen), *sargs)
                        tok0, ok = (int(x) for x in
                                    _fenced(tel, "prefill", tok0, okf))
                        pf_s = time.perf_counter() - t0
                        prefills += 1
                        tel.emit("prefill", id=r.id, bucket=bucket,
                                 wall_s=round(pf_s, 6))
                    if jr is not None:
                        jr.admit(r.id, plen, int(tok0) if ok else None,
                                 resumed=len(prior))
                    if not ok:
                        slots[slot_i] = _Slot(r, flen, 0, [], t_run0, pf_s,
                                              carried=list(prior))
                        finish(slot_i, error="non-finite logits in prefill")
                        continue
                    if ledger is not None:
                        row = ledger.alloc(slot_i, need, shared=plan.shared)
                        block_table[slot_i] = row
                        if rows is not None:
                            # Masked install: the shared entries write
                            # their zero chunks into scratch block 0, never
                            # into the donor's blocks; the table keeps the
                            # shared ids.
                            masked = row.copy()
                            masked[: plan.use] = 0
                            ex.install_paged(caches, rows, masked)
                        if digests:
                            # Index only after the readback validated the
                            # install; memoize the first token of a fresh,
                            # block-aligned prompt (a later full hit).
                            ledger.register_prefix(slot_i, digests,
                                                   start=plan.use)
                            if flen == plen and plen % ledger.block == 0 \
                                    and not plan.full_hit:
                                ledger.record_next(digests[-1], int(tok0))
                    else:
                        ex.install(caches, rows, slot_i)
                    if spec_d:
                        dpf = ex.build_draft_prefill(bucket)
                        tel.program_cost(
                            "draft_prefill", dpf, bucket=bucket,
                            flops=lambda: ex.program_flops(bucket))
                        drows = dpf(self.draft_params, self.op_state, padded)
                        ex.install(dcaches, drows, slot_i)
                        draft_prefills += 1
                    sl = _Slot(request=r, pos=flen, last_tok=int(tok0),
                               tokens=[int(tok0)], t_eligible=t_run0,
                               prefill_s=pf_s, carried=list(prior))
                    total_tokens += 1
                    slots[slot_i] = sl
                    if slot_done(sl):
                        finish(slot_i)

                active = [i for i, sl in enumerate(slots) if sl is not None]
                if not active:
                    break

                # -- faults, then one decode superstep (or round) --
                if self.injector is not None:
                    try:
                        caches, _nan = self.injector.before_superstep(
                            superstep_idx, caches, block_table,
                            slot_row=ex.slot_row)
                    except ServingFault as f:
                        superstep_idx += 1
                        if slots[f.slot] is not None:
                            finish(f.slot, error=f"raised fault: {f}")
                        continue
                with torch.inference_mode():
                    dev["pos"].copy_(torch.from_numpy(np.array(
                        [sl.pos if sl else 0 for sl in slots], np.int32)))
                    dev["tok"].copy_(torch.from_numpy(np.array(
                        [sl.last_tok if sl else 0 for sl in slots],
                        np.int32)))
                    args = ()
                    if block_table is not None:
                        dev["bt"].copy_(torch.from_numpy(block_table))
                        args += (dev["bt"],)
                    args += (dev["pos"], dev["tok"])
                    if self.sample is not None:
                        dev["req"].copy_(torch.from_numpy(np.array(
                            [sl.request.id if sl else 0 for sl in slots],
                            np.int32)))
                        args += (dev["req"],)
                t_call = time.perf_counter()
                if spec_d:
                    tel.program_cost("spec_verify", step_fn,
                                     flops=lambda: ex.program_flops(
                                         2 * (spec_d + 1) * B), d=spec_d)
                    *_s, (toks, oks, acc) = step_fn(
                        self.params, self.draft_params, self.op_state,
                        caches, dcaches, *args)
                    host_toks, host_oks, host_acc = _fenced(
                        tel, "spec_verify", toks, oks, acc)
                    k_eff = spec_d + 1
                else:
                    tel.program_cost(
                        "decode_superstep", step_fn, k=k,
                        flops=lambda: ex.program_flops(k * B))
                    *_s, (toks, oks) = step_fn(self.params, self.op_state,
                                               caches, *args)
                    host_toks, host_oks = _fenced(tel, "decode_superstep",
                                                  toks, oks)
                    k_eff = k
                wall = time.perf_counter() - t_call
                decode_s += wall
                supersteps += 1
                superstep_idx += 1
                # One host program (a graph replay on CUDA) and one fence
                # covered k_eff decode steps.
                tel.add_programs(1, steps=k_eff)
                # The batch's occupancy by request id, before finish()
                # frees slots: the span layer's decode attribution.
                occ = [slots[i].request.id for i in active]
                if not spec_d:
                    tel.emit("decode_superstep", k=k, active=len(active),
                             slots=occ, wall_s=round(wall, 6))
                for j in range(k_eff):
                    tel.record_step((supersteps - 1) * k_eff + j,
                                    wall_s=wall / k_eff)
                emitted_round = 0
                for i in active:
                    sl = slots[i]
                    err = None
                    appended: List[int] = []
                    if spec_d:
                        n_take = int(host_acc[i]) + 1
                        spec_accept_total += int(host_acc[i])
                    else:
                        n_take = k
                    for j in range(n_take):
                        if not host_oks[j, i]:
                            err = "non-finite logits in decode"
                            break
                        sl.tokens.append(int(host_toks[j, i]))
                        appended.append(int(host_toks[j, i]))
                        sl.pos += 1
                        total_tokens += 1
                        decode_tokens += 1
                        if slot_done(sl):
                            break
                    sl.last_tok = sl.tokens[-1] if sl.tokens else 0
                    emitted_round += len(appended)
                    # The validated delta goes to the journal before any
                    # done record (under speculation: accepted tokens
                    # only, so a resume is the same as plain decode's).
                    if jr is not None and appended:
                        jr.tokens(sl.request.id, appended)
                    if err is not None:
                        finish(i, error=err)
                    elif slot_done(sl):
                        finish(i)
                if spec_d:
                    spec_draft_total += spec_d * len(active)
                    tel.emit("spec_verify", d=spec_d, active=len(active),
                             accepted=int(sum(int(host_acc[i])
                                              for i in active)),
                             draft=spec_d * len(active),
                             emitted=emitted_round, slots=occ,
                             wall_s=round(wall, 6))
        finally:
            preempt.__exit__(None, None, None)
            if jr is not None:
                jr.close()

        elapsed = time.perf_counter() - t_run0
        lats = sorted(r.latency_s for r in results.values() if r.error is None)

        def pct(p: float) -> float:
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(round(p * (len(lats) - 1))))]

        stats = {
            "requests": len(results),
            "completed": sum(1 for r in results.values() if r.error is None),
            "failed": sum(1 for r in results.values() if r.error),
            "tokens": total_tokens,
            "decode_tokens": decode_tokens,
            "elapsed_s": elapsed,
            "tokens_per_s": total_tokens / max(elapsed, 1e-9),
            "decode_supersteps": supersteps,
            "decode_steps_per_call": k,
            "decode_s": decode_s,
            "prefills": prefills,
            "request_latency_ms_p50": round(pct(0.50) * 1e3, 3),
            "request_latency_ms_p95": round(pct(0.95) * 1e3, 3),
            # One host program per superstep: a graph replay on CUDA.
            "programs_per_decode_superstep": 1,
            "kv_layout": "paged" if ex.paged else "padded",
            "shard": list(ex.shard) if ex.shard is not None else None,
            "sampled": self.sample is not None,
        }
        if ex.paged:
            stats["kv_block"] = ex.kv_block
            stats["kv_blocks"] = ex.kv_blocks
        if ex.prefix_cache:
            stats["prefix_cache"] = True
            stats["prefix_hits"] = prefix_hits
            stats["prefix_hit_rate"] = round(
                prefix_hits / max(prefills + full_hits, 1), 4)
            stats["prefill_tokens_saved"] = prefill_tokens_saved
            stats["kv_cows"] = kv_cows
            if prefix_hits:
                # The reader's reconstruct_summary recomputes both from
                # the prefill and prefix_hit events.
                tel.note_summary(prefix_hit_rate=stats["prefix_hit_rate"],
                                 prefill_tokens_saved=prefill_tokens_saved)
        if spec_d:
            stats["speculate"] = spec_d
            stats["draft_layers"] = ex.draft_layers
            stats["draft_prefills"] = draft_prefills
            stats["spec_acceptance_rate"] = round(
                spec_accept_total / max(spec_draft_total, 1), 4)
            stats["spec_tokens_per_dispatch"] = round(
                decode_tokens / max(supersteps, 1), 3)
            tel.note_summary(
                spec_acceptance_rate=stats["spec_acceptance_rate"],
                spec_tokens_per_dispatch=stats["spec_tokens_per_dispatch"])
        if self.drain_on_preempt:
            stats["drained"] = drained
        return results, tel.fold_stats(stats)


def synthetic_requests(
    n: int,
    vocab: int,
    prompt_len: Tuple[int, int] = (4, 12),
    max_new_tokens: int = 16,
    seed: int = 0,
) -> List[Request]:
    """Deterministic synthetic closed-loop requests: prompt lengths
    uniform in ``prompt_len`` (inclusive), ids uniform over the vocab —
    numpy's ``default_rng``, so the JAX package draws the same prompts
    from the same seed."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    out = []
    for i in range(n):
        plen = int(rng.integers(lo, hi + 1))
        out.append(Request(
            id=i,
            prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            max_new_tokens=max_new_tokens,
        ))
    return out
