"""Inference serving: ServingExecutor and the closed-loop Server.

The padded, greedy, single-device core of
``flexflow_tpu/runtime/serving.py``:

- **Prefill** (:meth:`ServingExecutor.build_prefill`, one per pad
  bucket): the full-sequence causal forward over a zero-padded prompt,
  filling per-layer ``(1, max_seq, heads, d_head)`` cache rows and
  returning the greedy first token and a finiteness flag.
- **Decode superstep** (:meth:`ServingExecutor.build_decode_superstep`):
  K single-token steps over the whole slot batch as a Python loop under
  ``torch.inference_mode()``, token selection on the device, and ONE
  host readback of the ``(K, B)`` tokens and finiteness flags per
  superstep (the Server's :func:`_readback`).
- **Server.run**: FIFO admission into ``max_batch`` slots between
  supersteps (prefill + install), one fused decode superstep over the
  batch, per-slot consumption with the EOS, budget and context limits,
  eviction, and the stats block.

Left for later slices (ROADMAP.md queue 1): paged KV and the prefix
cache, speculation, sampling, sharded decode, the scheduler and fleet,
the journal, fault injection, telemetry and checkpoint restore.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.ops.attention import MultiHeadAttention, PositionEmbedding
from flexflow_torch.runtime.executor import Executor, resolve_device
from flexflow_torch.runtime.trainer import relay_safe_steps

_log = logging.getLogger("ff.serving")


@dataclasses.dataclass
class Request:
    """One generation request (closed loop: eligible at run start)."""

    id: int
    prompt: np.ndarray  # 1-D int32 token ids
    max_new_tokens: int = 16


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
    tokens: List[int]        # tokens generated so far
    t_eligible: float
    prefill_s: float


def _readback(*tensors: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of same-shaped int/bool tensors, stacked
    as int32 — the fence that ends a prefill or a decode superstep."""
    return torch.stack([t.to(torch.int32) for t in tensors]).cpu().numpy()


class ServingExecutor:
    """Forward-only serving programs for an FFModel transformer LM
    (padded cache layout, greedy decoding, one device)."""

    def __init__(
        self,
        model: FFModel,
        config: Optional[FFConfig] = None,
        max_batch: int = 4,
        max_seq: Optional[int] = None,
        buckets: Optional[Sequence[int]] = None,
        decode_kernel: Optional[bool] = None,
        device=None,
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
        self._prefill_fns: Dict[int, Any] = {}
        self._decode_fns: Dict[Tuple, Any] = {}

    def init(self, seed: Optional[int] = None):
        """Fresh ``(params, op_state)`` on the serving device."""
        params = Executor(self.model, config=self.config,
                          device=self.device).init(seed)
        return params, {}

    # -- caches -------------------------------------------------------------

    def _zeros_cache(self, batch: int):
        S = self.max_seq
        return {
            name: {
                "k": torch.zeros((batch, S, h, hd), dtype=dt, device=self.device),
                "v": torch.zeros((batch, S, h, hd), dtype=dt, device=self.device),
            }
            for name, (h, hd, dt) in self._cache_specs.items()
        }

    @torch.inference_mode()
    def init_cache(self):
        """Per-layer ``{op: {"k"/"v": (max_batch, max_seq, heads,
        d_head)}}`` caches, zeroed."""
        return self._zeros_cache(self.max_batch)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest pad bucket "
            f"{self.buckets[-1]} (max_seq={self.max_seq})"
        )

    # -- the forward walk ---------------------------------------------------

    def _forward(self, params, op_state, tokens, caches, pos):
        """Forward over the non-loss graph in inference mode: attention
        ops get their caches and ``pos`` through ``state`` (the
        ``ops/attention.py`` KV-cache protocol), position embeddings get
        ``pos``; every other op runs its eval forward.  Returns
        ``(logits, caches)``."""
        env: Dict[str, Any] = {self._tokens_name: tokens}
        new_caches: Dict[str, Any] = {}
        for op in self._layers:
            if isinstance(op, MultiHeadAttention):
                op.decode_kernel = self.decode_kernel
            xs = [env[t.name] for t in op.inputs]
            s = dict(op_state.get(op.name, {}))
            if op.name in caches:
                s["cache_k"] = caches[op.name]["k"]
                s["cache_v"] = caches[op.name]["v"]
                s["pos"] = pos
            elif isinstance(op, PositionEmbedding):
                s["pos"] = pos
            ys, s_new = op.forward(params.get(op.name, {}), xs, s,
                                   training=False)
            if op.name in caches:
                new_caches[op.name] = {"k": s_new["cache_k"],
                                       "v": s_new["cache_v"]}
            for t, y in zip(op.outputs, ys):
                env[t.name] = y
        return env[self._logits_name], new_caches

    # -- programs -----------------------------------------------------------

    def build_prefill(self, bucket: int):
        """The prefill program for one pad bucket: ``(params, op_state,
        tokens (1, bucket), length) -> (cache_rows, first_token,
        finite)``.  ``cache_rows`` are ``(max_seq, h, hd)`` per layer
        (rows past ``bucket`` zero), ready for :meth:`install`;
        ``first_token`` is the greedy argmax of the logits at
        ``length - 1``; both it and ``finite`` stay on the device."""
        fn = self._prefill_fns.get(bucket)
        if fn is not None:
            return fn

        @torch.inference_mode()
        def prefill(params, op_state, tokens, length):
            tokens = torch.as_tensor(np.asarray(tokens), device=self.device)
            if tuple(tokens.shape) != (1, bucket):
                raise ValueError(f"prefill bucket {bucket} takes (1, "
                                 f"{bucket}) tokens, got {tuple(tokens.shape)}")
            caches = self._zeros_cache(1)
            pos = torch.zeros((1,), dtype=torch.int32, device=self.device)
            logits, caches = self._forward(params, op_state,
                                           tokens.to(torch.int32), caches, pos)
            last = logits[0, int(length) - 1]
            tok = torch.argmax(last, dim=-1).to(torch.int32)
            ok = torch.isfinite(last.float()).all()
            rows = {name: {"k": c["k"][0], "v": c["v"][0]}
                    for name, c in caches.items()}
            return rows, tok, ok

        self._prefill_fns[bucket] = prefill
        return prefill

    @torch.inference_mode()
    def install(self, caches, rows, slot: int):
        """Copy a prefilled cache row into ``slot`` of every layer's K
        and V, in place; returns ``caches``."""
        for name, r in rows.items():
            caches[name]["k"][slot].copy_(r["k"])
            caches[name]["v"][slot].copy_(r["v"])
        return caches

    def build_decode_superstep(self, k: int, return_logits: bool = False):
        """K single-token decode steps over the whole slot batch:
        ``(params, op_state, caches, pos (B,), tok (B,)) -> (caches, pos,
        tok, (tokens (K, B), finite (K, B)))``, with greedy selection on
        the device and nothing read back inside.  Each step writes its
        K/V at ``pos`` and advances ``pos = min(pos + 1, max_seq - 1)``.
        ``return_logits`` also stacks the ``(K, B, V)`` logits (tests)."""
        if k < 1:
            raise ValueError(f"decode steps per call must be >= 1, got {k}")
        key = (k, return_logits)
        fn = self._decode_fns.get(key)
        if fn is not None:
            return fn
        S = self.max_seq

        @torch.inference_mode()
        def superstep(params, op_state, caches, pos, tok):
            pos = torch.as_tensor(np.asarray(pos), dtype=torch.int32,
                                  device=self.device)
            tok = torch.as_tensor(np.asarray(tok), dtype=torch.int32,
                                  device=self.device)
            toks, oks, lgs = [], [], []
            for _ in range(k):
                logits, caches = self._forward(params, op_state, tok[:, None],
                                               caches, pos)
                logits = logits[:, 0]                            # (B, V)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(tok)
                oks.append(torch.isfinite(logits.float()).all(dim=-1))
                if return_logits:
                    lgs.append(logits)
                pos = torch.clamp(pos + 1, max=S - 1)
            outs = (torch.stack(toks), torch.stack(oks))
            if return_logits:
                outs += (torch.stack(lgs),)
            return caches, pos, tok, outs

        self._decode_fns[key] = superstep
        return superstep


class Server:
    """Closed-loop FIFO serving over a :class:`ServingExecutor`.

    ``run(requests)`` admits requests into free slots (prefill + cache
    install), runs one fused K-token decode superstep over the batch,
    consumes the read-back tokens per slot (EOS / budget / context
    limits), evicts finished slots, and repeats.  Returns ``(results,
    stats)``."""

    def __init__(self, executor: ServingExecutor, params, op_state,
                 decode_steps: int = 8, eos_id: Optional[int] = None):
        self.ex = executor
        self.params = params
        self.op_state = op_state
        self.decode_steps = relay_safe_steps(decode_steps,
                                             what="decode_steps", log=_log)
        self.eos_id = eos_id

    def run(self, requests: Sequence[Request]):
        ex = self.ex
        B, k = ex.max_batch, self.decode_steps
        decode_fn = ex.build_decode_superstep(k)
        caches = ex.init_cache()
        slots: List[Optional[_Slot]] = [None] * B
        queue = collections.deque(requests)
        results: Dict[int, RequestResult] = {}
        total_tokens = 0
        decode_tokens = 0
        supersteps = 0
        prefills = 0
        decode_s = 0.0
        t_run0 = time.perf_counter()

        def finish(slot_i: int, error: Optional[str] = None):
            sl = slots[slot_i]
            results[sl.request.id] = RequestResult(
                id=sl.request.id, prompt_len=len(sl.request.prompt),
                tokens=list(sl.tokens), error=error,
                latency_s=time.perf_counter() - sl.t_eligible,
                prefill_s=sl.prefill_s,
            )
            slots[slot_i] = None

        def slot_done(sl: _Slot) -> bool:
            if self.eos_id is not None and sl.tokens and \
                    sl.tokens[-1] == self.eos_id:
                return True
            if len(sl.tokens) >= sl.request.max_new_tokens:
                return True
            return sl.pos >= ex.max_seq  # context limit

        while queue or any(slots):
            # -- admissions (between decode supersteps) --
            while queue and None in slots:
                r = queue.popleft()
                plen = len(r.prompt)
                try:
                    bucket = ex.bucket_for(plen)
                except ValueError as e:
                    results[r.id] = RequestResult(
                        id=r.id, prompt_len=plen, tokens=[], error=str(e),
                        latency_s=time.perf_counter() - t_run0,
                    )
                    continue
                slot_i = slots.index(None)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :plen] = np.asarray(r.prompt, np.int32)
                t0 = time.perf_counter()
                rows, tok0, okf = ex.build_prefill(bucket)(
                    self.params, self.op_state, padded, np.int32(plen))
                tok0, ok = (int(x) for x in _readback(tok0, okf))
                pf_s = time.perf_counter() - t0
                prefills += 1
                if not ok:
                    slots[slot_i] = _Slot(r, plen, 0, [], t_run0, pf_s)
                    finish(slot_i, error="non-finite logits in prefill")
                    continue
                caches = ex.install(caches, rows, slot_i)
                sl = _Slot(request=r, pos=plen, last_tok=tok0, tokens=[tok0],
                           t_eligible=t_run0, prefill_s=pf_s)
                total_tokens += 1
                slots[slot_i] = sl
                if slot_done(sl):
                    finish(slot_i)

            active = [i for i, sl in enumerate(slots) if sl is not None]
            if not active:
                break

            # -- one fused decode superstep over the whole batch --
            pos_vec = np.array([sl.pos if sl else 0 for sl in slots], np.int32)
            tok_vec = np.array([sl.last_tok if sl else 0 for sl in slots],
                               np.int32)
            t_call = time.perf_counter()
            caches, _pos, _tok, (toks, oks) = decode_fn(
                self.params, self.op_state, caches, pos_vec, tok_vec)
            host_toks, host_oks = _readback(toks, oks)
            decode_s += time.perf_counter() - t_call
            supersteps += 1
            for i in active:
                sl = slots[i]
                err = None
                for j in range(k):
                    if not host_oks[j, i]:
                        err = "non-finite logits in decode"
                        break
                    sl.tokens.append(int(host_toks[j, i]))
                    sl.pos += 1
                    total_tokens += 1
                    decode_tokens += 1
                    if slot_done(sl):
                        break
                sl.last_tok = sl.tokens[-1] if sl.tokens else 0
                if err is not None:
                    finish(i, error=err)
                elif slot_done(sl):
                    finish(i)

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
            "programs_per_decode_superstep": 1,
            "kv_layout": "padded",
            "shard": None,
            "sampled": False,
        }
        return results, stats


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
