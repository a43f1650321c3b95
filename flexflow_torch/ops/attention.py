"""Attention operators: the port of ``flexflow_tpu/ops/attention.py``
(its ring path aside).

``LayerNorm``, ``PositionEmbedding`` and ``MultiHeadAttention`` with its
dense forward and the padded KV-cache protocol (prefill and decode).
Dense attention (training, and the serving prefill) goes through
``kernels.flash_attention_lse_auto``, as JAX's ``_flash_dense`` does: K1f
forward and K1b backward for every head dim they take, the streamed K1s
and K1sb under ``FF_FLASH_STREAMED=1``, the plain blocked form at
``t >= 4096`` for other head dims, and the einsum when it returns None.
Cached decode on the padded cache takes JAX's route: the flash-decode
kernel (``kernels.flash_decode``) where its gate
(``kernels.flash_decode_supported``) holds, the plain ``_einsum_decode``
where it does not or when ``decode_kernel`` is False.
The paged decode (a block pool and a per-slot block table) runs plain
torch, as the JAX package runs jnp there.  The offset prefill of a
shared prefix attends on the route of a fresh prefill of its bucket
(``_attend_offset``: the dispatcher, so K1f on the card), where JAX runs
the jnp ``_attend_chunk``: on the card, two routes for one bucket would
round a bf16 sharer's tokens apart from its unshared run's.  On CPU tensors both
kernel wrappers run their plain versions.

Under a mesh the dense route runs the dispatcher, and with it K1f and
K1b, on the rank's local ``(b/n, h/c, t, hd)`` heads, as JAX's
``shard_map`` does (``attention.py:507-528``): ``n`` splits the batch,
``c`` the heads (the projections' columns, ``wo``'s rows), the input
enters through ``copy_to`` and the row-parallel output is all-reduced
over ``c``.  Where the heads do not split over ``c`` the op gathers its
projections and runs every head on each rank, as JAX returns to the
unsharded route.  ``s > 1`` (ring attention) is ROADMAP.md item 9d.
``LayerNorm`` reads its feature dim whole and stays local.

The KV-cache protocol runs on a rank's share too, bound by the serving
shard (``runtime/serving.py``, ``ServingExecutor(shard=(n, c))``): the
parameters are whole on every rank and the op cuts its ``h/c`` heads
from them (``_serving_heads``: the columns of ``wq``/``wk``/``wv``, the
rows of ``wo``), projects, writes and attends its local cache block
(padded ``(B/n, S, h/c, hd)``, so K6 runs at the local shape, or the
pool ``(NB, bs, h/c, hd)``) and all-reduces the row-parallel output over
``c``; a prefill attends its ``h/c`` heads through the dispatcher (K1f
on the card).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from flexflow_torch.initializers import GlorotUniform, OnesInitializer, ZeroInitializer
from flexflow_torch.ops import kernels
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.parallel import collectives

_NEG_INF = -1e30


def _einsum_decode(q, cache_k, cache_v, pos):
    """Dense reference decode attention: one query per (batch, head)
    against a (B, max_seq, h, hd) KV cache, f32 scores, masked to key
    positions ``<= pos`` (the query's own K/V are already in the
    cache).  ``q``: (B, h, hd); ``pos``: (B,) int.  The plain decode
    that ``decode_kernel=False`` selects."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhd,bshd->bhs", q.float(), cache_k.float()) * scale
    keys = torch.arange(cache_k.shape[1], device=q.device)
    mask = keys[None, :] <= pos.to(q.device)[:, None]            # (B, S)
    scores = torch.where(mask[:, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", attn, cache_v.float()).to(dtype)


def _einsum_attention(q, k, v, causal: bool):
    """Dense reference attention on (b, h, t, hd) heads, f32 scores;
    returns the input dtype."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t = scores.shape[-1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v).to(dtype)


class LayerNorm(Op):
    """Layer normalization over the last (feature) dim, in f32.

    The reference computes ``((x - mean) * rsqrt(var + eps)) * scale +
    bias`` in f32 (biased variance) and rounds once to the input dtype.
    ``F.layer_norm`` computes the same in f32 for f32 and bf16 inputs and
    keeps only the input and per-row statistics for its backward, where
    the op written out would keep several f32 copies of the activation
    per layer."""

    def __init__(self, name: str, x: TensorSpec, eps: float = 1e-5):
        super().__init__(name, [x])
        self.attrs = dict(eps=eps)
        self._make_output(x.shape, x.dtype, x.dim_axes)

    def param_specs(self) -> Dict[str, ParamSpec]:
        d = self.inputs[0].shape[-1]
        dt = self.outputs[0].dtype
        return {
            "scale": ParamSpec((d,), dt, OnesInitializer()),
            "bias": ParamSpec((d,), dt, ZeroInitializer()),
        }

    def input_spec(self, i, frm):
        x = self.inputs[0]
        return self._spec(x.dim_axes[:-1] + (None,), x.shape)

    def output_spec(self, j):
        return self.input_spec(0, None)

    def forward(self, params, xs, state, training):
        (x,) = xs
        y = F.layer_norm(x, (x.shape[-1],), params["scale"].to(x.dtype),
                         params["bias"].to(x.dtype), self.attrs["eps"])
        return [y], state


class PositionEmbedding(Op):
    """Adds a learned (seq, dim) position table to (batch, seq, dim)."""

    def __init__(self, name: str, x: TensorSpec, initializer=None):
        super().__init__(name, [x])
        if x.ndim != 3:
            raise ValueError(f"{name}: input must be (batch, seq, dim), got "
                             f"{x.shape}")
        self.initializer = initializer or GlorotUniform()
        self._make_output(x.shape, x.dtype, x.dim_axes)

    def param_specs(self) -> Dict[str, ParamSpec]:
        _, t, d = self.inputs[0].shape
        return {"table": ParamSpec((t, d), self.outputs[0].dtype,
                                   self.initializer, ("s", None))}

    def forward(self, params, xs, state, training):
        (x,) = xs
        table = params["table"]
        if "pos" in state:
            # Serving: ``pos`` is each slot's position of this call's
            # first token.  Decode (t == 1) gathers one row per slot;
            # prefill starts every slot at 0 and may be shorter than the
            # declared sequence (pad-to-bucket), so it slices.  The
            # offset prefill of a shared prefix starts at row ``chunk``.
            if x.shape[1] == 1:
                return [x + table[state["pos"].long()][:, None]], state
            start = int(state.get("chunk", 0))
            return [x + table[None, start:start + x.shape[1]]], state
        return [x + table[None]], state


class MultiHeadAttention(Op):
    """Causal (or full) self-attention over (batch, seq, dim).

    ``wq``/``wk``/``wv``/``wo`` are stored ``(in, out)`` and applied as
    ``x @ w`` (the opposite of ``Linear``), as in the JAX package."""

    #: Decode routing, bound by the serving executor: False selects the
    #: plain ``_einsum_decode``; None or True the flash-decode kernel
    #: (its plain version on CPU tensors).
    decode_kernel: Optional[bool] = None

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        num_heads: int,
        causal: bool = True,
        use_bias: bool = True,
        kernel_initializer=None,
    ):
        super().__init__(name, [x])
        if x.ndim != 3:
            raise ValueError(f"attention input must be (batch, seq, dim), "
                             f"got {x.shape}")
        d = x.shape[-1]
        if d % num_heads:
            raise ValueError(f"{name}: d_model {d} not divisible by "
                             f"{num_heads} heads")
        self.attrs = dict(num_heads=num_heads, causal=causal, use_bias=use_bias)
        self.kernel_initializer = kernel_initializer or GlorotUniform()
        self._make_output(x.shape, x.dtype, x.dim_axes)

    def param_specs(self) -> Dict[str, ParamSpec]:
        d = self.inputs[0].shape[-1]
        dt = self.outputs[0].dtype
        ki = self.kernel_initializer
        specs = {
            "wq": ParamSpec((d, d), dt, ki, (None, "c")),
            "wk": ParamSpec((d, d), dt, ki, (None, "c")),
            "wv": ParamSpec((d, d), dt, ki, (None, "c")),
            "wo": ParamSpec((d, d), dt, ki, ("c", None)),
        }
        if self.attrs["use_bias"]:
            for b in ("bq", "bk", "bv"):
                specs[b] = ParamSpec((d,), dt, ZeroInitializer(), ("c",))
            specs["bo"] = ParamSpec((d,), dt, ZeroInitializer())
        return specs

    # -- helpers -----------------------------------------------------------

    def _project(self, params, x):
        """One fused (d, 3d) QKV product over the concatenated weights
        (each output column contracts only its own weight column, so
        this equals three separate products)."""
        w = torch.cat([params["wq"], params["wk"], params["wv"]], dim=1)
        qkv = x @ w
        if self.attrs["use_bias"]:
            qkv = qkv + torch.cat([params["bq"], params["bk"], params["bv"]])
        return qkv.chunk(3, dim=-1)

    def _split_heads(self, x, heads: Optional[int] = None):
        """(b, t, d) -> (b, h, t, hd), keeping the compute dtype; ``heads``
        the rank's heads under a ``c`` split (default all)."""
        b, t, d = x.shape
        h = heads or self.attrs["num_heads"]
        return x.reshape(b, t, h, d // h).transpose(1, 2)

    def _merge_heads(self, x, dtype):
        b, h, t, hd = x.shape
        return x.transpose(1, 2).reshape(b, t, h * hd).to(dtype)

    def _attend_heads(self, q, k, v):
        """(b, h, t, hd) heads through the dispatcher's formulation, or the
        einsum when it returns None: the one route of every prefill."""
        causal = self.attrs["causal"]
        res = kernels.flash_attention_lse_auto(q, k, v, causal)
        return _einsum_attention(q, k, v, causal) if res is None else res[0]

    def _attend_dense(self, q, k, v, dtype, heads: Optional[int] = None):
        """JAX's ``_attend_dense`` / ``_flash_dense`` on this rank's
        ``heads``."""
        q, k, v = (self._split_heads(x, heads) for x in (q, k, v))
        return self._merge_heads(self._attend_heads(q, k, v), dtype)

    def _out_proj(self, params, y):
        y = y @ params["wo"]
        if self.attrs["use_bias"]:
            y = y + params["bo"]
        return y

    def input_spec(self, i, frm):
        x = self.inputs[0]
        return self._spec(x.dim_axes[:-1] + (None,), x.shape)

    def output_spec(self, j):
        return self.input_spec(0, None)

    def _mesh_params(self, params, x):
        """``(params, x, c_axes)`` for the rank's heads: the projections
        as held and ``x`` through ``copy_to`` when the heads split over
        ``c``; else the projections gathered whole and ``c_axes`` empty."""
        c = self.param_spec("wq")[1]
        if not c:
            return params, x, ()
        if self.attrs["num_heads"] % self._plan.size(c) == 0:
            return params, collectives.copy_to(x, self._world, c), c
        whole = {k: collectives.gather(v, 1 if k in ("wq", "wk", "wv") else 0,
                                       self._world, self.param_spec(k)[
                                           1 if k in ("wq", "wk", "wv")
                                           else 0])
                 for k, v in params.items()}
        return whole, x, ()

    def forward(self, params, xs, state, training):
        (x,) = xs
        if "cache_k" in state:
            return self._forward_cached(params, x, state)
        c = ()
        if self._world is not None:
            params, x, c = self._mesh_params(params, x)
        q, k, v = self._project(params, x)
        heads = self.attrs["num_heads"] // (self._plan.size(c) if c else 1)
        y = self._attend_dense(q, k, v, x.dtype, heads)
        return [self._row_parallel_out(params, y, c)], state

    def _row_parallel_out(self, params, y, c):
        """The output projection of the rank's heads: their rows of ``wo``,
        the partial products summed over ``c``, then ``bo``; with ``c``
        empty, ``_out_proj``."""
        if not c:
            return self._out_proj(params, y)
        y = collectives.all_reduce(y @ params["wo"], self._world, c)
        if self.attrs["use_bias"]:
            y = y + params["bo"]
        return y

    # -- KV-cache protocol (runtime/serving.py) ------------------------------
    #
    # ``state`` carries ``cache_k``/``cache_v`` and the per-slot position
    # vector ``pos`` (B,) int32.  Padded caches are (B, max_seq, heads,
    # d_head).  Prefill (t > 1) runs the dense causal forward and writes
    # this call's K/V into cache rows 0..t-1; decode (t == 1) writes the
    # token's K/V at ``cache[b, pos[b]]`` and then attends key positions
    # ``<= pos`` (``lengths = pos + 1``).  With ``block_table`` (B, nblk)
    # the caches are a paged pool (kv_blocks, kv_block, heads, d_head):
    # decode scatters into the slot's block at (pos // bs, pos % bs) and
    # attends a transient (B, nblk * bs, ...) gather of the slot's blocks
    # with the plain ``_einsum_decode``, as JAX's jnp does (no kernel).
    # With ``chunk`` (an int) a prefill's t tokens sit at absolute rows
    # [chunk, chunk + t) of a cache whose rows [0, chunk) hold a shared
    # prefix; queries attend [0, chunk + t) under the offset-causal mask.
    #
    # The caches are updated IN PLACE (the JAX package returns new
    # arrays): serving owns them, a copy of every layer's cache per token
    # would double the decode step's HBM traffic, and a CUDA graph of the
    # decode superstep replays onto the same tensors.  Rows past a slot's
    # position (a rejected draft, scratch block 0 of the pool) are never
    # attended: the ``<= pos`` mask hides them until the position walk
    # overwrites them.

    def _serving_heads(self, params):
        """``(params, heads, c_axes)`` of the rank's heads under the
        serving shard, whose parameters are whole on every rank: views of
        the ``h/c`` heads' columns of ``wq``/``wk``/``wv`` and their
        biases and of their rows of ``wo`` (``bo`` whole).  Unbound, or
        with ``c`` = 1, the parameters as they are and ``c_axes`` empty."""
        h = self.attrs["num_heads"]
        if self._world is None:
            return params, h, ()
        c = self._plan.assign(self._pc)["c"]
        parts = self._plan.size(c)
        if parts == 1:
            return params, h, ()
        w = params["wq"].shape[1] // parts
        i = self._world.index(c)
        cols = slice(i * w, (i + 1) * w)
        cut = dict(params)
        for key in ("wq", "wk", "wv"):
            cut[key] = params[key][:, cols]
        for key in ("bq", "bk", "bv", "wo"):
            if key in params:
                cut[key] = params[key][cols]
        return cut, h // parts, c

    def _forward_cached(self, params, x, state):
        ck, cv = state["cache_k"], state["cache_v"]
        params, heads, c = self._serving_heads(params)
        q, k, v = self._project(params, x)
        qh, kh, vh = (self._split_heads(t, heads)
                      for t in (q, k, v))                 # (B, h, t, hd)
        b, h, t, hd = qh.shape
        if t == 1 and "block_table" in state:
            pos = state["pos"].long()
            bt = state["block_table"].long()
            bs = ck.shape[1]
            rows = torch.arange(b, device=x.device)
            dest = bt[rows, pos // bs]
            ck[dest, pos % bs] = kh[:, :, 0].to(ck.dtype)
            cv[dest, pos % bs] = vh[:, :, 0].to(cv.dtype)
            view_k = ck[bt].reshape(b, -1, h, hd)
            view_v = cv[bt].reshape(b, -1, h, hd)
            out = _einsum_decode(qh[:, :, 0], view_k, view_v, state["pos"])
            y = self._merge_heads(out[:, :, None], x.dtype)
        elif t == 1:
            pos = state["pos"]
            rows = torch.arange(b, device=x.device)
            ck[rows, pos.long()] = kh[:, :, 0].to(ck.dtype)
            cv[rows, pos.long()] = vh[:, :, 0].to(cv.dtype)
            out = self._decode_attend(qh[:, :, 0], ck, cv, pos)
            y = self._merge_heads(out[:, :, None], x.dtype)
        elif "chunk" in state:
            o = int(state["chunk"])
            ck[:, o:o + t] = kh.transpose(1, 2).to(ck.dtype)
            cv[:, o:o + t] = vh.transpose(1, 2).to(cv.dtype)
            y = self._attend_offset(qh, ck, cv, o, x.dtype)
        else:
            ck[:, :t] = kh.transpose(1, 2).to(ck.dtype)
            cv[:, :t] = vh.transpose(1, 2).to(cv.dtype)
            y = self._attend_dense(q, k, v, x.dtype, heads)
        new_state = dict(state)
        new_state["cache_k"] = ck
        new_state["cache_v"] = cv
        return [self._row_parallel_out(params, y, c)], new_state

    def _attend_offset(self, qh, ck, cv, offset: int, dtype):
        """Offset-prefill attention on a fresh prefill's route: the ``t``
        queries sit at their absolute rows ``[offset, offset + t)`` of a
        zero query over the span ``offset + t`` (the bucket), against
        cache rows ``[0, offset + t)`` (the shared prefix and this call's
        own writes), through ``_attend_heads`` (K1f on the card).  The
        formulation, the query tiles and the key tiles each row visits
        are then those of a fresh prefill of the same bucket, so the tail
        rows equal that prefill's bit for bit, as long as the cache dtype
        is the compute dtype (the cached K/V rows are then the same bits
        as a fresh projection's).  The zero rows cost one bucket of
        wasted queries and are dropped.  JAX's ``_attend_chunk`` computes
        the same function as an f32 einsum under the offset-causal mask."""
        b, h, t, hd = qh.shape
        span = offset + t
        q = qh.new_zeros((b, h, span, hd))
        q[:, :, offset:] = qh
        k = ck[:, :span].transpose(1, 2).to(qh.dtype)
        v = cv[:, :span].transpose(1, 2).to(qh.dtype)
        out = self._attend_heads(q, k, v)
        return self._merge_heads(out[:, :, offset:], dtype)

    def _decode_attend(self, q1, ck, cv, pos):
        """``q1``: (B, h, hd).  JAX's route: ``decode_kernel`` None takes
        the flash-decode kernel where its gate
        (``kernels.flash_decode_supported``) holds and the plain
        ``_einsum_decode`` where it does not; True always launches the
        kernel (and raises outside the gate on the card); False is the
        einsum."""
        use = self.decode_kernel
        if use is None:
            use = kernels.flash_decode_supported(ck.shape, q1.dtype)
        if not use:
            return _einsum_decode(q1, ck, cv, pos)
        return kernels.flash_decode(q1, ck, cv, (pos + 1).to(torch.int32))
