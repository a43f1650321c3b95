"""Attention operators: the single-device path of
``flexflow_tpu/ops/attention.py``.

``LayerNorm``, ``PositionEmbedding`` and ``MultiHeadAttention`` with its
dense forward and the padded KV-cache protocol (prefill and decode).
Dense attention always runs the port's flash kernel
(``kernels.flash_attention_lse``); cached decode runs the flash-decode
kernel (``kernels.flash_decode``) unless ``decode_kernel`` is False,
which selects the plain ``_einsum_decode``.  On CPU tensors both kernel
wrappers run their plain versions.  The ring (sequence-parallel), paged
and prefix-offset paths come with later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from flexflow_torch.initializers import GlorotUniform, OnesInitializer, ZeroInitializer
from flexflow_torch.ops import kernels
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec

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
    """Layer normalization over the last (feature) dim, in f32."""

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

    def forward(self, params, xs, state, training):
        (x,) = xs
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)  # biased
        y = (xf - mean) * torch.rsqrt(var + self.attrs["eps"])
        y = y * params["scale"].float() + params["bias"].float()
        return [y.to(x.dtype)], state


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
            # declared sequence (pad-to-bucket), so it slices.
            if x.shape[1] == 1:
                return [x + table[state["pos"].long()][:, None]], state
            return [x + table[None, : x.shape[1]]], state
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

    def _split_heads(self, x):
        """(b, t, d) -> (b, h, t, hd), keeping the compute dtype."""
        b, t, d = x.shape
        h = self.attrs["num_heads"]
        return x.reshape(b, t, h, d // h).transpose(1, 2)

    def _merge_heads(self, x, dtype):
        b, h, t, hd = x.shape
        return x.transpose(1, 2).reshape(b, t, h * hd).to(dtype)

    def _attend_dense(self, q, k, v, dtype):
        q, k, v = map(self._split_heads, (q, k, v))
        out, _lse = kernels.flash_attention_lse(q, k, v, self.attrs["causal"])
        return self._merge_heads(out, dtype)

    def _out_proj(self, params, y):
        y = y @ params["wo"]
        if self.attrs["use_bias"]:
            y = y + params["bo"]
        return y

    def forward(self, params, xs, state, training):
        (x,) = xs
        if "cache_k" in state:
            return self._forward_cached(params, x, state)
        q, k, v = self._project(params, x)
        y = self._attend_dense(q, k, v, x.dtype)
        return [self._out_proj(params, y)], state

    # -- padded KV-cache protocol (runtime/serving.py) ----------------------
    #
    # ``state`` carries ``cache_k``/``cache_v`` (B, max_seq, heads, d_head)
    # and the per-slot position vector ``pos`` (B,) int32.  Prefill
    # (t > 1) runs the dense causal forward and writes this call's K/V
    # into cache rows 0..t-1; decode (t == 1) writes the token's K/V at
    # ``cache[b, pos[b]]`` and then attends key positions ``<= pos``
    # (``lengths = pos + 1``).  The caches are updated IN PLACE (the JAX
    # package returns new arrays): serving owns them, and a copy of every
    # layer's cache per token would double the decode step's HBM traffic.

    def _forward_cached(self, params, x, state):
        ck, cv = state["cache_k"], state["cache_v"]
        q, k, v = self._project(params, x)
        qh, kh, vh = map(self._split_heads, (q, k, v))   # (B, h, t, hd)
        b, h, t, hd = qh.shape
        if t == 1:
            pos = state["pos"]
            rows = torch.arange(b, device=x.device)
            ck[rows, pos.long()] = kh[:, :, 0].to(ck.dtype)
            cv[rows, pos.long()] = vh[:, :, 0].to(cv.dtype)
            out = self._decode_attend(qh[:, :, 0], ck, cv, pos)
            y = self._merge_heads(out[:, :, None], x.dtype)
        else:
            ck[:, :t] = kh.transpose(1, 2).to(ck.dtype)
            cv[:, :t] = vh.transpose(1, 2).to(cv.dtype)
            y = self._attend_dense(q, k, v, x.dtype)
        new_state = dict(state)
        new_state["cache_k"] = ck
        new_state["cache_v"] = cv
        return [self._out_proj(params, y)], new_state

    def _decode_attend(self, q1, ck, cv, pos):
        """``q1``: (B, h, hd).  The flash-decode kernel, or the plain
        ``_einsum_decode`` when ``decode_kernel`` is False."""
        if self.decode_kernel is False:
            return _einsum_decode(q1, ck, cv, pos)
        return kernels.flash_decode(q1, ck, cv, (pos + 1).to(torch.int32))
