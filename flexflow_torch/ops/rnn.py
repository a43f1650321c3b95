"""Recurrent operators: the LSTM of ``flexflow_tpu/ops/rnn.py``.

One op spans the whole sequence.  The input projection ``x @ wx + b``
is hoisted out of the recurrence into one ``(batch * t, in) x (in, 4h)``
product; the recurrence keeps only ``h @ wh`` per step, a loop over
``t`` in Python (JAX's ``lax.scan``), gates i, f, g, o.  Both are plain
products that JAX leaves to XLA and no Pallas kernel, so here they go to
``torch.matmul`` (cuBLAS).

Under an ``s`` degree the op is JAX's sequence pipeline
(``rnn.py:139-222``): each rank holds a contiguous chunk of the
sequence, the rank's batch splits into ``M = num_microbatches or S``
microbatches, and in round ``r`` of ``M + S - 1`` rank ``s_idx`` runs
microbatch ``r - s_idx`` when it is in range, from ``(h0, c0)`` on the
first chunk and from the carry its predecessor sent at the end of the
previous round on the others (the chained shift, ``World.shift``).  The
final ``(h, c)`` live on the last chunk's rank and are replicated over
``s`` by an all-reduce of the masked values; ``h0``/``c0`` enter through
``copy_to`` (only the first chunk reads them).  The pipeline is one
``autograd.Function`` (``_Pipeline``): its backward runs the rounds in
reverse, each chunk's gradient from the graph its forward kept and each
round's carry gradient sent back by the reverse shift, so every rank
runs the same shifts in the same order whatever it computes.  At ``s =
1``, as in JAX, ``num_microbatches`` is kept and unused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from flexflow_torch.initializers import GlorotUniform, ZeroInitializer
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.parallel import collectives


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
        s = self.input_spec(0, None)[1] if self._world is not None else ()
        if s and self._plan.size(s) > 1:
            return self._forward_pipelined(params, x, h0, c0, fb, s), state
        (hT, cT), ys = _lstm_chunk(params["wx"], params["wh"], params["bias"],
                                   fb, h0, c0, x)
        return [ys, hT, cT], state

    def _forward_pipelined(self, params, x, h0, c0, fb, s):
        """The sequence pipeline over the ``s`` axes (module docstring):
        ``[y, hT, cT]`` of the rank's chunk and batch, ``hT``/``cT``
        replicated over ``s``."""
        world = self._world
        mb = self.attrs["num_microbatches"] or self._plan.size(s)
        if x.shape[0] % mb:
            raise ValueError(f"{self.name}: per-shard batch {x.shape[0]} not "
                             f"divisible by {mb} microbatches")
        h0, c0 = (collectives.copy_to(v, world, s) for v in (h0, c0))
        args = (x, h0, c0, params["wx"], params["wh"], params["bias"], fb)
        if torch.is_grad_enabled() and any(v.requires_grad for v in args):
            y, hT, cT = _Pipeline.apply(*args, world, s, mb)
        else:
            y, hT, cT, _ = _pipeline(*args, world, s, mb, keep=False)
        return [y, collectives.all_reduce(hT, world, s),
                collectives.all_reduce(cT, world, s)]


def _carry_in(first: bool, h0, c0, carry):
    """A chunk's initial ``(h, c)``: the op's initial state on the first
    chunk, the predecessor's carry on the others."""
    return (h0, c0) if first else carry


def _pipeline(x, h0, c0, wx, wh, b, fb, world, s, mb, keep: bool):
    """The pipeline's forward rounds on this rank: ``(y, hT, cT,
    chunks)``, ``hT``/``cT`` the final states of every microbatch on the
    last chunk's rank and zeros on the others.  With ``keep`` each chunk
    runs on detached leaves under autograd and ``chunks`` maps its
    microbatch to ``(leaves, outputs)``; ``wx``, ``wh``, ``b`` are then
    leaves already."""
    size, me = world.plan.size(s), world.index(s)
    rounds = mb + size - 1
    xs, h0s, c0s = (v.chunk(mb, 0) for v in (x, h0, c0))
    ys, chunks, carry = [None] * mb, {}, None
    hT, cT = torch.zeros_like(h0), torch.zeros_like(c0)
    rows = h0s[0].shape[0]
    for r in range(rounds):
        m = r - me
        send = None
        if 0 <= m < mb:
            ins = [xs[m], *_carry_in(me == 0, h0s[m], c0s[m], carry)]
            with torch.enable_grad() if keep else torch.no_grad():
                if keep:
                    ins = [v.detach().requires_grad_() for v in ins]
                (h, c), y = _lstm_chunk(wx, wh, b, fb, ins[1], ins[2],
                                        ins[0])
            if keep:
                chunks[m] = (ins, (y, h, c))
            ys[m] = y.detach()
            send = torch.stack([h, c]).detach()
            if me == size - 1:
                hT[m * rows:(m + 1) * rows] = send[0]
                cT[m * rows:(m + 1) * rows] = send[1]
        if r < rounds - 1:
            if send is None:
                send = h0.new_zeros((2,) + h0s[0].shape)
            got = world.shift(send, s, cyclic=False)
            carry = (got[0], got[1])
    return torch.cat(ys), hT, cT, chunks


class _Pipeline(torch.autograd.Function):
    """:func:`_pipeline` under autograd.  The backward walks the rounds
    in reverse: at each boundary the reverse shift of the carries'
    cotangents (every rank, every round), then the rank's chunk of that
    round, if any, by ``torch.autograd.grad`` over the graph its forward
    kept.  Every input gets a gradient tensor on every rank (zeros where
    its work does not read it), so the collectives upstream run on every
    rank."""

    @staticmethod
    def forward(ctx, x, h0, c0, wx, wh, b, fb, world, s, mb):
        leaves = [p.detach().requires_grad_() for p in (wx, wh, b)]
        y, hT, cT, chunks = _pipeline(x, h0, c0, *leaves, fb, world, s, mb,
                                      keep=True)
        ctx.state = (world, s, mb, leaves, chunks)
        ctx.carry = (2,) + h0.chunk(mb, 0)[0].shape
        ctx.h0 = (h0.shape, h0.dtype)
        return y, hT, cT

    @staticmethod
    def backward(ctx, gy, ghT, gcT):
        world, s, mb, leaves, chunks = ctx.state
        size, me = world.plan.size(s), world.index(s)
        rounds = mb + size - 1
        gys, ghs, gcs = (g.chunk(mb, 0) for g in (gy, ghT, gcT))
        dx = [None] * mb
        dh0 = torch.zeros(ctx.h0[0], dtype=ctx.h0[1], device=gy.device)
        dc0 = torch.zeros_like(dh0)
        dh0s, dc0s = dh0.chunk(mb, 0), dc0.chunk(mb, 0)
        dparams = [torch.zeros_like(p) for p in leaves]
        # The cotangent of the carry this rank started its chunk of the
        # round after the boundary from: sent back across the boundary.
        back = None
        for r in range(rounds - 1, -1, -1):
            d_send = None
            if r < rounds - 1:
                if back is None:
                    back = gy.new_zeros(ctx.carry)
                d_send = world.shift(back, s, cyclic=False, reverse=True)
                back = None
            m = r - me
            if not 0 <= m < mb:
                continue
            ins, (y, h, c) = chunks.pop(m)
            gh = torch.zeros_like(h) if d_send is None else d_send[0]
            gc = torch.zeros_like(c) if d_send is None else d_send[1]
            if me == size - 1:
                gh, gc = gh + ghs[m], gc + gcs[m]
            grads = torch.autograd.grad((y, h, c), ins + leaves,
                                        (gys[m], gh, gc), allow_unused=True)
            g_in = [torch.zeros_like(v) if g is None else g
                    for v, g in zip(ins, grads)]
            dx[m] = g_in[0]
            if me == 0:
                dh0s[m].copy_(g_in[1])
                dc0s[m].copy_(g_in[2])
            else:
                back = torch.stack(g_in[1:])
            for acc, g in zip(dparams, grads[len(ins):]):
                if g is not None:
                    acc.add_(g)
        return (torch.cat(dx), dh0, dc0, *dparams, None, None, None, None)
