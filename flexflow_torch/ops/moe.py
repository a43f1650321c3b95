"""Mixture-of-experts FFN: the port of ``flexflow_tpu/ops/moe.py``.

Top-k routing with a per-expert capacity taken from the runtime token
count, slot-major queueing (every first choice claims capacity before
any second choice, each in token order; a token past capacity loses
that slot only and still consumes its queue position), the expert FFNs
over ``(E, C)`` slots and the auxiliary load-balance loss, as the JAX op
computes them.

The JAX op routes with one-hot ``(S, E, C)`` dispatch and combine
tensors; at an LM's 32768 tokens, 8 experts and capacity 5120 each is
1.34e9 elements, several a layer, which autograd would keep.  This op
computes the same function by index: the f32 ``cumsum`` positions
(exact integers) give each kept assignment its ``(expert, slot)`` row,
the tokens are copied into those rows (a dropped assignment into a row
of its own past the ``E * C`` slots, so every index is distinct and no
mask or host sync is needed), the two expert products run as batched
matrix products, and each token gathers its ``k`` slots back weighted
by its gates rounded to the compute dtype (the JAX op's
``combine.astype(cd)``).  Each slot holds at most one token, so the
dispatch is exact and the combine sums the same ``k`` terms.  Nothing
reads a device value on the host, so a step with this op can be
captured as a CUDA graph.

Under a mesh the ``c`` degree splits the expert dim of ``w1``, ``b1``,
``w2`` and ``b2`` and ``n`` the tokens; the op reads its input whole
along the sequence.  The routing keeps JAX's global semantics, since
JAX's forward sees the whole batch (``moe.py:135-207``): each rank
routes its own tokens, and one all-gather over ``n`` of the per-choice
expert counts (exact integers in f32, ``_global_counts``) gives the
capacity of the global token count, each queue's offset from the tokens
of earlier ``n`` ranks and earlier choices (slot-major over the global
batch), the aux loss's ``load`` and the drops.  Each rank fills the
slots of its ``E/c`` experts with its tokens; the slots are summed over
``n`` and each ``n`` rank keeps its ``C/n`` of them
(``collectives.reduce_scatter``: every slot holds one token, so the sum
is exact), runs the two products on them, and the products are
all-gathered back over ``n``.  Each rank combines the terms of its
experts and the partial outputs are summed over ``c``.  The router's
inputs are replicated over ``c`` and the dispatch and the combine split
over it, so ``x`` and the gates enter them through ``copy_to``; the
aux loss's ``importance`` is all-reduced over ``n``.
"""

from __future__ import annotations

from typing import Dict

import torch

from flexflow_torch.initializers import GlorotUniform, ZeroInitializer
from flexflow_torch.ops.activations import apply_activation, check_activation
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.parallel import collectives


def top_k_lowest_index(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row in
    descending order, equal values taken lowest index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order
    among ties).  ``torch.argmax`` returns the first maximal index; the
    chosen entry is then masked below every probability."""
    idx = []
    p = probs
    for j in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        idx.append(i)
        if j + 1 < k:
            p = p.scatter(-1, i, -1.0)
    idx = torch.cat(idx, dim=-1)
    return probs.gather(-1, idx), idx


class MixtureOfExperts(Op):
    """Switch-style MoE FFN over ``(batch, seq, d_model)``.  A loss op:
    its forward returns the weighted aux loss (zero in eval), the
    metrics ``{name}_aux_loss`` and ``{name}_dropped`` and the FFN's
    output."""

    is_loss = True
    #: The heaviest op of its block; its loss is a scalar byproduct, so
    #: ``--remat`` recomputes it as it does the other ops.
    allow_remat = True

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        num_experts: int,
        ffn_dim: int,
        capacity_factor: float = 1.25,
        activation: str = "gelu",
        aux_loss_weight: float = 1e-2,
        top_k: int = 1,
        kernel_initializer=None,
    ):
        super().__init__(name, [x])
        if x.ndim != 3:
            raise ValueError(f"moe input must be (batch, seq, d), got "
                             f"{x.shape}")
        check_activation(activation)
        if num_experts < 2:
            raise ValueError("moe needs >= 2 experts")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts="
                             f"{num_experts}]")
        b, t, d = x.shape
        self.attrs = dict(
            num_experts=num_experts,
            ffn_dim=ffn_dim,
            capacity_factor=capacity_factor,
            # The declared batch's capacity; the forward takes it from
            # the runtime token count, so microbatches drop at the full
            # batch's rate.
            capacity=self.capacity_for(b * t * top_k, capacity_factor,
                                       num_experts),
            activation=activation,
            aux_loss_weight=aux_loss_weight,
            top_k=top_k,
        )
        self.d_model = d
        self.kernel_initializer = kernel_initializer or GlorotUniform()
        self._make_output(x.shape, x.dtype, x.dim_axes)

    @staticmethod
    def capacity_for(tokens: int, cf: float, e: int) -> int:
        """Per-expert slots for ``tokens`` routed assignments, rounded up
        to a multiple of 8 (at least 8)."""
        cap = int(-(-cf * tokens // e))
        return max(8, -(-cap // 8) * 8)

    def capacity(self, tokens: int) -> int:
        """Per-expert slots for ``tokens`` tokens: top-k routing places k
        assignments a token, so capacity scales by k."""
        return self.capacity_for(tokens * self.attrs["top_k"],
                                 self.attrs["capacity_factor"],
                                 self.attrs["num_experts"])

    def param_specs(self) -> Dict[str, ParamSpec]:
        d = self.d_model
        e = self.attrs["num_experts"]
        f = self.attrs["ffn_dim"]
        dt = self.outputs[0].dtype
        ki = self.kernel_initializer
        return {
            "gate": ParamSpec((d, e), dt, ki),
            "w1": ParamSpec((e, d, f), dt, ki, ("c", None, None)),
            "b1": ParamSpec((e, f), dt, ZeroInitializer(), ("c", None)),
            "w2": ParamSpec((e, f, d), dt, ki, ("c", None, None)),
            "b2": ParamSpec((e, d), dt, ZeroInitializer(), ("c", None)),
        }

    def input_spec(self, i, frm):
        x = self.inputs[0]
        return self._spec((x.dim_axes[0], None, None), x.shape)

    def output_spec(self, j):
        return self.input_spec(0, None)

    def _mesh_axes(self):
        """``(n, c)``: the mesh axes that split the tokens and the experts
        (each ``()`` on one device)."""
        if self._world is None:
            return (), ()
        return self.input_spec(0, None)[0], self.param_spec("w1")[0]

    def forward(self, params, xs, state, training):
        (x,) = xs
        b, t, d = x.shape
        e = self.attrs["num_experts"]
        k = self.attrs["top_k"]
        s = b * t
        n_ax, c_ax = self._mesh_axes()
        world = self._world
        parts = self._plan.size(n_ax) if n_ax else 1
        cap = self.capacity(s * parts)
        xf = x.reshape(s, d)
        dev = x.device

        # -- routing (f32) --
        logits = xf.float() @ params["gate"].float()
        probs = torch.softmax(logits, dim=-1)                     # (S, E)
        topk_p, topk_e = top_k_lowest_index(probs, k)             # (S, K)
        gates = topk_p if k == 1 else topk_p / topk_p.sum(-1, keepdim=True)
        experts = torch.arange(e, device=dev)
        tokens = torch.arange(s, device=dev)
        # The one-hot choices expert-major, (E, S): the f32 running count
        # runs along the contiguous axis.  A scan over the outer axis of
        # the (32768, 8) token-major mask took 5.2 ms a layer on an H100
        # 80GB HBM3 at 700 W (chip_smoke phase 23 profile).
        masks = [(experts[:, None] == topk_e[:, j]).float() for j in range(k)]
        offsets, load = _global_counts(
            torch.stack([m.sum(1) for m in masks]), world, n_ax)
        # The rank's experts [e0, e0 + el) and each n rank's slots: the
        # capacity padded to a multiple of the n degree (the padding slots
        # stay empty and no token reads them).
        el = e // (self._plan.size(c_ax) if c_ax else 1)
        e0 = el * world.index(c_ax) if c_ax else 0
        slots = -(-cap // parts) * parts
        keep_total = torch.zeros((), dtype=torch.float32, device=dev)
        dest, gather_idx, weights = [], [], []
        xf_in = collectives.copy_to(xf, world, c_ax)
        gates = collectives.copy_to(gates, world, c_ax)
        for j in range(k):
            ej, mask = topk_e[:, j], masks[j]
            pos = ((mask.cumsum(1) - 1.0) + offsets[j][:, None]).gather(
                0, ej[None, :])[0].long()
            keep = pos < cap
            mine = keep & (ej >= e0) & (ej < e0 + el)
            slot = (ej - e0) * slots + pos
            dest.append(torch.where(mine, slot, el * slots + j * s + tokens))
            gather_idx.append(torch.where(mine, slot, 0))
            weights.append(torch.where(mine, gates[:, j], 0.0))
            keep_total = keep_total + keep.float().sum()

        # -- expert compute: every slot row holds at most one token --
        cd = x.dtype
        rows = xf.new_zeros((el * slots + k * s, d)).index_copy(
            0, torch.cat(dest), xf_in.repeat(k, 1))
        expert_in = collectives.reduce_scatter(
            rows[:el * slots].view(el, slots, d), 1, world, n_ax)
        h = torch.bmm(expert_in, params["w1"])
        h = apply_activation(h + params["b1"][:, None, :],
                             self.attrs["activation"])
        y_e = torch.bmm(h, params["w2"]) + params["b2"][:, None, :]
        y_flat = collectives.all_gather(y_e, 1, world, n_ax).reshape(
            el * slots, d)
        y = None
        for j in range(k):
            term = (weights[j].to(cd).float()[:, None]
                    * y_flat.index_select(0, gather_idx[j]).float())
            y = term if y is None else y + term
        y = collectives.all_reduce(y, world, c_ax).to(cd)

        # -- aux load-balance loss (first-choice load) --
        if n_ax:
            importance = collectives.all_reduce(probs.sum(0), world,
                                                n_ax) / float(s * parts)
            keep_total = world.all_reduce(keep_total, n_ax)
        else:
            load, importance = masks[0].mean(1), probs.mean(0)
        aux = e * torch.sum(load * importance)
        w = self.attrs["aux_loss_weight"]
        loss = (w * aux).float() if training else torch.zeros(
            (), dtype=torch.float32, device=dev)
        metrics = {
            f"{self.name}_aux_loss": aux.detach().float(),
            # Dropped assignments: a top-2 token losing one slot counts
            # once and still flows through its other slot.
            f"{self.name}_dropped": float(s * parts * k) - keep_total,
        }
        return (loss, metrics, [y.reshape(b, t, d)]), state


def _global_counts(counts, world, n_axes):
    """``(offsets, load)`` from this rank's ``(k, E)`` per-choice expert
    counts: ``offsets[j]``, the slots of each expert that choice ``j`` of
    this rank's tokens queues behind (every earlier choice of the global
    batch, then choice ``j`` of the tokens of earlier ``n`` ranks), and
    ``load``, the global share of first choices per expert (None on one
    device, where the caller takes the mean of its mask)."""
    if not n_axes:
        return torch.cat([counts.new_zeros((1, counts.shape[1])),
                          counts[:-1].cumsum(0)]), None
    every = world.all_gather(counts[None], 0, n_axes)          # (N, k, E)
    mine = world.index(n_axes)
    total = every.sum(0)
    before = every[:mine].sum(0)
    offsets = torch.cat([total.new_zeros((1, total.shape[1])),
                         total[:-1].cumsum(0)]) + before
    return offsets, total[0] / total[0].sum()
