"""Optimizers: the dense updates of ``flexflow_tpu/optim.py``.

``SGDOptimizer`` (PyTorch semantics: weight decay folded into the
gradient, a momentum buffer, optional nesterov; reference
``optimizer_kernel.cu:28-41``) and ``AdamOptimizer`` (f32 moments,
bias correction from a step count, constant/cosine/step schedules,
decoupled weight decay).  Both update parameters and state IN PLACE, the
torch form of the JAX step's buffer donation; the arithmetic follows the
JAX update operation for operation, in f32, and each parameter is
rounded once to its own dtype (bf16 parameters keep no f32 master copy,
as in the JAX package).  Adam's step count is a 0-d int32 tensor on the
params' device, advanced in place, and its scheduled lr and bias
corrections are computed from it on that device in float32 with the JAX
expressions: no device value is read, and a CUDA graph that captured
the update advances them on every replay.  SGD's factors are constants.

Both also carry the row-sparse protocol the executor's sparse train step
drives (``flexflow_tpu/optim.py``): ``supports_sparse_rows`` (plain SGD,
or ``lazy_sparse`` -- ``--lazy-sparse-opt`` -- for momentum SGD and
Adam), ``sparse_row_step`` (one update restricted to gathered rows,
returning scatter-addable deltas) and the helpers that filter the sparse
tables' state out of the dense update and put it back.  Lazy semantics
are torch SparseAdam's: decay and moments advance only for rows a step
touches; Adam's bias correction uses the global step count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def _leaves(*trees: Tree):
    """Zip same-structured ``{op: {name: tensor}}`` trees leaf by leaf."""
    first = trees[0]
    for op in first:
        for k in first[op]:
            yield tuple(t[op][k] for t in trees)


@dataclasses.dataclass
class SGDOptimizer:
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    lazy_sparse: bool = False

    @property
    def supports_sparse_rows(self) -> bool:
        """Row-sparse updates equal the dense update only for plain SGD
        (momentum needs a dense buffer, weight decay touches every row);
        ``lazy_sparse`` opts into the lazy deviation instead."""
        return (self.momentum == 0.0 and self.weight_decay == 0.0) or \
            self.lazy_sparse

    @property
    def stateless_sparse(self) -> bool:
        """The row update is a scaled scatter-add, linear in the gradient:
        duplicate ids may be scattered per occurrence."""
        return self.momentum == 0.0 and self.weight_decay == 0.0

    def sparse_state_buffers(self, opt_state, op_name: str, key: str):
        """The table-shaped state tensors of one sparse param, by name."""
        if self.momentum == 0.0 or opt_state is None:
            return {}
        return {"v": opt_state[op_name][key]}

    def with_sparse_state_buffers(self, opt_state, op_name: str, key: str,
                                  new):
        if not new:
            return opt_state
        out = dict(opt_state)
        out[op_name] = {**out[op_name], key: new["v"]}
        return out

    def sparse_step_count(self, opt_state):
        return None

    @torch.no_grad()
    def sparse_row_step(self, p_rows, g_rows, state_rows, t=None):
        """One step restricted to gathered unique rows: ``(delta_p,
        delta_state)`` for the caller to scatter-add back."""
        g = g_rows.float()
        if self.weight_decay > 0.0:
            g = g + self.weight_decay * p_rows.float()
        if self.momentum > 0.0:
            v = state_rows["v"].float()
            v_new = self.momentum * v + g
            step = g + self.momentum * v_new if self.nesterov else v_new
            d_state = {"v": (v_new - v).to(state_rows["v"].dtype)}
        else:
            step, d_state = g, {}
        return (-self.lr * step).to(p_rows.dtype), d_state

    def map_param_states(self, opt_state, fn):
        """``fn`` applied to the params-shaped state (None passes)."""
        return None if opt_state is None else fn(opt_state)

    def restore_param_states(self, new_state, old_state, names):
        """``new_state`` with the subtrees of ``names`` taken back from
        ``old_state`` (the sparse tables left out of the dense update)."""
        if old_state is None:
            return new_state
        merged = dict(new_state or {})
        for n in names:
            if n in old_state:
                merged[n] = old_state[n]
        return merged

    def init(self, params: Tree) -> Any:
        """Momentum buffers in the parameters' dtype (the reference's
        per-parameter ``v_regions``); None when momentum is off."""
        if self.momentum > 0.0:
            return {op: {k: torch.zeros_like(p) for k, p in g.items()}
                    for op, g in params.items()}
        return None

    @torch.no_grad()
    def update(self, params: Tree, opt_state, grads: Tree):
        """One step in place; returns ``(params, opt_state)``."""
        trees = (params, grads) if self.momentum == 0.0 else (
            params, grads, opt_state)
        for leaf in _leaves(*trees):
            p, g = leaf[0], leaf[1]
            g = g.float()
            pf = p.float()
            if self.weight_decay > 0.0:
                g = g + self.weight_decay * pf
            if self.momentum > 0.0:
                v = leaf[2]
                v_new = self.momentum * v.float() + g
                step = g + self.momentum * v_new if self.nesterov else v_new
                v.copy_(v_new)
            else:
                step = g
            p.copy_(pf - self.lr * step)
        return params, opt_state


@dataclasses.dataclass
class AdamOptimizer:
    """Adam with f32 moments and a step count ``t`` carried in the state
    (a 0-d int32 tensor on the params' device, advanced in place).
    ``schedule``: ``"constant"``, ``"cosine"`` (linear warmup over
    ``warmup_steps``, then cosine decay to ``min_lr`` over
    ``decay_steps``) or ``"step"`` (times ``gamma`` every
    ``decay_steps``)."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 10_000
    min_lr: float = 0.0
    gamma: float = 0.1
    lazy_sparse: bool = False

    def __post_init__(self):
        if self.schedule not in ("constant", "cosine", "step"):
            raise ValueError(f"unknown schedule {self.schedule!r} "
                             f"(constant|cosine|step)")

    def _lr_at(self, t):
        """Scheduled lr for the 1-based step ``t`` (a 0-d int32 tensor,
        or an int), in float32 on ``t``'s device as the JAX package
        computes it; the constant schedule's lr is a Python float."""
        if self.schedule == "constant":
            return self.lr
        tf = torch.as_tensor(t, dtype=torch.int32).float()
        if self.schedule == "cosine":
            ramp = torch.clamp(tf / float(max(self.warmup_steps, 1)), max=1.0)
            prog = torch.clamp((tf - self.warmup_steps)
                               / max(self.decay_steps, 1), 0.0, 1.0)
            cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
            return ramp * (self.min_lr + (self.lr - self.min_lr) * cos)
        k = torch.floor((tf - 1.0) / max(self.decay_steps, 1))
        return self.lr * torch.pow(self.gamma, k)

    @property
    def supports_sparse_rows(self) -> bool:
        return self.lazy_sparse

    @property
    def stateless_sparse(self) -> bool:
        return False

    def sparse_state_buffers(self, opt_state, op_name: str, key: str):
        return {"m": opt_state["m"][op_name][key],
                "v": opt_state["v"][op_name][key]}

    def with_sparse_state_buffers(self, opt_state, op_name: str, key: str,
                                  new):
        out = {"m": dict(opt_state["m"]), "v": dict(opt_state["v"]),
               "t": opt_state["t"]}
        out["m"][op_name] = {**out["m"][op_name], key: new["m"]}
        out["v"][op_name] = {**out["v"][op_name], key: new["v"]}
        return out

    def sparse_step_count(self, opt_state):
        return opt_state["t"]

    def _factors(self, t):
        """Scheduled lr and the bias corrections ``1 - b**t`` of step
        ``t``, in float32 on ``t``'s device."""
        tf = torch.as_tensor(t, dtype=torch.int32).float()
        return (self._lr_at(t), 1.0 - torch.pow(self.b1, tf),
                1.0 - torch.pow(self.b2, tf))

    @torch.no_grad()
    def sparse_row_step(self, p_rows, g_rows, state_rows, t=None):
        """SparseAdam row step with the dense update's arithmetic; ``t``
        is the global step count after the dense update's increment.
        Returns scatter-addable deltas."""
        lr, c1, c2 = self._factors(t)
        g = g_rows.float()
        m, v = state_rows["m"], state_rows["v"]
        m_new = m.mul(self.b1).add_(g, alpha=1.0 - self.b1)
        v_new = v.mul(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        upd = (m_new / c1) / ((v_new / c2).sqrt() + self.eps)
        if self.weight_decay > 0.0:
            upd = upd + self.weight_decay * p_rows.float()
        return (-lr * upd).to(p_rows.dtype), {"m": m_new - m, "v": v_new - v}

    def map_param_states(self, opt_state, fn):
        """``fn`` applied to the params-shaped m and v; t passes."""
        return {"m": fn(opt_state["m"]), "v": fn(opt_state["v"]),
                "t": opt_state["t"]}

    def restore_param_states(self, new_state, old_state, names):
        out = {"m": dict(new_state["m"]), "v": dict(new_state["v"]),
               "t": new_state["t"]}
        for n in names:
            if n in old_state["m"]:
                out["m"][n] = old_state["m"][n]
                out["v"][n] = old_state["v"][n]
        return out

    def init(self, params: Tree) -> Dict[str, Any]:
        def zeros(g):
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for k, p in g.items()}

        device = next((p.device for g in params.values() for p in g.values()),
                      torch.device("cpu"))
        return {"m": {op: zeros(g) for op, g in params.items()},
                "v": {op: zeros(g) for op, g in params.items()},
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, params: Tree, opt_state, grads: Tree):
        """One step in place, ``t`` included; returns ``(params,
        opt_state)``."""
        t = opt_state["t"]
        t.add_(1)
        lr, c1, c2 = self._factors(t)
        for p, g, m, v in _leaves(params, grads, opt_state["m"],
                                  opt_state["v"]):
            g = g.float()
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / c1) / ((v / c2).sqrt() + self.eps)
            pf = p.float()
            if self.weight_decay > 0.0:
                upd = upd + self.weight_decay * pf  # AdamW-style decoupled
            p.copy_(pf - lr * upd)
        return params, opt_state
