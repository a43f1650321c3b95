"""Optimizers: the dense updates of ``flexflow_tpu/optim.py``.

``SGDOptimizer`` (PyTorch semantics: weight decay folded into the
gradient, a momentum buffer, optional nesterov; reference
``optimizer_kernel.cu:28-41``) and ``AdamOptimizer`` (f32 moments,
bias correction from a step count, constant/cosine/step schedules,
decoupled weight decay).  Both update parameters and state IN PLACE, the
torch form of the JAX step's buffer donation; the arithmetic follows the
JAX update operation for operation, in f32, and each parameter is
rounded once to its own dtype (bf16 parameters keep no f32 master copy,
as in the JAX package).  Scalar factors (scheduled lr, bias corrections)
are computed on the host in float32 with the JAX expressions, so no
device value is read.  The lazy row-sparse variants (``lazy_sparse``)
belong to the DLRM slice and are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def _refuse_lazy(lazy_sparse: bool) -> None:
    if lazy_sparse:
        raise NotImplementedError(
            "lazy_sparse (--lazy-sparse-opt): the row-sparse optimizer "
            "path comes with the DLRM slice of the port (ROADMAP.md queue "
            "1, item 1)"
        )


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

    def __post_init__(self):
        _refuse_lazy(self.lazy_sparse)

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
    (a host int).  ``schedule``: ``"constant"``, ``"cosine"`` (linear
    warmup over ``warmup_steps``, then cosine decay to ``min_lr`` over
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
        _refuse_lazy(self.lazy_sparse)
        if self.schedule not in ("constant", "cosine", "step"):
            raise ValueError(f"unknown schedule {self.schedule!r} "
                             f"(constant|cosine|step)")

    def _lr_at(self, t: int) -> np.float32:
        """Scheduled lr for the 1-based step ``t``, in float32 as the
        JAX package computes it."""
        f = np.float32
        tf = f(t)
        if self.schedule == "constant":
            return f(self.lr)
        if self.schedule == "cosine":
            warm = f(max(self.warmup_steps, 1))
            ramp = np.minimum(tf / warm, f(1.0))
            prog = np.clip((tf - f(self.warmup_steps))
                           / f(max(self.decay_steps, 1)), f(0.0), f(1.0))
            cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * prog))
            return f(ramp * (f(self.min_lr) + f(self.lr - self.min_lr) * cos))
        k = np.floor((tf - f(1.0)) / f(max(self.decay_steps, 1)))
        return f(f(self.lr) * np.power(f(self.gamma), k))

    def init(self, params: Tree) -> Dict[str, Any]:
        def zeros(g):
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for k, p in g.items()}

        return {"m": {op: zeros(g) for op, g in params.items()},
                "v": {op: zeros(g) for op, g in params.items()},
                "t": 0}

    @torch.no_grad()
    def update(self, params: Tree, opt_state, grads: Tree):
        """One step in place; returns ``(params, opt_state)``."""
        t = int(opt_state["t"]) + 1
        f = np.float32
        lr = float(self._lr_at(t))
        c1 = float(f(1.0) - np.power(f(self.b1), f(t)))
        c2 = float(f(1.0) - np.power(f(self.b2), f(t)))
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
        opt_state["t"] = t
        return params, opt_state
