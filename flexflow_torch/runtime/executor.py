"""Graph executor: parameter init, the forward over the op graph, and the
dense single-device train step.

The single-device path of ``flexflow_tpu/runtime/executor.py``:

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
- ``eval_step`` and the eval ``forward_step`` (every non-loss output).

Strategies and meshes, the row-sparse embedding path, supersteps and
gradient accumulation come with later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel

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


class Executor:
    def __init__(self, model: FFModel, config: Optional[FFConfig] = None,
                 optimizer=None, device=None):
        self.model = model
        self.config = config or model.config
        self.device = resolve_device(device)
        #: None for an executor that only runs forwards; ``init`` and
        #: ``train_step`` need one (``apps.common.make_optimizer`` builds
        #: it from the flags).
        self.optimizer = optimizer

    def _require_optimizer(self, what: str):
        if self.optimizer is None:
            raise ValueError(
                f"Executor.{what} needs an optimizer: pass optimizer="
                f"make_optimizer(cfg) (flexflow_torch.apps.common)")
        return self.optimizer

    # -- initialization ------------------------------------------------------

    def init_params(self, seed: Optional[int] = None) -> Tree:
        """Fresh params ``{op_name: {param: tensor}}`` on the device,
        drawn from a ``torch.Generator`` seeded with ``seed`` (default
        ``config.seed``), op by op and key by key in sorted order: the JAX
        package's order, not its values."""
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        params: Tree = {}
        for op in self.model.layers:
            specs = op.param_specs()
            if specs:
                params[op.name] = {
                    k: specs[k].initializer(gen, specs[k].shape,
                                            specs[k].dtype).to(self.device)
                    for k in sorted(specs)
                }
        return params

    def init(self, seed: Optional[int] = None):
        """Fresh ``(params, opt_state, state)`` for training.  No op of
        the port keeps state yet, so ``state`` is ``{}``."""
        opt = self._require_optimizer("init")
        params = self.init_params(seed)
        return params, opt.init(params), {}

    def shard_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch as tensors on the device, each in its input's
        dtype (one device: nothing is sharded)."""
        return {t.name: torch.as_tensor(batch[t.name]).to(self.device, t.dtype)
                for t in self.model.input_tensors if t.name in batch}

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
            if t.name in env and \
                    tuple(env[t.name].shape[strict:]) != t.shape[strict:]:
                raise ValueError(f"input {t.name}: expected {t.shape}, got "
                                 f"{tuple(env[t.name].shape)}")
        return env

    def forward(self, params, state, batch: Mapping[str, Any],
                training: bool, layers: Optional[List] = None):
        """Run the op graph, or the ops in ``layers`` (in graph order);
        ``batch`` needs only the inputs they read.  Returns ``(loss,
        metrics, new_state, env)``; ``env`` maps every tensor name to its
        value, except the loss ops' outputs, which no op reads and the
        port does not compute (``ops/losses.py``)."""
        layers = self.model.layers if layers is None else layers
        env = self._inputs(batch, {t.name for op in layers for t in op.inputs})
        total_loss = None
        metrics: Dict[str, torch.Tensor] = {}
        new_state: Dict[str, Any] = {}
        for op in layers:
            xs = [env[t.name] for t in op.inputs]
            s = state.get(op.name, {})
            result, s_new = op.forward(params.get(op.name, {}), xs, s,
                                       training)
            if op.is_loss:
                loss, m, ys = result
                total_loss = loss if total_loss is None else total_loss + loss
                metrics = _merge_metrics(metrics, m)
            else:
                ys = result
            for t, y in zip(op.outputs, ys):
                env[t.name] = y
            if s_new is not s and s_new:
                new_state[op.name] = s_new
            elif s:
                new_state[op.name] = s
        if total_loss is None:
            total_loss = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        return total_loss, metrics, new_state, env

    @torch.inference_mode()
    def forward_step(self, params, batch) -> Dict[str, torch.Tensor]:
        """Eval forward over the non-loss ops, returning every non-loss
        op output by tensor name (``outs["lm_head:out"]`` is the LM's
        full-sequence logits).  ``batch`` needs only the inputs those
        ops read (an LM's labels feed its loss alone)."""
        layers = [op for op in self.model.layers if not op.is_loss]
        _, _, _, env = self.forward(params, {}, batch, training=False,
                                    layers=layers)
        return {t.name: env[t.name] for op in layers for t in op.outputs}

    # -- steps ---------------------------------------------------------------

    def loss_and_grads(self, params, state, batch):
        """``(loss, metrics, new_state, grads)`` of one training forward
        and backward; ``grads`` has the params' structure and dtypes
        (zeros for a parameter the loss does not reach, as JAX gives)."""
        leaves = [p.requires_grad_(True) for g in params.values()
                  for p in g.values()]
        loss, metrics, new_state, env = self.forward(params, state, batch,
                                                     training=True)
        del env  # free what autograd does not keep before the backward
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(flat)
        grads = {}
        for op, group in params.items():
            grads[op] = {}
            for k, p in group.items():
                g = next(it)
                grads[op][k] = torch.zeros_like(p) if g is None else g
        return loss.detach(), metrics, new_state, grads

    def _clip_grads(self, grads):
        """--clip-norm: scale every gradient by ``min(1, c / ||g||)`` over
        the global L2 norm (one f32 device scalar; nothing is read back)."""
        c = self.config.clip_norm
        if not c or c <= 0.0:
            return grads
        sq = sum(g.float().square().sum() for group in grads.values()
                 for g in group.values())
        scale = torch.clamp(c * torch.rsqrt(torch.clamp(sq, min=1e-30)),
                            max=1.0)
        return {op: {k: (g.float() * scale).to(g.dtype)
                     for k, g in group.items()}
                for op, group in grads.items()}

    def train_step(self, params, opt_state, state, batch):
        """One iteration: forward, backward, clip, optimizer update in
        place.  Returns ``(params, opt_state, state, metrics)``."""
        opt = self._require_optimizer("train_step")
        _loss, metrics, new_state, grads = self.loss_and_grads(
            params, state, batch)
        grads = self._clip_grads(grads)
        params, opt_state = opt.update(params, opt_state, grads)
        return params, opt_state, new_state, metrics

    @torch.no_grad()
    def eval_step(self, params, state, batch):
        """Read-only forward: ``(loss, metrics)``."""
        loss, metrics, _, _ = self.forward(params, state, batch,
                                           training=False)
        return loss, metrics
