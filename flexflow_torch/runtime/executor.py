"""Graph executor: parameter init and the eval forward of an FFModel.

The single-device, forward-only part of
``flexflow_tpu/runtime/executor.py`` that serving needs: ``init`` and an
eval ``forward_step`` returning every non-loss op output (the
full-sequence logits the decode-versus-full-forward check reads).  The
training step comes with the next slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel


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


class Executor:
    def __init__(self, model: FFModel, config: Optional[FFConfig] = None,
                 device=None):
        self.model = model
        self.config = config or model.config
        self.device = resolve_device(device)

    def init(self, seed: Optional[int] = None) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fresh ``{op_name: {param: tensor}}`` on the device, drawn from
        a ``torch.Generator`` seeded with ``seed`` (default
        ``config.seed``), op by op and key by key in sorted order — the
        JAX package's order, not its values."""
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for op in self.model.layers:
            specs = op.param_specs()
            if specs:
                params[op.name] = {
                    k: specs[k].initializer(gen, specs[k].shape,
                                            specs[k].dtype).to(self.device)
                    for k in sorted(specs)
                }
        return params

    def forward(self, params, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Eval forward over the non-loss ops; returns every tensor by
        name (inputs included).  ``batch`` needs only the inputs those
        ops read (an LM's labels feed its loss alone)."""
        layers = [op for op in self.model.layers if not op.is_loss]
        consumed = {t.name for op in layers for t in op.inputs}
        env: Dict[str, torch.Tensor] = {}
        for t in self.model.input_tensors:
            if t.name not in consumed:
                continue
            x = torch.as_tensor(batch[t.name], device=self.device)
            if tuple(x.shape[1:]) != t.shape[1:]:
                raise ValueError(f"input {t.name}: expected {t.shape}, got "
                                 f"{tuple(x.shape)}")
            env[t.name] = x.to(t.dtype)
        for op in layers:
            xs = [env[t.name] for t in op.inputs]
            ys, _ = op.forward(params.get(op.name, {}), xs, {},
                               training=False)
            for t, y in zip(op.outputs, ys):
                env[t.name] = y
        return env

    @torch.inference_mode()
    def forward_step(self, params, batch) -> Dict[str, torch.Tensor]:
        """Eval forward returning every non-loss op output by tensor name
        (``outs["lm_head:out"]`` is the LM's full-sequence logits)."""
        env = self.forward(params, batch)
        return {t.name: env[t.name] for op in self.model.layers
                if not op.is_loss for t in op.outputs}
