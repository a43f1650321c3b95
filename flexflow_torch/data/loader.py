"""Synthetic host batches and the device memory budget: the port's copy
of ``flexflow_tpu/data/loader.py::synthetic_host_batch``,
``DeviceMemoryError`` and ``_device_bytes_limit``.

The same numpy draw in the same order as the JAX package, so both
packages train on identical batches from one seed.  The budget is what
the serving executor's KV cache is checked against before it is
allocated.  The loaders of the data plane (array, device-resident,
prefetching, streaming) come with later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class DeviceMemoryError(RuntimeError):
    """An allocation would not fit the per-device memory budget: raised
    from an up-front estimate, before anything is allocated."""


def _device_bytes_limit(device=None) -> Optional[int]:
    """The per-device memory budget: ``FF_DEVICE_MEM_BYTES`` when set,
    else on a CUDA device its memory (the total of
    ``torch.cuda.mem_get_info``, as JAX's ``bytes_limit`` is the device's
    whole budget); None elsewhere (the check is then inert, as on the JAX
    package's CPU backend)."""
    env = os.environ.get("FF_DEVICE_MEM_BYTES")
    if env:
        return int(env)
    import torch

    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(dev)
    return int(total)


def synthetic_host_batch(
    model,
    rng: np.random.Generator,
    int_high: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """One host batch of random inputs matching ``model``'s input
    tensors.  Integer inputs (labels, embedding ids) are drawn in
    ``[0, int_high[name])``, else ``[0, max_value)`` with the reference's
    small default of 2; float inputs are standard normal in f32 (the
    executor rounds them to the tensor's dtype when it places them)."""
    int_high = int_high or {}
    out = {}
    for t in model.input_tensors:
        if not t.dtype.is_floating_point:
            hi = int_high.get(t.name, getattr(t, "max_value", 2))
            out[t.name] = rng.integers(0, hi, size=t.shape).astype(np.int32)
        else:
            out[t.name] = rng.standard_normal(size=t.shape).astype(np.float32)
    return out
