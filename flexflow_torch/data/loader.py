"""Synthetic host batches: the port's copy of
``flexflow_tpu/data/loader.py::synthetic_host_batch``.

The same numpy draw in the same order as the JAX package, so both
packages train on identical batches from one seed.  The loaders of the
data plane (array, device-resident, prefetching, streaming) come with
later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


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
