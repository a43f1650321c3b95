"""Carrying parameters across from the JAX package.

The port keeps the JAX package's parameter names and logical layouts
(``(out, in)`` linear kernels, ``(in, out)`` attention projections), so
moving a ``{op: {name: array}}`` tree from ``jax.device_get`` into the
port is a copy per array and nothing is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in numpy form:
        # widen exactly to f32, then narrow on the torch side.
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy torch owns


def params_from_numpy(
    np_params: Mapping[str, Mapping[str, np.ndarray]],
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{op: {param: array}}`` -> the same tree of tensors on
    ``device``.  Each array keeps its own dtype unless ``dtype`` is
    given, which then applies to every floating-point parameter."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for op, group in np_params.items():
        out[op] = {}
        for name, arr in group.items():
            t = _tensor(arr)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            out[op][name] = t.to(device)
    return out
