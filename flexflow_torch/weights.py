"""Carrying parameters and optimizer state across from the JAX package.

The port keeps the JAX package's parameter names and logical layouts
(``(out, in)`` linear kernels, ``(in, out)`` attention projections), so
moving a ``{op: {name: array}}`` tree from ``jax.device_get`` into the
port is a copy per array and nothing is transposed.  A pipeline's
per-stage trees (``{si: {op: ...}}``, JAX's ``PipelineExecutor`` form)
cross the same way, each stage cut by its own executor's specs.
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


def _block(arr, plan, rank: int, specs, op: str, name: str):
    """The rank's block of a full array (the array itself without a
    plan)."""
    a = np.asarray(arr)
    if plan is None:
        return a
    return a[plan.local_slices(specs[op][name], a.shape, rank)]


def params_from_numpy(
    np_params: Mapping[str, Mapping[str, np.ndarray]],
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    plan=None,
    rank: int = 0,
    specs=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{op: {param: array}}`` -> the same tree of tensors on
    ``device``.  Each array keeps its own dtype unless ``dtype`` is
    given, which then applies to every floating-point parameter.  With a
    ``MeshPlan``, each array is cut to ``rank``'s block under
    ``specs[op][param]``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for op, group in np_params.items():
        out[op] = {}
        for name, arr in group.items():
            t = _tensor(_block(arr, plan, rank, specs, op, name))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            out[op][name] = t.to(device)
    return out


def opt_state_from_numpy(np_state, device="cuda", plan=None, rank: int = 0,
                         specs=None):
    """A JAX optimizer state, after ``jax.device_get``, as the port's:
    Adam's ``{"m": tree, "v": tree, "t": array}`` becomes f32 moment
    trees and a 0-d int32 step count on ``device``; SGD's momentum tree (or None)
    becomes a tree of tensors in its own dtype (or None).  Both packages
    can then continue from one state.  With a ``MeshPlan`` each moment is
    cut to ``rank``'s block under ``specs`` (``Executor.zero_specs``)."""
    if np_state is None:
        return None
    kw = dict(plan=plan, rank=rank, specs=specs)
    if set(np_state) == {"m", "v", "t"}:
        return {"m": params_from_numpy(np_state["m"], device, **kw),
                "v": params_from_numpy(np_state["v"], device, **kw),
                "t": torch.tensor(int(np.asarray(np_state["t"])),
                                  dtype=torch.int32, device=device)}
    return params_from_numpy(np_state, device, **kw)


def state_from_numpy(np_state, device="cuda", plan=None, rank: int = 0,
                     specs=None):
    """A JAX op state, after ``jax.device_get``, as the port's: the same
    ``{op: {key: array}}`` tree, with unsigned integer arrays (Dropout's
    uint32 threefry key) widened to int64, the form
    ``runtime/keyed_random.py`` computes in; float state (BatchNorm's
    running statistics) keeps its dtype; with a ``MeshPlan`` each array is
    cut to ``rank``'s block under ``specs``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for op, group in np_state.items():
        out[op] = {}
        for name, arr in group.items():
            a = _block(arr, plan, rank, specs, op, name)
            if a.dtype.kind == "u":
                a = a.astype(np.int64)
            out[op][name] = _tensor(a).to(device)
    return out


def _stage_tree(tree, pipe, si: int):
    """Stage ``si``'s share of a numpy tree: ``tree[si]`` of a per-stage
    ``{si: {op: ...}}`` tree (JAX's ``PipelineExecutor`` form), or the
    stage's ops of a one-executor ``{op: ...}`` tree."""
    if si in tree or str(si) in tree:
        return tree.get(si, tree.get(str(si)))
    ops = {op.name for op in pipe.stages[si].ops}
    return {op: g for op, g in tree.items() if op in ops}


def pipeline_params_from_numpy(np_params, pipe, device="cuda",
                               dtype: Optional[torch.dtype] = None):
    """JAX's per-stage parameter tree ``{si: {op: {param: array}}}`` (or
    one executor's ``{op: ...}``, split by stage) as the port's per-stage
    dicts for ``pipe``'s stages on this rank, each array cut to the rank's
    block under its stage executor's specs."""
    out = {}
    for si in pipe.mine:
        ex = pipe.stage_ex[si]
        out[si] = params_from_numpy(_stage_tree(np_params, pipe, si), device,
                                    dtype, plan=ex.plan, rank=ex.world.rank,
                                    specs=ex.param_specs())
    return out

