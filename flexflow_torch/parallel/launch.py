"""The world launcher: one process per rank, the port's counterpart of
JAX's device list.

``run(target, args, nprocs, device)`` spawns ``nprocs`` ranks with
``torch.multiprocessing``'s spawn context.  Each rank joins one
``torch.distributed`` process group through a ``FileStore`` in a fresh
temporary directory (no TCP port, so worlds started side by side never
collide), calls ``target(*args)`` and hands its return value back to the
parent, which returns the ranks' values in rank order.  ``target`` is a
``"module:function"`` path inside the port: a rank imports torch, the
port and that module, never the caller's module.

Backends:

- ``device="cpu"``: gloo, each rank on one CPU thread;
- ``device="cuda"``: NCCL with rank ``r`` on ``cuda:r``; it needs a card
  per rank (NCCL refuses two ranks on one card) and raises otherwise;
- ``device="cuda", backend="gloo"``: gloo with rank ``r`` on card
  ``r % cards``, all ranks on the one card of a one-card machine.  Only
  an explicit ``backend="gloo"`` takes this form.

A rank that has written its result leaves; over NCCL without tearing
the process group down (see ``_rank_main``).

Only rank 0's standard output is kept (the report a run prints once);
every rank keeps its standard error.  A rank that raises fails the run:
the parent stops the other ranks and raises with the rank's traceback.
The process group's timeout fails a collective that hangs
(``COLLECTIVE_TIMEOUT_S``, or ``timeout_s`` when given), and with
``timeout_s`` the parent stops the world after that long in all.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Any, List, Optional, Sequence

#: Seconds a collective may wait before it fails its rank.
COLLECTIVE_TIMEOUT_S = 600


def in_world() -> bool:
    """Whether this process is a rank of an initialised world."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if in_world() else 1


def rank() -> int:
    """This process's rank (0 outside a world)."""
    import torch.distributed as dist

    return dist.get_rank() if in_world() else 0


def _resolve(target: str):
    mod, _, fn = target.partition(":")
    if not mod.startswith("flexflow_torch") or not fn:
        raise ValueError(f"a rank's target is 'flexflow_torch....:function', "
                         f"got {target!r}")
    return getattr(importlib.import_module(mod), fn)


def _choose_backend(nprocs: int, device: str, backend: Optional[str]) -> str:
    import torch

    if device == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"CPU ranks run over gloo, not {backend!r}")
        return "gloo"
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a world on CUDA needs a CUDA device and none is "
                           "available; pass device='cpu' for CPU ranks")
    cards = torch.cuda.device_count()
    if backend is None:
        if cards < nprocs:
            raise RuntimeError(
                f"{nprocs} ranks need {nprocs} CUDA devices and {cards} are "
                f"visible: NCCL refuses two ranks on one device (pass "
                f"backend='gloo' to share the cards)")
        return "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and cards < nprocs:
        raise RuntimeError(f"NCCL needs a card per rank: {nprocs} ranks, "
                           f"{cards} cards")
    return backend


def _rank_main(r: int, nprocs: int, tmp: str, backend: str, device: str,
               target: str, args: Sequence[Any], timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    if r != 0:
        sys.stdout = open(os.devnull, "w")
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(r % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(tmp, "store"), nprocs)
    dist.init_process_group(
        backend, store=store, rank=r, world_size=nprocs,
        timeout=datetime.timedelta(seconds=timeout_s))
    out = _resolve(target)(*args)
    with open(os.path.join(tmp, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(out, f)
    sys.stdout.flush()
    if backend == "nccl":
        # NCCL's teardown waited forever on H100s (NCCL 2.28.9, torch
        # 2.11) once the world's collectives had been captured into CUDA
        # graphs at full width; the rank's result is written and the
        # device idle, so it leaves without tearing the group down.
        torch.cuda.synchronize()
        sys.stderr.flush()
        os._exit(0)
    dist.destroy_process_group()


def run(target: str, args: Sequence[Any] = (), nprocs: int = 1,
        device: str = "cuda", backend: Optional[str] = None,
        timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``target(*args)`` on each rank of a new world of ``nprocs``;
    returns the ranks' return values in rank order (they must pickle).
    Raises when a rank fails or the world outlives ``timeout_s``."""
    import torch.multiprocessing as mp

    if nprocs < 1:
        raise ValueError(f"a world needs at least one rank, got {nprocs}")
    if in_world():
        raise RuntimeError("run() starts a world; this process is already a "
                           "rank of one")
    backend = _choose_backend(nprocs, device, backend)
    _resolve(target)  # a bad target fails here, not in every rank
    tmp = tempfile.mkdtemp(prefix="ff_world_")
    sys.stdout.flush()
    try:
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, tmp, backend, device, target,
                              tuple(args), timeout_s or COLLECTIVE_TIMEOUT_S),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + (timeout_s or float("inf"))
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(5)
                raise TimeoutError(f"world of {nprocs} ({target}) did not "
                                   f"finish in {timeout_s} s")
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
