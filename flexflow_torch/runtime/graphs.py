"""K steps as one CUDA graph: the torch form of the JAX package's
``lax.scan`` superstep (``flexflow_tpu/runtime/executor.py``,
``build_superstep``).

``StepGraph`` runs ``step(*carry, inputs_j) -> (*carry, outs_j)`` for
``j < k``, where ``inputs_j`` is row ``j`` of every tensor of a stacked
``(k, ...)`` input dict and the ``outs_j`` (a dict of tensors) come back
stacked ``(k, ...)``: a train step ``(params, opt_state, state, batch)
-> (params, opt_state, state, metrics)`` has that form.  The carry
(trees of dicts, lists and tuples of tensors) crosses steps: the step
must update its tensors IN PLACE and hand back the same ones, which is
what lets a graph replay the k steps onto them.

On CUDA:

- the first call runs the k steps eagerly on a side stream (real steps:
  they build the kernels, choose the cuDNN and cuBLAS plans and settle
  the allocator), then captures them once with ``torch.cuda.graph``;
- every later call copies the stacked inputs into the graph's static
  input buffer (no copy when it is handed that buffer) and replays, so
  the k steps cost one launch from the host;
- ``capture`` records the graph without running it, for a caller that
  has already warmed the same step (the trainer's tail superstep);
- a call whose carry is not the captured tensors (compared by
  ``data_ptr``) raises: a replay would update the captured ones;
- a capture that fails raises.  Nothing falls back to eager steps;
- Python's cyclic garbage collector is paused during a capture: a graph
  that became garbage in a reference cycle (an old executor's) is
  destroyed by the collector, and destroying a graph while another
  stream captures invalidates the capture
  (``cudaErrorStreamCaptureInvalidated``).

The stacked outputs of a replay are the graph's static tensors: they
hold until the next call overwrites them, so the caller reads them (the
trainer's one host readback per superstep) before calling again.

Under a world of ranks the steps hold collectives:

- over NCCL they are captured with the kernels into the rank's graph
  (NCCL's communicators are made by the eager first call, before any
  capture); the executor captures them in ``thread_local`` error mode,
  so the process group's watchdog thread may still query its own events
  meanwhile;
- over gloo (the CPU, or ranks sharing one card) nothing of a
  collective can be captured: the caller builds the step graph with
  ``graph=False`` and the k steps run as a loop on CUDA too.  That is
  chosen from the backend before the first call, never after a failed
  capture.

Elsewhere (the CPU) the k steps run as a Python loop.  The kernels'
Python launch counters advance while a graph is captured and not when
it replays.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, List, Tuple

import torch


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts (in sorted key order), lists and
    tuples; other leaves (None, numbers) are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


def _ptrs(tree) -> List[int]:
    return [t.data_ptr() for t in tensor_leaves(tree)]


def _stack(outs: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


class StepGraph:
    """``k`` steps of ``step`` over a stacked input, as one CUDA graph on
    CUDA and a Python loop elsewhere (see the module docstring)."""

    def __init__(self, step: Callable, k: int, device: torch.device,
                 graph: bool = True, capture_error_mode: str = "global"):
        if k < 1:
            raise ValueError(f"a step graph needs k >= 1, got {k}")
        self.step = step
        self.k = k
        self.device = torch.device(device)
        #: Whether the k steps are one CUDA graph (on CUDA, unless the
        #: caller asks for the loop: ranks over gloo).
        self.graphed = graph and self.device.type == "cuda"
        self.capture_error_mode = capture_error_mode
        self._graph = None
        self._static_in: Dict[str, torch.Tensor] = {}
        self._static_out: Dict[str, torch.Tensor] = {}
        self._carry_ptrs: List[int] = []

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def _run(self, carry, stacked) -> Tuple[tuple, Dict[str, torch.Tensor]]:
        outs = []
        for j in range(self.k):
            *carry, out = self.step(*carry,
                                    {n: v[j] for n, v in stacked.items()})
            outs.append(out)
        return tuple(carry), _stack(outs)

    def __call__(self, *args):
        """``step``'s carry and then the stacked inputs in; ``(*carry,
        outs)`` out after k steps, ``outs`` stacked ``(k, ...)``."""
        carry, stacked = args[:-1], args[-1]
        if not self.graphed:
            carry, outs = self._run(carry, stacked)
        elif self._graph is None:
            carry, outs = self._warm(carry, stacked)
            self.capture(*carry, stacked)
        else:
            self._replay(carry, stacked)
            outs = self._static_out
        return (*carry, outs)

    def _replay(self, carry, stacked) -> None:
        if _ptrs(carry) != self._carry_ptrs:
            raise ValueError(
                "this step graph was captured on other tensors: call it "
                "with the params and state it was captured with (or build "
                "a new one)")
        if set(stacked) != set(self._static_in):
            raise ValueError(f"stacked inputs {sorted(stacked)}, the graph "
                             f"was captured with {sorted(self._static_in)}")
        for name, v in stacked.items():
            dst = self._static_in[name]
            if v is dst:
                continue
            if v.shape != dst.shape or v.dtype != dst.dtype:
                raise ValueError(
                    f"stacked input {name}: {tuple(v.shape)} {v.dtype}, the "
                    f"graph was captured at {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(v)
        self._graph.replay()

    def _warm(self, carry, stacked):
        """The k steps eagerly on a side stream, then joined back."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            carry, outs = self._run(carry, stacked)
        main.wait_stream(side)
        for v in outs.values():
            v.record_stream(main)  # read on the caller's stream
        return carry, outs

    def capture(self, *args) -> None:
        """Record the k steps on the carry (``args`` as for a call) as
        the graph, without running them; the next call replays.  The
        step must already have run eagerly in this process at these
        shapes (a first call does that), so no kernel is built or
        planned while capturing."""
        if not self.graphed:
            raise ValueError("only a step graph on CUDA, built with "
                             "graph=True, is captured")
        if self._graph is not None:
            raise RuntimeError("this step graph is already captured")
        carry, stacked = args[:-1], args[-1]
        before = _ptrs(carry)
        static_in = {n: v.clone() for n, v in stacked.items()}
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            mode = {} if self.capture_error_mode == "global" else {
                "capture_error_mode": self.capture_error_mode}
            with torch.cuda.graph(graph, **mode):
                out_carry, outs = self._run(carry, static_in)
        finally:
            if collecting:
                gc.enable()
        if _ptrs(out_carry) != before:
            raise RuntimeError(
                "the captured step hands back other tensors than it was "
                "given: a tensor that crosses steps must be updated in "
                "place, or the graph would replay onto stale ones")
        self._graph, self._static_in, self._static_out = graph, static_in, outs
        self._carry_ptrs = before

    @property
    def static_inputs(self) -> Dict[str, torch.Tensor]:
        """The captured graph's input buffer: a caller that writes each
        superstep's inputs here saves the copy a call makes."""
        return self._static_in
