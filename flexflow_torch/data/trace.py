"""The production-trace source: the port of
``flexflow_tpu/data/trace.py``, draw for draw.

Recommendation traffic differs from uniform synthetic arrays in two
ways: embedding ids follow a power law (a few hot ids dominate every
lookup), and input arrives in bursts.  :class:`ProductionTraceSource`
draws each table's ids from a Zipf(alpha) clamped into the vocab (the
head of the distribution exact, the tail collapsed onto the last id)
and can stall every ``burst_every``-th read for ``burst_s``.  Rows are
generated in blocks as ``SyntheticStreamSource``'s are (block ``b``
seeds ``default_rng([seed, b])``), so a read reproduces at any chunk
boundary and both packages read the same rows from one seed.

Its reader here is the serving workload
(``serving/workload.py::production_workload``, ``apps.serve
--workload-trace prod``).  The DLRM app's ``--prod-trace`` and the
streaming loader come with ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from flexflow_torch.data.stream import StreamSource, read_blocks

__all__ = ["ProductionTraceSource"]

_KEYS = ("dense_input", "label", "sparse_input")


class ProductionTraceSource(StreamSource):
    """DLRM-shaped rows with power-law ids and bursty reads:
    ``dense_input`` (float32, ``(rows, dense_dim)``), ``label`` (float32,
    ``(rows, 1)``, Bernoulli ``ctr``) and ``sparse_input`` (int32,
    ``(rows, len(vocab_sizes))``)."""

    def __init__(self, num_samples: int, dense_dim: int,
                 vocab_sizes: List[int], alpha: float = 1.2,
                 seed: int = 0, ctr: float = 0.25,
                 burst_every: int = 0, burst_s: float = 0.0,
                 block: int = 4096):
        if alpha <= 1.0:
            raise ValueError(f"zipf alpha must be > 1.0, got {alpha}")
        self.num_samples = int(num_samples)
        self.dense_dim = int(dense_dim)
        self.vocab_sizes = [int(v) for v in vocab_sizes]
        self.alpha = float(alpha)
        self.seed = int(seed)
        self.ctr = float(ctr)
        self.burst_every = int(burst_every)
        self.burst_s = float(burst_s)
        self.block = int(block)
        self._reads = 0

    def specs(self):
        return {
            "dense_input": ((self.dense_dim,), np.dtype(np.float32)),
            "label": ((1,), np.dtype(np.float32)),
            "sparse_input": ((len(self.vocab_sizes),), np.dtype(np.int32)),
        }

    def _gen_block(self, b: int) -> Dict[str, np.ndarray]:
        lo = b * self.block
        rows = min(self.block, self.num_samples - lo)
        rng = np.random.default_rng([self.seed, b])
        dense = rng.standard_normal((rows, self.dense_dim)).astype(np.float32)
        label = (rng.random((rows, 1)) < self.ctr).astype(np.float32)
        cols = []
        for vocab in self.vocab_sizes:
            ids = np.minimum(rng.zipf(self.alpha, size=rows), vocab) - 1
            cols.append(ids.astype(np.int32))
        sparse = np.stack(cols, axis=1)
        return {"dense_input": dense, "label": label, "sparse_input": sparse}

    def read(self, start: int, stop: int) -> Dict[str, np.ndarray]:
        self._reads += 1
        if self.burst_every > 0 and self.burst_s > 0 \
                and self._reads % self.burst_every == 0:
            time.sleep(self.burst_s)
        return read_blocks(self._gen_block, self.block, self.num_samples,
                           _KEYS, start, stop)
