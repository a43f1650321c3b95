"""Chunked row sources of the streaming data plane: the port of the
source half of ``flexflow_tpu/data/stream.py``.

A :class:`StreamSource` serves contiguous row ranges (``read(start,
stop)``) as fresh host numpy arrays, and a read is deterministic: the
same range always returns the same bytes.  Here: the protocol, the
in-memory :class:`ArrayStreamSource`, the block-deterministic
:class:`SyntheticStreamSource` (block ``b`` draws from
``np.random.default_rng([seed, b])``, so a row's bytes do not depend on
the chunk boundaries) and :class:`ThrottledSource` (a fixed and a
per-row delay per read, a disk-bound stand-in).  The same draws as the
JAX package's, so both read the same rows from one seed.

The streaming loader (windowed shuffle, reader thread, checkpointed
cursor) and the HDF5 source come with ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "StreamSource",
    "ArrayStreamSource",
    "SyntheticStreamSource",
    "ThrottledSource",
    "StreamReaderError",
]


class StreamReaderError(RuntimeError):
    """A background reader died; raised at the next read of its consumer.
    A ``RuntimeError``, so ``FailurePolicy.recoverable`` takes it."""


class StreamSource:
    """Protocol: a random-access source of contiguous row ranges.

    Implementations give ``num_samples``, ``specs()`` (per key
    ``(row_shape, dtype)``) and ``read(start, stop)``, fresh host arrays
    for rows ``[start, stop)``; the same range always returns the same
    bytes."""

    num_samples: int = 0

    def specs(self) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        raise NotImplementedError

    def read(self, start: int, stop: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ArrayStreamSource(StreamSource):
    """In-memory source over host numpy arrays.  ``read`` copies, like a
    disk read, so a consumer may trim the result in place."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        if not arrays:
            raise ValueError("ArrayStreamSource needs at least one array")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        lengths = {len(v) for v in self.arrays.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged arrays: lengths {sorted(lengths)}")
        self.num_samples = lengths.pop()

    def specs(self):
        return {k: (v.shape[1:], v.dtype) for k, v in self.arrays.items()}

    def read(self, start, stop):
        return {k: np.array(v[start:stop]) for k, v in self.arrays.items()}


def read_blocks(gen_block, block: int, num_samples: int, keys,
                start: int, stop: int) -> Dict[str, np.ndarray]:
    """Rows ``[start, stop)`` of a block-generated source: every block the
    range touches, made by ``gen_block(b)`` and cut to the range."""
    stop = min(stop, num_samples)
    parts: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
    b = start // block
    while b * block < stop:
        blk = gen_block(b)
        lo = max(start - b * block, 0)
        hi = min(stop - b * block, block)
        for k, v in blk.items():
            parts[k].append(v[lo:hi])
        b += 1
    return {k: (p[0] if len(p) == 1 else np.concatenate(p))
            for k, p in parts.items()}


class SyntheticStreamSource(StreamSource):
    """Generated rows with no backing store, in blocks of ``block`` rows:
    block ``b`` draws from ``np.random.default_rng([seed, b])``, so a read
    returns the same bytes for a row at any chunk boundary.  ``specs``
    maps key -> (row_shape, dtype); an integer key draws from ``[0,
    int_high[key])`` (default 2), a float key standard normals."""

    def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                 num_samples: int, seed: int = 0,
                 int_high: Optional[Dict[str, int]] = None,
                 block: int = 4096):
        self._specs = {k: (tuple(s), np.dtype(d)) for k, (s, d) in
                       sorted(specs.items())}
        self.num_samples = int(num_samples)
        self.seed = int(seed)
        self.block = int(block)
        self.int_high = dict(int_high or {})

    def specs(self):
        return dict(self._specs)

    def _gen_block(self, b: int) -> Dict[str, np.ndarray]:
        lo = b * self.block
        rows = min(self.block, self.num_samples - lo)
        rng = np.random.default_rng([self.seed, b])
        out = {}
        for k, (shape, dtype) in self._specs.items():
            size = (rows,) + shape
            if np.issubdtype(dtype, np.integer):
                high = self.int_high.get(k, 2)
                out[k] = rng.integers(0, high, size=size, dtype=dtype)
            else:
                out[k] = rng.standard_normal(size=size).astype(dtype)
        return out

    def read(self, start, stop):
        return read_blocks(self._gen_block, self.block, self.num_samples,
                           self._specs, start, stop)


class ThrottledSource(StreamSource):
    """A source with a delay per read: ``delay_s`` fixed and ``per_row_s``
    per row of the range, to make an input-bound run reproducible."""

    def __init__(self, source: StreamSource, delay_s: float = 0.0,
                 per_row_s: float = 0.0):
        self.source = source
        self.delay_s = float(delay_s)
        self.per_row_s = float(per_row_s)
        self.num_samples = source.num_samples
        self.reads = 0

    def specs(self):
        return self.source.specs()

    def read(self, start, stop):
        self.reads += 1
        pause = self.delay_s + self.per_row_s * max(stop - start, 0)
        if pause > 0:
            time.sleep(pause)
        return self.source.read(start, stop)

    def close(self):
        self.source.close()
