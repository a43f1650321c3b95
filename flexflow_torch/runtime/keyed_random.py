"""JAX's keyed random draws in torch tensor ops: the sampling head of
the serving programs (``flexflow_tpu/runtime/serving.py::_picker``).

The JAX package samples a token as ``jax.random.categorical(
fold_in(fold_in(key(seed), req_id), pos), logits)``: a pure function of
(seed, request, position), so a sampled sequence replays across batch
compositions, superstep boundaries and speculation.  This module
computes the same bits with the same generator, threefry-2x32 (the
partitionable bit layout, ``jax_threefry_partitionable``), so the port
draws the tokens JAX draws.

Every value is an int64 tensor holding a uint32 (masked to 32 bits after
each add and shift): torch has no uint32 arithmetic on every device.
Nothing here uses a ``torch.Generator`` or reads a device value on the
host, so a CUDA graph captures the draw with the step that makes it.

- ``key(seed)``: the key ``(0, seed)`` as a ``(..., 2)`` tensor.
- ``fold_in(k, d)``: ``threefry(k, (0, d))``, elementwise over ``d``.
- ``bits(k, n)``: ``x0 ^ x1`` of ``threefry(k, (0, i))`` for ``i < n``,
  one row of ``n`` per key of ``k``.
- ``uniform``, ``gumbel``, ``categorical``: JAX's float32 transforms of
  those bits (``gumbel`` in its default "low" mode).
- ``split(k, num)``: ``threefry(k, (0, i))`` for ``i < num``, the new
  keys; ``bernoulli(k, p, shape)``: ``uniform < p`` over ``shape`` in
  row-major order (Dropout's masks, ``ops/tensor_ops.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
#: The smallest normal float32, JAX's ``finfo(float32).tiny``.
_TINY = 1.1754943508222875e-38


def _add(a, b):
    return (a + b) & _M32


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds over uint32 values held in int64
    tensors (broadcast together); returns ``(y0, y1)``."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0, x1 = _add(x0, k0), _add(x1, k1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = _add(x0, x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(x1, ks[(i + 2) % 3] + i + 1)
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for ``0 <= seed <
    2**32``: the int64 pair ``(0, seed)``."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"sampling seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` elementwise: ``k`` is ``(..., 2)``
    (broadcast against ``data``), ``data`` integers in ``[0, 2**32)``;
    returns the new keys, ``data.shape + (2,)``."""
    d = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` for each key of ``k``
    (``(..., 2)``), as int64: ``k.shape[:-1] + (n,)``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return y0 ^ y1


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` per key of ``k`` (``(..., 2)``):
    ``k.shape[:-1] + (num, 2)``, key ``i`` being both words of
    ``threefry(k, (0, i))``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def uniform(k: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), float32, minval, maxval)`` per key:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled, and kept at or above ``minval``."""
    f = ((bits(k, n) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    # f32 bounds as host scalars: a host tensor copied in would be a
    # copy a CUDA graph cannot capture.
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min((f - 1.0) * span + lo, lo)


def bernoulli(k: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for one key ``(2,)`` and a
    float ``p``: a bool tensor, ``uniform(k, shape, float32) < p`` with
    the element of flat index ``i`` drawn from counter ``i``."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    return (uniform(k, n) < float(np.float32(p))).reshape(shape)


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(k, (n,), float32)`` per key ("low" mode):
    ``-log(-log(u))`` of a uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(k, n, minval=_TINY)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` per row: the first index
    of the largest ``gumbel + logits`` (f32 logits ``(..., V)``, keys
    ``(..., 2)``); int64."""
    return torch.argmax(gumbel(k, logits.shape[-1]) + logits, dim=-1)
