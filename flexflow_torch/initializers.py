"""Parameter initializers drawing from an explicit ``torch.Generator``.

The port of ``flexflow_tpu/initializers.py`` (reference:
``include/initializer.h:26-81``).  Values are drawn on the host from a
CPU generator, so one seed gives the same weights on every device, and
then moved by the caller.  They do not reproduce JAX's draws (the two
RNGs never agree): parity tests carry the JAX weights across instead
(``flexflow_torch/weights.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape: Sequence[int],
                 dtype: torch.dtype) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class GlorotUniform(Initializer):
    """Glorot/Xavier uniform: ``scale = sqrt(6/(fan_in+fan_out))``.
    Without explicit fans, dim 0 is fan_out and dim 1 fan_in, trailing
    dims the receptive field (the out-major 2-D linear case)."""

    fan_in: int | None = None
    fan_out: int | None = None

    def __call__(self, gen, shape, dtype):
        shape = tuple(shape)
        fan_in, fan_out = self.fan_in, self.fan_out
        if fan_in is None or fan_out is None:
            if len(shape) >= 2:
                receptive = math.prod(shape[2:])
                fan_in = shape[1] * receptive
                fan_out = shape[0] * receptive
            else:
                fan_in = fan_out = shape[0]
        scale = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (u * (2 * scale) - scale).to(dtype)


@dataclasses.dataclass
class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype):
        return torch.zeros(tuple(shape), dtype=dtype)


@dataclasses.dataclass
class UniformInitializer(Initializer):
    """Uniform in ``[min_val, max_val]``, drawn in one pass in f32."""

    min_val: float = -0.1
    max_val: float = 0.1

    def __call__(self, gen, shape, dtype):
        u = torch.empty(tuple(shape), dtype=torch.float32)
        return u.uniform_(self.min_val, self.max_val, generator=gen).to(dtype)


@dataclasses.dataclass
class NormInitializer(Initializer):
    """Gaussian N(mean, stddev)."""

    mean: float = 0.0
    stddev: float = 1.0

    def __call__(self, gen, shape, dtype):
        z = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (self.mean + self.stddev * z).to(dtype)


@dataclasses.dataclass
class OnesInitializer(Initializer):
    def __call__(self, gen, shape, dtype):
        return torch.ones(tuple(shape), dtype=dtype)


@dataclasses.dataclass
class RngKeyInitializer(Initializer):
    """A fresh threefry key for an op that threads an RNG through its
    state (Dropout): two uint32 words held in an int64 tensor, the form
    ``runtime/keyed_random.py`` takes.  JAX stores its slice of the init
    key stream; the two never agree, so parity tests carry JAX's key
    across (``weights.state_from_numpy``)."""

    def __call__(self, gen, shape, dtype):
        return torch.randint(0, 2 ** 32, tuple(shape), generator=gen,
                             dtype=torch.int64).to(dtype)
