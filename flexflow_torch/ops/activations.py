"""Activation helper: the port of ``flexflow_tpu/ops/activations.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

VALID_ACTIVATIONS = (None, "none", "relu", "sigmoid", "tanh", "gelu")


def check_activation(activation) -> None:
    """Validate at graph-build time (op ctor), not first forward."""
    if activation not in VALID_ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; valid: {VALID_ACTIVATIONS}"
        )


def apply_activation(x, activation):
    if activation is None or activation == "none":
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; torch's default
        # (the exact erf form) would not match the reference.
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")
