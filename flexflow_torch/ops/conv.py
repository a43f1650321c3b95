"""Convolution, pooling and flatten operators: the single-device path of
``flexflow_tpu/ops/conv.py``.

The API tensors are NHWC and the conv kernel is HWIO ``(kh, kw, cin,
cout)``, as in the JAX package, so parameter dicts carry across
unchanged.  Inside an op, ``x.permute(0, 3, 1, 2)`` is a free NCHW view
with channels-last strides, which cuDNN takes without a copy; the
result goes back to NHWC the same way.  The convolutions go to cuDNN
through ``F.conv2d`` and the pools to ``F.max_pool2d`` /
``F.avg_pool2d``, as the JAX package leaves them to XLA's lowerings.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from flexflow_torch.initializers import GlorotUniform, ZeroInitializer
from flexflow_torch.ops.activations import apply_activation, check_activation
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec


def time_conv_plans(device) -> None:
    """On a CUDA ``device``, have cuDNN time its candidate algorithms at
    each convolution shape's first call and keep the fastest, as XLA
    autotunes its convolutions (``torch.backends.cudnn.benchmark``, a
    process-wide setting).  The apps and the bench entry call this; the
    ops and the executor leave the setting to their caller."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.benchmark = True


def _out_hw(h: int, w: int, k, s, p):
    return (1 + (h + 2 * p[0] - k[0]) // s[0],
            1 + (w + 2 * p[1] - k[1]) // s[1])


def _check_nhwc(x: TensorSpec, what: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{what} input must be NHWC, got {x.shape}")


class Conv2D(Op):
    """2-D convolution, plus bias and a fused activation."""

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        out_channels: int,
        kernel_h: int,
        kernel_w: int,
        stride_h: int,
        stride_w: int,
        padding_h: int,
        padding_w: int,
        activation: Optional[str] = None,
        use_bias: bool = True,
        kernel_initializer=None,
        bias_initializer=None,
    ):
        super().__init__(name, [x])
        _check_nhwc(x, "conv2d")
        check_activation(activation)
        n, h, w, cin = x.shape
        self.attrs = dict(
            out_channels=out_channels,
            kernel=(kernel_h, kernel_w),
            stride=(stride_h, stride_w),
            padding=(padding_h, padding_w),
            activation=activation,
            use_bias=use_bias,
        )
        self.in_channels = cin
        # HWIO: the fans are explicit, the kernel's dims 0 and 1 are not
        # (out, in) as GlorotUniform's default assumes.
        self.kernel_initializer = kernel_initializer or GlorotUniform(
            fan_in=kernel_h * kernel_w * cin,
            fan_out=kernel_h * kernel_w * out_channels,
        )
        self.bias_initializer = bias_initializer or ZeroInitializer()
        out_h, out_w = _out_hw(h, w, self.attrs["kernel"],
                               self.attrs["stride"], self.attrs["padding"])
        self._make_output((n, out_h, out_w, out_channels), x.dtype,
                          ("n", "h", "w", "c"))

    def param_specs(self) -> Dict[str, ParamSpec]:
        kh, kw = self.attrs["kernel"]
        cout = self.attrs["out_channels"]
        dtype = self.outputs[0].dtype
        specs = {
            "kernel": ParamSpec((kh, kw, self.in_channels, cout), dtype,
                                self.kernel_initializer, (None, None, None, "c"))
        }
        if self.attrs["use_bias"]:
            specs["bias"] = ParamSpec((cout,), dtype, self.bias_initializer,
                                      ("c",))
        return specs

    def forward(self, params, xs, state, training):
        (x,) = xs
        y = F.conv2d(
            x.permute(0, 3, 1, 2),
            params["kernel"].permute(3, 2, 0, 1),  # HWIO -> OIHW
            params.get("bias") if self.attrs["use_bias"] else None,
            stride=self.attrs["stride"],
            padding=self.attrs["padding"],
        )
        y = apply_activation(y, self.attrs["activation"])
        return [y.permute(0, 2, 3, 1)], state


class Pool2D(Op):
    """Max or average pooling.  Max pooling pads with -inf; average
    pooling divides by ``kh * kw``, the padding counted (cuDNN's
    ``AVG_COUNT_INCLUDE_PADDING``, the JAX op's rule).  The padding is
    applied explicitly, so any padding the JAX op takes works here too
    (PyTorch's pools take at most half the window)."""

    def __init__(
        self,
        name: str,
        x: TensorSpec,
        kernel_h: int,
        kernel_w: int,
        stride_h: int,
        stride_w: int,
        padding_h: int,
        padding_w: int,
        pool_type: str = "max",
        activation: Optional[str] = None,
    ):
        super().__init__(name, [x])
        _check_nhwc(x, "pool2d")
        if pool_type not in ("max", "avg"):
            raise ValueError(f"pool_type must be 'max' or 'avg', got "
                             f"{pool_type!r}")
        check_activation(activation)
        n, h, w, c = x.shape
        self.attrs = dict(
            kernel=(kernel_h, kernel_w),
            stride=(stride_h, stride_w),
            padding=(padding_h, padding_w),
            pool_type=pool_type,
            activation=activation,
        )
        out_h, out_w = _out_hw(h, w, self.attrs["kernel"],
                               self.attrs["stride"], self.attrs["padding"])
        self._make_output((n, out_h, out_w, c), x.dtype, ("n", "h", "w", "c"))

    def forward(self, params, xs, state, training):
        (x,) = xs
        ph, pw = self.attrs["padding"]
        is_max = self.attrs["pool_type"] == "max"
        y = x.permute(0, 3, 1, 2)
        if ph or pw:
            y = F.pad(y, (pw, pw, ph, ph),
                      value=float("-inf") if is_max else 0.0)
        pool = F.max_pool2d if is_max else F.avg_pool2d
        y = pool(y, self.attrs["kernel"], self.attrs["stride"])
        y = apply_activation(y, self.attrs["activation"])
        return [y.permute(0, 2, 3, 1)], state


class Flat(Op):
    """Flatten NHWC to ``(N, H*W*C)`` in (h, w, c) order, the order the
    following linear's weights expect."""

    def __init__(self, name: str, x: TensorSpec):
        super().__init__(name, [x])
        _check_nhwc(x, "flat")
        n, h, w, c = x.shape
        self._make_output((n, h * w * c), x.dtype, ("n", None))

    def forward(self, params, xs, state, training):
        (x,) = xs
        return [x.reshape(x.shape[0], -1)], state
