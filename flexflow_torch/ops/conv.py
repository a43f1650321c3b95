"""Convolution, pooling and flatten operators: the port of
``flexflow_tpu/ops/conv.py``.

The API tensors are NHWC and the conv kernel is HWIO ``(kh, kw, cin,
cout)``, as in the JAX package, so parameter dicts carry across
unchanged.  Inside an op, ``x.permute(0, 3, 1, 2)`` is a free NCHW view
with channels-last strides, which cuDNN takes without a copy; the
result goes back to NHWC the same way.  The convolutions go to cuDNN
through ``F.conv2d`` and the pools to ``F.max_pool2d`` /
``F.avg_pool2d``, as the JAX package leaves them to XLA's lowerings.

Under a mesh, ``n`` splits the batch; ``h`` and ``w`` split the output
rows and columns, and each rank reads its window's input rows from its
own block plus its neighbours' boundary rows (``collectives.halo_window``:
only those rows move, never the whole input), then runs unpadded along
that dim.  A ``c`` split of ``Conv2D`` splits the output channels (the
kernel's and the bias's ``cout/c``), the input whole along its channels
(through ``copy_to``, as ``Linear`` takes its contraction); a pool keeps
the channel split it is given.  ``Flat`` reads its input split on ``n``
only, so the executor reshards a spatial split away before it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from flexflow_torch.initializers import GlorotUniform, ZeroInitializer
from flexflow_torch.ops.activations import apply_activation, check_activation
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.parallel import collectives


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


class _Windowed(Op):
    """The mesh side shared by the convolution and the pools: the output's
    ``h``/``w`` split, the input's (the same axes where its extent
    divides, else whole), and the windowed input rows."""

    def _spatial(self, in_channel_tag):
        x, y = self.inputs[0], self.outputs[0]
        out = self.output_spec(0)
        tags = ["n", None, None, in_channel_tag]
        want = list(self._spec(tags, x.shape))
        for d in (1, 2):
            parts = self._plan.size(out[d])
            want[d] = out[d] if parts > 1 and x.shape[d] % parts == 0 else ()
        return tuple(want), out

    def _window(self, x, fill):
        """``(x, padding)``: the input rows and columns of this rank's
        output block along each split spatial dim, and the padding the op
        still applies (0 along those dims)."""
        pad = list(self.attrs["padding"])
        if self._world is None:
            return x, tuple(pad)
        want, out = self._spatial(None)
        for d in (1, 2):
            if self._plan.size(out[d]) == 1:
                continue
            k, s, p = (self.attrs[a][d - 1]
                       for a in ("kernel", "stride", "padding"))
            x = collectives.halo_window(
                x, d, self._world, want[d], out[d], self.inputs[0].shape[d],
                self.outputs[0].shape[d], k, s, p, fill)
            pad[d - 1] = 0
        return x, tuple(pad)


class Conv2D(_Windowed):
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

    def input_spec(self, i, frm):
        return self._spatial(None)[0]

    def forward(self, params, xs, state, training):
        (x,) = xs
        padding = self.attrs["padding"]
        if self._world is not None:
            x = collectives.copy_to(x, self._world,
                                    self.param_spec("kernel")[3])
            x, padding = self._window(x, 0.0)
        y = F.conv2d(
            x.permute(0, 3, 1, 2),
            params["kernel"].permute(3, 2, 0, 1),  # HWIO -> OIHW
            params.get("bias") if self.attrs["use_bias"] else None,
            stride=self.attrs["stride"],
            padding=padding,
        )
        y = apply_activation(y, self.attrs["activation"])
        return [y.permute(0, 2, 3, 1)], state


class Pool2D(_Windowed):
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

    def input_spec(self, i, frm):
        return self._spatial("c")[0]

    def forward(self, params, xs, state, training):
        (x,) = xs
        is_max = self.attrs["pool_type"] == "max"
        x, (ph, pw) = self._window(x, float("-inf") if is_max else 0.0)
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

    def input_spec(self, i, frm):
        return self._spec(("n", None, None, None), self.inputs[0].shape)

    def forward(self, params, xs, state, training):
        (x,) = xs
        return [x.reshape(x.shape[0], -1)], state
