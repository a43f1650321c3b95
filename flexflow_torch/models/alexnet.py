"""AlexNet: the port of ``flexflow_tpu/models/alexnet.py::build_alexnet``.

The reference's op list (``alexnet.cc:3-19``) with the JAX package's op
names: conv1..conv5 with fused ReLU, three max pools, flat, three
linears (the last without an activation) and the fused softmax
cross-entropy.  The input is an NHWC RGB image (229 x 229 by default),
the labels int32.  At 229 the spatial sizes run 56, 27, 27, 13, 13, 6,
so ``flat`` has 9216 features.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel


def build_alexnet(
    batch_size: int = 64,
    image_size: int = 229,
    num_classes: int = 1000,
    dtype=None,
    config: Optional[FFConfig] = None,
) -> FFModel:
    """``dtype=None`` follows ``config.compute_dtype``."""
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    img = ff.create_tensor((batch_size, image_size, image_size, 3),
                           dtype=dtype, name="image")
    label = ff.create_tensor((batch_size,), dtype=torch.int32, name="label")
    t = ff.conv2d(img, 64, 11, 11, 4, 4, 2, 2, activation="relu", name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu", name="conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool2")
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu", name="conv3")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu", name="conv4")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu", name="conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool3")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 4096, activation="relu", name="linear1")
    t = ff.dense(t, 4096, activation="relu", name="linear2")
    t = ff.dense(t, num_classes, activation=None, name="linear3")
    ff.softmax(t, label, name="softmax")
    return ff
