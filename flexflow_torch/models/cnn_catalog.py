"""The CNN catalog: the port of ``flexflow_tpu/models/cnn_catalog.py``
(reference ``cnn.cc:130-281`` and ``inception.h:18-132``): VGG-16,
Inception-v3, DenseNet-121 and ResNet-101, the networks the ICML'18
strategies were searched over.

The same op sequence, op names and shapes as the JAX package: convs with
fused ReLU as the reference's ``add_conv_layer`` builds them, concat
along NHWC's channel axis, DenseNet's BatchNorms (``ops/norm.py``), and
ResNet-101's bottleneck taken literally from the reference (no residual
add and no BatchNorm), since the JAX package is the oracle.  The 1x7 and
7x1 convolutions with asymmetric padding go through ``ops/conv.py``'s
``Conv2D`` (cuDNN on the card); the loss is the fused cross-entropy K3.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.ops.base import TensorSpec

CH_AXIS = 3  # NHWC channel axis


def _head(ff: FFModel, t: TensorSpec, label: TensorSpec, num_classes: int):
    t = ff.flat(t, name="flat")
    t = ff.dense(t, num_classes, activation=None, name="linear_out")
    ff.softmax(t, label, name="softmax")


def build_vgg16(batch_size: int = 64, image_size: int = 224,
                num_classes: int = 1000, config: Optional[FFConfig] = None) -> FFModel:
    """VGG-16 (``cnn.cc:166-190``)."""
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    t = ff.create_tensor((batch_size, image_size, image_size, 3), name="image")
    label = ff.create_tensor((batch_size,), dtype=torch.int32, name="label")
    plan = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    for b, (ch, reps) in enumerate(plan):
        for r in range(reps):
            t = ff.conv2d(t, ch, 3, 3, 1, 1, 1, 1, activation="relu",
                          name=f"conv{b}_{r}")
        t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name=f"pool{b}")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 4096, activation="relu", name="linear1")
    t = ff.dense(t, 4096, activation="relu", name="linear2")
    t = ff.dense(t, num_classes, activation=None, name="linear3")
    ff.softmax(t, label, name="softmax")
    return ff


# ---- Inception-V3 (inception.h:18-100, cnn.cc:193-216) -----------------


def _inception_a(ff, x, pool_features, tag):
    t1 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b1")
    t2 = ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b2a")
    t2 = ff.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, activation="relu", name=f"{tag}_b2b")
    t3 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b3a")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation="relu", name=f"{tag}_b3b")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation="relu", name=f"{tag}_b3c")
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{tag}_pool")
    t4 = ff.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, activation="relu",
                   name=f"{tag}_b4")
    return ff.concat([t1, t2, t3, t4], axis=CH_AXIS, name=f"{tag}_cat")


def _inception_b(ff, x, tag):
    t1 = ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0, activation="relu", name=f"{tag}_b1")
    t2 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b2a")
    t2 = ff.conv2d(t2, 96, 3, 3, 1, 1, 1, 1, activation="relu", name=f"{tag}_b2b")
    t2 = ff.conv2d(t2, 96, 3, 3, 2, 2, 0, 0, activation="relu", name=f"{tag}_b2c")
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0, name=f"{tag}_pool")
    return ff.concat([t1, t2, t3], axis=CH_AXIS, name=f"{tag}_cat")


def _inception_c(ff, x, ch, tag):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b1")
    t2 = ff.conv2d(x, ch, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b2a")
    t2 = ff.conv2d(t2, ch, 1, 7, 1, 1, 0, 3, activation="relu", name=f"{tag}_b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, activation="relu", name=f"{tag}_b2c")
    t3 = ff.conv2d(x, ch, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b3a")
    t3 = ff.conv2d(t3, ch, 7, 1, 1, 1, 3, 0, activation="relu", name=f"{tag}_b3b")
    t3 = ff.conv2d(t3, ch, 1, 7, 1, 1, 0, 3, activation="relu", name=f"{tag}_b3c")
    t3 = ff.conv2d(t3, ch, 7, 1, 1, 1, 3, 0, activation="relu", name=f"{tag}_b3d")
    t3 = ff.conv2d(t3, 192, 1, 7, 1, 1, 0, 3, activation="relu", name=f"{tag}_b3e")
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{tag}_pool")
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b4")
    return ff.concat([t1, t2, t3, t4], axis=CH_AXIS, name=f"{tag}_cat")


def _inception_d(ff, x, tag):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b1a")
    t1 = ff.conv2d(t1, 320, 3, 3, 2, 2, 0, 0, activation="relu", name=f"{tag}_b1b")
    t2 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b2a")
    t2 = ff.conv2d(t2, 192, 1, 7, 1, 1, 0, 3, activation="relu", name=f"{tag}_b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, activation="relu", name=f"{tag}_b2c")
    t2 = ff.conv2d(t2, 192, 3, 3, 2, 2, 0, 0, activation="relu", name=f"{tag}_b2d")
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0, name=f"{tag}_pool")
    return ff.concat([t1, t2, t3], axis=CH_AXIS, name=f"{tag}_cat")


def _inception_e(ff, x, tag):
    t1 = ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b1")
    t2i = ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b2i")
    t2 = ff.conv2d(t2i, 384, 1, 3, 1, 1, 0, 1, activation="relu", name=f"{tag}_b2a")
    t3 = ff.conv2d(t2i, 384, 3, 1, 1, 1, 1, 0, activation="relu", name=f"{tag}_b2b")
    t3i = ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b3i")
    t3i = ff.conv2d(t3i, 384, 3, 3, 1, 1, 1, 1, activation="relu", name=f"{tag}_b3j")
    t4 = ff.conv2d(t3i, 384, 1, 3, 1, 1, 0, 1, activation="relu", name=f"{tag}_b3a")
    t5 = ff.conv2d(t3i, 384, 3, 1, 1, 1, 1, 0, activation="relu", name=f"{tag}_b3b")
    t6 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{tag}_pool")
    t6 = ff.conv2d(t6, 192, 1, 1, 1, 1, 0, 0, activation="relu", name=f"{tag}_b4")
    return ff.concat([t1, t2, t3, t4, t5, t6], axis=CH_AXIS, name=f"{tag}_cat")


def build_inception_v3(batch_size: int = 64, image_size: int = 299,
                       num_classes: int = 1000,
                       config: Optional[FFConfig] = None) -> FFModel:
    """Inception-V3 (``cnn.cc:193-216``)."""
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    t = ff.create_tensor((batch_size, image_size, image_size, 3), name="image")
    label = ff.create_tensor((batch_size,), dtype=torch.int32, name="label")
    t = ff.conv2d(t, 32, 3, 3, 2, 2, 0, 0, activation="relu", name="stem1")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, activation="relu", name="stem2")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu", name="stem3")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="stem_pool1")
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, activation="relu", name="stem4")
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, activation="relu", name="stem5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="stem_pool2")
    t = _inception_a(ff, t, 32, "a1")
    t = _inception_a(ff, t, 64, "a2")
    t = _inception_a(ff, t, 64, "a3")
    t = _inception_b(ff, t, "b1")
    t = _inception_c(ff, t, 128, "c1")
    t = _inception_c(ff, t, 160, "c2")
    t = _inception_c(ff, t, 160, "c3")
    t = _inception_c(ff, t, 192, "c4")
    t = _inception_d(ff, t, "d1")
    t = _inception_e(ff, t, "e1")
    t = _inception_e(ff, t, "e2")
    hw = t.shape[1]
    t = ff.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg", name="avgpool")
    _head(ff, t, label, num_classes)
    return ff


def build_densenet121(batch_size: int = 64, image_size: int = 224,
                      num_classes: int = 1000,
                      config: Optional[FFConfig] = None) -> FFModel:
    """DenseNet-121 (``cnn.cc:219-239``; blocks ``inception.h:102-121``)."""
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    t = ff.create_tensor((batch_size, image_size, image_size, 3), name="image")
    label = ff.create_tensor((batch_size,), dtype=torch.int32, name="label")
    t = ff.conv2d(t, 64, 7, 7, 2, 2, 3, 3, activation=None, name="stem_conv")
    t = ff.batch_norm(t, relu=True, name="stem_bn")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")

    def dense_block(t, num_layers, growth, tag):
        last = t
        for i in range(num_layers):
            u = ff.batch_norm(last, relu=True, name=f"{tag}_l{i}_bn1")
            u = ff.conv2d(u, 4 * growth, 1, 1, 1, 1, 0, 0, activation=None,
                          name=f"{tag}_l{i}_conv1")
            u = ff.batch_norm(u, relu=True, name=f"{tag}_l{i}_bn2")
            u = ff.conv2d(u, growth, 3, 3, 1, 1, 1, 1, activation=None,
                          name=f"{tag}_l{i}_conv2")
            last = ff.concat([last, u], axis=CH_AXIS, name=f"{tag}_l{i}_cat")
        return last

    def transition(t, out_size, tag):
        t = ff.conv2d(t, out_size, 1, 1, 1, 1, 0, 0, activation="relu",
                      name=f"{tag}_conv")
        return ff.pool2d(t, 2, 2, 2, 2, 0, 0, pool_type="avg", name=f"{tag}_pool")

    num_features = 64
    t = dense_block(t, 6, 32, "db1")
    num_features = (num_features + 32 * 6) // 2
    t = transition(t, num_features, "tr1")
    t = dense_block(t, 12, 32, "db2")
    num_features = (num_features + 32 * 12) // 2
    t = transition(t, num_features, "tr2")
    t = dense_block(t, 24, 32, "db3")
    num_features = (num_features + 32 * 24) // 2
    t = transition(t, num_features, "tr3")
    t = dense_block(t, 16, 32, "db4")
    hw = t.shape[1]
    t = ff.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg", name="avgpool")
    _head(ff, t, label, num_classes)
    return ff


def build_resnet101(batch_size: int = 64, image_size: int = 224,
                    num_classes: int = 1000,
                    config: Optional[FFConfig] = None) -> FFModel:
    """ResNet-101 bottleneck stack (``cnn.cc:242-262``;
    ``BottleneckBlock`` ``inception.h:123-132``).  Note the reference's
    bottleneck has no residual add (commented-out BNs, no skip) — we
    keep its literal op sequence for parity."""
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    t = ff.create_tensor((batch_size, image_size, image_size, 3), name="image")
    label = ff.create_tensor((batch_size,), dtype=torch.int32, name="label")
    t = ff.conv2d(t, 64, 7, 7, 2, 2, 3, 3, activation="relu", name="stem_conv")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")

    def bottleneck(t, out_ch, bn_ch, stride, tag):
        t = ff.conv2d(t, bn_ch, 1, 1, 1, 1, 0, 0, activation="relu",
                      name=f"{tag}_c1")
        t = ff.conv2d(t, bn_ch, 3, 3, stride, stride, 1, 1, activation="relu",
                      name=f"{tag}_c2")
        return ff.conv2d(t, out_ch, 1, 1, 1, 1, 0, 0, activation="relu",
                         name=f"{tag}_c3")

    for i in range(3):
        t = bottleneck(t, 256, 64, 1, f"s1_b{i}")
    for i in range(4):
        t = bottleneck(t, 512, 128, 2 if i == 0 else 1, f"s2_b{i}")
    for i in range(23):
        t = bottleneck(t, 1024, 256, 2 if i == 0 else 1, f"s3_b{i}")
    for i in range(3):
        t = bottleneck(t, 2048, 512, 2 if i == 0 else 1, f"s4_b{i}")
    hw = t.shape[1]
    t = ff.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg", name="avgpool")
    _head(ff, t, label, num_classes)
    return ff
