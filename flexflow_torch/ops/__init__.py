"""Operators of the port (the counterparts of ``flexflow_tpu/ops``)."""

from flexflow_torch.ops.activations import apply_activation, check_activation
from flexflow_torch.ops.attention import LayerNorm, MultiHeadAttention, PositionEmbedding
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.ops.conv import Conv2D, Flat, Pool2D
from flexflow_torch.ops.embedding import (
    Embedding,
    HeteroEmbedding,
    MultiEmbedding,
    WordEmbedding,
)
from flexflow_torch.ops.linear import Linear
from flexflow_torch.ops.losses import MSELoss, SoftmaxCrossEntropy
from flexflow_torch.ops.tensor_ops import Add, Concat, DotInteraction, Reshape

__all__ = [
    "Add", "Concat", "Conv2D", "DotInteraction", "Embedding", "Flat",
    "HeteroEmbedding", "LayerNorm", "Linear", "MSELoss", "MultiEmbedding",
    "MultiHeadAttention", "Op", "ParamSpec", "Pool2D", "PositionEmbedding",
    "Reshape", "SoftmaxCrossEntropy",
    "TensorSpec", "WordEmbedding", "apply_activation", "check_activation",
]
