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
from flexflow_torch.ops.moe import MixtureOfExperts
from flexflow_torch.ops.norm import BatchNorm
from flexflow_torch.ops.rnn import LSTM
from flexflow_torch.ops.tensor_ops import (
    Add,
    Concat,
    DotInteraction,
    Dropout,
    Reshape,
)

__all__ = [
    "Add", "BatchNorm", "Concat", "Conv2D", "DotInteraction", "Dropout",
    "Embedding", "Flat", "HeteroEmbedding", "LSTM", "LayerNorm", "Linear",
    "MSELoss", "MixtureOfExperts", "MultiEmbedding",
    "MultiHeadAttention", "Op", "ParamSpec", "Pool2D", "PositionEmbedding",
    "Reshape", "SoftmaxCrossEntropy",
    "TensorSpec", "WordEmbedding", "apply_activation", "check_activation",
]
