"""Operators of the port (the counterparts of ``flexflow_tpu/ops``)."""

from flexflow_torch.ops.activations import apply_activation, check_activation
from flexflow_torch.ops.attention import LayerNorm, MultiHeadAttention, PositionEmbedding
from flexflow_torch.ops.base import Op, ParamSpec, TensorSpec
from flexflow_torch.ops.embedding import WordEmbedding
from flexflow_torch.ops.linear import Linear
from flexflow_torch.ops.losses import SoftmaxCrossEntropy
from flexflow_torch.ops.tensor_ops import Add

__all__ = [
    "Add", "LayerNorm", "Linear", "MultiHeadAttention", "Op", "ParamSpec",
    "PositionEmbedding", "SoftmaxCrossEntropy", "TensorSpec", "WordEmbedding",
    "apply_activation", "check_activation",
]
