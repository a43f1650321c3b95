"""The FFModel graph API: the port of ``flexflow_tpu/graph.py``.

Apps call its methods to append ops to ``self.layers``; each method
infers shapes and does no compute.  Op naming (``_unique``) and the
dtype rules match the JAX package, so the two packages make graphs with
the same op names, parameter keys and shapes, and ``summary()`` prints
the JAX package's text for the same graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.ops import (
    Add,
    BatchNorm,
    Concat,
    Conv2D,
    DotInteraction,
    Dropout,
    Embedding,
    Flat,
    HeteroEmbedding,
    LSTM,
    LayerNorm,
    Linear,
    MSELoss,
    MixtureOfExperts,
    MultiEmbedding,
    MultiHeadAttention,
    Op,
    Pool2D,
    PositionEmbedding,
    Reshape,
    SoftmaxCrossEntropy,
    TensorSpec,
    WordEmbedding,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name (or a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; the port computes in "
                         f"{sorted(_DTYPES)}") from None


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.layers: List[Op] = []
        self.input_tensors: List[TensorSpec] = []
        self._name_counts: Dict[str, int] = {}

    # -- naming -----------------------------------------------------------

    def _unique(self, base: str, name: Optional[str]) -> str:
        existing = {op.name for op in self.layers} | {
            t.name for t in self.input_tensors}
        if name is not None:
            if name in existing:
                raise ValueError(f"duplicate op name {name!r}")
            return name
        while True:
            i = self._name_counts.get(base, 0)
            self._name_counts[base] = i + 1
            candidate = f"{base}{i}"
            if candidate not in existing:
                return candidate

    def _add(self, op: Op) -> TensorSpec:
        self.layers.append(op)
        return op.outputs[0]

    # -- inputs -----------------------------------------------------------

    def create_tensor(
        self,
        shape: Sequence[int],
        dtype=None,
        name: Optional[str] = None,
        dim_axes: Optional[Sequence[Optional[str]]] = None,
    ) -> TensorSpec:
        """Declare an input placeholder.  Default dtype is
        ``config.compute_dtype``; default tags put the batch on dim 0."""
        dtype = torch_dtype(self.config.compute_dtype if dtype is None
                            else dtype)
        shape = tuple(shape)
        if dim_axes is None:
            if len(shape) == 4:
                dim_axes = ("n", "h", "w", "c")
            else:
                dim_axes = ("n",) + tuple(None for _ in shape[1:])
        t = TensorSpec(name=self._unique("input", name), shape=shape,
                       dtype=dtype, dim_axes=tuple(dim_axes), producer=None)
        self.input_tensors.append(t)
        return t

    # -- ops --------------------------------------------------------------

    def conv2d(self, x: TensorSpec, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation: Optional[str] = None,
               use_bias: bool = True, name: Optional[str] = None,
               **kw) -> TensorSpec:
        return self._add(Conv2D(
            self._unique("conv2d", name), x, out_channels, kernel_h, kernel_w,
            stride_h, stride_w, padding_h, padding_w, activation=activation,
            use_bias=use_bias, **kw))

    def pool2d(self, x: TensorSpec, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: str = "max", activation: Optional[str] = None,
               name: Optional[str] = None) -> TensorSpec:
        return self._add(Pool2D(
            self._unique("pool2d", name), x, kernel_h, kernel_w, stride_h,
            stride_w, padding_h, padding_w, pool_type=pool_type,
            activation=activation))

    def batch_norm(self, x: TensorSpec, relu: bool = False,
                   name: Optional[str] = None) -> TensorSpec:
        """Batch normalization over (n, h, w) with running statistics as
        op state (``ops/norm.py``)."""
        return self._add(BatchNorm(self._unique("batchnorm", name), x,
                                   relu=relu))

    def flat(self, x: TensorSpec, name: Optional[str] = None) -> TensorSpec:
        return self._add(Flat(self._unique("flat", name), x))

    def dense(self, x: TensorSpec, out_dim: int,
              activation: Optional[str] = None, use_bias: bool = True,
              name: Optional[str] = None, **kw) -> TensorSpec:
        return self._add(Linear(self._unique("dense", name), x, out_dim,
                                activation=activation, use_bias=use_bias, **kw))

    def _embedding_dtypes(self, kw) -> None:
        """Activations follow ``compute_dtype``; the TABLE stays f32
        while sparse embedding updates are enabled (the JAX package's
        rule, kept so the parameter dtypes match)."""
        out = torch_dtype(self.config.compute_dtype)
        kw.setdefault("out_dtype", out)
        kw.setdefault(
            "dtype",
            torch.float32 if self.config.sparse_embedding_updates else out,
        )

    def embedding(self, x: TensorSpec, num_entries: int, out_dim: int,
                  aggr: str = "sum", name: Optional[str] = None,
                  **kw) -> TensorSpec:
        """Single-table lookup with bag sum/avg, (batch, bag) -> (batch,
        dim); ``--shard-embeddings`` (``shard_rows``) range-shards its rows
        over the op's ``c`` axes."""
        self._embedding_dtypes(kw)
        kw.setdefault("shard_rows", self.config.shard_embeddings)
        return self._add(Embedding(self._unique("embedding", name), x,
                                   num_entries, out_dim, aggr=aggr, **kw))

    def multi_embedding(self, x: TensorSpec, num_tables: int,
                        num_entries: int, out_dim: int,
                        name: Optional[str] = None, **kw) -> TensorSpec:
        """T same-vocabulary tables stacked, (batch, T) -> (batch, T, dim)."""
        self._embedding_dtypes(kw)
        return self._add(MultiEmbedding(self._unique("embeddings", name), x,
                                        num_tables, num_entries, out_dim, **kw))

    def hetero_embedding(self, x: TensorSpec, vocab_sizes, out_dim: int,
                         name: Optional[str] = None, **kw) -> TensorSpec:
        """T different-vocabulary tables concatenated by rows."""
        self._embedding_dtypes(kw)
        return self._add(HeteroEmbedding(self._unique("embeddings", name), x,
                                         vocab_sizes, out_dim, **kw))

    def word_embedding(self, x: TensorSpec, num_entries: int, out_dim: int,
                       name: Optional[str] = None, **kw) -> TensorSpec:
        """Token embedding (batch, seq) -> (batch, seq, dim);
        ``--shard-embeddings`` range-shards its rows as :meth:`embedding`'s."""
        self._embedding_dtypes(kw)
        kw.setdefault("shard_rows", self.config.shard_embeddings)
        return self._add(WordEmbedding(self._unique("word_embedding", name),
                                       x, num_entries, out_dim, **kw))

    def lstm(self, x: TensorSpec, hidden_size: int, initial_state=None,
             name: Optional[str] = None, **kw):
        """LSTM over (batch, seq, features); returns ``(y, hT, cT)``."""
        op = LSTM(self._unique("lstm", name), x, hidden_size,
                  initial_state=initial_state, **kw)
        self.layers.append(op)
        return op.outputs[0], op.outputs[1], op.outputs[2]

    def dropout(self, x: TensorSpec, rate: float,
                name: Optional[str] = None) -> TensorSpec:
        """Inverted dropout; the identity at eval and at rate 0."""
        return self._add(Dropout(self._unique("dropout", name), x, rate))

    def multihead_attention(self, x: TensorSpec, num_heads: int,
                            causal: bool = True, name: Optional[str] = None,
                            **kw) -> TensorSpec:
        return self._add(MultiHeadAttention(self._unique("attention", name),
                                            x, num_heads, causal=causal, **kw))

    def moe(self, x: TensorSpec, num_experts: int, ffn_dim: int,
            capacity_factor: float = 1.25, name: Optional[str] = None,
            **kw) -> TensorSpec:
        """Mixture-of-experts FFN (``top_k=1`` switch routing by default,
        ``top_k=2`` with renormalized gates; ``ops/moe.py``)."""
        return self._add(MixtureOfExperts(
            self._unique("moe", name), x, num_experts, ffn_dim,
            capacity_factor=capacity_factor, **kw))

    def layer_norm(self, x: TensorSpec, name: Optional[str] = None,
                   **kw) -> TensorSpec:
        return self._add(LayerNorm(self._unique("layernorm", name), x, **kw))

    def position_embedding(self, x: TensorSpec, name: Optional[str] = None,
                           **kw) -> TensorSpec:
        return self._add(PositionEmbedding(self._unique("pos_embedding", name),
                                           x, **kw))

    def add(self, a: TensorSpec, b: TensorSpec,
            name: Optional[str] = None) -> TensorSpec:
        return self._add(Add(self._unique("add", name), a, b))

    def softmax(self, logits: TensorSpec, labels: TensorSpec,
                label_smoothing: float = 0.0,
                name: Optional[str] = None) -> TensorSpec:
        """Fused softmax + cross-entropy loss node (its forward comes with
        the training slice; see ``ops/losses.py``)."""
        return self._add(SoftmaxCrossEntropy(
            self._unique("softmax", name), logits, labels,
            label_smoothing=label_smoothing,
        ))

    def concat(self, inputs: Sequence[TensorSpec], axis: int,
               name: Optional[str] = None) -> TensorSpec:
        return self._add(Concat(self._unique("concat", name), inputs, axis))

    def dot_interaction(self, dense: TensorSpec, sparse: TensorSpec,
                        name: Optional[str] = None) -> TensorSpec:
        """DLRM pairwise-dot interaction."""
        return self._add(DotInteraction(self._unique("interact", name), dense,
                                        sparse))

    def reshape(self, x: TensorSpec, shape: Sequence[int],
                name: Optional[str] = None) -> TensorSpec:
        return self._add(Reshape(self._unique("reshape", name), x, shape))

    def mse_loss(self, pred: TensorSpec, label: TensorSpec,
                 reduction: str = "mean",
                 name: Optional[str] = None) -> TensorSpec:
        return self._add(MSELoss(self._unique("mseloss", name), pred, label,
                                 reduction))

    # -- introspection ----------------------------------------------------

    @property
    def loss_ops(self) -> List[Op]:
        return [op for op in self.layers if op.is_loss]

    def find_op(self, name: str) -> Op:
        for op in self.layers:
            if op.name == name:
                return op
        raise KeyError(name)

    def summary(self) -> str:
        """One line per input and per op: class name, op name and output
        shapes, the JAX package's format."""
        lines = [f"input   {t.name:24s} {t.shape}" for t in self.input_tensors]
        for op in self.layers:
            outs = ", ".join(str(o.shape) for o in op.outputs)
            lines.append(f"{type(op).__name__:8s}{op.name:24s} -> {outs}")
        return "\n".join(lines)
