"""Loss operators: ``SoftmaxCrossEntropy`` as a graph node.

The serving path excludes loss ops, so this slice needs the node only so
that ``build_transformer_lm`` builds the same graph as the JAX package.
Its forward belongs to the training slice, which ports the fused
cross-entropy kernel K3 (``pallas_kernels.softmax_xent``); until then it
raises instead of computing a plain cross-entropy.
"""

from __future__ import annotations

from flexflow_torch.ops.base import Op, TensorSpec


class SoftmaxCrossEntropy(Op):
    """Softmax + cross-entropy against int labels, mean over batch."""

    is_loss = True

    def __init__(self, name: str, logits: TensorSpec, labels: TensorSpec,
                 label_smoothing: float = 0.0):
        super().__init__(name, [logits, labels])
        if labels.shape != logits.shape[:-1]:
            raise ValueError(f"labels must be {logits.shape[:-1]}, got "
                             f"{labels.shape}")
        if not 0.0 <= label_smoothing < 1.0:  # also rejects nan
            raise ValueError(f"{name}: label_smoothing must be in [0, 1), "
                             f"got {label_smoothing}")
        self.attrs = dict(label_smoothing=label_smoothing)
        self._make_output(logits.shape, logits.dtype, logits.dim_axes)

    def forward(self, params, xs, state, training):
        raise NotImplementedError(
            f"{self.name}: the softmax cross-entropy forward comes with the "
            f"training slice of the port, which ports the fused kernel K3 "
            f"(ROADMAP.md queue 1, item 2; queue 2, K3)"
        )
