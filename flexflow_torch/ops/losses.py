"""Loss operators: ``SoftmaxCrossEntropy`` and ``MSELoss``, the port of
``flexflow_tpu/ops/losses.py``.

Every row of the logits goes through the fused cross-entropy kernel K3
(``kernels.softmax_xent``), which has no shape gate on the GPU; on the
CPU its plain version (the JAX op's unfused branch, ``losses.py:112-116``)
runs.  The softmax probabilities are not computed: no op of a training
or eval step reads them (in JAX, XLA removes them as dead code), and in
eager PyTorch they would be an ``(N, V)`` tensor per step.

Under a mesh both losses run on the rank's rows (the ``n`` and ``s``
blocks of the labels), K3 at the local row count with the vocabulary
whole on each rank, as JAX's ``shard_map`` keeps it (``losses.py:60-62``):
the executor gathers ``c``-split logits first.  The rank's mean is
all-reduced over the row axes into the global batch's mean (``mean``
reduction; a sum for ``sum``), and the counts are summed the same way,
so every rank holds the global loss and metrics.
"""

from __future__ import annotations

import torch

from flexflow_torch.ops import kernels
from flexflow_torch.ops.base import Op, TensorSpec
from flexflow_torch.parallel import collectives


class _RowMean(torch.autograd.Function):
    """Row means of ``(N, V)`` logits in f32 with no f32 copy of the
    logits (the reduction widens them as it reads them).  The backward
    is the per-row constant ``g / V`` in the logits' dtype, broadcast as
    a view: autograd adds it to K3's dlogits, so the step holds no other
    ``(N, V)`` tensor.  In bf16 that sum rounds a second time, where the
    JAX op adds both terms in f32 and rounds once."""

    @staticmethod
    def forward(ctx, x):
        ctx.v, ctx.dtype = x.shape[-1], x.dtype
        return x.mean(dim=-1, dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.v).to(ctx.dtype)[:, None].expand(-1, ctx.v)


class _RowLoss(Op):
    """The mesh side of a loss over rows: inputs whole along their last
    dim, the rows split over the labels' ``n``/``s`` axes."""

    is_loss = True

    def input_spec(self, i, frm):
        t = self.inputs[i]
        tags = t.dim_axes
        if t.ndim >= 2 and (i == 0 or self.inputs[0].ndim == t.ndim):
            tags = tags[:-1] + (None,)  # the class (or feature) dim whole
        return self._spec(tags, t.shape)

    def _row_axes(self):
        if self._world is None:
            return ()
        return collectives.axes_of(self.input_spec(1, None))

    def _global(self, loss, correct, total: int, mean: bool):
        """The global batch's ``(loss, correct, total)`` from this rank's
        (one rank: unchanged)."""
        rows = self._row_axes()
        if not rows:
            return loss, correct, total
        parts = self._plan.size(rows)
        loss = collectives.all_reduce(loss, self._world, rows)
        if mean:
            loss = loss * (1.0 / parts)
        return (loss, self._world.all_reduce(correct, rows), total * parts)


class SoftmaxCrossEntropy(_RowLoss):
    """Softmax + cross-entropy against int labels, mean over every
    leading dim, with optional uniform label smoothing."""

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
        """Returns ``((loss, metrics, []), state)``: the loss and the
        metrics ``train_loss``, ``train_correct`` and ``train_all`` stay
        tensors (no host sync per step); no probabilities are returned.

        The logits are read in their own dtype: the kernel widens them
        to f32 in registers, which gives exactly the values of the JAX
        op's f32 cast, and its gradient is rounded once to the logits'
        dtype, as the cast's VJP rounds."""
        logits, labels = xs
        flat = logits.reshape(-1, logits.shape[-1])
        nll, lse, pred = kernels.softmax_xent(
            flat, labels.reshape(-1).to(torch.int32))
        eps = self.attrs["label_smoothing"]
        if eps > 0.0:
            # (1-eps)*nll + eps*(1/V) sum_j -log p_j
            # = (1-eps)*nll + eps*(lse - mean(logits)): exact from row
            # statistics, so it composes with the fused kernel.
            nll = (1.0 - eps) * nll + eps * (lse - _RowMean.apply(flat))
        loss = nll.mean()
        correct = (pred == labels.reshape(-1).to(torch.int32)).sum(
            dtype=torch.int32)
        loss, correct, total = self._global(loss, correct, labels.numel(),
                                            mean=True)
        metrics = {
            "train_loss": loss.detach(),
            "train_correct": correct,
            # A fill, not a host-to-device copy (which would sync).
            "train_all": torch.full((), total, dtype=torch.int32,
                                    device=labels.device),
        }
        return (loss, metrics, []), state


class MSELoss(_RowLoss):
    """Mean-squared error in f32 with the reference's accuracy rule:
    with one column a prediction is correct when ``|pred - label| <
    0.5``, with several when the argmaxes match (``mse_loss.cu:61-125``);
    ``reduction`` is ``mean`` or ``sum``."""

    def __init__(self, name: str, pred: TensorSpec, label: TensorSpec,
                 reduction: str = "mean"):
        super().__init__(name, [pred, label])
        if pred.shape != label.shape:
            raise ValueError(f"{name}: pred {pred.shape} and label "
                             f"{label.shape} differ")
        if reduction not in ("mean", "sum"):
            raise ValueError(f"{name}: reduction must be mean or sum, got "
                             f"{reduction!r}")
        self.reduction = reduction
        self._make_output((), torch.float32, ())

    def forward(self, params, xs, state, training):
        """Returns ``((loss, metrics, [loss]), state)``; every metric
        stays a device tensor."""
        pred, label = (x.float() for x in xs)
        se = (pred - label).square()
        loss = se.mean() if self.reduction == "mean" else se.sum()
        if pred.dim() == 2 and pred.shape[1] == 1:
            correct = ((pred - label).abs() < 0.5).sum(dtype=torch.int32)
            total = pred.shape[0]
        elif pred.dim() == 2:
            correct = (pred.argmax(dim=1) == label.argmax(dim=1)).sum(
                dtype=torch.int32)
            total = pred.shape[0]
        else:
            correct = torch.zeros((), dtype=torch.int32, device=pred.device)
            total = pred.shape[0] if pred.dim() >= 1 else 1
        loss, correct, total = self._global(loss, correct, total,
                                            mean=self.reduction == "mean")
        metrics = {
            "train_loss": loss.detach(),
            "train_correct": correct,
            "train_all": torch.full((), total, dtype=torch.int32,
                                    device=pred.device),
        }
        return (loss, metrics, [loss]), state
