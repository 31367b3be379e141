"""Softmax cross-entropy with label smoothing (counterpart of
``apex_tpu.contrib.xentropy.softmax_xentropy``).

Per row, for ``[N, V]`` logits and ``[N]`` labels::

    loss = (1 - smoothing) * nll + smoothing * smooth_loss
    nll         = -logprob[label]
    smooth_loss = -mean_v(logprob)

with rows whose ``label == padding_idx`` zeroed, forward and backward, in
fp32 whatever the logits' dtype.  :class:`_SoftmaxXentropy` saves the
logits, one fp32 log-sum-exp a row and the labels (never an ``[N, V]``
softmax); the backward recomputes ``softmax = exp(logits - lse)``.
"""

from __future__ import annotations

import torch

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]


def _safe_labels(labels, padding_idx):
    """Labels that index a row: padding rows (zeroed anyway) read column 0,
    so a negative ``padding_idx`` gathers nothing out of range."""
    return torch.where(labels == padding_idx, 0, labels).to(torch.int64)


class _SoftmaxXentropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx):
        x32 = logits.float()
        lse = torch.logsumexp(x32, dim=-1)                          # [N]
        lab = _safe_labels(labels, padding_idx)
        nll = lse - x32.gather(-1, lab[:, None])[:, 0]
        smooth = lse - x32.mean(-1)
        del x32
        loss = (1.0 - smoothing) * nll + smoothing * smooth
        loss = torch.where(labels == padding_idx, 0.0, loss)
        ctx.save_for_backward(logits, lse, labels)
        ctx.smoothing, ctx.padding_idx = smoothing, padding_idx
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        logits, lse, labels = ctx.saved_tensors
        s = ctx.smoothing
        vocab = logits.shape[-1]
        # d/dx [(1-s) nll + s smooth] = softmax - (1-s) onehot - s/V, in
        # that order
        d = torch.exp(logits.float() - lse[:, None])
        lab = _safe_labels(labels, ctx.padding_idx)
        d.scatter_add_(-1, lab[:, None], torch.full(
            (d.shape[0], 1), -(1.0 - s), dtype=d.dtype, device=d.device))
        d.sub_(s / vocab)
        g = torch.where(labels == ctx.padding_idx, 0.0, grad_loss.float())
        d.mul_(g[:, None])
        return d.to(logits.dtype), None, None, None


def softmax_cross_entropy_loss(logits, labels, smoothing=0.0, padding_idx=0):
    """Per-row smoothed CE: ``[N]`` fp32 losses for ``[N, V]`` logits and
    ``[N]`` int labels."""
    return _SoftmaxXentropy.apply(logits, labels, float(smoothing),
                                  int(padding_idx))


class SoftmaxCrossEntropyLoss:
    """Function-object form matching the reference's ``.apply`` call
    style."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        """Label-smoothed softmax cross-entropy per token; ``padding_idx``
        rows get zero loss.  ``half_to_float`` is accepted for API parity:
        the losses are always fp32."""
        del half_to_float
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx)
