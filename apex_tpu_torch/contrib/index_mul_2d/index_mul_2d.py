"""Gather-multiply ``out[i] = in1[idx[i]] * in2[i]`` (counterpart of
``apex_tpu.contrib.index_mul_2d.index_mul_2d``): 2-D tensors, the index
along dimension 0, with the reference's backward, one scatter-add
(``index_add_``, JAX's ``segment_sum``) into ``grad_in1`` and a
gather-multiply for ``grad_in2``.  On the card ``index_add_`` adds with
atomics, so ``grad_in1``'s rows that several indices share are summed in
no fixed order: their bits may differ between runs.
"""

from __future__ import annotations

import torch

__all__ = ["index_mul_2d"]


def _check(in1, in2, idx1):
    if in1.dim() != 2 or in2.dim() != 2:
        raise ValueError("in1 and in2 must be 2-D")
    if idx1.dim() != 1 or in2.shape[0] != idx1.shape[0]:
        raise ValueError("idx1 must be 1-D with len(idx1) == in2.shape[0]")
    if in1.dtype != in2.dtype:
        raise ValueError("in1 and in2 must share a dtype")


class _IndexMul2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, in1, in2, idx1):
        ctx.save_for_backward(in1, in2, idx1)
        return in1.index_select(0, idx1) * in2

    @staticmethod
    def backward(ctx, g):
        in1, in2, idx1 = ctx.saved_tensors
        grad_in1 = grad_in2 = None
        if ctx.needs_input_grad[0]:
            grad_in1 = torch.zeros_like(in1).index_add_(0, idx1,
                                                        (g * in2).to(in1.dtype))
        if ctx.needs_input_grad[1]:
            grad_in2 = (in1.index_select(0, idx1) * g).to(in2.dtype)
        return grad_in1, grad_in2, None


def index_mul_2d(in1, in2, idx1):
    """``in1 [S, H]``, ``in2 [N, H]``, ``idx1 [N]`` int -> ``[N, H]``."""
    _check(in1, in2, idx1)
    return _IndexMul2d.apply(in1, in2, idx1.to(torch.int64))
