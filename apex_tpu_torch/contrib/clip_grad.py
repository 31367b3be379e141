"""Gradient clipping by global norm (counterpart of
``apex_tpu/contrib/clip_grad.py``, Apex's ``contrib.clip_grad``).

- :func:`clip_grad_norm` is the JAX function: a tree of gradients in, the
  clipped tree (new tensors) and the total norm out.
- :func:`clip_grad_norm_` is Apex's in-place form: the gradients of
  ``parameters`` (a tensor or an iterable of tensors; those without a
  gradient are left out) scaled in place, the total norm returned.

Both keep the JAX semantics: the coefficient is ``max_norm / (total +
1e-6)``, clamped to 1, and 1 where it is not finite; every gradient is
multiplied by it in fp32 and stored in its own dtype.  ``norm_type`` 2 is
one ``mt_l2norm`` over every gradient, then ``mt_scale`` with the
coefficient on the device (:mod:`apex_tpu_torch.ops.multi_tensor`; their
plain versions on the CPU); ``inf`` and other p-norms are plain PyTorch, as
in the JAX function.  Nothing is read on the host, so ``error_if_nonfinite``
cannot raise, as in the JAX function: a non-finite norm is returned and the
loss scaler's skip stays in charge.
"""

from __future__ import annotations

from typing import Any, Iterable, Union

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.utils.packing import tree_leaves, tree_map

__all__ = ["clip_grad_norm", "clip_grad_norm_"]


def _total_norm(leaves, norm_type: float) -> torch.Tensor:
    if norm_type == 2.0:
        return mt.l2norm(leaves).total
    if norm_type == float("inf"):
        return torch.max(torch.stack([torch.max(torch.abs(l.float()))
                                      for l in leaves]))
    p = float(norm_type)
    return torch.pow(sum(torch.sum(torch.pow(torch.abs(l.float()), p))
                         for l in leaves), 1.0 / p)


def _coefficient(total: torch.Tensor, max_norm: float) -> torch.Tensor:
    coef = torch.clamp(float(max_norm) / (total + 1e-6), max=1.0)
    return torch.where(torch.isfinite(coef), coef, 1.0)


def _clip(leaves, outs, max_norm: float, norm_type: float) -> torch.Tensor:
    """Write each leaf times the coefficient into ``outs``; the total."""
    total = _total_norm(leaves, float(norm_type))
    mt.scale(leaves, outs, _coefficient(total, max_norm), check=False)
    return total


def clip_grad_norm(grads: Any, max_norm: float, norm_type: float = 2.0,
                   error_if_nonfinite: bool = False):
    """``(clipped_grads, total_norm)`` for a tree of gradients (the JAX
    function); the input is not written.  An empty tree gives itself and a
    0-d fp32 zero."""
    del error_if_nonfinite
    leaves = tree_leaves(grads)
    if not leaves:
        return grads, torch.zeros((), dtype=torch.float32)
    outs = [torch.empty_like(l) for l in leaves]
    total = _clip(leaves, outs, max_norm, norm_type)
    clipped = iter(outs)
    return tree_map(lambda _: next(clipped), grads), total


def clip_grad_norm_(parameters: Union[torch.Tensor, Iterable[torch.Tensor]],
                    max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False) -> torch.Tensor:
    """Clip the gradients of ``parameters`` in place (Apex's
    ``clip_grad_norm_``); returns the total norm, a 0-d fp32 tensor on the
    gradients' device (a CPU zero when no parameter has a gradient)."""
    del error_if_nonfinite
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    with torch.no_grad():
        return _clip(grads, grads, max_norm, norm_type)
