"""Multi-tensor apply: one operation over a whole tree of tensors
(counterpart of ``apex_tpu/multi_tensor_apply/__init__.py``, the
``amp_C`` family's ``multi_tensor_l2norm``, ``multi_tensor_scale``,
``multi_tensor_axpby`` and ``multi_tensor_unscale_l2norm``, and the
``multi_tensor_applier`` trampoline).

On CUDA tensors ``multi_tensor_scale``, the overflow check,
``multi_tensor_l2norm`` and ``multi_tensor_unscale_l2norm`` run the
multi-tensor kernels of :mod:`apex_tpu_torch.ops.multi_tensor` (``mt_scale``
and ``mt_l2norm``: one walk over every leaf, where the JAX functions are
jnp tree maps that XLA fuses); on CPU tensors their plain versions.  Each
scale multiplies in fp32 and rounds to the leaf's dtype.
``multi_tensor_axpby`` stays plain PyTorch over the leaves (no path of the
port calls it).  The calls are functional: each returns its result and an
overflow flag (a 0-d bool tensor on the device, never read on the host) in
place of the CUDA originals' mutated ``noop_flag``.
"""

from __future__ import annotations

from typing import Any

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.utils.packing import tree_leaves, tree_map
from apex_tpu_torch.utils.tree_math import tree_axpby, tree_l2norm

__all__ = ["multi_tensor_scale", "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_unscale_l2norm", "MultiTensorApply",
           "multi_tensor_applier"]


def _nonfinite(tree: Any, device=None) -> torch.Tensor:
    """True if any leaf holds an inf or a NaN (the amp_C overflow check):
    ``mt_scale``'s check alone, one launch over every leaf on CUDA.  With
    no leaves, False on ``device``."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.bool, device=device)
    return mt.scale(leaves, None, 1.0)


def _no_overflow(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.bool, device=device)


def multi_tensor_scale(tree: Any, scale, check_overflow: bool = True):
    """``out = tree * scale``; returns ``(out, found_inf)``
    (``amp_C.multi_tensor_scale``, the amp loss scaler's unscale): one
    ``mt_scale`` over every leaf, in fp32, each output in its leaf's
    dtype; ``scale`` a number or a 0-d fp32 tensor on the leaves' device."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree, _no_overflow(tree)
    outs = [torch.empty_like(l) for l in leaves]
    flag = mt.scale(leaves, outs, scale, check=check_overflow)
    unscaled = iter(outs)
    out = tree_map(lambda _: next(unscaled), tree)
    return out, flag if check_overflow else _no_overflow(tree)


def multi_tensor_axpby(a, x: Any, b, y: Any, check_overflow: bool = True):
    """``out = a * x + b * y``; returns ``(out, found_inf)``
    (``amp_C.multi_tensor_axpby``)."""
    out = tree_axpby(a, x, b, y)
    if check_overflow:
        return out, _nonfinite(x) | _nonfinite(y)
    return out, _no_overflow(x)


def multi_tensor_l2norm(tree: Any, per_tensor: bool = False):
    """Global L2 norm (and with ``per_tensor`` the per-tensor norms), in
    fp32 (``amp_C.multi_tensor_l2norm``, used by FusedLAMB): ``mt_l2norm``
    on CUDA."""
    return tree_l2norm(tree, per_leaf=per_tensor)


def multi_tensor_unscale_l2norm(tree: Any, inv_scale, per_tensor: bool = False):
    """``tree * inv_scale`` and its L2 norm (and with ``per_tensor`` the
    per-tensor norms), in fp32 (``amp_C.multi_tensor_unscale_l2norm``);
    returns ``(unscaled, norm)`` or ``(unscaled, (norm, per_tensor_norms))``.
    The norm is ``mt_l2norm``'s of the fp32 products ``x * inv_scale``, the
    unscaled tree ``mt_scale``'s (each product rounded to its leaf's
    dtype)."""
    unscaled, _ = multi_tensor_scale(tree, inv_scale, check_overflow=False)
    leaves = tree_leaves(tree)
    if not leaves:
        return unscaled, tree_l2norm(tree, per_leaf=per_tensor)
    norms = mt.l2norm(leaves, inv_scale)
    if per_tensor:
        return unscaled, (norms.total, list(norms.per_tensor.unbind()))
    return unscaled, norms.total


class MultiTensorApply:
    """The ``multi_tensor_applier`` trampoline
    (``apex/multi_tensor_apply/multi_tensor_apply.py``): the original
    calls ``applier(op, noop_flag, tensor_lists, *args)``; here ``op`` is
    one of the functions above (or any callable) and the call is
    functional.  ``chunk_size`` is kept for the API and not used."""

    available = True

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, *args, **kwargs):
        return op(*args, **kwargs)


multi_tensor_applier = MultiTensorApply()
