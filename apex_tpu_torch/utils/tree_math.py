"""Reductions and elementwise math over trees of tensors (counterpart of
``apex_tpu/utils/tree_math.py``).

A tree is a tensor, or a list, tuple or dict of trees (dict keys taken
in sorted order, as ``jax.tree_util`` takes them); see
:func:`apex_tpu_torch.utils.packing.tree_leaves`.
"""

from __future__ import annotations

from typing import Any

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.utils.packing import tree_leaves, tree_map

__all__ = ["tree_add", "tree_axpby", "tree_cast", "tree_l2norm", "tree_scale",
           "tree_zeros_like"]


def tree_add(a: Any, b: Any) -> Any:
    """``a + b`` per leaf (two trees of one structure)."""
    bs = iter(tree_leaves(b))
    return tree_map(lambda x: x + next(bs), a)


def tree_scale(tree: Any, scale) -> Any:
    """``x * scale`` per leaf, the scale taken in each leaf's dtype."""
    return tree_map(lambda x: x * torch.as_tensor(scale, dtype=x.dtype,
                                                  device=x.device), tree)


def tree_axpby(a, x: Any, b, y: Any) -> Any:
    """``a * x + b * y`` per leaf (``amp_C.multi_tensor_axpby``), the
    coefficients taken in ``x``'s dtype."""
    xs, ys = tree_leaves(x), tree_leaves(y)
    out = iter([torch.as_tensor(a, dtype=xi.dtype, device=xi.device) * xi
                + torch.as_tensor(b, dtype=xi.dtype, device=xi.device) * yi
                for xi, yi in zip(xs, ys)])
    return tree_map(lambda _: next(out), x)


def tree_l2norm(tree: Any, per_leaf: bool = False, device=None):
    """Global (and with ``per_leaf`` per-leaf) L2 norm, in fp32
    (``amp_C.multi_tensor_l2norm``): each leaf's squares summed in fp32,
    the global norm the root of those sums' sum; on CUDA one ``mt_l2norm``
    over every leaf (:mod:`apex_tpu_torch.ops.multi_tensor`).  Returns a
    0-d fp32 tensor on the leaves' device (on ``device`` for a tree with
    no leaves), and with ``per_leaf`` the list of per-leaf norms too."""
    leaves = tree_leaves(tree)
    if not leaves:
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return (zero, []) if per_leaf else zero
    norms = mt.l2norm(leaves)
    if per_leaf:
        return norms.total, list(norms.per_tensor.unbind())
    return norms.total


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Every leaf in ``dtype``."""
    return tree_map(lambda x: x.to(dtype), tree)


def tree_zeros_like(tree: Any, dtype: torch.dtype = None) -> Any:
    """Zeros of each leaf's shape, in ``dtype`` (each leaf's own when
    None), on the leaf's device."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)
