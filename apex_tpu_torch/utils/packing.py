"""Pack a tree of tensors into one flat, padded buffer and back.

Counterpart of ``apex_tpu/utils/packing.py`` (``PackedSpec``,
``make_packed_spec``, ``pack_pytree``, ``unpack_pytree``): the flat layout
the packed optimizer kernels sweep in one launch, where the CUDA original
(``multi_tensor_apply``) walks a table of tensor pointers.

A tree is a tensor, or a list, tuple or dict of trees; dict keys are taken
in sorted order, as ``jax.tree_util`` takes them, so a flat buffer packed
here lays the leaves out in the JAX package's order.  Leaves are laid end
to end, each flattened in row-major order, and the buffer is padded with
zeros to a multiple of ``pad_to`` elements.

:func:`flatten_dense_tensors` / :func:`unflatten_dense_tensors` are the
unpadded pair of ``apex_C.flatten`` / ``unflatten`` that the data-parallel
wrapper's gradient buckets use (:mod:`apex_tpu_torch.parallel.distributed`).

:func:`host_flatten_dense_tensors` / :func:`host_unflatten_dense_tensors`
are the same pair over numpy arrays on the host (checkpoint shards,
staged batches), copied by the C++ runtime ``csrc/packing.cpp``
(:mod:`apex_tpu_torch.utils._native`), with the JAX module's checks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["PackedSpec", "PackedBuffer", "make_packed_spec", "pack_pytree",
           "unpack_pytree", "tree_leaves", "tree_map",
           "flatten_dense_tensors", "unflatten_dense_tensors",
           "host_flatten_dense_tensors", "host_unflatten_dense_tensors"]


def _flatten(tree: Any, out: List[torch.Tensor]):
    """Append the leaves of ``tree`` to ``out``; returns its structure."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys), tuple(_flatten(tree[k], out) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, None,
                tuple(_flatten(t, out) for t in tree))
    raise TypeError(f"a tree holds tensors, lists, tuples and dicts, not "
                    f"{type(tree).__name__}")


def _unflatten(structure, leaves) -> Any:
    if structure is None:
        return next(leaves)
    kind, keys, children = structure
    items = [_unflatten(c, leaves) for c in children]
    if kind == "dict":
        return dict(zip(keys, items))
    return tuple(items) if kind == "tuple" else items


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree_util`` order."""
    out: List[torch.Tensor] = []
    _flatten(tree, out)
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    leaves: List[torch.Tensor] = []
    structure = _flatten(tree, leaves)
    return _unflatten(structure, iter([fn(l) for l in leaves]))


@dataclasses.dataclass(frozen=True)
class PackedSpec:
    """The layout of a packed tree: its structure, and each leaf's shape,
    dtype and offset in the flat buffer."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]   # start offset of each leaf in the flat buffer
    total: int                 # unpadded element count
    padded_total: int          # element count after padding to `pad_to`

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)

    @property
    def sizes(self) -> Tuple[int, ...]:
        """Element count per leaf."""
        return tuple(math.prod(s) for s in self.shapes)


@dataclasses.dataclass
class PackedBuffer:
    """A tree flattened into one 1-D buffer, with its spec."""

    flat: torch.Tensor
    spec: PackedSpec

    def unpack(self) -> Any:
        return unpack_pytree(self.flat, self.spec)


def make_packed_spec(tree: Any, pad_to: int = 1024) -> PackedSpec:
    leaves: List[torch.Tensor] = []
    treedef = _flatten(tree, leaves)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = [math.prod(s) for s in shapes]
    offsets, at = [], 0
    for s in sizes:
        offsets.append(at)
        at += s
    total = at
    padded_total = -(-total // pad_to) * pad_to if total else pad_to
    return PackedSpec(treedef, shapes, tuple(l.dtype for l in leaves),
                      tuple(offsets), total, padded_total)


def pack_pytree(tree: Any, dtype: torch.dtype = None,
                pad_to: int = 1024) -> PackedBuffer:
    """Concatenate the leaves of ``tree``, each flattened and cast to
    ``dtype`` (by default the leaves' promoted dtype), into one buffer
    padded with zeros to a multiple of ``pad_to`` elements."""
    spec = make_packed_spec(tree, pad_to=pad_to)
    leaves = tree_leaves(tree)
    if not leaves:
        return PackedBuffer(torch.zeros(spec.padded_total,
                                        dtype=dtype or torch.float32), spec)
    if dtype is None:
        dtype = leaves[0].dtype
        for l in leaves[1:]:
            dtype = torch.promote_types(dtype, l.dtype)
    parts = [l.reshape(-1).to(dtype) for l in leaves]
    pad = spec.padded_total - spec.total
    if pad:
        parts.append(torch.zeros(pad, dtype=dtype, device=leaves[0].device))
    return PackedBuffer(torch.cat(parts), spec)


def unpack_pytree(flat: torch.Tensor, spec: PackedSpec) -> Any:
    """The tree of ``spec`` with each leaf read back from ``flat`` in its
    own shape and dtype (a view where the dtypes agree, else a copy)."""
    leaves = [flat[o:o + math.prod(shape)].view(shape).to(dtype)
              for shape, dtype, o in zip(spec.shapes, spec.dtypes,
                                         spec.offsets)]
    return _unflatten(spec.treedef, iter(leaves))


def flatten_dense_tensors(tensors) -> torch.Tensor:
    """The tensors, each flattened in row-major order, laid end to end in
    one 1-D buffer (``apex_C.flatten``); they share one dtype."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_dense_tensors(flat: torch.Tensor, like) -> List[torch.Tensor]:
    """``flat`` cut back into tensors shaped like ``like``, in order
    (``apex_C.unflatten``): views of ``flat``."""
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape))
        at += n
    return out


def host_flatten_dense_tensors(arrays) -> np.ndarray:
    """Host ``apex_C.flatten``: numpy arrays of one dtype, each in row-major
    order, end to end in one new 1-D array (an empty list gives an empty
    fp32 array), copied by ``csrc/packing.cpp``.  Non-contiguous arrays
    are made contiguous first."""
    from apex_tpu_torch.utils import _native

    if not arrays:
        return np.empty((0,), np.float32)
    dtype = arrays[0].dtype
    if any(a.dtype != dtype for a in arrays):
        raise ValueError("host flatten requires a single dtype")
    arrays = [np.ascontiguousarray(a) for a in arrays]
    out = np.empty((sum(a.size for a in arrays),), dtype)
    _native.flatten_into(arrays, out)
    return out


def host_unflatten_dense_tensors(flat: np.ndarray, like) -> List[np.ndarray]:
    """Host ``apex_C.unflatten``: ``flat`` cut, in order, into new arrays
    shaped like ``like``, copied by ``csrc/packing.cpp``.  Raises if
    ``flat`` is shorter than ``like`` needs, or if an array of ``like`` is
    not of ``flat``'s dtype (the outputs are ``flat``'s)."""
    from apex_tpu_torch.utils import _native

    flat, outs = _unflatten_checked(flat, like)
    _native.unflatten_from(flat, outs)
    return outs


def _unflatten_checked(flat, like):
    """``flat`` contiguous and the empty outputs of an unflatten, after
    the JAX module's checks."""
    flat = np.ascontiguousarray(flat)
    need = sum(int(np.prod(np.shape(t))) for t in like)
    if flat.size < need:
        raise ValueError(
            f"flat buffer has {flat.size} elements; 'like' needs {need}")
    # apex_C.unflatten returns like-typed tensors; the outputs here take
    # flat's dtype, so a mixed-dtype 'like' would change dtypes quietly
    bad = {str(np.asarray(t).dtype) for t in like} - {str(flat.dtype)}
    if bad:
        raise ValueError(
            f"'like' arrays have dtypes {sorted(bad)} != flat buffer dtype "
            f"{flat.dtype}; unflatten preserves the flat dtype (flatten "
            "likewise requires a single dtype)")
    return flat, [np.empty(np.shape(t), flat.dtype) for t in like]

