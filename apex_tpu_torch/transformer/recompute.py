"""Activation recompute policies for the transformer layers: the port's
counterpart of the ``jax.checkpoint`` policies that
``apex_tpu/transformer/testing/standalone_transformer_lm.py``'s
``ParallelTransformer`` hands to ``nn.remat``.

The port's kernels launch through ``ctypes``, not as dispatcher ops, so
a selective context of ``torch.utils.checkpoint`` sees a kernel's output
allocation and never its result: it cannot keep a kernel's output, and
re-runs the kernel whatever its policy says.  The four policies therefore
take two mechanisms, chosen so that each recomputes what the JAX policy
recomputes:

- ``None`` (whole-layer recompute): the layer under
  :func:`~apex_tpu_torch.transformer.tensor_parallel.checkpoint`; the
  backward re-runs both norm forwards, the attention forward and the
  linear products up to the last one whose output it needs (three of the
  four: ``torch.utils.checkpoint`` stops once every saved tensor is back,
  as XLA drops a dead recomputation).
- ``"dots"`` / ``"dots_no_batch"``: the same ``checkpoint`` with the
  selective context of :func:`dots_context`, which keeps the outputs of
  ``aten.mm`` / ``aten.addmm`` (the linears) and, for ``"dots"``, of
  ``aten.bmm`` / ``aten.baddbmm`` (the materialized attention's batched
  products) and recomputes everything else: the norm forwards and the
  flash forward, which are no dots in JAX either (a ``pallas_call``), run
  again; no linear product does.  ``"dots_no_batch"`` also re-runs the
  batched products, as ``checkpoint_dots_with_no_batch_dims`` does.
- ``"except_activations"``: every activation stays saved except those a
  layer tags with :func:`checkpoint_name` under one of the context's
  names (the norm outputs ``"ln_out"`` and the MLP's gelu output
  ``"mlp_act"``, JAX's names).  :class:`drop_named_activations` installs
  ``saved_tensors_hooks`` whose pack step keeps, in place of a tagged
  tensor (or a view of it), the recipe that makes it; the first unpack in
  the backward re-runs the recipe (a norm forward, or the gelu) under
  ``no_grad`` and the other unpacks of the same tensor share its result.
  The recipe's inputs keep their version counters from the forward, and
  the unpack raises if one moved, as autograd does for a saved tensor.
  The flash forward is not re-run.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, List, Sequence

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

__all__ = ["POLICIES", "dots_context", "drop_named_activations",
           "checkpoint_name"]

#: the policies of the JAX ``ParallelTransformer``
POLICIES = (None, "dots", "dots_no_batch", "except_activations")


def _dots_policy(saved, ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dots_context(batched: bool) -> Callable:
    """The ``context_fn`` of ``"dots"`` (``batched``) or
    ``"dots_no_batch"``: keep the products' outputs, recompute the rest."""
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default}
    if batched:
        saved |= {aten.bmm.default, aten.baddbmm.default}
    policy = functools.partial(_dots_policy, frozenset(saved))
    return functools.partial(create_selective_checkpoint_contexts, policy)


class _Tag:
    __slots__ = ("recompute", "tensor", "value", "pending", "inputs",
                 "versions")

    def __init__(self, recompute: Callable, tensor: torch.Tensor,
                 inputs: Sequence[torch.Tensor]):
        self.recompute = recompute
        self.tensor = tensor        # held while packing: its address is ours
        self.value = None
        self.pending = 0
        # the recipe's inputs and their version counters now: a write in
        # place before the recompute raises, as for autograd's saved tensors
        self.inputs = tuple(inputs)
        self.versions = tuple(t._version for t in self.inputs)


class _Dropped:
    """What the graph keeps for a dropped tensor: its tag and its view."""

    __slots__ = ("tag", "size", "stride", "offset")

    def __init__(self, tag: _Tag, t: torch.Tensor):
        self.tag = tag
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset() - tag.tensor.storage_offset()


_ACTIVE: List["drop_named_activations"] = []


def _storage_key(t: torch.Tensor):
    return (t.untyped_storage().data_ptr(), t.dtype, t.device)


def _unpack(packed):
    if not isinstance(packed, _Dropped):
        return packed
    tag = packed.tag
    if tag.value is None:
        now = tuple(t._version for t in tag.inputs)
        if now != tag.versions:
            raise RuntimeError(
                f"an input of a dropped activation's recompute recipe was "
                f"modified by an inplace operation after the forward "
                f"(versions {tag.versions}, now {now})")
        with torch.no_grad():
            tag.value = tag.recompute()
    v = tag.value
    out = v.as_strided(packed.size, packed.stride,
                       v.storage_offset() + packed.offset)
    tag.pending -= 1
    if tag.pending <= 0:
        # every saved use has its tensor; a second backward (retain_graph)
        # recomputes again
        tag.value = None
    return out


class drop_named_activations:
    """A context under which a tensor tagged with :func:`checkpoint_name`
    under one of ``names`` is not saved for the backward but recomputed
    there from its recipe (see the module docstring)."""

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self._tags = {}
        self._hooks = None

    def _pack(self, t: torch.Tensor):
        if not self._tags or t.layout != torch.strided:
            return t
        tag = self._tags.get(_storage_key(t))
        if tag is None:
            return t
        tag.pending += 1
        return _Dropped(tag, t)

    def tag(self, t: torch.Tensor, recompute: Callable,
            inputs: Sequence[torch.Tensor]) -> None:
        self._tags[_storage_key(t)] = _Tag(recompute, t, inputs)

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                               _unpack)
        self._hooks.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._hooks.__exit__(*exc)
        for tag in self._tags.values():
            tag.tensor = None
        self._tags.clear()
        return False


def checkpoint_name(t: torch.Tensor, name: str, recompute: Callable,
                    inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``t`` unchanged (JAX's ``checkpoint_name``).  Under a
    :class:`drop_named_activations` that names ``name``, the saved uses of
    ``t`` that follow keep ``recompute`` (a function of no arguments that
    returns ``t`` again from ``inputs``, the tensors it reads) in its
    place; the backward raises if one of ``inputs`` was written in place
    since."""
    if _ACTIVE and torch.is_grad_enabled():
        ctx = _ACTIVE[-1]
        if name in ctx.names:
            ctx.tag(t, recompute, inputs)
    return t
