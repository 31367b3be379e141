"""Data-parallel gradient synchronization over a ``torch.distributed``
process group (counterpart of ``apex_tpu/parallel/distributed.py``).

apex's ``DistributedDataParallel`` (``apex/parallel/distributed.py``)
broadcasts the model at construction, flattens gradients into buckets,
all-reduces them after the backward and keeps the knobs
``delay_allreduce``, ``allreduce_always_fp32`` and
``gradient_predivide_factor``.  The JAX package keeps the semantics and
leaves the buckets to XLA; here the semantics are the JAX functions' and
the wrapper is apex's, an ``nn.Module`` around the model:

- :func:`allreduce_grads`: sum or average a list of tensors over a group,
  one all-reduce over one flat bucket a dtype, with the predivide split
  (``/ f`` before the sum, ``/ (world / f)`` after) and, with
  ``allreduce_always_fp32``, half tensors reduced in fp32;
- :func:`broadcast_params`: root's values on every rank, the root checked
  against the group's size first;
- :class:`Reducer`: the manual average of a module's gradients (or any
  tensors);
- :class:`DistributedDataParallel`: the model behind a wrapper whose
  ``forward`` calls it; after each backward (the end of the autograd
  pass) the gradients are reduced by :func:`allreduce_grads`, unless
  ``delay_allreduce``, where :meth:`~DistributedDataParallel.sync`
  reduces once, after accumulation.  No per-bucket overlap with the
  backward and no side streams: the reduction follows the backward.

Where the JAX wrapper's ``shard_batch`` / ``replicate`` place arrays on a
mesh, this one's cut a batch into the rank's rows of the group and
broadcast tensors from rank 0 of the group.  ``group=None`` is the
default group (the whole world), as in ``torch.distributed``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch._logging import get_logger
from apex_tpu_torch.utils.packing import (
    flatten_dense_tensors,
    unflatten_dense_tensors,
)

__all__ = ["allreduce_grads", "broadcast_params", "Reducer",
           "DistributedDataParallel"]

logger = get_logger("parallel.distributed")


def _world(group, what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what}: torch.distributed is not initialized; call "
            f"torch.distributed.init_process_group first (torchrun, or "
            f"init_method='file://...' for one process)")
    return dist.get_world_size(group)


def _buckets(tensors: Sequence[torch.Tensor]):
    """The tensors grouped by dtype, in order of first appearance."""
    out = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out.values()


@torch.no_grad()
def allreduce_grads(grads: Iterable[Optional[torch.Tensor]], group=None, *,
                    allreduce_always_fp32: bool = False,
                    gradient_predivide_factor: float = 1.0,
                    gradient_average: bool = True) -> List[torch.Tensor]:
    """Sum (``gradient_average=False``) or average ``grads`` over
    ``group``, in place; returns them (``None`` entries dropped).

    Each dtype's tensors are flattened into one bucket and reduced by one
    all-reduce (``allreduce_bucket``, apex/parallel/distributed.py): with
    ``allreduce_always_fp32`` the bucket is fp32 and each result is cast
    back; the bucket is divided by ``gradient_predivide_factor`` before
    the sum and, when averaging, by ``world / gradient_predivide_factor``
    after it (that quotient formed in fp32, then taken in the bucket's
    dtype), as the JAX function divides."""
    grads = [g for g in grads if g is not None]
    world = _world(group, "allreduce_grads")
    f = float(gradient_predivide_factor)
    for bucket in _buckets(grads):
        flat = flatten_dense_tensors(bucket)
        if allreduce_always_fp32:
            flat = flat.float()
        if f != 1.0:
            flat.div_(float(torch.tensor(f, dtype=flat.dtype)))
        dist.all_reduce(flat, group=group)
        if gradient_average:
            post = torch.tensor(world, dtype=torch.float32) / torch.tensor(
                f, dtype=torch.float32)
            flat.div_(float(post.to(flat.dtype)))
        for g, new in zip(bucket, unflatten_dense_tensors(flat, bucket)):
            g.copy_(new)
    return grads


@torch.no_grad()
def broadcast_params(params: Iterable[torch.Tensor], group=None,
                     root: int = 0) -> List[torch.Tensor]:
    """Every rank's ``params`` set, in place, to those of the group's rank
    ``root`` (the DDP construction broadcast); one broadcast a dtype.
    ``root`` is checked against the group's size before anything moves:
    the JAX function's masked sum would spread zeros from a root outside
    the axis."""
    params = list(params)
    world = _world(group, "broadcast_params")
    if not 0 <= root < world:
        raise ValueError(
            f"broadcast_params: root {root} is outside the group of size "
            f"{world} (an out-of-range root would broadcast no rank's "
            f"params)")
    src = root if group is None else dist.get_global_rank(group, root)
    logger.debug("broadcast_params over a group of %d from rank %d",
                 world, root)
    for bucket in _buckets(params):
        flat = flatten_dense_tensors(bucket)
        dist.broadcast(flat, src=src, group=group)
        for p, new in zip(bucket, unflatten_dense_tensors(flat, bucket)):
            p.copy_(new)
    return params


class Reducer:
    """The manual reduction of apex's ``Reducer``: given a module (or a
    list of tensors), broadcast its parameters from rank 0 at
    construction; :meth:`reduce` averages the given tensors over the
    group in place, by default the module's gradients."""

    def __init__(self, module_or_tensors=None, group=None):
        self.group = group
        self.module = None
        if isinstance(module_or_tensors, nn.Module):
            self.module = module_or_tensors
            broadcast_params(self.module.parameters(), group)
        elif module_or_tensors is not None:
            broadcast_params(module_or_tensors, group)

    def reduce(self, tensors: Optional[Iterable[torch.Tensor]] = None
               ) -> List[torch.Tensor]:
        """The mean of ``tensors`` over the group, in place (one
        all-reduce a dtype, then a division by the group's size)."""
        if tensors is None:
            if self.module is None:
                raise ValueError("Reducer.reduce: no tensors given and no "
                                 "module to take gradients from")
            tensors = [p.grad for p in self.module.parameters()]
        return allreduce_grads(tensors, self.group)


class DistributedDataParallel(nn.Module):
    """``module`` behind data parallelism over ``group`` (apex's
    ``DistributedDataParallel`` with the JAX wrapper's options).

    At construction every floating and integer tensor of the module's
    ``state_dict`` is broadcast from the group's rank 0.  ``forward``
    calls the module.  After a backward that reached any of its
    parameters, the gradients are reduced by :func:`allreduce_grads` with
    this wrapper's options, once, at the end of the autograd pass;
    ``delay_allreduce=True`` leaves them local, and :meth:`sync` reduces
    them once, after accumulation (the JAX ``sync``)."""

    def __init__(self, module: nn.Module, group=None, *,
                 allreduce_always_fp32: bool = False,
                 gradient_predivide_factor: float = 1.0,
                 gradient_average: bool = True,
                 delay_allreduce: bool = False):
        super().__init__()
        self.module = module
        self.group = group
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_predivide_factor = gradient_predivide_factor
        self.gradient_average = gradient_average
        self.delay_allreduce = delay_allreduce
        self._queued = False
        broadcast_params(module.state_dict().values(), group)
        if not delay_allreduce:
            for p in module.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._on_grad)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def _on_grad(self, _param) -> None:
        # the first gradient of a backward queues one reduction for the
        # end of the pass, when every gradient has been accumulated
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._after_backward)

    def _after_backward(self) -> None:
        self._queued = False
        self._reduce()

    def _reduce(self) -> List[torch.Tensor]:
        return allreduce_grads(
            [p.grad for p in self.module.parameters()], self.group,
            allreduce_always_fp32=self.allreduce_always_fp32,
            gradient_predivide_factor=self.gradient_predivide_factor,
            gradient_average=self.gradient_average)

    def sync(self) -> List[torch.Tensor]:
        """Reduce the accumulated gradients now (with ``delay_allreduce``,
        once after the last backward)."""
        return self._reduce()

    # -- the JAX wrapper's placement helpers, over the group ---------------
    def shard_batch(self, batch):
        """This rank's rows of each tensor of ``batch`` (a tensor, or a
        tuple or list of them): dim 0 cut evenly over the group."""
        world = _world(self.group, "shard_batch")
        rank = dist.get_rank(self.group)

        def rows(t):
            if t.shape[0] % world:
                raise ValueError(f"shard_batch: {t.shape[0]} rows do not "
                                 f"split evenly over {world} ranks")
            n = t.shape[0] // world
            return t[rank * n:(rank + 1) * n]

        if isinstance(batch, torch.Tensor):
            return rows(batch)
        return type(batch)(rows(t) for t in batch)

    def replicate(self, tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors`` set to the group's rank 0's, in place."""
        return broadcast_params(tensors, self.group)
