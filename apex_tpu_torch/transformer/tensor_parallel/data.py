"""Batches for tensor-parallel ranks (counterpart of
``apex_tpu/transformer/tensor_parallel/data.py``).

- :func:`broadcast_data`: every rank of the tensor-parallel group gets
  the values of the group's first rank, through ``dist.broadcast`` over
  the group (the reference reads a batch once per tp group and
  broadcasts it; the JAX function all-gathers inside ``shard_map`` and
  keeps rank 0's).
- :func:`tp_replicated_rows`: the port's counterpart of the JAX
  ``tp_replicated_sharding``, whose ``NamedSharding`` puts dim 0 of a
  batch over ``dp`` and replicates it over ``tp`` and ``pp``.  One
  process a rank holds only its own part, so this returns that part:
  data-parallel rank ``r`` of ``dp`` takes rows ``[r * n / dp, (r + 1) *
  n / dp)`` of the global batch, the same rows on every rank of its tp
  group; without ``batch_dim_over_dp`` every rank takes the whole batch.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    current_tp_group,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

__all__ = ["broadcast_data", "tp_replicated_rows"]


def broadcast_data(keys: Iterable[str], data: Dict[str, Any],
                   datatype: torch.dtype, group=None, *,
                   device=None) -> Dict[str, torch.Tensor]:
    """``{key: tensor}`` for each key, as ``datatype`` (on ``device`` if
    given, else where the value lies): the tp group's first rank's values
    on every rank.  The group is ``group``, else the bound region's, else
    ``parallel_state``'s tensor-parallel group; with none of them (one
    process), the values as they are.  NCCL groups take CUDA tensors,
    gloo ones CPU tensors."""
    g = current_tp_group() if group is None else group
    src = None if g is None else dist.get_global_rank(g, 0)
    out = {}
    for k in keys:
        t = torch.as_tensor(data[k], dtype=datatype, device=device)
        t = t.contiguous().clone()
        if g is not None:
            dist.broadcast(t, src=src, group=g)
        out[k] = t
    return out


def tp_replicated_rows(batch: torch.Tensor,
                       batch_dim_over_dp: bool = True) -> torch.Tensor:
    """This rank's rows of the global ``batch`` (see the module
    docstring): its data-parallel block of dim 0, from ``parallel_state``'s
    dp rank and size (the whole batch before the parallel state is
    initialized)."""
    from apex_tpu_torch.transformer import parallel_state

    if not batch_dim_over_dp or \
            not parallel_state.model_parallel_is_initialized():
        return batch
    dp = parallel_state.get_data_parallel_world_size()
    rank = parallel_state.get_data_parallel_rank()
    n = divide(batch.shape[0], dp)
    return batch[rank * n:(rank + 1) * n]
