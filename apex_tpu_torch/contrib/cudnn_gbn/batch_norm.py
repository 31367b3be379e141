"""Group BatchNorm: batch-norm statistics reduced over rank *subgroups*
(counterpart of ``apex_tpu.contrib.cudnn_gbn.batch_norm``).

When per-rank batches are small (detection, segmentation), groups of
``group_size`` adjacent ranks share their statistics for a larger
effective batch without a world-wide reduction.  JAX reduces with one
``psum`` over ``axis_index_groups``; here each subgroup is a
``torch.distributed.new_group``, and every rank of ``process_group``
creates all of them, in the same order (``new_group`` is collective over
the whole world).  Everything else (the Welford merge, fp32 statistics,
the running-statistics update, the written-out backward) is
:class:`apex_tpu_torch.parallel.SyncBatchNorm`'s.

``axis_index_groups=None`` reduces over the whole ``process_group``;
``process_group=None`` is local batch norm (JAX's ``axis_name=None``).
The channel dimension defaults to the last, as in JAX.
"""

from __future__ import annotations

import torch.distributed as dist

from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["GroupBatchNorm2d", "bn_group_index_groups"]


def bn_group_index_groups(world_size: int, group_size: int):
    """Partition ranks ``[0, world)`` into adjacent groups of
    ``group_size`` (None for a group size of 1)."""
    if group_size <= 1:
        return None
    if world_size % group_size != 0:
        raise ValueError(
            f"world_size ({world_size}) must be a multiple of "
            f"group_size ({group_size})")
    return [list(range(s, s + group_size))
            for s in range(0, world_size, group_size)]


def subgroup(process_group, axis_index_groups):
    """The group this rank's statistics reduce over: ``process_group``
    itself without ``axis_index_groups``, else the subgroup (ranks of
    ``process_group`` by index) that holds this rank.  Every rank of the
    world must call this with the same arguments: it creates every
    subgroup."""
    if process_group is None or axis_index_groups is None:
        return process_group
    world = dist.get_world_size(process_group)
    if sorted(i for g in axis_index_groups for i in g) != list(range(world)):
        raise ValueError(f"axis_index_groups {axis_index_groups} do not "
                         f"partition the group's {world} ranks")
    me = dist.get_rank(process_group)
    mine = None
    for g in axis_index_groups:
        ranks = [dist.get_global_rank(process_group, i) for i in g]
        made = dist.new_group(ranks)
        if me in g:
            mine = made
    return mine


class GroupBatchNorm2d(SyncBatchNorm):
    """Batch norm whose statistics reduce over a subgroup of
    ``process_group``: ``GroupBatchNorm2d(C, process_group=group,
    axis_index_groups=bn_group_index_groups(world, bn_group))``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, process_group=None,
                 axis_index_groups=None, channel_axis: int = -1,
                 fuse_relu: bool = False, use_fast_variance: bool = True,
                 device=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats,
                         subgroup(process_group, axis_index_groups),
                         channel_axis, fuse_relu, use_fast_variance, device)
        self.axis_index_groups = axis_index_groups
