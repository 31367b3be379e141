"""NHWC BatchNorm with fused ReLU and add+ReLU epilogues (counterpart of
``apex_tpu.contrib.groupbn.batch_norm``).

Channels on the last dimension; ``forward(x, z=None)`` applies BN(x),
then with ``z`` the reference's ``bn_addrelu``: ``relu(BN(x) + z)``,
always with the ReLU, and without ``z`` the ReLU only under
``fuse_relu``.  ``bn_group > 1`` shares the statistics among groups of
``bn_group`` adjacent ranks of ``process_group``
(:func:`~apex_tpu_torch.contrib.cudnn_gbn.bn_group_index_groups`), and
``bn_group = 1`` with a group reduces over the whole group, as JAX's
module does with an ``axis_name``.  The reference's persistent-kernel
knobs (``max_cta_per_sm``, ``cta_launch_margin``, ``multi_stream``) are
accepted and ignored.  Running statistics are used in ``eval()`` mode
(JAX's ``use_running_average``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.contrib.cudnn_gbn.batch_norm import (
    bn_group_index_groups,
    subgroup,
)
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["BatchNorm2d_NHWC"]


class BatchNorm2d_NHWC(SyncBatchNorm):
    """NHWC batch norm; ``forward(x, z=None)``: BN(x) (+ z) (+ ReLU)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, fuse_relu: bool = False,
                 bn_group: int = 1, process_group=None,
                 world_size: Optional[int] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 max_cta_per_sm: int = 2, cta_launch_margin: int = 12,
                 multi_stream: bool = False, device=None):
        del max_cta_per_sm, cta_launch_margin, multi_stream
        group = process_group
        if bn_group > 1:
            if process_group is None:
                raise ValueError("bn_group > 1 needs a process_group to "
                                 "form rank subgroups")
            size = dist.get_world_size(process_group)
            if world_size is not None and world_size != size:
                raise ValueError(f"world_size {world_size} != the group's "
                                 f"size {size}")
            group = subgroup(process_group,
                             bn_group_index_groups(size, bn_group))
        super().__init__(num_features, eps, momentum, process_group=group,
                         channel_axis=-1, fuse_relu=fuse_relu, device=device)
        self.bn_group = bn_group
        if param_dtype is not None:
            self.weight.data = self.weight.data.to(param_dtype)
            self.bias.data = self.bias.data.to(param_dtype)

    def forward(self, x, z=None):
        y = self._normalize(x, self.fuse_relu and z is None)
        if z is not None:
            # bn_addrelu: passing z selects the add + ReLU kernel in the
            # reference, which applies the ReLU regardless of fuse_relu
            y = torch.relu(y + z)
        return y
