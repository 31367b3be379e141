"""Group BatchNorm: statistics over rank subgroups (counterpart of
``apex_tpu.contrib.cudnn_gbn``)."""

from apex_tpu_torch.contrib.cudnn_gbn.batch_norm import (
    GroupBatchNorm2d,
    bn_group_index_groups,
)

__all__ = ["GroupBatchNorm2d", "bn_group_index_groups"]
