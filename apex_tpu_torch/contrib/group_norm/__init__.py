"""Channels-last GroupNorm with fused Swish/SiLU (counterpart of
``apex_tpu.contrib.group_norm``)."""

from apex_tpu_torch.contrib.group_norm.group_norm import (
    GroupNorm,
    group_norm_nhwc,
)

__all__ = ["GroupNorm", "group_norm_nhwc"]
