"""Spatial parallelism: halo exchange and the spatially split bottleneck
(counterpart of ``apex_tpu.contrib.halo``)."""

from apex_tpu_torch.contrib.halo.halo_exchange import (
    HaloExchanger1d,
    halo_exchange_1d,
    left_right_halo_exchange,
    spatial_conv2d,
)
from apex_tpu_torch.contrib.halo.bottleneck import Bottleneck, SpatialBottleneck

__all__ = ["HaloExchanger1d", "halo_exchange_1d",
           "left_right_halo_exchange", "spatial_conv2d",
           "SpatialBottleneck"]
