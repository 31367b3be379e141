"""Convolution + bias (+ mask) (+ ReLU) (counterpart of
``apex_tpu.contrib.conv_bias_relu``)."""

from apex_tpu_torch.contrib.conv_bias_relu.conv_bias_relu import (
    ConvBias,
    ConvBiasMaskReLU,
    ConvBiasReLU,
    ConvFrozenScaleBiasReLU,
)

__all__ = ["ConvBias", "ConvBiasMaskReLU", "ConvBiasReLU",
           "ConvFrozenScaleBiasReLU"]
