"""Convolution + bias (+ mask) (+ ReLU) (counterpart of
``apex_tpu.contrib.conv_bias_relu.conv_bias_relu``): the epilogue order
of the reference's four cuDNN fusion graphs over ``F.conv2d``.

Layout: PyTorch's, not JAX's.  ``x`` is ``[N, C, H, W]`` (keep it in
``torch.channels_last`` memory for cuDNN's NHWC kernels, as the
reference does), the weight ``[C_out, C_in, kh, kw]`` (OIHW), ``bias``
and ``scale`` ``[C_out]`` broadcast over dimension 1, the mask shaped as
the output.  JAX's functions take NHWC / HWIO;
:func:`apex_tpu_torch.models.convert.conv_params_from_jax` carries an
HWIO kernel over.  The bias is added after the convolution, so dtypes
promote as in JAX (a 16-bit convolution plus an fp32 bias is fp32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ConvBias", "ConvBiasMaskReLU", "ConvBiasReLU",
           "ConvFrozenScaleBiasReLU"]


def _conv(x, weight, padding, stride):
    """``F.conv2d`` with JAX's padding forms: an int, a pair of ints, or a
    pair of ``(low, high)`` pairs (asymmetric pairs go through ``F.pad``)."""
    if isinstance(padding, int):
        padding = (padding, padding)
    padding = tuple(padding)
    if padding and not isinstance(padding[0], int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
    return F.conv2d(x, weight, stride=stride, padding=padding)


def _channel(t, like):
    return t.view(1, -1, *([1] * (like.dim() - 2)))


def ConvBias(x, weight, bias, padding=0, stride=1):
    """conv + bias.  x ``[N, C_in, H, W]``, weight ``[C_out, C_in, kh,
    kw]``, bias ``[C_out]``."""
    y = _conv(x, weight, padding, stride)
    return y + _channel(bias, y)


def ConvBiasReLU(x, weight, bias, padding=0, stride=1):
    """conv + bias + ReLU."""
    return torch.relu(ConvBias(x, weight, bias, padding, stride))


def ConvBiasMaskReLU(x, weight, bias, mask, padding=0, stride=1):
    """conv + bias, times an elementwise mask (the output's shape), then
    ReLU."""
    return torch.relu(ConvBias(x, weight, bias, padding, stride) * mask)


def ConvFrozenScaleBiasReLU(x, weight, scale, bias, padding=0, stride=1):
    """conv * scale + bias + ReLU with scale and bias frozen (no gradient
    reaches them): the folded-BN inference pattern."""
    y = _conv(x, weight, padding, stride)
    return torch.relu(y * _channel(scale.detach(), y)
                      + _channel(bias.detach(), y))
