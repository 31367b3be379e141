"""ResNet bottleneck blocks with frozen batch norm, including the
spatially split one (counterpart of ``apex_tpu/contrib/halo/bottleneck.py``,
after ``apex.contrib.bottleneck``'s ``Bottleneck`` and
``SpatialBottleneck``).

``relu(conv3(relu(conv2(relu(conv1(x))))) + shortcut(x))``, each
convolution followed by its frozen batch norm folded into a per-channel
scale and bias, the stride on the 3x3 (the reference's default), a 1x1
projection of the input where the shape changes.  The scales and biases
are parameters the block reads detached (JAX's ``stop_gradient``): they
never receive a gradient.  :class:`SpatialBottleneck` computes its 3x3 on
an H-split block with :func:`~apex_tpu_torch.contrib.halo.spatial_conv2d`.

Layout NCHW, weights OIHW (PyTorch's, as the port's ResNet; JAX's block
is NHWC / HWIO, :func:`~apex_tpu_torch.models.convert.
bottleneck_params_from_jax` transposes).  The convolutions are cuDNN's
``F.conv2d`` with flax's ``SAME`` padding (``lax.conv`` in JAX).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.contrib.halo.halo_exchange import spatial_conv2d
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.parallel_state import axis_group
from apex_tpu_torch.utils.conv import conv2d_same

__all__ = ["Bottleneck", "SpatialBottleneck"]


def _he_normal(cout: int, cin: int, k: int, *, dtype, device, generator):
    """flax's ``he_normal()``: truncated normal (within 2 std) of variance
    ``2 / fan_in``."""
    std = math.sqrt(2.0 / (cin * k * k)) / .87962566103423978
    w = torch.empty((cout, cin, k, k), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return nn.Parameter(w.to(dtype))


class Bottleneck(nn.Module):
    """Frozen-BN bottleneck over ``in_channels -> bottleneck_channels ->
    out_channels``.  Parameters (JAX's names): ``conv1 [bc, in, 1, 1]``,
    ``conv2 [bc, bc, 3, 3]``, ``conv3 [out, bc, 1, 1]`` and, where the
    shape changes, ``conv_down [out, in, 1, 1]``; ``bn1_scale`` /
    ``bn1_bias`` ... ``bn_down_bias`` (ones and zeros), read detached.
    With ``spatial_axis`` (a process group over which the input's H is
    split), the 3x3 exchanges halos; a strided block then raises."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, *, spatial_axis=None,
                 param_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride
        self.spatial_axis = axis_group(spatial_axis, "spatial_axis")
        dev = resolve_device(device)
        kw = dict(dtype=param_dtype, device=dev, generator=generator)
        bc = bottleneck_channels
        self.conv1 = _he_normal(bc, in_channels, 1, **kw)
        self.conv2 = _he_normal(bc, bc, 3, **kw)
        self.conv3 = _he_normal(out_channels, bc, 1, **kw)
        norms = [("bn1", bc), ("bn2", bc), ("bn3", out_channels)]
        self.has_down = stride != 1 or in_channels != out_channels
        if self.has_down:
            self.conv_down = _he_normal(out_channels, in_channels, 1, **kw)
            norms.append(("bn_down", out_channels))
        for name, c in norms:
            self.register_parameter(f"{name}_scale", nn.Parameter(
                torch.ones(c, dtype=param_dtype, device=dev)))
            self.register_parameter(f"{name}_bias", nn.Parameter(
                torch.zeros(c, dtype=param_dtype, device=dev)))

    def _bn(self, y, name: str):
        """``y * scale + bias`` by channel, the frozen pair detached."""
        scale = getattr(self, f"{name}_scale").detach()[:, None, None]
        bias = getattr(self, f"{name}_bias").detach()[:, None, None]
        return y * scale + bias

    def forward(self, x):
        y = F.relu(self._bn(conv2d_same(x, self.conv1), "bn1"))
        if self.spatial_axis is not None:
            if self.stride != 1:
                raise NotImplementedError(
                    "a strided spatial bottleneck needs a resharding step; "
                    "split the batch or width instead")
            y = spatial_conv2d(y, self.conv2, self.spatial_axis)
        else:
            y = conv2d_same(y, self.conv2, self.stride)
        y = F.relu(self._bn(y, "bn2"))
        y = self._bn(conv2d_same(y, self.conv3), "bn3")
        shortcut = (self._bn(conv2d_same(x, self.conv_down, self.stride),
                             "bn_down")
                    if self.has_down else x)
        return F.relu(y + shortcut)


class SpatialBottleneck(Bottleneck):
    """:class:`Bottleneck` whose 3x3 runs on an H-split block with halo
    exchange: each rank of ``spatial_axis`` passes its block of H.  The
    group has no default (JAX's is the mesh axis ``"spatial"``); None is
    the unsplit block."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, *, spatial_axis,
                 **kw):
        super().__init__(in_channels, bottleneck_channels, out_channels,
                         stride, spatial_axis=spatial_axis, **kw)
