"""flax's / XLA's ``SAME`` convolution padding on NCHW tensors with OIHW
weights, shared by the ImageNet ResNet and the halo bottleneck."""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["same_pads", "conv2d_same"]


def same_pads(size: int, kernel: int, stride: int):
    """flax's / XLA's ``SAME`` padding of one dimension: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x, w, stride: int = 1):
    """``lax.conv`` with ``SAME`` padding, NCHW / OIHW, no bias: symmetric
    pads go to the convolution, asymmetric ones (``(0, 1)``, ``(2, 3)``)
    to an ``F.pad`` first."""
    (t, b), (l, r) = (same_pads(x.shape[2], w.shape[2], stride),
                      same_pads(x.shape[3], w.shape[3], stride))
    if t == b and l == r:
        return F.conv2d(x, w, None, stride, (t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, None, stride)
