"""Channels-last GroupNorm with an optional Swish/SiLU epilogue
(counterpart of ``apex_tpu.contrib.group_norm.group_norm``).

The layout is JAX's: channels on the last dimension, ``[N, ..., C]``
(``[N, H, W, C]`` for an image).  Statistics are fp32 per (sample,
group) over every spatial position and the group's channels; the affine
runs in fp32, swish/silu after it, and the result is cast back to the
input's dtype.  Plain PyTorch: autograd gives the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["GroupNorm", "group_norm_nhwc"]

_ACTS = {None: lambda x: x, "": lambda x: x, "silu": F.silu, "swish": F.silu}


def group_norm_nhwc(x, num_groups: int, weight=None, bias=None,
                    eps: float = 1e-5, act: Optional[str] = None):
    """GroupNorm over a channels-last tensor ``[N, ..., C]``; ``weight``
    and ``bias`` are per-channel ``[C]``; ``act`` is None, ``"silu"`` or
    ``"swish"``, applied after the affine."""
    if act not in _ACTS:
        raise ValueError(f"unsupported act {act!r}; one of "
                         f"{sorted(map(str, _ACTS))}")
    C = x.shape[-1]
    if C % num_groups != 0:
        raise ValueError(f"channels ({C}) not divisible by groups "
                         f"({num_groups})")
    xg = x.float().reshape(*x.shape[:-1], num_groups, C // num_groups)
    dims = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)  # spatial + group
    mean = xg.mean(dims, keepdim=True)
    var = (xg - mean).square().mean(dims, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return _ACTS[act](y).to(x.dtype)


class GroupNorm(nn.Module):
    """Module form of :func:`group_norm_nhwc` on channels-last input;
    ``weight`` and ``bias`` in ``param_dtype`` (fp32) on ``device`` (CUDA
    by default)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, act: Optional[str] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if num_channels % num_groups != 0:
            raise ValueError("num_channels must be divisible by num_groups")
        self.num_groups, self.num_channels = num_groups, num_channels
        self.eps, self.affine = eps, affine
        self.act = act.lower() if act else act
        if self.act not in _ACTS:
            raise ValueError(f"unsupported act {act!r}")
        if affine:
            kw = dict(dtype=param_dtype, device=resolve_device(device))
            self.weight = nn.Parameter(torch.ones(num_channels, **kw))
            self.bias = nn.Parameter(torch.zeros(num_channels, **kw))

    def forward(self, x):
        if x.shape[-1] != self.num_channels:
            raise ValueError(
                f"expected channels-last input with C={self.num_channels}, "
                f"got shape {tuple(x.shape)}")
        w = self.weight if self.affine else None
        b = self.bias if self.affine else None
        return group_norm_nhwc(x, self.num_groups, w, b, self.eps, self.act)
