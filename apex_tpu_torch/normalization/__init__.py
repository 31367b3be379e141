"""apex_tpu_torch.normalization: fused LayerNorm / RMSNorm modules.

Counterpart of ``apex_tpu/normalization/__init__.py``.  The modules run
:mod:`apex_tpu_torch.ops.layer_norm`: the CUDA kernel for tensors on the
card, its plain version on the CPU.  The affine parameters are named as in
flax (``scale``, and ``bias`` for LayerNorm), so a flax parameter tree maps
onto them one to one.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm", "fused_layer_norm", "fused_layer_norm_affine",
           "fused_rms_norm", "fused_rms_norm_affine"]

Shape = Union[int, Sequence[int]]


def _canon(normalized_shape: Shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(int(s) for s in normalized_shape)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims
    (apex.normalization.FusedLayerNorm).  ``memory_efficient`` makes the
    backward save the output ``y`` in place of the input and recover
    ``xhat = (y - bias) / scale`` from it; the forward is the same."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.normalized_shape = _canon(normalized_shape)
        self.eps = eps
        self.memory_efficient = memory_efficient
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            dev = resolve_device(device)
            self.scale = nn.Parameter(torch.ones(self.normalized_shape,
                                                 dtype=dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                                 dtype=dtype, device=dev))

    def forward(self, x):
        if not self.elementwise_affine:
            return fused_layer_norm(x, self.normalized_shape, self.eps,
                                    memory_efficient=self.memory_efficient)
        return fused_layer_norm_affine(x, self.scale, self.bias,
                                       self.normalized_shape, self.eps,
                                       memory_efficient=self.memory_efficient)


class FusedRMSNorm(nn.Module):
    """RMSNorm over the trailing ``normalized_shape`` dims
    (apex.normalization.FusedRMSNorm).  ``memory_efficient`` as in
    :class:`FusedLayerNorm`."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.normalized_shape = _canon(normalized_shape)
        self.eps = eps
        self.memory_efficient = memory_efficient
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.scale = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=dtype,
                device=resolve_device(device)))

    def forward(self, x):
        if not self.elementwise_affine:
            return fused_rms_norm(x, self.normalized_shape, self.eps,
                                  memory_efficient=self.memory_efficient)
        return fused_rms_norm_affine(x, self.scale, self.normalized_shape,
                                     self.eps,
                                     memory_efficient=self.memory_efficient)


class MixedFusedLayerNorm(FusedLayerNorm):
    """Megatron's mixed-dtype LayerNorm (apex.normalization.
    MixedFusedLayerNorm): the parameters stay fp32 while the input may be
    bf16 or fp16.  The kernels take a weight and bias of any dtype beside
    any input dtype, so this subclass only pins the parameters to fp32."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, *, device="cuda"):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, dtype=torch.float32, device=device)


class MixedFusedRMSNorm(FusedRMSNorm):
    """Megatron's mixed-dtype RMSNorm (apex.normalization.MixedFusedRMSNorm):
    fp32 parameters beside a bf16 or fp16 input, as
    :class:`MixedFusedLayerNorm`."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, *, device="cuda"):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, dtype=torch.float32, device=device)
