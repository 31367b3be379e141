"""FusedScaleMaskSoftmax: the dispatcher from scale + mask + softmax to
the fused kernels.

Counterpart of ``apex_tpu/transformer/functional/fused_softmax.py``
(apex's ``fused_softmax.py:164-275``), with the same routing:

- causal mask type: the causal kernel, combined with an explicit padding
  mask when one is given (:func:`scaled_causal_masked_softmax`), else
  :func:`scaled_upper_triang_masked_softmax`;
- padding mask type with a mask: :func:`scaled_masked_softmax` when
  :meth:`is_kernel_available`, else :func:`generic_scaled_masked_softmax`;
- no mask: :func:`scaled_softmax`.

All of them run :mod:`apex_tpu_torch.ops.softmax`: the CUDA kernels for
tensors on the card, their plain versions on the CPU.
:meth:`is_kernel_available` states the port kernel's own limit (``1 <= sk
<= MAX_SK``), not the TPU's ``sk % 128`` tiling rule; the generic path is
the same function and, on the card, the same kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops.softmax import (
    MAX_SK,
    generic_scaled_masked_softmax,
    scaled_causal_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = ["FusedScaleMaskSoftmax"]


class FusedScaleMaskSoftmax(nn.Module):
    """Fused scale + mask + softmax (``fused_softmax.py:164``).

    ``input_in_fp16`` / ``input_in_bf16`` describe the activation dtype,
    ``attn_mask_type`` selects causal or padding, ``scaled_masked_softmax_fusion``
    enables the kernel path, and ``mask_func`` / ``softmax_in_fp32`` /
    ``scale`` configure the eager path :meth:`forward_torch_softmax`."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        super().__init__()
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active at "
                               "the same time.")
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """Whether the masked kernel takes this shape: any sq, and sk from
        1 to the kernel's maximum."""
        del mask, b, np_, sq
        return self.scaled_masked_softmax_fusion and 1 <= sk <= MAX_SK

    def forward(self, inputs, mask=None):
        b, np_, sq, sk = inputs.shape
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            if mask is not None:
                # causal and padding compose (a caller passing a padding
                # mask still gets causal attention)
                return scaled_causal_masked_softmax(inputs, mask, scale)
            return scaled_upper_triang_masked_softmax(inputs, scale)
        if mask is not None:
            if self.is_kernel_available(mask, b, np_, sq, sk):
                return scaled_masked_softmax(inputs, mask, scale)
            return generic_scaled_masked_softmax(inputs, mask, scale)
        return scaled_softmax(inputs, scale)

    def forward_torch_softmax(self, inputs, mask=None):
        """The unfused eager path: scale, ``mask_func``, softmax, in fp32
        when ``softmax_in_fp32`` (cast back for fp16/bf16 input)."""
        x = inputs.float() if self.softmax_in_fp32 else inputs
        if self.scale is not None:
            x = x * self.scale
        if mask is not None and self.mask_func is not None:
            x = self.mask_func(x, mask)
        probs = torch.softmax(x, dim=-1)
        if self.softmax_in_fp32 and self.input_in_float16:
            probs = probs.to(inputs.dtype)
        return probs
