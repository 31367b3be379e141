"""Per-channel symmetric int8 quantize/dequantize (counterpart of
``apex_tpu/amp/quant.py``).

The one place a float tensor becomes an ``(int8 payload, fp32 scale)``
pair: serving weights at load time and KV-cache rows at write time both
go through these two functions.

- **Symmetric, no zero point**: ``q = round(x / scale)`` clipped to
  ``[-127, 127]``; the -128 code is unused.
- **Per-channel scales**: ``scale = amax(|x|) / 127`` over ``axis`` (the
  non-channel axes), one fp32 scale per remaining index.
- **Zero-amax guard**: an all-zero group takes ``scale = 1.0``, so its
  payload is zeros and the round trip is exact.

The op order is the JAX function's: the amax in fp32, then ``amax / 127``
(a division, not a multiply by a reciprocal), then ``x / scale``, then
round half to even (``torch.round``), then the clip.  On the same fp32
input the payload and the scales equal the JAX package's bit for bit.
Because a group's amax element quantizes to exactly +-127,
``quantize_int8(dequantize_int8(q, s))`` gives ``q`` back bit for bit.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["INT8_QMAX", "quantize_int8", "dequantize_int8"]

# symmetric clip bound: +-127, the -128 code deliberately unused
INT8_QMAX = 127.0


def _norm_axes(axis: Union[int, Tuple[int, ...]], ndim: int
               ) -> Tuple[int, ...]:
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    out = tuple(sorted(a % ndim for a in axes))
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate quantization axes {axes}")
    return out


def quantize_int8(x: torch.Tensor, axis: Union[int, Tuple[int, ...]] = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization of ``x``.

    ``axis`` names the dimensions the amax reduces over; the others are
    the channels, one fp32 scale each.  Returns ``(q, scale)``: ``q``
    int8 shaped like ``x``, ``scale`` fp32 shaped like ``x`` without the
    reduced axes."""
    axes = _norm_axes(axis, x.dim())
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / INT8_QMAX,
                        torch.ones((), dtype=torch.float32, device=x.device))
    q = torch.clamp(torch.round(xf / scale), -INT8_QMAX,
                    INT8_QMAX).to(torch.int8)
    for a in reversed(axes):
        scale = scale.squeeze(a)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    axis: Union[int, Tuple[int, ...]] = -1,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in fp32, the scale broadcast back over ``axis`` (the
    axes the matching :func:`quantize_int8` reduced), cast to ``dtype``."""
    axes = _norm_axes(axis, q.dim())
    s = scale.float()
    for a in axes:
        s = s.unsqueeze(a)
    out = q.float() * s
    return out if dtype == torch.float32 else out.to(dtype)
