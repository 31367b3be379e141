"""Varlen packed attention (counterpart of ``apex_tpu.contrib.fmha``).

qkv is ``[total, 3, h, d]`` with ``cu_seqlens`` (``[b + 1]`` cumulative
sequence starts) delimiting the sequences.  Packing maps onto the flash
kernels' segment ids: token ``i`` belongs to sequence
``searchsorted(cu_seqlens, i)``, tokens attend only within their own
segment, and the batch is one ``[1, h, total, d]`` problem with one
segment-id row.  q, k and v go to the kernels as strided views of qkv.

Cost: the flash kernels mask segments element by element and skip no
block, so a packed call does the ``total**2`` work of one long sequence,
not the ``sum(L_i**2)`` its sequences need.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["fmha_varlen", "FMHA"]


def segment_ids_from_cu_seqlens(cu_seqlens, total: int):
    """``[b + 1]`` cumulative starts -> ``[total]`` int32 segment ids
    (1-based; positions past ``cu_seqlens[-1]`` get id 0 = padding)."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int64)
    pos = torch.arange(total, device=cu.device)
    seg = torch.searchsorted(cu, pos, right=True)
    return torch.where(pos < cu[-1], seg, 0).to(torch.int32)


def fmha_varlen(qkv, cu_seqlens, *, causal: bool = False,
                scale: Optional[float] = None):
    """Packed varlen attention: ``qkv [total, 3, h, d]`` (fmha layout),
    ``cu_seqlens [b + 1]`` int sequence boundaries; returns the ``[total,
    h, d]`` context (a view)."""
    total, three, h, d = qkv.shape
    if three != 3:
        raise ValueError("qkv must be packed as [total, 3, h, d]")
    seg = segment_ids_from_cu_seqlens(cu_seqlens, total)[None]  # [1, total]
    q, k, v = (qkv[:, i].transpose(0, 1)[None] for i in range(3))
    out = flash_attention(q, k, v, causal=causal, segment_ids=seg,
                          scale=scale)
    return out[0].transpose(0, 1)


class FMHA(nn.Module):
    """Packed-qkv attention with the per-sequence boundaries supplied at
    call time (``apex.contrib.fmha.FMHA``).  Attention dropout is not
    fused; apply dropout on the returned context if needed."""

    def __init__(self, num_heads: int, causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal

    def forward(self, qkv, cu_seqlens, max_s=None, is_training: bool = True):
        del max_s, is_training  # no per-call sequence cap is needed
        return fmha_varlen(qkv, cu_seqlens, causal=self.causal)
