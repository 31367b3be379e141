"""Rotary positional embedding in the four layouts of apex's
``fused_rope`` (rotate-half convention; counterpart of
``apex_tpu/ops/rope.py``):

- sbhd, sines and cosines from a ``freqs`` tensor
  (:func:`fused_apply_rotary_pos_emb`);
- sbhd, cached cosines and sines (:func:`fused_apply_rotary_pos_emb_cached`);
- thd, packed sequences of varying length cut by ``cu_seqlens``
  (:func:`fused_apply_rotary_pos_emb_thd`);
- 2-d images, the height and width halves of the channels each with its
  own tables (:func:`fused_apply_rotary_pos_emb_2d`).

The JAX package has no Pallas kernel for rope (XLA fuses the elementwise
math), so this is plain PyTorch on every device; autograd gives the
backward.  Only the first ``d2 = freqs.shape[-1]`` channels rotate; the
rest pass through.
"""

from __future__ import annotations

import torch

__all__ = ["fused_apply_rotary_pos_emb", "fused_apply_rotary_pos_emb_cached",
           "fused_apply_rotary_pos_emb_thd", "fused_apply_rotary_pos_emb_2d"]


def _rotate_half(x):
    """(x1, x2) -> (-x2, x1) over the last dim."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply(t, cos, sin):
    d2 = cos.shape[-1]
    t_rot = t[..., :d2]
    rotated = (t_rot.float() * cos.float()
               + _rotate_half(t_rot).float() * sin.float()).to(t.dtype)
    if d2 == t.shape[-1]:
        return rotated
    return torch.cat([rotated, t[..., d2:]], dim=-1)


def fused_apply_rotary_pos_emb(t, freqs, transpose_output_memory: bool = False):
    """RoPE on ``t [s, b, h, d]``; ``freqs`` is ``[s, 1, 1, d2]`` or
    ``[s, b, 1, d2]``, float.  ``transpose_output_memory`` is a layout hint
    of the CUDA original, accepted and ignored as in the JAX package."""
    del transpose_output_memory
    return _apply(t, torch.cos(freqs), torch.sin(freqs))


def fused_apply_rotary_pos_emb_cached(t, cos_, sin_,
                                      transpose_output_memory: bool = False):
    """RoPE on ``t [s, b, h, d]`` with precomputed ``cos_`` / ``sin_`` of
    shape ``[s, 1, 1, d2]``."""
    del transpose_output_memory
    return _apply(t, cos_, sin_)


def fused_apply_rotary_pos_emb_thd(t, cu_seqlens, freqs):
    """RoPE on packed sequences ``t [total_t, h, d]``: ``cu_seqlens [b + 1]``
    holds the cumulative lengths, and each sequence restarts at position
    0, so token ``i`` of the sequence starting at ``cu_seqlens[j]`` takes
    row ``i - cu_seqlens[j]`` of ``freqs [max_s, 1, 1, d2]``."""
    cu = cu_seqlens.to(device=t.device, dtype=torch.int64)
    idx = torch.arange(t.shape[0], device=t.device)
    seq = torch.searchsorted(cu, idx, right=True) - 1
    f = freqs.reshape(freqs.shape[0], freqs.shape[-1])[idx - cu[seq]]
    return _apply(t, torch.cos(f)[:, None, :], torch.sin(f)[:, None, :])


def fused_apply_rotary_pos_emb_2d(t, img_h: int, img_w: int, cos_h, sin_h,
                                  cos_w, sin_w):
    """2-d (image) RoPE on ``t [b, s, h, d]`` with ``s == img_h * img_w``
    (row-major pixels): the first ``d / 2`` channels rotate by the row's
    height tables ``cos_h`` / ``sin_h [1, H, 1, d / 2]`` (``H >= img_h``),
    the second half by the column's width tables ``[1, W, 1, d / 2]``."""
    b, s, h, d = t.shape
    if s != img_h * img_w:
        raise ValueError(f"sequence length {s} != img_h*img_w = "
                         f"{img_h * img_w}")
    t5 = t.reshape(b, img_h, img_w, h, d)
    out_h = _apply(t5[..., :d // 2], cos_h[:, :img_h, None],
                   sin_h[:, :img_h, None])
    out_w = _apply(t5[..., d // 2:], cos_w[:, None, :img_w],
                   sin_w[:, None, :img_w])
    return torch.cat([out_h, out_w], dim=-1).reshape(b, s, h, d)
