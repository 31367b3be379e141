"""OpenFold acceleration modules (counterpart of
``apex_tpu.contrib.openfold_triton``): the Evoformer attention core with
pair bias, the small-shape LayerNorm, and ``FusedAdamSWA``.

- :func:`attention_core` routes the Evoformer MSA-row layout to the
  pair-bias attention kernels (:mod:`apex_tpu_torch.ops.pair_bias_attention`)
  under the JAX function's own condition, and computes every other input
  with a materialized softmax in plain PyTorch, as the JAX function
  computes it outside any Pallas kernel.
- ``CanSchTriMHA`` returns True, as in JAX; ``AttnBiasJIT`` and
  ``AttnNoBiasJIT`` name :func:`attention_core`.
- ``LayerNormSmallShapeOptImpl.apply`` is the port's fused LayerNorm
  (its forward and backward kernels).
- ``sync_triton_auto_tune_cache_across_gpus`` does nothing: the port's
  kernels are built by ``nvcc`` and tune nothing at run time.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.contrib.openfold_triton.fused_adam_swa import (
    AdamMathType,
    FusedAdamSWA,
)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
from apex_tpu_torch.ops.pair_bias_attention import pair_bias_flash_attention

__all__ = ["attention_core", "AttnBiasJIT", "AttnNoBiasJIT", "CanSchTriMHA",
           "LayerNormSmallShapeOptImpl", "FusedAdamSWA", "AdamMathType",
           "sync_triton_auto_tune_cache_across_gpus"]


def CanSchTriMHA(in_shape, has_bias=True, inf=1e9, training=True):
    """The reference's shape allowlist: every shape is taken, as in JAX."""
    del in_shape, has_bias, inf, training
    return True


def attention_core(q, k, v, mask=None, bias=None, inf=1e9,
                   is_training=True):
    """Evoformer attention: ``softmax(q·kᵀ + bias + mask_fill) · v``.

    q/k/v: ``[..., H, S, D]`` with q scaled by the caller (OpenFold divides
    it by sqrt(d)); ``mask`` a broadcastable 0/1 tensor (0 = masked, filled
    with ``-inf``); ``bias`` the pair-bias term.

    The 5-D MSA-row layout (q/k/v ``[b, r, h, s, d]``, bias ``[b, 1, h, s,
    s]``, mask ``[b, r, 1, 1, s]``) with ``s >= 1024``, ``s % 128 == 0`` and
    ``d % 8 == 0`` goes to the pair-bias attention kernels, the JAX
    routing; there ``inf`` is ignored (the fill is -1e30) and a query row
    with no valid key gives zeros with zero gradients.  Every other input
    takes the materialized path, where such a row is the uniform average
    of softmax over ``-inf``.
    """
    del is_training
    routed = _route_pair_bias(q, k, v, mask, bias)
    if routed is not None:
        return routed
    return _materialized(q, k, v, mask, bias, inf)


def _materialized(q, k, v, mask, bias, inf):
    """The materialized route, plain PyTorch: the scores, a softmax, the
    second product.  Rounded as the JAX function rounds: q kᵀ in q's
    dtype, then fp32, and the probabilities back in q's dtype before the
    second product."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask.bool(), scores, -float(inf))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def _route_pair_bias(q, k, v, mask, bias):
    """The Evoformer 5-D layout through the pair-bias kernels; None when
    the shapes fall outside the JAX function's routing condition (kept as
    it is: the two routes differ in meaning on fully masked rows)."""
    if q.dim() != 5 or bias is None or bias.dim() != 5:
        return None
    b, r, h, s, d = q.shape
    if s < 1024:
        return None
    if tuple(bias.shape) != (b, 1, h, s, s) or s % 128 or d % 8:
        return None
    kv_mask = None
    if mask is not None:
        if tuple(mask.shape) != (b, r, 1, 1, s):
            return None
        # [b, r, s] -> rows-major [r*b, s] (the bias's batch is the inner
        # factor)
        kv_mask = mask.bool()[:, :, 0, 0, :].transpose(0, 1).reshape(r * b, s)
    # [b, r, ...] -> [r, b, ...] -> [r*b, h, s, d]
    to_flat = lambda x: x.transpose(0, 1).reshape(r * b, h, s, d)
    out = pair_bias_flash_attention(to_flat(q), to_flat(k), to_flat(v),
                                    bias[:, 0], kv_mask)
    return out.reshape(r, b, h, s, d).transpose(0, 1)


# the reference's names for its two jitted variants
AttnBiasJIT = attention_core
AttnNoBiasJIT = attention_core


class LayerNormSmallShapeOptImpl:
    """The reference's small-shape LayerNorm, as a function object over the
    port's fused LayerNorm."""

    @staticmethod
    def apply(inputs, normalized_shape, weight, bias, eps=1e-5):
        """Affine LayerNorm over ``normalized_shape`` (the norm kernels on
        CUDA, their plain versions on the CPU)."""
        return fused_layer_norm_affine(inputs, weight, bias,
                                       normalized_shape, eps=eps)


def sync_triton_auto_tune_cache_across_gpus(*args, **kwargs):
    """Does nothing: the port tunes no kernel at run time."""
    return None
