"""apex_tpu_torch.transformer.layers: the transformer's LayerNorm
(counterpart of ``apex_tpu/transformer/layers/__init__.py``, apex's
``transformer.layers.FusedLayerNorm``) at tensor-parallel size 1.

The affine LayerNorm of :mod:`apex_tpu_torch.normalization` (``scale`` and
``bias``, the GPT norm, not RMS) under the transformer's argument names.
Sequence parallelism, whose gradient all-reduce across the tensor-parallel
group is the point of the JAX module, comes with the tensor-parallel slice
of the port and raises here.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import normalization

__all__ = ["FusedLayerNorm"]


class FusedLayerNorm(normalization.FusedLayerNorm):
    """LayerNorm over the last ``hidden_size`` features, with ``scale``
    (ones) and ``bias`` (zeros) in ``param_dtype``."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 memory_efficient: bool = False,
                 sequence_parallel_enabled: bool = False, *,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        if sequence_parallel_enabled:
            raise NotImplementedError(
                "FusedLayerNorm(sequence_parallel_enabled=True) comes with "
                "the tensor-parallel slice of the port")
        super().__init__(hidden_size, eps, memory_efficient=memory_efficient,
                         dtype=param_dtype, device=device)
