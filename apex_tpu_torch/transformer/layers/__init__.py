"""apex_tpu_torch.transformer.layers: the transformer's LayerNorm, aware of
sequence parallelism (counterpart of
``apex_tpu/transformer/layers/__init__.py``, apex's
``transformer.layers.FusedLayerNorm``).

The affine LayerNorm of :mod:`apex_tpu_torch.normalization` (``scale`` and
``bias``, the GPT norm, not RMS) under the transformer's argument names.
With ``sequence_parallel_enabled`` each rank normalizes its ``[s / tp, b,
h]`` shard of the tokens, so its ``scale`` and ``bias`` gradients are
partial sums: the parameters pass through
:func:`~apex_tpu_torch.transformer.tensor_parallel.copy_to_tensor_model_parallel_region`
(identity forward, all-reduce backward), as in the JAX module, and their
gradients come out summed over the tensor-parallel group.  Outside a
tensor-parallel region the copy is the identity.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import normalization
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
)

__all__ = ["FusedLayerNorm"]


class FusedLayerNorm(normalization.FusedLayerNorm):
    """LayerNorm over the last ``hidden_size`` features, with ``scale``
    (ones) and ``bias`` (zeros) in ``param_dtype``."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 memory_efficient: bool = False,
                 sequence_parallel_enabled: bool = False, *,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(hidden_size, eps, memory_efficient=memory_efficient,
                         dtype=param_dtype, device=device)
        self.sequence_parallel_enabled = sequence_parallel_enabled

    def forward(self, x):
        if not self.sequence_parallel_enabled:
            return super().forward(x)
        weight = copy_to_tensor_model_parallel_region(self.scale)
        bias = copy_to_tensor_model_parallel_region(self.bias)
        return fused_layer_norm_affine(x, weight, bias, self.normalized_shape,
                                       self.eps,
                                       memory_efficient=self.memory_efficient)
