"""DP-sharded batch samplers (counterpart of ``apex_tpu.transformer._data``)."""

from apex_tpu_torch.transformer._data._batchsampler import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)

__all__ = ["MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]
