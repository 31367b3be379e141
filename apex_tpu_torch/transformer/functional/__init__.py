"""apex_tpu_torch.transformer.functional: the fused softmax dispatcher
(counterpart of ``apex_tpu.transformer.functional``)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
)

__all__ = ["FusedScaleMaskSoftmax"]
