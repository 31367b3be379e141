"""apex_tpu_torch.transformer.functional: the fused softmax dispatcher and
the fused rotary embeddings (counterpart of
``apex_tpu.transformer.functional``)."""

from apex_tpu_torch.ops.rope import (
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_2d,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
)

__all__ = [
    "FusedScaleMaskSoftmax",
    "fused_apply_rotary_pos_emb",
    "fused_apply_rotary_pos_emb_2d",
    "fused_apply_rotary_pos_emb_cached",
    "fused_apply_rotary_pos_emb_thd",
]
