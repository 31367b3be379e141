"""Kernels of the port and their plain PyTorch versions (counterpart of
``apex_tpu.ops``).  ``_dispatch`` sends a CUDA tensor to the hand-written
kernel and a CPU tensor to the plain version; ``_build`` compiles the
CUDA sources in ``csrc/`` on first use.

Importing this package registers every kernel in ``_dispatch.KERNELS``,
in the order they were ported: the LayerNorm/RMSNorm forward, the flash
attention forward and the fused LM-head loss forward."""

from apex_tpu_torch.ops import layer_norm  # noqa: F401  (registers first)
from apex_tpu_torch.ops import flash_attention, fused_lm_head  # noqa: F401
