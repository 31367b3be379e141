"""Kernels of the port and their plain PyTorch versions (counterpart of
``apex_tpu.ops``).  ``_dispatch`` sends a CUDA tensor to the hand-written
kernel and a CPU tensor to the plain version; ``_build`` compiles the
CUDA sources in ``csrc/`` on first use.

Importing this package registers every kernel in ``_dispatch.KERNELS``,
module by module, each forward before its backward: the LayerNorm/RMSNorm
forward and backward, the flash attention forward, dq and dk/dv, the
fused LM-head loss forward, dH and dE, the scaled softmax forward and
backward, the packed LAMB phase 1, packed Adam and packed Adagrad, the
pair-bias attention forward, dq, dk/dv and d(bias), and the multi-tensor
kernels under the optimizers (``mt_l2norm``, ``mt_scale``, ``mt_adam``,
``mt_lamb``), which have no Pallas counterpart."""

from apex_tpu_torch.ops import layer_norm  # noqa: F401  (registers first)
from apex_tpu_torch.ops import flash_attention, fused_lm_head  # noqa: F401
from apex_tpu_torch.ops import softmax, packed_update  # noqa: F401
from apex_tpu_torch.ops import pair_bias_attention  # noqa: F401
from apex_tpu_torch.ops import multi_tensor  # noqa: F401  (registers last)
