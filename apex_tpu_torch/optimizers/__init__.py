"""apex_tpu_torch.optimizers: fused optimizers (counterpart of
``apex_tpu.optimizers``).  Ported so far: :class:`FusedAdam`, in plain
PyTorch, as the JAX ``FusedAdam`` is plain jnp, and :class:`FusedLAMB`,
plain PyTorch unpacked and over the packed LAMB kernel with
``packed=True``."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedAdam", "FusedLAMB"]
