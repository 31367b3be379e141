"""apex_tpu_torch.optimizers: fused optimizers (counterpart of
``apex_tpu.optimizers``).  Ported so far: :class:`FusedAdam`, in plain
PyTorch, as the JAX ``FusedAdam`` is plain jnp."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam

__all__ = ["FusedAdam"]
