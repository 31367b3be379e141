"""apex_tpu_torch.optimizers: fused optimizers (counterpart of
``apex_tpu.optimizers``).  Ported so far: :class:`FusedAdam`, in plain
PyTorch, as the JAX ``FusedAdam`` is plain jnp; :class:`FusedLAMB`, plain
PyTorch unpacked and over the packed LAMB kernel with ``packed=True``; and
:class:`FusedAdagrad`, plain PyTorch unpacked and over the packed Adagrad
kernel with ``packed=True``.  Each takes ``master_weights=True`` and
``step(grad_scale=, found_inf=)`` (``_common.FusedOptimizer``)."""

from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedAdagrad", "FusedAdam", "FusedLAMB"]
