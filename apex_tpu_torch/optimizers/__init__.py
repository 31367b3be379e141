"""apex_tpu_torch.optimizers: fused optimizers (counterpart of
``apex_tpu.optimizers``): :class:`FusedAdam`, :class:`FusedLAMB`,
:class:`FusedMixedPrecisionLamb`, :class:`FusedAdagrad`, :class:`FusedSGD`
and :class:`FusedNovoGrad`.  On CUDA, FusedAdam runs the multi-tensor
kernel ``mt_adam`` and the two LAMBs ``mt_l2norm`` and ``mt_lamb``
(:mod:`apex_tpu_torch.ops.multi_tensor`), one launch over every tensor of a
group; FusedLAMB and FusedAdagrad with ``packed=True`` run the packed
kernels of :mod:`apex_tpu_torch.ops.packed_update`; FusedSGD and
FusedNovoGrad are plain PyTorch, as their JAX classes are plain jnp
(NovoGrad's per-tensor norms on ``mt_l2norm``).  Each takes
``master_weights=True`` and ``step(grad_scale=, found_inf=)``
(``_common.FusedOptimizer``)."""

from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedAdagrad", "FusedAdam", "FusedLAMB", "FusedMixedPrecisionLamb",
           "FusedNovoGrad", "FusedSGD"]
