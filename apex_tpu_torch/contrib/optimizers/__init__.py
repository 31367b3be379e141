"""apex_tpu_torch.contrib.optimizers: the ZeRO-2 distributed optimizers
(counterpart of ``apex_tpu/contrib/optimizers/__init__.py``):
``DistributedFusedAdam`` and ``DistributedFusedLAMB`` over
:class:`ZeROOptimizer`, their state sharded over a data-parallel process
group.  The JAX module's deprecated aliases of the maintained optimizers
(``FusedAdam``, ``FusedLAMB``, ``FusedSGD``, ``FP16_Optimizer``) resolve to
the port's maintained ones with a ``DeprecationWarning``, as there.
"""

import importlib as _importlib
import warnings as _warnings

from apex_tpu_torch.contrib.optimizers._zero_base import (
    ZeROOptimizer,
    ZeROState,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (
    DistributedFusedLAMB,
)

__all__ = [
    "ZeROOptimizer",
    "ZeROState",
    "DistributedFusedAdam",
    "DistributedFusedLAMB",
    "FusedAdam",
    "FusedLAMB",
    "FusedSGD",
    "FP16_Optimizer",
]

_LEGACY = {
    "FusedAdam": ("apex_tpu_torch.optimizers", "FusedAdam"),
    "FusedLAMB": ("apex_tpu_torch.optimizers", "FusedLAMB"),
    "FusedSGD": ("apex_tpu_torch.optimizers", "FusedSGD"),
    "FP16_Optimizer": ("apex_tpu_torch.fp16_utils", "FP16Optimizer"),
}


def __getattr__(name):
    if name in _LEGACY:
        module_name, attr = _LEGACY[name]
        _warnings.warn(
            f"apex_tpu_torch.contrib.optimizers.{name} is the deprecated "
            f"contrib duplicate; use {module_name}.{attr}",
            DeprecationWarning, stacklevel=2)
        return getattr(_importlib.import_module(module_name), attr)
    raise AttributeError(
        f"module 'apex_tpu_torch.contrib.optimizers' has no attribute "
        f"{name!r}")
