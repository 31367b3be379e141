"""Megatron-style transformer building blocks (counterpart of
``apex_tpu.transformer``).  The submodules load on first use, as
attributes of this package too (``apex_tpu_torch.transformer.moe``); the
four enums are imported with it, as JAX's package imports them."""

import importlib as _importlib

from apex_tpu_torch.transformer.enums import (
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)

_SUBMODULES = ("parallel_state", "enums", "tensor_parallel",
               "pipeline_parallel", "context_parallel", "moe", "functional",
               "layers", "amp", "testing", "recompute", "microbatches",
               "log_util", "_data")


def __getattr__(name):
    if name in _SUBMODULES:
        module = _importlib.import_module(f"apex_tpu_torch.transformer.{name}")
        globals()[name] = module
        return module
    raise AttributeError(
        f"module 'apex_tpu_torch.transformer' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
