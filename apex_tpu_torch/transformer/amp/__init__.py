"""apex_tpu_torch.transformer.amp: the model-parallel-aware loss scaler
(counterpart of ``apex_tpu/transformer/amp/__init__.py``, apex's
``transformer.amp.GradScaler``).

:class:`GradScaler` is the dynamic :class:`~apex_tpu_torch.amp.LossScaler`
whose overflow flag is all-reduced with MAX over the model-parallel
group (tp x pp), so every shard of one model replica skips a step
together when any shard's gradients hold an inf or a NaN.  JAX's
``unscale`` takes the MAX over both axes
(``apex_tpu/transformer/amp/__init__.py:34-36``); one all-reduce over
the model-parallel group does the same here.

The JAX class reduces the flag in ``unscale``.  The port's fused
optimizers never call ``unscale``: a step takes ``found_inf =
scaler.has_overflow(grads)`` and hands it to ``opt.step(grad_scale=,
found_inf=)``.  So the reduction sits in :meth:`GradScaler.has_overflow`,
which ``unscale`` calls too.  It is one all-reduce of a one-element
device tensor: nothing is read on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.transformer.tensor_parallel.mappings import bound_group

__all__ = ["GradScaler"]


@dataclasses.dataclass(frozen=True)
class GradScaler(LossScaler):
    """A :class:`LossScaler` whose ``found_inf`` is the MAX over the
    model-parallel ranks: ``parallel_state``'s model-parallel group (tp x
    pp) once it is initialized, else the bound tensor-parallel region's
    group; with neither (one process) the flag is the local one, as the
    JAX scaler's outside ``shard_map``."""

    @classmethod
    def from_scaler(cls, scaler: LossScaler) -> "GradScaler":
        """A :class:`GradScaler` with ``scaler``'s settings (the one
        ``amp.initialize`` made, say)."""
        return cls(**dataclasses.asdict(scaler))

    def has_overflow(self, grads: Any) -> torch.Tensor:
        """The local ``found_inf`` (one ``mt_scale`` check on CUDA),
        all-reduced with MAX over the model-parallel group: a 0-d bool on
        the device."""
        from apex_tpu_torch.transformer import parallel_state

        found = super().has_overflow(grads)
        group = (parallel_state.get_model_parallel_group()
                 if parallel_state.model_parallel_is_initialized()
                 else bound_group())
        if group is None:
            return found
        flag = found.to(torch.float32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return flag[0] > 0
