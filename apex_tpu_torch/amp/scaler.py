"""Loss scaling with its state on the device (counterpart of
``apex_tpu/amp/scaler.py``).

The dynamic loss scaler of apex (``apex/amp/scaler.py``), its static form
and the hysteresis update of ``csrc/update_scale_hysteresis.cu``, as in the
JAX package: the state is four 0-d tensors on the device
(:class:`LossScalerState`), ``found_inf`` is computed on the device, the
optimizer keeps its old values where it is true
(``FusedOptimizer.step(found_inf=)``), and :meth:`LossScaler.update` is
branch-free (``torch.where``).  Nothing in a step reads a value on the
host.  The calls are functional, as the JAX ones are: ``update`` returns a
new state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Union

import numpy as np
import torch

from apex_tpu_torch.multi_tensor_apply import _nonfinite
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers._common import unscale_grads
from apex_tpu_torch.utils.packing import tree_leaves, tree_map

__all__ = ["LossScaler", "LossScalerState", "static_loss_scaler"]


class LossScalerState(NamedTuple):
    """The scaler's state, four 0-d tensors on the device."""

    scale: torch.Tensor               # fp32, the current loss scale
    growth_tracker: torch.Tensor      # int32, clean steps since the last change
    hysteresis_tracker: torch.Tensor  # int32, overflows left before a backoff
    unskipped: torch.Tensor           # int32, steps applied in all


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Static, dynamic and hysteresis loss scaling.

    The defaults are apex's: an initial scale of 2**16, doubled after 2000
    clean steps, halved on an overflow (after ``hysteresis`` consecutive
    ones), kept within ``[min_loss_scale, max_loss_scale]``.
    ``dynamic=False`` is the static scaler (``loss_scale=N`` in
    ``amp.initialize``)."""

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    hysteresis: int = 1
    min_loss_scale: float = 1.0
    max_loss_scale: float = 2.0 ** 24
    dynamic: bool = True

    def init(self, device="cuda") -> LossScalerState:
        """A fresh state on ``device`` (CUDA by default): ``init_scale``,
        zeroed counters, a full hysteresis budget."""
        dev = resolve_device(device)
        return LossScalerState(
            scale=torch.full((), self.init_scale, dtype=torch.float32,
                             device=dev),
            growth_tracker=torch.zeros((), dtype=torch.int32, device=dev),
            hysteresis_tracker=torch.full((), self.hysteresis,
                                          dtype=torch.int32, device=dev),
            unskipped=torch.zeros((), dtype=torch.int32, device=dev))

    def scale_loss(self, loss: torch.Tensor,
                   state: LossScalerState) -> torch.Tensor:
        """``loss * scale`` in fp32 (``apex/amp/handle.py``)."""
        return loss.float() * state.scale

    def has_overflow(self, grads: Any) -> torch.Tensor:
        """A 0-d bool on the device, true if any gradient of the tree holds
        an inf or a NaN (apex's ``LossScaler.has_overflow``): the
        ``found_inf`` of a step whose optimizer unscales the gradients
        itself (``opt.step(grad_scale=state.scale, found_inf=...)``): on
        CUDA one ``mt_scale`` check over every gradient, with no output."""
        return _nonfinite(grads)

    def unscale(self, grads: Any, state: LossScalerState):
        """``(grads / scale, found_inf)``: the tree of gradients unscaled in
        fp32 (dividing a half gradient by 2**16 in its own precision would
        flush it to subnormals) and :meth:`has_overflow` of the scaled
        ones."""
        found_inf = self.has_overflow(grads)
        unscaled = iter(unscale_grads(tree_leaves(grads), state.scale))
        return tree_map(lambda _: next(unscaled), grads), found_inf

    def update(self, state: LossScalerState,
               found_inf: Union[bool, torch.Tensor], *,
               min_scale: Union[None, float, torch.Tensor] = None
               ) -> LossScalerState:
        """The state after a step (``csrc/update_scale_hysteresis.cu``),
        branch-free on the device.  ``min_scale`` overrides
        ``min_loss_scale`` as the floor of a backoff (a number or a 0-d
        tensor)."""
        found = torch.as_tensor(found_inf, device=state.scale.device
                                ).to(torch.bool)
        unskipped = state.unskipped + (~found).to(torch.int32)
        if not self.dynamic:
            return state._replace(unskipped=unskipped)
        # the tracker is reset on every clean step, so only consecutive
        # overflows burn the hysteresis budget
        hys_after = torch.where(
            found, torch.clamp(state.hysteresis_tracker - 1, min=0),
            self.hysteresis).to(torch.int32)
        backoff = found & (hys_after <= 0)
        backed = state.scale * self.backoff_factor
        if isinstance(min_scale, torch.Tensor):
            backed = torch.maximum(backed, min_scale.to(torch.float32))
        else:
            backed = torch.clamp(backed, min=self.min_loss_scale
                                 if min_scale is None else float(min_scale))
        scale = torch.where(backoff, backed, state.scale)
        growth = torch.where(found, 0, state.growth_tracker + 1)
        grow_now = growth >= self.growth_interval
        scale = torch.where(
            grow_now, torch.clamp(scale * self.growth_factor,
                                  max=self.max_loss_scale), scale)
        # no reset on a backoff: a run of overflows keeps backing off once
        # the hysteresis is spent, as the CUDA kernel does
        growth = torch.where(grow_now, 0, growth).to(torch.int32)
        return LossScalerState(scale=scale.to(torch.float32),
                               growth_tracker=growth,
                               hysteresis_tracker=hys_after,
                               unskipped=unskipped)

    # -- checkpoints (amp.state_dict / load_state_dict) ----------------------
    def state_dict(self, state: LossScalerState) -> dict:
        """The state on the host, one numpy scalar a field, under the JAX
        scaler's keys (so either package loads the other's dict)."""
        return {k: np.asarray(v.detach().cpu().numpy())
                for k, v in state._asdict().items()}

    def load_state_dict(self, d: dict, device="cuda") -> LossScalerState:
        """A state on ``device`` from a :meth:`state_dict` dict, the port's
        or the JAX scaler's (numpy values, numbers or tensors)."""
        dev = resolve_device(device)

        def scalar(key, dtype):
            return torch.tensor(np.asarray(d[key]).item(), dtype=dtype,
                                device=dev)

        return LossScalerState(
            scale=scalar("scale", torch.float32),
            growth_tracker=scalar("growth_tracker", torch.int32),
            hysteresis_tracker=scalar("hysteresis_tracker", torch.int32),
            unskipped=scalar("unskipped", torch.int32))


def static_loss_scaler(loss_scale: float = 1.0) -> LossScaler:
    return LossScaler(init_scale=loss_scale, dynamic=False)
