"""The manual mixed-precision helpers of apex.fp16_utils (counterpart of
``apex_tpu/fp16_utils/__init__.py``).

``network_to_half``, ``prep_param_lists``,
``master_params_to_model_params`` and ``model_grads_to_master_grads``
(``apex/fp16_utils/fp16util.py``), and :class:`FP16Optimizer`, the
master-weight wrapper of ``apex/fp16_utils/fp16_optimizer.py``: it runs any
of the port's optimizers on fp32 master copies of a half model's
parameters, under a loss scaler whose state stays on the device.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.amp.scaler import (
    LossScaler,
    LossScalerState,
    static_loss_scaler,
)
from apex_tpu_torch.optimizers._common import master_copy
from apex_tpu_torch.utils.packing import tree_leaves, tree_map
from apex_tpu_torch.utils.tree_math import tree_cast

__all__ = ["network_to_half", "prep_param_lists",
           "master_params_to_model_params", "model_grads_to_master_grads",
           "FP16Optimizer"]


def network_to_half(model: nn.Module,
                    half_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Every floating parameter of ``model`` in ``half_dtype``, in place
    (``fp16util.py``'s ``network_to_half``).  Returns the model."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(half_dtype)
    return model


def prep_param_lists(model: Union[nn.Module, Iterable[torch.Tensor]]
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``(model_params, master_params)``: the model's parameters and an
    fp32 master copy of each, a leaf that requires its gradient
    (``fp16util.py``'s ``prep_param_lists``)."""
    params = list(model.parameters() if isinstance(model, nn.Module)
                  else model)
    return params, [master_copy(p).requires_grad_() for p in params]


def master_params_to_model_params(master: Any, like: Any) -> Any:
    """The masters in the dtypes of ``like`` (a tree of the same
    structure), as new tensors."""
    likes = iter(tree_leaves(like))
    return tree_map(lambda m: m.detach().to(next(likes).dtype), master)


def model_grads_to_master_grads(grads: Any) -> Any:
    """The gradients in fp32."""
    return tree_cast(grads, torch.float32)


class FP16Optimizer:
    """An optimizer of the port run on fp32 masters of a half model's
    parameters, with loss scaling (``fp16_optimizer.py``'s
    ``FP16_Optimizer``).

    ``optimizer`` is built over the model's parameters; this wrapper puts
    an fp32 master copy in place of each in its parameter groups (as the
    original does), so the inner optimizer's state lives on the masters.
    A step: :meth:`scale_loss` and ``backward`` on the model; then
    :meth:`step` checks the model's gradients for an inf or a NaN, gives
    each master its gradient unscaled in fp32, steps the inner optimizer
    with that ``found_inf`` (a skipped step keeps every value), copies the
    masters back into the model's parameters, and updates the scaler,
    all on the device."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 static_loss_scale: Optional[float] = None,
                 dynamic_loss_scale: bool = True):
        self.optimizer = optimizer
        self.scaler: LossScaler = (
            LossScaler() if dynamic_loss_scale
            else static_loss_scaler(static_loss_scale or 1.0))
        self.model_params: List[torch.Tensor] = []
        self.master_params: List[torch.Tensor] = []
        for group in optimizer.param_groups:
            masters = []
            for p in group["params"]:
                m = master_copy(p).requires_grad_()
                self.model_params.append(p)
                self.master_params.append(m)
                masters.append(m)
            group["params"] = masters
        self.scaler_state: LossScalerState = self.scaler.init(
            self.model_params[0].device)

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss * scale`` in fp32: differentiate this one; :meth:`step`
        unscales the gradients."""
        return self.scaler.scale_loss(loss, self.scaler_state)

    def zero_grad(self) -> None:
        """Drop the model's and the masters' gradients."""
        for p in self.model_params + self.master_params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One step of the inner optimizer on the masters (see the class
        docstring); returns ``found_inf``, a 0-d bool on the device."""
        have = [(p, m) for p, m in zip(self.model_params, self.master_params)
                if p.grad is not None]
        grads, found_inf = self.scaler.unscale([p.grad for p, _ in have],
                                               self.scaler_state)
        for (_, m), g in zip(have, grads):
            m.grad = g
        self.optimizer.step(found_inf=found_inf)
        for p, m in zip(self.model_params, self.master_params):
            p.copy_(m)
        self.scaler_state = self.scaler.update(self.scaler_state, found_inf)
        return found_inf

    def state_dict(self) -> dict:
        """The masters, the inner optimizer's state and the scaler's
        (``fp16_optimizer.py``'s ``state_dict``): everything a resumed run
        needs to follow the same trajectory."""
        return {"master_params": [m.detach().cpu().clone()
                                  for m in self.master_params],
                "optimizer_state_dict": self.optimizer.state_dict(),
                "scaler": self.scaler.state_dict(self.scaler_state)}

    def load_state_dict(self, d: dict) -> None:
        """Inverse of :meth:`state_dict`: the masters (and the model's
        parameters from them), the inner state and the scaler."""
        with torch.no_grad():
            for m, p, saved in zip(self.master_params, self.model_params,
                                   d["master_params"]):
                m.copy_(saved)
                p.copy_(m)
        self.optimizer.load_state_dict(d["optimizer_state_dict"])
        self.scaler_state = self.scaler.load_state_dict(
            d["scaler"], self.model_params[0].device)
