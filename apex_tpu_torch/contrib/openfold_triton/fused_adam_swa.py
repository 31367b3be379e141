"""FusedAdamSWA: an Adam step and a stochastic weight average in one
update, as a ``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/contrib/openfold_triton/fused_adam_swa.py``, in
the port's optimizer idiom: ``FusedAdamSWA(params, lr=..., ...)`` and
``opt.step()``, updating the parameters and the state in place (the JAX
class returns new arrays).  The state holds what the JAX ``AdamSWAState``
holds: ``step`` and ``n_averaged``, one int32 tensor a group on the
device, shared by its parameters' states (the JAX state holds one scalar
for the whole tree; a parameter whose first gradient comes late takes the
group's counters), and for each parameter ``exp_avg`` and ``exp_avg_sq``
(fp32), the fp32 master copy ``state_params`` that the update runs on (so
steps below a half-precision parameter's resolution are kept), and the
fp32 average ``swa_params``.  For each parameter with a gradient, in fp32:

    g = grad / grad_scale
    g = g + wd * p                      (ApexAdam, PyTorchAdam: L2 into g)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    p = p - (lr / bc1) * (m / (sqrt(v) / sqrt(bc2) + eps))       (PyTorchAdam)
    p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd * p])  (ApexAdam[W])
    swa = p if n_averaged == 0 else swa + (1 - decay) * (p - swa)

with ``bc1, bc2 = 1 - b1**step, 1 - b2**step`` (1 without
``bias_correction``), the average taken once ``step > swa_start_step``,
and the parameter stored back as ``p`` in its own dtype.  On CUDA a
group's step is one launch of the multi-tensor kernel ``mt_adam`` in its
SWA mode (:func:`apex_tpu_torch.ops.multi_tensor.adam`: the gradient read
in place and multiplied by ``1 / grad_scale`` on the device, the master,
moments, average and half parameter written in one pass); on the CPU its
plain version, a parameter at a time.  ``grad_scale`` and ``found_inf``
stay on the device: a true ``found_inf`` leaves the parameters and all the
state as they were (the kernel returns before any load), with no host
sync.  The expressions are the JAX function's, in its order, so the two
agree to fp32 rounding.
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._common import (
    bias_corrections,
    commit,
    inv_scale,
    restore_state,
)

__all__ = ["AdamMathType", "FusedAdamSWA"]


class AdamMathType(enum.Enum):
    ApexAdam = 0
    ApexAdamW = 1
    PyTorchAdam = 2


class FusedAdamSWA(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adam_math_mode: AdamMathType = AdamMathType.ApexAdam,
                 bias_correction: bool = True, swa_decay_rate: float = 0.9,
                 swa_start_step: int = 0):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                        bias_correction=bias_correction)
        super().__init__(params, defaults)
        self.adam_math_mode = AdamMathType(adam_math_mode)
        self.swa_decay_rate = swa_decay_rate
        self.swa_start_step = swa_start_step
        # 1 - decay as the JAX class forms it, in fp32
        self._swa_weight = float(torch.tensor(1.0) - torch.tensor(
            swa_decay_rate, dtype=torch.float32))

    def _counters(self, params: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The group's int32 ``step`` and ``n_averaged`` on the device: the
        ones its parameters' states share, or new zeros."""
        for p in params:
            state = self.state.get(p)
            if state:
                return state["step"], state["n_averaged"]
        zero = lambda: torch.zeros((), dtype=torch.int32, device=params[0].device)
        return zero(), zero()

    def _state(self, p: torch.Tensor, step, n_averaged) -> dict:
        state = self.state[p]
        if not state:
            master = lambda: p.detach().clone().float()
            state["step"] = step
            state["n_averaged"] = n_averaged
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            state["state_params"] = master()
            state["swa_params"] = master()
        return state

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None, *, grad_scale=None,
             found_inf=None):
        """One update of every parameter that has a gradient; returns the
        closure's loss when one is given.  ``grad_scale`` divides the
        (loss-scaled) gradients; a true ``found_inf`` skips the step."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if found_inf is not None and not isinstance(found_inf, torch.Tensor):
            if found_inf:          # a host flag that is set: nothing moves
                return loss
            found_inf = None
        skip = None if found_inf is None else found_inf.to(torch.bool)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(params, group, grad_scale, skip)
        return loss

    def _update(self, params, group, grad_scale, skip) -> None:
        b1, b2 = group["betas"]
        step, n_avg = self._counters(params)
        states = [self._state(p, step, n_avg) for p in params]
        nxt = step + 1
        bc1, bc2 = (bias_corrections(nxt, b1, b2) if group["bias_correction"]
                    else (None, None))
        mode = {AdamMathType.ApexAdam: mt.SWA_APEX_ADAM,
                AdamMathType.ApexAdamW: mt.SWA_APEX_ADAMW,
                AdamMathType.PyTorchAdam: mt.SWA_PYTORCH_ADAM}[
                    self.adam_math_mode]
        mt.adam([p.grad for p in params], [s["state_params"] for s in states],
                [s["exp_avg"] for s in states], [s["exp_avg_sq"] for s in states],
                mode=mode, lr=group["lr"], beta1=b1, beta2=b2, eps=group["eps"],
                weight_decay=group["weight_decay"],
                inv_scale=inv_scale(grad_scale, params[0].device), bc1=bc1,
                bc2=bc2, noop=skip, copy=params,
                swa=[s["swa_params"] for s in states], step=nxt,
                n_averaged=n_avg, swa_weight=self._swa_weight,
                swa_start_step=self.swa_start_step)
        # the counters move after the kernel has read them
        n_new = n_avg + (nxt > self.swa_start_step).to(torch.int32)
        commit(n_avg, n_new, skip)
        commit(step, nxt, skip)

    def load_state_dict(self, state_dict: dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, then each state tensor
        in its saved dtype (fp32 masters, moments and averages beside half
        parameters) and ``step`` and ``n_averaged`` one tensor a group
        again."""
        super().load_state_dict(state_dict)
        restore_state(self, state_dict, shared=("step", "n_averaged"))

    def swa_state_dict(self) -> List[torch.Tensor]:
        """The averaged model: each parameter's fp32 SWA average, in the
        order of the parameter groups (an fp32 copy of a parameter that has
        not been stepped yet)."""
        return [self.state[p]["swa_params"] if self.state[p]
                else p.detach().clone().float()
                for group in self.param_groups for p in group["params"]]
