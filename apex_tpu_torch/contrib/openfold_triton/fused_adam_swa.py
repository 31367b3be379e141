"""FusedAdamSWA: an Adam step and a stochastic weight average in one
update, as a ``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/contrib/openfold_triton/fused_adam_swa.py``, in
the port's optimizer idiom: ``FusedAdamSWA(params, lr=..., ...)`` and
``opt.step()``, updating the parameters and the state in place (the JAX
class returns new arrays).  Each parameter's state holds what the JAX
``AdamSWAState`` holds: ``step`` and ``n_averaged`` (int32 tensors on the
parameter's device), ``exp_avg`` and ``exp_avg_sq`` (fp32), the fp32
master copy ``state_params`` that the update runs on (so steps below a
half-precision parameter's resolution are kept), and the fp32 average
``swa_params``.  For each parameter with a gradient, in fp32:

    g = grad / grad_scale
    g = g + wd * p                      (ApexAdam, PyTorchAdam: L2 into g)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    p = p - (lr / bc1) * (m / (sqrt(v) / sqrt(bc2) + eps))       (PyTorchAdam)
    p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd * p])  (ApexAdam[W])
    swa = p if n_averaged == 0 else swa + (1 - decay) * (p - swa)

with ``bc1, bc2 = 1 - b1**step, 1 - b2**step`` (1 without
``bias_correction``), the average taken once ``step > swa_start_step``,
and the parameter stored back as ``p`` in its own dtype.  ``grad_scale``
and ``found_inf`` stay on the device: a true ``found_inf`` leaves the
parameters and all the state as they were, with no host sync.  The
expressions are the JAX function's, in its order, so the two agree to
fp32 rounding.  There is no Pallas kernel behind the JAX class: this is
plain PyTorch on every device.
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional

import torch

from apex_tpu_torch.optimizers._common import (
    apply_if_finite,
    bias_corrections,
    unscale_grads,
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

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            zero = lambda dt: torch.zeros((), dtype=dt, device=p.device)
            master = lambda: p.detach().clone().float()
            state["step"] = zero(torch.int32)
            state["n_averaged"] = zero(torch.int32)
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
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            for p, g in zip(params, unscale_grads([p.grad for p in params],
                                                  grad_scale)):
                self._update(p, g, self._state(p), group, found_inf)
        return loss

    def _update(self, p, g, state, group, found_inf) -> None:
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        mode = self.adam_math_mode
        step = state["step"] + 1
        if group["bias_correction"]:
            bc1, bc2 = bias_corrections(step, b1, b2)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=p.device)
        p32, m, v = state["state_params"], state["exp_avg"], state["exp_avg_sq"]
        if mode in (AdamMathType.ApexAdam, AdamMathType.PyTorchAdam):
            g = g + wd * p32
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        if mode is AdamMathType.PyTorchAdam:
            denom = torch.sqrt(v_new) / torch.sqrt(bc2) + eps
            p_new = p32 - (lr / bc1) * (m_new / denom)
        else:
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if mode is AdamMathType.ApexAdamW:
                update = update + wd * p32
            p_new = p32 - lr * update
        # the average of the new master values, past swa_start_step; the
        # first one copies them through
        n_avg, swa = state["n_averaged"], state["swa_params"]
        do_swa = step > self.swa_start_step
        averaged = torch.where(n_avg == 0, p_new,
                               swa + self._swa_weight * (p_new - swa))
        swa_new = torch.where(do_swa, averaged, swa)
        n_new = n_avg + do_swa.to(torch.int32)
        olds = [p, p32, m, v, swa, state["step"], n_avg]
        news = [p_new.to(p.dtype), p_new, m_new, v_new, swa_new, step, n_new]
        for dst, val in zip(olds, apply_if_finite(found_inf, news, olds)):
            dst.copy_(val)

    def swa_state_dict(self) -> List[torch.Tensor]:
        """The averaged model: each parameter's fp32 SWA average, in the
        order of the parameter groups (an fp32 copy of a parameter that has
        not been stepped yet)."""
        return [self.state[p]["swa_params"] if self.state[p]
                else p.detach().clone().float()
                for group in self.param_groups for p in group["params"]]
