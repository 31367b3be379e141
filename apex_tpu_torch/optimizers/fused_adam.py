"""FusedAdam: Adam / AdamW with the JAX ``FusedAdam`` semantics, as a
``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/optimizers/fused_adam.py``, with the original
apex API (``FusedAdam(params, lr=..., ...)``, ``opt.step()``).  For each
parameter with a gradient, in fp32 whatever the stored dtypes:

    g = g + wd * p                      (adam_w_mode=False: L2 into g)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    u = (m / bc1) / (sqrt(v / bc2) + eps)
    u = u + wd * p                      (adam_w_mode=True: decoupled)
    p = p - lr * u

with ``bc1, bc2 = 1 - b1**step, 1 - b2**step`` (1 without
``bias_correction``); ``p`` is stored back in its own dtype and ``m`` and
``v`` in ``state_dtype`` (bf16 moments halve the state and its traffic).
The update is a memory-bound pass over every parameter, so it runs as few
fp32 passes as plain PyTorch allows: in-place ``mul_``/``add_``,
``addcmul_`` for ``v`` and one ``addcdiv_`` for ``p - lr u`` (AdamW's decay
as ``p (1 - lr wd)`` first).  That regroups the JAX function's roundings,
so the two agree to fp32 rounding, not bit for bit.

Unlike the JAX optimizer, which returns new arrays, this one updates the
parameters and its state (``exp_avg``, ``exp_avg_sq``, ``step``) in place.
There is no Pallas kernel behind the JAX ``FusedAdam``: this is plain
PyTorch on every device.  ``amsgrad=True`` raises as the JAX class does;
``master_weights=True`` and the ``grad_scale`` / ``found_inf`` step
arguments raise ``NotImplementedError`` until the port's amp work.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.optimizers._common import bias_corrections, later_slice

__all__ = ["FusedAdam"]


class FusedAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, master_weights: bool = False,
                 state_dtype: torch.dtype = torch.float32):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        if master_weights:
            raise later_slice("FusedAdam(master_weights=True)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.adam_w_mode = adam_w_mode
        self.state_dtype = state_dtype

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None, *, grad_scale=None,
             found_inf=None):
        """One update of every parameter that has a gradient; returns the
        closure's loss when one is given."""
        if grad_scale is not None or found_inf is not None:
            raise later_slice("FusedAdam.step(grad_scale=, found_inf=)")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.state_dtype, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.state_dtype, memory_format=torch.preserve_format)
                state["step"] += 1
                if group["bias_correction"]:
                    bc1, bc2 = bias_corrections(state["step"], b1, b2)
                else:
                    bc1 = bc2 = 1.0
                self._update(p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                             lr, b1, b2, eps, wd, bc1, bc2)
        return loss

    def _update(self, p, g, m, v, lr, b1, b2, eps, wd, bc1, bc2):
        # fp32 working copies of p, m and v (an fp32 tensor is its own);
        # g is read as it is: an fp32 op on a bf16/fp16 operand widens it
        # exactly, as .float() would, and g is never written
        p32 = p.float() if p.dtype != torch.float32 else p
        g32 = g
        if not self.adam_w_mode and wd:
            g32 = p32.mul(wd).add_(g)
        m32 = m.float() if m.dtype != torch.float32 else m
        v32 = v.float() if v.dtype != torch.float32 else v
        m32.mul_(b1).add_(g32, alpha=1.0 - b1)
        v32.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
        denom = v32.div(bc2).sqrt_().add_(eps)
        if self.adam_w_mode and wd:
            p32.mul_(1.0 - lr * wd)
        p32.addcdiv_(m32, denom, value=-lr / bc1)
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)
