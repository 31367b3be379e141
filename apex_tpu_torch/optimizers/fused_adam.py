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
``bias_correction``) from the group's step counter on the device; ``p`` is
stored back in its own dtype and ``m`` and ``v`` in ``state_dtype`` (bf16
moments halve the state and its traffic).  The update is a memory-bound
pass over every parameter, so it runs as few fp32 passes as plain PyTorch
allows: ``mul``/``add_``, ``addcmul_`` for ``v`` and one ``addcdiv`` for
``p - lr u`` (AdamW's decay as ``p (1 - lr wd)`` first, ``bc1`` folded
into the denominator).  That regroups the JAX function's roundings, so the
two agree to fp32 rounding, not bit for bit.

The step is :class:`~apex_tpu_torch.optimizers._common.FusedOptimizer`'s:
``master_weights=True`` keeps an fp32 master of each parameter
(``state["master_param"]``) that the update runs on, copied back into the
parameter after it; ``step(grad_scale=, found_inf=)`` unscales the
gradients and, where ``found_inf`` is true, keeps every value and the step
counter as they were, on the device.  Unlike the JAX optimizer, which
returns new arrays, this one updates the parameters and its state
(``exp_avg``, ``exp_avg_sq``, ``step``, ``master_param``) in place.  There
is no Pallas kernel behind the JAX ``FusedAdam``: this is plain PyTorch on
every device (the packed kernel, ``ops.packed_update.packed_adam_update``,
is called on flat buffers directly).  ``amsgrad=True`` raises as the JAX
class does.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    bias_corrections,
    commit,
)

__all__ = ["FusedAdam"]


class FusedAdam(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, master_weights: bool = False,
                 state_dtype: torch.dtype = torch.float32):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults, master_weights=master_weights)
        self.adam_w_mode = adam_w_mode
        self.state_dtype = state_dtype

    def _update(self, work, skip) -> None:
        for group, params, grads, targets in work:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            step = self._group_step(params)
            for p in params:
                state = self.state[p]
                if "exp_avg" not in state:
                    state["step"] = step
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.state_dtype,
                        memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.state_dtype,
                        memory_format=torch.preserve_format)
            nxt = self._advance(step, skip)
            if group["bias_correction"]:
                bc1, bc2 = bias_corrections(nxt, b1, b2)
            else:
                bc1 = bc2 = 1.0
            for p, g, t in zip(params, grads, targets):
                state = self.state[p]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                p_new, m_new, v_new = self._adam(t, g, m, v, lr, b1, b2, eps,
                                                 wd, bc1, bc2)
                for dst, new in ((t, p_new), (m, m_new), (v, v_new)):
                    commit(dst, new, skip)

    def _adam(self, p, g, m, v, lr, b1, b2, eps, wd, bc1, bc2):
        """New fp32 ``(p, m, v)``; the inputs are not written.  ``g`` is
        fp32; an fp32 op on a bf16/fp16 operand widens it exactly, as
        ``.float()`` would."""
        p32 = p.float()
        if not self.adam_w_mode and wd:
            g = p32.mul(wd).add_(g)
        m_new = m.float().mul(b1).add_(g, alpha=1.0 - b1)
        v_new = v.float().mul(b2).addcmul_(g, g, value=1.0 - b2)
        denom = v_new.div(bc2).sqrt_().add_(eps).mul_(bc1)
        if self.adam_w_mode and wd:
            p32 = p32.mul(1.0 - lr * wd)
        return p32.addcdiv(m_new, denom, value=-lr), m_new, v_new
