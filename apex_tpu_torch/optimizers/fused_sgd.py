"""FusedSGD: momentum SGD with the JAX ``FusedSGD`` semantics, as a
``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py`` (the
``multi_tensor_sgd`` math of the CUDA original), with the original apex API
(``FusedSGD(params, lr, momentum=..., ...)``, ``opt.step()``).  For each
parameter with a gradient, in fp32:

    g = g + wd * p                      (wd_after_momentum=False)
    buf = g                             (the group's first step)
    buf = momentum * buf + (1 - dampening) * g          (later steps)
    d = g + momentum * buf (nesterov), else buf         (momentum 0: d = g)
    d = d + wd * p                      (wd_after_momentum=True)
    p = p - lr * d

The first step is the group's step counter reaching 1, on the device (no
host sync), as the JAX state's one step decides it.  ``momentum_buffer``
(fp32, one a parameter) is kept even at momentum 0, as in the JAX state.

Plain PyTorch on every device, a parameter at a time, as the JAX class is
plain jnp: no kernel of the port runs it (a multi-tensor SGD kernel is a
candidate for the walker of ``csrc/multi_tensor_apply.cuh``).  The step is
:class:`~apex_tpu_torch.optimizers._common.FusedOptimizer`'s:
``master_weights=True`` runs the update on fp32 masters,
``step(grad_scale=, found_inf=)`` unscales the gradients in fp32 and, where
``found_inf`` is true, keeps every value and the step counter as they
were.  ``materialize_master_grads`` is accepted for the API and not used.
Unlike the JAX optimizer, which returns new arrays, this one updates the
parameters and its state in place.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    commit,
    unscale_grads,
)

__all__ = ["FusedSGD"]


class FusedSGD(FusedOptimizer):
    def __init__(self, params, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 materialize_master_grads: bool = True,
                 master_weights: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov)
        super().__init__(params, defaults, master_weights=master_weights)
        self.wd_after_momentum = wd_after_momentum
        self.materialize_master_grads = materialize_master_grads

    def _update(self, work, skip, grad_scale) -> None:
        for group, params, grads, targets in work:
            grads = unscale_grads(grads, grad_scale)
            step = self._group_step(params)
            first = self._advance(step, skip) == 1
            lr, mu, damp = group["lr"], group["momentum"], group["dampening"]
            wd = group["weight_decay"]
            for p, g, t in zip(params, grads, targets):
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["step"] = step
                    state["momentum_buffer"] = torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.preserve_format)
                p32 = t.float()
                if wd and not self.wd_after_momentum:
                    g = g + wd * p32
                if mu:
                    buf = state["momentum_buffer"]
                    new_buf = torch.where(first, g, mu * buf + (1.0 - damp) * g)
                    d_p = g + mu * new_buf if group["nesterov"] else new_buf
                    commit(buf, new_buf, skip)
                else:
                    d_p = g
                if wd and self.wd_after_momentum:
                    d_p = d_p + wd * p32
                commit(t, p32 - lr * d_p, skip)
            self._copy_back(params, targets)
