"""FusedMixedPrecisionLamb: LAMB with its learning rate and step on the
device, and the JAX ``FusedMixedPrecisionLamb`` semantics, as a
``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/optimizers/fused_mixed_precision_lamb.py``, with
the original apex API (``FusedMixedPrecisionLamb(params, lr=..., step=...,
...)``, ``opt.step()``): each group's ``lr`` is a 0-d fp32 tensor on the
parameters' device (:meth:`set_lr` writes it there, with no host sync),
``step=`` is the step count the first update continues from, masters are on
by default (``master_weights=True``: half parameters, fp32 masters), and
the gradients are clipped by their global norm before the LAMB stages.  A
step, in fp32:

    clip = max(||g|| / max_grad_norm, 1)          (1 without max_grad_norm)
    g = g / clip
    m = b1 * m + b3 * g;   v = b2 * v + (1 - b2) * g * g
    u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
    p = p - lr * ratio * u,   ratio = ||p|| / ||u||

with ``ratio`` 1 where either norm is 0, and for every tensor when neither
``weight_decay`` nor ``use_nvlamb``.  On CUDA the global norm is one
``mt_l2norm`` over every gradient and each group's update one ``mt_lamb``
(two stages; the learning rate read on the device, the master's copy into
the half parameter in the same pass); on the CPU their plain versions
(:mod:`apex_tpu_torch.ops.multi_tensor`).  The step is
:class:`~apex_tpu_torch.optimizers._common.FusedOptimizer`'s
(``step(grad_scale=, found_inf=)``).  Unlike the JAX optimizer, this one
updates the parameters and its state in place.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    bias_corrections,
    inv_scale,
)

__all__ = ["FusedMixedPrecisionLamb"]


class FusedMixedPrecisionLamb(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, step: int = 0,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, master_weights: bool = True):
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging)
        super().__init__(params, defaults, master_weights=master_weights)
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self._init_step = int(step)
        for group in self.param_groups:
            group["lr"] = torch.full((), float(group["lr"]),
                                     dtype=torch.float32,
                                     device=group["params"][0].device)

    def set_lr(self, lr: Union[float, torch.Tensor]) -> None:
        """Write ``lr`` into every group's device learning rate (a number
        is filled in on the device; a tensor copied there)."""
        for group in self.param_groups:
            if isinstance(lr, torch.Tensor):
                group["lr"].copy_(lr.reshape(()))
            else:
                group["lr"].fill_(float(lr))

    def _group_step(self, params: Sequence[torch.Tensor]) -> torch.Tensor:
        for p in params:
            step = self.state[p].get("step") if p in self.state else None
            if step is not None:
                return step
        return torch.full((), self._init_step, dtype=torch.int32,
                          device=params[0].device)

    def _update(self, work, skip, grad_scale) -> None:
        if not work:
            return
        inv = inv_scale(grad_scale, work[0][1][0].device)
        clip = None
        if self.max_grad_norm:
            norm = mt.l2norm([g for _, _, grads, _ in work for g in grads],
                             inv).total
            clip = torch.clamp(norm / self.max_grad_norm, min=1.0)
        for group, params, grads, targets in work:
            b1, b2 = group["betas"]
            step = self._group_step(params)
            for p in params:
                state = self.state[p]
                if "exp_avg" not in state:
                    state["step"] = step
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(state["exp_avg"])
            nxt = self._advance(step, skip)
            bc1, bc2 = (bias_corrections(nxt, b1, b2)
                        if group["bias_correction"] else (None, None))
            wd = group["weight_decay"]
            mt.lamb(grads, targets, [self.state[p]["exp_avg"] for p in params],
                    [self.state[p]["exp_avg_sq"] for p in params],
                    lr=group["lr"], beta1=b1, beta2=b2,
                    beta3=1.0 - b1 if group["grad_averaging"] else 1.0,
                    eps=group["eps"], weight_decay=wd, adam_w_mode=True,
                    use_ratio=bool(wd or self.use_nvlamb), inv_scale=inv,
                    clip=clip, bc1=bc1, bc2=bc2, noop=skip,
                    copy=params if self.master_weights else None)
