"""LARC: layer-wise adaptive rate clipping around a port optimizer
(counterpart of ``apex_tpu/parallel/LARC.py``).

apex's ``LARC`` (apex/parallel/LARC.py) wraps any optimizer: before the
inner step each parameter's gradient is scaled by

    adaptive_lr = trust_coefficient * ||p|| / (||g|| + wd * ||p|| + eps)

taken as ``min(adaptive_lr / lr, 1)`` with ``clip=True`` and as it is
otherwise, with the group's weight decay folded into the gradient first
(``g + wd * p``) and the inner step run with ``weight_decay`` 0, then
restored.  A parameter whose norm or gradient norm is 0 passes through
untouched, without the fold.

The per-parameter norms of a group's parameters and of its gradients are
two calls of :func:`apex_tpu_torch.ops.multi_tensor.l2norm` (``mt_l2norm``
on the card, its plain version on the CPU), each element squared and
summed in fp32.  The gradients must be unscaled: the inner optimizer's
``grad_scale=`` is refused, since the trust ratio reads the gradient's
norm.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops import multi_tensor as mt

__all__ = ["LARC"]


class LARC:
    """Wraps a ``torch.optim.Optimizer`` of the port; every attribute but
    ``step`` (``param_groups``, ``state``, ``zero_grad``, ``state_dict``)
    is the inner optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    def __getattr__(self, name):
        return getattr(self.optim, name)

    @torch.no_grad()
    def _adjust(self, group: dict) -> None:
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        wd = float(group.get("weight_decay", 0.0))
        lr = float(group["lr"])
        pn = mt.l2norm(params).per_tensor
        gn = mt.l2norm(grads).per_tensor
        adaptive = self.trust_coefficient * pn / (gn + wd * pn + self.eps)
        mult = torch.clamp(adaptive / lr, max=1.0) if self.clip else adaptive
        ok = (pn != 0.0) & (gn != 0.0)
        mult = torch.where(ok, mult, torch.ones_like(mult))
        fold = torch.where(ok, wd, 0.0)
        for i, (p, g) in enumerate(zip(params, grads)):
            g32 = g.float() + fold[i] * p.float()
            g.copy_(g32 * mult[i])

    def step(self, closure: Optional[Callable] = None, **kwargs):
        """Scale each gradient by its trust ratio (the weight decay folded
        in), then the inner step with each group's ``weight_decay`` 0; the
        decay is restored however the step ends.  Keywords (``found_inf``)
        go to the inner step."""
        if kwargs.get("grad_scale") is not None:
            raise ValueError("LARC reads the gradients' norms: unscale them "
                             "before the step instead of passing grad_scale")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        saved = []
        for group in self.optim.param_groups:
            self._adjust(group)
            saved.append(group.get("weight_decay", 0.0))
            group["weight_decay"] = 0.0
        try:
            self.optim.step(**kwargs)
        finally:
            for group, wd in zip(self.optim.param_groups, saved):
                group["weight_decay"] = wd
        return loss
