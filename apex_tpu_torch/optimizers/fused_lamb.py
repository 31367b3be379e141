"""FusedLAMB: the layer-wise adaptive large-batch optimizer with the JAX
``FusedLAMB`` semantics, as a ``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py``, with the original
apex API (``FusedLAMB(params, lr=..., ...)``, ``opt.step()``).  A step
first takes the global L2 norm of every gradient (over all parameter
groups) and the clip factor ``clip = max(norm / max_grad_norm, 1)`` (1
without ``max_grad_norm``), then for each parameter, in fp32:

    g = g / clip;               g = g + wd * p   (adam_w_mode=False)
    m = b1 * m + b3 * g         (b3 = 1 - b1 with grad_averaging, else 1)
    v = b2 * v + (1 - b2) * g * g
    u = (m / bc1) / (sqrt(v / bc2) + eps);       u = u + wd * p  (adam_w_mode)
    p = p - lr * ratio * u,     ratio = ||p|| / ||u||

with ``ratio`` 1 where either norm is 0, and for every parameter when
neither ``weight_decay`` nor ``use_nvlamb`` (NVLAMB applies it even to
undecayed tensors).  ``bc1, bc2 = 1 - b1**step, 1 - b2**step`` (1 without
``bias_correction``).  The clip factor stays on the device: no step waits
for the card.

Two paths, as in the JAX class:

- **unpacked** (the default): on CUDA the global norm is one ``mt_l2norm``
  over every gradient and each group's update one ``mt_lamb`` launch
  (tensor group by tensor group: stage 1, the moments and the
  ``||p||^2``, ``||u||^2`` partials; stage 2 after a barrier, the trust
  ratios and the apply, the update recomputed while L2 still holds the
  group, so no fp32 buffer the size of the model is kept), each gradient
  read in place; on the CPU
  their plain versions, a parameter at a time
  (:mod:`apex_tpu_torch.ops.multi_tensor`).  ``m`` and ``v`` stored in
  ``state_dtype`` (fp32 or bf16: bf16 halves the state and its traffic),
  computed in fp32.
- **packed** (``packed=True``): each group's gradients and parameters are
  concatenated into flat fp32 buffers (:mod:`apex_tpu_torch.utils.packing`)
  and updated by :func:`~apex_tpu_torch.ops.packed_update.packed_lamb_update`,
  whose phase 1 is the CUDA kernel ``csrc/lamb_phase1.cu`` on the card;
  each parameter is copied back in its own dtype.  The flat fp32 ``m`` and
  ``v`` (``exp_avg``, ``exp_avg_sq``) and the ``step`` live in the state of
  the group's first parameter.  ``state_dtype`` other than fp32 raises, as
  in the JAX class, and so does a parameter without a gradient.  Phase 2
  (the per-leaf norms and the apply) runs ``mt_l2norm`` and ``mt_lamb``'s
  stage 2 over the leaves' views of the flat buffers on CUDA.

The step is :class:`~apex_tpu_torch.optimizers._common.FusedOptimizer`'s,
on both paths: ``master_weights=True`` runs the update on fp32 masters
(``state["master_param"]``; on CUDA unpacked, copied into the parameter by
``mt_lamb``'s pass), ``step(grad_scale=, found_inf=)`` unscales the
gradients first (the clip factor comes from the unscaled ones) and, where
``found_inf`` is true, keeps every value and the group's step counter as
they were, on the device: the clip factor and the trust ratios are
computed but not applied.  Unlike the JAX optimizer, which returns new
arrays, this one updates the parameters and its state in place.
``amsgrad=True`` raises as the JAX class does.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops.packed_update import packed_lamb_update
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    bias_corrections,
    commit,
    inv_scale,
    pack_unscaled,
)
from apex_tpu_torch.utils.packing import make_packed_spec, pack_pytree

__all__ = ["FusedLAMB"]


class FusedLAMB(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 master_weights: bool = False, packed: bool = False,
                 state_dtype: torch.dtype = torch.float32):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad variant.")
        if packed and state_dtype != torch.float32:
            raise ValueError("packed=True keeps fp32 flat-buffer state; "
                             "state_dtype applies to the unpacked path only")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging)
        super().__init__(params, defaults, master_weights=master_weights,
                         packed=packed)
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.state_dtype = state_dtype

    def _clip(self, grads: List[torch.Tensor], inv: Optional[torch.Tensor]):
        """The global-norm clip factor of the unscaled gradients (``grads *
        inv``), a 0-d fp32 tensor on the device (``mt_l2norm`` on CUDA), or
        None (1) without ``max_grad_norm``."""
        if not self.max_grad_norm:
            return None
        norm = mt.l2norm(grads, inv).total
        return torch.clamp(norm / self.max_grad_norm, min=1.0)

    def _update(self, work, skip, grad_scale) -> None:
        if not work:
            return
        inv = inv_scale(grad_scale, work[0][1][0].device)
        # the global norm runs over every group's unscaled gradients
        clip = self._clip([g for _, _, grads, _ in work for g in grads], inv)
        for group, params, grads, targets in work:
            b1, b2 = group["betas"]
            hyper = dict(lr=group["lr"], beta1=b1, beta2=b2,
                         beta3=1.0 - b1 if group["grad_averaging"] else 1.0,
                         eps=group["eps"], weight_decay=group["weight_decay"])
            step = self._group_step(params)
            nxt = self._advance(step, skip)
            bc1, bc2 = (bias_corrections(nxt, b1, b2)
                        if group["bias_correction"] else (None, None))
            if self.packed:
                self._packed_group(params, pack_unscaled(grads, grad_scale),
                                   targets, step, clip, bc1, bc2, hyper, skip)
                self._copy_back(params, targets)
            else:
                self._unpacked_group(params, grads, targets, step, clip, inv,
                                     bc1, bc2, hyper, skip)

    # -- the packed path -----------------------------------------------------

    def _packed_group(self, params, flat_g, targets, step, clip, bc1, bc2,
                      hyper, skip):
        spec = make_packed_spec(list(targets))
        state = self.state[params[0]]
        if "exp_avg" not in state:
            state["step"] = step
            state["exp_avg"] = torch.zeros(spec.padded_total,
                                           dtype=torch.float32,
                                           device=targets[0].device)
            state["exp_avg_sq"] = torch.zeros_like(state["exp_avg"])
        m, v = state["exp_avg"], state["exp_avg_sq"]
        # phase 1 writes the moments in place: keep the old ones for a
        # skipped step
        old = None if skip is None else (m.clone(), v.clone())
        flat_p = pack_pytree(list(targets), dtype=torch.float32).flat
        packed_lamb_update(
            flat_g, flat_p, m, v, spec=spec,
            bias_correction1=1.0 if bc1 is None else bc1,
            bias_correction2=1.0 if bc2 is None else bc2,
            global_clip=1.0 if clip is None else clip,
            adam_w_mode=self.adam_w_mode, use_nvlamb=self.use_nvlamb, **hyper)
        if old is not None:
            torch.where(skip, old[0], m, out=m)
            torch.where(skip, old[1], v, out=v)
        for t, o, n in zip(targets, spec.offsets, spec.sizes):
            commit(t, flat_p[o:o + n].view_as(t), skip)

    # -- the unpacked path ---------------------------------------------------

    def _unpacked_group(self, params, grads, targets, step, clip, inv, bc1,
                        bc2, hyper, skip):
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
        mt.lamb(grads, targets, [self.state[p]["exp_avg"] for p in params],
                [self.state[p]["exp_avg_sq"] for p in params],
                adam_w_mode=self.adam_w_mode,
                use_ratio=bool(hyper["weight_decay"] or self.use_nvlamb),
                inv_scale=inv, clip=clip, bc1=bc1, bc2=bc2, noop=skip,
                copy=params if self.master_weights else None, **hyper)
