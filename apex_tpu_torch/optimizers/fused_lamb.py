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

- **unpacked** (the default): per-parameter plain PyTorch on every device,
  as the JAX path is plain jnp; ``m`` and ``v`` stored in ``state_dtype``
  (fp32 or bf16: bf16 halves the state and its traffic), computed in fp32.
- **packed** (``packed=True``): each group's gradients and parameters are
  concatenated into flat fp32 buffers (:mod:`apex_tpu_torch.utils.packing`)
  and updated by :func:`~apex_tpu_torch.ops.packed_update.packed_lamb_update`,
  whose phase 1 is the CUDA kernel ``csrc/lamb_phase1.cu`` on the card;
  each parameter is copied back in its own dtype.  The flat fp32 ``m`` and
  ``v`` (``exp_avg``, ``exp_avg_sq``) and the ``step`` live in the state of
  the group's first parameter.  ``state_dtype`` other than fp32 raises, as
  in the JAX class, and so does a parameter without a gradient.

Unlike the JAX optimizer, which returns new arrays, this one updates the
parameters and its state in place.  ``amsgrad=True`` raises as the JAX
class does; ``master_weights=True`` and the ``grad_scale`` / ``found_inf``
step arguments raise ``NotImplementedError`` until the port's amp work.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from apex_tpu_torch.ops.packed_update import packed_lamb_update
from apex_tpu_torch.optimizers._common import bias_corrections, later_slice
from apex_tpu_torch.utils.packing import make_packed_spec, pack_pytree
from apex_tpu_torch.utils.tree_math import tree_l2norm

__all__ = ["FusedLAMB"]


class FusedLAMB(torch.optim.Optimizer):
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
        if master_weights:
            raise later_slice("FusedLAMB(master_weights=True)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging)
        super().__init__(params, defaults)
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.packed = packed
        self.state_dtype = state_dtype

    def _clip(self, grads: List[torch.Tensor]):
        """The global-norm clip factor, a 0-d fp32 tensor on the device (or
        1.0 without ``max_grad_norm``)."""
        if not self.max_grad_norm:
            return 1.0
        norm = tree_l2norm(grads)
        return torch.clamp(norm / self.max_grad_norm, min=1.0)

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None, *, grad_scale=None,
             found_inf=None):
        """One update of every parameter that has a gradient (with
        ``packed``, of every parameter); returns the closure's loss when one
        is given."""
        if grad_scale is not None or found_inf is not None:
            raise later_slice("FusedLAMB.step(grad_scale=, found_inf=)")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.packed:
            self._packed_step()
        else:
            self._unpacked_step()
        return loss

    # -- the packed path -----------------------------------------------------

    def _packed_step(self):
        flat_grads = []
        for group in self.param_groups:
            params = group["params"]
            if any(p.grad is None for p in params):
                raise ValueError("FusedLAMB(packed=True) updates every "
                                 "parameter of a group: each needs a gradient")
            flat_grads.append(pack_pytree([p.grad for p in params],
                                          dtype=torch.float32).flat)
        clip = self._clip(flat_grads)
        for group, flat_g in zip(self.param_groups, flat_grads):
            params = group["params"]
            if not params:
                continue
            spec = make_packed_spec(list(params))
            state = self.state[params[0]]
            if not state:
                state["step"] = 0
                state["exp_avg"] = torch.zeros(spec.padded_total,
                                               dtype=torch.float32,
                                               device=flat_g.device)
                state["exp_avg_sq"] = torch.zeros_like(state["exp_avg"])
            state["step"] += 1
            b1, b2 = group["betas"]
            bc1, bc2 = (bias_corrections(state["step"], b1, b2)
                        if group["bias_correction"] else (1.0, 1.0))
            flat_p = pack_pytree(list(params), dtype=torch.float32).flat
            packed_lamb_update(
                flat_g, flat_p, state["exp_avg"], state["exp_avg_sq"],
                spec=spec, lr=group["lr"], beta1=b1, beta2=b2,
                beta3=1.0 - b1 if group["grad_averaging"] else 1.0,
                eps=group["eps"], weight_decay=group["weight_decay"],
                bias_correction1=bc1, bias_correction2=bc2, global_clip=clip,
                adam_w_mode=self.adam_w_mode, use_nvlamb=self.use_nvlamb)
            for p, o, n in zip(params, spec.offsets, spec.sizes):
                p.copy_(flat_p[o:o + n].view_as(p))

    # -- the unpacked path ---------------------------------------------------

    def _unpacked_step(self):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if not grads:
            return
        clip = self._clip(grads)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b3 = 1.0 - b1 if group["grad_averaging"] else 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.state_dtype,
                        memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.state_dtype,
                        memory_format=torch.preserve_format)
                state["step"] += 1
                bc1, bc2 = (bias_corrections(state["step"], b1, b2)
                            if group["bias_correction"] else (1.0, 1.0))
                self._update(p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                             clip, group["lr"], b1, b2, b3, group["eps"],
                             group["weight_decay"], bc1, bc2)

    def _update(self, p, g, m, v, clip, lr, b1, b2, b3, eps, wd, bc1, bc2):
        # fp32 working copies of p, m and v (an fp32 tensor is its own)
        p32 = p.float() if p.dtype != torch.float32 else p
        m32 = m.float() if m.dtype != torch.float32 else m
        v32 = v.float() if v.dtype != torch.float32 else v
        g32 = g.float() / clip                 # a new tensor: g is not written
        if not self.adam_w_mode and wd:
            g32.add_(p32, alpha=wd)
        m32.mul_(b1).add_(g32, alpha=b3)
        v32.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
        update = torch.div(m32, bc1).div_(v32.div(bc2).sqrt_().add_(eps))
        if self.adam_w_mode and wd:
            update.add_(p32, alpha=wd)
        if wd or self.use_nvlamb:
            p_norm = torch.linalg.vector_norm(p32)
            u_norm = torch.linalg.vector_norm(update)
            ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                                1.0)
            p32.addcmul_(update, ratio, value=-lr)
        else:
            p32.add_(update, alpha=-lr)
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)
