"""FusedNovoGrad: NovoGrad with a per-tensor scalar second moment and the
JAX ``FusedNovoGrad`` semantics, as a ``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/optimizers/fused_novograd.py`` (the
``multi_tensor_novograd`` math of the CUDA original), with the original
apex API (``FusedNovoGrad(params, lr=..., ...)``, ``opt.step()``).  For each
parameter with a gradient, in fp32, ``v`` one scalar a tensor:

    v = ||g||^2 (or 0 with init_zero)   (the group's first step)
    v = b2 * v + (1 - b2) * ||g||^2     (later steps)
    g_hat = g / (sqrt(v / bc2) + eps);  g_hat = g_hat + wd * p  (reg_inside_moment)
    m = b1 * m + b3 * g_hat             (b3 = 1 - b1 with grad_averaging, else 1)
    u = m / bc1;                        u = u + wd * p  (otherwise)
    p = p - lr * u

with ``bc1, bc2 = 1 - b1**step, 1 - b2**step`` (1 without
``bias_correction``) from the group's step counter on the device.

Two paths, as in the JAX class:

- **unpacked** (the default): plain PyTorch a parameter at a time, except
  the per-tensor ``||g||^2``, which on CUDA is one ``mt_l2norm`` over every
  gradient of the group (:mod:`apex_tpu_torch.ops.multi_tensor`); ``m``
  fp32 like the parameter, ``v`` (``exp_avg_sq``) a 0-d fp32 tensor.
- **packed** (``packed=True``): the group's gradients and parameters packed
  into flat fp32 buffers and updated by the plain
  :func:`~apex_tpu_torch.ops.packed_update.packed_novograd_update` (the JAX
  one is jnp, with no Pallas kernel); the flat ``m`` and the ``[num_leaves
  + 1]`` ``v`` live in the state of the group's first parameter.

The NovoGrad update is a candidate for the multi-tensor walker; it stays
plain.  The step is
:class:`~apex_tpu_torch.optimizers._common.FusedOptimizer`'s: fp32 masters
with ``master_weights=True``, and ``step(grad_scale=, found_inf=)``.
``norm_type`` other than 2 raises, as in the JAX class.  Unlike the JAX
optimizer, this one updates the parameters and its state in place.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops.packed_update import packed_novograd_update
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    bias_corrections,
    commit,
    inv_scale,
    pack_unscaled,
)
from apex_tpu_torch.utils.packing import make_packed_spec, pack_pytree

__all__ = ["FusedNovoGrad"]


class FusedNovoGrad(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_averaging: bool = False,
                 reg_inside_moment: bool = False, norm_type: int = 2,
                 init_zero: bool = False, master_weights: bool = False,
                 packed: bool = False):
        if norm_type != 2:
            raise RuntimeError("FusedNovoGrad only supports the L2 norm.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging)
        super().__init__(params, defaults, master_weights=master_weights,
                         packed=packed)
        self.reg_inside_moment = reg_inside_moment
        self.init_zero = init_zero

    def _update(self, work, skip, grad_scale) -> None:
        for group, params, grads, targets in work:
            b1, b2 = group["betas"]
            step = self._group_step(params)
            nxt = self._advance(step, skip)
            bc1, bc2 = (bias_corrections(nxt, b1, b2)
                        if group["bias_correction"] else (1.0, 1.0))
            hyper = dict(lr=group["lr"], beta1=b1, beta2=b2,
                         beta3=1.0 - b1 if group["grad_averaging"] else 1.0,
                         eps=group["eps"], weight_decay=group["weight_decay"],
                         bc1=bc1, bc2=bc2, first=nxt == 1)
            if self.packed:
                self._packed_group(params, pack_unscaled(grads, grad_scale),
                                   targets, step, hyper, skip)
            else:
                self._unpacked_group(params, grads, targets, step, grad_scale,
                                     hyper, skip)
            self._copy_back(params, targets)

    def _unpacked_group(self, params, grads, targets, step, grad_scale, hyper,
                        skip):
        inv = inv_scale(grad_scale, params[0].device)
        g_sq = mt.l2norm(grads, inv).per_tensor_sq
        lr, b1, b2, b3 = (hyper[k] for k in ("lr", "beta1", "beta2", "beta3"))
        wd, eps, first = hyper["weight_decay"], hyper["eps"], hyper["first"]
        for i, (p, g, t) in enumerate(zip(params, grads, targets)):
            state = self.state[p]
            if "exp_avg" not in state:
                state["step"] = step
                state["exp_avg"] = torch.zeros_like(
                    p, dtype=torch.float32, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros((), dtype=torch.float32,
                                                  device=p.device)
            m, v = state["exp_avg"], state["exp_avg_sq"]
            g32 = g.float() if inv is None else g.float() * inv
            p32 = t.float()
            v_upd = b2 * v + (1.0 - b2) * g_sq[i]
            v_init = torch.zeros_like(v) if self.init_zero else g_sq[i]
            v_new = torch.where(first, v_init, v_upd)
            g_hat = g32 / (torch.sqrt(v_new / hyper["bc2"]) + eps)
            if wd and self.reg_inside_moment:
                g_hat = g_hat + wd * p32
            m_new = b1 * m + b3 * g_hat
            update = m_new / hyper["bc1"]
            if wd and not self.reg_inside_moment:
                update = update + wd * p32
            for dst, new in ((t, p32 - lr * update), (m, m_new), (v, v_new)):
                commit(dst, new, skip)

    def _packed_group(self, params, flat_g, targets, step, hyper, skip):
        spec = make_packed_spec(list(targets))
        state = self.state[params[0]]
        if "exp_avg" not in state:
            state["step"] = step
            state["exp_avg"] = torch.zeros(spec.padded_total,
                                           dtype=torch.float32,
                                           device=targets[0].device)
            state["exp_avg_sq"] = torch.zeros(spec.num_leaves + 1,
                                              dtype=torch.float32,
                                              device=targets[0].device)
        m, v = state["exp_avg"], state["exp_avg_sq"]
        p_new, m_new, v_new = packed_novograd_update(
            flat_g, pack_pytree(list(targets), dtype=torch.float32).flat, m, v,
            spec=spec, lr=hyper["lr"], beta1=hyper["beta1"],
            beta2=hyper["beta2"], beta3=hyper["beta3"], eps=hyper["eps"],
            weight_decay=hyper["weight_decay"],
            bias_correction1=hyper["bc1"], bias_correction2=hyper["bc2"],
            is_first_step=hyper["first"], init_zero=self.init_zero,
            reg_inside_moment=self.reg_inside_moment)
        commit(m, m_new, skip)
        commit(v, v_new, skip)
        for t, o, n in zip(targets, spec.offsets, spec.sizes):
            commit(t, p_new[o:o + n].view_as(t), skip)
