"""FusedAdagrad with the JAX ``FusedAdagrad`` semantics, as a
``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/optimizers/fused_adagrad.py`` (the
``multi_tensor_adagrad`` math of the CUDA original), with the original
apex API (``FusedAdagrad(params, lr=..., ...)``, ``opt.step()``).  For each
parameter, in fp32:

    g = g + wd * p                      (adagrad_w_mode=False, the default)
    h = h + g * g
    u = g / (sqrt(h) + eps)
    u = u + wd * p                      (adagrad_w_mode=True: decoupled)
    p = p - lr * u

Two paths, as in the JAX class:

- **unpacked** (the default): per-parameter plain PyTorch on every device,
  as the JAX path is plain jnp; ``h`` (``state["sum_sq"]``) fp32.
- **packed** (``packed=True``): each group's gradients and parameters (or
  masters) are concatenated into flat fp32 buffers
  (:mod:`apex_tpu_torch.utils.packing`) and updated by
  :func:`~apex_tpu_torch.ops.packed_update.packed_adagrad_update`, on the
  card the CUDA kernel ``csrc/packed_adagrad.cu``; each is copied back in
  its own dtype.  The flat fp32 ``h`` lives in the state of the group's
  first parameter; a parameter without a gradient raises.

The step is :class:`~apex_tpu_torch.optimizers._common.FusedOptimizer`'s:
fp32 masters with ``master_weights=True``, and ``step(grad_scale=,
found_inf=)``.  The JAX class applies ``found_inf`` after its update
(``apply_if_finite``); the packed path here passes it to the kernel as its
``noop`` flag instead, which leaves the same values without a second pass.
The step counter (``state["step"]``, one int32 tensor a group) counts the
applied steps, as the JAX state's does; the update does not read it.
Unlike the JAX optimizer, this one updates the parameters and its state in
place.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.packed_update import packed_adagrad_update
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    commit,
    pack_unscaled,
    unscale_grads,
)
from apex_tpu_torch.utils.packing import make_packed_spec, pack_pytree

__all__ = ["FusedAdagrad"]


class FusedAdagrad(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False,
                 master_weights: bool = False, packed: bool = False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults, master_weights=master_weights,
                         packed=packed)
        self.adagrad_w_mode = adagrad_w_mode

    def _update(self, work, skip, grad_scale) -> None:
        for group, params, grads, targets in work:
            step = self._group_step(params)
            hyper = dict(lr=group["lr"], eps=group["eps"],
                         weight_decay=group["weight_decay"])
            if self.packed:
                self._packed_group(params, pack_unscaled(grads, grad_scale),
                                   targets, step, hyper, skip)
            else:
                grads = unscale_grads(grads, grad_scale)
                for p, g, t in zip(params, grads, targets):
                    state = self.state[p]
                    if "sum_sq" not in state:
                        state["step"] = step
                        state["sum_sq"] = torch.zeros_like(
                            p, dtype=torch.float32,
                            memory_format=torch.preserve_format)
                    h = state["sum_sq"]
                    p_new, h_new = self._adagrad(t, g, h, **hyper)
                    commit(t, p_new, skip)
                    commit(h, h_new, skip)
            self._advance(step, skip)
            self._copy_back(params, targets)

    def _packed_group(self, params, flat_g, targets, step, hyper, skip):
        spec = make_packed_spec(list(targets))
        state = self.state[params[0]]
        if "sum_sq" not in state:
            state["step"] = step
            state["sum_sq"] = torch.zeros(spec.padded_total,
                                          dtype=torch.float32,
                                          device=targets[0].device)
        flat_p = pack_pytree(list(targets), dtype=torch.float32).flat
        packed_adagrad_update(
            flat_g, flat_p, state["sum_sq"], adagrad_w_mode=self.adagrad_w_mode,
            noop_flag=skip, **hyper)
        # a skipped step left flat_p as packed, so each target gets its own
        # bits back
        for t, o, n in zip(targets, spec.offsets, spec.sizes):
            t.copy_(flat_p[o:o + n].view_as(t))

    def _adagrad(self, p, g, h, *, lr, eps, weight_decay):
        """New fp32 ``(p, h)``, the JAX leaf function's expressions; the
        inputs are not written."""
        wd = weight_decay
        p32 = p.float()
        if wd and not self.adagrad_w_mode:
            g = g + wd * p32
        h_new = h + g * g
        update = g / (torch.sqrt(h_new) + eps)
        if wd and self.adagrad_w_mode:
            update = update + wd * p32
        return p32 - lr * update, h_new
