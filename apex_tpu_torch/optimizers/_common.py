"""Shared pieces of the fused optimizers (counterpart of
``apex_tpu/optimizers/_common.py``).

:class:`FusedOptimizer` is the capturable step of the JAX
``FusedOptimizer.step`` with fp32 master weights, in the port's idiom (a
``torch.optim.Optimizer`` that updates in place).  One step:

1. each gradient unscaled in fp32 (divided by ``grad_scale``): on CUDA
   inside the multi-tensor kernels, which read the gradient in place and
   multiply it by a device ``1 / grad_scale`` (:func:`inv_scale`), with no
   fp32 copy; on the packed paths in the flat fp32 buffer they are packed
   into (:func:`pack_unscaled`); elsewhere by :func:`unscale_grads`;
2. the update computed on the fp32 masters (``master_weights=True``) or on
   the parameters, by the subclass's ``_update``;
3. every value kept as it was where ``found_inf`` is true (the kernels'
   ``noop``, or :func:`commit`: a select on the device; no host sync);
4. the masters copied back into the parameters, each in its own dtype
   (fused into ``mt_adam`` and ``mt_lamb``'s pass; :meth:`_copy_back`
   elsewhere).

Each group's step counter is one int32 tensor on the device, shared by
the states of the group's parameters (``state["step"]``): it advances only
on a step that is applied, and the bias corrections come from it on the
device (:func:`bias_corrections`), once a group, not once a parameter.
``FusedAdamSWA`` (``contrib/openfold_triton``) uses :func:`inv_scale`,
:func:`commit`, :func:`bias_corrections` and :func:`restore_state` on its
own.
"""

from __future__ import annotations

from typing import (Callable, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from apex_tpu_torch.utils.packing import pack_pytree

__all__ = ["FusedOptimizer", "bias_corrections", "commit",
           "inv_scale", "is_half", "master_copy", "pack_unscaled",
           "restore_state", "unscale_grads"]


def bias_corrections(step: torch.Tensor, beta1: float, beta2: float):
    """``(1 - beta1**step, 1 - beta2**step)`` as two fp32 tensors on the
    step's device, computed in fp32 as the JAX ``bias_corrections``
    computes them from its int32 step (no host sync)."""
    # a Python base and constant enter the fp32 ops as fp32 values; no
    # tensor is made on the host
    t = step.to(torch.float32)
    return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)


def unscale_grads(grads: Sequence[torch.Tensor],
                  grad_scale: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """``grads / grad_scale`` in fp32 (the kernel-side inverse scale of a
    capturable Adam): one multiply by ``1 / grad_scale``, the reciprocal
    taken in fp32, on the device for a tensor scale.  Without a scale, the
    grads in fp32 (an fp32 grad is returned as it is, never written)."""
    g32 = [g.float() for g in grads]
    if grad_scale is None:
        return g32
    if isinstance(grad_scale, torch.Tensor):
        inv = 1.0 / grad_scale.to(torch.float32)
    else:
        inv = float(1.0 / torch.tensor(grad_scale, dtype=torch.float32))
    return [g * inv for g in g32]


def inv_scale(grad_scale: Union[None, float, torch.Tensor], device
              ) -> Optional[torch.Tensor]:
    """``1 / grad_scale`` as a 0-d fp32 tensor on ``device`` (the reciprocal
    taken in fp32, as :func:`unscale_grads` takes it), the multiplier the
    multi-tensor kernels apply to each gradient; None without a scale."""
    if grad_scale is None:
        return None
    if isinstance(grad_scale, torch.Tensor):
        return torch.reciprocal(grad_scale.to(device=device,
                                              dtype=torch.float32))
    inv = float(1.0 / torch.tensor(grad_scale, dtype=torch.float32))
    return torch.full((), inv, dtype=torch.float32, device=device)


def pack_unscaled(grads: Sequence[torch.Tensor],
                  grad_scale: Union[None, float, torch.Tensor]
                  ) -> torch.Tensor:
    """The gradients packed into one flat fp32 buffer
    (:func:`~apex_tpu_torch.utils.packing.pack_pytree`) and multiplied by
    :func:`inv_scale` there: the products :func:`unscale_grads` forms, with
    no fp32 copy of each gradient first (the packed paths' input)."""
    flat = pack_pytree(list(grads), dtype=torch.float32).flat
    inv = inv_scale(grad_scale, flat.device)
    return flat if inv is None else flat.mul_(inv)


def commit(dst: torch.Tensor, new: torch.Tensor,
           skip: Optional[torch.Tensor]) -> None:
    """Write ``new`` into ``dst`` (in ``dst``'s dtype), or, with a 0-d
    bool ``skip`` on the device, ``skip ? dst : new``: a true flag leaves
    ``dst``'s bits as they were."""
    if skip is None:
        dst.copy_(new)
    else:
        torch.where(skip, dst, new.to(dst.dtype), out=dst)


def master_copy(p: torch.Tensor) -> torch.Tensor:
    """An fp32 master copy of ``p`` that never aliases it: ``.float()`` of
    an fp32 parameter (a norm scale O2 keeps in fp32) would be the
    parameter itself, and the master and model values would be one."""
    return p.detach().to(torch.float32, copy=True)


def is_half(x: torch.Tensor) -> bool:
    return x.dtype in (torch.bfloat16, torch.float16)


#: one group's work: (group, the parameters it updates, their gradients as
#: they are, the tensors the update writes: masters or the parameters
#: themselves)
Work = Tuple[dict, List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def restore_state(opt: torch.optim.Optimizer, state_dict: dict,
                  shared: Sequence[str] = ("step",)) -> None:
    """After ``torch.optim.Optimizer.load_state_dict``: each state tensor
    back in its saved dtype (torch casts every floating one to its
    parameter's dtype, and these optimizers keep fp32 masters and moments
    beside half parameters), and each key of ``shared`` one tensor a group
    again, shared by its parameters' states."""
    saved_ids = [i for g in state_dict["param_groups"] for i in g["params"]]
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in zip(saved_ids, params):
        for key, val in state_dict["state"].get(i, {}).items():
            if isinstance(val, torch.Tensor):
                opt.state[p][key] = val.to(device=p.device, copy=True)
    for group in opt.param_groups:
        for key in shared:
            first = None
            for p in group["params"]:
                state = opt.state.get(p)
                if state and key in state:
                    first = state[key] if first is None else first
                    state[key] = first


class FusedOptimizer(torch.optim.Optimizer):
    """Base of the fused optimizers: the capturable step with master
    weights (see the module docstring).  A subclass implements
    ``_update(work, skip, grad_scale)``, which unscales the gradients (in a
    kernel or by :func:`unscale_grads`), updates each group's ``work``
    targets and its own state so that a true ``skip`` keeps every bit (a
    kernel's ``noop``, or :func:`commit`), advances the group's step with
    :meth:`_advance`, and copies masters back (:meth:`_copy_back`) where
    its kernel does not.
    ``packed`` is the packed path's contract: a step updates every
    parameter of a group, so each needs a gradient."""

    def __init__(self, params, defaults: dict, master_weights: bool = False,
                 packed: bool = False):
        super().__init__(params, defaults)
        self.master_weights = master_weights
        self.packed = packed

    def _params_to_update(self, group: dict, grads=None
                          ) -> List[torch.Tensor]:
        """The parameters a step updates: those with a gradient, in
        ``grads`` when it is given, else in ``.grad`` (with ``packed``,
        all of the group's, raising if one has none)."""
        def has(p):
            return p.grad is not None if grads is None else p in grads

        if not self.packed:
            return [p for p in group["params"] if has(p)]
        if not all(has(p) for p in group["params"]):
            raise ValueError(f"{type(self).__name__}(packed=True) updates "
                             f"every parameter of a group: each needs a "
                             f"gradient")
        return list(group["params"])

    def _update(self, work: List[Work], skip: Optional[torch.Tensor],
                grad_scale: Union[None, float, torch.Tensor]) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None, *,
             grad_scale: Union[None, float, torch.Tensor] = None,
             found_inf: Union[None, bool, torch.Tensor] = None,
             grads: Optional[Mapping[torch.Tensor, torch.Tensor]] = None):
        """One update of every parameter that has a gradient; returns the
        closure's loss when one is given.  ``grad_scale`` divides the
        (loss-scaled) gradients in fp32 before the update; a true
        ``found_inf`` (a 0-d tensor on the device, never read on the host)
        leaves the parameters, the masters, the optimizer state and the
        step counter as they were.  ``grads`` maps a parameter to the
        gradient to step from in place of its ``.grad``, of any float
        dtype: the fp32 microbatch sums of
        ``forward_backward_no_pipelining``, whose cast to a half
        ``.grad`` may overflow where the sums do not (the JAX optimizer
        steps from the sums)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if found_inf is not None and not isinstance(found_inf, torch.Tensor):
            if found_inf:          # a host flag that is set: nothing moves
                return loss
            found_inf = None
        skip = None if found_inf is None else found_inf.to(torch.bool)
        work = []
        for group in self.param_groups:
            params = self._params_to_update(group, grads)
            if not params:
                continue
            targets = ([self._master(p) for p in params]
                       if self.master_weights else params)
            work.append((group, params, [p.grad if grads is None
                                         else grads[p] for p in params],
                         targets))
        self._update(work, skip, grad_scale)
        return loss

    def _copy_back(self, params: Sequence[torch.Tensor],
                   targets: Sequence[torch.Tensor]) -> None:
        """With ``master_weights``, each master copied into its parameter
        in the parameter's dtype (a skipped step left both as they were,
        so the copy gives the parameter its own bits back)."""
        if self.master_weights:
            for p, m in zip(params, targets):
                p.copy_(m)

    def _master(self, p: torch.Tensor) -> torch.Tensor:
        state = self.state[p]
        if "master_param" not in state:
            state["master_param"] = master_copy(p)
        return state["master_param"]

    def _group_step(self, params: Sequence[torch.Tensor]) -> torch.Tensor:
        """The group's int32 step counter on the device: the one its
        parameters' states share, or a new 0 for a group never stepped."""
        for p in params:
            step = self.state[p].get("step") if p in self.state else None
            if step is not None:
                return step
        return torch.zeros((), dtype=torch.int32, device=params[0].device)

    @staticmethod
    def _advance(step: torch.Tensor, skip: Optional[torch.Tensor]
                 ) -> torch.Tensor:
        """Advance ``step`` by one in place, unless ``skip``; returns the
        step the update used (``step + 1``)."""
        nxt = step + 1
        commit(step, nxt, skip)
        return nxt

    def load_state_dict(self, state_dict: dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, then each state
        tensor back in its saved dtype (torch casts every floating one to
        its parameter's dtype, and these optimizers keep fp32 masters and
        moments beside half parameters), and each group's step counter
        one tensor again, shared by its parameters' states."""
        super().load_state_dict(state_dict)
        restore_state(self, state_dict)
