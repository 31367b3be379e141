"""Shared pieces of the fused optimizers (counterpart of
``apex_tpu/optimizers/_common.py``).

:func:`unscale_grads` and :func:`apply_if_finite` are the capturable step
arguments of the JAX optimizers, on the device with no host sync:
``FusedAdamSWA`` (``contrib/openfold_triton``) takes ``grad_scale`` and
``found_inf`` through them.  ``FusedAdam``'s and ``FusedLAMB``'s master
weights and step arguments come with the port's mixed-precision (amp)
slice (``amp/policy.py``, ``amp/scaler.py``); until then they raise here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

__all__ = ["apply_if_finite", "bias_corrections", "later_slice",
           "unscale_grads"]


def bias_corrections(step: Union[int, torch.Tensor], beta1: float,
                     beta2: float):
    """``(1 - beta1**step, 1 - beta2**step)`` computed in fp32, as the JAX
    ``bias_corrections`` computes them from its int32 step.  For an int
    step, two Python floats (each exactly an fp32 value); for a step held
    in a tensor, two fp32 tensors on its device (no host sync)."""
    if isinstance(step, torch.Tensor):
        # a Python base and constant enter the fp32 ops as fp32 values; no
        # tensor is made on the host
        t = step.to(torch.float32)
        return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)
    t = torch.tensor(float(step), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    bc1 = one - torch.tensor(beta1, dtype=torch.float32) ** t
    bc2 = one - torch.tensor(beta2, dtype=torch.float32) ** t
    return float(bc1), float(bc2)


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


def apply_if_finite(found_inf: Optional[torch.Tensor],
                    new: Sequence[torch.Tensor],
                    old: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``found_inf ? old : new`` for each pair (the capturable skip): for
    a flag in a tensor, a select on its device with no host sync; a true
    flag keeps every value as it was.  Without a flag, ``new``."""
    if found_inf is None:
        return list(new)
    if not isinstance(found_inf, torch.Tensor):
        return list(old if found_inf else new)
    skip = found_inf.to(torch.bool)
    return [torch.where(skip, o, n) for n, o in zip(new, old)]


def later_slice(what: str) -> NotImplementedError:
    """The error for an option of the JAX optimizers that the port has
    not reached yet."""
    return NotImplementedError(
        f"{what} comes with the port's mixed-precision (amp) slice, the "
        f"one after GPT training (amp/policy.py, amp/scaler.py)")
