"""Shared pieces of the fused optimizers (counterpart of
``apex_tpu/optimizers/_common.py``).

The JAX package's master weights and its capturable ``grad_scale`` /
``found_inf`` step arguments come with the port's mixed-precision (amp)
slice (``amp/policy.py``, ``amp/scaler.py``), the one after GPT training;
until then they raise here.
"""

from __future__ import annotations

import torch

__all__ = ["bias_corrections", "later_slice"]


def bias_corrections(step: int, beta1: float, beta2: float):
    """``(1 - beta1**step, 1 - beta2**step)`` computed in fp32, as the JAX
    ``bias_corrections`` computes them from its int32 step, returned as
    Python floats (each exactly an fp32 value)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    bc1 = one - torch.tensor(beta1, dtype=torch.float32) ** t
    bc2 = one - torch.tensor(beta2, dtype=torch.float32) ** t
    return float(bc1), float(bc2)


def later_slice(what: str) -> NotImplementedError:
    """The error for an option of the JAX optimizers that the port has
    not reached yet."""
    return NotImplementedError(
        f"{what} comes with the port's mixed-precision (amp) slice, the "
        f"one after GPT training (amp/policy.py, amp/scaler.py)")
