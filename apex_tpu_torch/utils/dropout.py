"""Dropout drawn from an explicit ``torch.Generator``: the port's stand-in
for flax's ``nn.Dropout`` and for the int seed the flash kernels' in-kernel
dropout takes (the JAX modules draw both from a ``"dropout"`` PRNG key)."""

from __future__ import annotations

import torch

__all__ = ["dropout", "dropout_seed"]


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability ``1 -
    rate`` (a uniform draw from ``generator`` below it), kept values
    divided by ``1 - rate``, the others 0."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def dropout_seed(generator: torch.Generator) -> int:
    """The flash kernels' int seed for one call, drawn from ``generator``
    (the JAX module's ``randint(make_rng("dropout"), (), 0, 2**31 - 1)``);
    a generator on the card costs a host sync to read it."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device).item())
