"""apex_tpu_torch.mlp: the whole-MLP module (counterpart of
``apex_tpu.mlp``, apex's ``mlp.MLP``): N stacked linear (+ bias) layers
with an activation between them ('none', 'relu' or 'sigmoid'), each layer
:func:`~apex_tpu_torch.fused_dense.linear_bias` (``F.linear`` on cuBLAS,
as the JAX package's layers are XLA's products).  The module holds apex's
``weight_i`` ``[out, in]`` and ``bias_i``."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from apex_tpu_torch.fused_dense import _bias, _weight, linear_bias

__all__ = ["MLP", "mlp_forward"]

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def mlp_forward(x, kernels: Sequence, biases: Sequence,
                activation: str = "relu"):
    """The full MLP chain over JAX's ``kernels`` ``[in, out]`` and
    ``biases`` (None entries for none), the activation between layers,
    not after the last."""
    try:
        act = _ACTIVATIONS[activation]
    except KeyError:
        raise ValueError(
            f"activation must be one of {sorted(_ACTIVATIONS)}, got "
            f"{activation!r}") from None
    n = len(kernels)
    for i, (k, b) in enumerate(zip(kernels, biases)):
        x = linear_bias(x, k, b)
        if i != n - 1:
            x = act(x)
    return x


class MLP(nn.Module):
    """Fused MLP module (apex's ``MLP``): ``mlp_sizes`` lists the layer
    widths including the input width; CUDA by default, parameters in
    ``dtype`` (fp32 by default)."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        sizes = list(mlp_sizes)
        if len(sizes) < 2:
            raise ValueError(
                "mlp_sizes must name at least input and output widths")
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(_ACTIVATIONS)}, got "
                f"{activation!r}")
        self.mlp_sizes, self.activation = sizes, activation
        self.num_layers = len(sizes) - 1
        for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.register_parameter(f"weight_{i}",
                                    _weight(d_out, d_in, device, dtype))
            self.register_parameter(
                f"bias_{i}", _bias(d_out, device, dtype) if bias else None)

    def forward(self, x):
        if x.shape[-1] != self.mlp_sizes[0]:
            raise ValueError(f"input width {x.shape[-1]} != mlp_sizes[0] "
                             f"{self.mlp_sizes[0]}")
        kernels = [getattr(self, f"weight_{i}").t()
                   for i in range(self.num_layers)]
        biases = [getattr(self, f"bias_{i}") for i in range(self.num_layers)]
        return mlp_forward(x, kernels, biases, self.activation)
