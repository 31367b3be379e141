"""apex_tpu_torch.fused_dense: GEMM + bias (+ GeLU + GEMM) dense layers
(counterpart of ``apex_tpu.fused_dense``, apex's ``fused_dense``).

The JAX package computes these products outside any Pallas kernel (XLA
fuses bias and GeLU into the GEMM), so the port's are ``F.linear`` on
cuBLAS.  Its dtype rules are JAX's: each product accumulates in fp32 and
is rounded to the input's dtype (a half input's product by cuBLAS, which
accumulates in fp32; an fp32 input's in full fp32 unless the caller
enables TF32), and the bias is added after, in that dtype.

The functions take JAX's ``kernel`` ``[in, out]``; the modules hold
apex's ``weight`` ``[out, in]`` (``nn.Linear``'s layout;
:func:`~apex_tpu_torch.models.convert.dense_params_from_jax` carries a
flax tree over) and take their input width up front, as apex's do
(flax infers it from the first input).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = [
    "linear_bias",
    "linear_gelu_linear",
    "FusedDense",
    "FusedDenseGeluDense",
    "DenseNoBias",
]


def linear_bias(x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor = None) -> torch.Tensor:
    """``y = x @ kernel (+ bias)``, ``kernel`` ``[in, out]`` in ``x``'s
    dtype; the bias (any dtype) cast to ``y``'s and added after the
    product's rounding, as JAX adds it."""
    y = F.linear(x, kernel.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def linear_gelu_linear(x, kernel1, bias1, kernel2, bias2) -> torch.Tensor:
    """``y = gelu(x @ k1 + b1) @ k2 + b2``, the tanh-approximated GeLU of
    the reference kernel."""
    h = F.gelu(linear_bias(x, kernel1, bias1), approximate="tanh")
    return linear_bias(h, kernel2, bias2)


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a truncated normal (at 2 standard
    deviations) of variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)


def _weight(out_f: int, in_f: int, device, dtype) -> nn.Parameter:
    w = torch.empty(out_f, in_f, device=resolve_device(device), dtype=dtype)
    return nn.Parameter(_lecun_normal_(w, in_f))


def _bias(out_f: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(out_f, device=resolve_device(device),
                                    dtype=dtype))


class FusedDense(nn.Module):
    """Linear + bias (apex's ``FusedDense``): ``weight`` ``[out, in]``,
    ``bias`` ``[out]``, the parameters in ``dtype`` (fp32 by default, the
    JAX module's ``param_dtype``), the weight cast to the input's dtype.
    CUDA by default."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _weight(out_features, in_features, device, dtype)
        self.bias = _bias(out_features, device, dtype) if bias else None

    def forward(self, x):
        return linear_bias(x, self.weight.t(), self.bias)


class DenseNoBias(FusedDense):
    """Bias-free linear (apex's ``DenseNoBias``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=dtype)


class FusedDenseGeluDense(nn.Module):
    """Linear + GeLU + linear (apex's ``FusedDenseGeluDense``):
    ``weight1`` ``[intermediate, in]``, ``bias1``, ``weight2`` ``[out,
    intermediate]``, ``bias2``."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight1 = _weight(intermediate_features, in_features, device,
                               dtype)
        self.bias1 = _bias(intermediate_features, device, dtype)
        self.weight2 = _weight(out_features, intermediate_features, device,
                               dtype)
        self.bias2 = _bias(out_features, device, dtype)

    def forward(self, x):
        return linear_gelu_linear(x, self.weight1.t(), self.bias1,
                                  self.weight2.t(), self.bias2)
