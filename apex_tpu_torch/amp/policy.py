"""Precision policies: the O0-O3 levels of apex.amp (counterpart of
``apex_tpu/amp/policy.py``).

apex defines four levels through ``Properties``: the model's cast type,
the patched torch namespace (O1), fp32 batch norms, fp32 master weights
and the loss scale.  As in the JAX package the policy is data and is
applied explicitly: :meth:`PrecisionPolicy.cast_params` casts a module's
parameters once, in place, keeping the norm-like ones in fp32;
:meth:`PrecisionPolicy.wrap_module` casts a module's floating inputs to
the compute dtype and its floating outputs to the output dtype.  fp16
policies default to the dynamic loss scaler, bf16 ones to none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch
from torch import nn

from apex_tpu_torch.amp.scaler import LossScaler, static_loss_scaler
from apex_tpu_torch.utils.packing import tree_map

__all__ = ["AmpModule", "PrecisionPolicy", "O0", "O1", "O2", "O3",
           "get_policy"]

# Parameter-name fragments treated as norm-like and kept fp32 under
# keep_norm_fp32 (O2's keep_batchnorm_fp32); the JAX package's list, matched
# against the lowercased parameter name as it matches the tree path
_NORM_NAME_HINTS = ("norm", "bn", "batch_stats", "scale_param", "ln_")


def _cast_floating(x: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of a tree (a tensor, or a list, tuple or dict
    of trees) in ``dtype``; other leaves and non-tensors as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, (list, tuple, dict)):
        return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                        x)
    return x


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """The dtype rules of one training setup (apex.amp ``Properties``)."""

    opt_level: str
    param_dtype: torch.dtype    # the parameters' storage dtype
    compute_dtype: torch.dtype  # what matrix products run in
    output_dtype: torch.dtype   # what activations come out in
    keep_norm_fp32: bool        # keep_batchnorm_fp32
    master_weights: bool        # fp32 masters in the optimizer
    loss_scale: Union[str, float, None]  # "dynamic", a number, or None

    def cast_params(self, model: nn.Module) -> nn.Module:
        """Cast ``model``'s floating parameters to ``param_dtype`` in place,
        keeping fp32 those whose lowercased name holds a norm-like hint
        when ``keep_norm_fp32`` (O2's ``model.to(half)`` with the batch-norm
        exemption, ``apex/amp/_initialize.py``).  Returns the model."""
        if self.param_dtype == torch.float32:
            return model
        for name, p in model.named_parameters():
            if p.is_floating_point() and not self._keeps_fp32(name):
                p.data = p.data.to(self.param_dtype)
        return model

    def cast_state_dict(self, state: dict) -> dict:
        """A ``state_dict`` cast as :meth:`cast_params` casts the module's
        parameters (the same dtype for every name); the caller's tensors
        are not altered.  What the JAX ``cast_params`` does to a params
        tree, for a restored checkpoint."""
        if self.param_dtype == torch.float32:
            return dict(state)
        return {name: (t.to(self.param_dtype)
                       if t.is_floating_point() and not self._keeps_fp32(name)
                       else t)
                for name, t in state.items()}

    def _keeps_fp32(self, name: str) -> bool:
        return self.keep_norm_fp32 and any(h in name.lower()
                                           for h in _NORM_NAME_HINTS)

    def cast_inputs(self, *args):
        """Floating tensors of the arguments (trees included) in
        ``compute_dtype``; one argument comes back alone."""
        out = tuple(_cast_floating(a, self.compute_dtype) for a in args)
        return out[0] if len(args) == 1 else out

    def cast_output(self, x):
        """Floating tensors of a model's output tree in ``output_dtype``."""
        return _cast_floating(x, self.output_dtype)

    def wrap_module(self, module: nn.Module) -> "AmpModule":
        """``module`` behind :class:`AmpModule`: floating inputs in,
        floating outputs out, by this policy (the JAX ``wrap_apply``)."""
        return AmpModule(module, self)

    def make_scaler(self) -> LossScaler:
        """The scaler this policy prescribes: dynamic (the fp16 default), a
        static one at a fixed value, or the identity static 1.0 scaler when
        ``loss_scale`` is None (bf16 needs no scaling)."""
        if self.loss_scale == "dynamic":
            return LossScaler()
        if self.loss_scale is None:
            return static_loss_scaler(1.0)
        return static_loss_scaler(float(self.loss_scale))


class AmpModule(nn.Module):
    """A module run under a policy: each floating input (in the positional
    and keyword arguments, trees included) cast to ``compute_dtype``, each
    floating output to ``output_dtype``.  The wrapped module is
    ``.module``; its parameters are this module's."""

    def __init__(self, module: nn.Module, policy: PrecisionPolicy):
        super().__init__()
        self.module = module
        self.policy = policy

    def forward(self, *args, **kwargs):
        p = self.policy
        args = tuple(_cast_floating(a, p.compute_dtype) for a in args)
        kwargs = {k: _cast_floating(v, p.compute_dtype)
                  for k, v in kwargs.items()}
        return p.cast_output(self.module(*args, **kwargs))


def O0() -> PrecisionPolicy:
    """Pure fp32."""
    return PrecisionPolicy("O0", torch.float32, torch.float32, torch.float32,
                           False, False, None)


def O1(half_dtype: torch.dtype = torch.bfloat16) -> PrecisionPolicy:
    """Per-op mixed precision: fp32 parameters, half compute at the
    matrix products, fp32 norms and losses (applied through the
    policy-scoped op namespace, ``amp/functional.py``)."""
    ls = "dynamic" if half_dtype == torch.float16 else None
    return PrecisionPolicy("O1", torch.float32, half_dtype, torch.float32,
                           True, False, ls)


def O2(half_dtype: torch.dtype = torch.bfloat16) -> PrecisionPolicy:
    """"Almost half": half parameters and compute, fp32 norms, fp32
    master weights, the dynamic loss scale for fp16."""
    ls = "dynamic" if half_dtype == torch.float16 else None
    return PrecisionPolicy("O2", half_dtype, half_dtype, half_dtype, True,
                           True, ls)


def O3(half_dtype: torch.dtype = torch.bfloat16) -> PrecisionPolicy:
    """Pure half, no fp32 exemptions: the speed baseline."""
    return PrecisionPolicy("O3", half_dtype, half_dtype, half_dtype, False,
                           False, None)


_LEVELS = {"O0": O0, "O1": O1, "O2": O2, "O3": O3}


def get_policy(opt_level: str, half_dtype: torch.dtype = torch.bfloat16,
               **overrides) -> PrecisionPolicy:
    """The policy of an opt level, with any field overridden."""
    if opt_level not in _LEVELS:
        raise ValueError(f"Unexpected optimization level {opt_level!r} "
                         f"(expected O0..O3)")
    pol = _LEVELS[opt_level]() if opt_level == "O0" else \
        _LEVELS[opt_level](half_dtype)
    if overrides:
        pol = dataclasses.replace(pol, **overrides)
    return pol
