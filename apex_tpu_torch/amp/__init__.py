"""apex_tpu_torch.amp: mixed precision with the O0-O3 levels (counterpart
of ``apex_tpu/amp/__init__.py``).

``amp.initialize`` (``apex/amp/frontend.py``), ``scale_loss``
(``apex/amp/handle.py``) and the dynamic loss scaler, with nothing
patched: the policy is data, the scaler state is four tensors on the
device, and the step reads nothing on the host::

    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam

    amped = amp.initialize(model, opt_level="O2", half_dtype=torch.float16)
    opt = FusedAdam(model.parameters(), master_weights=True)
    scaler, state = amped.scaler, amped.scaler_state

    loss = amped.model(ids, labels=labels).mean()
    scaler.scale_loss(loss, state).backward()
    found_inf = scaler.has_overflow([p.grad for p in model.parameters()])
    opt.step(grad_scale=state.scale, found_inf=found_inf)
    state = scaler.update(state, found_inf)

The optimizer unscales the gradients in fp32 from ``grad_scale`` (the
JAX flow's ``scaler.unscale`` before ``opt.step``: a half parameter's
``.grad`` cannot hold the fp32 unscaled gradient); ``scaler.unscale``
gives the unscaled tree and ``found_inf`` together, for a caller that
needs the gradients themselves.

O1 keeps the parameters fp32 and casts the model's floating inputs to
the half dtype; the model's own layers take a mixed pair as the JAX
package's flax layers do (the examples' ``SimpleMLP`` and ResNet promote
it to fp32).  ``initialize(opt_level="O1")`` also installs the policy
process-wide for the policy-scoped op namespace
(:mod:`~apex_tpu_torch.amp.functional`, ops called as ``F.matmul(a, b)``
follow the cast lists of :mod:`~apex_tpu_torch.amp.lists`); a later
``initialize`` at another level leaves it installed, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn

from apex_tpu_torch.amp import functional, lists, quant
from apex_tpu_torch.amp.functional import active_policy, set_active_policy
from apex_tpu_torch.amp.quant import (
    INT8_QMAX,
    dequantize_int8,
    quantize_int8,
)
from apex_tpu_torch.amp.policy import (
    O0,
    O1,
    O2,
    O3,
    AmpModule,
    PrecisionPolicy,
    get_policy,
)
from apex_tpu_torch.amp.scaler import (
    LossScaler,
    LossScalerState,
    static_loss_scaler,
)

__all__ = ["initialize", "AmpState", "AmpModule", "functional", "lists",
           "active_policy", "set_active_policy", "PrecisionPolicy",
           "get_policy", "O0", "O1", "O2", "O3", "LossScaler",
           "LossScalerState", "static_loss_scaler", "state_dict",
           "load_state_dict", "quant", "INT8_QMAX", "quantize_int8",
           "dequantize_int8"]


@dataclasses.dataclass
class AmpState:
    """What ``initialize`` hands back: the model behind its policy (its
    parameters cast in place), the policy, the scaler and one scaler state
    a loss (``num_losses``, as in ``apex/amp/_initialize.py``)."""

    model: AmpModule
    policy: PrecisionPolicy
    scaler: LossScaler
    scaler_states: List[LossScalerState]

    @property
    def scaler_state(self) -> LossScalerState:
        return self.scaler_states[0]


def initialize(model: nn.Module, opt_level: str = "O1",
               half_dtype: torch.dtype = torch.bfloat16, num_losses: int = 1,
               loss_scale=None, **overrides) -> AmpState:
    """Configure mixed precision for ``model`` (``apex/amp/frontend.py``):
    cast its parameters by the level's policy, in place, and wrap it so its
    inputs and outputs follow the policy.  The scaler states live on the
    model's device.  ``loss_scale`` ("dynamic" or a number) and any policy
    field given as a keyword override the level's.  At O1 the policy is
    also installed for :mod:`~apex_tpu_torch.amp.functional`."""
    if loss_scale is not None:
        overrides["loss_scale"] = loss_scale
    policy = get_policy(opt_level, half_dtype=half_dtype, **overrides)
    # O1's patched-namespace semantics: ops called through amp.functional
    # follow this policy's cast lists from now on.  The other levels patch
    # nothing (apex's patch_torch_functions=False), and must not clobber
    # an O1 policy an earlier initialize installed.
    if opt_level == "O1":
        set_active_policy(policy)
    device = next(model.parameters()).device
    scaler = policy.make_scaler()
    return AmpState(model=policy.wrap_module(policy.cast_params(model)),
                    policy=policy, scaler=scaler,
                    scaler_states=[scaler.init(device)
                                   for _ in range(num_losses)])


def state_dict(amp_state: AmpState) -> dict:
    """Every loss scaler's state on the host (``amp.state_dict``), under
    the JAX package's keys."""
    return {f"loss_scaler{i}": amp_state.scaler.state_dict(s)
            for i, s in enumerate(amp_state.scaler_states)}


def load_state_dict(amp_state: AmpState, d: dict) -> AmpState:
    """``amp_state`` with its scaler states loaded from ``d`` (the port's
    :func:`state_dict` or the JAX package's), on the states' device."""
    dev = amp_state.scaler_state.scale.device
    states = [amp_state.scaler.load_state_dict(d[f"loss_scaler{i}"], dev)
              for i in range(len(amp_state.scaler_states))]
    return dataclasses.replace(amp_state, scaler_states=states)
