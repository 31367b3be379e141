"""Anomaly-aware stepping: localize, skip, degrade — never loop silently
(the port of ``apex_tpu.resilience.guarded``).

Layered on :mod:`apex_tpu_torch.amp.scaler`: the capturable step already
skips the optimizer update on overflow (``found_inf`` as the kernels'
``noop``), but a bare skip loop has two failure modes this module
closes:

1. **No localization.**  The global ``found_inf`` bit says *that* a step
   overflowed, not *where*.  :func:`nonfinite_counts` is the per-leaf
   census on the device (count of NaN/Inf elements per gradient leaf);
   :func:`nonfinite_report` renders it as ``{leaf path: count}`` on the
   host.
2. **No escape hatch.**  If the loss scale backs off to its floor and
   gradients *still* blow up, ``update`` skips forever.
   :func:`guarded_update` keeps a consecutive-skip counter in
   :class:`GuardState`; after ``patience`` consecutive skips it halves
   the dynamic scale floor (letting backoff continue below the
   configured ``min_loss_scale``).

Nothing here reads the device.  Where JAX emits the
``loss_scale_floor_halved`` event from inside the step (``lax.cond`` +
``jax.debug.callback``), the port keeps the trip on the device — the
step's ``metrics["floor_tripped"]`` — and :func:`fetch_metrics`, the
host's one read of a step's metrics, emits the event.  A step therefore
runs under ``torch.cuda.set_sync_debug_mode("error")``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.utils.serialization import (
    tree_flatten_with_path,
    tree_map_with_path,
)

__all__ = [
    "GuardConfig",
    "GuardState",
    "fetch_metrics",
    "guarded_update",
    "init_guard_state",
    "make_guarded_step",
    "nonfinite_counts",
    "nonfinite_report",
]


class GuardState(NamedTuple):
    """Skip bookkeeping, three 0-d tensors on the device (checkpointable
    alongside :class:`~apex_tpu_torch.amp.scaler.LossScalerState`, the
    JAX state's leaves)."""

    consecutive_skips: torch.Tensor  # int32, the current skip run
    total_skips: torch.Tensor        # int32, skipped steps in all
    scale_floor: torch.Tensor        # fp32, the dynamic min_loss_scale


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """``patience``: consecutive skips tolerated before degrading.
    ``floor_backoff``: factor applied to the dynamic floor on each trip.
    ``min_floor``: hard lower bound — below this the run is diverging and
    no loss scale can save it."""

    patience: int = 8
    floor_backoff: float = 0.5
    min_floor: float = 2.0 ** -14

    def __post_init__(self):
        # patience=0 would make the trip condition (consec >= patience)
        # true on clean steps and silently destroy loss scaling
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if not 0.0 < self.floor_backoff <= 1.0:
            raise ValueError(
                f"floor_backoff must be in (0, 1], got {self.floor_backoff}")
        if self.min_floor <= 0.0:
            raise ValueError(
                f"min_floor must be positive, got {self.min_floor}")


def init_guard_state(scaler: LossScaler, device="cuda") -> GuardState:
    """Zeroed counters on ``device`` (CUDA by default); the dynamic floor
    starts at the scaler's configured ``min_loss_scale``."""
    dev = resolve_device(device)
    return GuardState(
        consecutive_skips=torch.zeros((), dtype=torch.int32, device=dev),
        total_skips=torch.zeros((), dtype=torch.int32, device=dev),
        scale_floor=torch.full((), scaler.min_loss_scale,
                               dtype=torch.float32, device=dev))


def nonfinite_counts(grads: Any) -> Any:
    """Per-leaf count of non-finite elements: a tree like ``grads`` of 0-d
    int32 tensors on each leaf's device (nothing read on the host).

    The localizing refinement of the global overflow bit: the same
    traversal, but the result keeps the tree's structure."""
    # the elements less the finite ones: one pass and one reduction a
    # leaf (no negated copy)
    return tree_map_with_path(
        lambda _, g: g.numel() - torch.isfinite(g).sum(dtype=torch.int32),
        grads)


def nonfinite_report(counts: Any) -> dict:
    """Host-side ``{leaf path: nonfinite count}`` for the offending leaves
    only (empty dict == clean step), the paths ``jax.tree_util.keystr``'s.
    The counts come to the host in one copy."""
    flat = tree_flatten_with_path(counts)
    if not flat:
        return {}
    ts = [torch.as_tensor(c).reshape(()) for _, c in flat]
    values = torch.stack([t.to(ts[0].device) for t in ts]).cpu().tolist()
    return {p: int(v) for (p, _), v in zip(flat, values) if int(v)}


def guarded_update(
    scaler: LossScaler,
    state: LossScalerState,
    guard: GuardState,
    found_inf,
    config: GuardConfig = GuardConfig(),
) -> Tuple[LossScalerState, GuardState]:
    """``scaler.update`` plus skip accounting and bounded degradation;
    returns ``(state, guard)``.

    Branch-free device math: the consecutive-skip counter increments on
    overflow and resets on clean steps; when it reaches ``patience`` the
    dynamic floor halves (clamped at ``min_floor``) and the counter
    resets to give the lowered floor a fresh window.  No event is
    emitted here (that would read the device): the guarded step carries
    the trip to :func:`fetch_metrics`, which emits it.
    """
    return _guarded_update(scaler, state, guard, found_inf, config)[:2]


def _guarded_update(scaler, state, guard, found_inf, config):
    """:func:`guarded_update`'s ``(state, guard)`` and the trip, a 0-d
    bool on the device."""
    dev = state.scale.device
    found = torch.as_tensor(found_inf, device=dev).to(torch.bool)
    consec = torch.where(found, guard.consecutive_skips + 1,
                         torch.zeros_like(guard.consecutive_skips))
    tripped = consec >= config.patience
    new_floor = torch.where(
        tripped,
        torch.clamp(guard.scale_floor * config.floor_backoff,
                    min=config.min_floor),
        guard.scale_floor).to(torch.float32)
    new_state = scaler.update(state, found, min_scale=new_floor)
    # the trip forces a backoff when update() did not already back off
    # this step, so a trip step drops the scale exactly once — and never
    # for a static scaler, whose scale does not move at all
    if scaler.dynamic:
        already_backed = new_state.scale < state.scale
        forced = torch.maximum(state.scale * scaler.backoff_factor,
                               new_floor)
        new_state = new_state._replace(scale=torch.where(
            tripped & ~already_backed, forced, new_state.scale))
    new_guard = GuardState(
        consecutive_skips=torch.where(tripped, torch.zeros_like(consec),
                                      consec).to(torch.int32),
        total_skips=(guard.total_skips + found.to(torch.int32)),
        scale_floor=new_floor)
    return new_state, new_guard, tripped


def fetch_metrics(metrics: dict) -> dict:
    """The host's read of a guarded step's ``metrics``: every scalar as a
    Python number (one device-to-host copy) and ``nonfinite`` as
    :func:`nonfinite_report`'s dict.  When the step tripped the floor it
    emits ``loss_scale_floor_halved`` here, with JAX's fields — the event
    JAX emits from inside the step."""
    scalars = [(k, torch.as_tensor(v).reshape(()))
               for k, v in metrics.items() if k != "nonfinite"]
    dev = scalars[0][1].device
    vals = torch.stack([t.to(device=dev, dtype=torch.float64)
                        for _, t in scalars]).cpu().tolist()
    out = {}
    for (k, t), v in zip(scalars, vals):
        out[k] = (bool(v) if t.dtype == torch.bool
                  else float(v) if t.dtype.is_floating_point else int(v))
    out["nonfinite"] = nonfinite_report(metrics.get("nonfinite", {}))
    if out.get("floor_tripped"):
        emit_event("loss_scale_floor_halved", scale=out["scale"],
                   new_floor=out["scale_floor"],
                   consecutive_skips=out["skip_run"],
                   total_skips=out["total_skips"])
    return out


def make_guarded_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    optimizer,
    scaler: LossScaler,
    config: GuardConfig = GuardConfig(),
    *,
    grad_hook: Optional[Callable[[dict], dict]] = None,
) -> Callable:
    """Build the guarded train step, in PyTorch's idiom.

    ``loss_fn(model, batch) -> scalar``; ``optimizer`` a
    :class:`~apex_tpu_torch.optimizers.FusedOptimizer` over the model's
    parameters.  The returned function

    ``step(model, optimizer, sstate, gstate, batch)
        -> (sstate, gstate, metrics)``

    updates ``model`` and the optimizer (the step's ``optimizer``, or the
    one given here when it is None) in place, as the port's optimizers
    do: it scales the loss, back-propagates, passes the gradients
    ``{name: .grad}`` through ``grad_hook`` (a fault injector's
    ``inject_grads``, say; its result is what the step checks and steps
    from), takes ``found_inf`` (one ``mt_scale`` check on CUDA) and the
    per-leaf census of the scaled gradients (the unscale multiplies in
    fp32 by ``1 / scale``, which keeps a finite value finite), applies
    the capturable skip (the optimizer unscales in its kernel) and runs
    :func:`guarded_update`.  ``metrics`` is a dict of device scalars —
    ``loss``, ``found_inf``, ``skipped``, ``scale``, ``scale_floor``,
    ``consecutive_skips``, ``total_skips``, ``floor_tripped`` and
    ``skip_run`` (the skip run a trip ended) — plus the census under
    ``nonfinite``; :func:`fetch_metrics` reads them on the host.
    Nothing in the step reads the device.
    """
    default_opt = optimizer

    def step(model, optimizer, sstate: LossScalerState, gstate: GuardState,
             batch) -> Tuple[LossScalerState, GuardState, dict]:
        opt = default_opt if optimizer is None else optimizer
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        for _, p in named:
            p.grad = None
        loss = loss_fn(model, batch)
        scaler.scale_loss(loss, sstate).backward()
        grads = {n: p.grad for n, p in named if p.grad is not None}
        if grad_hook is not None:
            grads = grad_hook(grads)
        found_inf = scaler.has_overflow(list(grads.values()))
        counts = nonfinite_counts(grads)
        by_param = {p: grads[n] for n, p in named if n in grads}
        opt.step(grad_scale=sstate.scale, found_inf=found_inf,
                 grads=by_param)
        new_sstate, new_gstate, tripped = _guarded_update(
            scaler, sstate, gstate, found_inf, config)
        metrics = {
            "loss": loss.detach(),
            "found_inf": found_inf,
            "skipped": found_inf,
            "scale": new_sstate.scale,
            "scale_floor": new_gstate.scale_floor,
            "consecutive_skips": new_gstate.consecutive_skips,
            "total_skips": new_gstate.total_skips,
            "floor_tripped": tripped,
            "skip_run": torch.where(
                tripped, gstate.consecutive_skips + 1,
                new_gstate.consecutive_skips),
            "nonfinite": counts,
        }
        return new_sstate, new_gstate, metrics

    return step
