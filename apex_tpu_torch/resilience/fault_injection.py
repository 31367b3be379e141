"""Deterministic, seed-driven fault injection: the serving faults.

The port of the serving part of ``apex_tpu.resilience.fault_injection``:
the faults the scheduler's control plane is graded under, wired through
:class:`~apex_tpu_torch.serving.loadgen.LoadGenerator`'s ``step_hook``.
Each fires one ``fault_injected`` event through
:func:`~apex_tpu_torch._logging.emit_event`, as the JAX package's does.

- **Straggler decode steps**: :class:`SlowDecodeStep` inflates chosen
  scheduler steps on the injectable (virtual) clock — queueing and
  deadline pressure appear deterministically, while the token streams
  (clock-independent by construction) must stay bit-identical.
- **Abandoned streams**: :class:`StallStream` cancels chosen requests
  once they have emitted N tokens — the client that stopped reading;
  the scheduler must reclaim the slot without disturbing neighbors.
- **Cancellation storms**: :class:`CancelStorm` cancels a seed-chosen
  subset of in-flight/queued requests at chosen steps.

The JAX module's training faults (``FaultPlan`` / ``FaultInjector``,
``SlowStep``, ``FlakyIterator``, ``CorruptBatch``) wait for the
resilience slice; its weight and fleet faults (``ReloadStorm``,
``RegressingWeights``, ``KillReplica``, ``KillCanary``, ...) wait for the
reload, fleet and rollout slices.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from apex_tpu_torch._logging import emit_event

__all__ = ["CancelStorm", "SlowDecodeStep", "StallStream"]


class SlowDecodeStep:
    """Straggler scheduler steps: inflate chosen steps on the
    injectable clock.

    Install as a :class:`~apex_tpu_torch.serving.loadgen.LoadGenerator`
    ``step_hook``: at each configured (0-based) step index the hook
    advances ``clock`` — which must be the scheduler's own
    :class:`~apex_tpu_torch.serving.loadgen.VirtualClock` — by ``extra_s``,
    exactly as if that step's decode dispatch had stalled.  Queue wait,
    TTFT, and deadline pressure shift deterministically; the token
    streams must not move a bit (the scheduler's determinism contract:
    the clock feeds telemetry and policy, never token choice) — the
    chaos acceptance run asserts exactly that.
    """

    def __init__(self, steps: Iterable[int], extra_s: float, *, clock):
        if extra_s <= 0:
            raise ValueError(f"extra_s must be > 0, got {extra_s}")
        if not hasattr(clock, "advance"):
            raise ValueError(
                "SlowDecodeStep needs an advanceable clock — pass the "
                "scheduler's VirtualClock (a real monotonic clock "
                "cannot be inflated)")
        self.steps = frozenset(int(s) for s in steps)
        self.extra_s = float(extra_s)
        self._clock = clock

    def __call__(self, step: int, scheduler=None) -> None:
        if int(step) in self.steps:
            emit_event("fault_injected", fault="slow_decode_step",
                       step=int(step), extra_s=self.extra_s)
            self._clock.advance(self.extra_s)


class StallStream:
    """Abandoned-client streams: cancel chosen rids after N tokens.

    A client that stops reading mid-stream looks, server-side, like a
    request that must be cancelled to reclaim its slot.  Install as a
    ``step_hook``: once a configured rid's stream has emitted at least
    ``after_tokens`` tokens, it is cancelled (once).  The neighbors'
    streams must be bit-identical to an unstalled run — cancellation
    releases the slot, blocks, and pins without touching them.
    """

    def __init__(self, rids: Iterable[str], *, after_tokens: int = 2):
        if after_tokens < 1:
            raise ValueError(
                f"after_tokens must be >= 1, got {after_tokens}")
        self.rids = frozenset(str(r) for r in rids)
        self.after_tokens = int(after_tokens)
        self.stalled: list = []          # rids actually cancelled

    def __call__(self, step: int, scheduler) -> None:
        done = set(self.stalled)
        for rid in sorted(self.rids - done):
            if scheduler.phase_of(rid).value == "done":
                continue                 # finished before the stall bit
            tokens = scheduler.progress_of(rid)
            if tokens >= self.after_tokens:
                emit_event("fault_injected", fault="stall_stream",
                           rid=rid, step=int(step), tokens=tokens)
                scheduler.cancel(rid)
                self.stalled.append(rid)


class CancelStorm:
    """Mass-disconnect burst: cancel a seed-chosen subset of live
    requests at chosen steps.

    At each configured step, up to ``count`` rids are drawn
    (deterministically, from ``seed``) from everything currently
    queued or active on the scheduler and cancelled — the gateway
    -restart burst.  Surviving streams must be bit-identical to a
    storm-free run; every cancelled slot/block/pin must be reclaimed.
    ``cancelled`` records what the storm actually hit, for assertions.
    """

    def __init__(self, steps: Iterable[int], *, count: int = 2,
                 seed: int = 0):
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self.steps = frozenset(int(s) for s in steps)
        self.count = int(count)
        self.seed = int(seed)
        self.cancelled: list = []

    def __call__(self, step: int, scheduler) -> None:
        if int(step) not in self.steps:
            return
        live = sorted(scheduler.queued_rids + scheduler.active_rids)
        if not live:
            return
        rng = np.random.default_rng(self.seed + int(step))
        hit = [live[i] for i in sorted(
            rng.choice(len(live), size=min(self.count, len(live)),
                       replace=False))]
        emit_event("fault_injected", fault="cancel_storm",
                   step=int(step), rids=hit)
        for rid in hit:
            scheduler.cancel(rid)
            self.cancelled.append(rid)
