"""Serving control-plane policy: priorities, deadlines, tenant fairness.

Counterpart of ``apex_tpu/serving/policy.py``, copied whole (host
selection logic).

The FIFO :class:`~apex_tpu_torch.serving.scheduler.ContinuousBatchingScheduler`
answers "who is next" with arrival order alone, the default a scheduler
built without ``policy=`` keeps.  :class:`SchedulingPolicy` is the knob
for the rest, consumed by the scheduler at step boundaries:

- **Priority classes** (``Request.priority``, higher wins): admission
  always serves the highest priority class with an admissible request.
  With ``preemption`` enabled, a queued request may *preempt* a
  strictly lower-priority DECODE stream when no slot is free: the
  victim's cache state is captured (dense: ``capture_slot`` to host
  memory; paged: block references, no copy) and resumed later.  Within
  a class, preempted streams resume before fresh admissions.
- **Deadline shedding** (``Request.deadline_s``, relative to
  submission): at every step boundary a queued (or suspended) request
  whose deadline has already passed is shed (``finish_reason="shed"``)
  before it spends prefill budget.
- **Tenant fairness** (``Request.tenant``): within a priority class,
  queued requests are drawn from tenants by smooth weighted round-robin
  (:class:`WeightedRoundRobin`: deterministic, no RNG), and
  ``max_inflight_per_tenant`` caps any one tenant's active streams.

Everything here is host-side selection logic; preemption and resume ride
the engine's existing capture / restore / alias calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

__all__ = ["SchedulingPolicy", "WeightedRoundRobin"]


@dataclasses.dataclass(frozen=True)
class SchedulingPolicy:
    """Control-plane configuration for the continuous-batching
    scheduler (``ContinuousBatchingScheduler(..., policy=...)``).

    ``preemption``: allow a queued request to evict a strictly
    lower-priority DECODE stream when no slot is free (lossless — the
    victim resumes bit-exactly).  ``deadline_shedding``: shed queued
    requests whose ``deadline_s`` has already passed at each step
    boundary.  ``tenant_weights``: smooth-WRR weight per tenant
    (unlisted tenants get ``default_tenant_weight``); weights must be
    positive.  ``max_inflight_per_tenant``: cap on one tenant's
    concurrently active streams (``None`` = uncapped).
    """

    preemption: bool = True
    deadline_shedding: bool = True
    tenant_weights: Optional[Mapping[str, float]] = None
    default_tenant_weight: float = 1.0
    max_inflight_per_tenant: Optional[int] = None

    def __post_init__(self):
        if self.default_tenant_weight <= 0:
            raise ValueError(
                f"default_tenant_weight must be > 0, got "
                f"{self.default_tenant_weight}")
        if self.tenant_weights is not None:
            bad = {t: w for t, w in self.tenant_weights.items() if w <= 0}
            if bad:
                raise ValueError(
                    f"tenant weights must be > 0 (a zero-weight tenant "
                    f"would never be served — reject it at submit "
                    f"instead): {bad}")
        if (self.max_inflight_per_tenant is not None
                and self.max_inflight_per_tenant < 1):
            raise ValueError(
                f"max_inflight_per_tenant must be >= 1 (0 would "
                f"deadlock every queue), got "
                f"{self.max_inflight_per_tenant}")

    def weight_of(self, tenant: str) -> float:
        if self.tenant_weights is not None and tenant in self.tenant_weights:
            return float(self.tenant_weights[tenant])
        return float(self.default_tenant_weight)


class WeightedRoundRobin:
    """Smooth weighted round-robin over a dynamic tenant set.

    Classic nginx-style smooth WRR, deterministic and RNG-free: each
    :meth:`pick` over the currently *eligible* tenants adds every
    eligible tenant's weight to its running credit, selects the highest
    credit (lexicographic tie-break — stable across runs), and charges
    the winner the total weight added.  Over time each tenant is
    selected in proportion to its weight, and interleaved smoothly
    (AABAB… rather than AAABB… for 3:2) — a weight-5 tenant cannot
    monopolize five consecutive slots while a weight-1 tenant waits.

    Credits persist across picks for tenants that were temporarily
    ineligible (empty queue, at their in-flight cap), so a starved
    tenant re-enters with the priority its waiting earned.
    """

    def __init__(self, policy: SchedulingPolicy):
        self._policy = policy
        self._credit: Dict[str, float] = {}

    def snapshot(self) -> Dict[str, float]:
        """Copy of the credit state — pair with :meth:`restore` so a
        pick whose admission then fails (block-pool pressure) can be
        rolled back instead of silently charging the tenant for a slot
        it never got."""
        return dict(self._credit)

    def restore(self, state: Dict[str, float]) -> None:
        self._credit = dict(state)

    def pick(self, eligible) -> Optional[str]:
        """The next tenant among ``eligible`` (any iterable of tenant
        names; duplicates ignored), or ``None`` when empty."""
        tenants = sorted(set(eligible))
        if not tenants:
            return None
        total = 0.0
        for t in tenants:
            w = self._policy.weight_of(t)
            self._credit[t] = self._credit.get(t, 0.0) + w
            total += w
        # lexicographic tie-break: max() keeps the FIRST of equal
        # credits, and ``tenants`` is sorted — deterministic by name
        winner = max(tenants, key=lambda t: self._credit[t])
        self._credit[winner] -= total
        return winner
