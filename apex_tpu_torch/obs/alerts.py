"""Deterministic SLO alerting over metrics-registry snapshots.

Production alerting (Prometheus alert rules; the multi-window
multi-burn-rate recipes the SRE workbook canonized) is wall-clock and
scrape-driven — rerun the same incident and the alert timeline shifts.
This engine keeps the *rule semantics* (thresholds, absence/staleness,
multi-window SLO burn rate, for-duration hysteresis, firing→resolved
lifecycle) but evaluates them **on the serving clock** the scheduler and
load generator already share: :meth:`AlertEngine.evaluate` is called at
the fleet step boundary with the router's ``now``, reads one registry
snapshot, and appends every transition to a ledger.  Same workload +
same seed + same virtual clock ⇒ **bit-identical alert ledger** —
alerts become a regression-testable artifact, not a flaky side channel.

Rules:

- :class:`ThresholdRule` — fire while ``metric <op> value`` (e.g.
  ``apex_serving_fleet_replicas_healthy < 3``).
- :class:`AbsenceRule` — fire when a series is missing or has not
  *changed* within ``stale_after_s`` (a wedged replica keeps its last
  gauge value forever; staleness is the tell).
- :class:`BurnRateRule` — the SLO page signal: over a long and a short
  trailing window, the bad-event fraction relative to the objective's
  error budget must exceed ``factor`` in BOTH windows (the short window
  gates flapping, the long window gates noise).  ``good``/``total``
  selectors address counters, gauges, or histogram cumulative buckets
  (``le=`` picks the "fast enough" bucket of a latency histogram).

The shared evaluation core is :class:`Condition` — one comparison,
usable standalone: the rolling-upgrade :class:`CanaryGate` verdict path
evaluates its regression checks through the same class, so gating and
alerting cannot drift apart.

Lifecycle: OK → PENDING (condition holds, ``for_duration_s`` not yet
served) → FIRING (``serving_alert_firing`` emitted →
``apex_serving_alerts_firing{rule}`` = 1 in the bridge) → OK
(``serving_alert_resolved``, gauge = 0).  Transitions also count into
``apex_serving_alert_transitions_total``.  Default-off identity: no
engine constructed ⇒ no events, no metrics, nothing.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.obs import metrics

__all__ = [
    "AbsenceRule",
    "AlertEngine",
    "BurnRateRule",
    "Condition",
    "OPS",
    "Selector",
    "ThresholdRule",
    "compare",
]

#: comparison vocabulary shared by alert rules and the canary gate
OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, b: v > b,
    ">=": lambda v, b: v >= b,
    "<": lambda v, b: v < b,
    "<=": lambda v, b: v <= b,
    "==": lambda v, b: v == b,
    "!=": lambda v, b: v != b,
}


def compare(op: str, value: float, bound: float) -> bool:
    """``value <op> bound`` with the :data:`OPS` vocabulary (raises on
    an unknown operator — a typo'd rule must fail at definition, not
    silently never fire)."""
    fn = OPS.get(op)
    if fn is None:
        raise ValueError(f"unknown comparison op {op!r} "
                         f"(choose from {sorted(OPS)})")
    return fn(float(value), float(bound))


@dataclasses.dataclass(frozen=True)
class Condition:
    """One comparison against a fixed bound — the evaluation atom both
    the alert rules and the canary gate run on."""

    op: str
    bound: float

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown comparison op {self.op!r} "
                             f"(choose from {sorted(OPS)})")

    def holds(self, value: float) -> bool:
        return OPS[self.op](float(value), float(self.bound))


def _series_value(snap: Mapping[str, dict], metric: str,
                  labels: Optional[Mapping[str, str]] = None,
                  le: Optional[float] = None) -> Optional[float]:
    """One series' value out of a registry snapshot: counter/gauge
    value, histogram count, or (``le=``) the cumulative count of the
    smallest bucket whose edge is >= ``le``.  None when the metric or
    the addressed series does not exist (absence is a *signal* —
    :class:`AbsenceRule` — never a fabricated 0.0)."""
    entry = snap.get(metric)
    if entry is None:
        return None
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    for series in entry.get("series", ()):
        if dict(series.get("labels", {})) != want:
            continue
        if entry.get("type") == "histogram":
            if le is None:
                return float(series["count"])
            edges = entry.get("buckets", [])
            counts = series.get("bucket_counts", [])
            for edge, cum in zip(edges, counts):
                if edge >= le:
                    return float(cum)
            # le past the last finite edge: the +Inf bucket == count
            return float(series["count"])
        return float(series["value"])
    return None


@dataclasses.dataclass(frozen=True)
class ThresholdRule:
    """Fire while ``metric <op> value`` holds (optionally for a
    specific label set; an absent series never fires — that is
    :class:`AbsenceRule`'s job)."""

    name: str
    metric: str
    op: str
    value: float
    for_duration_s: float = 0.0
    labels: Optional[Mapping[str, str]] = None

    def __post_init__(self):
        Condition(self.op, self.value)   # validate the op eagerly

    def evaluate(self, snap: Mapping[str, dict], now: float,
                 state: dict) -> Optional[float]:
        """The observed value while the condition holds, else None."""
        v = _series_value(snap, self.metric, self.labels)
        if v is None:
            return None
        return v if Condition(self.op, self.value).holds(v) else None


@dataclasses.dataclass(frozen=True)
class AbsenceRule:
    """Fire when the series is missing, or its value has not changed
    for ``stale_after_s`` on the engine clock (a crashed emitter leaves
    a frozen gauge; freshness is tracked per rule, not per scrape)."""

    name: str
    metric: str
    stale_after_s: float
    labels: Optional[Mapping[str, str]] = None
    for_duration_s: float = 0.0

    def evaluate(self, snap: Mapping[str, dict], now: float,
                 state: dict) -> Optional[float]:
        v = _series_value(snap, self.metric, self.labels)
        if v is None:
            # never-seen series: stale since the engine first looked
            state.setdefault("t_change", now)
            age = now - state["t_change"]
            return age if age >= self.stale_after_s else None
        if state.get("last") != v:
            state["last"] = v
            state["t_change"] = now
            return None
        age = now - state["t_change"]
        return age if age >= self.stale_after_s else None


@dataclasses.dataclass(frozen=True)
class Selector:
    """Addresses one series (and optionally one histogram bucket) for
    burn-rate accounting."""

    metric: str
    labels: Optional[Mapping[str, str]] = None
    le: Optional[float] = None

    def value(self, snap: Mapping[str, dict]) -> Optional[float]:
        return _series_value(snap, self.metric, self.labels, self.le)


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """Multi-window SLO burn rate over ``good``/``total`` cumulative
    series.  Burn = (bad fraction over the window) / (1 - objective):
    1.0 spends the error budget exactly at the objective's rate; a
    page-worthy incident burns at ``factor`` ≥ several.  Fires only
    while BOTH the long and the short window burn ≥ ``factor`` (the
    workbook's flap/noise compromise).  Window deltas come from a
    per-rule sample history on the engine clock — monotone cumulative
    inputs (counters, histogram counts) are what make the deltas mean
    "events in the window"."""

    name: str
    good: Selector
    total: Selector
    objective: float
    long_window_s: float
    short_window_s: float
    factor: float
    for_duration_s: float = 0.0

    def __post_init__(self):
        if not 0 < self.objective < 1:
            raise ValueError(f"{self.name}: objective must be in (0, 1), "
                             f"got {self.objective}")
        if self.short_window_s > self.long_window_s:
            raise ValueError(
                f"{self.name}: short window {self.short_window_s} "
                f"exceeds long window {self.long_window_s}")

    def _window_burn(self, hist: deque, now: float,
                     window_s: float) -> Optional[float]:
        """Burn rate over the trailing window, from the oldest sample
        still inside it to the newest; None until the window has two
        samples or while the window saw no traffic."""
        newest = hist[-1]
        oldest = None
        for t, good, total in hist:
            if t >= now - window_s:
                oldest = (t, good, total)
                break
        if oldest is None or oldest[0] >= newest[0]:
            return None
        d_total = newest[2] - oldest[2]
        d_good = newest[1] - oldest[1]
        if d_total <= 0:
            return None
        bad_fraction = max(0.0, (d_total - d_good) / d_total)
        return bad_fraction / (1.0 - self.objective)

    def evaluate(self, snap: Mapping[str, dict], now: float,
                 state: dict) -> Optional[float]:
        good = self.good.value(snap)
        total = self.total.value(snap)
        hist: deque = state.setdefault("hist", deque())
        if good is None or total is None:
            return None
        hist.append((now, good, total))
        # keep one sample older than the long window so the oldest
        # in-window delta spans the full window, bound memory hard
        while len(hist) > 2 and hist[1][0] < now - self.long_window_s:
            hist.popleft()
        long_burn = self._window_burn(hist, now, self.long_window_s)
        short_burn = self._window_burn(hist, now, self.short_window_s)
        if long_burn is None or short_burn is None:
            return None
        if long_burn >= self.factor and short_burn >= self.factor:
            return long_burn
        return None


class AlertEngine:
    """Evaluate a fixed rule list against registry snapshots on an
    injected clock; emit ``serving_alert_{firing,resolved}`` events and
    keep a deterministic ledger.

    >>> engine = AlertEngine([
    ...     ThresholdRule("replica_down",
    ...                   "apex_serving_fleet_replicas_healthy",
    ...                   "<", 3)], clock=clk)
    >>> router = FleetRouter(replicas, alerts=engine)   # evaluates per step
    >>> engine.ledger     # [{"step", "t", "rule", "transition", "value"}]

    Rule names must be unique — the name is the ``rule`` label on
    ``apex_serving_alerts_firing``, and two rules sharing it would
    fight over one series.
    """

    def __init__(self, rules: Sequence,
                 clock: Callable[[], float] = time.monotonic,
                 registry: metrics.MetricsRegistry = metrics.REGISTRY):
        names = [r.name for r in rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate alert rule names {sorted(dupes)} "
                             f"— the name is the metric's rule label")
        self.rules = tuple(rules)
        self._clock = clock
        self._registry = registry
        self._step = 0
        # per-rule: lifecycle phase + rule-private state (freshness
        # tracking, burn-rate sample history)
        self._phase: Dict[str, str] = {r.name: "ok" for r in self.rules}
        self._t_pending: Dict[str, float] = {}
        self._state: Dict[str, dict] = {r.name: {} for r in self.rules}
        # evaluation reads only the metrics the rules reference — the
        # per-step snapshot cost scales with the rule set, not with
        # everything the process happens to have registered
        needed = set()
        for r in self.rules:
            if getattr(r, "metric", None) is not None:
                needed.add(r.metric)
            for sel in (getattr(r, "good", None),
                        getattr(r, "total", None)):
                if sel is not None:
                    needed.add(sel.metric)
        self._needed = frozenset(needed)
        self.ledger: List[dict] = []

    def firing(self) -> List[str]:
        """Names of the rules currently in the FIRING phase."""
        return [n for n, p in self._phase.items() if p == "firing"]

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass (call at the fleet step boundary);
        returns the transitions this pass appended to the ledger."""
        if now is None:
            now = self._clock()
        self._step += 1
        snap = self._registry.snapshot(names=self._needed)
        out: List[dict] = []
        for rule in self.rules:
            value = rule.evaluate(snap, now, self._state[rule.name])
            phase = self._phase[rule.name]
            if value is not None:
                hold = getattr(rule, "for_duration_s", 0.0)
                if phase == "ok":
                    self._t_pending[rule.name] = now
                    phase = "pending"
                if phase == "pending" and (
                        now - self._t_pending[rule.name] >= hold):
                    phase = "firing"
                    entry = {"step": self._step, "t": round(now, 9),
                             "rule": rule.name, "transition": "firing",
                             "value": round(float(value), 9)}
                    self.ledger.append(entry)
                    out.append(entry)
                    emit_event("serving_alert_firing", rule=rule.name,
                               step=self._step, value=entry["value"])
            else:
                if phase == "firing":
                    entry = {"step": self._step, "t": round(now, 9),
                             "rule": rule.name,
                             "transition": "resolved", "value": None}
                    self.ledger.append(entry)
                    out.append(entry)
                    emit_event("serving_alert_resolved", rule=rule.name,
                               step=self._step)
                phase = "ok"
                self._t_pending.pop(rule.name, None)
            self._phase[rule.name] = phase
        return out
