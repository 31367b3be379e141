"""Rolling fleet upgrades: health-gated rolling reload, a canary
replica, and automatic fleet rollback.

The port of ``apex_tpu.serving.rollout``, copied whole: verdicts,
phases and events are the JAX controller's for the same schedule on the
same clock.

:mod:`~apex_tpu_torch.serving.reload` gives one engine a hot reload with
a validation gate and a one-step rollback;
:mod:`~apex_tpu_torch.serving.fleet` gives the router whose ``drain()`` /
``rejoin()`` pair and restore-ahead ``prefetch()`` are "the
rolling-reload hook".  This module is the orchestrator:
a :class:`RollingReloadController` that upgrades every replica of a
live fleet to a new committed checkpoint with **zero dropped
streams**, per replica::

    prefetch()  ->  drain()  ->  reload()  ->  rejoin()
    (off-path)     (lossless     (swap-only    (health-gated)
                    evacuation)   pause)

one replica (configurable K) at a time, with a **health window**
between waves: the rejoined replica must re-beat HEALTHY and complete
a configurable number of clean router steps before the next drain.

The first upgraded replica is the **canary**: the router pins a
seeded deterministic fraction of new traffic to it
(:meth:`~apex_tpu_torch.serving.fleet.FleetRouter.pin_traffic`, reusing the
shadow/A-B :func:`~apex_tpu_torch.serving.reload.assign_arm` rid hash), and
a :class:`CanaryGate` compares the canary arm's SLO report against
the old-version arms over the same window.  Pass promotes the rollout
to the remaining replicas; fail — or a refused/corrupt candidate, or
any replica dying mid-rollout — triggers automatic **halt + fleet
rollback**: every already-upgraded replica rolls back byte-exact from
its retained previous buffer (the reloader's double buffer), newest
first.  The terminal state (``promoted`` / ``aborted`` + reason) is a
first-class outcome, not an exception.

Why rollback is byte-exact: :meth:`HotReloader.rollback` swaps back
the *displaced buffer itself* — the very arrays that were serving
before the upgrade, retained, never copied through a checkpoint
round-trip — through the same ``swap_weights`` mechanism, so a halted
rollout leaves every replica serving bit-identical weights to the
pre-rollout fleet (pinned by the chaos tests).

Mixed-version caveat: mid-rollout the fleet serves two versions.  A
drain moves streams to survivors, and a captured (KV-intact) stream
restores bit-exactly only into a *same-version* engine — the router
degrades a cross-version capture to a bare requeue (deterministic
replay re-earns the tokens end-to-end on ONE version), so no stream
is ever a hybrid of two models.  ``weights_step`` rides every
routed/finished event to make the mixed window observable.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.obs.alerts import Condition
from apex_tpu_torch.serving.fleet import ReplicaState

logger = get_logger("serving.rollout")

__all__ = [
    "CanaryGate",
    "CanaryVerdict",
    "RolloutConfig",
    "RollingReloadController",
]


# ---------------------------------------------------------------------------
# the gate


@dataclasses.dataclass(frozen=True)
class CanaryGate:
    """SLO comparison thresholds for the canary verdict.

    The gate compares the canary arm's
    :class:`~apex_tpu_torch.obs.slo.SLOReport` against the old-version
    baseline arm over the same pinned window.  It **fails closed**: a
    canary that completed fewer than ``min_samples`` requests in the
    window fails the gate (a canary serving nothing is itself a
    regression signal), and every threshold breach is recorded as a
    reason so the halt event says *why*.

    A latency series only participates when both arms produced finite
    samples — on a single-process virtual clock the baseline arm is
    always populated under load, but the guard keeps the gate honest
    on thin windows.
    """

    tpot_ratio: float = 1.5       # canary tpot p95 may be <= ratio x baseline
    ttft_ratio: float = 1.5       # canary ttft p95 may be <= ratio x baseline
    completion_margin: float = 0.1  # completion rate may trail by <= this
    goodput_margin: float = 0.05    # goodput may trail by <= this (when known)
    min_samples: int = 1

    def __post_init__(self):
        if self.tpot_ratio <= 0 or self.ttft_ratio <= 0:
            raise ValueError("gate ratios must be > 0")
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}")

    @staticmethod
    def _p95(series: dict) -> Optional[float]:
        v = series.get("p95") if isinstance(series, dict) else None
        if v is None or not math.isfinite(v):
            return None
        return float(v)

    def verdict(self, canary, baseline) -> Tuple[bool, List[str]]:
        """Compare two :class:`~apex_tpu_torch.obs.slo.SLOReport` arms;
        returns ``(passed, reasons)`` with one reason per breached
        threshold (empty on pass).

        Every regression check evaluates through
        :class:`~apex_tpu_torch.obs.alerts.Condition` — the same comparison
        atom the fleet's :class:`~apex_tpu_torch.obs.alerts.AlertEngine`
        rules run on, so gating and alerting share one evaluation core
        (the arithmetic is unchanged: each check builds the identical
        float bound the inline comparisons used)."""
        reasons: List[str] = []
        if canary.completed < self.min_samples:
            reasons.append(
                f"canary completed {canary.completed} < min_samples "
                f"{self.min_samples} (fail-closed)")
            return False, reasons
        if baseline.completed >= self.min_samples:
            for series, limit in (("tpot", self.tpot_ratio),
                                  ("ttft", self.ttft_ratio)):
                c = self._p95(getattr(canary, series))
                b = self._p95(getattr(baseline, series))
                if c is not None and b is not None and b > 0 \
                        and Condition(">", b * limit).holds(c):
                    reasons.append(
                        f"{series} p95 {c:.4f}s > {limit:g}x baseline "
                        f"{b:.4f}s")
            c_rate = canary.completed / max(canary.offered, 1)
            b_rate = baseline.completed / max(baseline.offered, 1)
            if Condition("<", b_rate - self.completion_margin).holds(
                    c_rate):
                reasons.append(
                    f"completion rate {c_rate:.3f} trails baseline "
                    f"{b_rate:.3f} by more than {self.completion_margin}")
            if canary.goodput is not None and baseline.goodput is not None \
                    and Condition(
                        "<", baseline.goodput - self.goodput_margin
                    ).holds(canary.goodput):
                reasons.append(
                    f"goodput {canary.goodput:.3f} trails baseline "
                    f"{baseline.goodput:.3f} by more than "
                    f"{self.goodput_margin}")
        return (not reasons), reasons


@dataclasses.dataclass(frozen=True)
class CanaryVerdict:
    """One canary window's outcome: the pass/fail decision, the
    per-threshold reasons, and a compact numeric summary of each arm
    (full reports are the recorder's business — the verdict carries
    what the halt event and the bench need)."""

    passed: bool
    reasons: Tuple[str, ...]
    canary: dict                  # compact arm summary
    baseline: dict
    window_steps: int
    duration_s: float


def _arm_summary(report) -> dict:
    return {
        "offered": report.offered,
        "completed": report.completed,
        "tpot_p95": (report.tpot or {}).get("p95"),
        "ttft_p95": (report.ttft or {}).get("p95"),
        "goodput": report.goodput,
    }


# ---------------------------------------------------------------------------
# the controller


@dataclasses.dataclass
class RolloutConfig:
    """One rollout's shape.

    ``gate=None`` disables the canary phase entirely (no pin, no
    verdict — a straight health-gated rolling reload).  That is the
    *dangerous* mode: a regressing candidate promotes to the whole
    fleet; the chaos bench exists to show its goodput cost.
    """

    step: Optional[int] = None           # target; None = newest committed
    batch_size: int = 1                  # replicas upgraded per wave (K)
    health_window_steps: int = 2         # clean HEALTHY steps between waves
    canary_fraction: float = 0.25        # traffic share pinned to the canary
    canary_seed: int = 0
    canary_window_steps: int = 16        # verdict window length
    gate: Optional[CanaryGate] = dataclasses.field(
        default_factory=CanaryGate)

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")
        if self.health_window_steps < 0:
            raise ValueError(f"health_window_steps must be >= 0, got "
                             f"{self.health_window_steps}")
        if not 0.0 < self.canary_fraction <= 1.0:
            raise ValueError(f"canary_fraction must be in (0, 1], got "
                             f"{self.canary_fraction}")
        if self.canary_window_steps < 1:
            raise ValueError(f"canary_window_steps must be >= 1, got "
                             f"{self.canary_window_steps}")


class RollingReloadController:
    """Drive a fleet-wide weight upgrade over the existing primitives.

    Install as the :class:`~apex_tpu_torch.serving.loadgen.LoadGenerator`
    ``step_hook`` (it is callable with the ``(step, router)`` hook
    signature) — or call :meth:`advance` once per router step boundary
    yourself — after :meth:`start`.  Each call advances a small state
    machine at most one phase:

    - ``prefetch``: stage the wave's candidate off the serving path
      (restore + validate now; the later reload pause is swap-only).
    - ``upgrade``: per wave replica — ``drain()`` (lossless evacuation
      to survivors) → ``reload()`` consuming the stage → ``rejoin()``.
      A refused candidate (corrupt bytes, spec mismatch) aborts.
    - ``health``: wait for every wave replica to be HEALTHY for
      ``health_window_steps`` *consecutive* clean steps (a SUSPECT
      beat resets the count; a death aborts).
    - ``canary`` (first wave only, when gated): pin
      ``canary_fraction`` of new traffic to the upgraded replica for
      ``canary_window_steps``, then split the window's request records
      into arms by the router's pin log and ask the
      :class:`CanaryGate` for a verdict.  Pass promotes; fail halts.

    Abort (gate fail, refused candidate, replica death) rolls every
    already-upgraded replica back from its retained previous buffer —
    newest first, drain-evacuated where a healthy survivor exists,
    in-place otherwise (the swap itself is lossless) — and lands in
    terminal state ``aborted`` with :attr:`abort_reason`; a clean run
    lands in ``promoted``.  Both are first-class: the controller never
    raises for a bad candidate, because the fleet must keep serving.

    ``recorder`` (an :func:`apex_tpu_torch.obs.recording_requests` recorder
    sharing the run's clock) is required when gated — the verdict is
    computed from its records.  ``deadlines``/``arrivals`` (rid-keyed,
    as for :func:`~apex_tpu_torch.obs.slo.build_report`) flow into the
    per-arm goodput when provided.
    """

    def __init__(self, router, reloaders: Mapping[str, Any], *,
                 config: Optional[RolloutConfig] = None,
                 recorder: Any = None,
                 deadlines: Optional[Mapping[str, Optional[float]]] = None,
                 arrivals: Optional[Mapping[str, float]] = None):
        self.router = router
        self.reloaders: Dict[str, Any] = dict(reloaders)
        self.config = config if config is not None else RolloutConfig()
        self.recorder = recorder
        self.deadlines = deadlines
        self.arrivals = arrivals
        names = list(router.replica_names)
        if set(self.reloaders) != set(names):
            raise ValueError(
                f"reloaders must cover the fleet exactly: fleet "
                f"{sorted(names)}, reloaders {sorted(self.reloaders)}")
        for name in names:
            if self.reloaders[name].scheduler is not router.replica(name):
                raise ValueError(
                    f"reloader[{name!r}] wraps a different scheduler "
                    f"than the router's replica {name!r}")
        if self.config.gate is not None and recorder is None:
            raise ValueError(
                "a gated rollout needs the run's request recorder "
                "(apex_tpu_torch.obs.recording_requests) to build the "
                "per-arm canary reports — pass recorder=, or gate=None "
                "for an ungated rolling reload")
        self.state = "idle"            # idle|running|promoted|aborted
        self.abort_reason: Optional[str] = None
        self.verdict: Optional[CanaryVerdict] = None
        self.canary: Optional[str] = None
        self.swap_pauses: Dict[str, float] = {}
        self._order: List[str] = []
        self._pending: deque = deque()
        self._wave: List[str] = []
        self._upgraded: List[str] = []
        self._target: Optional[int] = None
        self._from_steps: Dict[str, Optional[int]] = {}
        self._phase: Optional[str] = None
        self._health_left = 0
        self._canary_left = 0
        self._canary_done = False
        self._pinned = False
        self._t0 = 0.0
        self._window_t0 = 0.0

    # ---- introspection ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self.state in ("promoted", "aborted")

    @property
    def upgraded(self) -> List[str]:
        return list(self._upgraded)

    @property
    def target_step(self) -> Optional[int]:
        return self._target

    @property
    def phase(self) -> Optional[str]:
        return self._phase

    @property
    def status(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "phase": self._phase,
            "target_step": self._target,
            "canary": self.canary,
            "upgraded": list(self._upgraded),
            "pending": list(self._pending),
            "abort_reason": self.abort_reason,
            "verdict": (None if self.verdict is None else {
                "passed": self.verdict.passed,
                "reasons": list(self.verdict.reasons)}),
            "swap_pauses": dict(self.swap_pauses),
        }

    # ---- lifecycle -------------------------------------------------------
    def start(self, *, step: Optional[int] = None) -> int:
        """Arm the rollout toward ``step`` (or ``config.step``, or the
        newest committed step any reloader's watcher can see).
        Returns the resolved target step.  The first :meth:`advance`
        call begins prefetching."""
        if self.state != "idle":
            raise RuntimeError(
                f"start() on a rollout in state {self.state!r} — one "
                f"controller drives one rollout")
        target = step if step is not None else self.config.step
        if target is None:
            for rl in self.reloaders.values():
                target = rl.watcher.committed_step()
                if target is not None:
                    break
        if target is None:
            raise ValueError("no target step: none given and no "
                             "committed checkpoint visible")
        names = list(self.router.replica_names)
        if len(names) < 2:
            raise ValueError(
                "a rolling reload needs >= 2 replicas (drain() must "
                "have a healthy survivor to evacuate to)")
        self._target = int(target)
        self._order = names
        self._pending = deque(names)
        self.canary = names[0] if self.config.gate is not None else None
        self._from_steps = {n: self.reloaders[n].current_step
                            for n in names}
        self._t0 = self.router.clock()
        self.state = "running"
        self._phase = "prefetch"
        emit_event("serving_rollout_started", step=self._target,
                   replicas=len(names), canary=self.canary,
                   fraction=(self.config.canary_fraction
                             if self.config.gate is not None else None),
                   gated=self.config.gate is not None,
                   batch_size=self.config.batch_size,
                   from_steps=dict(self._from_steps))
        logger.info("rollout -> step %s over %d replicas (canary=%s)",
                    self._target, len(names), self.canary)
        return self._target

    def __call__(self, step: int = 0, router: Any = None) -> None:
        """``LoadGenerator`` ``step_hook`` adapter."""
        self.advance()

    def advance(self) -> None:
        """Advance the state machine at most one phase.  Call once per
        router step boundary; no-op when idle or terminal."""
        if self.state != "running":
            return
        for name in self._order:
            if self.router.state_of(name) is ReplicaState.DEAD:
                self._abort(f"replica_died:{name}")
                return
        if self._phase == "prefetch":
            self._do_prefetch()
        elif self._phase == "upgrade":
            self._do_upgrade()
        elif self._phase == "health":
            self._do_health()
        elif self._phase == "canary":
            self._do_canary()

    # ---- phases ----------------------------------------------------------
    def _next_wave(self) -> List[str]:
        if not self._upgraded and self.config.gate is not None:
            return [self._pending.popleft()]      # the canary goes alone
        k = min(self.config.batch_size, len(self._pending))
        return [self._pending.popleft() for _ in range(k)]

    def _do_prefetch(self) -> None:
        self._wave = self._next_wave()
        for name in self._wave:
            staged = self.reloaders[name].prefetch(step=self._target)
            if staged is None:
                # nothing staged (restore failure / spec mismatch):
                # proceed — reload() re-walks the full path and refuses
                # first-class, which aborts with the real reason
                logger.warning("rollout prefetch staged nothing for %s "
                               "(step %s)", name, self._target)
        self._phase = "upgrade"

    def _do_upgrade(self) -> None:
        for i, name in enumerate(self._wave):
            rl = self.reloaders[name]
            prefetched = rl.staged_step == self._target
            try:
                self.router.drain(name)
            except ValueError as e:
                self._wave = self._wave[i:]  # un-upgraded tail, for abort
                self._abort(f"drain_refused:{name}: {e}")
                return
            out = rl.reload(step=self._target)
            if not out.ok:
                # the replica still serves its old weights, untouched
                # (the double-buffer guarantee) — return it to service
                # before rolling the fleet back
                self.router.rejoin(name)
                self._abort(f"reload_refused:{name}: {out.reason}")
                return
            self.router.rejoin(name)
            self._upgraded.append(name)
            self.swap_pauses[name] = out.swap_s
            emit_event("serving_rollout_replica_upgraded", replica=name,
                       step=self._target, from_step=out.from_step,
                       swap_s=round(out.swap_s, 6),
                       prefetched=prefetched,
                       canary=name == self.canary)
        self._health_left = self.config.health_window_steps
        self._phase = "health"

    def _do_health(self) -> None:
        if all(self.router.state_of(n) is ReplicaState.HEALTHY
               for n in self._wave):
            self._health_left -= 1
        else:
            # a SUSPECT beat resets the window: the gate wants
            # *consecutive* clean steps, not clean steps eventually
            self._health_left = self.config.health_window_steps
            return
        if self._health_left > 0:
            return
        if (self.config.gate is not None and not self._canary_done
                and self._wave and self._wave[0] == self.canary):
            self.router.pin_traffic(
                self.canary, fraction=self.config.canary_fraction,
                seed=self.config.canary_seed)
            self._pinned = True
            self._canary_left = self.config.canary_window_steps
            self._window_t0 = self.router.clock()
            self._phase = "canary"
            return
        self._next_wave_or_promote()

    def _do_canary(self) -> None:
        self._canary_left -= 1
        if self._canary_left > 0:
            return
        from apex_tpu_torch.obs.slo import build_report

        log = self.router.unpin_traffic()
        self._pinned = False
        duration_s = self.router.clock() - self._window_t0
        records = [r for r in self.recorder.records() if r.rid in log]
        arm = {True: [], False: []}
        for r in records:
            arm[log[r.rid] == self.canary].append(r)
        offered_c = sum(1 for v in log.values() if v == self.canary)

        def _report(recs, offered):
            dl = (None if self.deadlines is None
                  else {r.rid: self.deadlines.get(r.rid) for r in recs})
            ar = (None if self.arrivals is None
                  else {r.rid: self.arrivals[r.rid] for r in recs
                        if r.rid in self.arrivals})
            return build_report(recs, offered=offered, deadlines=dl,
                                arrivals=ar)

        c_report = _report(arm[True], max(offered_c, len(
            [r for r in arm[True] if r.complete])))
        b_report = _report(arm[False], max(len(log) - offered_c, len(
            [r for r in arm[False] if r.complete])))
        passed, reasons = self.config.gate.verdict(c_report, b_report)
        self.verdict = CanaryVerdict(
            passed=passed, reasons=tuple(reasons),
            canary=_arm_summary(c_report),
            baseline=_arm_summary(b_report),
            window_steps=self.config.canary_window_steps,
            duration_s=duration_s)
        emit_event("serving_rollout_canary_verdict",
                   verdict="pass" if passed else "fail",
                   canary=self.canary,
                   window_steps=self.config.canary_window_steps,
                   duration_s=round(duration_s, 6),
                   reasons="; ".join(reasons)[:500],
                   canary_completed=c_report.completed,
                   baseline_completed=b_report.completed)
        self._canary_done = True
        if passed:
            self._next_wave_or_promote()
        else:
            self._abort("canary_failed: " + "; ".join(reasons))

    def _next_wave_or_promote(self) -> None:
        if self._pending:
            self._phase = "prefetch"
        else:
            self._promote()

    # ---- terminals -------------------------------------------------------
    def _promote(self) -> None:
        self.state = "promoted"
        self._phase = "done"
        duration_s = self.router.clock() - self._t0
        emit_event("serving_rollout_promoted", step=self._target,
                   replicas=len(self._order),
                   duration_s=round(duration_s, 6))
        logger.info("rollout promoted: step %s on %d replicas in %.3fs",
                    self._target, len(self._order), duration_s)

    def _abort(self, reason: str) -> None:
        reason = reason[:500]
        logger.warning("rollout halted: %s (rolling back %d upgraded "
                       "replicas)", reason, len(self._upgraded))
        emit_event("serving_rollout_halted", reason=reason,
                   step=self._target, upgraded=len(self._upgraded),
                   duration_s=round(self.router.clock() - self._t0, 6))
        if self._pinned:
            self.router.unpin_traffic()
            self._pinned = False
        rolled: List[str] = []
        for name in reversed(self._upgraded):
            if self.router.state_of(name) is ReplicaState.DEAD:
                continue                 # scheduler closed at failover
            rl = self.reloaders[name]
            if not rl.can_rollback:
                continue
            drained = False
            try:
                self.router.drain(name)
                drained = True
            except ValueError:
                # no healthy survivor to evacuate to: roll back in
                # place — the swap itself is lossless (streams keep
                # their slots and continue under the restored weights)
                pass
            rl.rollback()
            if drained:
                self.router.rejoin(name)
            rolled.append(name)
        emit_event("serving_rollout_rolled_back", replicas=len(rolled),
                   names=",".join(rolled), step=self._target)
        self.state = "aborted"
        self.abort_reason = reason
        self._phase = "done"
