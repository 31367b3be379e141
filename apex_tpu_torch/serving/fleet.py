"""Fault-tolerant fleet serving: a replica router with health checks,
prefix-affinity placement, and lossless stream failover.

The port of ``apex_tpu.serving.fleet``, copied whole: its placements,
health transitions, failovers and events are the JAX router's for the
same schedule on the same clock.  Replicas may be engines over one
shared module (each serves its own weights; see
:meth:`~apex_tpu_torch.serving.engine.DecodeEngine.swap_params`).

Everything below the router is one engine behind one queue — a single
wedged or killed engine loses every in-flight stream.
:class:`FleetRouter` fronts N independent
:class:`~apex_tpu_torch.serving.scheduler.ContinuousBatchingScheduler` +
:class:`~apex_tpu_torch.serving.engine.DecodeEngine` replicas behind the
exact scheduler surface a
:class:`~apex_tpu_torch.serving.loadgen.LoadGenerator` drives (``submit`` /
``step`` / ``results`` / ``clock`` / the pending-work counters), so
fleet and single-engine runs share one harness.

**Placement** (per :meth:`FleetRouter.submit`):

1. *Prefix affinity* — the prompt is chain-hashed with the prefix
   cache's own block hash and probed **read-only**
   (:meth:`~apex_tpu_torch.serving.prefix_cache.PrefixCache.probe` — no LRU
   touch, no hit/miss pollution) against every healthy replica's
   cache; the replica covering the most prompt tokens wins, so
   shared-prefix tenants keep landing where their blocks live.
2. *Smooth WRR by load* — with no cache coverage anywhere, the
   nginx-style smooth weighted round-robin from
   :mod:`apex_tpu_torch.serving.policy` draws the replica (replica names
   play the tenant role; per-replica weights ride
   :attr:`FleetConfig.weights`).
3. *Bounded deterministic backoff* — a replica's ``QueueFull`` moves
   the submission to the next-best candidate (affinity order first,
   then repeated WRR draws over the untried); when every healthy
   replica refuses, the router sheds (``serving_fleet_shed`` +
   re-raised ``QueueFull`` — the open-loop loadgen records it).

**Health** is a per-replica heartbeat on the *shared* scheduler clock
(the :mod:`~apex_tpu_torch.resilience.supervisor` deadline pattern, fleet
-sized): every completed ``replica.step()`` beats; a beat older than
``suspect_after_s`` drives HEALTHY → SUSPECT (no new placements, still
stepped), older than ``dead_after_s`` drives SUSPECT → DEAD
(failover).  A suspect replica that completes a step again recovers to
HEALTHY with its WRR credits reset — exactly like a rejoin, so a
recovered straggler cannot burst-claim the traffic it "missed".

**Failover** drains a dead replica through
:meth:`~apex_tpu_torch.serving.scheduler.ContinuousBatchingScheduler.
export_streams`:

- a *wedged-but-intact* replica (watchdog death, :meth:`drain`)
  exports with ``capture=True`` — dense DECODE streams carry their
  cache bytes and resume on a survivor **mid-stream** (the
  ``capture_slot`` → ``restore_prefix`` contract, cross-engine);
- a *hard-killed* replica (:meth:`kill` — device memory gone) exports
  bare records: victims re-queue on survivors with their original
  submit stamps and **replay deterministically** (sampler keys fold
  from the request seed by token index), so the final token stream is
  still bit-identical to an uninterrupted run;
- paged replicas always fail over by requeue (paged capture is by
  block reference into a per-engine pool — the bytes cannot cross
  engines).

Re-placement runs highest priority first (the scheduler's priority
classes at fleet granularity); when no surviving capacity exists the
lowest-priority victims shed first.  The killed replica's scheduler is
routed through ``close()`` so its prefix-cache pins and paged block
holds are released, never leaked.  :meth:`drain` is the rolling-reload
hook: drain → reload the idle replica → ``rejoin``.

**Chaos + grading**: :class:`~apex_tpu_torch.resilience.fault_injection`
grows ``KillReplica`` / ``WedgeReplica`` / ``SlowReplica``, all wired
through ``LoadGenerator(step_hook=)`` on one virtual clock; the
``serving_fleet_*`` events feed ``apex_serving_fleet_*`` metrics
(replicas-healthy gauge, routed/failover/resume/shed counters, a
failover-latency histogram) via :mod:`apex_tpu_torch.obs.bridge`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Mapping, Optional

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.obs import bridge as obs_bridge
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.serving.policy import SchedulingPolicy, WeightedRoundRobin
from apex_tpu_torch.serving.reload import assign_arm
from apex_tpu_torch.serving.scheduler import (
    QueueFull,
    Request,
    RequestResult,
    StreamExport,
)

__all__ = ["FleetConfig", "FleetRouter", "ReplicaState"]

logger = get_logger("serving.fleet")


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"      # missed beats: no new placements, watched
    DEAD = "dead"            # failed over; engine presumed unusable
    DRAINING = "draining"    # rolling-reload drain: no new placements


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router knobs.  The heartbeat thresholds are in scheduler-clock
    seconds — on a :class:`~apex_tpu_torch.serving.loadgen.VirtualClock`
    with ``step_time_s`` they are exact multiples of the step time, so
    every health transition in a test is deterministic.

    ``failover=False`` is the honesty baseline the bench grades
    against: a dead replica's streams are *shed* instead of moved
    (what a router without the export/adopt machinery would do)."""

    suspect_after_s: float = 1.0
    dead_after_s: float = 3.0
    affinity: bool = True              # prefix-affinity first placement
    failover: bool = True              # False: dead replica's work sheds
    weights: Optional[Mapping[str, float]] = None   # replica WRR weights

    def __post_init__(self):
        if self.suspect_after_s <= 0:
            raise ValueError(f"suspect_after_s must be > 0, got "
                             f"{self.suspect_after_s}")
        if self.dead_after_s <= self.suspect_after_s:
            raise ValueError(
                f"dead_after_s ({self.dead_after_s}) must exceed "
                f"suspect_after_s ({self.suspect_after_s}) — a replica "
                f"must pass through SUSPECT before it can die")


@dataclasses.dataclass
class _Replica:
    name: str
    scheduler: object                     # ContinuousBatchingScheduler
    state: ReplicaState = ReplicaState.HEALTHY
    last_beat: float = 0.0
    wedged: bool = False                  # hard hang: step never returns
    stalled: bool = False                 # one-step straggler mark


@dataclasses.dataclass
class _Pending:
    """A failover victim awaiting re-placement (captured records wait
    for a free slot; bare records wait for queue room)."""

    exp: StreamExport
    from_replica: str
    t_failed: float                       # when the donor was drained


class FleetRouter:
    """N scheduler replicas behind one serving surface.

    >>> router = FleetRouter({"r0": sched0, "r1": sched1, "r2": sched2})
    >>> gen = LoadGenerator(router, workload, step_time_s=0.25)
    >>> out = gen.run()

    All replicas must share one clock object (the virtual-clock
    determinism contract — same check as
    :class:`~apex_tpu_torch.serving.reload.ShadowABScheduler`), and replica
    iteration order is the insertion order of ``replicas`` — placement,
    stepping, and failover all walk it deterministically.
    """

    def __init__(self, replicas: Mapping[str, object], *,
                 config: FleetConfig = FleetConfig(),
                 alerts: Optional[object] = None):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        names = list(replicas)
        clock = replicas[names[0]].clock
        engines = set()
        sched_names = set()
        for name in names:
            sched = replicas[name]
            if sched.clock is not clock:
                raise ValueError(
                    f"replica {name!r} does not share the fleet clock "
                    f"object — construct every scheduler with the same "
                    f"(virtual) clock so heartbeats, deadlines and "
                    f"latencies live on one timeline")
            eid = id(sched.engine)
            if eid in engines:
                raise ValueError(
                    f"replica {name!r} shares an engine with another "
                    f"replica — a fleet is N independent engines (two "
                    f"schedulers over one engine fight for slots)")
            engines.add(eid)
            # named schedulers stamp their name onto every metric as
            # the 'replica' label; two replicas sharing one scheduler
            # name would silently merge into one metric identity
            sname = getattr(sched, "name", None)
            if sname is not None:
                if sname in sched_names:
                    raise ValueError(
                        f"replica {name!r}: scheduler name {sname!r} is "
                        f"already used by another replica — per-replica "
                        f"metric attribution needs unique names")
                sched_names.add(sname)
        # the fleet size IS the replica label's cardinality bound
        # (widen-only, so replacement replicas with fresh names fit)
        obs_metrics.REGISTRY.declare_scope("replica", len(names))
        self._alerts = alerts
        self.config = config
        self._clock: Callable[[], float] = clock
        now = clock()
        self._replicas: Dict[str, _Replica] = {
            name: _Replica(name=name, scheduler=replicas[name],
                           last_beat=now)
            for name in names}
        # smooth WRR over replica names (names play the tenant role);
        # credits persist while a replica is ineligible, and reset on
        # rejoin/recovery via _reset_credits
        weights = dict(config.weights or {})
        unknown = set(weights) - set(names)
        if unknown:
            raise ValueError(f"weights for unknown replicas: "
                             f"{sorted(unknown)}")
        self._wrr = WeightedRoundRobin(SchedulingPolicy(
            tenant_weights=weights))
        self._steps = 0
        self._pending: List[_Pending] = []
        self._placed: Dict[str, str] = {}       # rid -> replica name
        self._routed_total = 0
        self._failovers_total = 0
        self._resumed_total = 0
        self._shed_total = 0
        # canary traffic pin (rolling rollout): (name, fraction, seed)
        # while active, plus the window's rid -> replica log
        self._pin: Optional[tuple] = None
        self._pin_log: Dict[str, str] = {}

    # ---- introspection (the LoadGenerator surface + fleet extras) --------
    @property
    def clock(self) -> Callable[[], float]:
        return self._clock

    @property
    def engine(self):
        """The first replica's engine (single-engine-compat
        convenience; per-replica engines ride ``replica(name).engine``)."""
        return next(iter(self._replicas.values())).scheduler.engine

    def replica(self, name: str):
        """The named replica's scheduler (introspection for tests)."""
        return self._replicas[name].scheduler

    @property
    def replica_names(self) -> List[str]:
        return list(self._replicas)

    def state_of(self, name: str) -> ReplicaState:
        return self._replicas[name].state

    @property
    def replicas_healthy(self) -> int:
        return sum(1 for r in self._replicas.values()
                   if r.state is ReplicaState.HEALTHY)

    def placement_of(self, rid: str) -> Optional[str]:
        """The replica currently serving ``rid`` (None once its result
        was claimed, or for a rid the router never placed)."""
        return self._placed.get(rid)

    @property
    def queue_depth(self) -> int:
        return (sum(r.scheduler.queue_depth
                    for r in self._live_replicas())
                + len(self._pending))

    @property
    def active_count(self) -> int:
        return sum(r.scheduler.active_count
                   for r in self._live_replicas())

    @property
    def suspended_count(self) -> int:
        return sum(r.scheduler.suspended_count
                   for r in self._live_replicas())

    @property
    def steps_run(self) -> int:
        return self._steps

    @property
    def weights_steps(self) -> Dict[str, Optional[int]]:
        """Per-replica checkpoint step being served (``None`` =
        unknown provenance) — the mixed-version-fleet dashboard a
        rolling upgrade is watched on."""
        return {name: getattr(r.scheduler, "weights_step", None)
                for name, r in self._replicas.items()}

    @property
    def fleet_stats(self) -> Dict[str, int]:
        """Cumulative router accounting: placements, failed-over
        streams, capture-resumes, fleet-level sheds."""
        return {"routed": self._routed_total,
                "failovers": self._failovers_total,
                "resumed": self._resumed_total,
                "shed": self._shed_total}

    @property
    def results(self) -> Dict[str, RequestResult]:
        out: Dict[str, RequestResult] = {}
        for r in self._replicas.values():
            out.update(r.scheduler.results)
        return out

    def pop_result(self, rid: str) -> RequestResult:
        for r in self._replicas.values():
            if rid in r.scheduler.results:
                self._placed.pop(rid, None)
                return r.scheduler.pop_result(rid)
        raise KeyError(rid)

    def pop_results(self) -> Dict[str, RequestResult]:
        out: Dict[str, RequestResult] = {}
        for r in self._replicas.values():
            out.update(r.scheduler.pop_results())
        for rid in out:
            self._placed.pop(rid, None)
        return out

    def replica_reports(self, records, *,
                        deadlines: Optional[Dict[str, Optional[float]]]
                        = None,
                        arrivals: Optional[Dict[str, float]] = None,
                        duration_s: Optional[float] = None
                        ) -> Dict[str, Any]:
        """Per-replica + fleet-aggregate
        :class:`~apex_tpu_torch.obs.slo.SLOReport` over request-trace
        ``records`` (the :func:`apex_tpu_torch.obs.recording_requests`
        output for a fleet run).  A stream counts toward the replica
        that FINISHED it — a failover victim reports on its survivor,
        which is where its latency was actually served.  The
        ``"fleet"`` entry aggregates every placed record; records the
        router never placed (shed before placement) are charged to the
        fleet aggregate only.  Call before claiming results
        (``pop_results`` forgets placements)."""
        from apex_tpu_torch.obs.slo import build_report

        records = list(records)
        by_replica: Dict[str, list] = {}
        for rec in records:
            name = self._placed.get(rec.rid)
            if name is not None:
                by_replica.setdefault(name, []).append(rec)

        def _report(recs, offered):
            dl = (None if deadlines is None
                  else {r.rid: deadlines.get(r.rid) for r in recs})
            ar = (None if arrivals is None
                  else {r.rid: arrivals[r.rid] for r in recs
                        if r.rid in arrivals})
            return build_report(recs, offered=offered, deadlines=dl,
                                arrivals=ar, duration_s=duration_s)

        reports: Dict[str, Any] = {
            name: _report(recs, len(recs))
            for name, recs in sorted(by_replica.items())}
        reports["fleet"] = _report(records, max(len(records), 1))
        return reports

    def _live_replicas(self) -> List[_Replica]:
        return [r for r in self._replicas.values()
                if r.state is not ReplicaState.DEAD]

    # ---- placement -------------------------------------------------------
    def _eligible(self) -> List[_Replica]:
        """Replicas new placements may target: HEALTHY only (SUSPECT is
        watched, DRAINING is emptying, DEAD is gone)."""
        return [r for r in self._replicas.values()
                if r.state is ReplicaState.HEALTHY]

    def _candidate_order(self, prompt) -> List[str]:
        """The deterministic retry order for one submission: replicas
        with prefix-cache coverage first (most covered tokens wins,
        insertion order breaks ties — probed READ-ONLY so placement
        never skews a replica's own cache stats), then the uncovered
        remainder by repeated smooth-WRR draws."""
        eligible = self._eligible()
        covered: List[tuple] = []
        rest: List[str] = []
        for idx, r in enumerate(eligible):
            cache = (r.scheduler.prefix_cache
                     if self.config.affinity else None)
            c = cache.probe(prompt) if cache is not None else 0
            if c > 0:
                covered.append((-c, idx, r.name))
            else:
                rest.append(r.name)
        order = [name for _, _, name in sorted(covered)]
        remaining = set(rest)
        while remaining:
            pick = self._wrr.pick(remaining)
            order.append(pick)
            remaining.discard(pick)
        return order

    def pin_traffic(self, name: str, *, fraction: float,
                    seed: int = 0) -> None:
        """Pin a seeded deterministic ``fraction`` of new placements to
        replica ``name`` (the canary), reusing the shadow/A-B
        :func:`~apex_tpu_torch.serving.reload.assign_arm` rid hash: a rid
        hashing under ``fraction`` places on the canary first, every
        other rid avoids it — the split is exact and reproducible, not
        statistical.  While pinned the router logs every placement
        (rid → replica) so a :class:`~apex_tpu_torch.serving.rollout.
        CanaryGate` can split the window's request records into arms
        after the fact; :meth:`unpin_traffic` returns the log.

        The pin biases, it never strands: a full canary falls back to
        the normal candidate order (losslessness outranks an exact
        fraction), and a canary that leaves HEALTHY is simply skipped.
        """
        if name not in self._replicas:
            raise KeyError(name)
        if not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"pin fraction must be in (0, 1], got {fraction}")
        self._pin = (name, float(fraction), int(seed))
        self._pin_log = {}

    def unpin_traffic(self) -> Dict[str, str]:
        """Clear the canary pin; returns the pinned window's placement
        log (rid → replica) and forgets it."""
        log, self._pin, self._pin_log = self._pin_log, None, {}
        return log

    def submit(self, request: Request) -> None:
        """Place one request: affinity-first, WRR fallback, next-best
        retry on ``QueueFull``, fleet shed when every healthy replica
        refuses (the re-raised ``QueueFull`` is the open-loop
        loadgen's shed signal)."""
        order = self._candidate_order(request.prompt)
        if self._pin is not None:
            pin_name, fraction, seed = self._pin
            if self._replicas[pin_name].state is ReplicaState.HEALTHY:
                if assign_arm(request.rid, fraction=fraction, seed=seed):
                    order = ([pin_name]
                             + [n for n in order if n != pin_name])
                else:
                    rest = [n for n in order if n != pin_name]
                    # never strand a request to honor the fraction: the
                    # canary stays last-resort for the control arm
                    order = rest + ([pin_name] if pin_name in order
                                    else [])
        if not order:
            self._shed_total += 1
            emit_event("serving_fleet_shed", rid=request.rid,
                       priority=request.priority, reason="no_replica")
            raise QueueFull("no healthy replica accepts placements")
        retries = 0
        for name in order:
            sched = self._replicas[name].scheduler
            try:
                sched.submit(request)
            except QueueFull:
                retries += 1
                continue
            self._placed[request.rid] = name
            if self._pin is not None:
                self._pin_log[request.rid] = name
            self._routed_total += 1
            emit_event("serving_fleet_routed", rid=request.rid,
                       replica=name, retries=retries,
                       weights_step=getattr(sched, "weights_step",
                                            None))
            return
        self._shed_total += 1
        emit_event("serving_fleet_shed", rid=request.rid,
                   priority=request.priority, reason="all_full")
        raise QueueFull(
            f"every healthy replica at capacity ({len(order)} tried)")

    # ---- health + failover -----------------------------------------------
    def _transition(self, r: _Replica, to: ReplicaState) -> None:
        if r.state is to:
            return
        emit_event("serving_fleet_replica_state", replica=r.name,
                   state=to.value, from_state=r.state.value)
        logger.info("replica %s: %s -> %s", r.name, r.state.value,
                    to.value)
        r.state = to

    def _reset_credits(self, name: str) -> None:
        """Zero one replica's WRR credit on rejoin/recovery: a replica
        away for N rounds must not burst-claim the traffic it missed."""
        state = dict(self._wrr.snapshot())
        state[name] = 0.0
        self._wrr.restore(state)

    def _check_health(self) -> None:
        now = self._clock()
        for r in self._replicas.values():
            if r.state in (ReplicaState.DEAD, ReplicaState.DRAINING):
                continue
            age = now - r.last_beat
            if age >= self.config.dead_after_s:
                self._transition(r, ReplicaState.DEAD)
                self._fail_over(r, capture=True)
            elif (age >= self.config.suspect_after_s
                  and r.state is ReplicaState.HEALTHY):
                self._transition(r, ReplicaState.SUSPECT)

    def _fail_over(self, r: _Replica, *, capture: bool) -> None:
        """Drain a dead replica: export its streams (captured when the
        host/device state is intact and the engine is dense; bare
        otherwise), close it so prefix pins and paged block holds are
        released, and park the victims for priority-ordered
        re-placement.  With ``config.failover=False`` the victims shed
        instead — the no-failover baseline the bench grades against."""
        capture = capture and r.scheduler.engine.paged is None
        now = self._clock()
        exports = r.scheduler.export_streams(capture=capture)
        # a drained scheduler closes cleanly: the prefix cache drops
        # its entries (paged: derefs the pool blocks) and the reclaim
        # hook unhooks — a killed replica must never leak pins
        r.scheduler.close()
        for exp in exports:
            self._placed.pop(exp.request.rid, None)
            if not self.config.failover:
                self._shed_total += 1
                emit_event("serving_fleet_shed", rid=exp.request.rid,
                           priority=exp.request.priority,
                           reason="no_failover")
                continue
            mode = "capture-resume" if exp.kv is not None else "requeue"
            self._failovers_total += 1
            emit_event("serving_fleet_failover", rid=exp.request.rid,
                       replica=r.name, mode=mode,
                       new_tokens=len(exp.tokens))
            self._pending.append(_Pending(exp=exp, from_replica=r.name,
                                          t_failed=now))
        # priority classes survive first; FIFO (export order) within
        # a class — stable sort keeps it
        self._pending.sort(key=lambda p: -p.exp.request.priority)

    def _place_pending(self) -> None:
        """Re-place failover victims, highest priority first.  A bare
        record that fits nowhere right now is SHED lowest-priority
        first (fleet capacity genuinely dropped — holding it would
        just let its deadline rot); a captured record waits for a free
        slot (its tokens are already earned — shedding it would throw
        away served work) and is counted in :attr:`queue_depth` so
        drains keep stepping."""
        if not self._pending:
            return
        still: List[_Pending] = []
        for p in self._pending:
            placed = False
            order = self._candidate_order(p.exp.request.prompt)

            def _capture_ok(name: str) -> bool:
                # captured bytes restore bit-exactly only into a dense
                # engine serving the SAME weights version: a cross-
                # version resume would splice two models into one
                # stream (hybrid tokens no single-version run could
                # ever produce)
                sched = self._replicas[name].scheduler
                return (sched.engine.paged is None
                        and getattr(sched, "weights_step", None)
                        == p.exp.weights_step)

            if p.exp.kv is not None and not any(
                    _capture_ok(n) for n in order):
                # no same-version dense survivor (mixed fleet, or a
                # rollout moved every peer to another weights step):
                # degrade to a bare requeue — deterministic replay
                # re-earns the tokens end-to-end on ONE version;
                # holding the capture would deadlock the drain
                p.exp.kv = None
                p.exp.tokens = []
                p.exp.t_first = 0.0
            for name in order:
                sched = self._replicas[name].scheduler
                if p.exp.kv is not None and not _capture_ok(name):
                    continue
                try:
                    ok = sched.adopt_stream(p.exp)
                except QueueFull:
                    continue
                if not ok:
                    continue             # captured record, no free slot
                self._placed[p.exp.request.rid] = name
                if p.exp.kv is not None:
                    self._resumed_total += 1
                emit_event(
                    "serving_fleet_resumed", rid=p.exp.request.rid,
                    replica=name, from_replica=p.from_replica,
                    mode=("capture-resume" if p.exp.kv is not None
                          else "requeue"),
                    duration_s=round(self._clock() - p.t_failed, 6))
                placed = True
                break
            if placed:
                continue
            if p.exp.kv is not None or not order:
                still.append(p)
            else:
                # bare record, every healthy queue full: fleet
                # capacity dropped below the offered load — shed
                # (lowest priority lands here first: placement walks
                # the priority-sorted list, so higher classes already
                # took the remaining room)
                self._shed_total += 1
                emit_event("serving_fleet_shed",
                           rid=p.exp.request.rid,
                           priority=p.exp.request.priority,
                           reason="capacity")
        self._pending = still

    # ---- fault/ops entry points ------------------------------------------
    def kill(self, name: str) -> None:
        """Hard-kill a replica NOW (device memory lost): its streams
        re-queue from their host-side request records and replay
        deterministically on survivors.  Idempotent on a dead
        replica."""
        r = self._replicas[name]
        if r.state is ReplicaState.DEAD:
            return
        self._transition(r, ReplicaState.DEAD)
        self._fail_over(r, capture=False)

    def wedge(self, name: str) -> None:
        """Mark a replica hard-hung: its step never completes, so it
        stops beating — the watchdog walks it HEALTHY → SUSPECT → DEAD
        and drains it via preempt-capture (host state intact)."""
        self._replicas[name].wedged = True

    def stall(self, name: str) -> None:
        """Mark a replica a straggler for the NEXT router step only
        (the step does not complete in time — one missed beat).  Long
        enough runs of stalls drive SUSPECT and then DEAD; short runs
        recover with WRR credits reset."""
        self._replicas[name].stalled = True

    def drain(self, name: str) -> List[str]:
        """Rolling-reload hook: stop placing onto ``name``, move its
        live streams to the surviving replicas (capture-resume where
        the engine allows), and return the moved rids.  The replica's
        scheduler stays open and empty — reload it idle, then
        :meth:`rejoin`."""
        r = self._replicas[name]
        if r.state is ReplicaState.DEAD:
            raise ValueError(f"drain({name!r}): replica is dead")
        if not any(x.state is ReplicaState.HEALTHY
                   for x in self._replicas.values() if x is not r):
            raise ValueError(
                f"drain({name!r}): no other healthy replica to move "
                f"its streams to")
        self._transition(r, ReplicaState.DRAINING)
        capture = r.scheduler.engine.paged is None
        now = self._clock()
        exports = r.scheduler.export_streams(capture=capture)
        moved = []
        for exp in exports:
            self._placed.pop(exp.request.rid, None)
            mode = "capture-resume" if exp.kv is not None else "requeue"
            self._failovers_total += 1
            emit_event("serving_fleet_failover", rid=exp.request.rid,
                       replica=name, mode=mode,
                       new_tokens=len(exp.tokens))
            self._pending.append(_Pending(exp=exp, from_replica=name,
                                          t_failed=now))
            moved.append(exp.request.rid)
        self._pending.sort(key=lambda p: -p.exp.request.priority)
        return moved

    def rejoin(self, name: str) -> None:
        """Return a drained (or recovered/rebuilt) replica to service
        with its WRR credits reset.  A DEAD replica may rejoin only
        because the caller rebuilt it (the router closed its
        scheduler) — pass the same name with a fresh scheduler via
        :meth:`replace`."""
        r = self._replicas[name]
        if r.state is ReplicaState.DEAD:
            raise ValueError(
                f"rejoin({name!r}): the router closed this replica's "
                f"scheduler at failover — rebuild it and call "
                f"replace() instead")
        r.wedged = False
        r.stalled = False
        r.last_beat = self._clock()
        self._transition(r, ReplicaState.HEALTHY)
        self._reset_credits(name)

    def replace(self, name: str, scheduler) -> None:
        """Swap in a rebuilt scheduler for a DEAD replica (same shared
        clock required) and rejoin it fresh.  Refuses a replica that is
        not DEAD: a live scheduler may hold in-flight streams, and
        silently discarding it would drop them without a failover —
        ``drain()`` + ``rejoin()`` is the live-replica path, ``kill()``
        the destructive one."""
        if scheduler.clock is not self._clock:
            raise ValueError(
                f"replace({name!r}): the new scheduler must share the "
                f"fleet clock object")
        r = self._replicas[name]
        if r.state is not ReplicaState.DEAD:
            raise ValueError(
                f"replace({name!r}): replica is {r.state.value}, not "
                f"dead — replacing a live scheduler would drop its "
                f"in-flight streams; drain() it first (or kill() it "
                f"to force a failover)")
        r.scheduler = scheduler
        r.wedged = False
        r.stalled = False
        r.last_beat = self._clock()
        self._transition(r, ReplicaState.HEALTHY)
        self._reset_credits(name)

    # ---- the loop --------------------------------------------------------
    def step(self) -> List[str]:
        """One fleet step boundary: watchdog sweep (suspect/dead
        transitions + failover drains), re-place pending victims, then
        step every live replica — a completed step IS the heartbeat.
        Returns rids that reached a terminal state, fleet-wide."""
        self._check_health()
        self._place_pending()
        finished: List[str] = []
        for r in self._replicas.values():
            if r.state is ReplicaState.DEAD or r.wedged:
                continue                 # a wedged step never returns
            if r.stalled:
                r.stalled = False        # one missed beat, then retry
                continue
            finished.extend(r.scheduler.step())
            r.last_beat = self._clock()
            if r.state is ReplicaState.SUSPECT:
                # a completed beat clears suspicion; credits reset so
                # the comeback cannot burst-claim missed traffic
                self._transition(r, ReplicaState.HEALTHY)
                self._reset_credits(r.name)
        self._steps += 1
        obs_bridge.SERVING_FLEET_REPLICAS_HEALTHY.set(
            self.replicas_healthy)
        if self._alerts is not None:
            # the fleet step boundary is the alert engine's evaluation
            # tick: every gauge/counter above is freshly set, and the
            # shared clock makes the firing/resolved ledger a
            # deterministic function of the workload
            self._alerts.evaluate(now=self._clock())
        return finished

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[str, RequestResult]:
        """Drain the whole fleet; returns rid -> result."""
        steps = 0
        bound = max_steps if max_steps is not None else (
            64 + sum(r.scheduler._derived_step_bound()
                     for r in self._live_replicas()))
        while (self.queue_depth or self.active_count
               or self.suspended_count):
            if steps >= bound:
                raise RuntimeError(
                    f"fleet drain stalled after {steps} steps: "
                    f"{self.queue_depth} queued, {self.active_count} "
                    f"active, {self.suspended_count} suspended, "
                    f"{len(self._pending)} pending failover")
            self.step()
            steps += 1
        return self.results
