"""Deterministic open-loop workload generation for the serving stack.

Counterpart of ``apex_tpu/serving/loadgen.py``.  A closed-loop client
submits only when the system is ready, so it never shows queueing;
serving comparisons are stated at a controlled *offered load*: requests
arrive at their own rate whatever the completions, and latency and
goodput are read from what queueing makes of them.  This module is that
generator, deterministic end to end:

- **Arrival processes** (:func:`uniform_arrivals`,
  :func:`poisson_arrivals`, :func:`burst_arrivals`): offset tables in
  seconds from a seeded ``numpy`` generator.
- **Prompt mixes** (:func:`shared_prefix_prompts`,
  :func:`zero_overlap_prompts`, :func:`mixed_length_prompts`): one
  shared system prompt (prefix caching's case), disjoint prompts, and a
  short-skewed length recipe, all seeded.
- :class:`OpenLoopWorkload`: requests + arrival offsets + per-request
  completion deadlines, validated.
- :class:`LoadGenerator`: drives a
  :class:`~apex_tpu_torch.serving.scheduler.ContinuousBatchingScheduler`
  open-loop on the scheduler's own clock: each request is submitted once
  its offset has come, a :class:`QueueFull` rejection is shed (counted
  against goodput, never retried), and the loop steps the scheduler until
  the workload drains.  On a :class:`VirtualClock` with ``step_time_s``
  the run is sleep-free and every latency an exact multiple of the step.

Goodput (requests served in full within their deadline / requests
offered) is the overload metric.  A run emits ``loadgen_started``, one
``loadgen_request_shed`` per arrival a full queue turned away, and
``loadgen_finished``, with the JAX module's payloads; a deadline-carrying
workload also sets the ``apex_serving_goodput_ratio`` gauge
(:mod:`apex_tpu_torch.obs.bridge`).  :class:`LoadgenResult` carries the
same counts, with the workload's fingerprint and offered rate.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.serving.scheduler import (
    SERVED_REASONS,
    QueueFull,
    Request,
    RequestResult,
)

__all__ = [
    "LoadGenerator",
    "LoadgenResult",
    "OpenLoopWorkload",
    "chain_hooks",
    "VirtualClock",
    "burst_arrivals",
    "make_workload",
    "mixed_length_prompts",
    "poisson_arrivals",
    "shared_prefix_prompts",
    "uniform_arrivals",
    "zero_overlap_prompts",
]


class VirtualClock:
    """A monotonic clock that moves only when told to.

    Pass one instance as ``clock=`` to the scheduler (the load generator
    reads the scheduler's), and every latency becomes an exact
    arithmetic fact — no sleeps, no wall-clock margins.  Binary-friendly steps
    (0.25, 0.125) keep the arithmetic float-exact.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt}")
        self._t += float(dt)
        return self._t


# ---------------------------------------------------------------------------
# arrival processes — offset tables in seconds, deterministic by seed
# ---------------------------------------------------------------------------

def chain_hooks(*hooks):
    """Compose ``step_hook`` callables into one, fired in order.

    A :class:`LoadGenerator` takes exactly one hook; this stacks several
    (a slow step, a cancellation, a probe).  ``None`` entries are
    skipped so call sites can toggle hooks inline; an all-``None`` chain
    returns ``None`` (no hook at all)."""
    live = [h for h in hooks if h is not None]
    if not live:
        return None

    def hook(step: int, scheduler) -> None:
        for h in live:
            h(step, scheduler)

    return hook


def uniform_arrivals(n: int, rate_rps: float) -> Tuple[float, ...]:
    """``n`` arrivals equally spaced at ``rate_rps`` requests/s,
    starting at t=0 (offset ``i / rate``)."""
    if n < 1 or rate_rps <= 0:
        raise ValueError(f"need n >= 1 and rate_rps > 0, got "
                         f"n={n} rate_rps={rate_rps}")
    return tuple(i / rate_rps for i in range(n))


def poisson_arrivals(n: int, rate_rps: float, seed: int = 0
                     ) -> Tuple[float, ...]:
    """``n`` arrivals of a seeded Poisson process at mean ``rate_rps``
    (i.i.d. exponential gaps; same seed ⇒ same schedule, bit for bit)."""
    if n < 1 or rate_rps <= 0:
        raise ValueError(f"need n >= 1 and rate_rps > 0, got "
                         f"n={n} rate_rps={rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return tuple(np.cumsum(gaps) - gaps[0])       # first arrival at t=0


def burst_arrivals(n: int, burst: int, period_s: float,
                   spacing_s: float = 0.0) -> Tuple[float, ...]:
    """Burst trains: groups of ``burst`` requests every ``period_s``
    seconds, ``spacing_s`` apart inside a group (0 == simultaneous) —
    the bursty workload the ROADMAP grades SLO scheduling by.  Mean
    offered load is ``burst / period_s``."""
    if n < 1 or burst < 1 or period_s <= 0 or spacing_s < 0:
        raise ValueError(
            f"need n >= 1, burst >= 1, period_s > 0, spacing_s >= 0; "
            f"got n={n} burst={burst} period_s={period_s} "
            f"spacing_s={spacing_s}")
    if spacing_s * (burst - 1) >= period_s:
        raise ValueError(
            f"a burst of {burst} at spacing {spacing_s}s outlasts its "
            f"own period {period_s}s — not a burst train")
    return tuple((i // burst) * period_s + (i % burst) * spacing_s
                 for i in range(n))


# ---------------------------------------------------------------------------
# prompt mixes — seeded token-id lists
# ---------------------------------------------------------------------------

def _token_list(rng, n: int, vocab: int) -> List[int]:
    return [int(x) for x in rng.integers(0, vocab, n)]


def shared_prefix_prompts(n: int, *, shared_len: int, suffix_len: int,
                          vocab: int, seed: int = 0) -> List[List[int]]:
    """A chatbot fleet: one shared system prompt of ``shared_len``
    tokens + a unique ``suffix_len``-token tail per request (the
    prefix-cache hit workload)."""
    rng = np.random.default_rng(seed)
    shared = _token_list(rng, shared_len, vocab)
    return [shared + _token_list(rng, suffix_len, vocab)
            for _ in range(n)]


def zero_overlap_prompts(n: int, *, length: int, vocab: int,
                         seed: int = 0) -> List[List[int]]:
    """Disjoint random prompts (the prefix cache's no-regression
    workload; every admission is a miss)."""
    rng = np.random.default_rng(seed)
    return [_token_list(rng, length, vocab) for _ in range(n)]


#: the short-skewed length mix of real traffic: fractions of
#: ``prefill_len`` cycled per request (the JAX module's recipe).
LENGTH_SKEW_FRACTIONS = (1 / 8, 1 / 8, 1 / 8, 1 / 8, 3 / 16, 1 / 4,
                         1 / 2, 1)


def mixed_length_prompts(n: int, *, prefill_len: int, vocab: int,
                         seed: int = 0, max_len: Optional[int] = None
                         ) -> List[List[int]]:
    """Mixed prompt lengths over the short-skewed recipe
    (:data:`LENGTH_SKEW_FRACTIONS` of ``prefill_len``, cycled), token
    ids seeded; lengths clamped under ``max_len`` when given."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = max(1, int(prefill_len
                            * LENGTH_SKEW_FRACTIONS[
                                i % len(LENGTH_SKEW_FRACTIONS)]))
        if max_len is not None:
            length = min(length, max_len)
        out.append(_token_list(rng, length, vocab))
    return out


# ---------------------------------------------------------------------------
# the workload + the generator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpenLoopWorkload:
    """Requests + arrival offsets (+ optional per-request completion
    deadlines, relative to arrival) in arrival order."""

    requests: Tuple[Request, ...]
    arrivals: Tuple[float, ...]            # offsets from run start, sorted
    deadlines: Tuple[Optional[float], ...]  # relative to arrival; None=∞

    def __post_init__(self):
        n = len(self.requests)
        if n < 1:
            raise ValueError("empty workload")
        if len(self.arrivals) != n or len(self.deadlines) != n:
            raise ValueError(
                f"requests/arrivals/deadlines length mismatch: "
                f"{n}/{len(self.arrivals)}/{len(self.deadlines)}")
        if any(b < a for a, b in zip(self.arrivals, self.arrivals[1:])):
            raise ValueError("arrival offsets must be non-decreasing")
        if self.arrivals[0] < 0:
            raise ValueError(
                f"first arrival offset {self.arrivals[0]} < 0")
        if any(d is not None and d <= 0 for d in self.deadlines):
            raise ValueError("deadlines must be positive (or None)")
        rids = [r.rid for r in self.requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate rids in workload")

    @property
    def offered(self) -> int:
        return len(self.requests)

    @property
    def offered_rps(self) -> float:
        """Mean offered load over the arrival window (n-1 gaps)."""
        span = self.arrivals[-1] - self.arrivals[0]
        if len(self.arrivals) < 2 or span <= 0:
            return float("inf")
        return (len(self.arrivals) - 1) / span

    def schedule_fingerprint(self) -> str:
        """Hex digest over arrival offsets + every prompt's token ids +
        per-request generation config — two workloads with equal
        fingerprints produce identical token streams on a deterministic
        scheduler."""
        h = hashlib.blake2b(digest_size=16)
        for req, off, dl in zip(self.requests, self.arrivals,
                                self.deadlines):
            h.update(repr((req.rid, tuple(req.prompt),
                           req.max_new_tokens, req.eos_id,
                           req.temperature, req.top_k, req.seed,
                           float(off),
                           None if dl is None else float(dl),
                           req.priority, req.tenant,
                           None if req.deadline_s is None
                           else float(req.deadline_s))).encode())
        return h.hexdigest()


def make_workload(prompts: Sequence[Sequence[int]],
                  arrivals: Sequence[float], *,
                  max_new_tokens: int,
                  deadline_s: Optional[float] = None,
                  eos_id: Optional[int] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  seed: int = 0,
                  rid_prefix: str = "lg",
                  priorities: Optional[Sequence[int]] = None,
                  tenants: Optional[Sequence[str]] = None
                  ) -> OpenLoopWorkload:
    """Zip a prompt mix with an arrival table into an
    :class:`OpenLoopWorkload` (one shared ``deadline_s`` / generation
    config; build the dataclass directly for per-request variety).

    ``deadline_s`` rides both the workload (goodput accounting, from
    arrival) and each :class:`Request` (so a ``policy=`` scheduler can
    shed expired queued requests — a FIFO scheduler ignores it).
    ``priorities`` / ``tenants`` optionally assign per-request control
    -plane fields (cycled if shorter than the prompt list)."""
    if len(prompts) != len(arrivals):
        raise ValueError(f"{len(prompts)} prompts vs {len(arrivals)} "
                         f"arrivals")
    requests = tuple(
        Request(f"{rid_prefix}{i}", list(p), max_new_tokens=max_new_tokens,
                eos_id=eos_id, temperature=temperature, top_k=top_k,
                seed=seed + i, deadline_s=deadline_s,
                priority=(0 if priorities is None
                          else int(priorities[i % len(priorities)])),
                tenant=("default" if tenants is None
                        else str(tenants[i % len(tenants)])))
        for i, p in enumerate(prompts))
    return OpenLoopWorkload(requests=requests,
                            arrivals=tuple(float(a) for a in arrivals),
                            deadlines=(deadline_s,) * len(requests))


@dataclasses.dataclass
class LoadgenResult:
    """One open-loop run's outcome: completions, shed arrivals, and the
    deadline bookkeeping.  ``arrivals`` are *absolute* clock stamps —
    deadlines are enforced from arrival, not from (possibly later)
    submission, so a step boundary's submit lag can never quietly extend
    a deadline.  ``fingerprint`` and ``offered_rps`` are the workload's
    (what the ``loadgen_started`` event carries)."""

    offered: int
    completed: int                         # results with FULL service
    rejected: List[str]                    # shed at QueueFull, in order
    results: Dict[str, RequestResult]      # rid -> scheduler result
    deadlines: Dict[str, Optional[float]]  # rid -> deadline from arrival
    arrivals: Dict[str, float]             # rid -> absolute arrival stamp
    met_deadline: Dict[str, bool]          # rid -> served within it
    duration_s: float
    steps: int
    fingerprint: str = ""
    offered_rps: float = float("inf")

    @property
    def goodput(self) -> Optional[float]:
        """Requests *served in full* within their deadline / offered
        (None when the workload carries no deadlines — goodput is then
        undefined, not 1.0).  A cancelled or policy-shed request has a
        result but delivered partial or no service
        (:data:`~apex_tpu_torch.serving.scheduler.SERVED_REASONS`), so it
        can never count as met — finishing early by giving up is not
        goodput."""
        if all(d is None for d in self.deadlines.values()):
            return None
        return sum(self.met_deadline.values()) / max(self.offered, 1)


class LoadGenerator:
    """Drive a scheduler open-loop through one workload.

    >>> gen = LoadGenerator(sched, workload)         # real clock
    >>> out = gen.run()
    >>> gen = LoadGenerator(sched, workload, step_time_s=0.25)  # virtual
    >>> out = gen.run()                              # fully deterministic

    ``step_time_s`` is the virtual cost of one scheduler step: after
    each ``sched.step()`` the scheduler's clock (which must then be a
    :class:`VirtualClock`) advances by it.  Leave it ``None`` on the
    real monotonic clock.  The loop submits every arrival
    whose offset has come due *before* each step — open-loop: arrivals
    never wait for capacity, and a full queue sheds the request
    (recorded in ``rejected``, charged against goodput).

    ``step_hook`` (optional, ``hook(step_index, scheduler)``) fires
    after every scheduler step: the point where a caller inflates a
    step on the virtual clock, cancels a request or inspects state,
    deterministic by step index.  ``None`` (the default) runs the plain
    loop.

    The target is duck-typed: anything exposing the scheduler surface
    the loop uses (``submit`` / ``step`` / ``results`` / ``clock`` /
    ``queue_depth`` / ``active_count`` / ``suspended_count``) drives
    identically.
    """

    def __init__(self, scheduler, workload: OpenLoopWorkload, *,
                 step_time_s: Optional[float] = None,
                 max_steps: Optional[int] = None,
                 step_hook: Optional[Callable[[int, Any], None]] = None):
        clock = scheduler.clock
        if step_time_s is not None:
            if step_time_s <= 0:
                raise ValueError(
                    f"step_time_s must be > 0, got {step_time_s}")
            if not hasattr(clock, "advance"):
                raise ValueError(
                    "step_time_s needs an advanceable scheduler clock "
                    "— construct the scheduler with "
                    "clock=VirtualClock()")
        self.scheduler = scheduler
        self.workload = workload
        self.step_time_s = step_time_s
        self.max_steps = max_steps
        self.step_hook = step_hook
        self._clock: Callable[[], float] = clock

    def run(self) -> LoadgenResult:
        sched, wl = self.scheduler, self.workload
        t_start = self._clock()
        i = 0
        n = wl.offered
        rejected: List[str] = []
        submit_stamps: Dict[str, float] = {}
        steps = 0
        emit_event("loadgen_started", offered=n,
                   fingerprint=wl.schedule_fingerprint(),
                   offered_rps=(None if wl.offered_rps == float("inf")
                                else round(wl.offered_rps, 6)))

        def pending() -> bool:
            # suspended (preempted) streams are live work: a policy
            # scheduler may hold a victim mid-decode while its
            # preemptor finishes — stopping then would orphan the
            # victim without a result (and a later close() would
            # refuse).  FIFO schedulers always report 0 suspended.
            return bool(sched.queue_depth or sched.active_count
                        or sched.suspended_count)

        while i < n or pending():
            now = self._clock() - t_start
            while i < n and wl.arrivals[i] <= now + 1e-12:
                req = wl.requests[i]
                try:
                    sched.submit(req)
                    submit_stamps[req.rid] = self._clock()
                except QueueFull:
                    # open-loop: the arrival process never slows down
                    # for the system — a full queue sheds the request
                    rejected.append(req.rid)
                    emit_event("loadgen_request_shed", rid=req.rid,
                               queue_depth=sched.queue_depth)
                i += 1
            if i >= n and not pending():
                break                       # everything shed or done
            t_before = self._clock()
            sched.step()
            steps += 1
            if self.step_hook is not None:
                # the hook may inflate the clock, cancel requests or
                # inspect state, deterministic by step index
                self.step_hook(steps - 1, sched)
            if self.step_time_s is not None:
                self._clock.advance(self.step_time_s)
            elif (self._clock() == t_before and i < n
                  and not (sched.queue_depth or sched.active_count)):
                raise RuntimeError(
                    "scheduler clock did not advance across an idle "
                    "step with arrivals still pending — a virtual "
                    "clock needs step_time_s= (the run would spin "
                    "forever)")
            if self.max_steps is not None and steps >= self.max_steps:
                break
        duration_s = self._clock() - t_start
        all_results = sched.results          # ONE copy of the property
        results = {r.rid: all_results[r.rid] for r in wl.requests
                   if r.rid in all_results}
        deadlines = {r.rid: d for r, d in zip(wl.requests, wl.deadlines)}
        arrivals = {r.rid: t_start + off
                    for r, off in zip(wl.requests, wl.arrivals)}
        met = {}
        served = 0
        for req, deadline in zip(wl.requests, wl.deadlines):
            res = results.get(req.rid)
            # only FULL service can meet a deadline: a cancelled or
            # policy-shed result exists but delivered nothing it
            # promised — counting it as met would reward giving up
            if res is None or res.finish_reason not in SERVED_REASONS:
                met[req.rid] = False
                continue
            served += 1
            # enforced from ARRIVAL, not submission: submits happen at
            # step boundaries, so a request due mid-step is submitted
            # late — that lag must tighten its remaining budget, never
            # extend the deadline
            finish_abs = submit_stamps[req.rid] + res.total_s
            met[req.rid] = bool(
                deadline is None
                or finish_abs - arrivals[req.rid] <= deadline)
        out = LoadgenResult(offered=n, completed=served,
                            rejected=rejected, results=results,
                            deadlines=deadlines, arrivals=arrivals,
                            met_deadline=met, duration_s=duration_s,
                            steps=steps,
                            fingerprint=wl.schedule_fingerprint(),
                            offered_rps=wl.offered_rps)
        goodput = out.goodput
        if goodput is not None:
            # only a deadline-carrying workload touches the gauge: the
            # default metric stream stays as it was
            from apex_tpu_torch.obs import bridge as obs_bridge

            obs_bridge.SERVING_GOODPUT.set(goodput)
        emit_event("loadgen_finished", offered=n,
                   completed=out.completed, shed=len(rejected),
                   steps=steps, duration_s=round(duration_s, 6),
                   goodput=(None if goodput is None
                            else round(goodput, 6)))
        return out
