"""Training supervisor: step watchdog, heartbeat, escalation, clean abort
(the port of ``apex_tpu.resilience.supervisor``).

The host-side layer that turns the quiet failures — a step that never
finishes, a straggling host, an input pipeline that hangs or rots — into
*events with deadlines*:

- :class:`StepWatchdog` — a per-step deadline on a monotonic clock.
  ``arm``/``disarm`` bracket each step (or ``with watchdog.step(i):``);
  a background monitor thread notices a stall mid-step and dumps
  structured diagnostics (step, heartbeat age, pipeline timer snapshot,
  the CUDA allocator's allocated bytes) through ``emit_event`` while the
  step is still stuck.  ``disarm`` raises :class:`StepDeadlineExceeded`
  for slow-but-finished steps.
- **Heartbeat file** — ``beat`` atomically rewrites a small JSON file
  (step, wall/monotonic time, newest checkpoint path) that an external
  orchestrator watches, the JAX package's file field for field.
- :class:`TrainingSupervisor` — the escalation policy: transient
  data-fetch failures are retried, corrupt batches are skipped within
  the guard's budget, and *unrecovered* step-level failures feed a
  consecutive-failure counter.  At ``max_consecutive_failures`` the
  supervisor writes an emergency checkpoint through the validated
  atomic machinery, proves it good, records it in the heartbeat and
  raises :class:`TrainingAborted` — the run dies clean and resumable.

The clock, sleeper and fault sources are injectable, so every path runs
on the CPU in tests without real waits.  On CUDA the step a supervisor
brackets must end on a host read (see :class:`TrainingSupervisor`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Iterable, Optional, Tuple

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.obs import trace as obs_trace
from apex_tpu_torch.resilience.async_checkpoint import (
    AsyncCheckpointer,
    SaveVetoed,
)
from apex_tpu_torch.resilience.checkpoint import (
    CheckpointError,
    CheckpointManager,
    validate_checkpoint,
)
from apex_tpu_torch.resilience.consistency import ReplicaDesyncError
from apex_tpu_torch.resilience.data_guard import (
    DataStallError,
    SkipBudgetExceeded,
)
from apex_tpu_torch.resilience.retry import (
    RetryExhausted,
    RetryPolicy,
    retry_transient,
)
from apex_tpu_torch.utils.serialization import atomic_write_json

__all__ = [
    "StepDeadlineExceeded",
    "StepWatchdog",
    "SupervisorConfig",
    "TrainingAborted",
    "TrainingSupervisor",
    "read_heartbeat",
    "write_heartbeat",
]

logger = get_logger("resilience.supervisor")

# the histogram is the p99-step-time answer, the counter the progress
# rate, the gauge the liveness probe an exporter reads without parsing
# heartbeat files — evaluated at scrape time via set_function
_STEP_SECONDS = obs_metrics.histogram(
    "apex_step_duration_seconds", "supervised train-step wall time")
_STEPS_TOTAL = obs_metrics.counter(
    "apex_supervisor_steps_total",
    "steps completed under the training supervisor")
_HEARTBEAT_AGE = obs_metrics.gauge(
    "apex_heartbeat_age_seconds",
    "seconds since the newest watchdog beat (-1 before the first)")


class StepDeadlineExceeded(RuntimeError):
    """A training step outlived its deadline (straggler or hang).

    Carries ``step``, ``deadline_s``, ``elapsed_s`` and the
    ``diagnostics`` dict dumped with the ``watchdog_stall`` event.
    """

    def __init__(self, step: int, deadline_s: float, elapsed_s: float,
                 diagnostics: Optional[dict] = None):
        super().__init__(
            f"step {step} exceeded its {deadline_s:.3f}s deadline "
            f"({elapsed_s:.3f}s elapsed)")
        self.step = step
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s
        self.diagnostics = diagnostics or {}


class TrainingAborted(RuntimeError):
    """Clean abort after graceful degradation: the emergency checkpoint
    (``checkpoint_path``, when one could be written) is validated and
    resumable — restart from it."""

    def __init__(self, reason: str, step: int,
                 checkpoint_path: Optional[str] = None):
        super().__init__(
            f"training aborted at step {step}: {reason}"
            + (f" (emergency checkpoint: {checkpoint_path})"
               if checkpoint_path else " (no emergency checkpoint written)"))
        self.reason = reason
        self.step = step
        self.checkpoint_path = checkpoint_path


def write_heartbeat(path: str, step: int, *,
                    ckpt_path: Optional[str] = None,
                    stalled: bool = False) -> dict:
    """Atomically rewrite the heartbeat file; returns the payload.

    Same crash-safety move as the checkpoint writer (temp + ``os.replace``):
    a watcher never reads a half-written heartbeat.  ``monotonic`` rides
    along so in-process readers can compute stall-safe ages; external
    watchers use mtime / ``time``.  A model-parallel run adds this
    process's ``rank_info`` and the ``mesh`` sizes, as JAX's does.
    """
    payload = {
        "step": int(step),
        "time": time.time(),
        "monotonic": time.monotonic(),
        "pid": os.getpid(),
        "ckpt_path": ckpt_path,
        "stalled": bool(stalled),
    }
    try:
        from apex_tpu_torch.transformer import parallel_state

        if parallel_state.model_parallel_is_initialized():
            payload["rank_info"] = parallel_state.get_rank_info()
            payload["mesh"] = parallel_state.mesh_axis_sizes()
    except Exception as e:  # the liveness probe must outlive rank plumbing
        logger.debug("heartbeat rank info unavailable: %s: %s",
                     type(e).__name__, e)
    # atomic_write_json embeds the thread ident in its temp name: a
    # monitor thread and the main thread may write concurrently
    atomic_write_json(path, payload)
    return payload


def read_heartbeat(path: str) -> dict:
    """Parse a heartbeat file (the watcher side of :func:`write_heartbeat`)."""
    with open(path) as f:
        return json.load(f)


class StepWatchdog:
    """Per-step deadline on a monotonic clock, with a monitor thread.

    Synchronous contract: ``arm(step)`` at step start, ``disarm()`` at
    step end — ``disarm`` raises :class:`StepDeadlineExceeded` when the
    deadline was blown (the straggler case: the step *finished*, late).
    Asynchronous contract: ``start()`` spawns a daemon monitor thread
    that polls the armed step and, the moment a stall crosses the
    deadline, dumps diagnostics via a ``watchdog_stall`` event, marks
    the heartbeat file ``stalled``, and invokes ``on_stall`` (the hook
    for ``_thread.interrupt_main`` or an orchestrator RPC) — so a truly
    hung step still leaves evidence even though no Python thread can
    unwedge it.  ``arm``/``disarm`` are single attribute swaps (atomic
    under the GIL).

    On CUDA a step returns to the host before the card has finished it:
    a deadline around a step that never synchronizes times only its
    launches.  Bracket a step that ends on a host read (its loss and
    ``found_inf``, say), and the deadline covers the card's work too.
    """

    def __init__(self, deadline_s: float, *,
                 heartbeat_path: Optional[str] = None,
                 timers=None,
                 poll_interval_s: Optional[float] = None,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        if poll_interval_s is not None and poll_interval_s <= 0.0:
            raise ValueError(
                f"poll_interval_s must be positive, got {poll_interval_s}")
        self.deadline_s = deadline_s
        self.heartbeat_path = heartbeat_path
        self.timers = timers
        self.poll_interval_s = (poll_interval_s if poll_interval_s is not None
                                else min(max(deadline_s / 4.0, 0.01), 10.0))
        self.on_stall = on_stall
        self._clock = clock
        self._armed: Optional[Tuple[int, float]] = None  # (step, t0) swap
        self._stall: Optional[dict] = None  # monitor-observed diagnostics
        self._last_beat: Optional[Tuple[int, float]] = None
        self._last_ckpt_path: Optional[str] = None  # newest known checkpoint
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # scrape-time heartbeat age: the gauge binding is acquired at
        # start() — NOT here, where merely constructing a second
        # watchdog would steal the gauge from a healthy running one and
        # report the -1 sentinel (a false wedged-host signal)
        self._released = False
        self._prev_beat_age: Optional[Callable[[], float]] = None

    def _beat_age(self) -> float:
        # a released (stopped) watchdog reports the no-live-beat
        # sentinel, NEVER a frozen last beat aging without bound — even
        # if a misordered stop() chain hands the gauge back to it
        beat = self._last_beat if not self._released else None
        return self._clock() - beat[1] if beat is not None else -1.0

    # -- monitor lifecycle -------------------------------------------------

    def start(self) -> "StepWatchdog":
        """Spawn the monitor thread (idempotent).  Acquires (or
        re-acquires after a stop()) the process-default heartbeat-age
        gauge: the newest STARTED watchdog wins, the displaced binding
        is remembered so stop() can hand it back, and a reused
        supervisor's second run keeps its liveness probe."""
        self._released = False
        if _HEARTBEAT_AGE.bound_function() != self._beat_age:
            self._prev_beat_age = _HEARTBEAT_AGE.bound_function()
            _HEARTBEAT_AGE.set_function(self._beat_age)
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._monitor, name="apex-step-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the monitor thread (idempotent).  Also hands
        the heartbeat-age gauge back IF still bound to this watchdog: a
        finished run must not keep reporting an ever-growing age (a
        false wedged-host signal) or pin this object alive through the
        gauge's bound-method reference — and a short-lived inner
        watchdog must not leave a still-running outer one unreported,
        so the binding this one displaced at construction is restored
        rather than cleared.  A newer watchdog's binding is left
        untouched."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self.poll_interval_s * 4, 1.0))
            self._thread = None
        self._released = True
        if _HEARTBEAT_AGE.bound_function() == self._beat_age:
            _HEARTBEAT_AGE.set_function(self._prev_beat_age)
            if self._prev_beat_age is None:
                # keep the series PRESENT with the honest sentinel: an
                # alert on -1 must read a sample, not a vanished series
                _HEARTBEAT_AGE.set(-1.0)

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- per-step bracket --------------------------------------------------

    def arm(self, step: int) -> None:
        """Start the deadline for ``step`` (one attribute swap)."""
        self._stall = None
        self._armed = (int(step), self._clock())

    def cancel(self) -> None:
        """Clear the armed step without a deadline check (use when the
        step body raised for an unrelated reason — don't double-report)."""
        self._armed = None
        self._stall = None

    def disarm(self) -> None:
        """End the armed step; raises :class:`StepDeadlineExceeded` when
        the step overran its deadline (or the monitor already saw it)."""
        armed, self._armed = self._armed, None
        if armed is None:
            raise RuntimeError("disarm() without a matching arm()")
        step, t0 = armed
        elapsed = self._clock() - t0
        stall = self._stall
        self._stall = None
        if stall is not None and stall.get("step") != step:
            # the monitor raced arm(): it observed the PREVIOUS step's
            # stall and stored it after arm() cleared the slot — that
            # step already raised at its own disarm; not this step's miss
            stall = None
        if stall is None and elapsed <= self.deadline_s:
            return
        diag = stall or self._diagnostics(step, elapsed)
        if stall is None:
            # the monitor did not get there first (tight deadline or no
            # thread running): this is the one report for the step
            emit_event("watchdog_stall", **diag)
        raise StepDeadlineExceeded(step, self.deadline_s, elapsed, diag)

    @contextlib.contextmanager
    def step(self, step: int):
        """``with watchdog.step(i): ...`` — arm/disarm bracket that does
        not double-fire when the body raises on its own."""
        self.arm(step)
        try:
            yield self
        except BaseException:
            self.cancel()
            raise
        self.disarm()

    # -- heartbeat ---------------------------------------------------------

    def beat(self, step: int, *, ckpt_path: Optional[str] = None) -> None:
        """Record liveness (and optionally the newest checkpoint path);
        rewrites the heartbeat file when one is configured.  The
        checkpoint path is *sticky*: a ``beat`` without one re-publishes
        the newest path seen, so the heartbeat's resume pointer survives
        the (majority of) steps that don't save.  A heartbeat write
        failure is logged, never fatal — losing the liveness probe must
        not kill the run the probe exists to protect."""
        self._last_beat = (int(step), self._clock())
        if ckpt_path is not None:
            self._last_ckpt_path = ckpt_path
        if self.heartbeat_path is None:
            return
        try:
            write_heartbeat(self.heartbeat_path, step,
                            ckpt_path=self._last_ckpt_path)
        except OSError as e:
            logger.warning("heartbeat write to %s failed: %s",
                           self.heartbeat_path, e)

    # -- diagnostics -------------------------------------------------------

    def _diagnostics(self, step: int, elapsed_s: float) -> dict:
        """The stall dump: everything a post-mortem needs that vanishes
        with the process."""
        beat_age = None
        if self._last_beat is not None:
            beat_age = round(self._clock() - self._last_beat[1], 3)
        diag = {
            "step": int(step),
            "deadline_s": self.deadline_s,
            "elapsed_s": round(elapsed_s, 3),
            "heartbeat_age_s": beat_age,
        }
        try:
            # JAX counts its live arrays; the port reads the CUDA caching
            # allocator's allocated bytes (0 before CUDA is initialized)
            import torch

            diag["cuda_allocated_bytes"] = (
                torch.cuda.memory_allocated()
                if torch.cuda.is_initialized() else 0)
        except Exception as e:  # diagnostics must never mask the stall
            diag["cuda_allocated_bytes"] = (
                f"unavailable: {type(e).__name__}")
        if self.timers is not None:
            try:
                diag["timers"] = self.timers.snapshot()
            except Exception as e:
                diag["timers"] = f"unavailable: {type(e).__name__}"
        return diag

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            armed = self._armed
            if armed is None or self._stall is not None:
                continue
            step, t0 = armed
            elapsed = self._clock() - t0
            if elapsed <= self.deadline_s:
                continue
            diag = self._diagnostics(step, elapsed)
            # heartbeat BEFORE the event: anything watching the event
            # stream may react immediately and must find the stall marker
            if self.heartbeat_path is not None:
                try:
                    write_heartbeat(self.heartbeat_path, step,
                                    ckpt_path=self._last_ckpt_path,
                                    stalled=True)
                except OSError as e:
                    logger.warning("stall heartbeat write failed: %s", e)
            emit_event("watchdog_stall", **diag)
            self._stall = diag  # one report per armed step
            if self.on_stall is not None:
                self.on_stall(diag)


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Escalation policy knobs.

    ``step_deadline_s`` bounds one step (watchdog).  ``checkpoint_every``
    is the periodic-save interval in steps (the final step always saves).
    ``max_consecutive_failures`` is the graceful-degradation trigger:
    that many *unrecovered* failures in a row write an emergency
    checkpoint and abort cleanly.  ``retry`` governs every host-I/O
    retry (data fetch, checkpoint save).
    ``consistency_check_interval`` runs the supervisor's
    :class:`~apex_tpu_torch.resilience.consistency.ReplicaConsistency` pass
    every that many steps (0 disables); a desync the pass cannot repair
    escalates through the same failure ladder as every other
    unrecovered failure.

    ``async_save`` (default off — the sync path is the escape hatch and
    the bit-identical reference) moves periodic checkpoint writes onto a
    background thread: the step loop blocks only on the device→host
    snapshot, at most one write is in flight (backpressure blocks the
    *next* save, not the step), a failed write surfaces at the next step
    boundary into the same retry/escalation ladder, emergency
    checkpoints and shutdown join the in-flight write first, and a
    failed consistency pass vetoes an in-flight commit.  On-disk bytes
    and restores are identical to sync mode."""

    step_deadline_s: float = 1800.0
    poll_interval_s: Optional[float] = None
    max_consecutive_failures: int = 3
    checkpoint_every: int = 1
    consistency_check_interval: int = 0
    heartbeat_path: Optional[str] = None
    async_save: bool = False
    # bound on joining a wedged background writer at escalation/shutdown:
    # the graceful-degradation contract ("a wedged process is worse than
    # a lost checkpoint interval") must hold against the writer too —
    # past the bound the emergency save proceeds anyway (the live-writer
    # registry makes the two writers safe concurrently) and the daemon
    # writer dies with the process, its temp dir never committable
    async_join_timeout_s: float = 120.0
    retry: RetryPolicy = RetryPolicy()

    def __post_init__(self):
        if self.step_deadline_s <= 0.0:
            raise ValueError("step_deadline_s must be positive")
        if self.max_consecutive_failures < 1:
            raise ValueError("max_consecutive_failures must be >= 1")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.consistency_check_interval < 0:
            raise ValueError("consistency_check_interval must be >= 0")
        if self.async_join_timeout_s <= 0.0:
            raise ValueError("async_join_timeout_s must be positive")


class TrainingSupervisor:
    """Supervised host loop: watchdog + retry + skip budget + escalation.

    ``run(step_fn, state, batches, num_steps=...)`` drives
    ``step_fn(state, batch, step) -> state`` over ``batches`` (wrap them
    in a :class:`~apex_tpu_torch.resilience.data_guard.GuardedIterator` for
    validation/skip semantics), with:

    - every batch fetch retried under ``config.retry`` (transient
      producer errors cost attempts, not the run);
    - every step bracketed by the watchdog;
    - a heartbeat + periodic validated checkpoint after each step;
    - a periodic cross-replica consistency pass (``consistency=`` a
      :class:`~apex_tpu_torch.resilience.consistency.ReplicaConsistency`, run
      every ``config.consistency_check_interval`` steps *before* the
      checkpoint commit) — silent replica divergence is detected,
      localized, and resynced in place; an unrepairable desync counts
      as an unrecovered failure;
    - an escalating consecutive-failure counter over the supervisor's
      failure domain (:class:`StepDeadlineExceeded`,
      :class:`~apex_tpu_torch.resilience.retry.RetryExhausted`,
      :class:`~apex_tpu_torch.resilience.data_guard.SkipBudgetExceeded`,
      :class:`~apex_tpu_torch.resilience.data_guard.DataStallError`,
      :class:`~apex_tpu_torch.resilience.consistency.ReplicaDesyncError`) —
      any other exception is not the supervisor's to absorb and
      propagates.

    A slow-but-finished step keeps its result (the work is real) but
    counts as a failure; escalation therefore checkpoints the *newest*
    state, and a restart resumes bit-identically.

    The watchdog times ``step_fn`` from its call to its return.  On CUDA
    that return comes before the card's work unless the step reads a
    result on the host, so a supervised step ends on such a read (its
    loss and ``found_inf``): the watchdog disarms after it, and the
    deadline and ``apex_step_duration_seconds`` cover the card's time.
    """

    FAILURE_DOMAIN = (StepDeadlineExceeded, RetryExhausted,
                      SkipBudgetExceeded, DataStallError,
                      ReplicaDesyncError)

    def __init__(self, manager: Optional[CheckpointManager] = None,
                 config: SupervisorConfig = SupervisorConfig(), *,
                 consistency=None,
                 persist_transform: Optional[Callable[[Any], Any]] = None,
                 timers=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.manager = manager
        self.config = config
        self.consistency = consistency
        self.persist_transform = persist_transform
        self.consecutive_failures = 0
        self._sleep = sleep
        # async pipeline: periodic saves become snapshot + background
        # write; the emergency path stays synchronous (it must be
        # durable before TrainingAborted is raised) but joins the
        # in-flight write first — one writer per root, always
        self._async = (AsyncCheckpointer(manager, retry=config.retry,
                                         sleep=sleep)
                       if config.async_save and manager is not None
                       else None)
        # step label of the newest checkpoint pointer published to the
        # heartbeat: the shutdown drain must never overwrite a NEWER
        # pointer (e.g. the emergency checkpoint escalate() just beat)
        # with an older async commit
        self._published_ckpt_step: Optional[int] = None
        # did escalate() already perform the bounded in-flight join?  the
        # finally drain must not pay a SECOND async_join_timeout_s on the
        # very wedged-writer path the bound exists for
        self._escalate_joined = False
        self.watchdog = StepWatchdog(
            config.step_deadline_s,
            heartbeat_path=config.heartbeat_path,
            timers=timers,
            poll_interval_s=config.poll_interval_s,
            clock=clock)

    # -- failure accounting / graceful degradation -------------------------

    def record_success(self) -> None:
        self.consecutive_failures = 0

    def record_failure(self, step: int, state: Any, exc: BaseException, *,
                       completed_step: Optional[int] = None) -> None:
        """Count one unrecovered failure; escalate at the threshold.

        ``completed_step`` is the step whose completion produced
        ``state`` and therefore labels any emergency checkpoint; it
        defaults to ``step``.  A fetch-time failure passes the PREVIOUS
        step here — ``state`` predates ``step``, and labeling the
        checkpoint ``step`` would make a resume at ``step + 1`` silently
        skip the step that never ran."""
        self.consecutive_failures += 1
        emit_event("supervisor_failure", step=int(step),
                   failure=type(exc).__name__, error=str(exc)[:500],
                   consecutive=self.consecutive_failures,
                   max_consecutive=self.config.max_consecutive_failures)
        if self.consecutive_failures >= self.config.max_consecutive_failures:
            self.escalate(step, state,
                          reason=f"{self.consecutive_failures} consecutive "
                                 f"failures (last: {type(exc).__name__})",
                          completed_step=completed_step)

    def escalate(self, step: int, state: Any, *, reason: str,
                 completed_step: Optional[int] = None) -> None:
        """Graceful degradation: emergency checkpoint, then clean abort.

        The checkpoint is written through the validated atomic machinery
        (with transient-I/O retries) and re-validated before the abort is
        raised; if even that fails, the abort still happens — carrying
        the error — because a wedged process is worse than a lost
        checkpoint interval.
        """
        ckpt_step = step if completed_step is None else completed_step
        path, path_step, ckpt_error = None, None, None
        if self._async is not None:
            # join the in-flight background write FIRST (bounded: a
            # writer wedged on dead storage must not block the abort
            # forever — the live-writer registry keeps a concurrent
            # emergency save safe): the emergency save must not race a
            # healthy writer for the root, and the newest committed
            # periodic path is a resume pointer worth carrying
            joined = self._async.wait(
                timeout=self.config.async_join_timeout_s)
            self._escalate_joined = True
            if joined is None and self._async.inflight is not None:
                logger.warning(
                    "background checkpoint write still running after "
                    "%.0fs at escalation — proceeding with the "
                    "emergency checkpoint", self.config.async_join_timeout_s)
            lc = self._async.last_committed  # one atomic (step, path) read
            if lc is not None:
                path_step, path = lc
        if self.manager is not None:
            fallback = (path, path_step)  # newest COMMITTED async pointer
            try:
                path = self._checkpoint(ckpt_step, state,
                                        what="emergency_checkpoint")
                validate_checkpoint(path)
                path_step = int(ckpt_step)
            except (RetryExhausted, CheckpointError, OSError) as e:
                ckpt_error = f"{type(e).__name__}: {e}"
                # never publish a pointer that just failed validation —
                # the abort carries the newest checkpoint known GOOD (or
                # None), plus the error explaining what was lost
                path, path_step = fallback
        emit_event("supervisor_abort", step=int(step), reason=reason,
                   checkpoint=path, checkpoint_error=ckpt_error)
        self.watchdog.beat(step, ckpt_path=path)
        if path is not None:
            self._note_published(path_step)
        raise TrainingAborted(reason, int(step), path)

    def _beat_if_newer(self, at_step: int) -> None:
        """Publish the async pipeline's newest committed checkpoint to
        the heartbeat iff it is newer than anything already published.
        ``at_step`` is the training step to label the beat with — the
        heartbeat's ``step`` field must never run backwards just because
        the checkpoint being published is older than the loop's last
        beat."""
        lc = self._async.last_committed  # one atomic (step, path) read
        if lc is None:
            return
        lc_step, lc_path = lc
        if (self._published_ckpt_step is not None
                and lc_step <= self._published_ckpt_step):
            return
        self.watchdog.beat(max(int(at_step), lc_step), ckpt_path=lc_path)
        self._note_published(lc_step)

    def _consume_async_result(self, done, step: int, state: Any) -> None:
        """THE harvest policy for one completed background write, shared
        by the step-boundary poll and the return drain: a failure in the
        supervisor's domain joins the ladder, a veto was deliberate and
        already accounted by its cause, anything else propagates exactly
        as a synchronous save error would.  Commits are published via
        ``last_committed``, never here."""
        if done is None or done.error is None:
            return
        if isinstance(done.error, self.FAILURE_DOMAIN):
            self.record_failure(step, state, done.error)
        elif not isinstance(done.error, SaveVetoed):
            raise done.error

    def _note_published(self, step: Optional[int]) -> None:
        """Record the step label of the newest checkpoint pointer beaten
        into the heartbeat — the guard that keeps the pointer monotonic
        (a late drain must not regress it to an older commit)."""
        if step is None:
            return
        if (self._published_ckpt_step is None
                or int(step) > self._published_ckpt_step):
            self._published_ckpt_step = int(step)

    # -- the supervised loop ----------------------------------------------

    def _next_batch(self, it) -> Any:
        return retry_transient(lambda: next(it), policy=self.config.retry,
                               what="data_fetch", sleep=self._sleep)

    def _checkpoint(self, step: int, state: Any, *,
                    what: str = "checkpoint_save") -> Optional[str]:
        """One retried save.  A manager constructed with its own
        ``retry`` policy already wraps ``save`` in ``retry_transient``
        (the documented recipe does exactly that) — defer to it rather
        than nesting two loops into ``max_attempts**2`` save attempts.

        ``persist_transform`` (when set) maps the live state to its
        persistable form first — the stacked-per-replica workflow passes
        :func:`~apex_tpu_torch.resilience.consistency.collapse_replicas` here
        so every periodic AND emergency checkpoint stores the
        mesh-shape-free logical copy an elastic restart can reshard,
        never the dp-world-size-dependent stacked form."""
        if self.persist_transform is not None:
            state = self.persist_transform(state)
        if self._async is not None and what == "checkpoint_save":
            # periodic save under async_save: block on the snapshot only
            # and hand the write to the background thread.  Returns None
            # — the heartbeat's resume pointer advances when the commit
            # is harvested at a later step boundary, never before the
            # step dir is durably in place.  (The emergency path stays
            # synchronous: durability before TrainingAborted.)
            self._async.save(int(step), state)
            return None
        if self.manager.retry is not None:
            return self.manager.save(int(step), state)
        return retry_transient(
            lambda: self.manager.save(int(step), state),
            policy=self.config.retry, what=what,
            sleep=self._sleep)

    def run(self, step_fn: Callable[[Any, Any, int], Any], state: Any,
            batches: Iterable, *, num_steps: int,
            start_step: int = 0) -> Tuple[Any, int]:
        """Drive ``step_fn`` for steps ``[start_step, num_steps)``.

        Returns ``(state, last_completed_step)`` — ``start_step - 1``
        when no step completed (e.g. the iterator was empty).  Raises
        :class:`TrainingAborted` on escalation; exceptions outside the
        supervisor's failure domain propagate unchanged.
        """
        it = iter(batches)
        step = int(start_step)
        last_completed = step - 1
        self._escalate_joined = False
        # STICKY across steps: once a consistency pass fails, the state
        # stays untrusted (no commit, no failure-counter reset) until a
        # later pass proves it clean — steps BETWEEN interval checks
        # neither re-earn trust nor bury the standing divergence
        state_trusted = True
        self.watchdog.start()
        try:
            while step < num_steps:
                # ONE span per step attempt, covering fetch -> step -> commit:
                # fetch-retry and skip events stamp it, and the train_step +
                # checkpoint_save spans nest inside — the trace of a slow
                # step IS its causal story (docs recipe)
                with obs_trace.span("supervisor_step", step=step):
                    # -- fetch (retried; guard skips ride inside the iterator)
                    try:
                        batch = self._next_batch(it)
                    except StopIteration:
                        break
                    except self.FAILURE_DOMAIN as e:
                        # state predates `step` (its fetch failed): any
                        # emergency checkpoint must carry the completed label
                        self.record_failure(step, state, e,
                                            completed_step=last_completed)
                        continue  # re-attempt the same step number

                    # -- the step itself, under the deadline
                    self.watchdog.arm(step)
                    t_step = time.perf_counter()
                    try:
                        with obs_trace.span("train_step", step=step):
                            new_state = step_fn(state, batch, step)
                    except BaseException:
                        self.watchdog.cancel()  # not a deadline event
                        raise
                    # the step COMPLETED (possibly late): record its latency
                    # unconditionally — the p99 answer must include stragglers
                    _STEP_SECONDS.observe(time.perf_counter() - t_step)
                    _STEPS_TOTAL.inc()
                    step_ok = True
                    try:
                        self.watchdog.disarm()
                    except StepDeadlineExceeded as e:
                        # late but finished: keep the result, count the miss
                        step_ok = False
                        self.record_failure(step, new_state, e)  # may abort
                    state = new_state
                    last_completed = step

                    # -- cross-replica consistency, BEFORE the checkpoint
                    # commit: a desynced state must never be persisted, and a
                    # resynced repair is what the periodic save should carry
                    if (self.consistency is not None
                            and self.config.consistency_check_interval
                            and (step + 1)
                            % self.config.consistency_check_interval == 0):
                        try:
                            state = self.consistency.check(state, step=step)
                            state_trusted = True  # proven clean (or repaired)
                        except ReplicaDesyncError as e:
                            # unrepaired divergence: one unrecovered failure
                            # (escalates to emergency-checkpoint + abort at
                            # the threshold, like every other failure kind);
                            # commits are SKIPPED until a later pass proves
                            # the state clean — it must not become
                            # latest_valid_step and survive the restart
                            step_ok = False
                            state_trusted = False
                            if self._async is not None:
                                # an in-flight background write is from the
                                # same untrusted lineage — veto its commit
                                # before it can publish a step dir
                                self._async.veto(
                                    f"consistency failure at step {step}")
                            self.record_failure(step, state, e)
                    # the consecutive-failure counter resets only while the
                    # state is trusted — otherwise a desync that re-proves
                    # itself every interval would be buried by the
                    # intervening successful steps and never escalate
                    if step_ok and state_trusted:
                        self.record_success()

                    # -- commit host-side progress
                    ckpt_path = None
                    ckpt_path_step = step
                    if self._async is not None:
                        # harvest the background write that (maybe)
                        # finished since the last boundary: a failure
                        # joins the ladder exactly one step boundary
                        # after it died
                        self._consume_async_result(self._async.poll(),
                                                   step, state)
                        # the resume pointer is the newest COMMITTED
                        # path — lossless even when a backpressure join
                        # (not poll) consumed a success's future; one
                        # atomic (step, path) read so the published
                        # bookkeeping can never run ahead of the path
                        lc = self._async.last_committed
                        if lc is not None:
                            ckpt_path_step, ckpt_path = lc
                    if self.manager is not None and state_trusted and (
                            (step + 1) % self.config.checkpoint_every == 0
                            or step + 1 >= num_steps):
                        try:
                            path = self._checkpoint(step, state)
                            if path is not None:  # None: async, in flight
                                ckpt_path = path
                        except RetryExhausted as e:
                            self.record_failure(step, state, e)  # may abort
                    self.watchdog.beat(step, ckpt_path=ckpt_path)
                    if ckpt_path is not None:
                        self._note_published(ckpt_path_step)
                    step += 1
            # drain the final in-flight write BEFORE returning: the last
            # periodic save must be durable — or its failure visible —
            # when the caller moves on (bounded: a wedged writer must
            # not wedge the return; it dies with the process, its temp
            # dir never committable)
            if self._async is not None:
                done = self._async.wait(
                    timeout=self.config.async_join_timeout_s)
                self._consume_async_result(done, last_completed, state)
                self._beat_if_newer(last_completed)
            return state, last_completed
        finally:
            if self._async is not None:
                # exception paths must not abandon a nearly committed
                # write; the newest commit still reaches the resume
                # pointer before the watchdog stops — but never by
                # REGRESSING it, and never by paying a SECOND bounded
                # join when escalate() already performed one on a
                # wedged writer
                if not self._escalate_joined:
                    self._async.wait(
                        timeout=self.config.async_join_timeout_s)
                self._beat_if_newer(max(last_completed, 0))
            self.watchdog.stop()
