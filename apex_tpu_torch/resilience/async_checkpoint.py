"""Asynchronous checkpoint pipeline: snapshot on the hot path, write off it.

The port of ``apex_tpu.resilience.async_checkpoint``, copied whole over
the port's v1 :class:`~apex_tpu_torch.resilience.checkpoint.
CheckpointManager` (the sharded v2 manager comes with the multi-card
slice).  The snapshot is what makes the background write safe under
PyTorch, whose optimizers update parameters in place: it copies every
leaf into host memory the training loop never touches again.

A periodic save of a 1.3B-param train state (bf16 params + moments,
~10 GB serialized with per-leaf CRC32 and fsync) stalls a synchronous
step loop for the full device→host + serialize + write wall time — at
pod scale checkpoint stalls are a first-order throughput term once
steps are fast (PAPERS.md: "Exploring the limits of Concurrency in ML
Training on Google TPUs").  This module splits the save in two:

1. **Snapshot** (:func:`~apex_tpu_torch.resilience.checkpoint.snapshot_tree`,
   via the manager's ``snapshot``): a device→host copy of every leaf into
   owned host buffers.  This is the only phase the step loop ever
   blocks on — donation-safe by construction, so the very next step may
   overwrite the live state while the writer is still serializing.
2. **Write** (a daemon writer thread running the manager's
   ``write_snapshot``): the EXISTING serialize/CRC/manifest/
   atomic-rename/rotation machinery of
   :class:`~apex_tpu_torch.resilience.checkpoint.CheckpointManager` —
   producing bytes **identical** to a synchronous save (the
   two paths share one writer function; a test compares the files).

Correctness invariants, each pinned by a test:

- **At most one write in flight** per :class:`AsyncCheckpointer`.
  Backpressure blocks the *next* ``save()`` (which joins the previous
  write first, counting ``apex_checkpoint_backpressure_total``), never
  the step loop itself.
- **Crash-safe mid-write**: the writer streams into a ``tmp_*`` dir
  (fsynced incrementally) that ``latest_valid_step`` / the restore walk
  can never select; only the final atomic rename publishes the step.
- **Failures surface**: a failed background write is stored on its
  :class:`SaveFuture` and re-raised/harvested at the caller's next poll
  or join — the supervisor feeds it into the same retry/escalation
  ladder as a synchronous save failure.
- **Vetoable commit**: :meth:`AsyncCheckpointer.veto` aborts an
  in-flight write at its commit gate, *before* the atomic rename (the
  temp dir is cleaned up; the future completes with
  :class:`SaveVetoed`) — the hook a failed cross-replica consistency
  pass uses against the write already in the air.  The veto is honored
  up to the gate; a write already past it lands — exactly the
  synchronous-mode outcome for the previous boundary's save — and the
  caller's trust machinery blocks all NEW commits either way.
- **Joins on emergency/shutdown**: ``wait()`` drains the in-flight
  write so an emergency checkpoint never races the background writer
  for the single-writer root, and process exit never abandons a nearly
  committed checkpoint.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.obs import trace as obs_trace
from apex_tpu_torch.resilience.checkpoint import _CKPT_SECONDS, CheckpointError

__all__ = ["AsyncCheckpointer", "SaveFuture", "SaveVetoed"]

logger = get_logger("resilience.async_checkpoint")

_INFLIGHT = obs_metrics.gauge(
    "apex_checkpoint_inflight",
    "background checkpoint writes currently in flight (at most one per "
    "AsyncCheckpointer; counted inc/dec so concurrent pipelines sum)")
_BACKPRESSURE = obs_metrics.counter(
    "apex_checkpoint_backpressure_total",
    "async saves that had to join a still-running previous write before "
    "starting (the NEXT save blocks, never the step)")


class SaveVetoed(CheckpointError):
    """An in-flight background write was vetoed before its atomic
    rename (consistency failure, deliberate abort): no step directory
    was produced, the temp dir was cleaned up.  Deterministic — never
    retried (inherits ``transient = False``)."""


class SaveFuture:
    """Completion handle for one background write.

    ``done()`` / ``join()`` / ``result()`` are the consumption surface;
    ``path`` and ``error`` are set exactly once, before the internal
    event fires.  ``snapshot_s`` (the step-loop blocking cost) is
    stamped by the checkpointer; ``write_s`` by the writer thread.
    """

    def __init__(self, step: int):
        self.step = int(step)
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.snapshot_s: Optional[float] = None
        self.write_s: Optional[float] = None
        self._done = threading.Event()
        self._veto = threading.Event()
        self._veto_reason = ""

    def done(self) -> bool:
        return self._done.is_set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the write to finish (success, failure, or veto);
        returns whether it did.  Never raises — read ``error``/``path``,
        or call :meth:`result` to raise."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> str:
        """The committed checkpoint path; raises the writer's error (or
        :class:`TimeoutError` if still in flight after ``timeout``)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"background write of step {self.step} still in flight")
        if self.error is not None:
            raise self.error
        return self.path

    # -- writer side -------------------------------------------------------

    def _commit_gate(self) -> None:
        """Runs inside the write machinery, immediately before the
        atomic rename — the last point a veto can stop publication."""
        if self._veto.is_set():
            raise SaveVetoed(
                f"step {self.step} commit vetoed: {self._veto_reason}")

    def _finish(self, *, path: Optional[str] = None,
                error: Optional[BaseException] = None) -> None:
        self.path = path
        self.error = error
        self._done.set()


class AsyncCheckpointer:
    """Drive a checkpoint manager's two-phase save surface from a
    background writer thread, one save in flight at a time.

    ``manager`` is any object with the ``snapshot(tree, specs=None)`` /
    ``write_snapshot(step, snap, commit_gate=, progress_hook=)`` pair —
    the v1 :class:`CheckpointManager` qualifies, and gets async saves (and
    its ``retry`` policy) for free.
    ``retry`` is the fallback transient-I/O policy applied only when the
    manager carries none (the supervisor passes its ``config.retry``
    here — same no-nesting rule as the synchronous save path, so a
    transient blip surfaces as :class:`RetryExhausted` in both modes).
    ``progress_hook`` is forwarded to every write (fault injection /
    tests).

    >>> ac = AsyncCheckpointer(CheckpointManager("/ckpts/run7", keep=3))
    >>> fut = ac.save(step, state)        # blocks ~snapshot time only
    >>> ...                               # training continues
    >>> fut.join(); assert fut.error is None
    """

    def __init__(self, manager: Any, *,
                 retry: Any = None,
                 progress_hook: Optional[Callable[[dict], None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if not hasattr(manager, "snapshot") or not hasattr(
                manager, "write_snapshot"):
            raise TypeError(
                f"{type(manager).__name__} has no snapshot/write_snapshot "
                f"surface — pass a CheckpointManager")
        self.manager = manager
        self.retry = retry
        self.progress_hook = progress_hook
        self._sleep = sleep  # injectable: virtualized-clock runs must not
        # spin real backoff waits inside the writer thread
        self._lock = threading.Lock()
        self._future: Optional[SaveFuture] = None
        self._thread: Optional[threading.Thread] = None
        # newest commit, written by the writer thread WITHOUT the lock
        # (a plain GIL-atomic assignment: the writer must never contend
        # with a save() that is holding the lock while joining it) —
        # the lossless record a backpressure join cannot drop, so the
        # heartbeat's resume pointer advances even when write duration
        # persistently exceeds the checkpoint interval
        self._last_committed: Optional[tuple] = None  # (step, path)

    # -- state -------------------------------------------------------------

    @property
    def inflight(self) -> Optional[SaveFuture]:
        """The current future, completed or not (None before any save or
        after the last one was harvested)."""
        return self._future

    @property
    def last_committed(self) -> Optional[tuple]:
        """``(step, path)`` of the newest committed checkpoint this
        pipeline wrote (None before the first commit) — ONE atomic read,
        so callers never see a torn step/path pair from a commit landing
        mid-read.  Lossless under backpressure: a success whose future
        was consumed by the next ``save()``'s join still shows up here."""
        return self._last_committed

    @property
    def last_committed_path(self) -> Optional[str]:
        lc = self._last_committed
        return lc[1] if lc is not None else None

    @property
    def committed_step(self) -> Optional[int]:
        """Step of the newest committed checkpoint, or None — the
        single-field read a serving-side
        :class:`~apex_tpu_torch.serving.reload.WeightWatcher` polls every
        scheduler step (same torn-pair-free atomic read as
        ``last_committed``)."""
        lc = self._last_committed
        return lc[0] if lc is not None else None

    def poll(self) -> Optional[SaveFuture]:
        """Non-blocking harvest: return and CLEAR the tracked future if
        its write has completed (else None).  The step-boundary call —
        a failed write surfaces here, one step after it died."""
        with self._lock:
            fut = self._future
            if fut is None or not fut.done():
                return None
            self._future = None
            self._join_thread()
            return fut

    def wait(self, timeout: Optional[float] = None) -> Optional[SaveFuture]:
        """Join the in-flight write (emergency-checkpoint / shutdown
        path) and harvest its future; None when nothing was in flight.
        Never raises on write failure — inspect ``error``."""
        with self._lock:
            fut = self._future
            if fut is None:
                return None
            if not fut.join(timeout):
                return None  # still running; future stays tracked
            self._future = None
            self._join_thread()
            return fut

    def veto(self, reason: str) -> bool:
        """Request that the in-flight write (if any) not commit.  Best
        effort by nature: the writer honors the veto at its commit gate,
        immediately before the atomic rename — a write already past the
        gate lands anyway, which is exactly the synchronous-mode outcome
        for a save scheduled at the previous boundary (the caller's
        trust machinery blocks NEW commits; a durably published
        checkpoint cannot be unpublished).  Returns True when the
        request was delivered to a write still in flight, False when
        nothing was in flight or it had already finished; certainty
        about the outcome requires joining the future."""
        with self._lock:
            fut = self._future
        if fut is None or fut.done():
            return False
        fut._veto_reason = str(reason)
        fut._veto.set()
        emit_event("checkpoint_commit_vetoed", step=fut.step,
                   reason=str(reason)[:500])
        # did the veto land before the gate?  join-free check: the writer
        # will observe the event at its gate; callers that need certainty
        # join the future.  Report optimistically only if not yet done.
        return True

    # -- the pipeline ------------------------------------------------------

    def save(self, step: int, tree: Any, *, specs: Any = None) -> SaveFuture:
        """Snapshot ``tree`` (blocking, fast) and hand the write to the
        background thread; returns the new :class:`SaveFuture`.

        Backpressure: at most one write in flight — a still-running
        previous write is JOINED first (counted in
        ``apex_checkpoint_backpressure_total``).  A previous write that
        *failed* and was never harvested surfaces here: its error is
        raised before any new snapshot is taken, exactly where a
        synchronous ``manager.save`` would have raised (a vetoed write
        is not a failure and is silently cleared; a successful one
        stays visible through ``last_committed_path``).
        """
        with self._lock:
            prev = self._future
            if prev is not None:
                if not prev.done():
                    _BACKPRESSURE.inc()
                    emit_event("checkpoint_backpressure", step=int(step),
                               blocked_on_step=prev.step)
                    prev.join()
                self._future = None
                self._join_thread()
                if prev.error is not None and not isinstance(
                        prev.error, SaveVetoed):
                    raise prev.error
            t0 = time.perf_counter()
            snapshot = self.manager.snapshot(tree, specs=specs)
            fut = SaveFuture(step)
            fut.snapshot_s = time.perf_counter() - t0
            self._future = fut
            # inc/dec (not absolute set): two pipelines over different
            # roots must sum, not clobber each other's reading
            _INFLIGHT.inc()
            self._thread = threading.Thread(
                target=self._write, args=(fut, snapshot),
                name=f"apex-ckpt-writer-{int(step)}", daemon=True)
            try:
                self._thread.start()
            except BaseException:
                _INFLIGHT.dec()
                self._future = None
                self._thread = None
                raise
            return fut

    def _write(self, fut: SaveFuture, snapshot: Any) -> None:
        t0 = time.perf_counter()

        def write_fn():
            return self.manager.write_snapshot(
                fut.step, snapshot,
                commit_gate=fut._commit_gate,
                progress_hook=self.progress_hook)

        try:
            with obs_trace.span("checkpoint_write", step=fut.step):
                if (self.retry is not None
                        and getattr(self.manager, "retry", None) is None):
                    from apex_tpu_torch.resilience.retry import retry_transient

                    path = retry_transient(write_fn, policy=self.retry,
                                           what="checkpoint_write",
                                           sleep=self._sleep)
                else:
                    path = write_fn()
        except BaseException as e:
            fut.write_s = time.perf_counter() - t0
            if isinstance(e, SaveVetoed):
                logger.info("background write of step %d vetoed: %s",
                            fut.step, e)
            else:
                logger.warning(
                    "background checkpoint write of step %d failed: "
                    "%s: %s", fut.step, type(e).__name__, e)
            fut._finish(error=e)
        else:
            fut.write_s = time.perf_counter() - t0
            _CKPT_SECONDS.observe(fut.write_s, op="write")
            self._last_committed = (fut.step, path)  # before done fires
            fut._finish(path=path)
        finally:
            _INFLIGHT.dec()

    def _join_thread(self) -> None:
        # the future is already done; the thread has at most its final
        # bookkeeping left — reap it so harvested saves leave no zombie
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)
