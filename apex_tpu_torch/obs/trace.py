"""Nestable spans on the monotonic clock, exported as Chrome trace JSON.

The metrics registry answers "how often / how long on average"; spans
answer "what was this *particular* slow step doing".  Design:

- :func:`span` is a context manager.  With **no recorder installed it
  is a near-no-op** — one module-global read, no contextvar traffic, no
  allocation (the hot-path contract ``bench.py``'s ``obs`` block
  measures).  With a recorder, each span records a Chrome trace-event
  ``"X"`` (complete) event: ``ts``/``dur`` in monotonic microseconds
  from :func:`time.perf_counter` (never the wall clock — spans must
  not stretch under NTP steps), ``pid``/``tid``, and ``args`` carrying
  the span's attributes, id, and parent id.
- **Parent linkage via contextvars**: entering a span makes it the
  current span for the enclosing context; nested spans record their
  parent's id.  Each thread gets its own context, so the watchdog
  monitor thread can open spans without corrupting the main thread's
  stack; an executor that copies contexts propagates parentage across
  submission boundaries for free.
- **Stamping**: :func:`current_span` exposes the innermost live span so
  cross-cutting layers (the ``emit_event`` bridge) can attach events to
  whatever operation is in flight — zero call-site churn.
- **Export**: :meth:`TraceRecorder.to_chrome_trace` returns the
  ``{"traceEvents": [...]}`` object that ``chrome://tracing`` and
  `Perfetto <https://ui.perfetto.dev>`_ load directly;
  :meth:`TraceRecorder.export` atomically writes it to disk.

For stalls that need *device-side* truth, :func:`start_torch_profiler` /
:func:`stop_torch_profiler` wrap ``torch.profiler`` start/stop (opt-in,
failure-tolerant; the stop writes a Chrome trace), and
:func:`profile_on_stall` adapts them to a stall watchdog's ``on_stall``
hook (the JAX package's ``StepWatchdog``; the port's supervisor waits
for the resilience slice) so the first stall of a run captures a device
profile on demand.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Iterator, List, Optional

from apex_tpu_torch._logging import get_logger

__all__ = [
    "Span",
    "TraceRecorder",
    "current_span",
    "install_recorder",
    "profile_on_stall",
    "recording",
    "span",
    "start_torch_profiler",
    "stop_torch_profiler",
    "uninstall_recorder",
]

logger = get_logger("obs.trace")

_RECORDER: Optional["TraceRecorder"] = None
_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "apex_obs_current_span", default=None)
_SPAN_IDS = itertools.count(1)


def _now_us() -> float:
    return time.perf_counter() * 1e6


class Span:
    """One live span: name, attributes, events, parent linkage.

    Mutable only while live; the exporter snapshot is taken at exit.
    """

    __slots__ = ("name", "span_id", "parent_id", "attrs", "events")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.events: List[dict] = []

    def set_attribute(self, key: str, value) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs) -> None:
        """Stamp a point-in-time event onto this span (the bridge calls
        this for every ``emit_event`` fired while the span is live)."""
        ev = {"name": name, "ts_us": round(_now_us(), 3)}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)


class TraceRecorder:
    """Thread-safe collector of finished span events.

    ``max_events`` bounds memory: a recorder left installed for a whole
    multi-day run (the docs recipe does exactly that) must not grow RSS
    without limit.  At the cap, NEW events are dropped and counted in
    :attr:`dropped` (the trace keeps the run's beginning — the part
    that explains how it got into trouble); the first drop logs a
    warning so the truncation is never silent.
    """

    def __init__(self, max_events: int = 500_000):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []

    def record(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                first_drop = self.dropped == 1
            else:
                self._events.append(event)
                first_drop = False
        if first_drop:
            logger.warning(
                "TraceRecorder full (%d events): dropping further spans "
                "(count rides the exported trace's otherData)",
                self.max_events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        events.sort(key=lambda e: e["ts"])
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            payload["otherData"] = {"dropped_events": dropped,
                                    "max_events": self.max_events}
        return payload

    def export(self, path: str) -> dict:
        """Atomically write the trace JSON; returns the payload.
        Non-finite span attributes (a NaN loss stamped on a diverged
        step) are mapped to ``null`` — Perfetto's strict JSON parser
        must always load the file, never less so than when something
        went wrong."""
        from apex_tpu_torch.utils.serialization import (
            atomic_write_json,
            json_finite,
        )

        payload = json_finite(self.to_chrome_trace())
        # default=str: span attrs are arbitrary user kwargs (a tensor
        # stamped on a span must degrade to its repr, not kill the export
        # — the same contract emit_event's log line has always had)
        atomic_write_json(path, payload, allow_nan=False, default=str)
        return payload


def install_recorder(recorder: Optional[TraceRecorder] = None
                     ) -> TraceRecorder:
    """Install (and return) the process-wide recorder; spans are
    recorded only while one is installed."""
    global _RECORDER
    if recorder is None:
        recorder = TraceRecorder()
    _RECORDER = recorder
    return recorder


def uninstall_recorder() -> Optional[TraceRecorder]:
    """Remove and return the installed recorder (None if none)."""
    global _RECORDER
    recorder, _RECORDER = _RECORDER, None
    return recorder


@contextlib.contextmanager
def recording() -> Iterator[TraceRecorder]:
    """``with recording() as rec:`` — record spans for the block only,
    restoring whatever recorder was installed before."""
    global _RECORDER
    prev = _RECORDER
    rec = TraceRecorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = prev


def current_span() -> Optional[Span]:
    """The innermost live span of this context (None outside any span,
    and always None while no recorder is installed)."""
    return _CURRENT.get()


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[Span]]:
    """``with span("train_step", step=i) as s:`` — time a region.

    Yields the live :class:`Span` (mutate attributes, add events), or
    ``None`` when no recorder is installed — the no-recorder path does
    no contextvar writes and no allocation, so leaving instrumentation
    in hot loops is free by default.
    """
    recorder = _RECORDER
    if recorder is None:
        yield None
        return
    parent = _CURRENT.get()
    live = Span(name, next(_SPAN_IDS),
                parent.span_id if parent is not None else None, dict(attrs))
    token = _CURRENT.set(live)
    t0 = time.perf_counter()
    try:
        yield live
    finally:
        dur_us = (time.perf_counter() - t0) * 1e6
        _CURRENT.reset(token)
        args = dict(live.attrs)
        args["span_id"] = live.span_id
        if live.parent_id is not None:
            args["parent_id"] = live.parent_id
        if live.events:
            args["events"] = live.events
        recorder.record({
            "name": name, "ph": "X", "cat": "apex",
            "ts": round(t0 * 1e6, 3), "dur": round(dur_us, 3),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args,
        })


# ---------------------------------------------------------------------------
# opt-in torch.profiler hook: device-side truth for a stalled step
# ---------------------------------------------------------------------------

_PROFILER_LOCK = threading.Lock()
_PROFILER = None          # the running torch.profiler.profile, or None
_PROFILER_LOGDIR = None


def start_torch_profiler(logdir: str) -> bool:
    """Start a ``torch.profiler`` trace (CPU and, on a CUDA build with a
    card, CUDA activity) that :func:`stop_torch_profiler` writes into
    ``logdir`` as Chrome trace JSON (idempotent; False when already
    running or when the profiler is unavailable).  Opt-in by design:
    nothing in apex_tpu_torch starts it for you except the hook you
    explicitly wire via :func:`profile_on_stall`."""
    global _PROFILER, _PROFILER_LOGDIR
    with _PROFILER_LOCK:
        if _PROFILER is not None:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(logdir, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # diagnostics must never kill the run
            logger.warning("torch profiler start failed: %s: %s",
                           type(e).__name__, e)
            return False
        _PROFILER, _PROFILER_LOGDIR = prof, logdir
        logger.info("torch profiler tracing into %s", logdir)
        return True


def stop_torch_profiler() -> bool:
    """Stop a running ``torch.profiler`` trace and write it into its
    ``logdir`` as ``trace_<pid>_<ns>.json`` (False when none active)."""
    global _PROFILER, _PROFILER_LOGDIR
    with _PROFILER_LOCK:
        if _PROFILER is None:
            return False
        try:
            _PROFILER.stop()
            _PROFILER.export_chrome_trace(os.path.join(
                _PROFILER_LOGDIR,
                f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))
        except Exception as e:
            # the profiler stays set: a failed stop must remain
            # stoppable — clearing it here would wedge the trace running
            # until process exit with every later call refusing at the
            # guard
            logger.warning("torch profiler stop failed: %s: %s",
                           type(e).__name__, e)
            return False
        _PROFILER, _PROFILER_LOGDIR = None, None
        return True


def profile_on_stall(logdir: str):
    """Adapter for a stall watchdog's ``on_stall`` hook: the FIRST stall
    of a run starts a device profile on demand (stop it with
    :func:`stop_torch_profiler` once the evidence is captured)::

        wd = StepWatchdog(deadline_s=60.0,
                          on_stall=profile_on_stall("/tmp/stall_profile"))
    """
    def _hook(diagnostics: dict) -> None:
        if start_torch_profiler(logdir):
            logger.warning(
                "stall at step %s: torch profiler started into %s",
                diagnostics.get("step"), logdir)
    return _hook
