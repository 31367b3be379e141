"""Rank-aware logging and structured events for apex_tpu_torch.

The port of ``apex_tpu._logging``: the same :func:`emit_event`, sink
registry, :func:`get_logger`, :func:`set_logging_level` and
:class:`RankInfoFilter`, on the ``apex_tpu_torch`` and
``apex_tpu_torch.events`` loggers.  Rank info is ``p{rank}`` from
``torch.distributed`` when its process group is initialized, else
``p0``; the JAX package appends its mesh registry's rank info, which
waits here for the port of ``transformer/parallel_state``.  The default
sink's JSON payload for a given event dict is byte-equal to the JAX
package's.
"""

from __future__ import annotations

import json
import logging
import threading
import time


class RankInfoFilter(logging.Filter):
    """Injects a ``rank_info`` field into log records.

    Cheap by design: reads the rank lazily and tolerates
    ``torch.distributed`` not being initialized or available (import-time
    logging must never crash).
    """

    def filter(self, record: logging.LogRecord) -> bool:
        record.rank_info = _rank_info()
        return True


_RANK_INFO_WARNED: set = set()
# the keys are a small closed vocabulary today, but callers pass
# arbitrary strings (sink ids ride through here too) — cap the set so a
# pathological key stream can never grow it without bound
_MAX_WARNED_KEYS = 64


def _debug_once(key: str, what: str, exc: Exception) -> None:
    """Log a swallowed rank-info failure ONCE at debug level.

    The flag is set *before* logging: the debug record flows through the
    rank-aware handler, whose filter re-enters :func:`_rank_info` — the
    guard is what keeps that recursion one level deep.
    """
    if key in _RANK_INFO_WARNED or len(_RANK_INFO_WARNED) >= _MAX_WARNED_KEYS:
        return
    _RANK_INFO_WARNED.add(key)
    logging.getLogger("apex_tpu_torch._logging").debug(
        "%s unavailable (further failures silent): %s: %s",
        what, type(exc).__name__, exc)


def _rank_info() -> str:
    try:
        import torch.distributed as dist

        rank = (dist.get_rank() if dist.is_available()
                and dist.is_initialized() else 0)
    except Exception as e:
        _debug_once("process_index", "torch.distributed rank", e)
        return "p?"
    return f"p{rank}"


_HANDLER: logging.Handler | None = None


def _install_rank_aware_logging() -> None:
    """Install one rank-aware handler on the ``apex_tpu_torch`` logger (idempotent)."""
    global _HANDLER
    if _HANDLER is not None:
        return
    logger = logging.getLogger("apex_tpu_torch")
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s [%(levelname)s|%(rank_info)s] %(name)s: %(message)s")
    )
    handler.addFilter(RankInfoFilter())
    logger.addHandler(handler)
    logger.propagate = False
    _HANDLER = handler


def set_logging_level(level: int | str) -> None:
    """Set the apex_tpu_torch logging level (reference: apex/transformer/log_util.py)."""
    logging.getLogger("apex_tpu_torch").setLevel(level)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"apex_tpu_torch.{name}")


def _log_sink(event: dict) -> None:
    """The default sink: one sorted-key JSON line on
    ``apex_tpu_torch.events`` (the exact pre-sink-registry behavior, byte
    for byte)."""
    logging.getLogger("apex_tpu_torch.events").info(
        "%s", json.dumps(event, sort_keys=True, default=str))


# ordered fan-out list; the log sink is first so the canonical line is
# written even when a later sink misbehaves.  The lock makes add/remove
# idempotence hold under concurrent registration — a sink subscribed
# twice would silently double-count every event-driven metric
_EVENT_SINKS: list = [_log_sink]
_SINKS_LOCK = threading.Lock()


def add_event_sink(sink) -> None:
    """Subscribe ``sink(event_dict)`` to every :func:`emit_event`
    (idempotent, thread-safe).  Sinks must be cheap and must not raise;
    a raising sink is debug-logged once and never breaks the emitting
    code path (the event bridge in :mod:`apex_tpu_torch.obs.bridge` is the
    canonical subscriber)."""
    with _SINKS_LOCK:
        if sink not in _EVENT_SINKS:
            _EVENT_SINKS.append(sink)


def remove_event_sink(sink) -> None:
    """Unsubscribe a sink (no-op when absent).  Removing
    :func:`_log_sink` itself silences the JSON log lines — tests that
    want a quiet stream may do that, production code should not."""
    with _SINKS_LOCK:
        try:
            _EVENT_SINKS.remove(sink)
        except ValueError:
            pass


def event_sinks() -> tuple:
    """The current fan-out list (a copy; mutate via add/remove)."""
    return tuple(_EVENT_SINKS)


def emit_event(kind: str, *, t0: float | None = None, **fields) -> dict:
    """Emit a structured (JSON) operational event and return it.

    The resilience subsystem reports state transitions — checkpoint
    saved/rejected/restored, step skipped, loss-scale floor halved —
    as machine-parseable single-line events rather than prose, so a
    fleet-level collector can alert on them (the reason silent recovery
    loops are banned; see the JAX package's ``apex_tpu.resilience``).
    Events ride the ordinary ``apex_tpu_torch.events`` logger and
    therefore inherit the rank-aware handler installed at import.

    The finished event fans out to every registered sink
    (:func:`add_event_sink`); the default sink is the logger line above
    — its output is byte-identical whether or not other sinks exist —
    and :mod:`apex_tpu_torch.obs.bridge` subscribes a sink that turns every
    event into a metric increment and a span stamp.

    Timing events pass ``t0`` — a ``time.monotonic()`` stamp taken when
    the operation started — and get a ``duration_s`` field computed on
    the monotonic clock.  ``time.time()`` (the ``time`` field) is for
    cross-host correlation only: the wall clock steps under NTP and is
    exactly what a stall watchdog must NOT measure with.
    """
    event = {"event": kind, "time": time.time(), **fields}
    if t0 is not None:
        event["duration_s"] = round(time.monotonic() - t0, 6)
    for sink in tuple(_EVENT_SINKS):
        try:
            sink(event)
        except Exception as e:  # a broken sink must not break the emitter
            # keyed by qualname, NOT id(): the debug-once set is capped,
            # and id() churn (or reuse after GC) could both exhaust the
            # cap and collide distinct sinks
            name = getattr(sink, "__qualname__", type(sink).__name__)
            _debug_once(f"event_sink:{name}", f"event sink {name!r}", e)
    return event
