"""Classified-exception retry with exponential backoff + deterministic jitter.

The port of ``apex_tpu.resilience.retry``, copied whole: the same
classification, the same ``retry_*`` events, and for the same ``what``
and attempt the same delay as the JAX policy.

Host-side I/O at pod scale — checkpoint writes to network filesystems,
data fetches through a flaky storage frontend — fails *transiently* far
more often than it fails *permanently*.  This module is
the one retry policy for all of them, with three properties the ad-hoc
``try/sleep/except`` it replaces never had:

- **Classified**: only exceptions the policy names (by type, or by a
  status-code-anchored message marker) are retried.  Deterministic
  failures — a ``CheckpointError`` from corrupt bytes, a shape bug —
  propagate on the first attempt; retrying them only burns the deadline
  re-proving them.
- **Deterministic jitter**: backoff delay is ``base * backoff**attempt``
  plus a jitter fraction derived from ``(seed, what, attempt)`` via
  CRC32 — the same call site produces the same delay schedule on every
  run, so tests of the retry path are reproducible while a fleet
  of real hosts (different ``seed`` per process) still de-synchronizes
  its retry storms.
- **Observable**: every attempt, recovery, and exhaustion emits a
  structured event through :func:`apex_tpu_torch._logging.emit_event` — a
  silent retry loop hides exactly the infrastructure rot an operator
  needs to see trending.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Tuple, Type, TypeVar

from apex_tpu_torch._logging import emit_event

__all__ = [
    "RetryExhausted",
    "RetryPolicy",
    "TransientError",
    "is_transient",
    "retry_transient",
]

T = TypeVar("T")


class TransientError(RuntimeError):
    """Raise-to-retry marker: wrap an error the *caller* knows is
    transient (e.g. a storage frontend's custom exception type) so the
    default policy retries it without widening its type list."""


class RetryExhausted(RuntimeError):
    """The transient failure persisted through every allowed attempt.

    Carries ``what`` (the operation label), ``attempts``, and ``last``
    (the final underlying exception, also chained via ``__cause__``).
    """

    # never re-retried by an outer retry_transient, even though its
    # message embeds the (possibly marker-matching) underlying error text
    transient = False

    def __init__(self, what: str, attempts: int, last: BaseException):
        super().__init__(
            f"{what}: transient failure persisted through {attempts} "
            f"attempts (last: {type(last).__name__}: {last})")
        self.what = what
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """What to retry, how often, and how long to wait between attempts.

    ``transient_types`` classifies by exception type (``OSError`` covers
    the host-I/O family: ``ConnectionError``, ``TimeoutError``, disk
    errors).  ``transient_markers`` classifies by status-code-anchored
    message substring for runtime errors that arrive as generic types
    (remote-runtime tunnel errors).  Everything else is deterministic
    and propagates immediately.

    The delay for attempt ``n`` (1-based) is
    ``min(base_delay_s * backoff**(n-1), max_delay_s)`` stretched by a
    jitter fraction in ``[0, jitter)`` derived deterministically from
    ``(seed, what, n)`` — reproducible per call site, decorrelated
    across differently-seeded processes.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    backoff: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    transient_types: Tuple[Type[BaseException], ...] = (
        OSError, TransientError)
    transient_markers: Tuple[str, ...] = (
        "UNAVAILABLE:", "DEADLINE_EXCEEDED", "remote_compile",
        "Socket closed", "Connection reset", "Stream removed")

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0.0 or self.max_delay_s < 0.0:
            raise ValueError("delays must be non-negative")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1.0, got {self.backoff}")
        if self.jitter < 0.0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")

    def delay_s(self, what: str, attempt: int) -> float:
        """Deterministic backoff+jitter delay before retry ``attempt``."""
        base = min(self.base_delay_s * self.backoff ** (attempt - 1),
                   self.max_delay_s)
        digest = zlib.crc32(f"{self.seed}:{what}:{attempt}".encode())
        frac = (digest % 10_000) / 10_000.0  # [0, 1), stable across runs
        return min(base * (1.0 + self.jitter * frac), self.max_delay_s)


def is_transient(exc: BaseException, policy: RetryPolicy) -> bool:
    """Does ``policy`` classify ``exc`` as worth retrying?

    An exception type can opt out unconditionally with a class attribute
    ``transient = False`` — the hook for *deterministic* errors that
    happen to subclass a transient family (``DataStallError`` is a
    ``TimeoutError``/``OSError``, but re-fetching throws away a batch
    per attempt) or to embed marker text (``RetryExhausted`` quotes the
    underlying error).
    """
    if getattr(exc, "transient", None) is False:
        return False
    if isinstance(exc, policy.transient_types):
        return True
    msg = str(exc)
    return any(m in msg for m in policy.transient_markers)


def retry_transient(fn: Callable[[], T], *,
                    policy: RetryPolicy = RetryPolicy(),
                    what: str = "operation",
                    sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn()`` with classified retries; return its result.

    Non-transient exceptions (per :func:`is_transient`) propagate from
    the first attempt untouched — including ``StopIteration``, so this
    wraps ``next(iterator)`` safely.  Transient ones are retried up to
    ``policy.max_attempts`` total attempts with deterministic
    backoff+jitter, one ``retry_attempt`` event per failure; exhaustion
    raises :class:`RetryExhausted` from the last error after a
    ``retry_exhausted`` event.  A success on attempt > 1 emits
    ``retry_recovered`` with the total attempt count and (monotonic)
    duration.  ``sleep`` is injectable so tests never really wait.
    """
    t0 = time.monotonic()
    for attempt in range(1, policy.max_attempts + 1):
        try:
            result = fn()
        except Exception as e:
            if not is_transient(e, policy):
                raise
            err = f"{type(e).__name__}: {e}"
            if attempt >= policy.max_attempts:
                emit_event("retry_exhausted", what=what, attempts=attempt,
                           error=err[:500], t0=t0)
                raise RetryExhausted(what, attempt, e) from e
            delay = policy.delay_s(what, attempt)
            emit_event("retry_attempt", what=what, attempt=attempt,
                       max_attempts=policy.max_attempts,
                       delay_s=round(delay, 6), error=err[:500])
            sleep(delay)
            continue
        if attempt > 1:
            emit_event("retry_recovered", what=what, attempts=attempt, t0=t0)
        return result
    raise AssertionError("unreachable")  # pragma: no cover
