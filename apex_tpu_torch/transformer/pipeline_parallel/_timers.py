"""Named wall timers with an optional device sync (counterpart of
``apex_tpu/transformer/pipeline_parallel/_timers.py``, apex's
``pipeline_parallel._timers``).

A timer accumulates wall seconds over ``start`` / ``stop`` pairs or a
``timing()`` block.  CUDA launches return before the work is done, so a
stop without a sync times the issue; ``barrier=True`` synchronizes the
timer's device first: ``torch.cuda.synchronize(device)`` for a CUDA
device, nothing for the CPU, whose work is done when the call returns.
The device is the registry's (:class:`Timers`), CUDA by default and the
CPU only when the caller passes ``device="cpu"``.  The JAX timers wait
on ``jax.effects_barrier`` there.

:meth:`Timers.publish_metrics` writes each timer's total into the
observability bridge's ``apex_timer_seconds{region=...}`` gauge.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, List

import torch

logger = logging.getLogger(__name__)

__all__ = ["Timers"]


class _Timer:
    """Accumulating wall timer for one named region."""

    __slots__ = ("name", "total", "running", "_t0", "_device")

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.total = 0.0          # accumulated seconds across start/stop pairs
        self.running = False
        self._t0 = 0.0
        self._device = device

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def start(self, barrier: bool = False) -> None:
        if self.running:
            raise RuntimeError(f"timer {self.name!r} is already running")
        if barrier:
            self._sync()
        # _t0 before running: a concurrent snapshot() that observes
        # running=True must never pair it with the PREVIOUS region's t0
        self._t0 = time.perf_counter()
        self.running = True

    def stop(self, barrier: bool = False) -> None:
        if not self.running:
            raise RuntimeError(f"timer {self.name!r} was never started")
        if barrier:
            self._sync()
        # running=False before total+=: a concurrent snapshot() that
        # already read total must not ALSO add the in-flight span
        elapsed = time.perf_counter() - self._t0
        self.running = False
        self.total += elapsed

    @contextlib.contextmanager
    def timing(self, barrier: bool = False) -> Iterator["_Timer"]:
        """``with timers('fwd').timing(): ...`` — the idiomatic bracket."""
        self.start(barrier=barrier)
        try:
            yield self
        finally:
            self.stop(barrier=barrier)

    def reset(self) -> None:
        self.total = 0.0
        self.running = False

    def elapsed(self, reset: bool = True) -> float:
        """Accumulated seconds; pauses/resumes a running timer around the read."""
        was_running = self.running
        if was_running:
            self.stop()
        seconds = self.total
        if reset:
            self.reset()
        if was_running:
            self.start()
        return seconds


class Timers:
    """Registry of named timers; calling it creates on first use.  Every
    timer's barrier syncs ``device`` (CUDA by default)."""

    def __init__(self, device="cuda"):
        from apex_tpu_torch.ops._dispatch import resolve_device

        self.device = resolve_device(device)
        self._timers: Dict[str, _Timer] = {}

    @property
    def timers(self) -> Dict[str, "_Timer"]:
        """Read-only view of the registry (reference surface: ported
        Megatron/apex scripts poke ``timers.timers`` directly)."""
        return self._timers

    def __call__(self, name: str) -> _Timer:
        try:
            return self._timers[name]
        except KeyError:
            t = self._timers[name] = _Timer(name, self.device)
            return t

    def snapshot(self) -> Dict[str, dict]:
        """Point-in-time, NON-destructive view of every timer.

        ``{name: {"total_s": accumulated+in-flight seconds, "running":
        bool}}``.  Unlike :meth:`_Timer.elapsed` this mutates nothing —
        it is the read a monitor thread takes while the main thread is
        stuck *inside* a timed region, so a running timer's in-flight
        seconds are included and values may be one assignment stale
        (harmless for diagnostics).
        """
        now = time.perf_counter()
        out: Dict[str, dict] = {}
        for name, t in list(self._timers.items()):
            # read total BEFORE running: paired with stop()'s
            # running=False-then-total+= ordering, a racing stop can make
            # this view one span stale but never double-counted
            total = t.total
            running = t.running
            if running:
                total += now - t._t0
            out[name] = {"total_s": round(total, 6), "running": running}
        return out

    def publish_metrics(self) -> Dict[str, dict]:
        """Export the (non-destructive) :meth:`snapshot` totals as the
        ``apex_timer_seconds{region=...}`` gauge series of the port's
        observability bridge: every timed region becomes a scrapeable
        cumulative-seconds gauge.  Returns the snapshot it published."""
        from apex_tpu_torch.obs.bridge import TIMER_SECONDS

        snap = self.snapshot()
        for name, rec in snap.items():
            TIMER_SECONDS.set(rec["total_s"], region=name)
        return snap

    def write(self, names: List[str], writer, iteration: int,
              normalizer: float = 1.0, reset: bool = False) -> None:
        """Export per-name mean seconds to any ``add_scalar(tag, val, step)``
        sink (TensorBoard SummaryWriter shaped)."""
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be positive, got {normalizer}")
        for name in names:
            seconds = self._timers[name].elapsed(reset=reset) / normalizer
            writer.add_scalar(f"{name}-time", seconds, iteration)

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True) -> str:
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be positive, got {normalizer}")
        cells = [
            f"{name}: {self._timers[name].elapsed(reset=reset) * 1e3 / normalizer:.2f}"
            for name in names
        ]
        line = "time (ms) | " + " | ".join(cells)
        logger.info(line)
        return line
