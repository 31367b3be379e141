"""Deterministic, seed-driven fault injection: the serving faults.

The port of the serving part of ``apex_tpu.resilience.fault_injection``:
the faults the scheduler's control plane is graded under, wired through
:class:`~apex_tpu_torch.serving.loadgen.LoadGenerator`'s ``step_hook``.
Each fires one ``fault_injected`` event through
:func:`~apex_tpu_torch._logging.emit_event`, as the JAX package's does.

- **Straggler decode steps**: :class:`SlowDecodeStep` inflates chosen
  scheduler steps on the injectable (virtual) clock — queueing and
  deadline pressure appear deterministically, while the token streams
  (clock-independent by construction) must stay bit-identical.
- **Abandoned streams**: :class:`StallStream` cancels chosen requests
  once they have emitted N tokens — the client that stopped reading;
  the scheduler must reclaim the slot without disturbing neighbors.
- **Cancellation storms**: :class:`CancelStorm` cancels a seed-chosen
  subset of in-flight/queued requests at chosen steps.

The weight-lifecycle faults, on the reloader, the fleet router and the
rollout controller:

- **Reload pressure**: :class:`ReloadStorm` forces reload attempts at
  chosen steps under load.
- **Replica faults** (``step_hook`` over a
  :class:`~apex_tpu_torch.serving.fleet.FleetRouter`):
  :class:`KillReplica` (device memory lost: streams replay on
  survivors), :class:`WedgeReplica` (a hung step: the watchdog walks it
  to DEAD and drains it with capture) and :class:`SlowReplica` (missed
  beats).
- **Rollout faults**: :class:`CorruptCandidateMidRollout` (flipped
  candidate bytes), :class:`RegressingWeights` (a valid candidate that
  serves slower — by router stalls, not by its values) and
  :class:`KillCanary`.
- **Writer crash**: :class:`CrashCheckpointWriter` kills a checkpoint
  write after N records with :class:`SimulatedWriterCrash`, leaving the
  partial temp dir a hard kill leaves.

:func:`corrupt_checkpoint` is the storage corruption of the JAX
``FaultInjector.corrupt_checkpoint`` (same offsets for the same seed).
``CorruptShardFile`` flips bytes inside one shard record of a sharded
(v2) checkpoint.

The training faults, each placed as the JAX package's for the same seed
over the same leaf order (``jax.tree_util``'s: dict keys sorted):

- **Numerical**: :meth:`FaultInjector.inject_grads` plants NaN/Inf
  gradient elements at configured steps (functional; the step may be a
  0-d tensor on the device, compared there without a host read).
- **Preemption**: :meth:`FaultInjector.check_preemption` raises
  :class:`SimulatedPreemption` at the host step boundary.
- **Storage**: :meth:`FaultInjector.corrupt_checkpoint` /
  :meth:`~FaultInjector.truncate_checkpoint`.
- **Stragglers**: :class:`SlowStep` stalls the host step body.
- **Flaky producers**: :class:`FlakyIterator` makes a chosen fetch raise
  a transient error N times, then succeed without consuming the item.
- **Corrupt records**: :class:`CorruptBatch` inserts a damaged copy of a
  chosen batch ahead of the clean one (NaN / shape / dtype damage).
- **Replica divergence**: :class:`DesyncReplica` perturbs one element of
  one leaf of one data-parallel rank's own copy (JAX perturbs that
  rank's slice of the stacked state).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, Optional,
                    Tuple, Type)

import numpy as np
import torch

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.utils.serialization import (
    tree_flatten_with_path,
    tree_map_with_path,
)

__all__ = ["CancelStorm", "CorruptBatch", "CorruptCandidateMidRollout",
           "CorruptShardFile", "CrashCheckpointWriter", "DesyncReplica",
           "FaultInjector", "FaultPlan", "FlakyIterator", "KillCanary",
           "KillReplica", "RegressingWeights", "ReloadStorm",
           "SimulatedPreemption", "SimulatedWriterCrash", "SlowDecodeStep",
           "SlowReplica", "SlowStep", "StallStream", "WedgeReplica",
           "corrupt_checkpoint"]


def corrupt_checkpoint(ckpt_dir: str, *, seed: int = 0,
                       nbytes: int = 8) -> list[int]:
    """Flip ``nbytes`` seed-chosen bytes of ``<ckpt_dir>/data.bin`` in
    place; returns the corrupted offsets (bit corruption).  The JAX
    ``FaultInjector(FaultPlan(seed=seed)).corrupt_checkpoint``: the same
    offsets and the same ``checkpoint_corruption`` event."""
    path = os.path.join(ckpt_dir, "data.bin")
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    offsets = sorted(
        int(o) for o in rng.choice(size, size=min(nbytes, size),
                                   replace=False))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ 0xFF]))
    emit_event("fault_injected", fault="checkpoint_corruption",
               path=path, offsets=offsets)
    return offsets


def _rebuild(tree: Any, leaves: list) -> Any:
    """``tree`` with its leaves, in flatten order, replaced by ``leaves``."""
    it = iter(leaves)
    return tree_map_with_path(lambda _, __: next(it), tree)


class SimulatedPreemption(RuntimeError):
    """Raised at an injected preemption boundary (stands in for SIGTERM)."""

    def __init__(self, step: int):
        super().__init__(f"simulated preemption at step {step}")
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to break, and when (all step indices are host step numbers).

    ``nan_grad_steps`` / ``inf_grad_steps``: steps whose gradients get
    deterministic NaN / Inf elements injected.  ``preempt_steps``: steps
    whose host boundary raises :class:`SimulatedPreemption`.  ``seed``
    drives every placement choice.
    """

    seed: int = 0
    nan_grad_steps: Tuple[int, ...] = ()
    inf_grad_steps: Tuple[int, ...] = ()
    preempt_steps: Tuple[int, ...] = ()


class FaultInjector:
    """Executes a :class:`FaultPlan` against a training loop."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def placements(self, grads: Any) -> list:
        """Where :meth:`inject_grads` plants its faults in a tree shaped
        like ``grads``: ``[(value, leaf path, flat element, steps)]`` for
        each configured class, NaN before Inf — JAX's leaf and element
        for the same seed: the candidates are the non-empty floating
        leaves in flatten order, and the seed stream is consumed for both
        classes even when one is not configured."""
        plan = self.plan
        if not plan.nan_grad_steps and not plan.inf_grad_steps:
            return []
        flat = tree_flatten_with_path(grads)
        candidates = [i for i, (_, l) in enumerate(flat)
                      if isinstance(l, torch.Tensor) and l.numel()
                      and (l.is_floating_point() or l.is_complex())]
        if not candidates:
            return []
        rng = np.random.default_rng(plan.seed)
        out = []
        for bad, steps in ((float("nan"), plan.nan_grad_steps),
                           (float("inf"), plan.inf_grad_steps)):
            idx = candidates[int(rng.integers(len(candidates)))]
            pos = int(rng.integers(flat[idx][1].numel()))
            if steps:
                out.append((bad, flat[idx][0], pos, tuple(steps)))
        return out

    def inject_grads(self, grads: Any, step) -> Any:
        """``grads`` with NaN/Inf planted when ``step`` is a configured
        fault step (at :meth:`placements`); the same tensors otherwise.

        The fault is planted in the leaf's own dtype, in a copy of that
        leaf (the tree given is never written).  ``step`` is a host int,
        or a 0-d tensor on the device, where the hit is a ``torch.where``
        (no host read; the target leaf is then copied on every call, as
        JAX's is).
        """
        sites = self.placements(grads)
        if not sites:
            return grads
        flat = tree_flatten_with_path(grads)
        index = {path: i for i, (path, _) in enumerate(flat)}
        leaves = [l for _, l in flat]
        for bad, path, pos, steps in sites:
            if isinstance(step, torch.Tensor):
                hit = (step.reshape(()) == torch.tensor(
                    steps, device=step.device, dtype=step.dtype)).any()
            elif int(step) in steps:
                hit = None
            else:
                continue
            leaf = leaves[index[path]]
            cell = leaf.detach().reshape(-1).clone()
            if hit is None:
                cell[pos:pos + 1].fill_(bad)      # a fill: no host copy
            else:
                cell[pos] = torch.where(hit, torch.full_like(cell[pos], bad),
                                        cell[pos])
            leaves[index[path]] = cell.view(leaf.shape)
        return _rebuild(grads, leaves)

    def check_preemption(self, step: int) -> None:
        """Host-side step boundary: raises :class:`SimulatedPreemption`
        when ``step`` is a configured preemption step."""
        if int(step) in self.plan.preempt_steps:
            emit_event("fault_injected", fault="preemption", step=int(step))
            raise SimulatedPreemption(int(step))

    def corrupt_checkpoint(self, ckpt_dir: str, *,
                           nbytes: int = 8) -> list[int]:
        """Flip ``nbytes`` seed-chosen bytes of ``<ckpt_dir>/data.bin``
        in place; returns the corrupted offsets (:func:`corrupt_checkpoint`
        with the plan's seed)."""
        return corrupt_checkpoint(ckpt_dir, seed=self.plan.seed,
                                  nbytes=nbytes)

    def truncate_checkpoint(self, ckpt_dir: str, *,
                            drop_bytes: int = 1) -> None:
        """Truncate ``data.bin`` by ``drop_bytes`` (half-written writer)."""
        path = os.path.join(ckpt_dir, "data.bin")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size - drop_bytes, 0))
        emit_event("fault_injected", fault="checkpoint_truncation",
                   path=path, dropped=drop_bytes)


class SlowStep:
    """Host-side straggler: stall the step body at configured steps.

    Call ``slow(step)`` inside the watchdog's armed window to block for
    ``duration_s`` on the chosen steps; the computation itself is
    untouched.  ``sleep`` is injectable for wait-free tests.
    """

    def __init__(self, steps: Iterable[int], duration_s: float = 0.3, *,
                 sleep: Callable[[float], None] = time.sleep):
        self.steps = frozenset(int(s) for s in steps)
        self.duration_s = float(duration_s)
        self._sleep = sleep

    def __call__(self, step: int) -> None:
        if int(step) in self.steps:
            emit_event("fault_injected", fault="slow_step", step=int(step),
                       duration_s=self.duration_s)
            self._sleep(self.duration_s)


class FlakyIterator:
    """Transiently failing producer: chosen fetches raise, then succeed.

    The fetch at (0-based) index ``i`` for each ``i`` in ``fail_at``
    raises ``exc_type`` ``failures`` times before succeeding, and the
    failures do NOT consume the underlying item, so a retry wrapper
    recovers the identical stream.
    """

    def __init__(self, it: Iterable, *, fail_at: Iterable[int] = (),
                 failures: int = 2,
                 exc_type: Type[Exception] = OSError,
                 message: str = "injected flaky fetch"):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        self._it = iter(it)
        self.fail_at = frozenset(int(i) for i in fail_at)
        self.failures = failures
        self.exc_type = exc_type
        self.message = message
        self._idx = 0      # index of the next successful fetch
        self._raised = 0   # failures already raised at the current index

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._idx in self.fail_at and self._raised < self.failures:
            self._raised += 1
            emit_event("fault_injected", fault="flaky_iterator",
                       index=self._idx, failure=self._raised,
                       failures=self.failures)
            raise self.exc_type(
                f"{self.message} (index {self._idx}, "
                f"failure {self._raised}/{self.failures})")
        item = next(self._it)
        self._idx += 1
        self._raised = 0
        return item


def _numel(leaf: Any) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else np.size(leaf)


def _floating(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


class CorruptBatch:
    """Insert a corrupted COPY of chosen batches ahead of the clean ones.

    A guarded run that drops every corrupted copy consumes the exact
    clean stream an unfaulted run consumes.  ``at`` indexes the clean
    stream (0-based).  Damage modes, applied to a copy of the first
    array leaf (a tensor stays a tensor, on its device):

    - ``"nan"``    — plant NaNs at seed-chosen elements (JAX's for the
      seed) of the first floating leaf,
    - ``"shape"``  — drop the leading row,
    - ``"dtype"``  — cast to float64 (float32 when it is float64).
    """

    _MODES = ("nan", "shape", "dtype")

    def __init__(self, it: Iterable, *, at: Iterable[int] = (),
                 mode: str = "nan", seed: int = 0, n_elements: int = 3):
        if mode not in self._MODES:
            raise ValueError(f"mode must be one of {self._MODES}, got {mode!r}")
        self._it = iter(it)
        self.at = frozenset(int(i) for i in at)
        self.mode = mode
        self.seed = seed
        self.n_elements = n_elements
        self._idx = 0             # clean items fetched from the source
        self._pending = None      # clean item to deliver after its corrupt copy

    def __iter__(self) -> Iterator:
        return self

    def _corrupt(self, batch: Any) -> Any:
        leaves = [l for _, l in tree_flatten_with_path(batch)]
        if self.mode == "nan":
            target = next((i for i, l in enumerate(leaves)
                           if _numel(l) and _floating(l)), None)
        else:
            target = next((i for i, l in enumerate(leaves) if _numel(l)),
                          None)
        if target is None:
            raise ValueError(
                f"CorruptBatch(mode={self.mode!r}): batch has no "
                f"{'floating-point ' if self.mode == 'nan' else ''}"
                "non-empty array leaf to corrupt")
        leaf = leaves[target]
        tensor = isinstance(leaf, torch.Tensor)
        arr = leaf.detach().clone() if tensor else np.array(leaf)
        if self.mode == "nan":
            rng = np.random.default_rng(self.seed)
            flat = arr.reshape(-1)
            n = _numel(arr)
            pos = rng.choice(n, size=min(self.n_elements, n), replace=False)
            flat[torch.from_numpy(pos) if tensor else pos] = float("nan")
            arr = flat.reshape(arr.shape)
        elif self.mode == "shape":
            arr = arr[1:] if arr.ndim and arr.shape[0] > 0 else arr.reshape(-1)
        elif tensor:
            arr = arr.to(torch.float64 if arr.dtype != torch.float64
                         else torch.float32)
        else:
            arr = arr.astype(np.float64 if arr.dtype != np.float64
                             else np.float32)
        leaves[target] = arr
        return _rebuild(batch, leaves)

    def __next__(self):
        if self._pending is not None:
            item, self._pending = self._pending, None
            return item
        item = next(self._it)
        idx = self._idx
        self._idx += 1
        if idx in self.at:
            corrupted = self._corrupt(item)  # before touching _pending
            emit_event("fault_injected", fault="corrupt_batch", index=idx,
                       mode=self.mode)
            self._pending = item
            return corrupted
        return item


_SAME_SIZE_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}


class DesyncReplica:
    """Silently diverge ONE data-parallel rank's copy of one leaf at
    chosen steps.

    Each rank calls ``desync(state, step)`` on its own copy; on rank
    ``rank`` of the data-parallel group ``axis_name`` (None: rank 0 of
    one) and a configured step it adds ``delta`` to one element of the
    chosen leaf, in place, and returns ``state`` (every other call leaves
    it untouched).  No collective runs and no event fires beyond
    ``fault_injected``: the silent divergence a cross-replica hash pass
    exists to catch.

    ``leaf`` selects the victim by keystr substring; None picks
    seed-deterministically among the non-empty floating leaves, as JAX
    picks among its stacked ones.  The element offset is seed-chosen
    within this rank's own copy of the leaf (its local shard under tp,
    where JAX's offset is within the replica's whole slice).  When
    ``delta`` rounds away in the leaf's dtype, the element's lowest bit
    flips instead, so the injection is always a real byte divergence.
    """

    def __init__(self, steps: Iterable[int], *, rank: int = 1,
                 leaf: Any = None, seed: int = 0, delta: float = 1e-3,
                 axis_name=None):
        self.steps = frozenset(int(s) for s in steps)
        self.rank = int(rank)
        self.leaf = leaf
        self.seed = int(seed)
        self.delta = float(delta)
        self.axis_name = axis_name

    def _my_rank(self) -> int:
        import torch.distributed as dist

        from apex_tpu_torch.resilience.consistency import _groups

        group, _ = _groups(self.axis_name, None)
        if group is None or not dist.is_initialized():
            return 0
        return dist.get_rank(group)

    def __call__(self, state: Any, step: int) -> Any:
        if int(step) not in self.steps or self._my_rank() != self.rank:
            return state
        candidates = [
            (path, leaf) for path, leaf in tree_flatten_with_path(state)
            if isinstance(leaf, torch.Tensor) and leaf.numel()
            and leaf.is_floating_point()
            and (self.leaf is None or str(self.leaf) in path)]
        if not candidates:
            raise ValueError(
                f"DesyncReplica(leaf={self.leaf!r}): no non-empty floating "
                f"leaf to perturb")
        rng = np.random.default_rng(self.seed)
        key, victim = candidates[int(rng.integers(len(candidates)))]
        pos = int(rng.integers(victim.numel()))
        at = tuple(int(i) for i in np.unravel_index(pos, tuple(victim.shape)))
        with torch.no_grad():
            cell = victim[at].clone()
            new = cell + torch.tensor(self.delta, dtype=victim.dtype,
                                      device=victim.device)
            bits = _SAME_SIZE_INT[victim.element_size()]
            if torch.equal(new.view(bits), cell.view(bits)):
                new = (new.view(bits) ^ 1).view(victim.dtype)
            victim[at] = new
        emit_event("fault_injected", fault="desync_replica", step=int(step),
                   leaf=key, rank=self.rank, element=pos, delta=self.delta)
        return state


class SlowDecodeStep:
    """Straggler scheduler steps: inflate chosen steps on the
    injectable clock.

    Install as a :class:`~apex_tpu_torch.serving.loadgen.LoadGenerator`
    ``step_hook``: at each configured (0-based) step index the hook
    advances ``clock`` — which must be the scheduler's own
    :class:`~apex_tpu_torch.serving.loadgen.VirtualClock` — by ``extra_s``,
    exactly as if that step's decode dispatch had stalled.  Queue wait,
    TTFT, and deadline pressure shift deterministically; the token
    streams must not move a bit (the scheduler's determinism contract:
    the clock feeds telemetry and policy, never token choice) — the
    chaos acceptance run asserts exactly that.
    """

    def __init__(self, steps: Iterable[int], extra_s: float, *, clock):
        if extra_s <= 0:
            raise ValueError(f"extra_s must be > 0, got {extra_s}")
        if not hasattr(clock, "advance"):
            raise ValueError(
                "SlowDecodeStep needs an advanceable clock — pass the "
                "scheduler's VirtualClock (a real monotonic clock "
                "cannot be inflated)")
        self.steps = frozenset(int(s) for s in steps)
        self.extra_s = float(extra_s)
        self._clock = clock

    def __call__(self, step: int, scheduler=None) -> None:
        if int(step) in self.steps:
            emit_event("fault_injected", fault="slow_decode_step",
                       step=int(step), extra_s=self.extra_s)
            self._clock.advance(self.extra_s)


class StallStream:
    """Abandoned-client streams: cancel chosen rids after N tokens.

    A client that stops reading mid-stream looks, server-side, like a
    request that must be cancelled to reclaim its slot.  Install as a
    ``step_hook``: once a configured rid's stream has emitted at least
    ``after_tokens`` tokens, it is cancelled (once).  The neighbors'
    streams must be bit-identical to an unstalled run — cancellation
    releases the slot, blocks, and pins without touching them.
    """

    def __init__(self, rids: Iterable[str], *, after_tokens: int = 2):
        if after_tokens < 1:
            raise ValueError(
                f"after_tokens must be >= 1, got {after_tokens}")
        self.rids = frozenset(str(r) for r in rids)
        self.after_tokens = int(after_tokens)
        self.stalled: list = []          # rids actually cancelled

    def __call__(self, step: int, scheduler) -> None:
        done = set(self.stalled)
        for rid in sorted(self.rids - done):
            if scheduler.phase_of(rid).value == "done":
                continue                 # finished before the stall bit
            tokens = scheduler.progress_of(rid)
            if tokens >= self.after_tokens:
                emit_event("fault_injected", fault="stall_stream",
                           rid=rid, step=int(step), tokens=tokens)
                scheduler.cancel(rid)
                self.stalled.append(rid)


class CancelStorm:
    """Mass-disconnect burst: cancel a seed-chosen subset of live
    requests at chosen steps.

    At each configured step, up to ``count`` rids are drawn
    (deterministically, from ``seed``) from everything currently
    queued or active on the scheduler and cancelled — the gateway
    -restart burst.  Surviving streams must be bit-identical to a
    storm-free run; every cancelled slot/block/pin must be reclaimed.
    ``cancelled`` records what the storm actually hit, for assertions.
    """

    def __init__(self, steps: Iterable[int], *, count: int = 2,
                 seed: int = 0):
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self.steps = frozenset(int(s) for s in steps)
        self.count = int(count)
        self.seed = int(seed)
        self.cancelled: list = []

    def __call__(self, step: int, scheduler) -> None:
        if int(step) not in self.steps:
            return
        live = sorted(scheduler.queued_rids + scheduler.active_rids)
        if not live:
            return
        rng = np.random.default_rng(self.seed + int(step))
        hit = [live[i] for i in sorted(
            rng.choice(len(live), size=min(self.count, len(live)),
                       replace=False))]
        emit_event("fault_injected", fault="cancel_storm",
                   step=int(step), rids=hit)
        for rid in hit:
            scheduler.cancel(rid)
            self.cancelled.append(rid)


class ReloadStorm:
    """Hot-reload pressure: force weight reload attempts at chosen
    steps while the scheduler is under load.

    Install as a ``step_hook`` alongside an overloaded open-loop
    workload: at each configured (0-based) step index the hook calls
    ``reloader.reload()`` (or ``maybe_reload()`` when ``force=False``
    — then only steps where the watcher actually sees a newer commit
    reload).  The chaos acceptance contract: however many swaps,
    refusals, and rollback-fodder candidates the storm generates,
    every in-flight stream survives and the scheduler's accounting
    (slots, blocks, pins, queue) stays exact.  ``outcomes`` records
    each attempt's :class:`~apex_tpu_torch.serving.reload.ReloadOutcome`
    (or None for a no-op ``maybe_reload``) for assertions.
    """

    def __init__(self, steps: Iterable[int], *, reloader,
                 force: bool = False):
        self.steps = frozenset(int(s) for s in steps)
        self.reloader = reloader
        self.force = bool(force)
        self.outcomes: list = []

    def __call__(self, step: int, scheduler=None) -> None:
        if int(step) not in self.steps:
            return
        emit_event("fault_injected", fault="reload_storm",
                   step=int(step), forced=self.force)
        if self.force:
            out = self.reloader.reload()
        else:
            out = self.reloader.maybe_reload()
        self.outcomes.append(out)


# -- fleet faults ------------------------------------------------


class KillReplica:
    """Hard-kill a fleet replica at a chosen step (device memory
    lost).

    Install as a :class:`~apex_tpu_torch.serving.loadgen.LoadGenerator`
    ``step_hook`` driving a
    :class:`~apex_tpu_torch.serving.fleet.FleetRouter`: at the configured
    (0-based) step the router's :meth:`~apex_tpu_torch.serving.fleet.
    FleetRouter.kill` fires — the victim's in-flight streams re-queue
    on survivors from their host-side request records and **replay
    deterministically** (the final token streams are bit-identical to
    an unperturbed run; the device cache is honestly gone, so the
    already-emitted tokens are re-earned, not restored).  The killed
    scheduler is routed through ``close()`` so prefix pins and paged
    block holds never leak.
    """

    def __init__(self, replica: str, *, at_step: int):
        if at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {at_step}")
        self.replica = str(replica)
        self.at_step = int(at_step)
        self.killed = False

    def __call__(self, step: int, router) -> None:
        if self.killed or int(step) != self.at_step:
            return
        emit_event("fault_injected", fault="kill_replica",
                   replica=self.replica, step=int(step))
        router.kill(self.replica)
        self.killed = True


class WedgeReplica:
    """Hard-hang a fleet replica at a chosen step: its steps never
    complete again, so it stops heartbeating and the router's watchdog
    walks it HEALTHY → SUSPECT → DEAD on the shared clock, then drains
    it via preempt-capture (host and device state are intact — a hang
    is not a loss), resuming dense victims on survivors **mid-stream,
    bit-exactly**.
    """

    def __init__(self, replica: str, *, at_step: int):
        if at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {at_step}")
        self.replica = str(replica)
        self.at_step = int(at_step)
        self.wedged = False

    def __call__(self, step: int, router) -> None:
        if self.wedged or int(step) != self.at_step:
            return
        emit_event("fault_injected", fault="wedge_replica",
                   replica=self.replica, step=int(step))
        router.wedge(self.replica)
        self.wedged = True


class SlowReplica:
    """Straggler replica: at each configured step the replica's step
    fails to complete within the boundary (one missed heartbeat per
    configured step) and the shared clock inflates by ``extra_s``.  A
    run of stalls longer than ``suspect_after_s`` drives the replica
    SUSPECT (placements route around it); shorter than
    ``dead_after_s`` it recovers on its next completed beat — HEALTHY
    again with WRR credits reset.  Token streams must not move a bit
    (clock feeds health and telemetry, never token choice).
    """

    def __init__(self, replica: str, steps: Iterable[int],
                 extra_s: float, *, clock):
        if extra_s <= 0:
            raise ValueError(f"extra_s must be > 0, got {extra_s}")
        if not hasattr(clock, "advance"):
            raise ValueError(
                "SlowReplica needs an advanceable clock — pass the "
                "fleet's VirtualClock (a real monotonic clock cannot "
                "be inflated)")
        self.replica = str(replica)
        self.steps = frozenset(int(s) for s in steps)
        self.extra_s = float(extra_s)
        self._clock = clock

    def __call__(self, step: int, router) -> None:
        if int(step) not in self.steps:
            return
        emit_event("fault_injected", fault="slow_replica",
                   replica=self.replica, step=int(step),
                   extra_s=self.extra_s)
        router.stall(self.replica)
        self._clock.advance(self.extra_s)


# -- rollout faults


class CorruptCandidateMidRollout:
    """Flip bytes in the rollout's candidate checkpoint at a chosen
    loadgen step — the committed-but-rotted candidate a rolling
    upgrade must refuse.

    ``step_hook`` over a :class:`~apex_tpu_torch.serving.fleet.FleetRouter`
    run driven by a :class:`~apex_tpu_torch.serving.rollout.
    RollingReloadController`: at ``at_step`` the candidate's
    ``data.bin`` gets seed-chosen bytes flipped in place (the
    :func:`corrupt_checkpoint` corruption).  Any replica
    whose reload restores those bytes refuses first-class (the
    checksum/validation gate), which the controller turns into
    automatic halt + fleet rollback.  Fire it *before* the victim
    wave's prefetch — a stage restored earlier already holds clean
    bytes (restore-ahead is exactly that window).
    """

    def __init__(self, root: str, step: int, *, at_step: int,
                 seed: int = 0, nbytes: int = 8):
        if at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {at_step}")
        self.root = str(root)
        self.step = int(step)
        self.at_step = int(at_step)
        self.seed = int(seed)
        self.nbytes = int(nbytes)
        self.corrupted = False

    def __call__(self, step: int, router=None) -> None:
        if self.corrupted or int(step) != self.at_step:
            return
        from apex_tpu_torch.resilience.checkpoint import _step_dirname

        emit_event("fault_injected", fault="corrupt_candidate",
                   step=int(step), candidate_step=self.step)
        corrupt_checkpoint(
            os.path.join(self.root, _step_dirname(self.step)),
            seed=self.seed, nbytes=self.nbytes)
        self.corrupted = True


class RegressingWeights:
    """A candidate that *validates clean but serves measurably worse*
    — the regression only a canary gate catches.

    :meth:`publish` commits a spec-valid candidate (same tree,
    shapes, dtypes — every structural gate passes) whose weights are
    perturbed.  The serving regression itself is modeled by the hook:
    on a virtual clock no weight value can slow its own matmul, so
    *any* replica currently serving the candidate step is stalled
    every ``slow_every``-th call
    (:meth:`~apex_tpu_torch.serving.fleet.FleetRouter.stall` — its streams
    miss that beat), inflating the candidate arm's per-token latency
    deterministically while old-version replicas run clean.  During a
    gated rollout only the canary serves the candidate, so only the
    canary degrades and the gate catches it; with the gate disabled
    the whole fleet ends up on the candidate and the whole fleet
    degrades — the goodput contrast the gate exists to buy.  Stalls
    are phase-offset per replica so a fully-upgraded fleet halves its
    capacity rather than freezing outright.  Keep ``slow_every *
    step_time`` under the fleet's ``suspect_after_s`` so the watchdog
    never escalates — the regression must be caught by the *gate*,
    not the health check.  The stalling stops on its own when a
    replica leaves the candidate step (rollback).
    """

    def __init__(self, controller, *, slow_every: int = 2):
        if slow_every < 2:
            raise ValueError(
                f"slow_every must be >= 2, got {slow_every} — at 1 "
                f"every step stalls and streams never finish")
        self.controller = controller
        self.slow_every = int(slow_every)
        self.stalls = 0
        self._announced = False
        self._ticks: Dict[str, int] = {}

    @staticmethod
    def publish(root: str, params: Any, step: int, *,
                delta: float = 1e-3) -> Any:
        """Commit the degraded-but-valid candidate
        ``{"params": params + delta}`` at ``step`` (``delta`` added in
        each floating leaf's own dtype); returns the perturbed tree (for
        bit-exactness assertions)."""
        from apex_tpu_torch.resilience.checkpoint import save_checkpoint
        from apex_tpu_torch.utils.serialization import tree_map_with_path

        def perturb(_, leaf):
            if isinstance(leaf, torch.Tensor):
                return (leaf + torch.tensor(delta, dtype=leaf.dtype,
                                            device=leaf.device)
                        if leaf.is_floating_point() else leaf)
            arr = np.asarray(leaf)
            return (arr + np.asarray(delta, arr.dtype)
                    if np.issubdtype(arr.dtype, np.inexact) else leaf)

        bad = tree_map_with_path(perturb, params)
        save_checkpoint(str(root), int(step), {"params": bad})
        return bad

    def __call__(self, step: int, router) -> None:
        c = self.controller
        if c.target_step is None:
            return
        for idx, name in enumerate(router.replica_names):
            sched = router.replica(name)
            if getattr(sched, "weights_step", None) != c.target_step:
                continue                 # not serving the candidate
            if not self._announced:
                emit_event("fault_injected",
                           fault="regressing_weights", replica=name,
                           step=int(step),
                           candidate_step=c.target_step)
                self._announced = True
            tick = self._ticks.get(name, 0)
            self._ticks[name] = tick + 1
            if (tick + idx) % self.slow_every == 0:
                self.stalls += 1
                router.stall(name)


class KillCanary:
    """Kill the canary replica mid-verdict-window (device memory
    lost) — the rollout must halt and roll back, and the canary's
    in-flight streams must replay losslessly on the old-version
    survivors.

    ``step_hook``: once the controller enters its canary window
    (traffic pinned), waits ``after_window_steps`` window steps, then
    hard-kills whichever replica the controller chose as canary.
    """

    def __init__(self, controller, *, after_window_steps: int = 1):
        if after_window_steps < 1:
            raise ValueError(f"after_window_steps must be >= 1, got "
                             f"{after_window_steps}")
        self.controller = controller
        self.after = int(after_window_steps)
        self.killed = False
        self._seen = 0

    def __call__(self, step: int, router) -> None:
        if self.killed or self.controller.phase != "canary":
            return
        self._seen += 1
        if self._seen < self.after:
            return
        emit_event("fault_injected", fault="kill_canary",
                   replica=self.controller.canary, step=int(step))
        router.kill(self.controller.canary)
        self.killed = True


# -- checkpoint-writer faults


class SimulatedWriterCrash(RuntimeError):
    """A checkpoint writer died mid-write (stands in for SIGKILL).

    ``preserve_partial_write`` makes the write machinery skip its
    temp-dir cleanup — exactly the on-disk state a hard kill leaves: a
    partially written ``tmp_*`` dir that ``latest_valid_step`` and the
    restore walk can never select, reclaimed by the next save's orphan
    sweep.  Deterministic (``transient = False``): a crashed writer is
    not an I/O blip, so the retry layer never re-runs it."""

    preserve_partial_write = True
    transient = False

    def __init__(self, step: int, record: int):
        super().__init__(
            f"simulated writer crash at step {step}, record {record}")
        self.step = step
        self.record = record


class CrashCheckpointWriter:
    """Kill the (background) checkpoint writer after N leaf records.

    Install as the write machinery's ``progress_hook`` (e.g.
    ``AsyncCheckpointer(manager, progress_hook=CrashCheckpointWriter())``
    or ``manager.write_snapshot(..., progress_hook=...)``): the hook
    fires after each manifest record is written, and once
    ``after_records`` records are on disk it raises
    :class:`SimulatedWriterCrash` — leaving the partial temp dir behind
    like a real SIGKILL (see ``preserve_partial_write``).  ``steps``
    optionally restricts the crash to chosen host steps; one crash per
    instance (``fired``), so a retried or subsequent save succeeds.
    """

    def __init__(self, *, after_records: int = 1,
                 steps: Optional[Iterable[int]] = None):
        if after_records < 1:
            raise ValueError(
                f"after_records must be >= 1, got {after_records}")
        self.after_records = int(after_records)
        self.steps = None if steps is None else frozenset(
            int(s) for s in steps)
        self.fired = False
        self._seen = 0

    def __call__(self, progress: dict) -> None:
        if self.fired:
            return
        if self.steps is not None and int(progress["step"]) not in self.steps:
            return
        self._seen += 1
        if self._seen >= self.after_records:
            self.fired = True
            emit_event("fault_injected", fault="writer_crash",
                       step=int(progress["step"]),
                       record=int(progress["record"]),
                       bytes=int(progress["bytes"]))
            raise SimulatedWriterCrash(int(progress["step"]),
                                       int(progress["record"]))


class CorruptShardFile:
    """Flip bytes inside exactly one shard record of a v2 checkpoint.

    The damage stays inside the chosen shard's byte extent in
    ``data.bin``; the manifest and every other shard are intact, so the
    per-shard CRCs must localize it (validation names the shard's mesh
    coordinates and leaf) and the restore walk must fall back to the
    newest fully valid step.  ``leaf`` picks the victim leaf by keystr
    substring (None: seed-chosen among leaves with non-empty shards);
    ``shard`` indexes that leaf's non-empty shards.  Returns what was
    damaged."""

    def __init__(self, *, leaf=None, shard: int = 0, nbytes: int = 4,
                 seed: int = 0):
        if nbytes < 1:
            raise ValueError(f"nbytes must be >= 1, got {nbytes}")
        self.leaf = leaf
        self.shard = int(shard)
        self.nbytes = int(nbytes)
        self.seed = int(seed)

    def __call__(self, ckpt_dir: str) -> dict:
        import json

        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != 2:
            raise ValueError(
                f"{ckpt_dir}: CorruptShardFile needs a sharded (v2) "
                f"checkpoint, got format_version "
                f"{manifest.get('format_version')}")
        recs = [r for r in manifest["leaves"]
                if r.get("shards")
                and any(s.get("nbytes") for s in r["shards"])
                and (self.leaf is None or str(self.leaf) in r["path"])]
        if not recs:
            raise ValueError(
                f"{ckpt_dir}: no leaf matching {self.leaf!r} with a "
                f"non-empty shard to corrupt")
        rng = np.random.default_rng(self.seed)
        rec = recs[int(rng.integers(len(recs)))]
        shards = [s for s in rec["shards"] if s.get("nbytes")]
        shard = shards[self.shard % len(shards)]
        offsets = sorted(
            int(shard["offset"]) + int(o)
            for o in rng.choice(int(shard["nbytes"]),
                                size=min(self.nbytes, int(shard["nbytes"])),
                                replace=False))
        path = os.path.join(ckpt_dir, "data.bin")
        with open(path, "r+b") as f:
            for off in offsets:
                f.seek(off)
                byte = f.read(1)[0]
                f.seek(off)
                f.write(bytes([byte ^ 0xFF]))
        emit_event("fault_injected", fault="shard_corruption", path=path,
                   leaf=rec["path"], coords=shard.get("coords"),
                   offsets=offsets)
        return {"leaf": rec["path"], "coords": shard.get("coords"),
                "offsets": offsets}
