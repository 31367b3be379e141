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
(v2) checkpoint.  The JAX module's training faults (``FaultPlan`` /
``FaultInjector``, ``SlowStep``, ``FlakyIterator``, ``CorruptBatch``) and
``DesyncReplica`` wait for the training-side resilience slice.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from apex_tpu_torch._logging import emit_event

__all__ = ["CancelStorm", "CorruptCandidateMidRollout",
           "CorruptShardFile", "CrashCheckpointWriter", "KillCanary", "KillReplica",
           "RegressingWeights", "ReloadStorm", "SimulatedWriterCrash",
           "SlowDecodeStep", "SlowReplica", "StallStream", "WedgeReplica",
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
