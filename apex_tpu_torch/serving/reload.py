"""Zero-downtime weight lifecycle: hot reload, rollback, shadow/A-B.

The port of ``apex_tpu.serving.reload``.  Weights are state dicts;
the swap is :meth:`~apex_tpu_torch.serving.engine.DecodeEngine.
swap_params`, which rebinds one engine's tensors and never writes into a
module other engines share.

The serving stack boots its weights once (:mod:`.weights`); a fleet
that "serves while you train" cannot drain and
restart every engine each time training publishes a checkpoint.  This
module closes the loop with three layers, all **default-off** — a
scheduler that never constructs them behaves byte-for-byte as before:

- :class:`WeightWatcher` — polls for newer *committed* steps, by
  preference order: an in-process
  :class:`~apex_tpu_torch.resilience.async_checkpoint.AsyncCheckpointer`'s
  ``last_committed`` (exact, GIL-atomic), a supervisor heartbeat file's
  ``ckpt_path`` pointer (the cross-process contract of
  :mod:`~apex_tpu_torch.resilience.supervisor` — written strictly *after*
  commit, so the pointed-at
  step is always whole), or a raw root walk that skips steps the
  live-writer registry marks in flight
  (:func:`~apex_tpu_torch.resilience.checkpoint.in_flight_steps`).

- :class:`HotReloader` — the **double-buffered** reload: the candidate
  is restored through the existing validated path
  (:func:`~apex_tpu_torch.serving.weights.load_serving_params` — fused
  CRC validation, optional :class:`~apex_tpu_torch.resilience.retry.
  RetryPolicy` on transient I/O) into a *fresh* buffer that never aliases the
  serving params; a failed restore, a corrupt candidate, or a
  shape/dtype-incompatible tree leaves the engine serving the last
  good weights untouched.  The swap itself is
  :meth:`~apex_tpu_torch.serving.scheduler.ContinuousBatchingScheduler.
  swap_weights` at a step boundary: in-flight streams are preserved
  (decode state is weight-independent), the prefix cache is
  version-bumped (old-weights K/V can never resume a new-weights
  stream), and the displaced buffer is retained so :meth:`~HotReloader.
  rollback` can swap back by the same mechanism.  The engine enforces
  the same-spec contract (names, shapes, dtypes), leaves the KV cache
  and block tables where they are, and makes the same kernel launches a
  model call as before the swap.

- Shadow/A-B (:func:`assign_arm`, :class:`ShadowABScheduler`) — two
  weight versions behind one serving facade: a deterministic
  traffic-fraction mirror (seeded rid hash — stable across runs and
  processes) labels each request's arm; mirrored requests are COPIED
  to a shadow scheduler serving the candidate weights while their
  originals keep serving from the incumbent, so users only ever see
  incumbent output.  Per-arm SLO reports
  (:func:`~apex_tpu_torch.obs.slo.build_report` over the request-trace
  recorder's records) compare candidate vs incumbent before a
  promotion decision.

Chaos coverage drives the whole
lifecycle under :mod:`~apex_tpu_torch.resilience.fault_injection`: corrupt /
truncated candidates mid-reload, a :class:`SimulatedWriterCrash`
racing the watcher against a live ``AsyncCheckpointer``, and a reload
storm under 2x overload — every perturbation must leave the engine
serving the last-good weights with all streams intact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.resilience import checkpoint as _ckpt
from apex_tpu_torch.resilience.retry import RetryPolicy, retry_transient
from apex_tpu_torch.serving.weights import load_serving_params

__all__ = ["WeightWatcher", "HotReloader", "ReloadOutcome",
           "ABConfig", "ShadowABScheduler", "assign_arm"]

logger = get_logger("serving.reload")


def _step_of_ckpt_path(path: str) -> Optional[int]:
    """The step a committed checkpoint path names, or None — the
    heartbeat's ``ckpt_path`` is the cross-process committed pointer."""
    name = os.path.basename(os.path.normpath(path))
    if not name.startswith(_ckpt._STEP_PREFIX):
        return None
    try:
        return int(name[len(_ckpt._STEP_PREFIX):])
    except ValueError:
        return None


class WeightWatcher:
    """Poll for a newer committed checkpoint step than the one served.

    Exactly one source is used, by constructor argument:

    - ``checkpointer=`` — an in-process ``AsyncCheckpointer``; its
      ``last_committed`` property is set strictly after the atomic
      commit rename, so the returned step is always whole.
    - ``heartbeat_path=`` — a supervisor heartbeat file; its
      ``ckpt_path`` field points at the last *committed* checkpoint
      (written after commit by the training loop's heartbeat).  An
      unreadable / half-missing heartbeat is "nothing new", never an
      error: liveness files are best-effort by contract.
    - neither — walk ``root`` for the newest listed step, skipping
      steps the live-writer registry marks in flight (a re-save swaps
      the committed dir aside mid-commit; selecting it would race the
      writer).  Listing only ever sees committed ``step_*`` dirs —
      temp dirs are invisible by construction.

    ``poll()`` returns a step strictly newer than ``last_seen`` (or
    None); the reloader calls ``mark(step)`` after a successful swap so
    a refused candidate is re-offered every poll until it is repaired
    or superseded — a corrupt candidate must not wedge the watcher.
    """

    def __init__(self, root: str, *,
                 heartbeat_path: Optional[str] = None,
                 checkpointer: Any = None,
                 last_seen: Optional[int] = None):
        if heartbeat_path is not None and checkpointer is not None:
            raise ValueError("pass heartbeat_path= or checkpointer=, "
                             "not both — one committed-step source")
        self.root = root
        self.heartbeat_path = heartbeat_path
        self.checkpointer = checkpointer
        self.last_seen = last_seen
        self._polls = 0

    def committed_step(self) -> Optional[int]:
        """Newest committed step the source reports right now."""
        if self.checkpointer is not None:
            lc = self.checkpointer.last_committed
            return None if lc is None else int(lc[0])
        if self.heartbeat_path is not None:
            try:
                from apex_tpu_torch.resilience.supervisor import read_heartbeat

                hb = read_heartbeat(self.heartbeat_path)
            except (OSError, ValueError) as e:
                logger.debug("heartbeat unreadable: %s", e)
                return None
            path = hb.get("ckpt_path")
            return None if not path else _step_of_ckpt_path(str(path))
        live = _ckpt.in_flight_steps(self.root)
        committed = [s for s in _ckpt._list_steps(self.root)
                     if s not in live]
        return committed[-1] if committed else None

    def poll(self) -> Optional[int]:
        """A committed step strictly newer than ``last_seen``, or None."""
        self._polls += 1
        step = self.committed_step()
        if step is None:
            return None
        if self.last_seen is not None and step <= self.last_seen:
            return None
        return step

    def mark(self, step: int) -> None:
        """Record ``step`` as applied; later polls only report newer."""
        if self.last_seen is None or step > self.last_seen:
            self.last_seen = int(step)

    @property
    def polls(self) -> int:
        return self._polls


@dataclasses.dataclass
class ReloadOutcome:
    """One reload (or rollback) attempt's result + phase timings."""

    ok: bool
    step: Optional[int]          # step now served (ok) / refused (not)
    from_step: Optional[int]     # step served before the attempt
    version: int                 # engine weights_version after
    reason: Optional[str] = None       # refusal reason (ok=False)
    restore_s: float = 0.0
    validate_s: float = 0.0
    swap_s: float = 0.0
    rollback: bool = False


class HotReloader:
    """Double-buffered hot weight reload over one scheduler.

    >>> reloader = HotReloader(sched, root, like=train_state,
    ...                        params_key="params", watcher=watcher)
    >>> out = reloader.maybe_reload()      # at any step boundary
    >>> reloader.rollback()                # one-step undo, same swap

    The lifecycle invariants (each pinned by a test):

    - **Failed validate never serves.**  The candidate restores into a
      fresh buffer through the fused-validation path; any
      :class:`CheckpointError` (corrupt bytes, truncation, structure
      mismatch) or spec mismatch against the served tree refuses the
      swap with the serving params untouched — bit-exactly.
    - **Streams survive the swap.**  The swap happens through
      ``scheduler.swap_weights`` at a step boundary: active slots keep
      their KV cache / lengths / sampler state and continue under the
      new weights; nothing is dropped, and the post-swap tokens are
      bit-identical to a fresh engine booted on the new weights and
      fed the same state.
    - **Rollback is a swap.**  The displaced buffer is retained
      (double buffering — one previous version, the production
      playbook's one-step undo); ``rollback()`` swaps it back through
      the identical mechanism, prefix-cache invalidation included.
    - **Restore-ahead.**  :meth:`prefetch` stages the next candidate
      (restore + validate) off the serving path at any time; the
      matching ``reload()`` then pauses serving only for the pointer
      swap.  The staged buffer is a third, invisible buffer — staging
      never touches the serving or rollback params.

    ``retry`` (a :class:`RetryPolicy`) retries *transient* I/O during
    the restore; deterministic corruption propagates immediately into
    the refusal path.  ``like`` decides where the candidate lands: a
    template of tensors on the engine's card restores straight there, so
    the swap moves nothing.  ``shardings`` (a tp rank's
    :func:`~apex_tpu_torch.serving.engine.tp_param_shardings`, with
    ``like`` holding the rank's shard dict) restores only the rank's
    slice of each candidate, v1 or v2, and the swap replaces the rank's
    shard.
    """

    def __init__(self, scheduler, root: str, *, like: Any,
                 params_key: Optional[str] = None,
                 policy: Any = None,
                 shardings: Any = None,
                 retry: Optional[RetryPolicy] = None,
                 watcher: Optional[WeightWatcher] = None,
                 current_step: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.scheduler = scheduler
        self.engine = scheduler.engine
        self.root = root
        self.like = like
        self.params_key = params_key
        self.policy = policy
        self.retry = retry
        self.watcher = watcher if watcher is not None else WeightWatcher(
            root, last_seen=current_step)
        self._clock = clock
        self.shardings = shardings
        self._current_step = current_step
        self._previous: Optional[tuple] = None   # (params, step)
        self._staged: Optional[tuple] = None     # (params, step,
        #                                           restore_s, validate_s)
        self._reloads = 0
        self._refusals = 0
        self._prefetches = 0
        self._discarded_stages = 0
        # seed the scheduler's served-version tag so routed/finished
        # events carry the boot step from the first request on
        if current_step is not None and hasattr(scheduler,
                                                "weights_step"):
            scheduler.weights_step = int(current_step)

    # ---- introspection ---------------------------------------------------
    @property
    def current_step(self) -> Optional[int]:
        """Step of the weights being served (None = boot params of
        unknown step)."""
        return self._current_step

    @property
    def previous_step(self) -> Optional[int]:
        """Step of the retained rollback buffer, or None."""
        return self._previous[1] if self._previous is not None else None

    @property
    def can_rollback(self) -> bool:
        return self._previous is not None

    @property
    def staged_step(self) -> Optional[int]:
        """Step of the restore-ahead candidate staged by
        :meth:`prefetch`, or None when nothing is staged."""
        return self._staged[1] if self._staged is not None else None

    @property
    def stats(self) -> Dict[str, int]:
        return {"reloads": self._reloads, "refusals": self._refusals,
                "prefetches": self._prefetches,
                "discarded_stages": self._discarded_stages,
                "watcher_polls": self.watcher.polls}

    # ---- the lifecycle ---------------------------------------------------
    def maybe_reload(self) -> Optional[ReloadOutcome]:
        """Poll the watcher; reload if a newer committed step exists.
        Returns None when there is nothing new (the steady-state path:
        one cheap poll, zero device work, zero events)."""
        step = self.watcher.poll()
        if step is None:
            return None
        return self.reload(step=step)

    def _refuse(self, step: Optional[int], reason: str,
                restore_s: float, validate_s: float) -> ReloadOutcome:
        self._refusals += 1
        logger.warning("reload refused (step %s): %s", step, reason)
        emit_event("serving_reload_failed", step=step,
                   reason=reason[:500],
                   serving_step=self._current_step)
        return ReloadOutcome(
            ok=False, step=step, from_step=self._current_step,
            version=int(self.engine.weights_version), reason=reason,
            restore_s=restore_s, validate_s=validate_s)

    def prefetch(self, *, step: Optional[int] = None) -> Optional[int]:
        """Restore-ahead: stage the next candidate off the serving
        path, so the step-boundary :meth:`reload` pause is just the
        pointer swap (``swap_s``, ~1 ms) instead of being dominated by
        the restore (~tens of ms for even a small model).

        Restores and validates the candidate into a staged buffer
        right now (safe at any time — the serving params are never
        touched) and returns the staged step, or None when nothing
        could be staged (no committed step, restore failure, or spec
        mismatch — logged, not a formal refusal: nothing was offered
        for serving, and the later :meth:`reload` re-walks the full
        path and refuses first-class).  A later ``reload()`` whose
        target matches the staged step consumes the stage and skips
        straight to the swap; a non-matching target discards the stale
        stage and restores fresh.
        """
        if step is None:
            step = self.watcher.committed_step()
            if step is None:
                return None
        if (self._staged is not None
                and self._staged[1] == int(step)):
            return int(step)             # already staged — idempotent
        t0 = self._clock()

        def _restore():
            return load_serving_params(
                self.root, self.like, params_key=self.params_key,
                policy=self.policy, step=step, shardings=self.shardings)

        try:
            if self.retry is not None:
                candidate, got = retry_transient(
                    _restore, policy=self.retry, what="serving_reload")
            else:
                candidate, got = _restore()
        except Exception as e:
            logger.warning("prefetch failed (step %s): %s: %s",
                           step, type(e).__name__, e)
            return None
        restore_s = self._clock() - t0
        t1 = self._clock()
        mismatch = self._spec_mismatch(candidate)
        validate_s = self._clock() - t1
        if mismatch is not None:
            logger.warning("prefetch staged nothing (step %s): %s",
                           got, mismatch)
            return None
        self._staged = (candidate, int(got), restore_s, validate_s)
        self._prefetches += 1
        return int(got)

    def reload(self, *, step: Optional[int] = None) -> ReloadOutcome:
        """Restore → validate → swap, double-buffered.

        ``step`` pins the candidate (the watcher path); ``None`` takes
        the newest valid committed step.  Call at a step boundary only
        (between ``scheduler.step()`` calls — e.g. a loadgen
        ``step_hook``).  Never raises for a bad candidate: refusal is
        an outcome (``ok=False`` + a ``serving_reload_failed`` event),
        because the server must keep serving.

        When :meth:`prefetch` staged this exact step, the restore and
        validate phases were already paid off the serving path: the
        boundary pause here is only the swap.  The emitted timings
        keep the staged restore_s/validate_s (the work was real — it
        just didn't stall serving) plus ``prefetched=True``.
        """
        candidate = None
        prefetched = False
        if self._staged is not None:
            want = step if step is not None \
                else self.watcher.committed_step()
            if want is not None and int(want) == self._staged[1]:
                candidate, got, restore_s, validate_s = self._staged
                prefetched = True
            else:
                self._discarded_stages += 1
                logger.info("discarding stale stage (step %s): reload "
                            "target is %s", self._staged[1], want)
            self._staged = None          # consumed or stale either way

        if candidate is None:
            t0 = self._clock()

            def _restore():
                return load_serving_params(
                    self.root, self.like, params_key=self.params_key,
                    policy=self.policy, step=step,
                    shardings=self.shardings)

            try:
                if self.retry is not None:
                    candidate, got = retry_transient(
                        _restore, policy=self.retry,
                        what="serving_reload")
                else:
                    candidate, got = _restore()
            except Exception as e:
                # the double-buffer guarantee: the failure happened
                # entirely inside the candidate buffer — serving
                # params untouched
                return self._refuse(step, f"{type(e).__name__}: {e}",
                                    self._clock() - t0, 0.0)
            restore_s = self._clock() - t0

            # validation gate against the SERVED weights: names +
            # shape/dtype must match.  swap_params enforces this too —
            # checking here makes the refusal a first-class outcome instead of
            # an exception, and times the phase separately from the
            # pointer swap.
            t1 = self._clock()
            mismatch = self._spec_mismatch(candidate)
            validate_s = self._clock() - t1
            if mismatch is not None:
                return self._refuse(got, mismatch, restore_s,
                                    validate_s)

        t2 = self._clock()
        displaced = self.scheduler.swap_weights(candidate,
                                                step=int(got))
        swap_s = self._clock() - t2
        self._previous = (displaced, self._current_step)
        from_step = self._current_step
        self._current_step = int(got)
        self._reloads += 1
        self.watcher.mark(int(got))
        version = int(self.engine.weights_version)
        emit_event("serving_weights_swapped", step=int(got),
                   from_step=from_step, version=version, rollback=False,
                   prefetched=prefetched,
                   restore_s=round(restore_s, 6),
                   validate_s=round(validate_s, 6),
                   swap_s=round(swap_s, 6))
        return ReloadOutcome(ok=True, step=int(got), from_step=from_step,
                             version=version, restore_s=restore_s,
                             validate_s=validate_s, swap_s=swap_s)

    def rollback(self) -> ReloadOutcome:
        """Swap back to the retained previous buffer (step-boundary
        call, same mechanism as a reload's swap — prefix-cache
        invalidation included).  The displaced current buffer becomes
        the new rollback target, so rollback twice toggles."""
        if self._previous is None:
            raise RuntimeError("rollback() with no retained previous "
                               "weights — no reload has succeeded yet")
        if self._staged is not None:
            # the stage belongs to the version line being abandoned: a
            # later reload() consuming it would silently re-promote the
            # rolled-back direction.  Discard it, counted.
            self._discarded_stages += 1
            logger.info("rollback discards staged step %s",
                        self._staged[1])
            self._staged = None
        params, prev_step = self._previous
        t0 = self._clock()
        displaced = self.scheduler.swap_weights(params, step=prev_step)
        swap_s = self._clock() - t0
        from_step = self._current_step
        self._previous = (displaced, from_step)
        self._current_step = prev_step
        version = int(self.engine.weights_version)
        # no restore_s/validate_s: a rollback restores nothing, and the
        # bridge must not observe fabricated 0.0 phase samples
        emit_event("serving_weights_swapped", step=prev_step,
                   from_step=from_step, version=version, rollback=True,
                   swap_s=round(swap_s, 6))
        return ReloadOutcome(ok=True, step=prev_step, from_step=from_step,
                             version=version, swap_s=swap_s,
                             rollback=True)

    def _spec_mismatch(self, candidate: Any) -> Optional[str]:
        """None when ``candidate`` is swap-compatible with the served
        params, else the human-readable refusal reason.  An int8 engine
        compares a float candidate in its quantized layout, as its
        ``swap_params`` would take it (the names change; the check is of
        the names and of each tensor's shape and dtype)."""
        served = self.engine.params
        try:
            cand = dict(candidate)
        except (TypeError, ValueError):
            return (f"candidate is a {type(candidate).__name__}, not a "
                    f"state_dict")
        quant = getattr(self.engine, "quant", None)
        if (quant is not None and quant.weights
                and set(cand) != set(served)):
            from apex_tpu_torch.serving.quant import quantize_state_dict

            cand = quantize_state_dict(
                {k: v.to("meta") for k, v in cand.items()})
        if set(cand) != set(served):
            missing = sorted(set(served) - set(cand))[:5]
            extra = sorted(set(cand) - set(served))[:5]
            return (f"candidate names differ from served params "
                    f"(missing {missing}, unexpected {extra})")
        for i, (name, o) in enumerate(served.items()):
            n = cand[name]
            if tuple(o.shape) != tuple(n.shape) or o.dtype != n.dtype:
                return (f"leaf {i} ({name}): candidate "
                        f"{tuple(n.shape)}/{n.dtype} vs "
                        f"served {tuple(o.shape)}/{o.dtype}")
        return None


# --------------------------------------------------------------------------
# shadow / A-B serving
# --------------------------------------------------------------------------


def assign_arm(rid: str, *, fraction: float, seed: int = 0) -> bool:
    """Deterministic traffic-fraction mirror decision: True == this rid
    is mirrored to the candidate arm.  A seeded blake2b hash of the rid
    maps to ``[0, 1)`` and compares against ``fraction`` — stable
    across runs, processes, and submission order (the property the
    seed-deterministic A/B acceptance pins), with no shared RNG state
    to race."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    digest = hashlib.blake2b(f"{seed}:{rid}".encode(),
                             digest_size=8).digest()
    u = int.from_bytes(digest, "big") / 2.0 ** 64
    return u < fraction


@dataclasses.dataclass(frozen=True)
class ABConfig:
    """Shadow/A-B mirror configuration.

    ``fraction`` of requests (deterministically chosen by
    :func:`assign_arm` under ``seed``) are mirrored: the original keeps
    serving from the incumbent scheduler — users only ever see
    incumbent output — while a copy with rid ``mirror_prefix + rid``
    runs on the shadow scheduler's candidate weights.  Per-arm SLO
    reports then compare the two on identical traffic."""

    fraction: float = 0.1
    seed: int = 0
    mirror_prefix: str = "shadow:"

    def __post_init__(self):
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"fraction must be in [0, 1], got {self.fraction}")
        if not self.mirror_prefix:
            raise ValueError("mirror_prefix must be non-empty (mirror "
                             "rids must be distinguishable)")


class ShadowABScheduler:
    """Two weight versions behind one serving facade.

    Duck-types the scheduler surface a :class:`~apex_tpu_torch.serving.
    loadgen.LoadGenerator` drives (``submit`` / ``step`` /
    ``queue_depth`` / ``active_count`` / ``suspended_count`` /
    ``results`` / ``clock``), delegating to the *primary* (incumbent)
    scheduler; mirrored submissions are copied to the *shadow*
    scheduler (candidate weights), which is stepped in the same
    boundary.  Both schedulers must share one clock object (the
    virtual-clock determinism contract); the facade checks.

    Shed semantics: a full primary queue raises ``QueueFull`` exactly
    like a plain scheduler (open-loop loadgen sheds it); a full
    *shadow* queue silently drops only the mirror copy (shadow traffic
    must never degrade incumbent service) and counts it in
    ``mirror_shed``.
    """

    def __init__(self, primary, shadow, config: ABConfig):
        if primary.clock is not shadow.clock:
            raise ValueError(
                "primary and shadow schedulers must share one clock "
                "object — construct both with the same (virtual) clock "
                "so mirrored timing is comparable")
        if primary is shadow or primary.engine is shadow.engine:
            raise ValueError("primary and shadow must be distinct "
                             "schedulers over distinct engines (two "
                             "weight buffers)")
        self.primary = primary
        self.shadow = shadow
        self.config = config
        self._mirrored: List[str] = []     # rids mirrored, in order
        self._mirror_shed = 0

    # ---- the LoadGenerator-facing surface --------------------------------
    @property
    def clock(self):
        return self.primary.clock

    @property
    def engine(self):
        return self.primary.engine

    # pending-work counts cover BOTH arms: a LoadGenerator (or any
    # drain loop) polling them must keep stepping until the shadow's
    # mirror streams finish too, or the candidate arm's records would
    # be truncated mid-flight
    @property
    def queue_depth(self) -> int:
        return self.primary.queue_depth + self.shadow.queue_depth

    @property
    def active_count(self) -> int:
        return self.primary.active_count + self.shadow.active_count

    @property
    def suspended_count(self) -> int:
        return (self.primary.suspended_count
                + self.shadow.suspended_count)

    @property
    def steps_run(self) -> int:
        return self.primary.steps_run

    @property
    def results(self):
        return self.primary.results

    def pop_result(self, rid: str):
        return self.primary.pop_result(rid)

    def pop_results(self):
        return self.primary.pop_results()

    def submit(self, request) -> None:
        """Submit to the incumbent; mirror a deterministic fraction to
        the shadow.  ``QueueFull`` propagates from the PRIMARY submit
        only, and only after any mirror copy was decided — the arm
        assignment is a pure rid hash, so a shed request sheds in both
        arms identically."""
        mirrored = assign_arm(request.rid, fraction=self.config.fraction,
                              seed=self.config.seed)
        self.primary.submit(request)        # may raise QueueFull
        if mirrored:
            self._mirrored.append(request.rid)
            copy = dataclasses.replace(
                request, rid=self.config.mirror_prefix + request.rid)
            try:
                self.shadow.submit(copy)
            except Exception as e:
                # shadow capacity must never hurt incumbent service:
                # drop the mirror, keep the original
                self._mirror_shed += 1
                logger.debug("mirror %s shed: %s", copy.rid, e)

    def step(self) -> List[str]:
        """One facade step: primary first (user-visible service), then
        the shadow if it has work.  Returns the PRIMARY's finished rids
        — shadow completions are never user-visible."""
        out = self.primary.step()
        if (self.shadow.queue_depth or self.shadow.active_count
                or self.shadow.suspended_count):
            self.shadow.step()
        return out

    def run(self, max_steps: Optional[int] = None):
        """Drain both arms; returns the primary's results."""
        steps = 0
        bound = max_steps if max_steps is not None else (
            self.primary._derived_step_bound()
            + self.shadow._derived_step_bound())
        while (self.primary.queue_depth or self.primary.active_count
               or self.primary.suspended_count
               or self.shadow.queue_depth or self.shadow.active_count
               or self.shadow.suspended_count):
            if steps >= bound:
                raise RuntimeError(
                    f"A/B drain stalled after {steps} steps")
            self.step()
            steps += 1
        return self.primary.results

    # ---- per-arm accounting ----------------------------------------------
    @property
    def mirrored_rids(self) -> List[str]:
        """Rids assigned to the mirror (submission order)."""
        return list(self._mirrored)

    @property
    def mirror_shed(self) -> int:
        return self._mirror_shed

    def arm_of(self, rid: str) -> str:
        """``"candidate"`` for a mirror-copy rid, ``"incumbent"`` for a
        mirrored original, ``"unmirrored"`` otherwise."""
        if rid.startswith(self.config.mirror_prefix):
            return "candidate"
        return ("incumbent" if rid in set(self._mirrored)
                else "unmirrored")

    def arm_records(self, records) -> Dict[str, list]:
        """Partition request-trace records by arm: ``candidate`` =
        shadow mirror copies, ``incumbent`` = their primary originals —
        the SAME traffic on both weight versions, which is what makes
        the per-arm comparison fair.  Unmirrored records are excluded
        from both arms."""
        mirrored = set(self._mirrored)
        prefix = self.config.mirror_prefix
        out: Dict[str, list] = {"incumbent": [], "candidate": []}
        for rec in records:
            rid = rec.rid
            if rid.startswith(prefix) and rid[len(prefix):] in mirrored:
                out["candidate"].append(rec)
            elif rid in mirrored:
                out["incumbent"].append(rec)
        return out

    def arm_reports(self, records, *,
                    deadlines: Optional[Dict[str, Optional[float]]] = None,
                    arrivals: Optional[Dict[str, float]] = None,
                    duration_s: Optional[float] = None) -> Dict[str, Any]:
        """Per-arm :class:`~apex_tpu_torch.obs.slo.SLOReport` over the SAME
        mirrored traffic: candidate vs incumbent, the promotion
        comparison.  ``deadlines``/``arrivals`` are keyed by ORIGINAL
        rid (e.g. straight from a ``LoadgenResult``); the candidate
        arm's mirror rids are mapped back automatically."""
        from apex_tpu_torch.obs.slo import build_report

        arms = self.arm_records(records)
        prefix = self.config.mirror_prefix

        def base_rid(rid: str) -> str:
            return rid[len(prefix):] if rid.startswith(prefix) else rid

        reports = {}
        for arm, recs in arms.items():
            dl = (None if deadlines is None
                  else {r.rid: deadlines.get(base_rid(r.rid))
                        for r in recs})
            ar = (None if arrivals is None
                  else {r.rid: arrivals[base_rid(r.rid)] for r in recs
                        if base_rid(r.rid) in arrivals})
            reports[arm] = build_report(
                recs, offered=len(recs), deadlines=dl, arrivals=ar,
                duration_s=duration_s)
        return reports
