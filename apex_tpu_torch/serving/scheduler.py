"""Continuous batching: a host loop that keeps decode slots full.

Counterpart of ``apex_tpu/serving/scheduler.py``:

- **Bounded queue**: :meth:`~ContinuousBatchingScheduler.submit` rejects
  past ``max_queue`` with :class:`QueueFull`.
- **Slot admission**: at each step, free slots are filled from the queue
  in FIFO order.
- **Prefill/decode interleaving**: each step spends at most
  ``prefill_budget`` prompt tokens on chunks (oldest admitted request
  first), then runs one shared decode step for every decoding slot;
  mid-prefill slots ride that step as inactive lanes.
- **Per-request state machine**: QUEUED -> PREFILL -> DECODE -> DONE,
  with eviction on EOS or ``max_new_tokens`` and immediate slot reuse.
- **Paged engines** (``DecodeEngine(paged=...)``): admission is priced
  in pool blocks.  :meth:`~ContinuousBatchingScheduler.submit` refuses a
  request whose worst case (``prompt + max_new_tokens - 1`` rows, no
  sharing) exceeds the whole pool, and a queued request waits while its
  worst case exceeds the free blocks less what admitted streams still
  reserve for their own growth, plus what prefix-cache eviction could
  free.
- **Prefix caching** (``prefix_caching=PrefixCacheConfig(...)``): at
  admission the prompt's longest cached block chain
  (:mod:`~apex_tpu_torch.serving.prefix_cache`) is restored into the
  fresh slot (dense: ``restore_prefix``; paged: ``alias_prefix``, no
  copy) and prefill resumes past it.  After every prefill chunk the
  prompt blocks it completed are offered to the cache (dense: one
  ``read_region`` of the new blocks; paged: their pool block ids, by
  reference), pinned until the prompt is cached.  On a paged engine the
  pool's reclaim hook evicts unpinned cache entries before an allocation
  would fail; :meth:`~ContinuousBatchingScheduler.close` clears the cache
  and takes the hook down again.
- **Speculation** (``speculation=SpeculationConfig(...)``): greedy
  requests draft up to k tokens a step by prompt lookup
  (:mod:`~apex_tpu_torch.serving.draft`) and verify them in one forward
  (:meth:`~apex_tpu_torch.serving.engine.DecodeEngine.verify_draft`),
  emitting the accepted prefix plus a bonus token.  The draft length
  adapts per request; slots with no match ride the batched decode step,
  and sampled requests never draft.
- **Control plane** (``policy=SchedulingPolicy(...)``,
  :mod:`~apex_tpu_torch.serving.policy`): priority admission with
  lossless preemption of a strictly lower-priority DECODE stream (dense:
  ``capture_slot`` to host memory, resumed by ``restore_prefix``; paged:
  block references held across the release, resumed by
  ``alias_prefix``), deadline shedding at every step boundary, and
  weighted round-robin across tenants with in-flight caps.
  :meth:`~ContinuousBatchingScheduler.cancel` works with or without a
  policy.  ``RequestResult.finish_reason`` is one of ``eos``, ``length``,
  ``cancelled``, ``shed`` and ``preempted-resumed``; :data:`SERVED_REASONS`
  names those that delivered the whole stream.
- **Failover**: :meth:`~ContinuousBatchingScheduler.export_streams` moves
  every live stream out as a :class:`StreamExport`, and
  :meth:`~ContinuousBatchingScheduler.adopt_stream` takes one in on
  another scheduler (a dense capture restored mid-stream, or the bare
  request requeued).
- **Hot weight swap**: :meth:`~ContinuousBatchingScheduler.swap_weights`
  at a step boundary (the surface of :mod:`~apex_tpu_torch.serving.
  reload`): in-flight streams continue under the new weights, the prefix
  cache's version is bumped so no pre-swap K/V feeds a later admission,
  and a stream admitted before the swap never offers its (hybrid) blocks.
  :attr:`~ContinuousBatchingScheduler.weights_step` rides the stream
  exports and the finished events.

Sampling draws from per-request seeds (see
:meth:`~apex_tpu_torch.serving.engine.DecodeEngine.sample`); the clock
(``clock=``, ``time.monotonic`` by default) feeds the latency fields and
deadlines only, never token choice.  Preemption keeps a stream's token
count, so its draws are the same after a resume.

- **Telemetry**: every ``serving_*`` event of the JAX scheduler, with its
  payload, at the same step boundary, through
  :func:`~apex_tpu_torch._logging.emit_event` (the obs bridge turns them
  into metrics; a :class:`~apex_tpu_torch.obs.RequestTraceRecorder` into
  per-request records); ``serving_step`` every ``log_interval`` steps.
  The current-state gauges of :mod:`apex_tpu_torch.obs.bridge` (queue
  depth, slot occupancy, cache utilization, prefill backlog, and with
  their features prefix cached tokens, block-pool utilization, tenant
  in-flight and speculation speedup) are set every step.  ``name=``
  stamps ``replica`` on every event and mirrors the gauges into
  ``{replica=name}`` series.  Every field comes from host state the
  scheduler already holds: telemetry reads nothing from the device.  Two
  departures from the JAX scheduler: a verify that finishes its request
  emits ``serving_spec_verify`` before the ``serving_request_finished``
  it causes (the JAX scheduler emits them the other way round, so its
  request-trace recorder drops that verify), and
  ``apex_serving_decode_compiles`` is never set (nothing here compiles).
  :meth:`~ContinuousBatchingScheduler.stats` (prefix hits, misses, saved
  tokens), :attr:`~ContinuousBatchingScheduler.spec_stats` and
  :attr:`~ContinuousBatchingScheduler.control_stats` keep the same counts.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.obs import bridge as obs_bridge
from apex_tpu_torch.serving.draft import SpeculationConfig, adapt_k, propose
from apex_tpu_torch.serving.engine import DecodeEngine
from apex_tpu_torch.serving.paged_kv_cache import (
    blocks_per_slot,
    bytes_per_block,
)
from apex_tpu_torch.serving.policy import SchedulingPolicy, WeightedRoundRobin
from apex_tpu_torch.serving.prefix_cache import PrefixCache, PrefixCacheConfig

__all__ = ["Request", "RequestPhase", "RequestResult", "QueueFull",
           "SchedulerStalled", "SERVED_REASONS", "StreamExport",
           "ContinuousBatchingScheduler"]

#: finish reasons that delivered the request's whole token stream; a
#: cancelled or shed request finished without the service it asked for
SERVED_REASONS = frozenset({"eos", "length", "preempted-resumed"})


class QueueFull(RuntimeError):
    """The bounded request queue is at capacity — apply backpressure."""


class SchedulerStalled(RuntimeError):
    """``run()`` exceeded its progress bound with work still pending."""


class RequestPhase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``temperature <= 0`` is greedy;
    ``top_k <= 0`` means no truncation; ``eos_id=None`` runs to
    ``max_new_tokens``.

    The control-plane fields act only under a ``policy=``: ``priority``
    (higher admits first and may preempt strictly lower), ``deadline_s``
    (completion deadline from submission; an expired queued request is
    shed) and ``tenant`` (the fairness bucket)."""

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None
    tenant: str = "default"


@dataclasses.dataclass
class RequestResult:
    """A finished stream and its latencies (on the scheduler's clock)."""

    rid: str
    tokens: List[int]
    # "eos" | "length" | "cancelled" | "shed" | "preempted-resumed" (the
    # last: finished normally after >= 1 lossless preemption)
    finish_reason: str
    ttft_s: float                      # submit -> first token (NaN if none)
    total_s: float                     # submit -> finished
    tokens_per_s: float
    preemptions: int = 0               # lossless preempt/resume cycles


@dataclasses.dataclass
class _Active:
    request: Request
    slot: int
    seq: int                 # admission order (FIFO prefill priority)
    tokens: List[int]
    t_submit: float
    t_first: float = 0.0
    prompt_pos: int = 0      # prompt tokens cached so far
    phase: RequestPhase = RequestPhase.PREFILL
    draft_k: int = 0         # adaptive draft length (speculation only)
    # prefix caching: the chain hash of the last prompt block this
    # request matched or offered, how many blocks that is, and the
    # entries pinned for it until its prompt is cached
    chain: str = PrefixCache.ROOT
    blocks_cached: int = 0
    pinned: List = dataclasses.field(default_factory=list)
    preemptions: int = 0     # lossless suspend/resume cycles survived
    wv: int = 0              # engine weights_version at admission

    @property
    def prompt_remaining(self) -> int:
        return len(self.request.prompt) - self.prompt_pos


@dataclasses.dataclass
class StreamExport:
    """One live stream in portable form, made by
    :meth:`ContinuousBatchingScheduler.export_streams` and taken by
    :meth:`ContinuousBatchingScheduler.adopt_stream` on another scheduler.

    With ``kv`` (a dense engine's DECODE stream, exported with
    ``capture=True``) the captured cache rows travel with the stream and
    adoption restores it mid-stream.  Without (``capture=False``, a
    mid-prefill stream, a queued request, any stream of a paged engine,
    whose blocks belong to its own pool) adoption requeues the bare
    request under its original submit stamp, and the stream is computed
    again from its seed."""

    request: Request
    t_submit: float                   # original submit stamp, preserved
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_first: float = 0.0
    preemptions: int = 0
    length: int = 0                   # cached rows at capture
    kv: Optional[tuple] = None        # dense (k, v) CPU tensors
    # checkpoint step the donor served at export (None = unknown).  A
    # capture is only faithful on an adopter serving the same step: the
    # fleet router requeues a cross-version capture bare, so no stream
    # decodes a hybrid of two weight versions
    weights_step: Optional[int] = None


@dataclasses.dataclass
class _Suspended:
    """A preempted DECODE stream awaiting resume: the frozen host state
    and the captured cache (dense: host K/V; paged: the held block
    references, whose bytes never moved)."""

    st: _Active
    length: int                               # cached rows at capture
    kv: Optional[tuple] = None                # dense: (k, v) CPU tensors
    block_ids: Optional[List[int]] = None     # paged: referenced blocks
    t_suspended: float = 0.0


class ContinuousBatchingScheduler:
    """Continuous batching over one :class:`DecodeEngine`.

    >>> sched = ContinuousBatchingScheduler(engine, max_queue=64)
    >>> sched.submit(Request("r0", prompt, max_new_tokens=32, eos_id=2))
    >>> results = sched.run()          # drain queue + all active slots

    ``prefill_budget`` is the prompt-token cap per :meth:`step` (default
    ``engine.prefill_len``, one full chunk).  ``prefix_caching`` turns on
    the cross-request prefix cache (:attr:`prefix_cache`); its block size
    defaults to the engine's smallest prefill bucket, and on a paged
    engine is the pool's block size (an entry is a pool block there).
    ``speculation`` and ``policy`` are as in the module docstring; without
    them the scheduler is the FIFO one.  ``clock`` stamps every latency
    and deadline (a :class:`~apex_tpu_torch.serving.loadgen.VirtualClock`
    makes them exact).  ``log_interval`` is the period, in steps, of the
    ``serving_step`` event; ``name`` makes this scheduler a named replica:
    every event carries ``replica=name`` and the per-step gauges get a
    ``{replica=name}`` series beside the unlabeled one.
    """

    def __init__(self, engine: DecodeEngine, *, max_queue: int = 64,
                 log_interval: int = 32,
                 prefill_budget: Optional[int] = None,
                 speculation: Optional[SpeculationConfig] = None,
                 prefix_caching: Optional[PrefixCacheConfig] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 name: Optional[str] = None):
        if name is not None and (not isinstance(name, str) or not name):
            raise ValueError(
                f"scheduler name must be a non-empty string (it becomes "
                f"the bounded 'replica' metric label), got {name!r}")
        if prefill_budget is None:
            prefill_budget = engine.prefill_len
        if prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1 token per "
                             f"step, got {prefill_budget}")
        if (speculation is not None
                and speculation.max_draft > engine.max_draft):
            raise ValueError(
                f"speculation.max_draft {speculation.max_draft} exceeds "
                f"the engine's draft bucket table (max {engine.max_draft})"
                f" — widen draft_buckets or narrow the config")
        self.engine = engine
        self.name = name
        if name is not None:
            obs_bridge.register_replica(name)
        self.max_queue = int(max_queue)
        self.log_interval = max(1, int(log_interval))
        self.prefill_budget = int(prefill_budget)
        self.speculation = speculation
        self.policy = policy
        self._wrr = WeightedRoundRobin(policy) if policy is not None else None
        self._clock = clock
        self._queue: deque = deque()
        self._active: Dict[int, _Active] = {}
        self._suspended: List[_Suspended] = []
        self._results: Dict[str, RequestResult] = {}
        # every rid queued, active, suspended or holding an unclaimed
        # result (pop_result frees it)
        self._live_rids: set = set()
        self._admit_seq = 0
        self._step_index = 0
        self._paged = engine.block_pool is not None
        self._reclaim_hook = None
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_caching is not None:
            self.prefix_cache = self._make_prefix_cache(prefix_caching)
        # what the JAX scheduler's events carry, counted
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_saved_tokens = 0
        self._spec = dict(dispatches=0, drafted=0, accepted=0, emitted=0)
        self._control = dict(preempted=0, resumed=0, cancelled=0, shed=0)
        # every tenant seen under a policy: the in-flight gauge reads 0
        # for one with nothing in flight
        self._tenants_seen: set = set()
        # checkpoint step of the weights served (None: unknown): set by
        # swap_weights(step=) and seeded by the HotReloader at boot
        self.weights_step: Optional[int] = None

    def _emit(self, kind: str, **fields) -> None:
        """Every serving event this scheduler emits, stamped with
        ``replica`` when the scheduler is named."""
        if self.name is not None:
            fields["replica"] = self.name
        emit_event(kind, **fields)

    def _make_prefix_cache(self, config: PrefixCacheConfig) -> PrefixCache:
        engine = self.engine
        if self._paged:
            block = engine.block_size
            if config.block_size is not None and config.block_size != block:
                raise ValueError(
                    f"prefix block_size {config.block_size} != the "
                    f"engine's pool block_size {block} — a paged cache "
                    f"entry IS a pool block, so the sizes cannot differ")
        else:
            block = (config.block_size if config.block_size is not None
                     else engine.prefill_buckets[0])
        if block > engine.max_len - 1:
            raise ValueError(
                f"prefix block_size {block} cannot fit a "
                f"max_len={engine.max_len} cache alongside the resume "
                f"token")
        if not self._paged:
            return PrefixCache(block_size=block,
                               max_tokens=config.max_tokens)
        cache = PrefixCache(block_size=block, max_tokens=config.max_tokens,
                            pool=engine.block_pool,
                            bytes_per_block=bytes_per_block(engine.cache))
        # last-resort backpressure: an exhausted pool evicts unpinned
        # cache entries before it raises.  The bound method is stored, so
        # close() can tell its own hook from a later scheduler's (a bound
        # method fetched again is a new object)
        self._reclaim_hook = cache.evict_blocks
        engine.set_block_reclaim(self._reclaim_hook)
        return cache

    # ---- submission ------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Enqueue; raises :class:`QueueFull` at ``max_queue`` and
        ``ValueError`` for requests the engine can never serve."""
        rid = request.rid
        if rid in self._live_rids:
            raise ValueError(
                f"duplicate rid {rid!r}: already "
                f"{'finished' if rid in self._results else 'in flight'}")
        n = len(request.prompt)
        if request.max_new_tokens < 1:
            raise ValueError(f"{rid}: max_new_tokens must be >= 1 "
                             f"(got {request.max_new_tokens})")
        if n < 1:
            raise ValueError(f"{rid}: empty prompt")
        if request.deadline_s is not None and request.deadline_s <= 0:
            raise ValueError(
                f"{rid}: deadline_s must be > 0 (or None), got "
                f"{request.deadline_s} — an already-expired deadline is a "
                f"caller bug, not a sheddable request")
        if not request.tenant:
            raise ValueError(f"{rid}: tenant must be a non-empty string")
        # the final sampled token is never appended, so a stream may fill
        # the cache exactly
        if n + request.max_new_tokens - 1 > self.engine.max_len:
            raise ValueError(
                f"{rid}: prompt {n} + max_new_tokens "
                f"{request.max_new_tokens} needs "
                f"{n + request.max_new_tokens - 1} cached positions, over "
                f"cache max_len {self.engine.max_len}")
        if self._paged:
            # the paged form of the max_len guard: a stream whose worst
            # case (no sharing) exceeds the whole pool could stall every
            # other stream before failing at BlockPoolExhausted
            bs = self.engine.block_size
            need = blocks_per_slot(n + request.max_new_tokens - 1, bs)
            usable = self.engine.block_pool.num_blocks - 1
            if need > usable:
                raise ValueError(
                    f"{rid}: worst-case footprint of {need} blocks "
                    f"(block_size {bs}) exceeds the whole pool ({usable} "
                    f"allocatable blocks) — raise num_blocks or shrink "
                    f"the request")
        if len(self._queue) >= self.max_queue:
            raise QueueFull(f"queue at capacity ({self.max_queue})")
        self._queue.append((request, self._clock()))
        self._live_rids.add(rid)
        if self.policy is not None:
            self._tenants_seen.add(request.tenant)
        self._emit("serving_request_queued", rid=rid, prompt_tokens=n,
                   queue_depth=len(self._queue))

    # ---- introspection ---------------------------------------------------
    @property
    def clock(self) -> Callable[[], float]:
        """The clock every latency and deadline is measured on; the load
        generator reads this one too."""
        return self._clock

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def active_slots(self) -> Dict[int, str]:
        """Slot -> rid of every admitted request."""
        return {slot: st.request.rid for slot, st in self._active.items()}

    @property
    def steps_run(self) -> int:
        return self._step_index

    @property
    def queued_rids(self) -> List[str]:
        """Rids waiting for admission, in arrival order."""
        return [r.rid for r, _ in self._queue]

    @property
    def active_rids(self) -> List[str]:
        """Rids holding a slot, in slot order."""
        return [self._active[s].request.rid for s in sorted(self._active)]

    @property
    def suspended_count(self) -> int:
        """Preempted streams parked for resume."""
        return len(self._suspended)

    @property
    def spec_stats(self) -> Dict[str, int]:
        """Speculation so far: verify ``dispatches``, ``drafted`` and
        ``accepted`` draft tokens, ``emitted`` tokens (accepted + one
        bonus a verify).  All zero when speculation is off or bypassed."""
        return dict(self._spec)

    @property
    def control_stats(self) -> Dict[str, int]:
        """Control plane so far: ``preempted`` / ``resumed`` cycles,
        ``cancelled`` requests, ``shed`` deadline evictions.  All zero
        without a policy and without :meth:`cancel` calls."""
        return dict(self._control)

    def stats(self) -> Dict[str, int]:
        """Prefix-cache hits, misses and saved prompt tokens of the
        requests admitted so far (zeros without prefix caching)."""
        return {"prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_saved_tokens": self.prefix_saved_tokens}

    def _find(self, rid: str):
        """The live ``_Active`` of ``rid`` (slot-held or suspended)."""
        for st in self._active.values():
            if st.request.rid == rid:
                return st
        for sus in self._suspended:
            if sus.st.request.rid == rid:
                return sus.st
        return None

    def progress_of(self, rid: str) -> int:
        """Tokens emitted so far for ``rid``: the live count while active
        or suspended, the result's once finished, 0 while queued or
        unknown."""
        result = self._results.get(rid)
        if result is not None:
            return len(result.tokens)
        st = self._find(rid)
        return 0 if st is None else len(st.tokens)

    def phase_of(self, rid: str) -> RequestPhase:
        """``rid``'s phase (DECODE while suspended; QUEUED when unknown)."""
        if rid in self._results:
            return RequestPhase.DONE
        st = self._find(rid)
        return RequestPhase.QUEUED if st is None else st.phase

    @property
    def prefill_backlog(self) -> int:
        """Prompt tokens not yet cached: admitted requests' remainders
        plus every queued prompt."""
        return (sum(st.prompt_remaining for st in self._active.values()
                    if st.phase is RequestPhase.PREFILL)
                + sum(len(r.prompt) for r, _ in self._queue))

    # ---- admission -------------------------------------------------------
    def _paged_available(self) -> int:
        """Blocks an admission may claim: free pool blocks, less what the
        admitted streams still reserve for their worst-case growth
        (blocks are allocated lazily), plus what prefix-cache eviction
        could free."""
        bs = self.engine.block_size
        reserved = 0
        for st in self._active.values():
            rows = len(st.request.prompt) + st.request.max_new_tokens - 1
            owned = self.engine.block_pool.owned_blocks(st.slot)
            reserved += max(blocks_per_slot(rows, bs) - owned, 0)
        return self.engine.free_blocks() - reserved + (
            self.prefix_cache.evictable_blocks()
            if self.prefix_cache is not None else 0)

    def _free_slots(self) -> List[int]:
        return [s for s in self.engine.free_slots() if s not in self._active]

    def _paged_fits(self, request: Request, held: int = 0) -> bool:
        """Whether a paged admission of ``request`` (holding ``held``
        blocks already) fits; always on a dense or idle engine, so a pool
        too small fails loudly at allocation instead of stalling."""
        if not (self._paged and self._active):
            return True
        need = blocks_per_slot(
            len(request.prompt) + request.max_new_tokens - 1,
            self.engine.block_size) - held
        return need <= self._paged_available()

    def _draft_k(self, request: Request) -> int:
        """A new stream's draft length: the widest for a greedy request
        under speculation, 0 (never drafts) otherwise."""
        if self.speculation is None or request.temperature > 0:
            return 0
        return self.speculation.max_draft

    def _admit_request(self, request: Request, t_submit: float,
                       slot: int) -> None:
        """Bind ``request`` to ``slot`` and restore its longest cached
        prefix (the FIFO and policy paths both admit here)."""
        st = _Active(request=request, slot=slot, seq=self._admit_seq,
                     tokens=[], t_submit=t_submit,
                     draft_k=self._draft_k(request),
                     wv=self.engine.weights_version)
        self._active[slot] = st
        self._admit_seq += 1
        self._emit("serving_request_admitted", rid=request.rid, slot=slot,
                   prompt_tokens=len(request.prompt),
                   queue_depth=len(self._queue),
                   queue_wait_s=round(self._clock() - t_submit, 6))
        if self.prefix_cache is not None:
            self._match_and_restore(st)

    def _admit(self) -> None:
        """Fill free slots from the queue (FIFO); with a policy,
        :meth:`_admit_policy` chooses.  Admission assigns a slot (and
        restores the longest cached prefix); :meth:`_prefill_work` caches
        the rest of the prompt under the per-step budget.  On a paged
        engine the next request waits while its worst case exceeds
        :meth:`_paged_available`."""
        if self.policy is not None:
            self._admit_policy()
            return
        while self._queue:
            free = self._free_slots()
            if not free or not self._paged_fits(self._queue[0][0]):
                break
            request, t_submit = self._queue.popleft()
            self._admit_request(request, t_submit, free[0])

    # ---- the control plane -------------------------------------------------
    def _tenant_inflight(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for st in self._active.values():
            t = st.request.tenant
            counts[t] = counts.get(t, 0) + 1
        return counts

    def _pick_victim(self, priority: int) -> Optional[_Active]:
        """The stream a ``priority`` admission may evict: the lowest
        priority DECODE stream strictly below ``priority``, the youngest
        admission among equals.  Mid-prefill streams are never
        preempted."""
        victims = [st for st in self._active.values()
                   if st.phase is RequestPhase.DECODE
                   and st.request.priority < priority]
        if not victims:
            return None
        return min(victims, key=lambda st: (st.request.priority, -st.seq))

    def _preempt(self, st: _Active, *, by_priority: int) -> None:
        """Evict an active DECODE stream losslessly: capture its cache
        (dense: ``capture_slot`` to host memory; paged: one reference on
        each of its blocks, no bytes move), release the slot, and park
        the stream."""
        slot = st.slot
        length = int(self.engine.lengths()[slot])
        sus = _Suspended(st=st, length=length, t_suspended=self._clock())
        if self._paged:
            # hold the blocks across the release: the slot's references
            # drop, ours keep the bytes; the surplus a verify's rollback
            # left past the length goes back to the pool
            ids = self.engine.slot_block_ids(slot)[
                :blocks_per_slot(length, self.engine.block_size)]
            self.engine.block_pool.ref(ids)
            sus.block_ids = ids
        else:
            k, v, _ = self.engine.capture_slot(slot)
            sus.kv = (k, v)
        self._active.pop(slot)
        self.engine.release(slot)
        st.slot = -1
        st.preemptions += 1
        self._suspended.append(sus)
        self._control["preempted"] += 1
        self._emit("serving_request_preempted", rid=st.request.rid,
                   slot=slot, priority=st.request.priority,
                   by_priority=by_priority, new_tokens=len(st.tokens),
                   cached_tokens=length)

    def _resume(self, sus: _Suspended, slot: int) -> None:
        """Put a suspended stream back into a free slot: dense, the
        captured rows written back (``restore_prefix``); paged, the held
        blocks aliased, then the suspension hold dropped, or every later
        append would copy on write against a phantom sharer."""
        st = sus.st
        if self._paged:
            self.engine.alias_prefix(slot, sus.block_ids, sus.length)
            self.engine.block_pool.deref(sus.block_ids)
        else:
            self.engine.restore_prefix(slot, sus.kv, sus.length)
        sus.kv = sus.block_ids = None
        st.slot = slot
        self._active[slot] = st
        self._control["resumed"] += 1
        self._emit("serving_request_resumed", rid=st.request.rid,
                   slot=slot, cached_tokens=sus.length,
                   suspended_s=round(self._clock() - sus.t_suspended, 6))

    def _admit_policy(self) -> None:
        """Policy admission: serve the highest priority class with an
        admissible request; within a class resume preempted streams first
        (oldest preemption first), then draw tenants by smooth weighted
        round-robin (FIFO within a tenant).  With no slot free, the class
        may preempt a strictly lower-priority DECODE stream
        (``policy.preemption``), but only once the candidate's blocks are
        known to fit; tenants at their in-flight cap are skipped."""
        cap = self.policy.max_inflight_per_tenant
        while self._queue or self._suspended:
            inflight = self._tenant_inflight()

            def ok(tenant: str) -> bool:
                return cap is None or inflight.get(tenant, 0) < cap

            res = [(i, s) for i, s in enumerate(self._suspended)
                   if ok(s.st.request.tenant)]
            qs = [(i, rt) for i, rt in enumerate(self._queue)
                  if ok(rt[0].tenant)]
            if not res and not qs:
                break
            best = max([s.st.request.priority for _, s in res]
                       + [r.priority for _, (r, _) in qs])
            res_best = [(i, s) for i, s in res
                        if s.st.request.priority == best]
            snap = None
            if res_best:
                qi, sus = res_best[0]
                request = sus.st.request
                # the resume allocates nothing, but the stream's remaining
                # growth must fit: its reservation lapsed while suspended
                held = len(sus.block_ids) if sus.block_ids else 0
            else:
                qs_best = [(i, rt) for i, rt in qs if rt[0].priority == best]
                snap = self._wrr.snapshot()
                tenant = self._wrr.pick({rt[0].tenant for _, rt in qs_best})
                qi, (request, t_submit) = next(
                    (i, rt) for i, rt in qs_best if rt[0].tenant == tenant)
                held = 0
            # a victim is never evicted for an admission the pool cannot
            # cover (its hold would keep its own blocks unavailable)
            if not self._paged_fits(request, held):
                if snap is not None:
                    self._wrr.restore(snap)    # picked, never served
                break
            free = self._free_slots()
            if not free:
                victim = (self._pick_victim(best)
                          if self.policy.preemption else None)
                if victim is None:
                    if snap is not None:
                        self._wrr.restore(snap)
                    break
                self._preempt(victim, by_priority=best)
                free = self._free_slots()
            if res_best:
                self._suspended.pop(qi)
                self._resume(sus, free[0])
            else:
                del self._queue[qi]
                self._admit_request(request, t_submit, free[0])

    def _shed_expired(self) -> List[str]:
        """Shed every queued or suspended request whose deadline (from
        submission) has passed: it can no longer meet it, so it spends no
        more budget.  Returns the shed rids."""
        now = self._clock()
        shed: List[str] = []

        def expired(request: Request, t_submit: float) -> bool:
            return (request.deadline_s is not None
                    and now - t_submit >= request.deadline_s)

        keep: deque = deque()
        for request, t_submit in self._queue:
            if expired(request, t_submit):
                self._terminal_result(request, t_submit, t_first=0.0,
                                      tokens=[], reason="shed")
                shed.append(request.rid)
                # the depth of the queue as the walk found it
                self._emit("serving_request_shed", rid=request.rid,
                           deadline_s=request.deadline_s,
                           waited_s=round(now - t_submit, 6),
                           new_tokens=0, queue_depth=len(self._queue))
            else:
                keep.append((request, t_submit))
        self._queue = keep
        keep_s: List[_Suspended] = []
        for sus in self._suspended:
            st = sus.st
            if expired(st.request, st.t_submit):
                self._drop_suspended_state(sus)
                self._terminal_result(st.request, st.t_submit,
                                      t_first=st.t_first, tokens=st.tokens,
                                      reason="shed",
                                      preemptions=st.preemptions)
                shed.append(st.request.rid)
                self._emit("serving_request_shed", rid=st.request.rid,
                           deadline_s=st.request.deadline_s,
                           waited_s=round(now - st.t_submit, 6),
                           new_tokens=len(st.tokens),
                           queue_depth=len(self._queue))
            else:
                keep_s.append(sus)
        self._suspended = keep_s
        self._control["shed"] += len(shed)
        return shed

    def _drop_suspended_state(self, sus: _Suspended) -> None:
        """Let go of a suspended stream's capture without resuming it
        (shed or cancelled): the paged hold is dereferenced (its blocks
        free unless shared), the dense host rows dropped."""
        if sus.block_ids is not None:
            self.engine.block_pool.deref(sus.block_ids)
        sus.kv = sus.block_ids = None

    def _terminal_result(self, request: Request, t_submit: float, *,
                         t_first: float, tokens: List[int], reason: str,
                         preemptions: int = 0) -> None:
        """Record a cancelled or shed outcome: partial tokens kept,
        ``ttft_s`` NaN when no token was emitted (judged by the count: a
        virtual clock may stamp a first token at 0.0)."""
        total = max(self._clock() - t_submit, 1e-9)
        self._results[request.rid] = RequestResult(
            rid=request.rid, tokens=list(tokens), finish_reason=reason,
            ttft_s=(t_first - t_submit) if tokens else float("nan"),
            total_s=total, tokens_per_s=len(tokens) / total,
            preemptions=preemptions)

    def cancel(self, rid: str) -> bool:
        """Cancel one request wherever it is (queued, suspended or
        active), releasing its slot, paged blocks and prefix-cache pins
        without touching any other stream; partial output is kept
        (``finish_reason="cancelled"``).  Returns ``False`` when the
        request already finished, and raises ``KeyError`` for a rid this
        scheduler does not know.  Works with or without a policy."""
        for i, (request, t_submit) in enumerate(self._queue):
            if request.rid == rid:
                del self._queue[i]
                self._terminal_result(request, t_submit, t_first=0.0,
                                      tokens=[], reason="cancelled")
                self._control["cancelled"] += 1
                self._emit("serving_request_cancelled", rid=rid,
                           phase="queued", new_tokens=0)
                return True
        for i, sus in enumerate(self._suspended):
            if sus.st.request.rid == rid:
                self._suspended.pop(i)
                self._drop_suspended_state(sus)
                st = sus.st
                self._terminal_result(st.request, st.t_submit,
                                      t_first=st.t_first, tokens=st.tokens,
                                      reason="cancelled",
                                      preemptions=st.preemptions)
                self._control["cancelled"] += 1
                self._emit("serving_request_cancelled", rid=rid,
                           phase="suspended", new_tokens=len(st.tokens))
                return True
        for slot, st in list(self._active.items()):
            if st.request.rid == rid:
                if self.prefix_cache is not None:
                    # a mid-prefill stream still pins the chain it extends
                    self._release_pins(st)
                st.phase = RequestPhase.DONE
                self._active.pop(slot)
                self.engine.release(slot)
                self._terminal_result(st.request, st.t_submit,
                                      t_first=st.t_first, tokens=st.tokens,
                                      reason="cancelled",
                                      preemptions=st.preemptions)
                self._control["cancelled"] += 1
                self._emit("serving_request_cancelled", rid=rid,
                           phase=("decode" if st.tokens else "prefill"),
                           new_tokens=len(st.tokens))
                return True
        if rid in self._results:
            return False
        raise KeyError(f"cancel({rid!r}): unknown rid — never submitted, or "
                       f"its result was already claimed via pop_result")

    # ---- failover: export / adopt ----------------------------------------
    def export_streams(self, *, capture: bool = True) -> List[StreamExport]:
        """Move every live stream (active, suspended, queued) out as
        :class:`StreamExport` records, releasing this scheduler's slots,
        paged holds and prefix-cache pins; nothing is recorded as
        finished.  Afterwards the scheduler is drained and :meth:`close`
        succeeds.

        ``capture=True`` keeps a dense DECODE stream's cache rows (host
        tensors) so that adoption elsewhere resumes it mid-stream;
        ``capture=False`` (the device cache is gone) exports every stream
        bare, to be computed again from its seed.  Paged streams always
        export bare.  Records come in admission order, then arrival
        order."""
        out: List[StreamExport] = []
        dense = not self._paged
        # mid-prefill streams are cheaper to compute again than to capture
        for slot, st in sorted(self._active.items(),
                               key=lambda item: item[1].seq):
            exp = StreamExport(request=st.request, t_submit=st.t_submit,
                               preemptions=st.preemptions,
                               weights_step=self.weights_step)
            if capture and dense and st.phase is RequestPhase.DECODE:
                k, v, length = self.engine.capture_slot(slot)
                exp.kv, exp.length = (k, v), length
                exp.tokens, exp.t_first = list(st.tokens), st.t_first
            if self.prefix_cache is not None:
                self._release_pins(st)
            self._active.pop(slot)
            self.engine.release(slot)
            self._live_rids.discard(st.request.rid)
            out.append(exp)
        for sus in self._suspended:
            st = sus.st
            exp = StreamExport(request=st.request, t_submit=st.t_submit,
                               preemptions=st.preemptions,
                               weights_step=self.weights_step)
            if capture and sus.kv is not None:
                exp.kv, exp.length = sus.kv, sus.length
                exp.tokens, exp.t_first = list(st.tokens), st.t_first
            self._drop_suspended_state(sus)
            self._live_rids.discard(st.request.rid)
            out.append(exp)
        self._suspended = []
        for request, t_submit in self._queue:
            out.append(StreamExport(request=request, t_submit=t_submit))
            self._live_rids.discard(request.rid)
        self._queue.clear()
        return out

    def adopt_stream(self, exp: StreamExport) -> bool:
        """Take over one exported stream.  A bare record (``kv`` None)
        joins the queue under its original submit stamp, so its latencies
        still count from the first submission.  A captured record needs a
        free slot: its rows are restored (``restore_prefix``) and decode
        goes on mid-stream; with every slot busy it returns ``False``
        without taking the record.  Raises ``ValueError`` on a rid already
        live here and, for a captured record, on a paged engine."""
        request = exp.request
        if request.rid in self._live_rids:
            raise ValueError(f"adopt_stream({request.rid!r}): rid already "
                             f"live on this scheduler")
        if exp.kv is None:
            if len(self._queue) >= self.max_queue:
                raise QueueFull(f"queue at capacity ({self.max_queue})")
            self._queue.append((request, exp.t_submit))
            self._live_rids.add(request.rid)
            if self.policy is not None:
                self._tenants_seen.add(request.tenant)
            self._emit("serving_request_queued", rid=request.rid,
                       prompt_tokens=len(request.prompt),
                       queue_depth=len(self._queue))
            return True
        if self._paged:
            raise ValueError(
                f"adopt_stream({request.rid!r}): captured K/V cannot "
                f"restore into a paged engine — export the donor with "
                f"capture=False (requeue) instead")
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        self.engine.restore_prefix(slot, exp.kv, exp.length)
        self._active[slot] = _Active(
            request=request, slot=slot, seq=self._admit_seq,
            tokens=list(exp.tokens), t_submit=exp.t_submit,
            t_first=exp.t_first, prompt_pos=len(request.prompt),
            phase=RequestPhase.DECODE, draft_k=self._draft_k(request),
            preemptions=exp.preemptions + 1,
            wv=self.engine.weights_version)
        self._admit_seq += 1
        self._live_rids.add(request.rid)
        if self.policy is not None:
            self._tenants_seen.add(request.tenant)
        self._emit("serving_request_resumed", rid=request.rid, slot=slot,
                   cached_tokens=exp.length, suspended_s=None)
        return True

    def close(self) -> None:
        """Take down this scheduler's prefix cache: drop every entry (on a
        paged engine that drops the cached blocks' references) and unhook
        the engine's reclaim callback if it is still this scheduler's.
        Needed before another caching scheduler runs over the same engine:
        an abandoned paged cache keeps its blocks for the engine's life.
        Refuses while any stream is queued, active or suspended; once
        drained, a second call does nothing more."""
        if self._active or self._queue or self._suspended:
            raise RuntimeError(
                f"close() with {len(self._active)} active stream(s), "
                f"{len(self._queue)} queued request(s) and "
                f"{len(self._suspended)} suspended stream(s) — drain with "
                f"run() (or cancel()) first")
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
            # a newer caching scheduler over the same engine may have
            # wired reclaim to its own cache: leave that one in place
            if (self._paged and self.engine.block_pool.reclaim
                    is self._reclaim_hook):
                self.engine.set_block_reclaim(None)

    def swap_weights(self, params, *, step: Optional[int] = None):
        """Hot-swap the engine's served weights at this step boundary;
        returns the displaced ``state_dict`` (the caller's rollback copy).

        Call between :meth:`step` calls only.  The swap is
        :meth:`DecodeEngine.swap_params` (same names, shapes and dtypes,
        or it raises), and in-flight streams are PRESERVED: decode state
        (KV cache, block tables, lengths, sampler seeds) is
        weight-independent, so active slots continue under the new
        weights.  The prefix cache is version-bumped so no cached
        pre-swap K/V can feed a post-swap admission; streams admitted
        pre-swap stop offering their (now hybrid) blocks.

        ``step`` records the candidate's checkpoint step in
        :attr:`weights_step` (the :class:`~apex_tpu_torch.serving.reload.
        HotReloader` passes it on every reload and rollback); a raw swap
        with no ``step`` resets it to ``None``: the provenance is unknown.
        """
        old = self.engine.swap_params(params)
        self.weights_step = None if step is None else int(step)
        if self.prefix_cache is not None:
            self.prefix_cache.bump_version()
        return old

    # ---- prefix caching ----------------------------------------------------
    def _match_and_restore(self, st: _Active) -> None:
        """Restore the prompt's longest cached chain into the fresh slot
        (dense: ``restore_prefix``; paged: ``alias_prefix``, no copy) and
        pin the matched entries until the prompt is cached; prefill then
        spends the budget on the rest only."""
        cache = self.prefix_cache
        request = st.request
        covered, entries = cache.match(request.prompt)
        if not covered:
            self.prefix_misses += 1
            self._emit("serving_prefix_miss", rid=request.rid,
                       prompt_tokens=len(request.prompt))
            return
        t0 = self._clock()
        if self._paged:
            self.engine.alias_prefix(st.slot, [e.block_id for e in entries],
                                     covered)
            self._emit("serving_block_alias", rid=request.rid,
                       blocks=len(entries), saved_tokens=covered)
        else:
            self.engine.restore_prefix(st.slot, cache.gather_kv(entries),
                                       covered)
        dt = self._clock() - t0
        cache.acquire(entries)
        st.pinned = list(entries)
        st.prompt_pos = covered
        st.chain = entries[-1].chain
        st.blocks_cached = len(entries)
        self.prefix_hits += 1
        self.prefix_saved_tokens += covered
        self._emit("serving_prefix_hit", rid=request.rid,
                   saved_tokens=covered, blocks=len(entries),
                   prompt_tokens=len(request.prompt),
                   duration_s=round(dt, 6))

    def _pin(self, st: _Active, entries) -> None:
        for entry in entries:
            self.prefix_cache.acquire([entry])
            st.pinned.append(entry)
            st.chain = entry.chain
            st.blocks_cached += 1

    def _offer_blocks(self, st: _Active) -> None:
        """Offer the prompt blocks the slot has completed to the cache:
        blocks another stream already inserted are advanced over by hash
        (no read), and the missing ones (always a tail: a chain hash has
        no entry without its parent) are captured, on a paged engine by
        their pool block ids, on a dense one by one ``read_region`` of
        the chunk's new blocks (at most a chunk's worth a read).  Each is
        pinned until the prompt is cached."""
        if st.wv != self.engine.weights_version:
            # admitted before a hot weight swap: its remaining prefill
            # rows are computed under the new weights over pre-swap
            # context — self-consistent for the stream, but never clean
            # new-weights prefill output, so never offered to the cache
            return
        cache = self.prefix_cache
        block = cache.block_size
        total = st.prompt_pos // block     # complete blocks available
        while st.blocks_cached < total:
            lo = st.blocks_cached * block
            entry = cache.lookup(cache.chain_hash(
                st.chain, st.request.prompt[lo:lo + block]))
            if entry is None:
                break
            self._pin(st, [entry])
        missing = total - st.blocks_cached
        if missing <= 0:
            return
        if self._paged:
            ids = self.engine.slot_block_ids(st.slot)
            lo = st.blocks_cached
            blocks = [st.request.prompt[(lo + i) * block:
                                        (lo + i + 1) * block]
                      for i in range(missing)]
            self._pin(st, cache.put_block_ids(st.chain, blocks,
                                              ids[lo:lo + missing]))
            return
        max_span = max(1, self.engine.prefill_len // block)
        while missing > 0:
            count = min(missing, max_span)
            lo = st.blocks_cached * block
            k_span, v_span = self.engine.read_region(
                st.slot, lo, lo + count * block)
            blocks = [st.request.prompt[lo + i * block:
                                        lo + (i + 1) * block]
                      for i in range(count)]
            entries = cache.put_blocks(st.chain, blocks, k_span, v_span)
            self._pin(st, entries)
            if len(entries) < count:
                return          # parent evicted: stop extending the chain
            missing -= count

    def _release_pins(self, st: _Active) -> None:
        if st.pinned:
            self.prefix_cache.release(st.pinned)
            st.pinned = []

    # ---- the loop --------------------------------------------------------
    def _sample(self, logits, states: Sequence[_Active], rows) -> np.ndarray:
        return self.engine.sample(
            logits[rows],
            [st.request.seed for st in states],
            [len(st.tokens) for st in states],
            [st.request.temperature for st in states],
            [st.request.top_k for st in states])

    def _prefill_work(self) -> List[str]:
        """Spend up to ``prefill_budget`` prompt tokens on chunks, oldest
        admitted request first (under a policy, higher priority classes
        first).  When a prompt completes, its first token is sampled from
        the final chunk's logits.  Returns rids finished at prefill
        completion (one-token requests, instant EOS)."""
        finished: List[str] = []
        budget = self.prefill_budget
        if self.policy is None:
            def key(s):
                return s.seq
        else:
            def key(s):
                return (-s.request.priority, s.seq)
        for st in sorted((s for s in self._active.values()
                          if s.phase is RequestPhase.PREFILL), key=key):
            while budget > 0 and st.prompt_remaining:
                chunk = min(st.prompt_remaining, self.engine.prefill_len,
                            budget)
                offset = st.prompt_pos
                t0 = self._clock()
                logits = self.engine.prefill_chunk(
                    st.slot, st.request.prompt[offset:offset + chunk])
                dt = self._clock() - t0
                st.prompt_pos = offset + chunk
                budget -= chunk
                self._emit("serving_prefill_chunk", rid=st.request.rid,
                           bucket=self.engine.bucket_for(chunk),
                           chunk_tokens=chunk, offset_tokens=offset,
                           duration_s=round(dt, 6))
                if self.prefix_cache is not None:
                    self._offer_blocks(st)
                if not st.prompt_remaining:
                    tok = int(self._sample(logits[None], [st], [0])[0])
                    st.t_first = self._clock()
                    st.tokens.append(tok)
                    st.phase = RequestPhase.DECODE
                    if self.prefix_cache is not None:
                        # the prompt is cached: its chain needs no pin
                        self._release_pins(st)
                    self._emit("serving_first_token", rid=st.request.rid,
                               ttft_s=round(st.t_first - st.t_submit, 6))
                    if self._finish_if_done(st):
                        finished.append(st.request.rid)
            if budget <= 0:
                break
        return finished

    @staticmethod
    def _done(st: _Active) -> bool:
        """Whether ``st``'s last token ends its stream (EOS or length)."""
        request = st.request
        return bool((request.eos_id is not None and st.tokens
                     and st.tokens[-1] == request.eos_id)
                    or len(st.tokens) >= request.max_new_tokens)

    def _finish_if_done(self, st: _Active) -> bool:
        if not self._done(st):
            return False
        request = st.request
        done_eos = (request.eos_id is not None
                    and st.tokens[-1] == request.eos_id)
        now = self._clock()
        total = max(now - st.t_submit, 1e-9)
        # a stream that survived a preemption got its whole service, and
        # says so: its latencies include the suspension
        reason = "eos" if done_eos else "length"
        if st.preemptions:
            reason = "preempted-resumed"
        result = RequestResult(
            rid=request.rid, tokens=list(st.tokens), finish_reason=reason,
            ttft_s=st.t_first - st.t_submit, total_s=total,
            tokens_per_s=len(st.tokens) / total,
            preemptions=st.preemptions)
        self._results[request.rid] = result
        st.phase = RequestPhase.DONE
        self._active.pop(st.slot, None)
        self.engine.release(st.slot)     # immediate slot reuse
        # per_token_ms is the decode path only (first token to finish):
        # queue wait and prefill are in ttft_s
        decode_s = max(now - st.t_first, 0.0)
        decode_steps = max(len(st.tokens) - 1, 1)
        self._emit("serving_request_finished", rid=request.rid,
                   finish_reason=result.finish_reason,
                   new_tokens=len(result.tokens),
                   tokens_per_s=round(result.tokens_per_s, 3),
                   per_token_ms=round(decode_s / decode_steps * 1e3, 3),
                   weights_step=self.weights_step)
        return True

    def _spec_work(self, decoding: Dict[int, _Active]) -> tuple:
        """One verify for each decoding slot that drafts: prompt lookup
        over the request's prompt and tokens so far, one
        :meth:`~apex_tpu_torch.serving.engine.DecodeEngine.verify_draft`,
        the accepted prefix plus the bonus token emitted (one at a time,
        so an EOS inside them ends the stream where plain decode would),
        and the next draft length adapted.  A slot rides the batched
        decode instead when its request samples (``draft_k == 0``), no
        n-gram matches, fewer than 2 tokens of budget are left, or the
        cache has no room for a draft.  Returns ``(finished rids, slots
        that already advanced this step)``."""
        finished: List[str] = []
        consumed: set = set()
        cfg = self.speculation
        lengths = self.engine.lengths()
        for slot, st in sorted(decoding.items()):
            request = st.request
            if st.draft_k < 1:
                continue
            remaining = request.max_new_tokens - len(st.tokens)
            # a draft of k emits at most k + 1 tokens: capped so a full
            # accept lands on max_new_tokens exactly
            cap = min(st.draft_k, remaining - 1,
                      self.engine.max_len - int(lengths[slot]) - 1)
            if cap < 1:
                continue
            draft = propose(list(request.prompt) + st.tokens, cap,
                            ngram_max=cfg.ngram_max, ngram_min=cfg.ngram_min)
            if not draft:
                continue
            t0 = self._clock()
            accepted, greedy, _ = self.engine.verify_draft(
                slot, [st.tokens[-1]] + draft)
            dt = self._clock() - t0
            consumed.add(slot)
            st.draft_k = adapt_k(st.draft_k, len(draft), accepted, cfg)
            self._spec["dispatches"] += 1
            self._spec["drafted"] += len(draft)
            self._spec["accepted"] += accepted
            n_emitted = 0
            for tok in draft[:accepted] + [int(greedy[accepted])]:
                st.tokens.append(int(tok))
                n_emitted += 1
                if self._done(st):
                    break
            self._spec["emitted"] += n_emitted
            # the verify's event comes before the finish it causes, so a
            # request's events read in the order things happened (the
            # JAX scheduler finishes first, and its request-trace
            # recorder, finding the record closed, drops the verify)
            self._emit("serving_spec_verify", rid=request.rid,
                       bucket=self.engine.draft_bucket_for(len(draft)),
                       drafted=len(draft), accepted=accepted,
                       emitted=n_emitted, duration_s=round(dt, 6))
            if self._finish_if_done(st):
                finished.append(request.rid)
        return finished, consumed

    def step(self) -> List[str]:
        """One step boundary: (with a policy) shed expired deadlines,
        admit into free slots (possibly preempting), spend the prefill
        budget, run the speculative verifies, then one shared decode step
        for every other decoding slot.  Returns rids that reached a
        terminal state at this boundary (finished or shed)."""
        finished: List[str] = []
        if self.policy is not None and self.policy.deadline_shedding:
            finished.extend(self._shed_expired())
        self._admit()
        finished.extend(self._prefill_work())
        decoding = {slot: st for slot, st in self._active.items()
                    if st.phase is RequestPhase.DECODE}
        if decoding and self.speculation is not None:
            spec_finished, consumed = self._spec_work(decoding)
            finished.extend(spec_finished)
            decoding = {slot: st for slot, st in decoding.items()
                        if slot not in consumed}
        if decoding:
            tokens = np.zeros((self.engine.slots,), np.int64)
            active = np.zeros((self.engine.slots,), bool)
            for slot, st in decoding.items():
                tokens[slot] = st.tokens[-1]
                active[slot] = True
            logits = self.engine.decode(tokens, active)
            slots = sorted(decoding)
            sampled = dict(zip(slots, self._sample(
                logits, [decoding[s] for s in slots], slots)))
            # streams finish in slot-admission order, as in the JAX
            # scheduler, so two finishing in one step emit in its order
            for slot, st in decoding.items():
                st.tokens.append(int(sampled[slot]))
                if self._finish_if_done(st):
                    finished.append(st.request.rid)
        self._step_index += 1
        self._publish_step()
        return finished

    def _publish_step(self) -> None:
        """The current-state gauges, every step, and ``serving_step``
        every ``log_interval`` steps: all from host state (the engine's
        length mirror, the pool's counts, the scheduler's own), so no
        telemetry reads the device.  Gauges of an unused feature (prefix
        cache, paged pool, policy, speculation) stay unset."""
        occupancy = len(self._active) / max(self.engine.slots, 1)
        cache_util = self.engine.cache_utilization()
        backlog = self.prefill_backlog
        spec = self._spec
        series = [{}] if self.name is None else [{}, {"replica": self.name}]
        for labels in series:
            obs_bridge.SERVING_QUEUE_DEPTH.set(len(self._queue), **labels)
            obs_bridge.SERVING_SLOT_OCCUPANCY.set(occupancy, **labels)
            obs_bridge.SERVING_CACHE_UTILIZATION.set(cache_util, **labels)
            obs_bridge.SERVING_PREFILL_BACKLOG.set(backlog, **labels)
            if self.prefix_cache is not None:
                obs_bridge.SERVING_PREFIX_CACHED_TOKENS.set(
                    self.prefix_cache.cached_tokens, **labels)
            if self._paged:
                obs_bridge.SERVING_BLOCK_POOL_UTILIZATION.set(
                    self.engine.block_pool_utilization(), **labels)
            if spec["dispatches"]:
                # tokens a verify: 1.0 is plain decode's rate
                obs_bridge.SERVING_SPEC_SPEEDUP.set(
                    spec["emitted"] / spec["dispatches"], **labels)
            if self.policy is not None and not labels:
                # every tenant ever seen, so one with nothing in flight
                # reads 0 (unlabeled by replica, as in the JAX scheduler)
                counts = self._tenant_inflight()
                for tenant in self._tenants_seen:
                    obs_bridge.SERVING_TENANT_INFLIGHT.set(
                        counts.get(tenant, 0), tenant=tenant)
        if self._step_index % self.log_interval == 0:
            self._emit("serving_step", step=self._step_index,
                       queue_depth=len(self._queue),
                       active_slots=len(self._active),
                       slot_occupancy=round(occupancy, 4),
                       cache_utilization=round(cache_util, 6),
                       prefill_backlog=backlog, tp=self.engine.tp_size)

    def _derived_step_bound(self) -> int:
        """A generous progress bound for :meth:`run`: every step of a
        healthy drain caches >= 1 prompt token, emits >= 1 token, or
        retires a request."""
        work = 0
        for request, _ in self._queue:
            work += len(request.prompt) + request.max_new_tokens
        for st in self._active.values():
            work += st.prompt_remaining + max(
                st.request.max_new_tokens - len(st.tokens), 1)
        for sus in self._suspended:
            work += max(sus.st.request.max_new_tokens - len(sus.st.tokens),
                        1)
        return 64 + 4 * work

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[str, RequestResult]:
        """Drive :meth:`step` until the queue, the slots and the suspended
        streams drain; returns rid -> :class:`RequestResult`.  Exceeding
        ``max_steps`` (derived from the queued work when None) raises
        :class:`SchedulerStalled`."""
        if max_steps is None:
            max_steps = self._derived_step_bound()
        steps = 0
        while self._queue or self._active or self._suspended:
            if steps >= max_steps:
                raise SchedulerStalled(
                    f"no drain after {steps} steps (bound {max_steps}): "
                    f"{len(self._queue)} queued, {len(self._active)} "
                    f"active, {len(self._suspended)} suspended, prefill "
                    f"backlog {self.prefill_backlog} tokens")
            self.step()
            steps += 1
        return dict(self._results)

    @property
    def results(self) -> Dict[str, RequestResult]:
        return dict(self._results)

    def pop_result(self, rid: str) -> RequestResult:
        """Claim (and forget) one finished result; its rid may be
        submitted again.  Unclaimed results are kept for the scheduler's
        life."""
        result = self._results.pop(rid)
        self._live_rids.discard(rid)
        return result

    def pop_results(self) -> Dict[str, RequestResult]:
        """Claim (and forget) every finished result."""
        out, self._results = self._results, {}
        self._live_rids.difference_update(out)
        return out
