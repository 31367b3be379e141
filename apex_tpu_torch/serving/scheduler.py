"""Continuous batching: a host loop that keeps decode slots full.

Counterpart of the FIFO core of ``apex_tpu/serving/scheduler.py``:

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
  would fail.

Sampling draws from per-request seeds (see
:meth:`~apex_tpu_torch.serving.engine.DecodeEngine.sample`); the clock
(``time.monotonic``) feeds the latency fields only, never token choice.

Speculative decoding and the control plane (priorities, deadlines,
tenants, preemption) come with later slices of the port; their
arguments raise ``NotImplementedError``, and :class:`Request` has none of
their fields yet.  The JAX scheduler's event stream and metrics bridge
are not carried over: the counts its prefix events carry (hits, misses,
saved tokens) are attributes here, read together by
:meth:`~ContinuousBatchingScheduler.stats`.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.serving.engine import DecodeEngine
from apex_tpu_torch.serving.paged_kv_cache import (
    blocks_per_slot,
    bytes_per_block,
)
from apex_tpu_torch.serving.prefix_cache import PrefixCache, PrefixCacheConfig

__all__ = ["Request", "RequestPhase", "RequestResult", "QueueFull",
           "SchedulerStalled", "ContinuousBatchingScheduler"]


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
    ``max_new_tokens``."""

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass
class RequestResult:
    """A completed stream and its latencies (``time.monotonic``)."""

    rid: str
    tokens: List[int]
    finish_reason: str                 # "eos" | "length"
    ttft_s: float                      # submit -> first token
    total_s: float                     # submit -> finished
    tokens_per_s: float


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
    # prefix caching: the chain hash of the last prompt block this
    # request matched or offered, how many blocks that is, and the
    # entries pinned for it until its prompt is cached
    chain: str = PrefixCache.ROOT
    blocks_cached: int = 0
    pinned: List = dataclasses.field(default_factory=list)

    @property
    def prompt_remaining(self) -> int:
        return len(self.request.prompt) - self.prompt_pos


def _not_yet(name: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}= comes with the {slice_name} slice of the port; this "
        f"scheduler is the FIFO core")


class ContinuousBatchingScheduler:
    """FIFO continuous batching over one :class:`DecodeEngine`.

    >>> sched = ContinuousBatchingScheduler(engine, max_queue=64)
    >>> sched.submit(Request("r0", prompt, max_new_tokens=32, eos_id=2))
    >>> results = sched.run()          # drain queue + all active slots

    ``prefill_budget`` is the prompt-token cap per :meth:`step` (default
    ``engine.prefill_len``, one full chunk).  ``prefix_caching`` turns on
    the cross-request prefix cache (:attr:`prefix_cache`); its block size
    defaults to the engine's smallest prefill bucket, and on a paged
    engine is the pool's block size (an entry is a pool block there).
    """

    def __init__(self, engine: DecodeEngine, *, max_queue: int = 64,
                 prefill_budget: Optional[int] = None,
                 speculation=None,
                 prefix_caching: Optional[PrefixCacheConfig] = None,
                 policy=None):
        for name, value, slice_name in (
                ("speculation", speculation, "speculative-decoding"),
                ("policy", policy, "serving control-plane")):
            if value is not None:
                raise _not_yet(name, slice_name)
        if prefill_budget is None:
            prefill_budget = engine.prefill_len
        if prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1 token per "
                             f"step, got {prefill_budget}")
        self.engine = engine
        self.max_queue = int(max_queue)
        self.prefill_budget = int(prefill_budget)
        self._queue: deque = deque()
        self._active: Dict[int, _Active] = {}
        self._results: Dict[str, RequestResult] = {}
        self._live_rids: set = set()
        self._admit_seq = 0
        self._paged = engine.block_pool is not None
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_caching is not None:
            self.prefix_cache = self._make_prefix_cache(prefix_caching)
        # what the JAX scheduler's prefix events carry, counted
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_saved_tokens = 0

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
        # cache entries before it raises
        engine.set_block_reclaim(cache.evict_blocks)
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
        self._queue.append((request, time.monotonic()))
        self._live_rids.add(rid)

    # ---- introspection ---------------------------------------------------
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

    def stats(self) -> Dict[str, int]:
        """Prefix-cache hits, misses and saved prompt tokens of the
        requests admitted so far (zeros without prefix caching)."""
        return {"prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_saved_tokens": self.prefix_saved_tokens}

    @property
    def prefill_backlog(self) -> int:
        """Prompt tokens not yet cached: admitted requests' remainders
        plus every queued prompt."""
        return (sum(st.prompt_remaining for st in self._active.values()
                    if st.phase is RequestPhase.PREFILL)
                + sum(len(r.prompt) for r, _ in self._queue))

    # ---- the loop --------------------------------------------------------
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

    def _admit(self) -> None:
        """Fill free slots from the queue (FIFO).  Admission assigns a
        slot (and restores the longest cached prefix); :meth:`_prefill_work`
        caches the rest of the prompt under the per-step budget.  On a
        paged engine the next request waits while its worst case exceeds
        :meth:`_paged_available` (an idle engine always admits, so a pool
        too small fails loudly at allocation instead of stalling)."""
        while self._queue:
            free = [s for s in self.engine.free_slots()
                    if s not in self._active]
            if not free:
                break
            if self._paged and self._active:
                request, _ = self._queue[0]
                need = blocks_per_slot(
                    len(request.prompt) + request.max_new_tokens - 1,
                    self.engine.block_size)
                if need > self._paged_available():
                    break
            request, t_submit = self._queue.popleft()
            st = _Active(request=request, slot=free[0], seq=self._admit_seq,
                         tokens=[], t_submit=t_submit)
            self._active[free[0]] = st
            self._admit_seq += 1
            if self.prefix_cache is not None:
                self._match_and_restore(st)

    def _match_and_restore(self, st: _Active) -> None:
        """Restore the prompt's longest cached chain into the fresh slot
        (dense: ``restore_prefix``; paged: ``alias_prefix``, no copy) and
        pin the matched entries until the prompt is cached; prefill then
        spends the budget on the rest only."""
        cache = self.prefix_cache
        covered, entries = cache.match(st.request.prompt)
        if not covered:
            self.prefix_misses += 1
            return
        if self._paged:
            self.engine.alias_prefix(st.slot, [e.block_id for e in entries],
                                     covered)
        else:
            self.engine.restore_prefix(st.slot, cache.gather_kv(entries),
                                       covered)
        cache.acquire(entries)
        st.pinned = list(entries)
        st.prompt_pos = covered
        st.chain = entries[-1].chain
        st.blocks_cached = len(entries)
        self.prefix_hits += 1
        self.prefix_saved_tokens += covered

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

    def _sample(self, logits, states: Sequence[_Active], rows) -> np.ndarray:
        return self.engine.sample(
            logits[rows],
            [st.request.seed for st in states],
            [len(st.tokens) for st in states],
            [st.request.temperature for st in states],
            [st.request.top_k for st in states])

    def _prefill_work(self) -> List[str]:
        """Spend up to ``prefill_budget`` prompt tokens on chunks, oldest
        admitted request first.  When a prompt completes, its first token
        is sampled from the final chunk's logits.  Returns rids finished
        at prefill completion (one-token requests, instant EOS)."""
        finished: List[str] = []
        budget = self.prefill_budget
        for st in sorted((s for s in self._active.values()
                          if s.phase is RequestPhase.PREFILL),
                         key=lambda s: s.seq):
            while budget > 0 and st.prompt_remaining:
                chunk = min(st.prompt_remaining, self.engine.prefill_len,
                            budget)
                offset = st.prompt_pos
                logits = self.engine.prefill_chunk(
                    st.slot, st.request.prompt[offset:offset + chunk])
                st.prompt_pos = offset + chunk
                budget -= chunk
                if self.prefix_cache is not None:
                    self._offer_blocks(st)
                if not st.prompt_remaining:
                    tok = int(self._sample(logits[None], [st], [0])[0])
                    st.t_first = time.monotonic()
                    st.tokens.append(tok)
                    st.phase = RequestPhase.DECODE
                    if self.prefix_cache is not None:
                        # the prompt is cached: its chain needs no pin
                        self._release_pins(st)
                    if self._finish_if_done(st):
                        finished.append(st.request.rid)
            if budget <= 0:
                break
        return finished

    def _finish_if_done(self, st: _Active) -> bool:
        request = st.request
        done_eos = (request.eos_id is not None and st.tokens
                    and st.tokens[-1] == request.eos_id)
        done_len = len(st.tokens) >= request.max_new_tokens
        if not (done_eos or done_len):
            return False
        total = max(time.monotonic() - st.t_submit, 1e-9)
        self._results[request.rid] = RequestResult(
            rid=request.rid, tokens=list(st.tokens),
            finish_reason="eos" if done_eos else "length",
            ttft_s=st.t_first - st.t_submit, total_s=total,
            tokens_per_s=len(st.tokens) / total)
        st.phase = RequestPhase.DONE
        self._active.pop(st.slot, None)
        self.engine.release(st.slot)     # immediate slot reuse
        return True

    def step(self) -> List[str]:
        """One step boundary: admit into free slots, spend the prefill
        budget, then one shared decode step for every decoding slot.
        Returns rids that finished at this boundary."""
        self._admit()
        finished = self._prefill_work()
        decoding = sorted((slot, st) for slot, st in self._active.items()
                          if st.phase is RequestPhase.DECODE)
        if decoding:
            tokens = np.zeros((self.engine.slots,), np.int64)
            active = np.zeros((self.engine.slots,), bool)
            for slot, st in decoding:
                tokens[slot] = st.tokens[-1]
                active[slot] = True
            logits = self.engine.decode(tokens, active)
            slots = [slot for slot, _ in decoding]
            sampled = self._sample(logits, [st for _, st in decoding], slots)
            for (_, st), tok in zip(decoding, sampled):
                st.tokens.append(int(tok))
                if self._finish_if_done(st):
                    finished.append(st.request.rid)
        return finished

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
        return 64 + 4 * work

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[str, RequestResult]:
        """Drive :meth:`step` until the queue and slots drain; returns rid
        -> :class:`RequestResult`.  Exceeding ``max_steps`` (derived from
        the queued work when None) raises :class:`SchedulerStalled`."""
        if max_steps is None:
            max_steps = self._derived_step_bound()
        steps = 0
        while self._queue or self._active:
            if steps >= max_steps:
                raise SchedulerStalled(
                    f"no drain after {steps} steps (bound {max_steps}): "
                    f"{len(self._queue)} queued, {len(self._active)} "
                    f"active, prefill backlog {self.prefill_backlog} "
                    f"tokens")
            self.step()
            steps += 1
        return dict(self._results)

    @property
    def results(self) -> Dict[str, RequestResult]:
        return dict(self._results)

