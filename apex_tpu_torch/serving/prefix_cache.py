"""Cross-request prefix cache: reuse a shared prompt's K/V (counterpart
of ``apex_tpu/serving/prefix_cache.py``).

Serving traffic is dominated by requests that share long prefixes
(system prompts, few-shot templates, chat history); a plain scheduler
prefills each of them anew.  The store is **block-granular**: a prompt
is hashed as a chain of fixed-size token blocks, and each entry holds

- the K/V of its block: in dense mode an owned device copy captured with
  ``DecodeEngine.read_region`` right after the prefill chunk that
  completed the block (blocks captured together share one *span*
  buffer, freed when its last entry goes); in paged mode the pool block
  id itself, captured by reference (one allocator reference an entry,
  no bytes moved); and
- the **chain hash** ``H(parent_hash, block_tokens)``: two prompts share
  an entry iff they share the whole token prefix up to that block, so
  position is in the hash and there are no false hits.  The hash is the
  JAX package's (BLAKE2b over the tokens as little-endian int64), so
  both packages give one prompt the same chain.

Admission does a **longest-chain match**, capped at ``len(prompt) - 1``
tokens (the last prompt token is always computed, for the next-token
logits).  Eviction is LRU under a token budget with two hard rules: an
entry with a nonzero pin count is never evicted (the scheduler pins a
request's chain until its prompt is cached), and eviction is leaf-first
(an entry with live children is not evictable), so every cached chain
stays reachable from the root; :meth:`PrefixCache.put` refuses an insert
whose parent is gone for the same reason.

Numerics.  The JAX package states that chunk boundaries are scheduling,
not numerics, so a restored prefix is bit-identical to a cold prefill.
On the card that does not hold: a cuBLAS product's algorithm follows its
M, so a prefix cached in other chunks has other bits.  A hit's stream is
held to a cold prefill's within a stated tolerance, not bit for bit; a
restored span equals the captured one bit for bit.

Everything here is host bookkeeping; not thread-safe (the scheduler is
one host loop and calls it at step boundaries).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

__all__ = ["PrefixCacheConfig", "PrefixCache"]

_ROOT = "root"          # chain hash of the empty prefix


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Opt-in knob for cross-request prefix caching.

    ``block_size``: tokens per hashed block (``None`` — the scheduler
    aligns it to the engine's smallest prefill bucket, so a restored
    chain always lands on bucket-friendly chunk boundaries).
    ``max_tokens``: cached-token budget — LRU eviction keeps the store
    at or under it whenever any unpinned, childless entry exists
    (pinned chains may transiently exceed it; see
    :meth:`PrefixCache.put`).
    """

    block_size: Optional[int] = None
    max_tokens: int = 1 << 20

    def __post_init__(self):
        if self.block_size is not None and self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be >= 1, got {self.max_tokens}")


@dataclasses.dataclass
class _Span:
    """One captured region's owned device buffers, shared by the blocks
    captured together (``live`` counts the entries still referencing
    it; its bytes are freed — the arrays dropped — when the last one
    is evicted)."""

    k: object                    # [layers, rows, kv_heads, head_dim]
    v: object
    nbytes: int
    live: int = 0


@dataclasses.dataclass
class _Entry:
    chain: str                   # this entry's chain hash
    parent: str                  # parent block's chain hash (or root)
    tokens: Tuple[int, ...]      # the block's tokens (len == block_size)
    span: Optional[_Span] = None  # shared captured buffers (dense mode)
    lo: int = 0                  # this block's row offset inside span
    refs: int = 0                # live pins; > 0 == never evictable
    block_id: Optional[int] = None  # pool block id (paged mode)
    version: int = 0             # weights generation the K/V came from


class PrefixCache:
    """Chain-hashed block store over captured K/V (host bookkeeping).

    >>> cache = PrefixCache(block_size=16, max_tokens=4096)
    >>> covered, entries = cache.match(prompt)       # longest chain
    >>> cache.acquire(entries)                       # pin while feeding
    >>> h = cache.put(parent_hash, block, k, v)      # insert-on-miss
    >>> cache.release(entries)                       # prompt cached

    Not thread-safe by design: the continuous-batching scheduler is a
    single host loop, and every call here happens at a step boundary.
    """

    ROOT = _ROOT

    def __init__(self, *, block_size: int, max_tokens: int,
                 pool=None, bytes_per_block: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        self.block_size = int(block_size)
        self.max_tokens = int(max_tokens)
        # paged mode: entries hold pool block IDS (captured by
        # reference via put_block_ids — the cache holds one allocator
        # reference per entry, dropped at eviction so the pool block
        # frees once no slot shares it).  ``pool`` is the engine's
        # PagedCacheManager (or anything with ref/deref);
        # ``bytes_per_block`` feeds the honest cached_bytes figure.
        self._pool = pool
        self._bytes_per_block = int(bytes_per_block)
        # LRU order IS the dict order: touch == move_to_end, eviction
        # scans from the oldest end for the first evictable entry —
        # O(1) in the common case instead of a full min() scan of a
        # store that can hold tens of thousands of blocks at budget
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._children: Dict[str, Set[str]] = {}
        self._span_bytes = 0     # bytes of spans with >= 1 live entry
        self._hits = 0
        self._misses = 0
        self._inserted = 0
        self._evicted = 0
        self._refused = 0
        # current weights generation: entries are stamped at insert and
        # only same-version entries match — cached K/V captured under
        # old weights must never resume a new-weights stream (the hot
        # reload invalidation contract; see bump_version)
        self._version = 0

    # ---- hashing ---------------------------------------------------------
    @staticmethod
    def chain_hash(parent: str, tokens: Sequence[int]) -> str:
        """``H(parent_hash, block_tokens)`` — equal iff the WHOLE token
        prefix up to and including this block is equal, so a chain hash
        encodes both content and position.  BLAKE2b over the raw int64
        token bytes, as in the JAX package."""
        h = hashlib.blake2b(parent.encode("ascii"), digest_size=16)
        h.update(np.asarray(tokens, dtype="<i8").tobytes())
        return h.hexdigest()

    # ---- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, chain: str) -> bool:
        return chain in self._entries

    @property
    def cached_tokens(self) -> int:
        return len(self._entries) * self.block_size

    @property
    def cached_bytes(self) -> int:
        """Bytes of live span buffers — the honest device-memory
        figure: a span stays allocated until its LAST entry is evicted,
        so this can exceed ``cached_tokens``-worth of bytes while a
        partially evicted span survives (bounded by one chunk's rows
        per surviving span).  In paged mode this is entries *
        bytes_per_block — the pool bytes the cache's references PIN;
        a block also referenced by a live slot costs no *extra* memory
        beyond this figure (the reference is the whole point)."""
        if self._pool is not None:
            return len(self._entries) * self._bytes_per_block
        return self._span_bytes

    def stats(self) -> Dict[str, int]:
        """Cumulative structural accounting (per-request hits, misses
        and saved tokens are the scheduler's ``stats()``)."""
        return {"entries": len(self._entries),
                "cached_tokens": self.cached_tokens,
                "cached_bytes": self.cached_bytes,
                "hits": self._hits, "misses": self._misses,
                "inserted": self._inserted, "evicted": self._evicted,
                "refused": self._refused,
                "version": self._version,
                "stale_entries": self.stale_entries}

    @property
    def version(self) -> int:
        """Current weights generation new inserts are stamped with."""
        return self._version

    @property
    def stale_entries(self) -> int:
        """Entries surviving from an older weights generation — pinned
        by (or mid-chain under) streams admitted before a swap.  They
        are unmatchable and un-extendable; LRU eviction reclaims them
        as their pins release."""
        return sum(1 for e in self._entries.values()
                   if e.version != self._version)

    def bump_version(self) -> int:
        """Invalidate every cached entry for a weight swap: the store's
        version advances, so existing entries stop matching (old-weights
        K/V must never resume a new-weights stream) and droppable ones
        are reclaimed immediately.  Entries pinned by live slots — a
        pre-swap stream still mid-prompt — survive *as storage* (their
        stream's own restore already happened and its decode state is
        self-consistent) but can never feed a new admission; they drop
        when their pins release and eviction reaches them.  Returns the
        new version."""
        self._version += 1
        # fixpoint sweep, leaves first: a stale parent becomes droppable
        # once its stale children are gone
        while True:
            victim = next(
                (e for e in self._entries.values()
                 if e.version != self._version and self._evictable(e)),
                None)
            if victim is None:
                break
            self._drop(victim)
        return self._version

    # ---- lookup ----------------------------------------------------------
    def _touch(self, entry: _Entry) -> None:
        self._entries.move_to_end(entry.chain)

    def match(self, prompt: Sequence[int]) -> Tuple[int, List[_Entry]]:
        """Longest cached chain covering a prefix of ``prompt``; returns
        ``(covered_tokens, entries)`` with ``covered_tokens`` a multiple
        of ``block_size`` and **at most** ``len(prompt) - 1`` (the final
        token is always recomputed so the resume chunk yields the
        next-token logits).  Matched entries are LRU-touched but NOT
        pinned — call :meth:`acquire` before any host work that could
        insert (and therefore evict)."""
        n = len(prompt)
        h = _ROOT
        out: List[_Entry] = []
        pos = 0
        while pos + self.block_size <= n - 1:
            h = self.chain_hash(h, prompt[pos:pos + self.block_size])
            entry = self._entries.get(h)
            if entry is None or entry.version != self._version:
                # a stale-version entry is K/V from pre-swap weights:
                # restoring it would resume a new-weights stream from
                # old-weights bytes — treated as absent (and left
                # untouched, so LRU eviction reclaims it first)
                break
            out.append(entry)
            pos += self.block_size
        for entry in out:
            self._touch(entry)
        if out:
            self._hits += 1
        else:
            self._misses += 1
        return pos, out

    def lookup(self, chain: str) -> Optional[_Entry]:
        """The live entry for a chain hash (LRU-touched), or ``None`` —
        the cheap presence probe capture uses to skip the device read
        for a block another stream already inserted."""
        entry = self._entries.get(chain)
        if entry is None or entry.version != self._version:
            return None          # stale == absent (see match)
        self._touch(entry)
        return entry

    def probe(self, prompt: Sequence[int]) -> int:
        """READ-ONLY coverage probe: tokens the longest cached chain
        would cover for ``prompt`` (same walk and ``len(prompt) - 1``
        cap as :meth:`match`) with **no side effects** — no LRU touch,
        no hit/miss accounting, no pinning."""
        n = len(prompt)
        h = _ROOT
        pos = 0
        while pos + self.block_size <= n - 1:
            h = self.chain_hash(h, prompt[pos:pos + self.block_size])
            entry = self._entries.get(h)
            if entry is None or entry.version != self._version:
                break
            pos += self.block_size
        return pos

    # ---- pinning ---------------------------------------------------------
    def acquire(self, entries: Sequence[_Entry]) -> None:
        """Pin entries feeding a live slot: refs > 0 blocks eviction."""
        for entry in entries:
            entry.refs += 1

    def release(self, entries: Sequence[_Entry]) -> None:
        """Drop one pin per entry (the prompt they fed is fully cached)."""
        for entry in entries:
            if entry.refs < 1:
                raise ValueError(
                    f"release of unpinned entry {entry.chain[:12]} — "
                    f"acquire/release must pair")
            entry.refs -= 1

    # ---- insert + eviction -----------------------------------------------
    def _insert_site(self, chain: str) -> Tuple[Optional[_Entry], bool]:
        """Resolve ``chain`` for an insert: ``(live entry, blocked)``.
        A current-version entry is the idempotent-reinsert case; a
        stale-version one is replaced when droppable, else the insert
        is BLOCKED (a pinned/mid-chain stale entry cannot be dropped,
        and chaining fresh K/V onto it would make the new entry
        reachable only through an unmatchable parent)."""
        entry = self._entries.get(chain)
        if entry is None or entry.version == self._version:
            return entry, False
        if self._evictable(entry):
            self._drop(entry)
            return None, False
        return None, True

    def _parent_live(self, parent: str) -> bool:
        if parent == _ROOT:
            return True
        entry = self._entries.get(parent)
        return entry is not None and entry.version == self._version

    def put(self, parent: str, tokens: Sequence[int], k, v
            ) -> Optional[_Entry]:
        """Insert one captured block (its own single-block span) — the
        convenience form of :meth:`put_blocks` for direct engine users
        and tests; the scheduler inserts a whole chunk's blocks at once
        with one shared span."""
        out = self.put_blocks(parent, [tokens], k, v)
        return out[0] if out else None

    def put_block_ids(self, parent: str,
                      blocks: Sequence[Sequence[int]],
                      block_ids: Sequence[int]) -> List[_Entry]:
        """Paged-mode insert: capture consecutive completed blocks **by
        reference** — each new entry records the pool block id the
        prompt's K/V already lives in and takes one allocator reference
        (zero device reads, zero copies; the owning slot keeps its own
        reference and both decay independently).  Same chain semantics
        as :meth:`put_blocks`: idempotent per block (an existing entry
        is touched and returned — its block stays THE shared copy; the
        caller's duplicate block simply frees when its slot releases),
        stops at the first orphaned parent, and runs the LRU eviction
        pass with this call's own fresh entries protected."""
        if self._pool is None:
            raise ValueError("put_block_ids on a span-mode cache — "
                             "construct with pool=... (a paged engine's "
                             "block_pool)")
        if len(block_ids) != len(blocks):
            raise ValueError(
                f"{len(block_ids)} block ids for {len(blocks)} blocks")
        out: List[_Entry] = []
        created: List[_Entry] = []
        for block, bid in zip(blocks, block_ids):
            tokens = tuple(map(int, block))
            if len(tokens) != self.block_size:
                raise ValueError(
                    f"block of {len(tokens)} tokens != block_size "
                    f"{self.block_size} — only whole blocks are "
                    f"hashable")
            chain = self.chain_hash(parent, tokens)
            entry, blocked = self._insert_site(chain)
            if blocked:
                self._refused += 1
                break
            if entry is None:
                if not self._parent_live(parent):
                    self._refused += 1
                    break
                self._pool.ref([int(bid)])
                entry = _Entry(chain=chain, parent=parent, tokens=tokens,
                               block_id=int(bid), version=self._version)
                self._entries[chain] = entry
                self._children.setdefault(parent, set()).add(chain)
                self._inserted += 1
                created.append(entry)
            self._touch(entry)
            out.append(entry)
            parent = chain
        for entry in created:       # protected through the pass below
            entry.refs += 1
        try:
            self._evict_to_budget()
        finally:
            for entry in created:
                entry.refs -= 1
        return out

    def put_blocks(self, parent: str, blocks: Sequence[Sequence[int]],
                   k_span, v_span) -> List[_Entry]:
        """Insert consecutive captured blocks sharing ONE span buffer
        pair (``k_span`` / ``v_span``: ``[layers, len(blocks) *
        block_size, kv_heads, head_dim]`` — exactly the rows block 0
        starts at, in order).  Idempotent per block: an existing chain
        entry is touched and returned as-is (its original span is THE
        copy; a re-capture of the same chain is bit-identical by the
        exactness contract anyway).  Stops — returning the entries
        inserted so far — at the first block whose parent chain is gone
        (evicted mid-prefill under a tight budget): an orphaned entry
        could never be matched and would leak budget forever.

        After the inserts, evicts LRU-childless-unpinned entries until
        the token budget holds again — this call's own fresh entries
        are protected from its own eviction pass, so the returned
        entries are always LIVE (callers pin them before any later
        insert can run).  When every entry is pinned or has live
        children the store may transiently exceed the budget rather
        than corrupt a chain a live slot is feeding.
        """
        if self._pool is not None:
            raise ValueError("put_blocks on a paged cache — capture is "
                             "by reference there (put_block_ids)")
        rows = int(k_span.shape[1])
        if rows != len(blocks) * self.block_size:
            raise ValueError(
                f"span of {rows} rows != {len(blocks)} blocks x "
                f"block_size {self.block_size}")
        nbytes = k_span.nbytes + v_span.nbytes
        span = _Span(k=k_span, v=v_span, nbytes=nbytes)
        out: List[_Entry] = []
        created: List[_Entry] = []
        for i, block in enumerate(blocks):
            tokens = tuple(map(int, block))
            if len(tokens) != self.block_size:
                raise ValueError(
                    f"block of {len(tokens)} tokens != block_size "
                    f"{self.block_size} — only whole blocks are "
                    f"hashable")
            chain = self.chain_hash(parent, tokens)
            entry, blocked = self._insert_site(chain)
            if blocked:
                self._refused += 1
                break
            if entry is None:
                if not self._parent_live(parent):
                    self._refused += 1
                    break
                entry = _Entry(chain=chain, parent=parent, tokens=tokens,
                               span=span, lo=i * self.block_size,
                               version=self._version)
                self._entries[chain] = entry
                self._children.setdefault(parent, set()).add(chain)
                if span.live == 0:
                    self._span_bytes += span.nbytes
                span.live += 1
                self._inserted += 1
                created.append(entry)
            self._touch(entry)
            out.append(entry)
            parent = chain
        # the call's own fresh entries are pinned THROUGH the eviction
        # pass: without this, a tight budget whose every other entry is
        # pinned would evict the blocks just inserted before the caller
        # can acquire them — handing back dead entries, killing the
        # chain a live prefill is extending.  The returned
        # entries are guaranteed live; callers pin them before any
        # later insert can run.
        for entry in created:
            entry.refs += 1
        try:
            self._evict_to_budget()
        finally:
            for entry in created:
                entry.refs -= 1
        return out

    @staticmethod
    def gather_kv(entries: Sequence[_Entry]) -> Tuple[object, object]:
        """Concatenate a matched chain's K/V for restore, slicing each
        span at most once: consecutive entries from the same span
        coalesce into one slice (a whole span passes through with no
        device op at all), so restoring a chain captured from one
        chunk costs one slice — not one per block."""
        if not entries:
            raise ValueError("gather_kv of an empty chain")
        if any(e.span is None for e in entries):
            raise ValueError("gather_kv of paged (by-reference) entries "
                             "— alias their block_ids instead of "
                             "materializing K/V")
        parts_k, parts_v = [], []
        i = 0
        while i < len(entries):
            first = entries[i]
            j = i
            while (j + 1 < len(entries)
                   and entries[j + 1].span is first.span
                   and entries[j + 1].lo == entries[j].lo
                   + len(entries[j].tokens)):
                j += 1
            hi = entries[j].lo + len(entries[j].tokens)
            if first.lo == 0 and hi == int(first.span.k.shape[1]):
                parts_k.append(first.span.k)
                parts_v.append(first.span.v)
            else:
                parts_k.append(first.span.k[:, first.lo:hi])
                parts_v.append(first.span.v[:, first.lo:hi])
            i = j + 1
        if len(parts_k) == 1:
            return parts_k[0], parts_v[0]
        return torch.cat(parts_k, dim=1), torch.cat(parts_v, dim=1)

    def _evictable(self, entry: _Entry) -> bool:
        return not entry.refs and not self._children.get(entry.chain)

    def _drop(self, victim: _Entry) -> int:
        """Remove one entry and release its payload: span accounting in
        dense mode, one allocator dereference in paged mode.  Returns
        pool blocks actually freed (0 unless paged and no slot still
        shares the block)."""
        del self._entries[victim.chain]
        siblings = self._children.get(victim.parent)
        if siblings is not None:
            siblings.discard(victim.chain)
            if not siblings:
                del self._children[victim.parent]
        self._children.pop(victim.chain, None)
        freed = 0
        if victim.block_id is not None:
            freed = self._pool.deref([victim.block_id])
        else:
            victim.span.live -= 1
            if victim.span.live == 0:
                # last entry of the span gone: its device buffers are
                # droppable now (nothing else references them)
                self._span_bytes -= victim.span.nbytes
        self._evicted += 1
        return freed

    def _evict_to_budget(self) -> None:
        while self.cached_tokens > self.max_tokens:
            victim = next(
                (e for e in self._entries.values() if self._evictable(e)),
                None)               # oldest-first: dict order IS LRU order
            if victim is None:
                # everything left is pinned or mid-chain: exceeding the
                # budget transiently beats corrupting a live chain
                return
            self._drop(victim)

    # ---- paged-mode reclaim ----------------------------------------------
    def evictable_blocks(self) -> int:
        """Blocks eviction could return to the pool RIGHT NOW: unpinned
        childless entries whose pool block nothing else references (a
        shared block survives its entry's eviction until every aliasing
        slot releases, so counting it would let admission overcommit —
        the gate's reservation math needs a pessimistic floor, and
        deeper chain links freed by cascading evictions only make the
        true count higher).  Span-mode entries always free with their
        entry."""
        return sum(
            1 for e in self._entries.values()
            if self._evictable(e) and (
                self._pool is None
                or self._pool.refcount(e.block_id) == 1))

    def evict_blocks(self, n_blocks: int) -> int:
        """Free pool blocks under memory pressure by evicting LRU
        unpinned leaf entries until ``n_blocks`` blocks actually
        returned to the pool (or nothing evictable remains) — the
        block-granular backpressure hook a paged engine's allocator
        calls before raising ``BlockPoolExhausted``.  Returns blocks
        freed; pinned chains are never touched (a live prefill's chain
        beats new admissions)."""
        if self._pool is None:
            raise ValueError("evict_blocks on a span-mode cache")
        freed = 0
        while freed < n_blocks:
            victim = next(
                (e for e in self._entries.values() if self._evictable(e)),
                None)
            if victim is None:
                break
            freed += self._drop(victim)
        return freed

    def clear(self) -> None:
        """Drop every entry (refuses while any entry is pinned — a live
        slot is still being fed from the store)."""
        pinned = [e.chain for e in self._entries.values() if e.refs]
        if pinned:
            raise ValueError(
                f"clear() with {len(pinned)} pinned entr"
                f"{'y' if len(pinned) == 1 else 'ies'} — release the "
                f"live slots first")
        if self._pool is not None:
            self._pool.deref([e.block_id for e in self._entries.values()
                              if e.block_id is not None])
        self._entries.clear()
        self._children.clear()
        self._span_bytes = 0
