"""Paged decode KV cache: a global block pool + per-slot block tables.

Counterpart of ``apex_tpu/serving/paged_kv_cache.py``.  In place of the
dense cache's ``[layers, slots, max_len, ...]`` buffer, a global pool of
fixed-size blocks

    ``k`` / ``v``: ``[layers, num_blocks + 1, block_size, kv_heads, head_dim]``

and a per-slot block table ``tables[slot, i] -> pool block id``: memory
follows the tokens in use, concurrency is priced in blocks, and
cross-request prefix reuse is table aliasing (a hit writes the shared
block ids into the new slot's table, with host refcounts deciding when a
block frees; a write into a block held more than once copies it first).

Attention reads a slot's K/V as the fixed-extent view ``pool[table[slot]]
-> [max_len, kv_heads, head_dim]``, contiguous, with the layout and
strides of the dense cache's rows, masked at ``-1e30`` past the committed
length: the valid rows hold the values the dense cache would hold, the
reduction extents and operand strides are the same, so the logits equal
the dense engine's bit for bit.

Layout invariants:

- **Block 0 is the null block**: never allocated, never read unmasked,
  finite zeros (an int8 pool's scales are 1.0 there), since a masked read
  multiplies it by exact-zero probabilities and a NaN would poison the PV
  product.  Free slots' table entries are 0.
- **Block ``num_blocks`` is the sink**: one block past the pool the
  manager hands out, written and never read.  A row the JAX cache drops
  with ``mode="drop"`` (its table entry the null block, its position
  ``< 0`` — an inactive decode lane — or ``>= max_len``) is written here
  instead: PyTorch has no drop mode, and an out-of-range index on the
  card is a device assert that ends the context.  Every row's target is
  computed on the device, with no host read of ``lengths``.
- The host :class:`PagedCacheManager` owns allocation, refcounts,
  copy-on-write planning and the table mirror; the device ``tables`` are
  brought up to date (one small host-to-device copy) only when the
  manager says they changed, so a decode step inside a block copies
  nothing.

As everywhere in the port, the device functions update the cache in
place and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.amp.quant import dequantize_int8
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.serving.kv_cache import write_rows

__all__ = ["PagedCacheConfig", "PagedKVCache", "QuantPagedKVCache",
           "BlockPoolExhausted", "PagedCacheManager", "init_paged_cache",
           "init_quant_paged_cache", "paged_prefill_write",
           "paged_append", "decode_view", "prefill_view",
           "bytes_per_block", "blocks_per_slot"]

NULL_BLOCK = 0          # reserved: finite zeros, never allocated


class BlockPoolExhausted(RuntimeError):
    """No free block in the pool (and reclaim, if any, freed none):
    block-granular out-of-memory backpressure.  Raised, never clamped: a
    clamped write would corrupt another stream's block."""


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Opt-in knob for the paged layout
    (``DecodeEngine(..., paged=PagedCacheConfig(...))``).

    ``block_size``: tokens a pool block.  ``num_blocks``: pool blocks
    *including* the null block (``None``: dense-capacity parity, ``slots
    * ceil(max_len / block_size) + 1``).  The sink block comes on top."""

    block_size: int = 16
    num_blocks: Optional[int] = None

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (the null block plus at least "
                f"one allocatable), got {self.num_blocks}")


@dataclasses.dataclass
class PagedKVCache:
    """Block-pool decode cache.

    ``k`` / ``v``: ``[layers, num_blocks + 1, block_size, kv_heads,
    head_dim]`` (the last block the sink); ``tables``: ``[slots,
    blocks_per_slot]`` int64 pool block ids (0 = the null block);
    ``lengths``: ``[slots]`` int32 valid tokens a slot; ``max_len``: the
    per-slot capacity, which ``blocks_per_slot * block_size`` may exceed
    (reads slice the gathered view back to ``max_len`` rows)."""

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor
    max_len: int

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_blocks(self) -> int:
        """Pool blocks the manager knows, the null block included (the
        sink is not one of them)."""
        return self.k.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_slots(self) -> int:
        return self.tables.shape[0]

    @property
    def blocks_per_slot(self) -> int:
        return self.tables.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.k.dtype


@dataclasses.dataclass
class QuantPagedKVCache(PagedKVCache):
    """The int8 twin of :class:`PagedKVCache`: int8 payload pools and fp32
    scale pools ``k_scale`` / ``v_scale`` ``[layers, num_blocks + 1,
    block_size, kv_heads]`` indexed by the same block ids, so aliasing,
    copy-on-write, fork and release move payload and scales together."""

    k_scale: torch.Tensor = None
    v_scale: torch.Tensor = None


def blocks_per_slot(max_len: int, block_size: int) -> int:
    """Table width: blocks covering ``max_len`` rows (ceil division)."""
    return -(-int(max_len) // int(block_size))


def bytes_per_block(cache) -> int:
    """Resident bytes one pool block pins across every layer and pool
    array (an int8 pool's scale pools ride the same block ids, so their
    bytes count)."""
    pools = [cache.k, cache.v]
    if isinstance(cache, QuantPagedKVCache):
        pools += [cache.k_scale, cache.v_scale]
    total = 0
    for arr in pools:
        shape = arr.shape            # [L, num_blocks + 1, block_size, ...]
        total += arr.element_size() * int(np.prod((shape[0],) + shape[2:]))
    return int(total)


def _shapes(config: Any, slots: int, max_len: int, block_size: int,
            num_blocks: int):
    head_dim = config.hidden_size // config.num_attention_heads
    pool = (config.num_hidden_layers, num_blocks + 1, block_size,
            config.kv_heads, head_dim)
    return pool, (slots, blocks_per_slot(max_len, block_size))


def init_paged_cache(config: Any, *, slots: int, max_len: int,
                     block_size: int, num_blocks: int,
                     dtype: torch.dtype = torch.float32,
                     device="cuda") -> PagedKVCache:
    """Zero-filled pool for ``config`` (``LlamaConfig``-shaped), the sink
    block after its ``num_blocks``.  Every table entry starts at the null
    block."""
    dev = resolve_device(device)
    pool, table = _shapes(config, slots, max_len, block_size, num_blocks)
    return PagedKVCache(
        k=torch.zeros(pool, dtype=dtype, device=dev),
        v=torch.zeros(pool, dtype=dtype, device=dev),
        tables=torch.zeros(table, dtype=torch.int64, device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=dev),
        max_len=int(max_len))


def init_quant_paged_cache(config: Any, *, slots: int, max_len: int,
                           block_size: int, num_blocks: int,
                           device="cuda") -> QuantPagedKVCache:
    """Zero-filled int8 pool; scales start at 1.0, so the null block and
    every unallocated block dequantize to finite zeros."""
    dev = resolve_device(device)
    pool, table = _shapes(config, slots, max_len, block_size, num_blocks)
    return QuantPagedKVCache(
        k=torch.zeros(pool, dtype=torch.int8, device=dev),
        v=torch.zeros(pool, dtype=torch.int8, device=dev),
        tables=torch.zeros(table, dtype=torch.int64, device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=dev),
        max_len=int(max_len),
        k_scale=torch.ones(pool[:-1], dtype=torch.float32, device=dev),
        v_scale=torch.ones(pool[:-1], dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# device ops: writes routed to the sink where JAX drops, fixed-extent reads
# ---------------------------------------------------------------------------


def _route_rows(cache: PagedKVCache, table_row: torch.Tensor,
                rows: torch.Tensor):
    """Map logical slot rows to ``(physical block, offset in block)`` on
    the device.  A row ``< 0`` (an inactive lane), ``>= max_len`` (bucket
    padding past capacity) or whose table entry is the null block
    (padding past the allocated frontier, a released slot) goes to the
    sink block.  ``table_row`` is one slot's table ``[bps]`` (a prefill
    chunk) or every slot's ``[slots, bps]`` with one row a slot (decode:
    row i reads slot i's own table)."""
    bs = cache.block_size
    safe = rows.clamp(0, cache.max_len - 1)
    blk = torch.div(safe, bs, rounding_mode="floor").clamp(
        0, cache.blocks_per_slot - 1)
    if table_row.dim() == 2:
        entry = torch.gather(table_row, 1, blk[:, None])[:, 0]
    else:
        entry = table_row[blk]
    ok = (rows >= 0) & (rows < cache.max_len) & (entry > NULL_BLOCK)
    phys = torch.where(ok, entry, torch.full_like(entry, cache.num_blocks))
    return phys, safe % bs


def paged_prefill_write(cache: PagedKVCache, layer: int, slot: int, k_seq,
                        v_seq, start: int = 0) -> PagedKVCache:
    """Write one (padded) prompt chunk's K/V ``[chunk, kv_heads,
    head_dim]`` through ``slot``'s table at row ``start``, in place (the
    paged twin of ``kv_cache.prefill_into_slot``).  Padding past the
    allocated frontier or past ``max_len`` goes to the sink, so no
    padding row ever lands in a live block.  ``lengths`` is left to the
    caller."""
    rows = int(start) + torch.arange(k_seq.shape[0], device=k_seq.device)
    phys, within = _route_rows(cache, cache.tables[slot], rows)
    write_rows(cache, (layer, phys, within), k_seq, v_seq)
    return cache


def paged_append(cache: PagedKVCache, layer: int, k_tok, v_tok,
                 positions: torch.Tensor) -> PagedKVCache:
    """Write one token's K/V a slot ``[slots, kv_heads, head_dim]`` at that
    slot's position, in place (the paged twin of
    ``kv_cache.append_token``).  ``positions [slots]`` is the slot's depth,
    or -1 for an inactive lane, whose write goes to the sink: a paged table
    has no private masked rows for it."""
    phys, within = _route_rows(cache, cache.tables, positions.long())
    write_rows(cache, (layer, phys, within), k_tok, v_tok)
    return cache


def _gathered(cache: PagedKVCache, arr: torch.Tensor,
              tables: torch.Tensor) -> torch.Tensor:
    """``arr`` (one layer's pool, ``[blocks, block_size, ...]``) gathered
    through ``tables`` (``[bps]`` or ``[slots, bps]``) into contiguous
    token rows, cut to exactly ``max_len``: the dense cache's layout and
    strides."""
    g = arr[tables]                          # [..., bps, bs, *tail]
    lead = tables.dim() - 1
    flat = g.reshape(g.shape[:lead] + (g.shape[lead] * g.shape[lead + 1],)
                     + g.shape[lead + 2:])
    return flat.narrow(lead, 0, cache.max_len).contiguous()


def _view(cache, layer: int, tables: torch.Tensor):
    k = _gathered(cache, cache.k[layer], tables)
    v = _gathered(cache, cache.v[layer], tables)
    if isinstance(cache, QuantPagedKVCache):
        return (dequantize_int8(k, _gathered(cache, cache.k_scale[layer],
                                             tables)),
                dequantize_int8(v, _gathered(cache, cache.v_scale[layer],
                                             tables)))
    return k, v


def decode_view(cache, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every slot's K/V as ``[slots, max_len, kv_heads, head_dim]``: the
    batched decode read, with the shape, strides and masked-read contract
    of the dense ``kv_cache.decode_read`` (dequantized fp32 for an int8
    pool)."""
    return _view(cache, layer, cache.tables)


def prefill_view(cache, layer: int, slot: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's K/V as ``[max_len, kv_heads, head_dim]``: the
    chunked-prefill read, as :func:`decode_view` gives it."""
    return _view(cache, layer, cache.tables[slot])


def copy_block(cache, src: int, dst: int) -> None:
    """Copy-on-write: pool block ``src`` -> ``dst`` across every layer,
    payload and scales, in place.  Runs before the write that needed it,
    so the writer lands on a private copy and the sharers keep theirs."""
    for arr in ([cache.k, cache.v, cache.k_scale, cache.v_scale]
                if isinstance(cache, QuantPagedKVCache)
                else [cache.k, cache.v]):
        arr[:, dst] = arr[:, src]


# ---------------------------------------------------------------------------
# host-side allocation: refcounts, block tables, CoW planning
# ---------------------------------------------------------------------------


class PagedCacheManager:
    """Host bookkeeping for one paged cache: a free-list allocator with
    per-block refcounts, the per-slot table mirror, and copy-on-write
    planning.

    Pure host state, updated at dispatch boundaries: the engine copies the
    table mirror to the device only when :meth:`consume_dirty` reports a
    change, and runs the CoW copies :meth:`ensure` returns before the
    write that needed them.  Every user of a block holds one reference:
    the owning slot's table, each aliasing slot's table, each prefix-cache
    entry.  A block frees (back to the LIFO free list: deterministic ids)
    when its count reaches zero; a write into a block with count > 1 must
    copy it first, which keeps sharers bit-isolated.

    ``reclaim``: optional callback ``(n_blocks) -> freed``, called once
    when the free list runs dry (the scheduler wires prefix-cache eviction
    here); if the list is still empty the allocation raises
    :class:`BlockPoolExhausted`.
    """

    def __init__(self, *, slots: int, max_len: int, block_size: int,
                 num_blocks: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if not 1 <= block_size <= max_len:
            raise ValueError(
                f"block_size {block_size} must be in [1, max_len "
                f"{max_len}]")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (null block + 1), got "
                f"{num_blocks}")
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.blocks_per_slot = blocks_per_slot(max_len, block_size)
        self._refs = np.zeros((num_blocks,), np.int64)
        # LIFO free list, block 0 (null) excluded forever
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._tables = np.zeros((self.slots, self.blocks_per_slot),
                                np.int64)
        self._owned = np.zeros((self.slots,), np.int64)
        self._dirty = True          # fresh mirror vs whatever device held
        self.reclaim: Optional[Callable[[int], int]] = None
        # cumulative structural accounting
        self.allocated_total = 0
        self.freed_total = 0
        self.cow_total = 0
        self.aliased_total = 0
        self.high_water = 0         # most blocks in use at once

    # ---- introspection ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Allocated (non-null) blocks."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def utilization(self) -> float:
        """Allocated blocks / allocatable blocks, in ``[0, 1]``."""
        return self.used_blocks / max(self.num_blocks - 1, 1)

    def refcount(self, block_id: int) -> int:
        return int(self._refs[block_id])

    def slot_block_ids(self, slot: int) -> List[int]:
        """The slot's allocated pool blocks, in token order."""
        return [int(b) for b in self._tables[slot, :self._owned[slot]]]

    def owned_blocks(self, slot: int) -> int:
        """How many table entries the slot holds."""
        return int(self._owned[slot])

    def table_snapshot(self) -> np.ndarray:
        return self._tables.copy()

    def consume_dirty(self) -> bool:
        """True exactly once after any mirror change: the engine's
        copy-only-when-needed signal."""
        dirty, self._dirty = self._dirty, False
        return dirty

    def stats(self) -> dict:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "used_blocks": self.used_blocks,
                "free_blocks": self.free_blocks,
                "high_water": self.high_water,
                "allocated_total": self.allocated_total,
                "freed_total": self.freed_total,
                "cow_total": self.cow_total,
                "aliased_total": self.aliased_total}

    # ---- refcounting -----------------------------------------------------
    def ref(self, block_ids: Sequence[int]) -> None:
        """Add one reference a block (a prefix-cache entry, an aliasing
        slot).  All or nothing: every id is checked before any count
        moves."""
        for b in block_ids:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"block id {b} out of pool range "
                                 f"(1, {self.num_blocks})")
            if self._refs[b] < 1:
                raise ValueError(
                    f"ref of free block {b} — a reference must derive "
                    f"from a live owner (alias what exists, never "
                    f"resurrect)")
        for b in block_ids:
            self._refs[b] += 1

    def deref(self, block_ids: Sequence[int]) -> int:
        """Drop one reference a block; blocks reaching zero go back to the
        free list.  Returns how many freed.  All or nothing like
        :meth:`ref` (duplicates in one call count against one
        refcount)."""
        seen: dict = {}
        for b in block_ids:
            seen[b] = seen.get(b, 0) + 1
            if self._refs[b] < seen[b]:
                raise ValueError(f"deref of unreferenced block {b} — "
                                 f"ref/deref must pair")
        freed = 0
        for b in block_ids:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(int(b))
                self.freed_total += 1
                freed += 1
        return freed

    # ---- allocation + CoW ------------------------------------------------
    def _alloc_one(self) -> int:
        if not self._free and self.reclaim is not None:
            self.reclaim(1)
        if not self._free:
            raise BlockPoolExhausted(
                f"KV block pool exhausted ({self.num_blocks - 1} blocks, "
                f"all referenced) — release streams, evict prefix-cache "
                f"entries, or size num_blocks for the offered load")
        b = self._free.pop()
        self._refs[b] = 1
        self.allocated_total += 1
        self.high_water = max(self.high_water, self.used_blocks)
        return b

    def ensure(self, slot: int, start: int, stop: int
               ) -> List[Tuple[int, int]]:
        """Make rows ``[start, stop)`` of ``slot`` writable in place:
        allocate the table entries the span needs, and plan a copy for
        every owned span block whose refcount exceeds one.  Returns the
        ``(src, dst)`` block pairs the caller copies on the device
        before the write.  Raises :class:`BlockPoolExhausted` (never
        clamps) when the pool cannot cover the span."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")
        if not 0 <= start < stop <= self.max_len:
            raise ValueError(
                f"write span [{start}, {stop}) outside [0, "
                f"{self.max_len}]")
        bs = self.block_size
        cow: List[Tuple[int, int]] = []
        for idx in range(start // bs, -(-stop // bs)):
            if idx >= self._owned[slot]:
                # the span grows the slot: fresh exclusive blocks, in
                # order (a gap would leave a null entry under rows)
                if idx != self._owned[slot]:
                    raise ValueError(
                        f"non-contiguous table growth for slot {slot}: "
                        f"block {idx} past frontier {self._owned[slot]}")
                self._tables[slot, idx] = self._alloc_one()
                self._owned[slot] += 1
                self._dirty = True
            else:
                old = int(self._tables[slot, idx])
                if self._refs[old] > 1:
                    new = self._alloc_one()
                    self._refs[old] -= 1     # the slot's own reference
                    self._tables[slot, idx] = new
                    self._dirty = True
                    self.cow_total += 1
                    cow.append((old, new))
        return cow

    def alias(self, slot: int, block_ids: Sequence[int],
              tokens: int) -> None:
        """Point an empty slot's table at shared blocks (a prefix-cache
        hit): no bytes move, each block gains a reference.  ``tokens`` is
        the valid-row count the ids cover (the caller commits it)."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")
        if self._owned[slot]:
            raise ValueError(
                f"alias into slot {slot} which owns "
                f"{int(self._owned[slot])} blocks — release it first")
        ids = [int(b) for b in block_ids]
        if len(ids) > self.blocks_per_slot:
            raise ValueError(
                f"{len(ids)} blocks exceed the table width "
                f"{self.blocks_per_slot}")
        if not 0 < tokens <= len(ids) * self.block_size:
            raise ValueError(
                f"{tokens} tokens not coverable by {len(ids)} blocks of "
                f"{self.block_size}")
        self.ref(ids)                      # validates liveness first
        self._tables[slot, :len(ids)] = ids
        self._owned[slot] = len(ids)
        self._dirty = True
        self.aliased_total += len(ids)

    def fork(self, src: int, dst: int) -> List[int]:
        """Share every block of ``src`` into empty slot ``dst``.  Either
        slot's next write into a shared block (the partial tail block both
        append into, too) copies it first, so the streams stay
        bit-isolated.  Returns the shared ids."""
        ids = self.slot_block_ids(src)
        if not ids:
            raise ValueError(f"fork of empty slot {src}")
        self.alias(dst, ids, tokens=len(ids) * self.block_size)
        self.aliased_total -= len(ids)     # a fork is not a prefix hit
        return ids

    def release(self, slot: int) -> int:
        """Drop the slot's references (blocks free unless shared) and zero
        its table row.  Returns blocks freed."""
        ids = self.slot_block_ids(slot)
        freed = self.deref(ids) if ids else 0
        if ids:
            self._tables[slot, :] = NULL_BLOCK
            self._owned[slot] = 0
            self._dirty = True
        return freed
