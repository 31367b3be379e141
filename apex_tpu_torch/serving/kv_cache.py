"""Slot-indexed dense decode KV cache, fp or int8.

Counterpart of ``apex_tpu/serving/kv_cache.py``.  The cache is
preallocated at ``[layers, slots, max_len, kv_heads, head_dim]`` and every
read covers the whole ``max_len`` axis under a per-slot length mask, so a
decode step has one shape whatever the mix of requests.

Unlike the JAX package, whose arrays are immutable and whose updates
return a new cache, the functions here **update the cache in place** and
return the same object, so no step copies the cache.

``lengths[slot]`` is the number of valid tokens in the slot.  Rows past
it are garbage by contract (stale evictions, prompt padding, the writes
of inactive decode lanes); every reader masks them.  Eviction is O(1):
zero the length, reuse the slot.

:class:`QuantKVCache` is the int8 twin: the payload as symmetric int8
with one fp32 scale per (position, kv head), quantized on write and
dequantized on read (:mod:`apex_tpu_torch.amp.quant`), so attention never
spells a scale.  Its scales start at 1.0, so an unused row dequantizes to
finite zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from apex_tpu_torch.amp.quant import dequantize_int8, quantize_int8
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["KVCache", "QuantKVCache", "init_cache", "init_quant_cache",
           "prefill_into_slot", "append_token", "commit_slot_length",
           "release_slot", "valid_token_mask", "read_slot_region",
           "write_slot_region", "decode_read", "slot_read", "value_dtype",
           "gather_slot_rows"]


@dataclasses.dataclass
class KVCache:
    """Preallocated decode cache: one slot per in-flight request.

    ``k`` / ``v``: ``[layers, slots, max_len, kv_heads, head_dim]``;
    ``lengths``: ``[slots]`` int32 on the same device, valid tokens per
    slot (0 = free).
    """

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.k.dtype


@dataclasses.dataclass
class QuantKVCache:
    """The int8 twin of :class:`KVCache`: ``k`` / ``v`` int8 ``[layers,
    slots, max_len, kv_heads, head_dim]``, ``k_scale`` / ``v_scale`` fp32
    ``[layers, slots, max_len, kv_heads]`` on the same rows, ``lengths``
    as in :class:`KVCache`."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    lengths: torch.Tensor

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        """The payload dtype (int8); reads give :func:`value_dtype`."""
        return self.k.dtype


def is_int8(cache) -> bool:
    """True for an int8 cache, dense or paged (its scales beside it)."""
    return hasattr(cache, "k_scale")


def value_dtype(cache) -> torch.dtype:
    """The dtype cache reads give: the payload's for an fp cache, fp32
    (the dequantized values) for an int8 one; what staging buffers for a
    restore must use (int8 staging would destroy the values before the
    requantize)."""
    return torch.float32 if is_int8(cache) else cache.dtype


def init_cache(config: Any, *, slots: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cuda") -> KVCache:
    """Zero-filled cache for ``config`` (``num_hidden_layers``,
    ``kv_heads``, ``hidden_size``, ``num_attention_heads``)."""
    dev = resolve_device(device)
    head_dim = config.hidden_size // config.num_attention_heads
    shape = (config.num_hidden_layers, slots, max_len, config.kv_heads,
             head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=torch.zeros((slots,), dtype=torch.int32,
                                       device=dev))


def init_quant_cache(config: Any, *, slots: int, max_len: int,
                     device="cuda") -> QuantKVCache:
    """Zero-filled int8 cache; scales start at 1.0 (the zero-amax
    convention), so every unused row dequantizes to finite zeros."""
    dev = resolve_device(device)
    head_dim = config.hidden_size // config.num_attention_heads
    shape = (config.num_hidden_layers, slots, max_len, config.kv_heads,
             head_dim)
    return QuantKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=dev),
        v=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=dev))


def write_rows(cache, index, k, v) -> None:
    """Write K/V rows at ``index`` (a tuple for the arrays' leading axes),
    in place: quantized per (row, head), scales on the same rows, on an
    int8 cache (dense or paged); cast to the cache's dtype on an fp one."""
    if is_int8(cache):
        kq, ks = quantize_int8(k, axis=-1)
        vq, vs = quantize_int8(v, axis=-1)
        cache.k[index], cache.v[index] = kq, vq
        cache.k_scale[index], cache.v_scale[index] = ks, vs
    else:
        cache.k[index] = k.to(cache.dtype)
        cache.v[index] = v.to(cache.dtype)


def _load(cache, index):
    """K/V rows at ``index``: views of an fp cache, dequantized fp32
    copies of an int8 one."""
    if is_int8(cache):
        return (dequantize_int8(cache.k[index], cache.k_scale[index]),
                dequantize_int8(cache.v[index], cache.v_scale[index]))
    return cache.k[index], cache.v[index]


def prefill_into_slot(cache: KVCache, layer: int, slot: int, k_seq, v_seq,
                      start: int = 0) -> KVCache:
    """Write one (padded) prompt chunk's K/V, ``[chunk, kv_heads,
    head_dim]``, into ``slot`` of ``layer`` at rows ``start..``, in place.

    Rows that would fall past ``max_len`` (bucket padding of a tail chunk
    near the cache end) are dropped, never clamped backward onto cached
    tokens.  Does not touch ``lengths``: the caller commits the slot's
    real length once per model call."""
    keep = max(0, min(k_seq.shape[0], cache.max_len - int(start)))
    rows = slice(int(start), int(start) + keep)
    write_rows(cache, (layer, slot, rows), k_seq[:keep], v_seq[:keep])
    return cache


def append_token(cache: KVCache, layer: int, k_tok, v_tok,
                 positions: torch.Tensor) -> KVCache:
    """Write one token's K/V per slot, ``[slots, kv_heads, head_dim]``,
    at that slot's own position (``positions [slots]``, normally
    ``cache.lengths``), in place.  A position past the end is clamped to
    the last row, as ``lax.dynamic_update_slice`` does in the JAX package
    (only an inactive lane can be there, and its row is masked)."""
    pos = positions.long().clamp(0, cache.max_len - 1)
    lanes = torch.arange(cache.num_slots, device=pos.device)
    write_rows(cache, (layer, lanes, pos), k_tok, v_tok)
    return cache


def commit_slot_length(cache: KVCache, slot: int, length: int) -> KVCache:
    """Set one slot's valid-token count, in place."""
    cache.lengths[slot] = int(length)
    return cache


def release_slot(cache: KVCache, slot: int) -> KVCache:
    """Free a slot for reuse: O(1), zero its length, leave the bytes."""
    cache.lengths[slot] = 0
    return cache


def read_slot_region(cache, slot: int, start: int, stop: int) -> tuple:
    """One slot's K/V rows ``[start, stop)`` across every layer, ``[layers,
    stop - start, kv_heads, head_dim]``: owned copies, not views, which a
    caller may keep across later writes (the prefix-cache capture).  An
    int8 cache hands out dequantized fp32 rows.  The caller keeps the span
    inside the slot's valid length."""
    n = int(stop) - int(start)
    if n < 1:
        raise ValueError(f"empty region [{start}, {stop})")
    k, v = _load(cache, (slice(None), slot, slice(int(start), int(stop))))
    return k.clone(), v.clone()


def write_slot_region(cache, slot: int, start: int, k_region,
                      v_region):
    """Write a K/V span ``[layers, n, kv_heads, head_dim]`` into one slot
    across every layer at row ``start``, in place (the prefix-cache
    restore).  Rows past ``max_len`` are dropped, never clamped back onto
    cached tokens; an int8 cache requantizes the rows (the payload of
    rows it handed out comes back bit for bit).  ``lengths`` is left to
    the caller."""
    keep = max(0, min(k_region.shape[1], cache.max_len - int(start)))
    rows = slice(int(start), int(start) + keep)
    write_rows(cache, (slice(None), slot, rows), k_region[:, :keep],
           v_region[:, :keep])
    return cache


def gather_slot_rows(cache, slot: int, rows: torch.Tensor):
    """One slot's K/V at the row indices ``rows`` across every layer,
    ``[layers, len(rows), kv_heads, head_dim]`` (dequantized fp32 for an
    int8 cache)."""
    return _load(cache, (slice(None), slot, rows))


def decode_read(cache, layer: int):
    """Every slot's K/V of one layer, ``[slots, max_len, kv_heads,
    head_dim]``: views of an fp cache, the dequantized fp32 values of an
    int8 one."""
    return _load(cache, (layer,))


def slot_read(cache, layer: int, slot: int):
    """One slot's K/V of one layer, ``[max_len, kv_heads, head_dim]``
    (the chunked-prefill read), as :func:`decode_read` gives them."""
    return _load(cache, (layer, slot))


def valid_token_mask(positions: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[slots, max_len]`` bool, True where ``idx <= position``: the
    decode read mask (``positions`` the pre-append lengths), the
    ``idx <= bound`` rule ``models.llama._cached_attention`` applies per
    query row."""
    idx = torch.arange(max_len, device=positions.device)[None, :]
    return idx <= positions.long()[:, None]
