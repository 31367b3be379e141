"""DecodeEngine: bucketed chunked prefill + batched single-token decode
over a dense KV cache.

Counterpart of the dense, single-chip part of
``apex_tpu/serving/engine.py``.  The engine wraps a
:class:`~apex_tpu_torch.models.llama.LlamaForCausalLM` whose weights live
on the engine's device:

- **prefill**: a prompt is cached in ``prefill_len``-sized chunks, each
  padded to the smallest covering bucket of ``prefill_buckets``; a
  chunk's causal block attends everything the slot already cached, so
  splitting a prompt changes no result.  The returned logits are the fp32
  next-token distribution after the chunk's last real token.
- **decode**: one step for every slot at once; inactive lanes still
  compute (one shape per step) and write their K/V at their slot's
  length, but their lengths do not advance, so the write stays masked
  until the next prefill chunk overwrites it.

There is no jit: the JAX program bodies ``_prefill`` and ``_decode`` are
plain methods here, run under ``torch.inference_mode()``.  The cache is
updated in place.  A host mirror of the slot lengths lets every call
check slot bounds and capacity without reading the device.

Sampling is a function of ``(logits, seed, token index, temperature,
top_k)``: a sampled row reseeds the engine's ``torch.Generator`` from the
request's seed and the token's index before it draws, so a request
replays to the same stream.  ``temperature <= 0`` is greedy.  The draws
are PyTorch's, not ``jax.random``'s, so a sampled stream repeats under a
fixed seed but differs from the JAX engine's.

Paged caches, tensor parallelism, quantization and speculative decoding
come with later slices of the port; their arguments raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.serving.kv_cache import (
    commit_slot_length,
    init_cache,
    release_slot,
)

__all__ = ["DecodeEngine", "default_prefill_buckets", "no_tf32",
           "token_seed"]


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and convolutions
    (``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.backends.cudnn.allow_tf32``) inside the block; both flags as
    they were after it, however it ends."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def default_prefill_buckets(prefill_len: int, floor: int = 16) -> tuple:
    """Power-of-two chunk-size table ``(floor, 2*floor, ..., prefill_len)``.

    A prompt (or prompt chunk) is padded to the smallest covering bucket,
    so a short prompt costs a short forward while the set of chunk shapes
    stays logarithmic in ``prefill_len``."""
    if floor < 2:
        raise ValueError(f"bucket floor must be >= 2, got {floor}")
    if prefill_len <= floor:
        return (prefill_len,)
    out, b = [], floor
    while b < prefill_len:
        out.append(b)
        b *= 2
    out.append(prefill_len)
    return tuple(out)


def token_seed(seed: int, index: int) -> int:
    """The generator seed of the ``index``-th generated token of a request
    seeded with ``seed`` (the port's counterpart of ``fold_in``)."""
    return (int(seed) % (1 << 32)) << 32 | (int(index) % (1 << 32))


def _not_yet(name: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}= comes with the {slice_name} slice of the port; this "
        f"engine serves the dense single-chip path")


class DecodeEngine:
    """KV-cached incremental decoding for a Llama-family model.

    >>> eng = DecodeEngine(model, slots=8, max_len=2048, prefill_len=512)
    >>> first_logits = eng.prefill(slot=0, tokens=prompt_ids)
    >>> logits = eng.decode(tokens, active)       # one step, all slots
    >>> eng.release(0)                            # O(1) slot reuse

    ``device`` defaults to CUDA and must be where ``model``'s weights
    are; the engine never moves them.  It puts the model in eval mode and
    leaves its parameters' ``requires_grad`` as they are (the model calls
    run under ``inference_mode``).  On CUDA each model call runs with TF32
    off for matrix products and convolutions (:func:`no_tf32`), so fp32
    runs in fp32; the process's flags are restored after each call.
    """

    def __init__(self, model, *, slots: int = 8, max_len: int = 512,
                 prefill_len: int = 64,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 device="cuda", paged=None, tp=None, quant=None):
        for name, value, slice_name in (
                ("paged", paged, "paged-serving"),
                ("tp", tp, "tensor-parallel serving"),
                ("quant", quant, "quantized serving")):
            if value is not None:
                raise _not_yet(name, slice_name)
        self.device = resolve_device(device)
        if prefill_len < 2:
            raise ValueError("prefill_len must be >= 2 (a length-1 "
                             "prefill is indistinguishable from a decode "
                             "step; pad the buffer)")
        if prefill_len > max_len:
            raise ValueError(f"prefill_len {prefill_len} > max_len "
                             f"{max_len}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(int(prefill_len))
        buckets = tuple(int(b) for b in prefill_buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"prefill_buckets must be non-empty, "
                             f"strictly ascending ints, got {buckets}")
        if buckets[0] < 2:
            raise ValueError(f"prefill buckets must be >= 2 (a 1-row "
                             f"chunk is indistinguishable from a decode "
                             f"step), got {buckets}")
        if buckets[-1] != int(prefill_len):
            raise ValueError(
                f"the largest prefill bucket must equal prefill_len "
                f"{prefill_len} (it is the full-chunk shape), got "
                f"{buckets}")
        params = list(model.parameters())
        wrong = {str(p.device) for p in params if p.device != self.device}
        if wrong:
            raise ValueError(f"model weights lie on {sorted(wrong)}, the "
                             f"engine runs on {self.device}: move the model "
                             f"first")
        if cache_dtype is None:
            # serve in the weights' own precision (bf16 weights -> bf16
            # cache); fp32 for a tree with no float leaves
            floats = [p.dtype for p in params if p.dtype.is_floating_point]
            cache_dtype = floats[0] if floats else torch.float32
        # eval mode only: the model calls run under inference_mode, so the
        # caller's parameters keep requires_grad and the model stays
        # trainable after it has been served
        self.model = model.eval()
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prefill_len = int(prefill_len)
        self.prefill_buckets = buckets
        self._cache = init_cache(model.config, slots=self.slots,
                                 max_len=self.max_len, dtype=cache_dtype,
                                 device=self.device)
        self._lengths_host = np.zeros((self.slots,), np.int64)
        self._sampler = torch.Generator(device=self.device)
        # model calls run with the engine's card as the current device and
        # TF32 off
        self._cuda = self.device.type == "cuda"
        # model calls made, for callers that account per call
        self.prefill_chunks = 0
        self.decode_steps = 0

    @contextlib.contextmanager
    def _on_device(self):
        """The engine's card as the current device and TF32 off, on CUDA."""
        if not self._cuda:
            yield
            return
        with torch.cuda.device(self.device), no_tf32():
            yield

    # ---- cache/slot state ------------------------------------------------
    def lengths(self) -> np.ndarray:
        """Per-slot valid-token counts (0 = free), from the host mirror."""
        return self._lengths_host.copy()

    def free_slots(self) -> list:
        return [i for i, n in enumerate(self._lengths_host) if n == 0]

    def cache_utilization(self) -> float:
        """Filled cache positions / total capacity, in ``[0, 1]``."""
        return float(self._lengths_host.sum()) / float(
            self.slots * self.max_len)

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")

    def release(self, slot: int) -> None:
        """Evict a slot (O(1)); its bytes stay masked until overwritten."""
        self._check_slot(slot)
        release_slot(self._cache, slot)
        self._lengths_host[slot] = 0

    def reset(self) -> None:
        """Free every slot (keeps the cache allocation)."""
        self._cache.lengths.zero_()
        self._lengths_host[:] = 0

    def bucket_for(self, n: int) -> int:
        """Smallest prefill bucket covering an ``n``-token chunk."""
        if not 1 <= n <= self.prefill_len:
            raise ValueError(f"chunk length {n} not in [1, "
                             f"{self.prefill_len}]")
        return next(b for b in self.prefill_buckets if b >= n)

    # ---- model calls -----------------------------------------------------
    def prefill_chunk(self, slot: int, tokens: Sequence[int]) -> torch.Tensor:
        """Cache one prompt chunk (``<= prefill_len`` tokens) at ``slot``'s
        current depth; returns the fp32 next-token logits ``[vocab]``
        after the chunk's last real token.  Callers feed the chunks of one
        prompt in order (the scheduler does; :meth:`prefill` also guards
        against clobbering a live stream)."""
        self._check_slot(slot)
        n = len(tokens)
        bucket = self.bucket_for(n)
        offset = int(self._lengths_host[slot])
        if offset + n > self.max_len:
            raise ValueError(
                f"chunk of {n} tokens at offset {offset} overruns cache "
                f"max_len {self.max_len}")
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :n] = torch.as_tensor(list(tokens), dtype=torch.long)
        with self._on_device(), torch.inference_mode():
            logits, _ = self.model(ids.to(self.device), kv_cache=self._cache,
                                   slot=slot, position=offset)
            commit_slot_length(self._cache, slot, offset + n)
            last = logits[n - 1, 0].float()
        self._lengths_host[slot] = offset + n
        self.prefill_chunks += 1
        return last

    def prefill(self, slot: int, tokens: Sequence[int], *,
                resume: int = 0) -> torch.Tensor:
        """Fill ``slot`` with a whole prompt (chunked as needed); return
        its fp32 next-token logits ``[vocab]``.  ``resume`` (resuming over
        a restored prefix) comes with prefix caching in a later slice of
        the port: only 0 is taken."""
        if resume:
            raise _not_yet("resume", "prefix-caching")
        self._check_slot(slot)
        n = len(tokens)
        if not 1 <= n <= self.max_len:
            raise ValueError(f"prompt length {n} not in [1, "
                             f"{self.max_len}] (cache capacity)")
        if self._lengths_host[slot]:
            raise ValueError(
                f"slot {slot} is occupied ({self._lengths_host[slot]} "
                f"tokens); release() it before prefilling — silently "
                f"clobbering a live stream is the corruption class these "
                f"guards exist for")
        logits = None
        for start in range(0, n, self.prefill_len):
            logits = self.prefill_chunk(
                slot, tokens[start:start + self.prefill_len])
        return logits

    def decode(self, tokens, active) -> torch.Tensor:
        """One batched decode step: append ``tokens[slot]`` to every active
        slot, return per-slot fp32 next-token logits ``[slots, vocab]``.
        Inactive lanes return garbage rows; callers mask by ``active``.
        Raises when an active slot is at ``max_len`` or was never
        prefilled."""
        act = np.asarray(active, bool)
        full = act & (self._lengths_host >= self.max_len)
        if full.any():
            raise ValueError(
                f"slots {np.flatnonzero(full).tolist()} are at cache "
                f"capacity ({self.max_len}); release or raise max_len")
        empty = act & (self._lengths_host == 0)
        if empty.any():
            raise ValueError(
                f"slots {np.flatnonzero(empty).tolist()} are active but "
                f"never prefilled — a decode step would expose a garbage "
                f"token as their whole context")
        ids = torch.as_tensor(np.asarray(tokens, np.int64)).to(self.device)
        step = torch.as_tensor(act.astype(np.int32)).to(self.device)
        with self._on_device(), torch.inference_mode():
            logits, _ = self.model(ids[:, None], kv_cache=self._cache,
                                   position=self._cache.lengths)
            self._cache.lengths += step
            out = logits[0].float()
        self._lengths_host[act] += 1
        self.decode_steps += 1
        return out

    # ---- sampling --------------------------------------------------------
    def sample(self, logits: torch.Tensor, seeds, indices, temperatures,
               top_ks) -> np.ndarray:
        """One token per row of ``logits [n, vocab]``: argmax where the
        temperature is ``<= 0``; otherwise a draw from
        ``softmax(logits / temperature)``, cut to the ``top_k`` highest
        logits when ``top_k > 0`` (ties at the threshold stay), with the
        generator seeded by :func:`token_seed` of the row's request seed
        and token index.  Returns a host int64 array."""
        temps = np.asarray(temperatures, np.float32)
        top_ks = np.asarray(top_ks, np.int64)
        with self._on_device(), torch.inference_mode():
            out = torch.argmax(logits, dim=-1)
            for i in np.flatnonzero(temps > 0):
                row = logits[i].float()
                if top_ks[i] > 0:
                    k = int(min(top_ks[i], row.shape[-1]))
                    thresh = torch.topk(row, k).values[-1]
                    row = torch.where(row < thresh, float("-inf"), row)
                probs = torch.softmax(row / float(temps[i]), dim=-1)
                self._sampler.manual_seed(token_seed(seeds[i], indices[i]))
                out[i] = torch.multinomial(probs, 1,
                                           generator=self._sampler)[0]
            return out.cpu().numpy().astype(np.int64)
