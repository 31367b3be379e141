"""DecodeEngine: bucketed chunked prefill + batched single-token decode
over a dense or paged, fp or int8 KV cache.

Counterpart of the single-chip part of ``apex_tpu/serving/engine.py``.
The engine wraps a :class:`~apex_tpu_torch.models.llama.LlamaForCausalLM`
whose weights live on the engine's device:

- **prefill**: a prompt is cached in ``prefill_len``-sized chunks, each
  padded to the smallest covering bucket of ``prefill_buckets``; a
  chunk's causal block attends everything the slot already cached.  The
  returned logits are the fp32 next-token distribution after the chunk's
  last real token.
- **decode**: one step for every slot at once; inactive lanes still
  compute (one shape per step).  On a dense cache they write their K/V
  at their slot's length, which does not advance, so the write stays
  masked until the next prefill chunk overwrites it; on a paged cache
  they carry position -1 and their write goes to the pool's sink block.

Options, each off by default:

- ``paged=PagedCacheConfig(...)``: a global block pool and per-slot
  block tables (:mod:`~apex_tpu_torch.serving.paged_kv_cache`), managed
  on the host by a :class:`PagedCacheManager`; the device tables are
  brought up to date only when the manager changed them.  Serving equals
  the dense engine's bit for bit.
- ``quant=QuantConfig(weights=, kv=)``: int8 projections and LM head
  (a float model is quantized into the engine's own copy; a quantized
  one is taken as it is) and an int8 KV cache, dense or paged
  (:mod:`~apex_tpu_torch.serving.quant`).
- prefix reuse: :meth:`DecodeEngine.read_region` /
  :meth:`DecodeEngine.capture_slot` / :meth:`DecodeEngine.restore_prefix`
  on a dense cache, :meth:`DecodeEngine.alias_prefix` /
  :meth:`DecodeEngine.fork_slot` on a paged one, and
  ``prefill(resume=)`` over what they placed.
- speculation: :meth:`DecodeEngine.verify_draft` scores a drafted
  continuation in one cached forward of ``bucket + 1`` rows (the drafts
  padded to ``draft_buckets``), accepts on the device and commits the
  accepted length there.

There is no jit: the JAX program bodies are plain methods here, run
under ``torch.inference_mode()``, and the JAX engine's ``*_compiles``
counters (its bounded jit caches) have nothing to count, so they are
left out.  The cache is updated in place.  A host mirror of the slot
lengths lets every call check slot bounds and capacity without reading
the device.

Sampling is a function of ``(logits, seed, token index, temperature,
top_k)``: a sampled row reseeds the engine's ``torch.Generator`` from the
request's seed and the token's index before it draws, so a request
replays to the same stream.  ``temperature <= 0`` is greedy.  The draws
are PyTorch's, not ``jax.random``'s, so a sampled stream repeats under a
fixed seed but differs from the JAX engine's.

Hot weight swap (:meth:`DecodeEngine.swap_params`, the engine surface of
:mod:`~apex_tpu_torch.serving.reload`): the engine serves the tensors of
:attr:`DecodeEngine.params`, a ``state_dict`` that starts as the model's
own.  A swap rebinds this engine's tensors only: it never writes into
the module's parameters, which other engines over the same module (a
shadow arm, fleet replicas) and the rollback buffer still hold.  While
an engine serves swapped tensors, each model call binds them into the
module for the call and puts the module's own back after it.  The KV
cache and the block tables are untouched by a swap, and the number of
norm launches a model call makes does not change; the JAX engine's
"zero new compiles" has those two witnesses here.

**Tensor parallelism** (``tp=TPConfig(size)``).  The JAX engine is one
controller that wraps each program body in ``shard_map`` over a 1-D mesh.
The port runs one process per rank over ``torch.distributed``, as PyTorch
servers do: every rank builds the same model holding its shard (built
inside :func:`~apex_tpu_torch.transformer.tensor_parallel.
tensor_parallel_region` of the group), runs the same engine and the same
scheduler over the same requests, and the host's decisions (admission,
buckets, block tables, prefix keys, preemption) agree because each input
to them is the same on every rank.  The engine binds its group around
every model call, so the layers run Megatron's collectives (the
row-parallel pair's all-reduce each layer, the embedding's); the logits'
vocab shards are all-gathered before any argmax or draw, so every rank
holds the same logits bit for bit.  Sampling at temperature > 0 draws
from generators seeded alike on every rank (:func:`token_seed`) over
those equal logits: every rank draws the same token with no collective
a step.  The KV cache holds ``kv_heads / tp`` heads a rank, dense or
paged, fp or int8 (scales split on the same axis); lengths and block
tables are whole on every rank.  :meth:`DecodeEngine.capture_slot` and
:meth:`DecodeEngine.read_region` all-gather the heads, so the host rows
equal the JAX engine's (which reads the whole array) and any engine can
take them; :meth:`DecodeEngine.restore_prefix` keeps the rank's heads of
the rows it is given.  That is one collective a capture, none a step.
Under ``quant=QuantConfig(allreduce=True)`` the row-parallel pair's
all-reduce is :func:`~apex_tpu_torch.serving.quant.quantized_allreduce`.
The group is NCCL for a CUDA engine and gloo for a CPU one; each rank
binds its own card (``cuda:{local_rank}``).  A missing group, or one of
another size, raises: the engine never serves ``tp=`` as ``tp=None``.

Events (:func:`~apex_tpu_torch._logging.emit_event`), as the JAX engine
emits them: ``serving_quant_enabled`` once at construction with
``quant=``, ``serving_block_cow`` with the count of copy-on-write pairs
whenever a write copies shared blocks, and under ``tp=`` one
``serving_tp_step`` a decode step (``tp``, ``active``, ``duration_s``:
the step's wall, which bounds its collectives' time from above).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.serving.kv_cache import (
    commit_slot_length,
    init_cache,
    init_quant_cache,
    read_slot_region,
    release_slot,
    value_dtype,
    write_slot_region,
)
from apex_tpu_torch.serving.paged_kv_cache import (
    PagedCacheConfig,
    PagedCacheManager,
    blocks_per_slot,
    copy_block,
    init_paged_cache,
    init_quant_paged_cache,
)
from apex_tpu_torch.serving.quant import (
    QuantConfig,
    is_quantized,
    quantize_params,
    quantize_state_dict,
    quantized_allreduce,
    serving_param_spec,
)
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel import mappings

__all__ = ["DecodeEngine", "TPConfig", "default_draft_buckets",
           "default_prefill_buckets", "no_tf32", "token_seed",
           "tp_param_shardings", "ShardSlice"]


@dataclasses.dataclass(frozen=True)
class TPConfig:
    """Opt-in tensor-parallel serving over a ``size``-rank process group
    (``DecodeEngine(..., tp=TPConfig(size=2))``); see the module
    docstring.  ``tp=None`` keeps the single-card engine as it is."""

    size: int

    def __post_init__(self):
        if int(self.size) < 1:
            raise ValueError(f"tp size must be >= 1, got {self.size}")


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """The block of a whole leaf one rank keeps: block ``index`` of
    ``count`` equal blocks along ``dim``."""

    dim: int
    index: int
    count: int

    def bounds(self, size: int) -> tuple:
        """``(start, stop)`` along ``dim`` of a leaf ``size`` long there."""
        if size % self.count:
            raise ValueError(f"dim {self.dim} of size {size} does not "
                             f"split into {self.count} blocks")
        n = size // self.count
        return self.index * n, (self.index + 1) * n

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``t``, an owned copy."""
        start, stop = self.bounds(t.shape[self.dim])
        return t.narrow(self.dim, start, stop - start).clone()

    def whole_shape(self, shape) -> tuple:
        """The whole leaf's shape, from this block's."""
        out = list(shape)
        out[self.dim] *= self.count
        return tuple(out)


def tp_param_shardings(params, rank: int, size: int) -> dict:
    """The slice of each serving ``state_dict`` entry a tp rank keeps:
    ``{name: ShardSlice or None}`` (None: whole on every rank), from
    :func:`~apex_tpu_torch.serving.quant.serving_param_spec` (the model's
    column/row layout, quant-aware).  The port's twin of the JAX
    ``tp_param_shardings``, whose per-leaf ``NamedSharding`` places a
    leaf on the mesh: here each rank holds its own slice.  Hand it to
    :func:`~apex_tpu_torch.serving.weights.load_serving_params`
    (``shardings=``) to restore only the rank's slice of a checkpoint, or
    to :func:`~apex_tpu_torch.models.convert.shard_state_dict`."""
    out = {}
    for name in params:
        spec = serving_param_spec(name)
        dims = [d for d, e in enumerate(spec) if e is not None]
        out[name] = (ShardSlice(dims[0], int(rank), int(size)) if dims
                     else None)
    return out


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


def default_draft_buckets(max_draft: int) -> tuple:
    """Power-of-two draft-length table ``(1, 2, 4, ..., max_draft)``.

    A k-token draft is padded to the smallest covering bucket (the verify
    forward is ``bucket + 1`` rows: the pending token plus the padded
    draft), so the verify shapes stay logarithmic in ``max_draft``."""
    if max_draft < 1:
        raise ValueError(f"max_draft must be >= 1, got {max_draft}")
    out, b = [], 1
    while b < max_draft:
        out.append(b)
        b *= 2
    out.append(max_draft)
    return tuple(out)


def token_seed(seed: int, index: int) -> int:
    """The generator seed of the ``index``-th generated token of a request
    seeded with ``seed`` (the port's counterpart of ``fold_in``)."""
    return (int(seed) % (1 << 32)) << 32 | (int(index) % (1 << 32))


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
    ``paged`` and ``quant`` are as in the module docstring; with
    ``quant.weights`` on a float model, :attr:`model` is the engine's
    quantized copy and the caller's model is left as it was.
    """

    def __init__(self, model, *, slots: int = 8, max_len: int = 512,
                 prefill_len: int = 64,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 draft_buckets: Optional[Sequence[int]] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 device="cuda", paged: Optional[PagedCacheConfig] = None,
                 tp: Optional[TPConfig] = None,
                 quant: Optional[QuantConfig] = None):
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
        if draft_buckets is None:
            # a verify writes bucket + 1 rows, so the widest default draft
            # must leave room in even the smallest cache
            draft_buckets = default_draft_buckets(min(8, int(max_len) - 1))
        dbuckets = tuple(int(b) for b in draft_buckets)
        if not dbuckets or list(dbuckets) != sorted(set(dbuckets)):
            raise ValueError(f"draft_buckets must be non-empty, strictly "
                             f"ascending ints, got {dbuckets}")
        if dbuckets[0] < 1:
            raise ValueError(f"draft buckets must be >= 1 (a 0-token draft "
                             f"has nothing to verify), got {dbuckets}")
        if dbuckets[-1] >= int(max_len):
            raise ValueError(
                f"largest draft bucket {dbuckets[-1]} must be < max_len "
                f"{max_len} (a verify writes bucket+1 rows into the cache)")
        if quant is not None:
            if quant.allreduce and tp is None:
                raise ValueError(
                    "QuantConfig(allreduce=True) without tp= — the "
                    "quantized collective replaces the per-layer tp "
                    "psum pair; a single-chip engine has no psum to "
                    "quantize")
            if quant.kv and cache_dtype is not None:
                raise ValueError(
                    "cache_dtype with QuantConfig(kv=True) — the KV-"
                    "int8 cache owns its storage dtype (int8 payload "
                    "+ fp32 scales); drop one of the two")
        self.tp = tp
        self.quant = quant
        self._group = None
        self.tp_rank = 0
        if tp is not None:
            from apex_tpu_torch.models.llama import validate_tp_divisibility

            validate_tp_divisibility(model.config, tp.size)
            # raises unless the world is exactly tp.size ranks: no tp=
            # engine ever serves as a tp=None one
            self._group = parallel_state.serving_group(tp.size)
            parallel_state.check_group_device(self._group, self.device)
            self.tp_rank = torch.distributed.get_rank(self._group)
            built = {getattr(m, "world") for m in model.modules()
                     if hasattr(m, "world")}
            if built != {int(tp.size)}:
                raise ValueError(
                    f"the model's layers were built for tp world "
                    f"{sorted(built)}, the engine serves tp={tp.size}: "
                    f"build each rank's model inside "
                    f"tensor_parallel_region(group) and load its slice "
                    f"(models.convert.shard_state_dict)")
        tensors = list(model.parameters()) + list(model.buffers())
        wrong = {str(t.device) for t in tensors if t.device != self.device}
        if wrong:
            raise ValueError(f"model weights lie on {sorted(wrong)}, the "
                             f"engine runs on {self.device}: move the model "
                             f"first")
        if cache_dtype is None:
            # serve in the weights' own precision (bf16 weights -> bf16
            # cache); fp32 for a tree with no float leaves.  Read before
            # quantizing: the first float parameter is then the embedding
            floats = [p.dtype for p in model.parameters()
                      if p.dtype.is_floating_point]
            cache_dtype = floats[0] if floats else torch.float32
        if quant is not None and quant.weights and not is_quantized(model):
            # inside the group's region: a row shard's scales are the
            # whole weight's
            with self._region():
                model = quantize_params(model)
        # eval mode only: the model calls run under inference_mode, so the
        # caller's parameters keep requires_grad and the model stays
        # trainable after it has been served
        self.model = model.eval()
        self.quant = quant
        self.paged = paged
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prefill_len = int(prefill_len)
        self.prefill_buckets = buckets
        self.draft_buckets = dbuckets
        kv_int8 = quant is not None and quant.kv
        cfg = model.config
        if tp is not None:
            # the cache holds this rank's kv heads
            cfg = dataclasses.replace(
                cfg, num_key_value_heads=cfg.kv_heads // int(tp.size))
        self._pager: Optional[PagedCacheManager] = None
        if paged is not None:
            bs = int(paged.block_size)
            if bs > max_len:
                raise ValueError(
                    f"paged block_size {bs} exceeds max_len {max_len}")
            nblk = paged.num_blocks
            if nblk is None:
                # dense-capacity parity: every slot can still fill to
                # max_len with zero sharing (plus the null block)
                nblk = self.slots * blocks_per_slot(max_len, bs) + 1
            self._pager = PagedCacheManager(
                slots=self.slots, max_len=self.max_len, block_size=bs,
                num_blocks=int(nblk))
            kw = dict(slots=self.slots, max_len=self.max_len, block_size=bs,
                      num_blocks=int(nblk), device=self.device)
            self._cache = (init_quant_paged_cache(cfg, **kw) if kv_int8
                           else init_paged_cache(cfg, dtype=cache_dtype, **kw))
            self._pager.consume_dirty()     # the device holds this snapshot
        elif kv_int8:
            self._cache = init_quant_cache(cfg, slots=self.slots,
                                           max_len=self.max_len,
                                           device=self.device)
        else:
            self._cache = init_cache(cfg, slots=self.slots,
                                     max_len=self.max_len, dtype=cache_dtype,
                                     device=self.device)
        self._lengths_host = np.zeros((self.slots,), np.int64)
        # slots whose K/V arrived by restore_prefix / alias_prefix (slot ->
        # restored tokens): the only slots prefill() resumes mid-prompt
        self._restored: dict = {}
        self._sampler = torch.Generator(device=self.device)
        # model calls run with the engine's card as the current device and
        # TF32 off
        self._cuda = self.device.type == "cuda"
        # the served weights: the module's own tensors by name, and where
        # each one lives (submodule, its _parameters or _buffers dict, the
        # attribute) so that swapped tensors can be bound for a call
        self._own = OrderedDict(model.state_dict(keep_vars=True))
        self._params = self._own
        self._slots = []
        for key in self._own:
            prefix, _, attr = key.rpartition(".")
            sub = model.get_submodule(prefix) if prefix else model
            kind = "_parameters" if attr in sub._parameters else "_buffers"
            self._slots.append((getattr(sub, kind), attr))
        # monotonic weight-buffer generation: bumped by swap_params so
        # host layers (the prefix cache's version tags, the reloader's
        # rollback bookkeeping) can tell which weights produced a byte
        self._weights_version = 0
        # model calls made, for callers that account per call
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.verify_calls = 0
        if quant is not None:
            # quant=None emits nothing: the default event stream stays
            # the fp engine's
            emit_event("serving_quant_enabled",
                       weights=bool(quant.weights), kv=bool(quant.kv),
                       allreduce=bool(quant.allreduce), tp=self.tp_size,
                       paged=self._pager is not None)

    @contextlib.contextmanager
    def _region(self):
        """The engine's tp group bound (and, under ``quant.allreduce``,
        the quantized all-reduce of the row-parallel pair); nothing
        without ``tp=``."""
        if self._group is None:
            yield
            return
        with mappings.tensor_parallel_region(self._group):
            if self.quant is not None and self.quant.allreduce:
                with mappings.override_forward_allreduce(
                        quantized_allreduce):
                    yield
            else:
                yield

    @contextlib.contextmanager
    def _on_device(self):
        """The engine's card as the current device and TF32 off, on CUDA;
        no autograd recording either way; the served weights and the tp
        group bound."""
        if not self._cuda:
            with torch.inference_mode(), self._bound(), self._region():
                yield
            return
        with torch.cuda.device(self.device), no_tf32(), \
                torch.inference_mode(), self._bound(), self._region():
            yield

    def _whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The logits' vocab shards all-gathered (under ``tp=``), so
        every rank argmaxes and samples the same rows."""
        if self._group is None:
            return logits
        return mappings.gather_from_tensor_model_parallel_region(
            logits, self._group)

    def _whole_heads(self, t: torch.Tensor) -> torch.Tensor:
        """``[layers, n, kv_heads / tp, hd]`` rows with every rank's heads
        gathered on axis 2 (under ``tp=``)."""
        if self._group is None:
            return t
        return mappings._all_gather_dim(t, 2, self._group)

    def _my_heads(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's heads of whole-head rows (under ``tp=``)."""
        if self._group is None:
            return t
        return ShardSlice(2, self.tp_rank, int(self.tp.size)).take(t)

    @property
    def group(self):
        """The tp process group, or ``None`` on a single-card engine."""
        return self._group

    @contextlib.contextmanager
    def _bound(self):
        """The served tensors in the module for one model call, the
        module's own put back after it (nothing to do while they are the
        module's own)."""
        if self._params is self._own:
            yield
            return
        saved = [(slot, attr, slot[attr]) for slot, attr in self._slots]
        try:
            for (slot, attr), t in zip(self._slots, self._params.values()):
                slot[attr] = t
            yield
        finally:
            for slot, attr, t in saved:
                slot[attr] = t

    # ---- hot weight swap (serving/reload.py's engine surface) ------------
    @property
    def params(self) -> "OrderedDict[str, torch.Tensor]":
        """The served weights, a ``state_dict`` by reference (the
        model's own tensors until a swap)."""
        return OrderedDict(self._params)

    @property
    def weights_version(self) -> int:
        """Monotonic generation counter of the served weight buffer
        (0 == the boot params; bumped by every :meth:`swap_params`,
        including rollbacks)."""
        return self._weights_version

    def swap_params(self, params: Mapping[str, torch.Tensor]
                    ) -> "OrderedDict[str, torch.Tensor]":
        """Serve ``params`` (a ``state_dict``) from now on; returns the
        displaced one (the caller's rollback copy).

        The candidate must match the served weights exactly — the same
        names, shapes and dtypes — so that a validated-but-wrong tree
        (another model's checkpoint that happens to restore) is refused
        here rather than served.  An int8 engine quantizes a float
        candidate as its boot did (:func:`quantize_state_dict`); a
        quantized one (the buffer this method returned) is taken as it
        is.  A tensor off the engine's device is copied there; one on it
        is taken by reference, never copied.  Nothing is written into the
        module: the swap rebinds this engine's tensors, so another engine
        over the same module serves on, bit for bit.  KV cache, block
        tables and slot lengths are untouched: in-flight streams continue
        under the new weights.  Call between model calls only (a
        scheduler step boundary).
        """
        params = OrderedDict(params)
        if (self.quant is not None and self.quant.weights
                and set(params) != set(self._params)):
            params = quantize_state_dict(params, group=self._group)
        if set(params) != set(self._params):
            missing = sorted(set(self._params) - set(params))[:5]
            extra = sorted(set(params) - set(self._params))[:5]
            raise ValueError(
                f"swap_params: candidate names differ from the served "
                f"weights (missing {missing}, unexpected {extra}) — a "
                f"different model's weights cannot be hot-swapped")
        new = OrderedDict()
        for name, old in self._params.items():
            t = params[name]
            if tuple(t.shape) != tuple(old.shape) or t.dtype != old.dtype:
                raise ValueError(
                    f"swap_params: {name} is {tuple(t.shape)}/{t.dtype} "
                    f"but the served weights have "
                    f"{tuple(old.shape)}/{old.dtype} — a different "
                    f"model's weights cannot be hot-swapped")
            new[name] = t if t.device == self.device else t.to(self.device)
        old = self._params
        if all(new[k] is self._own[k] for k in new):
            new = self._own                 # the module's own again
        self._params = new
        self._weights_version += 1
        return OrderedDict(old)

    # ---- cache/slot state ------------------------------------------------
    @property
    def cache(self):
        return self._cache

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
        """Evict a slot (O(1)); its bytes stay masked until overwritten.
        A paged engine also drops the slot's block references: blocks
        shared with a prefix-cache entry or another slot survive, the
        rest go back to the pool."""
        self._check_slot(slot)
        release_slot(self._cache, slot)
        self._lengths_host[slot] = 0
        self._restored.pop(slot, None)
        if self._pager is not None:
            self._pager.release(slot)
            self._flush_tables()

    def reset(self) -> None:
        """Free every slot (keeps the cache allocation)."""
        self._cache.lengths.zero_()
        self._lengths_host[:] = 0
        self._restored.clear()
        if self._pager is not None:
            for slot in range(self.slots):
                self._pager.release(slot)
            self._flush_tables()

    @property
    def tp_size(self) -> int:
        """Ranks the serving calls run over (1 = single card)."""
        return 1 if self.tp is None else int(self.tp.size)

    def bucket_for(self, n: int) -> int:
        """Smallest prefill bucket covering an ``n``-token chunk."""
        if not 1 <= n <= self.prefill_len:
            raise ValueError(f"chunk length {n} not in [1, "
                             f"{self.prefill_len}]")
        return next(b for b in self.prefill_buckets if b >= n)

    @property
    def max_draft(self) -> int:
        """Widest draft :meth:`verify_draft` accepts (the largest draft
        bucket)."""
        return self.draft_buckets[-1]

    def draft_bucket_for(self, k: int) -> int:
        """Smallest draft bucket covering a ``k``-token draft."""
        if not 1 <= k <= self.draft_buckets[-1]:
            raise ValueError(f"draft length {k} not in [1, "
                             f"{self.draft_buckets[-1]}]")
        return next(b for b in self.draft_buckets if b >= k)

    # ---- the block pool (None / empty / refusing on a dense engine) ------
    @property
    def block_pool(self) -> Optional[PagedCacheManager]:
        """The host block manager (allocation, refcounts, tables), or
        ``None`` on a dense engine."""
        return self._pager

    @property
    def block_size(self) -> Optional[int]:
        return None if self._pager is None else self._pager.block_size

    def free_blocks(self) -> Optional[int]:
        """Unallocated pool blocks (``None`` on a dense engine)."""
        return None if self._pager is None else self._pager.free_blocks

    def block_pool_utilization(self) -> float:
        """Allocated pool blocks / allocatable blocks (0.0 when dense)."""
        return 0.0 if self._pager is None else self._pager.utilization

    def slot_block_ids(self, slot: int) -> list:
        """The pool blocks behind a slot, in token order: what a paged
        prefix cache captures, by reference."""
        self._check_slot(slot)
        if self._pager is None:
            raise ValueError("slot_block_ids on a dense engine — "
                             "construct with paged=PagedCacheConfig(...)")
        return self._pager.slot_block_ids(slot)

    def block_stats(self) -> dict:
        """Cumulative pool accounting (allocations, frees, copies on
        write, aliased blocks, high-water mark); empty when dense."""
        return {} if self._pager is None else self._pager.stats()

    def set_block_reclaim(self, callback) -> None:
        """Install the pool's last-resort reclaim hook (``(n_blocks) ->
        freed``), called once before an allocation raises
        ``BlockPoolExhausted``: the scheduler wires prefix-cache eviction
        here, and ``None`` unhooks it."""
        if self._pager is None:
            raise ValueError("set_block_reclaim on a dense engine")
        self._pager.reclaim = callback

    @property
    def cow_copies(self) -> int:
        """Copy-on-write block copies made so far (0 when dense)."""
        return 0 if self._pager is None else self._pager.cow_total

    def _flush_tables(self, *, with_lengths: bool = False) -> None:
        """Bring the device tables up to the host mirror, in one small
        host-to-device copy, only when the manager changed them; with
        ``with_lengths`` the committed lengths go over too (alias and
        fork commit a table and a length together)."""
        if self._pager is not None and self._pager.consume_dirty():
            self._cache.tables.copy_(
                torch.from_numpy(self._pager.table_snapshot()))
        if with_lengths:
            self._cache.lengths.copy_(
                torch.from_numpy(self._lengths_host.astype(np.int32)))

    def _ensure_paged(self, writes) -> None:
        """Before a write: allocate the blocks the spans ``(slot, start,
        stop)`` need, copy every shared block they write into (before the
        write lands), and bring the device tables up to date once for
        all of them."""
        if self._pager is None:
            return
        pairs = []
        for slot, start, stop in writes:
            pairs.extend(self._pager.ensure(slot, start, stop))
        if pairs:
            with self._on_device():
                for src, dst in pairs:
                    copy_block(self._cache, src, dst)
            emit_event("serving_block_cow", blocks=len(pairs))
        self._flush_tables()

    def alias_prefix(self, slot: int, block_ids: Sequence[int],
                     length: int) -> None:
        """Prefix reuse with no copy: point a free slot's table at blocks
        already in the pool and commit ``length`` valid tokens (the paged
        replacement of :meth:`restore_prefix`).  Each block gains a
        reference, and the slot's later writes into a shared block copy
        it first.  Then ``prefill(..., resume=length)`` (or
        ``prefill_chunk``) continues the prompt."""
        self._check_slot(slot)
        if self._pager is None:
            raise ValueError("alias_prefix on a dense engine — use "
                             "restore_prefix (copy-based) instead")
        if self._lengths_host[slot]:
            raise ValueError(
                f"slot {slot} is occupied ({self._lengths_host[slot]} "
                f"tokens); release() it before aliasing into it")
        length = int(length)
        if not 1 <= length <= self.max_len - 1:
            raise ValueError(
                f"aliased prefix of {length} tokens not in [1, "
                f"{self.max_len - 1}] (the resume chunk must still fit)")
        bs = self._pager.block_size
        want = blocks_per_slot(length, bs)
        if len(block_ids) != want:
            raise ValueError(
                f"{len(block_ids)} blocks cannot hold exactly {length} "
                f"tokens at block_size {bs} (want {want})")
        self._pager.alias(slot, block_ids, length)
        self._lengths_host[slot] = length
        self._restored[slot] = length
        self._flush_tables(with_lengths=True)

    def fork_slot(self, src: int, dst: int) -> None:
        """Branch a live stream: share every block of ``src`` into free
        slot ``dst`` (refcounts only) and commit the same length.  The
        first write either stream makes into a shared block (the tail
        block both append into, too) copies it, so the streams stay
        bit-isolated."""
        self._check_slot(src)
        self._check_slot(dst)
        if self._pager is None:
            raise ValueError("fork_slot on a dense engine — the dense "
                             "layout has no shareable blocks")
        if not self._lengths_host[src]:
            raise ValueError(f"fork of empty slot {src}")
        if self._lengths_host[dst]:
            raise ValueError(
                f"slot {dst} is occupied ({self._lengths_host[dst]} "
                f"tokens); release() it before forking into it")
        self._pager.fork(src, dst)
        self._lengths_host[dst] = self._lengths_host[src]
        self._flush_tables(with_lengths=True)

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
        # paged: the real rows' blocks allocated (and copied where shared)
        # before the write; bucket padding past the frontier goes to the
        # sink
        self._ensure_paged([(slot, offset, offset + n)])
        with self._on_device():
            logits, _ = self.model(ids.to(self.device), kv_cache=self._cache,
                                   slot=slot, position=offset)
            commit_slot_length(self._cache, slot, offset + n)
            last = self._whole_vocab(logits[n - 1, 0].float())
        self._lengths_host[slot] = offset + n
        self.prefill_chunks += 1
        return last

    def prefill(self, slot: int, tokens: Sequence[int], *,
                resume: int = 0) -> torch.Tensor:
        """Fill ``slot`` with a whole prompt (chunked as needed); return
        its fp32 next-token logits ``[vocab]``.

        ``resume`` continues mid-prompt over what :meth:`restore_prefix`
        or :meth:`alias_prefix` placed in the slot: it must equal that
        length, ``tokens`` is still the whole prompt, and only
        ``tokens[resume:]`` is computed.  Any other nonzero offset is
        refused: clobbering (or trusting) a live stream silently is the
        corruption these guards exist for."""
        self._check_slot(slot)
        resume = int(resume)
        n = len(tokens)
        if not 1 <= n <= self.max_len:
            raise ValueError(f"prompt length {n} not in [1, "
                             f"{self.max_len}] (cache capacity)")
        if resume:
            if (self._restored.get(slot) != resume
                    or self._lengths_host[slot] != resume):
                raise ValueError(
                    f"prefill(resume={resume}) on slot {slot}: the slot "
                    f"holds {self._lengths_host[slot]} tokens of which "
                    f"{self._restored.get(slot, 0)} are engine-restored "
                    f"— resume must equal the restore_prefix() length "
                    f"exactly")
            if n <= resume:
                raise ValueError(
                    f"prompt of {n} tokens has no suffix past "
                    f"the {resume} restored tokens — at least the final "
                    f"prompt token must be computed to produce the "
                    f"next-token logits")
            # validated: the slot is a live stream from here on (a
            # refused call leaves the mark for a corrected retry)
            self._restored.pop(slot, None)
        elif self._lengths_host[slot]:
            raise ValueError(
                f"slot {slot} is occupied ({self._lengths_host[slot]} "
                f"tokens); release() it before prefilling — silently "
                f"clobbering a live stream is the corruption class these "
                f"guards exist for")
        logits = None
        for start in range(resume, n, self.prefill_len):
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
        # paged: one allocation pass for every active lane and at most one
        # table copy (none on a step that crosses no block boundary)
        self._ensure_paged([(int(s), int(self._lengths_host[s]),
                             int(self._lengths_host[s]) + 1)
                            for s in np.flatnonzero(act)])
        ids = torch.as_tensor(np.asarray(tokens, np.int64)).to(self.device)
        step = torch.as_tensor(act.astype(np.int32)).to(self.device)
        t0 = time.perf_counter()
        with self._on_device():
            position = self._cache.lengths
            if self._pager is not None:
                # inactive lanes at -1: their writes go to the sink
                position = torch.where(step.bool(), position,
                                       torch.full_like(position, -1))
            logits, _ = self.model(ids[:, None], kv_cache=self._cache,
                                   position=position)
            self._cache.lengths += step
            out = self._whole_vocab(logits[0].float())
        if self._group is not None:
            # the step's wall: an upper bound on its collectives' time;
            # tp=None emits nothing, so its event stream is unchanged
            if self._cuda:
                torch.cuda.synchronize(self.device)
            replica = getattr(self, "name", None)
            emit_event("serving_tp_step", tp=self.tp_size,
                       active=int(act.sum()),
                       duration_s=time.perf_counter() - t0,
                       **({"replica": replica}
                          if isinstance(replica, str) else {}))
        self._lengths_host[act] += 1
        self.decode_steps += 1
        return out

    def verify_draft(self, slot: int, tokens: Sequence[int]) -> tuple:
        """One speculative verify: score ``tokens`` (the slot's pending
        last-sampled token followed by 1..``max_draft`` drafted
        candidates) in one cached forward, accept the longest draft
        prefix the model's greedy argmax agrees with, and roll the slot
        back to the accepted depth.

        The forward is the chunked-prefill path at the slot's offset over
        ``bucket + 1`` rows (the draft padded to the smallest covering
        ``draft_buckets`` entry), row ``i`` bounded at ``offset + i``, and
        keeps every row's fp32 logits.  The argmax, the acceptance (a
        cumulative product over the real draft rows) and the length
        commit ``offset + accepted + 1`` run on the device; the host reads
        ``accepted`` and the argmaxes once.

        Returns ``(accepted, greedy, logits)``: ``accepted`` draft tokens
        accepted (0: immediate rejection); ``greedy[i]`` the argmax after
        ``tokens[:i+1]`` (a host int64 array), so the step emits
        ``tokens[1:1+accepted] + [greedy[accepted]]``; ``logits`` the
        per-row fp32 distributions ``[bucket+1, vocab]`` on the engine's
        device (rows past ``accepted`` scored rejected or padded context).
        After the call the slot holds ``offset + accepted + 1`` tokens: the
        pending token and the accepted draft are cached and the bonus token
        is the new pending one, as after a plain decode step.  On a paged
        engine the blocks the real rows need are allocated first, padded
        rows go to the sink, and a rollback leaves the surplus blocks owned
        by the slot."""
        self._check_slot(slot)
        k = len(tokens) - 1
        if k < 1:
            raise ValueError(
                f"verify_draft needs the pending token plus >= 1 draft "
                f"token, got {len(tokens)} token(s) — with no draft to "
                f"verify, run the plain decode step")
        bucket = self.draft_bucket_for(k)    # raises past max_draft
        offset = int(self._lengths_host[slot])
        if offset == 0:
            raise ValueError(
                f"slot {slot} was never prefilled — a verify would expose "
                f"garbage as its whole context")
        if offset + k + 1 > self.max_len:
            raise ValueError(
                f"verify of {k + 1} tokens at offset {offset} overruns "
                f"cache max_len {self.max_len}")
        ids = torch.zeros((1, bucket + 1), dtype=torch.long)
        ids[0, :k + 1] = torch.as_tensor(list(tokens), dtype=torch.long)
        self._ensure_paged([(slot, offset, offset + k + 1)])
        with self._on_device():
            ids = ids.to(self.device)
            logits, _ = self.model(ids, kv_cache=self._cache, slot=slot,
                                   position=offset)
            # the whole vocab before the argmax decides, on every rank
            rows = self._whole_vocab(logits[:, 0].float())  # [bucket+1, V]
            greedy = torch.argmax(rows, dim=-1)
            match = greedy[:k] == ids[0, 1:k + 1]
            accepted = torch.cumprod(match.long(), dim=0).sum()
            self._cache.lengths[slot] = offset + 1 + accepted
            read = torch.cat([accepted[None], greedy]).cpu().numpy()
        a = int(read[0])
        self._lengths_host[slot] = offset + a + 1
        self.verify_calls += 1
        return a, read[1:].astype(np.int64), rows

    # ---- prefix reuse on a dense cache: capture and restore ---------------
    def read_region(self, slot: int, start: int, stop: int) -> tuple:
        """Rows ``[start, stop)`` of a slot's K/V across every layer,
        ``(k, v)`` ``[layers, stop - start, kv_heads, head_dim]``: owned
        copies on the engine's device, safe to keep across later calls
        (dequantized fp32 from an int8 cache).  Only valid rows are handed
        out: the span must lie inside the slot's committed length."""
        self._check_slot(slot)
        if self._pager is not None:
            raise ValueError(
                "read_region on a paged engine — prefix capture is "
                "by-reference there (slot_block_ids + refcounts), not "
                "by copy")
        start, stop = int(start), int(stop)
        if not 0 <= start < stop <= int(self._lengths_host[slot]):
            raise ValueError(
                f"region [{start}, {stop}) outside slot {slot}'s valid "
                f"length {int(self._lengths_host[slot])} — rows past the "
                f"committed length are masked garbage and must never be "
                f"handed out")
        with self._on_device():
            k, v = read_slot_region(self._cache, slot, start, stop)
            return self._whole_heads(k), self._whole_heads(v)

    def capture_slot(self, slot: int) -> tuple:
        """A live slot's whole valid K/V on the host, ``(k, v, length)``
        with ``k`` / ``v`` CPU tensors ``[layers, length, kv_heads,
        head_dim]`` (dequantized fp32 from an int8 cache; every rank's
        heads under ``tp=``): :meth:`restore_prefix` of them into a free slot gives back the
        slot's cache state (an int8 payload bit for bit).  Dense engines
        only: a paged slot is captured by reference."""
        self._check_slot(slot)
        if self._pager is not None:
            raise ValueError(
                "capture_slot on a paged engine — capture by reference "
                "instead (slot_block_ids + block_pool.ref; resume via "
                "alias_prefix)")
        length = int(self._lengths_host[slot])
        if length < 1:
            raise ValueError(f"capture of empty slot {slot}")
        k, v = self.read_region(slot, 0, length)
        return k.cpu(), v.cpu(), length

    def restore_prefix(self, slot: int, kv, length: int) -> None:
        """Put captured K/V back into a free slot: after the call the slot
        holds ``length`` cached tokens, the rows given (requantized by an
        int8 cache, whose payload comes back bit for bit), and
        ``prefill(..., resume=length)`` continues the prompt.  ``kv`` is
        ``(k, v)`` ``[layers, >= length, kv_heads, head_dim]``; ``length``
        is at most ``max_len - 1`` (the resume chunk must fit)."""
        self._check_slot(slot)
        if self._pager is not None:
            raise ValueError(
                "restore_prefix on a paged engine — hits alias shared "
                "blocks zero-copy (alias_prefix), never write K/V back")
        if self._lengths_host[slot]:
            raise ValueError(
                f"slot {slot} is occupied ({self._lengths_host[slot]} "
                f"tokens); release() it before restoring into it")
        k, v = kv
        length = int(length)
        layers = self._cache.num_layers
        # (kv_heads, head_dim): whole heads, under tp= too
        tail = (int(self._cache.k.shape[3]) * self.tp_size,
                int(self._cache.k.shape[4]))
        for name, arr in (("k", k), ("v", v)):
            shape = tuple(arr.shape)
            if (len(shape) != 4 or shape[0] != layers
                    or shape[2:] != tail):
                raise ValueError(
                    f"restore {name} shape {shape} does not match the "
                    f"cache's [layers={layers}, n, kv_heads={tail[0]}, "
                    f"head_dim={tail[1]}] layout")
        if not 1 <= length <= min(k.shape[1], v.shape[1]):
            raise ValueError(
                f"restore length {length} not in [1, "
                f"{min(k.shape[1], v.shape[1])}] (rows provided)")
        if length > self.max_len - 1:
            raise ValueError(
                f"restored prefix of {length} tokens leaves no room in "
                f"a max_len={self.max_len} cache for the resume chunk "
                f"that must produce the next-token logits")
        # the value dtype, not the storage dtype: int8 staging would
        # destroy the captured rows before the requantize
        dtype = value_dtype(self._cache)
        with self._on_device():
            write_slot_region(
                self._cache, slot, 0,
                self._my_heads(k[:, :length]).to(device=self.device,
                                                 dtype=dtype),
                self._my_heads(v[:, :length]).to(device=self.device,
                                                 dtype=dtype))
            commit_slot_length(self._cache, slot, length)
        self._lengths_host[slot] = length
        self._restored[slot] = length

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
        with self._on_device():
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
