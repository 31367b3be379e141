"""Named RNG streams for model parallelism and activation checkpointing
(counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``).

- :class:`RNGStatesTracker` (alias ``CudaRNGStatesTracker``) keeps named
  streams.  ``fork(name)`` yields an explicit ``torch.Generator`` on the
  tracker's device, seeded from the stream's seed folded with a counter
  that each fork bumps: two forks draw different values, and
  ``set_states`` of an earlier ``get_states`` replays the forks that
  followed it.  Nothing touches the global CPU or CUDA RNG state (the JAX
  tracker folds its key with the counter the same way).
- :func:`model_parallel_seed` (alias ``model_parallel_cuda_manual_seed``)
  installs the two streams of the reference: the data-parallel stream at
  ``seed`` on every rank, and the model-parallel stream at ``seed + 2718``
  folded with the tensor-parallel rank, so dropout inside a tp region
  differs across shards and agrees across data-parallel replicas.
- :func:`checkpoint` recomputes ``fn`` in the backward
  (``torch.utils.checkpoint`` with ``use_reentrant=False``).  The
  recompute sees the RNG state the first call saw: the global states
  (``preserve_rng_state``), every ``torch.Generator`` passed among the
  arguments and the global tracker's streams, so it is bit for bit the
  forward's.  ``context_fn`` passes on to ``torch.utils.checkpoint``: a
  selective context (``create_selective_checkpoint_contexts``) keeps the
  outputs of the ops its policy saves and recomputes the rest.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.distributed as dist
import torch.utils.checkpoint as _torch_checkpoint

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    current_tp_group,
)

__all__ = [
    "RNGStatesTracker",
    "CudaRNGStatesTracker",
    "get_rng_state_tracker",
    "model_parallel_seed",
    "model_parallel_cuda_manual_seed",
    "checkpoint",
]

_MODEL_PARALLEL_RNG = "model-parallel-rng"
_DATA_PARALLEL_RNG = "data-parallel-rng"
# the reference's offset of the tensor-model-parallel seed
_TP_SEED_OFFSET = 2718
_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints that spreads
    every input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``data`` (the port's
    ``jax.random.fold_in`` on integer seeds)."""
    return _mix((int(seed) & _MASK) ^ _mix(int(data) & _MASK)) >> 1


class RNGStatesTracker:
    """Named seeds with fork counters.

    ``add(name, seed)`` registers a stream; ``fork(name)`` yields a fresh
    ``torch.Generator`` on ``device`` for each use; ``get_states`` /
    ``set_states`` snapshot and restore every stream (for checkpoints and
    exact resumption).  ``device`` is resolved at each fork (CUDA unless
    the tracker was made for the CPU)."""

    def __init__(self, device="cuda"):
        self.device = device
        self.states_: Dict[str, int] = {}
        self.counters_: Dict[str, int] = {}

    def reset(self) -> None:
        """Drop every stream."""
        self.states_.clear()
        self.counters_.clear()

    def get_states(self) -> dict:
        """Every stream's seed and fork counter."""
        return {"seeds": dict(self.states_), "counters": dict(self.counters_)}

    def set_states(self, states: dict) -> None:
        """Restore a :meth:`get_states` snapshot."""
        self.states_ = dict(states["seeds"])
        self.counters_ = dict(states["counters"])

    def add(self, name: str, seed: int) -> None:
        """Register stream ``name`` at the int ``seed``."""
        if name in self.states_:
            raise Exception(f"cuda rng state {name} already exists")
        self.states_[name] = int(seed)
        self.counters_[name] = 0

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG):
        """Yield a generator seeded with the stream's seed folded with its
        counter, and bump the counter."""
        if name not in self.states_:
            raise Exception(f"cuda rng state {name} is not added")
        seed = fold_in(self.states_[name], self.counters_[name])
        self.counters_[name] += 1
        gen = torch.Generator(device=resolve_device(self.device))
        gen.manual_seed(seed)
        yield gen


CudaRNGStatesTracker = RNGStatesTracker

_GLOBAL_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    """The process's tracker (the reference's ``get_cuda_rng_tracker``)."""
    return _GLOBAL_TRACKER


def model_parallel_seed(seed: int, group=None, *, device="cuda") -> None:
    """Reset the global tracker to the two streams of the reference: the
    data-parallel one at ``seed``, the model-parallel one at ``seed +
    2718`` folded with this process's rank in ``group`` (by default
    :func:`~apex_tpu_torch.transformer.tensor_parallel.mappings.
    current_tp_group`; unfolded outside any).  ``device`` is where the
    forks' generators live."""
    _GLOBAL_TRACKER.reset()
    _GLOBAL_TRACKER.device = device
    _GLOBAL_TRACKER.add(_DATA_PARALLEL_RNG, seed)
    base = int(seed) + _TP_SEED_OFFSET
    g = current_tp_group() if group is None else group
    if g is not None:
        base = fold_in(base, dist.get_rank(g))
    _GLOBAL_TRACKER.add(_MODEL_PARALLEL_RNG, base)


model_parallel_cuda_manual_seed = model_parallel_seed


def checkpoint(fn: Callable, distribute_saved_activations: bool = False,
               *args,
               context_fn: Callable = _torch_checkpoint.noop_context_fn):
    """``fn(*args)``, its activations recomputed in the backward instead of
    saved.  ``distribute_saved_activations`` is accepted and changes
    nothing: the inputs saved are the caller's tensors, which under
    sequence parallelism are already the rank's shard (the JAX function
    accepts it the same way).  ``context_fn`` (keyword only) is
    ``torch.utils.checkpoint``'s: with a selective context the recompute
    re-runs only the ops its policy does not save."""
    del distribute_saved_activations
    gens = [a for a in args if isinstance(a, torch.Generator)]
    before = [g.get_state() for g in gens]
    tracker = get_rng_state_tracker().get_states()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        # the recompute: the states the first call began from, then back
        # to where the caller's generators and streams have moved since
        now = [g.get_state() for g in gens]
        now_tracker = get_rng_state_tracker().get_states()
        for g, s in zip(gens, before):
            g.set_state(s)
        get_rng_state_tracker().set_states(tracker)
        try:
            return fn(*a)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)
            get_rng_state_tracker().set_states(now_tracker)

    return _torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                        preserve_rng_state=True,
                                        context_fn=context_fn)
