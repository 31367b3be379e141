"""Data-pipeline guard: validate every batch, skip within a budget (the
port of ``apex_tpu.resilience.data_guard``).

An unguarded loop either trains on a corrupt shard's garbage or dies on
its first bad record.  The guard makes the middle path explicit and
*bounded*:

- :func:`validate_batch` checks a batch against a :func:`spec_of`-shaped
  template — tree structure, per-leaf shape and dtype, and finiteness of
  floating leaves — and returns human-readable reasons for any defect,
  the JAX module's reasons word for word.
- :class:`GuardedIterator` wraps the real iterator: clean batches pass
  through untouched; corrupt ones are dropped with a structured
  ``batch_skipped`` event, up to ``skip_budget`` for the iterator's
  lifetime, past which :class:`SkipBudgetExceeded` is raised.  A fetch
  slower than ``stall_timeout_s`` raises :class:`DataStallError` — the
  late batch is stashed and redelivered on the next call, so a stall
  costs a recorded failure, never data.

A tree is a tensor, a numpy array or a number, or a dict (keys in sorted
order), namedtuple, list or tuple of trees: ``jax.tree_util``'s leaf
order, so the reasons and the skips are JAX's.  The checks run on the
host: place the guard before the batch goes to the card (a CUDA leaf is
checked where it lies, at the cost of one read).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.utils.serialization import (
    _children,
    _is_namedtuple,
    dtype_name,
    leaf_spec,
    tree_flatten_with_path,
    tree_map_with_path,
)

__all__ = [
    "BatchLeafSpec",
    "DataStallError",
    "GuardedIterator",
    "SkipBudgetExceeded",
    "spec_of",
    "validate_batch",
]


class SkipBudgetExceeded(RuntimeError):
    """More corrupt batches than ``skip_budget`` allows — the pipeline is
    systematically bad, not sporadically unlucky."""

    def __init__(self, skipped: int, budget: int, reasons: List[str]):
        super().__init__(
            f"skipped {skipped} corrupt batches (budget {budget}); "
            f"last: {reasons}")
        self.skipped = skipped
        self.budget = budget
        self.reasons = reasons


class DataStallError(TimeoutError):
    """A batch fetch took longer than the configured stall timeout.

    The late batch itself is NOT lost: the guard stashes it and delivers
    it on the next ``__next__`` call."""

    # a TimeoutError subclass would be classified transient by the
    # default RetryPolicy — but each retried fetch would consume (and
    # discard) another batch; stalls are the supervisor's failure domain
    transient = False

    def __init__(self, fetch_s: float, timeout_s: float):
        super().__init__(
            f"batch fetch took {fetch_s:.3f}s "
            f"(stall timeout {timeout_s:.3f}s)")
        self.fetch_s = fetch_s
        self.timeout_s = timeout_s


@dataclasses.dataclass(frozen=True)
class BatchLeafSpec:
    """One leaf of a batch spec: its shape and its dtype's name (the
    port's ``jax.ShapeDtypeStruct``; a leaf of a tree, not a node)."""

    shape: tuple
    dtype: str


def spec_of(batch: Any) -> Any:
    """Batch spec (a tree of :class:`BatchLeafSpec`) from an exemplar;
    shapes and dtypes are read without moving a leaf off its device."""
    return tree_map_with_path(
        lambda _, leaf: BatchLeafSpec(*leaf_spec(leaf)), batch)


def _dtype_of(want: Any) -> str:
    """A spec leaf's dtype as a name: a :class:`BatchLeafSpec`'s, or that
    of anything with a ``dtype`` (a tensor, an array)."""
    dt = want.dtype
    if isinstance(dt, str):
        return dt
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _treedef_str(tree: Any) -> str:
    """``str`` of the tree's ``jax.tree_util`` treedef
    (``PyTreeDef({'x': *, 'y': *})``) for dicts, namedtuples, lists,
    tuples and None: the tree's structure, compared as a string."""
    def node(t):
        if t is None:
            return "None"
        kids = _children(t)
        if kids is None:
            return "*"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], "
                    f"[{', '.join(node(c) for _, c in kids)}])")
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k[1:-1]}: {node(c)}"
                                   for k, c in kids) + "}"
        body = ", ".join(node(c) for _, c in kids)
        if isinstance(t, tuple):
            return f"({body},)" if len(kids) == 1 else f"({body})"
        return f"[{body}]"

    return f"PyTreeDef({node(tree)})"


def _compile_spec(spec: Any) -> tuple:
    """Flatten a spec ONCE into ``(treedef string, [(path, shape, dtype
    name), ...])`` — the per-batch cost must not include re-flattening
    the fixed spec."""
    recs = [(path, tuple(want.shape), _dtype_of(want))
            for path, want in tree_flatten_with_path(spec)]
    return _treedef_str(spec), recs


def _nonfinite(leaf: Any) -> int:
    """Non-finite elements of a floating leaf (0 for any other)."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return 0
        return int(torch.isfinite(leaf).logical_not().sum())
    arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.floating):
        return 0
    return int(arr.size - np.count_nonzero(np.isfinite(arr)))


def _validate_compiled(batch: Any, treedef: str, recs, *,
                       check_finite: bool) -> List[str]:
    got = _treedef_str(batch)
    if got != treedef:
        return [f"structure mismatch: batch {got[:120]} != "
                f"spec {treedef[:120]}"]
    reasons = []
    for (path, want_shape, want_dtype), (_, leaf) in zip(
            recs, tree_flatten_with_path(batch)):
        shape, dtype = leaf_spec(leaf)
        if tuple(shape) != want_shape:
            reasons.append(f"leaf {path!r}: shape {tuple(shape)} != "
                           f"{want_shape}")
        elif dtype_name(leaf) != want_dtype:
            reasons.append(f"leaf {path!r}: dtype {dtype} != "
                           f"{want_dtype}")
        elif check_finite:
            bad = _nonfinite(leaf)
            if bad:
                reasons.append(f"leaf {path!r}: {bad} non-finite elements")
    return reasons


def validate_batch(batch: Any, spec: Any, *,
                   check_finite: bool = True) -> List[str]:
    """Defects of ``batch`` vs ``spec``; an empty list means clean.

    Checks, per leaf and in order: tree structure, shape, dtype, then
    (floating leaves only, when ``check_finite``) that every element is
    finite.  Reasons name the leaf by its ``keystr`` path."""
    return _validate_compiled(batch, *_compile_spec(spec),
                              check_finite=check_finite)


class GuardedIterator:
    """Validating wrapper around a batch iterator (itself an iterator).

    ``spec`` pins the expected batch layout; when omitted it is locked
    from the *first* batch.  Source exceptions propagate untouched, so a
    transient-failure retry wrapped *around* ``next()`` composes: the
    guard's skip bookkeeping survives the re-call.

    ``skip_budget`` is a lifetime cap: ``skipped`` counts every dropped
    batch and crossing the budget raises :class:`SkipBudgetExceeded`.
    ``clock`` is injectable (monotonic) so stall detection is testable
    without real waits.
    """

    def __init__(self, it: Iterable, spec: Any = None, *,
                 check_finite: bool = True, skip_budget: int = 8,
                 stall_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if skip_budget < 0:
            raise ValueError(f"skip_budget must be >= 0, got {skip_budget}")
        if stall_timeout_s is not None and stall_timeout_s <= 0.0:
            raise ValueError(
                f"stall_timeout_s must be positive, got {stall_timeout_s}")
        self._it = iter(it)
        self.spec = spec
        self.check_finite = check_finite
        self.skip_budget = skip_budget
        self.stall_timeout_s = stall_timeout_s
        self.skipped = 0
        self.delivered = 0
        self._clock = clock
        self._stalled = None       # late batch awaiting redelivery
        self._compiled = None      # _compile_spec view of the locked spec
        self._compiled_for = None  # identity key: recompile if spec swapped

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._stalled is not None:
                # a previous fetch stalled AFTER the producer delivered:
                # hand that batch over now instead of dropping it
                batch, self._stalled = self._stalled, None
            else:
                t0 = self._clock()
                batch = next(self._it)  # StopIteration/source errs propagate
                fetch_s = self._clock() - t0
                if (self.stall_timeout_s is not None
                        and fetch_s > self.stall_timeout_s):
                    self._stalled = batch
                    emit_event("data_stall", fetch_s=round(fetch_s, 6),
                               stall_timeout_s=self.stall_timeout_s)
                    raise DataStallError(fetch_s, self.stall_timeout_s)
            if self.spec is None:
                self.spec = spec_of(batch)
            if self._compiled_for is not self.spec:
                self._compiled = _compile_spec(self.spec)
                self._compiled_for = self.spec
            reasons = _validate_compiled(batch, *self._compiled,
                                         check_finite=self.check_finite)
            if not reasons:
                self.delivered += 1
                return batch
            self.skipped += 1
            emit_event("batch_skipped", reasons=reasons,
                       skipped=self.skipped, skip_budget=self.skip_budget)
            if self.skipped > self.skip_budget:
                raise SkipBudgetExceeded(self.skipped, self.skip_budget,
                                         reasons)
