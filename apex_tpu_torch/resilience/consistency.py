"""Cross-replica consistency: detect, localize and repair dp desync (the
port of ``apex_tpu.resilience.consistency``).

Data-parallel replicas are supposed to hold bit-identical state; a bit
flip in one replica's memory, a stale update or a collective that
dropped a participant breaks that silently, and every later all-reduce
averages the corruption into the whole job.  This module makes the
invariant checkable and repairable.

**Representation.**  The JAX module stacks the replicas' copies along a
leading ``(dp, ...)`` axis under ``shard_map``.  The port runs one
process a replica, so each rank passes its OWN copy: ``axis_name=`` is
the data-parallel ``ProcessGroup`` the replicas span (as every mesh-axis
keyword of the port is, :func:`~apex_tpu_torch.transformer.
parallel_state.axis_group`; None: ``parallel_state``'s data-parallel
group when it is initialized, else this one rank), and ``shard_group=``
the group over which one replica's shards are combined (None:
``parallel_state``'s model-parallel group when initialized, else none),
where JAX sums over the mesh's other axes.  Every tensor leaf of the
tree takes part; pass the subtree that should be replica-identical.

- :func:`replica_hashes` hashes every leaf locally — only one u32 hash
  and one fp32 delta a leaf cross the wire, never the parameters —
  with :func:`_shard_hash`, JAX's hash bit for bit.
- :func:`verify_replicas` localizes each diverged leaf (path, ranks,
  max-abs delta against rank 0) through ``replica_desync`` events.
- :func:`resync_replicas` repairs in place by broadcasting rank
  ``root``'s copy.
- :class:`ReplicaConsistency` is the policy object the
  :class:`~apex_tpu_torch.resilience.supervisor.TrainingSupervisor` runs:
  verify, resync from the majority, re-verify.

:func:`collapse_replicas` and :func:`expand_replicas` convert between
JAX's stacked form and its logical copy; with one process a replica the
logical copy is the rank's own: collapse returns it as it is, and expand
broadcasts rank 0's copy to every rank of the group.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.utils.serialization import tree_flatten_with_path

__all__ = [
    "DivergedLeaf",
    "ReplicaConsistency",
    "ReplicaDesyncError",
    "collapse_replicas",
    "expand_replicas",
    "majority_root",
    "replica_hashes",
    "resync_replicas",
    "verify_replicas",
]

logger = get_logger("resilience.consistency")

_U32 = 0xFFFFFFFF
# words hashed a pass: bounds the int64 working set of a large leaf
_HASH_CHUNK_WORDS = 1 << 26


class ReplicaDesyncError(RuntimeError):
    """Replicas diverged and could not (or may not) be resynced.

    Carries ``step`` and ``report`` (the :class:`DivergedLeaf` list).
    Deterministic by definition, so the retry layer never retries it."""

    transient = False

    def __init__(self, step: int, report: Sequence["DivergedLeaf"]):
        names = ", ".join(f"{d.path} (ranks {list(d.ranks)})"
                          for d in report) or "<none>"
        super().__init__(
            f"replica desync at step {step}: {len(report)} diverged "
            f"leaves: {names}")
        self.step = int(step)
        self.report = list(report)


@dataclasses.dataclass(frozen=True)
class DivergedLeaf:
    """One localized divergence: which leaf, which replicas, how far."""

    path: str
    ranks: tuple  # dp ranks whose hash differs from rank 0's
    max_abs_delta: float  # max |replica - rank0| over the diverged ranks
    hashes: tuple  # per-rank u32 leaf hashes (diagnostic)


def _groups(axis_name, shard_group):
    """The replica group and the shard group a pass runs over (see the
    module docstring); a string raises, as every mesh-axis keyword of
    the port does."""
    from apex_tpu_torch.transformer import parallel_state as ps

    axis_name = ps.axis_group(axis_name, "axis_name")
    shard_group = ps.axis_group(shard_group, "shard_group")
    if ps.model_parallel_is_initialized():
        if axis_name is None:
            axis_name = ps.get_data_parallel_group()
        if shard_group is None:
            shard_group = ps.get_model_parallel_group()
    return axis_name, shard_group


def _size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _shard_hash(x: torch.Tensor) -> torch.Tensor:
    """Order-sensitive u32 checksum of a local shard's raw bytes, JAX's
    bit for bit: the bytes packed into little-endian u32 WORDS (the tail
    zero-padded) and positionally weighted, ``sum(word[i] * (i + 1)) mod
    2**32``.  Returned as a 0-d int64 tensor in ``[0, 2**32)`` on ``x``'s
    device.

    torch has no wrapping u32 arithmetic, so the words are widened to
    int64 and each product masked to 32 bits before the sum: a product
    of a word (< 2**32) and a weight (< 2**31) fits in int64, and so does
    the sum of fewer than 2**31 masked products.  The words go through in
    chunks of ``2**26`` to bound the working set."""
    dev = x.device
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    b = x.detach().contiguous().reshape(-1)
    if b.dtype == torch.bool:
        b = b.to(torch.uint8)
    b = b.view(torch.uint8)
    pad = (-b.numel()) % 4
    if pad:
        b = torch.cat([b, torch.zeros(pad, dtype=torch.uint8, device=dev)])
    words = b.view(torch.int32)           # little-endian on every target
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, words.numel(), _HASH_CHUNK_WORDS):
        w = words[lo:lo + _HASH_CHUNK_WORDS].to(torch.int64)
        w.bitwise_and_(_U32)
        w.mul_(torch.arange(lo + 1, lo + 1 + w.numel(), dtype=torch.int64,
                            device=dev))
        total += w.bitwise_and_(_U32).sum()
    return total.bitwise_and_(_U32)


def _select(tree: Any):
    """``(paths, tensors)`` of the tree's tensor leaves in flatten order."""
    flat = [(p, l) for p, l in tree_flatten_with_path(tree)
            if isinstance(l, torch.Tensor)]
    return [p for p, _ in flat], [l for _, l in flat]


def replica_hashes(tree: Any, *, axis_name=None, shard_group=None) -> dict:
    """Per-replica hashes and max-abs deltas for every tensor leaf:
    ``{keystr: {"hashes": (dp,) uint32, "max_abs_delta": (dp,) float32}}``
    (numpy, on every rank).

    Each leaf's local hash is summed mod 2**32 over ``shard_group``
    (combining a replica's tp/pp shards into one digest, as JAX's
    wrapping ``psum`` over the non-replica axes does) and all-gathered
    over the replicas; the delta is each replica's max ``|x - x_rank0|``
    in fp32 (a diagnostic magnitude; the byte hash is the equality
    oracle), its max over ``shard_group``, all-gathered.  Rank 0's copy
    reaches every replica by one broadcast a leaf.
    """
    group, shards = _groups(axis_name, shard_group)
    paths, leaves = _select(tree)
    if not leaves:
        return {}
    dev = leaves[0].device
    hashes = torch.stack([_shard_hash(x).to(dev) for x in leaves])
    n = _size(group)
    deltas = torch.zeros(len(leaves), dtype=torch.float32, device=dev)
    if n > 1:
        src = dist.get_global_rank(group, 0)
        for i, x in enumerate(leaves):
            x0 = x.detach().to(torch.float32).clone()
            dist.broadcast(x0, src=src, group=group)
            if x.numel():
                deltas[i] = (x.detach().to(torch.float32) - x0).abs().max()
    if _size(shards) > 1:
        dist.all_reduce(hashes, group=shards)
        hashes &= _U32
        dist.all_reduce(deltas, op=dist.ReduceOp.MAX, group=shards)
    if n > 1:
        h_all = [torch.empty_like(hashes) for _ in range(n)]
        d_all = [torch.empty_like(deltas) for _ in range(n)]
        dist.all_gather(h_all, hashes, group=group)
        dist.all_gather(d_all, deltas, group=group)
        hashes, deltas = torch.stack(h_all), torch.stack(d_all)
    else:
        hashes, deltas = hashes[None], deltas[None]
    h = hashes.cpu().numpy().astype(np.uint32)
    d = deltas.cpu().numpy()
    return {p: {"hashes": h[:, i], "max_abs_delta": d[:, i]}
            for i, p in enumerate(paths)}


def verify_replicas(tree: Any, *, axis_name=None, shard_group=None,
                    step: int = 0, emit: bool = True) -> list:
    """Prove the replicas bit-identical; localize every divergence.

    Returns a (possibly empty) list of :class:`DivergedLeaf`, one per
    leaf whose per-replica hashes disagree with rank 0's, and (when
    ``emit``) a ``replica_desync`` event per diverged leaf.  ``ranks`` is
    relative to rank 0: when the fault landed on rank 0, every OTHER
    rank is reported; :func:`majority_root` finds the outlier."""
    t0 = time.monotonic()
    report = []
    for path, rec in replica_hashes(tree, axis_name=axis_name,
                                    shard_group=shard_group).items():
        hashes = rec["hashes"]
        bad = tuple(int(r) for r in range(len(hashes))
                    if int(hashes[r]) != int(hashes[0]))
        if not bad:
            continue
        max_delta = float(np.max(rec["max_abs_delta"][list(bad)]))
        diverged = DivergedLeaf(path=path, ranks=bad,
                                max_abs_delta=max_delta,
                                hashes=tuple(int(h) for h in hashes))
        report.append(diverged)
        if emit:
            emit_event("replica_desync", leaf=path, step=int(step),
                       ranks=list(bad), max_abs_delta=max_delta,
                       replicas=int(len(hashes)))
    if emit and report:
        emit_event("replica_verify_failed", step=int(step),
                   diverged_leaves=[d.path for d in report], t0=t0)
    return report


def resync_replicas(tree: Any, *, axis_name=None, root: int = 0) -> Any:
    """Repair a desync: every replica adopts rank ``root``'s copy, in
    place (one broadcast a dtype,
    :func:`~apex_tpu_torch.parallel.distributed.broadcast_params`);
    returns ``tree``.  One rank has nothing to repair."""
    from apex_tpu_torch.parallel.distributed import broadcast_params

    group, _ = _groups(axis_name, None)
    _, leaves = _select(tree)
    if leaves and _size(group) > 1:
        with torch.no_grad():
            broadcast_params(leaves, group, root=int(root))
    return tree


def majority_root(report: Sequence[DivergedLeaf], *,
                  default: int = 0) -> int:
    """The safest broadcast source for a repair: a replica whose hash
    agrees with the strict per-leaf MAJORITY for every diverged leaf;
    ``default`` when no rank is majority-consistent across all of them
    (a 50/50 split at dp = 2, where the hashes alone cannot say who is
    right)."""
    candidates: Optional[set] = None
    for d in report:
        counts: dict = {}
        for h in d.hashes:
            counts[h] = counts.get(h, 0) + 1
        best = max(counts.values())
        maj = (set() if best * 2 <= len(d.hashes)
               else {r for r, h in enumerate(d.hashes)
                     if counts[h] == best})
        candidates = maj if candidates is None else candidates & maj
    return min(candidates) if candidates else int(default)


def collapse_replicas(tree: Any) -> Any:
    """The logical copy of the replicated state: with one process a
    replica, this rank's own copy, returned as it is (JAX drops the
    stacked axis and keeps rank 0's).  Verify replicas first: a desynced
    rank's copy is its own."""
    return tree


def expand_replicas(tree: Any, axis_name=None) -> Any:
    """The logical copy on every replica: rank 0's copy broadcast to
    every rank of the data-parallel group ``axis_name`` (where JAX takes
    the mesh), in place, after an elastic restore at a new dp world size
    (JAX broadcasts along a new stacked axis).  Returns ``tree``."""
    return resync_replicas(tree, axis_name=axis_name, root=0)


class ReplicaConsistency:
    """verify -> resync -> re-verify, as one supervisor-pluggable pass.

    ``check(state, step)`` returns the (possibly repaired) state.  On
    divergence it resyncs from the :func:`majority_root`, falling back to
    ``root`` when the hashes cannot elect one, then re-verifies.  It
    raises :class:`ReplicaDesyncError` only when ``resync`` is disabled
    or the repair fails to converge — which the supervisor counts as an
    unrecovered failure.
    """

    def __init__(self, axis_name=None, *, shard_group=None,
                 resync: bool = True, root: int = 0):
        self.axis_name = axis_name
        self.shard_group = shard_group
        self.resync = resync
        self.root = root
        self.resyncs = 0  # lifetime repair count (observability)

    def check(self, tree: Any, *, step: int = 0) -> Any:
        kw = dict(axis_name=self.axis_name, shard_group=self.shard_group)
        report = verify_replicas(tree, step=step, **kw)
        if not report:
            return tree
        if not self.resync:
            raise ReplicaDesyncError(step, report)
        t0 = time.monotonic()
        root = majority_root(report, default=self.root)
        repaired = resync_replicas(tree, axis_name=self.axis_name,
                                   root=root)
        still_bad = verify_replicas(repaired, step=step, emit=False, **kw)
        if still_bad:
            raise ReplicaDesyncError(step, still_bad)
        self.resyncs += 1
        emit_event("replica_resync", step=int(step), root=root,
                   leaves=[d.path for d in report],
                   resyncs=self.resyncs, t0=t0)
        return repaired
