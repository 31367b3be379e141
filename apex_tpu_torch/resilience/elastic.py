"""Sharded (format v2) checkpoints: save per shard, restore onto any world
(counterpart of ``apex_tpu/resilience/elastic.py``).

- **Save** writes one *shard record* per (leaf, mesh-coordinate block):
  the leaf's partition spec cuts it into the block grid of the mesh's axis
  sizes, and each record carries its mesh coordinates, its index
  (start/stop per dim) and its own CRC32, so one flipped byte is
  localized to one shard of one leaf.
- **Manifest v2**: ``format_version: 2``, ``sharded: true``, the saving
  mesh's stamp, and per-leaf records of the GLOBAL shape, dtype,
  partition spec and shard list.
- **Restore** reassembles each leaf from its shard records (seek, read,
  CRC, place by index) onto the template's device and dtype, whatever
  mesh saved it: saving on ``dp 4 x tp 2`` and restoring for ``dp 2 x tp
  4`` or ``dp 8`` is bit for bit, since the bytes never pass through
  arithmetic.  With ``shardings=`` (``{path: ShardSlice}``) only a rank's
  block of a leaf is assembled, from the records that overlap it: a tp
  rank restores its slice without a whole-model copy in host memory.

The port has no ``jax.sharding``: a *mesh* is its axis sizes (``{"dp":
4, "tp": 2}``) and a spec is a :class:`PartitionSpec` (a tuple of axis
names, a tuple of them, or None per dim), given per leaf in ``specs=``
(a tree like ``tree`` with :class:`PartitionSpec` or None leaves, or a
``{keystr path: spec}`` mapping).  Two save forms:

(a) one process holds the global leaves and is given the specs and the
    mesh's axis sizes: the files are the JAX package's byte for byte for
    the same tree, specs and mesh shape;
(b) ``local=True`` under ``torch.distributed`` and an installed
    :mod:`~apex_tpu_torch.transformer.parallel_state`: every rank passes
    its own blocks, writes the shard records its mesh coordinates own
    into the shared ``data.bin`` (a block replicated over an axis is
    written by the rank at coordinate 0 of it), and rank 0 writes the
    manifest and commits.  The files equal form (a)'s.

Everything else (atomic temp dir + rename, orphan sweep, keep-last-K
rotation, the newest-valid fallback walk with ``checkpoint_rejected``
events) is :mod:`~apex_tpu_torch.resilience.checkpoint`'s machinery,
reused.  A root may mix v1 and v2 directories; both restore through
either module's walk.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import zlib
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.resilience.checkpoint import (
    _DATA,
    _FSYNC_INTERVAL_BYTES,
    _SHARDED_FORMAT_VERSION,
    CheckpointError,
    TreeSnapshot,
    _leaf_snapshots,
    _list_steps,
    _mesh_metadata,
    _observed,
    _read_manifest,
    _rotate,
    _step_dirname,
    _write_step_dir,
    snapshot_tree,
)
from apex_tpu_torch.utils.serialization import (
    _children,
    leaf_from_numpy,
    leaf_spec,
    np_dtype,
    tree_flatten_with_path,
    tree_map_with_path,
)

__all__ = [
    "PartitionSpec",
    "ShardedCheckpointManager",
    "restore_sharded_checkpoint",
    "save_sharded_checkpoint",
    "shard_bytes_read",
    "snapshot_sharded_tree",
    "validate_sharded_checkpoint",
]

# payload bytes read from shard records in this process (a block restore
# reads only the records that overlap its block)
_READ = {"bytes": 0}


def shard_bytes_read() -> int:
    """Payload bytes this process has read from v2 shard records."""
    return _READ["bytes"]


class PartitionSpec(tuple):
    """One leaf's partition spec: per dim an axis name, a tuple of them
    (split major-to-minor), or None (whole); trailing dims left out are
    whole.  ``PartitionSpec()`` is fully replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


# --------------------------------------------------------------------------
# partition-spec / shard-grid geometry
# --------------------------------------------------------------------------


def _entry_names(entry) -> tuple:
    """One spec entry as a tuple of axis names (None -> ``()``)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _spec_entries(spec, ndim: int) -> list:
    """A spec normalized to ``ndim`` per-dim tuples of axis names (``()``
    = whole dim); None is fully replicated, a short spec leaves the
    trailing dims whole."""
    return [_entry_names(spec[d] if spec is not None and d < len(spec)
                         else None)
            for d in range(ndim)]


def _shard_grid(entries: Sequence[tuple], shape: Sequence[int],
                axis_sizes: dict, what: str):
    """Yield ``(coords, index)`` for every shard of one leaf: ``coords``
    maps each partitioning axis to its coordinate, ``index`` is ``[[start,
    stop], ...]`` per dim.  A tuple entry splits its dim major-to-minor in
    axis order (``NamedSharding``'s layout).  Raises
    :class:`CheckpointError` on a repeated axis, an unknown axis, or a dim
    its axes do not divide."""
    axes = [a for entry in entries for a in entry]
    if len(set(axes)) != len(axes):
        raise CheckpointError(
            f"{what}: spec uses a mesh axis more than once ({axes})")
    blocks = []
    for d, entry in enumerate(entries):
        n = 1
        for a in entry:
            if a not in axis_sizes:
                raise CheckpointError(
                    f"{what}: spec axis {a!r} is not a mesh axis "
                    f"(mesh has {sorted(axis_sizes)})")
            n *= axis_sizes[a]
        if n and shape[d] % n:
            raise CheckpointError(
                f"{what}: dim {d} of size {shape[d]} is not divisible by "
                f"its partitioning axes {entry} (product {n})")
        blocks.append(shape[d] // n if n else shape[d])
    for combo in itertools.product(*[range(axis_sizes[a]) for a in axes]):
        coords = dict(zip(axes, combo))
        index = []
        for d, entry in enumerate(entries):
            block = 0
            for a in entry:
                block = block * axis_sizes[a] + coords[a]
            start = block * blocks[d]
            index.append([start, start + blocks[d]])
        yield coords, index


def _spec_json(entries: Sequence[tuple]) -> list:
    return [list(e) if e else None for e in entries]


# --------------------------------------------------------------------------
# save
# --------------------------------------------------------------------------


def _spec_paths(specs: Any) -> dict:
    """``{keystr path: spec}`` from a ``specs`` tree (PartitionSpec and
    None leaves) or an already flat mapping of paths."""
    if isinstance(specs, Mapping) and all(
            isinstance(k, str) and k.startswith(("[", "."))
            for k in specs):
        return dict(specs)
    out = {}

    def walk(node, prefix):
        kids = (None if node is None or isinstance(node, PartitionSpec)
                else _children(node))
        if kids is None:
            out[prefix] = node
            return
        for key, child in kids:
            walk(child, prefix + key)

    walk(specs, "")
    return out


def _resolve_spec_overrides(leaves: list, specs: Any) -> None:
    """Fold an explicit ``specs`` tree into the snapshot leaves' specs, in
    place; after it the snapshot is self-contained."""
    if specs is None:
        return
    by_path = _spec_paths(specs)
    paths = [snap.path for snap in leaves]
    if set(by_path) != set(paths):
        raise ValueError(
            f"specs has {len(by_path)} leaves for a tree of {len(paths)} "
            f"(pass a matching tree of PartitionSpecs; unmatched: "
            f"{sorted(set(by_path) ^ set(paths))[:5]})")
    for snap in leaves:
        override = by_path[snap.path]
        if override is not None:
            snap.spec = override


def _axis_sizes(mesh: Optional[Mapping]) -> dict:
    if mesh is None:
        from apex_tpu_torch.transformer import parallel_state

        mesh = parallel_state.mesh_axis_sizes() or {}
    return {str(a): int(n) for a, n in dict(mesh).items()}


def snapshot_sharded_tree(tree: Any, *, mesh: Optional[Mapping] = None,
                          specs: Any = None) -> TreeSnapshot:
    """Host snapshot for a sharded save (form (a)): owned leaf copies plus
    the shard-grid geometry (the mesh's axis sizes, each leaf's spec),
    captured now, so a background writer reads nothing live."""
    axis_sizes = _axis_sizes(mesh)
    snap = snapshot_tree(tree, mesh_meta=_mesh_metadata(axis_sizes or None))
    _resolve_spec_overrides(snap.leaves, specs)
    snap.axis_sizes = axis_sizes
    return snap


def _write_sharded_checkpoint(root: str, step: int, leaves: list, *,
                              axis_sizes: dict,
                              mesh_meta: Optional[dict],
                              keep: int,
                              t0: Optional[float] = None,
                              commit_gate=None,
                              progress_hook=None,
                              event_fields: Optional[dict] = None) -> str:
    """Form (a): the v2 shard-grid serialize/CRC over
    :func:`~apex_tpu_torch.resilience.checkpoint._write_step_dir`, from
    host snapshots of the global leaves."""
    t0 = time.monotonic() if t0 is None else t0

    def payload(f):
        records, offset, unsynced = [], 0, 0
        for i, snap in enumerate(leaves):
            arr = snap.array
            entries = _spec_entries(snap.spec, arr.ndim)
            shards = []
            for coords, index in _shard_grid(entries, arr.shape,
                                             axis_sizes, snap.path):
                block = arr[tuple(slice(lo, hi) for lo, hi in index)]
                data = np.ascontiguousarray(block).tobytes()
                shards.append({
                    "coords": coords,
                    "index": index,
                    "offset": offset,
                    "nbytes": len(data),
                    "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                })
                f.write(data)
                offset += len(data)
                unsynced += len(data)
                if unsynced >= _FSYNC_INTERVAL_BYTES:
                    f.flush()
                    os.fsync(f.fileno())
                    unsynced = 0
            records.append(_leaf_record(snap, list(arr.shape), entries,
                                        shards))
            if progress_hook is not None:
                progress_hook({"step": int(step), "record": i,
                               "path": snap.path, "bytes": offset})
        return records, offset

    final_dir, records, nbytes = _write_step_dir(
        root, step, payload,
        head_fields={"format_version": _SHARDED_FORMAT_VERSION,
                     "sharded": True},
        mesh_meta=mesh_meta, commit_gate=commit_gate)
    _rotate(root, keep, protect_step=int(step))
    emit_event("checkpoint_saved", step=int(step), bytes=nbytes,
               path=final_dir, sharded=True,
               n_shards=sum(len(r["shards"]) for r in records), t0=t0,
               **(event_fields or {}))
    return final_dir


def _leaf_record(snap, shape: list, entries, shards: list) -> dict:
    return {"path": snap.path, "shape": shape, "dtype": snap.dtype,
            "prng_key": snap.prng_key, "spec": _spec_json(entries),
            "shards": shards}


@_observed("save")
def save_sharded_checkpoint(root: str, step: int, tree: Any, *,
                            mesh: Optional[Mapping] = None,
                            specs: Any = None, keep: int = 3,
                            local: bool = False) -> str:
    """Write ``tree`` as the step-``step`` sharded checkpoint; returns its
    path.

    Form (a) (the default): ``tree`` holds the global leaves; each is cut
    into the grid its spec (``specs``; None = replicated) implies on
    ``mesh`` (axis sizes; default the installed parallel state's, or no
    axes).  Form (b) (``local=True``): every rank of the
    ``torch.distributed`` world calls this with its own blocks, the mesh
    and each rank's coordinates come from the installed
    :mod:`~apex_tpu_torch.transformer.parallel_state`, and the files equal
    form (a)'s for the assembled tree.  The atomic-commit / rotation
    contract is :func:`~apex_tpu_torch.resilience.checkpoint.
    save_checkpoint`'s, single-writer root included."""
    t0 = time.monotonic()
    if local:
        return _save_local(root, step, tree, specs=specs, keep=keep, t0=t0)
    axis_sizes = _axis_sizes(mesh)
    leaves = _leaf_snapshots(tree, copy=False)
    _resolve_spec_overrides(leaves, specs)
    return _write_sharded_checkpoint(
        root, step, leaves, axis_sizes=axis_sizes,
        mesh_meta=_mesh_metadata(axis_sizes or None), keep=keep, t0=t0)


def _save_local(root: str, step: int, tree: Any, *, specs: Any, keep: int,
                t0: float) -> str:
    """Form (b): each rank writes the shard records it owns at the offsets
    form (a) gives them; rank 0 gathers the CRCs, writes the manifest and
    commits (through the same ``_write_step_dir``)."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps

    axis_sizes = ps.mesh_axis_sizes()
    if axis_sizes is None:
        raise RuntimeError("save_sharded_checkpoint(local=True) needs the "
                           "parallel state installed "
                           "(parallel_state.initialize_model_parallel)")
    mine = {ps.DATA_PARALLEL_AXIS: ps.get_data_parallel_rank(),
            ps.PIPELINE_PARALLEL_AXIS: 0,
            ps.TENSOR_PARALLEL_AXIS: ps.get_tensor_model_parallel_rank()}
    rank = dist.get_rank()
    leaves = _leaf_snapshots(tree, copy=False)
    _resolve_spec_overrides(leaves, specs)
    # the global layout, the same on every rank: per leaf its grid, each
    # shard's offset, and which shards this rank writes
    layout, writes, offset = [], [], 0
    for i, snap in enumerate(leaves):
        arr = snap.array
        entries = _spec_entries(snap.spec, arr.ndim)
        gshape = [n * int(np.prod([axis_sizes[a] for a in e], dtype=int))
                  for n, e in zip(arr.shape, entries)]
        shards = []
        for coords, index in _shard_grid(entries, gshape, axis_sizes,
                                         snap.path):
            nbytes = int(np.prod([hi - lo for lo, hi in index], dtype=int)
                         ) * arr.dtype.itemsize
            shards.append({"coords": coords, "index": index,
                           "offset": offset, "nbytes": nbytes,
                           "crc32": None})
            if all(mine[a] == (coords[a] if a in coords else 0)
                   for a in axis_sizes):
                writes.append((i, len(shards) - 1))
            offset += nbytes
        layout.append((snap, gshape, entries, shards))
    total = offset

    def write_mine(f):
        crcs = []
        for i, j in writes:
            snap, _, _, shards = layout[i]
            data = np.ascontiguousarray(snap.array).tobytes()
            f.seek(shards[j]["offset"])
            f.write(data)
            crcs.append((i, j, zlib.crc32(data) & 0xFFFFFFFF))
        f.flush()
        os.fsync(f.fileno())
        return crcs

    def payload(f):
        f.truncate(total)
        dist.broadcast_object_list([f.name], src=0)
        crcs = write_mine(f)
        gathered = [None] * dist.get_world_size()
        dist.gather_object(crcs, gathered, dst=0)
        for part in gathered:
            for i, j, crc in part:
                layout[i][3][j]["crc32"] = crc
        records = [_leaf_record(snap, gshape, entries, shards)
                   for snap, gshape, entries, shards in layout]
        return records, total

    final = [None]
    if rank == 0:
        final[0], _, _ = _write_step_dir(
            root, step, payload,
            head_fields={"format_version": _SHARDED_FORMAT_VERSION,
                         "sharded": True},
            mesh_meta=_mesh_metadata(axis_sizes))
        _rotate(root, keep, protect_step=int(step))
        emit_event("checkpoint_saved", step=int(step), bytes=total,
                   path=final[0], sharded=True,
                   n_shards=sum(len(x[3]) for x in layout), t0=t0)
    else:
        name = [None]
        dist.broadcast_object_list(name, src=0)
        with open(name[0], "r+b") as f:
            crcs = write_mine(f)
        dist.gather_object(crcs, None, dst=0)
    # every rank returns once the step is committed
    dist.broadcast_object_list(final, src=0)
    return final[0]


# --------------------------------------------------------------------------
# validate / restore
# --------------------------------------------------------------------------


def _read_shard(f, shard: dict, rec: dict, ckpt_dir: str) -> np.ndarray:
    """Seek, read and CRC-check one shard record.  Defects the bytes can
    produce come back as :class:`CheckpointError`; an OSError on the open
    file is host I/O and propagates for the retry layer."""
    try:
        offset, nbytes = int(shard["offset"]), int(shard["nbytes"])
        if offset < 0 or nbytes < 0:
            raise ValueError(f"negative extent ({offset}, {nbytes})")
        index = [(int(lo), int(hi)) for lo, hi in shard["index"]]
        shape = [hi - lo for lo, hi in index]
        if any(lo < 0 or hi < lo or hi > g
               for (lo, hi), g in zip(index, rec["shape"])):
            raise ValueError(f"index {index} outside global "
                             f"shape {rec['shape']}")
        f.seek(offset)
        chunk = bytearray(nbytes)
        got = f.readinto(chunk)
        if got != nbytes:
            raise ValueError(f"short read ({got} of {nbytes} bytes)")
        _READ["bytes"] += nbytes
        arr = np.frombuffer(chunk, dtype=np_dtype(rec["dtype"]))
        arr = arr.reshape(shape)
    except CheckpointError:
        raise
    except OSError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"{ckpt_dir}: unusable shard {shard.get('coords')} of leaf "
            f"{rec.get('path', '?')!r}: {type(e).__name__}: {e}") from e
    if (zlib.crc32(chunk) & 0xFFFFFFFF) != shard.get("crc32"):
        raise CheckpointError(
            f"{ckpt_dir}: CRC mismatch on shard {shard.get('coords')} of "
            f"leaf {rec.get('path', '?')!r}")
    return arr


def _iter_shard_records(manifest: dict, ckpt_dir: str):
    for rec in manifest["leaves"]:
        if not isinstance(rec, dict) or not isinstance(
                rec.get("shards"), list):
            raise CheckpointError(
                f"{ckpt_dir}: leaf record "
                f"{rec.get('path', '?') if isinstance(rec, dict) else rec!r} "
                f"has no shard list")
        yield rec


def _check_tiling(rec: dict, ckpt_dir: str) -> None:
    """Prove one leaf's shard list tiles its global shape exactly: per
    dim the distinct intervals chain ``0..size`` with no gap or overlap,
    and the shard index set is exactly their cross product."""
    what = f"{ckpt_dir}: leaf {rec.get('path', '?')!r}"
    try:
        shape = [int(n) for n in rec["shape"]]
        ndim = len(shape)
        if 0 in shape:
            return
        indices = {tuple((int(lo), int(hi)) for lo, hi in s["index"])
                   for s in rec["shards"]}
    except Exception as e:
        raise CheckpointError(
            f"{what}: unusable shape/shard index list: "
            f"{type(e).__name__}: {e}") from e
    if len(indices) != len(rec["shards"]):
        raise CheckpointError(f"{what}: duplicate shard indices")
    if any(len(ix) != ndim for ix in indices):
        raise CheckpointError(f"{what}: shard index rank != leaf rank")
    n_blocks = 1
    for d in range(ndim):
        ivs = sorted({ix[d] for ix in indices})
        if not (ivs and ivs[0][0] == 0 and ivs[-1][1] == shape[d]
                and all(a[1] == b[0] for a, b in zip(ivs, ivs[1:]))):
            raise CheckpointError(
                f"{what}: dim {d} shard intervals {ivs} do not tile "
                f"[0, {shape[d]}) (gap or overlap)")
        n_blocks *= len(ivs)
    if len(indices) != n_blocks:
        raise CheckpointError(
            f"{what}: {len(indices)} shards do not fill the "
            f"{n_blocks}-block grid their per-dim intervals imply")


def _validate_shards(ckpt_dir: str, manifest: dict) -> None:
    """Tiling-check and CRC every shard of every leaf (the v2 body of
    ``checkpoint.validate_checkpoint``, which dispatches here)."""
    with open(os.path.join(ckpt_dir, _DATA), "rb") as f:
        for rec in _iter_shard_records(manifest, ckpt_dir):
            _check_tiling(rec, ckpt_dir)
            for shard in rec["shards"]:
                _read_shard(f, shard, rec, ckpt_dir)


def validate_sharded_checkpoint(ckpt_dir: str) -> None:
    """Prove a sharded checkpoint directory internally consistent:
    manifest structure, payload size, the tiling and every shard's CRC.
    Raises :class:`CheckpointError` on any defect."""
    manifest = _read_manifest(ckpt_dir)
    if manifest.get("format_version") != _SHARDED_FORMAT_VERSION:
        raise CheckpointError(
            f"{ckpt_dir}: not a sharded checkpoint (format_version "
            f"{manifest.get('format_version')})")
    _validate_shards(ckpt_dir, manifest)


def _assemble_leaf(f, rec: dict, tmpl: Any, ckpt_dir: str,
                   sl=None) -> Any:
    """One leaf from its shard records onto the template's device and
    dtype: the whole leaf, or with ``sl`` (a ``ShardSlice``) only its
    block, read from the records that overlap the block.  The tiling is
    proven before any byte is placed."""
    key = rec["path"]
    want_shape, want_dtype = leaf_spec(tmpl)
    if rec.get("prng_key"):
        raise CheckpointError(
            f"{ckpt_dir}: leaf {key!r} holds a JAX PRNG key; a torch tree "
            f"has no key leaf to restore it into")
    whole = tuple(want_shape) if sl is None else sl.whole_shape(want_shape)
    if list(whole) != rec.get("shape") or want_dtype != rec.get("dtype"):
        raise CheckpointError(
            f"{ckpt_dir}: leaf {key!r} is "
            f"{rec.get('dtype')}{rec.get('shape')}, template wants "
            f"{want_dtype}{list(whole)}"
            + ("" if sl is None else f" (its block {sl} of it)"))
    _check_tiling(rec, ckpt_dir)
    block = [(0, int(n)) for n in rec["shape"]]
    if sl is not None:
        block[sl.dim] = sl.bounds(int(rec["shape"][sl.dim]))
    try:
        out = np.empty([hi - lo for lo, hi in block],
                       dtype=np_dtype(rec["dtype"]))
    except Exception as e:
        raise CheckpointError(
            f"{ckpt_dir}: unusable leaf record {key!r}: "
            f"{type(e).__name__}: {e}") from e
    for shard in rec["shards"]:
        index = [(int(lo), int(hi)) for lo, hi in shard["index"]]
        lap = [(max(lo, blo), min(hi, bhi))
               for (lo, hi), (blo, bhi) in zip(index, block)]
        if any(lo >= hi for lo, hi in lap) and out.size:
            continue
        arr = _read_shard(f, shard, rec, ckpt_dir)
        src = tuple(slice(lo - s, hi - s)
                    for (lo, hi), (s, _) in zip(lap, index))
        dst = tuple(slice(lo - b, hi - b)
                    for (lo, hi), (b, _) in zip(lap, block))
        out[dst] = arr[src]
    leaf = leaf_from_numpy(out, tmpl)
    if getattr(leaf, "shape", out.shape) != out.shape:
        leaf = leaf.reshape(out.shape)      # a 0-d leaf through the copy
    return leaf


def _load_validated_sharded(ckpt_dir: str, like: Any,
                            shardings: Optional[Mapping] = None
                            ) -> tuple[Any, int]:
    """Validate-and-load in one pass: every shard read is CRC-checked as
    it is placed, and the template's structure, shapes and dtypes are
    enforced both ways.  A v1 directory goes to the whole-tree loader."""
    manifest = _read_manifest(ckpt_dir)
    if manifest.get("format_version") != _SHARDED_FORMAT_VERSION:
        from apex_tpu_torch.resilience.checkpoint import _load_validated

        return _load_validated(ckpt_dir, like, shardings=shardings)
    by_path = {r["path"]: r
               for r in _iter_shard_records(manifest, ckpt_dir)
               if isinstance(r.get("path"), str)}
    shardings = shardings or {}
    with open(os.path.join(ckpt_dir, _DATA), "rb") as f:
        def load(key, tmpl):
            rec = by_path.get(key)
            if rec is None:
                raise CheckpointError(
                    f"{ckpt_dir}: checkpoint has no leaf {key!r} "
                    f"(template/checkpoint structure mismatch)")
            return _assemble_leaf(f, rec, tmpl, ckpt_dir,
                                  shardings.get(key))

        tree = tree_map_with_path(load, like)
    extra = set(by_path) - {p for p, _ in tree_flatten_with_path(like)}
    if extra:
        raise CheckpointError(
            f"{ckpt_dir}: checkpoint has leaves the template does not: "
            f"{sorted(extra)[:5]}")
    return tree, manifest["step"]


@_observed("restore")
def restore_sharded_checkpoint(root: str, like: Any, *,
                               step: Optional[int] = None,
                               shardings: Optional[Mapping] = None
                               ) -> tuple[Any, int]:
    """Restore the newest *valid* checkpoint into ``like``'s structure,
    whatever mesh saved it; returns ``(tree, step)``.

    ``shardings`` (``{keystr path: ShardSlice}``) restores only those
    leaves' blocks, the template leaf then being the block.  Invalid
    candidates are skipped with a ``checkpoint_rejected`` event, ``step``
    pins one step (no fallback), and :class:`CheckpointError` is raised
    when nothing valid remains.  v1 candidates in a mixed root restore
    through the whole-tree loader."""
    candidates = ([step] if step is not None
                  else list(reversed(_list_steps(root))))
    errors: list = []
    for s in candidates:
        ckpt_dir = os.path.join(root, _step_dirname(s))
        t0 = time.monotonic()
        try:
            tree, got_step = _load_validated_sharded(ckpt_dir, like,
                                                     shardings)
        except CheckpointError as e:
            errors.append(str(e))
            emit_event("checkpoint_rejected", step=int(s), reason=str(e))
            if step is not None:
                raise
            continue
        emit_event("checkpoint_restored", step=int(got_step),
                   fallback=bool(candidates[0] != s), sharded=True, t0=t0)
        return tree, got_step
    raise CheckpointError(
        f"no valid checkpoint under {root!r}"
        + (f"; rejected: {errors}" if errors else " (directory empty)"))


@dataclasses.dataclass
class ShardedCheckpointManager:
    """Keep-last-K manager over one sharded checkpoint root: the
    :class:`~apex_tpu_torch.resilience.checkpoint.CheckpointManager`
    surface (``save`` / ``restore`` / ``latest_valid_step``, the async
    pipeline's ``snapshot`` / ``write_snapshot``) with per-shard records.
    ``mesh`` is the axis sizes saves cut their grid on (default: the
    installed parallel state's)."""

    root: str
    keep: int = 3
    mesh: Optional[Mapping] = None
    retry: Optional["RetryPolicy"] = None

    def _retrying(self, fn, what: str):
        if self.retry is None:
            return fn()
        from apex_tpu_torch.resilience.retry import retry_transient

        return retry_transient(fn, policy=self.retry, what=what)

    def save(self, step: int, tree: Any, *, specs: Any = None) -> str:
        return self._retrying(
            lambda: save_sharded_checkpoint(self.root, step, tree,
                                            mesh=self.mesh, specs=specs,
                                            keep=self.keep),
            "sharded_checkpoint_save")

    def snapshot(self, tree: Any, *, specs: Any = None) -> TreeSnapshot:
        """Host snapshot with the shard-grid geometry (blocking, fast)."""
        return snapshot_sharded_tree(tree, mesh=self.mesh, specs=specs)

    def write_snapshot(self, step: int, snapshot: TreeSnapshot, *,
                       commit_gate=None, progress_hook=None) -> str:
        """Serialize and commit a sharded :class:`TreeSnapshot` (the slow
        phase; safe on a background thread), under ``retry``."""
        return self._retrying(
            lambda: _write_sharded_checkpoint(
                self.root, step, snapshot.leaves,
                axis_sizes=snapshot.axis_sizes or {},
                mesh_meta=snapshot.mesh, keep=self.keep,
                commit_gate=commit_gate, progress_hook=progress_hook,
                event_fields={"background": True}),
            "sharded_checkpoint_write")

    def restore(self, like: Any, *, step: Optional[int] = None,
                shardings: Optional[Mapping] = None):
        return self._retrying(
            lambda: restore_sharded_checkpoint(self.root, like, step=step,
                                               shardings=shardings),
            "sharded_checkpoint_restore")

    def all_steps(self) -> list:
        return _list_steps(self.root)

    def latest_valid_step(self) -> Optional[int]:
        from apex_tpu_torch.resilience.checkpoint import latest_valid_step

        return latest_valid_step(self.root)

    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.root, _step_dirname(step))
