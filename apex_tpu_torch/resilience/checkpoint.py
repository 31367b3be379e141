"""Validated atomic checkpointing for arbitrary trees.

The port of the whole-tree (v1) part of ``apex_tpu.resilience.checkpoint``
over the port's trees (nested dicts, lists and tuples of tensors, numpy
arrays and scalars; a ``state_dict`` is one).  For the same tree it
writes the same ``manifest.json`` records and the same ``data.bin`` bytes
as the JAX package (timestamps and the mesh stamp aside), so a checkpoint
written by either restores in the other.  A leaf restores onto its
template's device and dtype; a bf16 leaf travels as its raw bits
(:mod:`apex_tpu_torch.utils.serialization`).  A step directory in the
sharded format (v2, :mod:`apex_tpu_torch.resilience.elastic`) validates
shard by shard and restores through :func:`restore_checkpoint` too, so
:func:`validate_checkpoint`, :func:`latest_valid_step` and the
newest-valid walk take a root that mixes both formats (the JAX
``restore_checkpoint`` rejects a v2 step and leaves it to its elastic
module).  ``shardings=`` (``{keystr path: ShardSlice}``) restores only a
rank's block of those leaves: from a v1 record the leaf is read (its CRC
covers the whole record) and the block kept; from a v2 one only the shard
records that overlap the block are read.

Design constraints come straight from pod-scale operation (PAPERS.md:
"Exploring the limits of Concurrency in ML Training on Google TPUs" —
preemption is routine, not exceptional):

- **Atomic**: a checkpoint is a directory written under a temp name and
  ``os.replace``-renamed into place, so a SIGTERM at any byte offset
  leaves either the previous checkpoint set or a complete new one —
  never a half-written latest.
- **Validated**: ``manifest.json`` records (path, shape, dtype, offset,
  nbytes, crc32) for every leaf plus the total payload size; restore
  proves a candidate good *before* touching any training state.
- **Self-healing**: ``restore`` walks checkpoints newest-first and falls
  back to the newest one that validates, so a corrupt or truncated
  latest (disk full, preempted writer on a non-atomic filesystem) costs
  one checkpoint interval, not the run.
- **Bounded**: keep-last-K rotation; rotation happens only after the new
  checkpoint is durably in place.

On-disk layout (one directory per step)::

    <root>/step_0000000042/manifest.json   # schema + per-leaf records
    <root>/step_0000000042/data.bin        # concatenated raw leaf bytes

The wire format is raw little-endian numpy bytes addressed by
``jax.tree_util.keystr`` paths — no pickle, so a checkpoint can be
audited (or partially salvaged) with nothing but the manifest and
``np.frombuffer``.  Restore requires a template pytree (``like``) with
the same structure: structure lives in code, data lives on disk — the
same split as the reference's README "Checkpointing" recipe, where
``amp.load_state_dict`` is called on a freshly constructed object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.obs import trace as obs_trace
from apex_tpu_torch.utils.serialization import (
    dtype_name,
    is_prng_key,
    leaf_from_numpy,
    leaf_spec,
    leaf_to_numpy,
    np_dtype,
    tree_flatten_with_path,
    tree_map_with_path,
)

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "LeafSnapshot",
    "TreeSnapshot",
    "latest_valid_step",
    "restore_checkpoint",
    "save_checkpoint",
    "snapshot_tree",
    "validate_checkpoint",
]

logger = get_logger("resilience.checkpoint")

_FORMAT_VERSION = 1            # whole-tree manifests (this module)
_SHARDED_FORMAT_VERSION = 2    # per-shard manifests (resilience.elastic)
_KNOWN_VERSIONS = (_FORMAT_VERSION, _SHARDED_FORMAT_VERSION)
_STEP_PREFIX = "step_"
_TMP_PREFIX = "tmp_"
_MANIFEST = "manifest.json"
_DATA = "data.bin"

_CKPT_SECONDS = obs_metrics.histogram(
    "apex_checkpoint_duration_seconds",
    "checkpoint operation wall time by op (save/validate/restore)",
    ("op",))


def _observed(op: str):
    """Bracket a checkpoint entry point with a trace span and (on
    success only — failed-attempt latencies would poison percentiles)
    an ``apex_checkpoint_duration_seconds{op=...}`` observation."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with obs_trace.span(f"checkpoint_{op}"):
                result = fn(*args, **kwargs)
            _CKPT_SECONDS.observe(time.perf_counter() - t0, op=op)
            return result
        return wrapper
    return deco


class CheckpointError(RuntimeError):
    """A checkpoint failed validation, or no valid checkpoint exists."""

    # deterministic by definition, and the message may embed wrapped I/O
    # error text (the rejected-candidates list) that would match
    # RetryPolicy.transient_markers — never retried (retry.is_transient)
    transient = False


def _step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{step:010d}"


def _list_steps(root: str) -> list[int]:
    """Completed checkpoint steps under ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith(_STEP_PREFIX):
            try:
                steps.append(int(name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
    return sorted(steps)


def _fsync_dir(path: str) -> None:
    """Durably record a directory entry (rename atomicity needs the parent
    flushed too); best-effort on filesystems without dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _mesh_metadata(axis_sizes: Optional[dict] = None) -> Optional[dict]:
    """Mesh shape + world sizes as manifest ``mesh`` metadata, in the JAX
    package's schema.  ``axis_sizes`` (``{axis: size}``) keys the record;
    when omitted it is the installed parallel state's
    (:func:`~apex_tpu_torch.transformer.parallel_state.mesh_axis_sizes`),
    else the ``torch.distributed`` world as one ``dp`` axis, and None
    without a process group.  (The stamp is informational for a v1 tree:
    it is whole on every rank and restores at any world size.)"""
    if axis_sizes is None:
        from apex_tpu_torch.transformer import parallel_state

        axis_sizes = parallel_state.mesh_axis_sizes()
    if axis_sizes is None:
        if not (torch.distributed.is_available()
                and torch.distributed.is_initialized()):
            return None
        axis_sizes = {"dp": torch.distributed.get_world_size()}
    world = 1
    for n in axis_sizes.values():
        world *= n
    return {"axes": axis_sizes, "axis_names": list(axis_sizes),
            "world": world, "dp": axis_sizes.get("dp", 1),
            "tp": axis_sizes.get("tp", 1), "pp": axis_sizes.get("pp", 1)}


# Live-writer registry: while a (possibly background) writer is producing
# a checkpoint, its temp dir must survive another save's orphan sweep and
# its target step must survive rotation — the async pipeline serializes
# saves through backpressure, but the emergency path and direct manager
# calls share the root, so the protection is enforced here, at the one
# place sweeping/rotation happen, not by caller discipline.
_WRITERS_LOCK = threading.Lock()
_ACTIVE_TMP_DIRS: set[str] = set()            # abs temp dirs being produced
_ACTIVE_STEPS: set[tuple[str, int]] = set()   # (abs root, step) in flight


@contextlib.contextmanager
def _live_writer(root: str, step: int):
    """Create this writer's temp dir and mark it live in ONE atomic
    action (under ``_WRITERS_LOCK``, so a concurrent save's sweep can
    never observe the dir unregistered), yield its path, and unregister
    on exit, crashed or not — a crashed writer's litter becomes
    sweepable the moment this exits."""
    key = (os.path.abspath(root), int(step))
    with _WRITERS_LOCK:
        tmp_dir = tempfile.mkdtemp(prefix=_TMP_PREFIX, dir=root)
        tmp_abs = os.path.abspath(tmp_dir)
        _ACTIVE_TMP_DIRS.add(tmp_abs)
        _ACTIVE_STEPS.add(key)
    try:
        yield tmp_dir
    finally:
        with _WRITERS_LOCK:
            _ACTIVE_TMP_DIRS.discard(tmp_abs)
            _ACTIVE_STEPS.discard(key)


def _sweep_tmp_dirs(root: str) -> None:
    """Reclaim ``tmp_*`` dirs orphaned by a hard kill mid-save — except
    the ones a live writer (e.g. an in-flight background save) is still
    producing.  Liveness is re-checked under the lock per dir: creation
    and registration are one atomic action in :func:`_live_writer`, so
    a listed-but-unregistered dir is genuinely orphaned.  The
    single-writer root contract still holds for *foreign* processes:
    only this process's live writers are known."""
    for name in os.listdir(root):
        if not name.startswith(_TMP_PREFIX):
            continue
        full = os.path.abspath(os.path.join(root, name))
        with _WRITERS_LOCK:
            if full in _ACTIVE_TMP_DIRS:
                continue
        shutil.rmtree(full, ignore_errors=True)


def _commit_step_dir(root: str, tmp_dir: str, final_dir: str) -> None:
    """Atomically install ``tmp_dir`` as ``final_dir``.

    Re-save of an existing step moves the old dir ASIDE (rename) rather
    than rmtree-ing it before the new one lands — a kill between the two
    renames loses at most the microsecond swap window instead of the
    whole serialization time; the aside copy is deleted only after the
    new checkpoint is in place, and restored if the install fails.
    """
    aside = None
    try:
        if os.path.exists(final_dir):
            aside = tmp_dir + ".old"
            # the aside name starts with tmp_ — register it as live
            # BEFORE the rename so a concurrent writer's orphan sweep
            # cannot reap the only copy of the old checkpoint mid-swap
            with _WRITERS_LOCK:
                _ACTIVE_TMP_DIRS.add(os.path.abspath(aside))
            os.rename(final_dir, aside)
        try:
            os.replace(tmp_dir, final_dir)
        except BaseException:
            if aside is not None and not os.path.exists(final_dir):
                os.rename(aside, final_dir)  # put the old checkpoint back
            raise
        _fsync_dir(root)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
    finally:
        if aside is not None:
            with _WRITERS_LOCK:
                _ACTIVE_TMP_DIRS.discard(os.path.abspath(aside))


def _rotate(root: str, keep: int, protect_step: int) -> None:
    """Keep-last-``keep`` rotation, strictly after the new checkpoint is
    durable.  Two rules keep it from ever shrinking the recoverable set:
    ``protect_step`` (the just-written step) is never deleted — even when
    an undetected-corrupt newer dir occupies the keep window — and
    checkpoints that fail the cheap structural check (unreadable
    manifest / truncated payload) are dropped first rather than counted
    toward ``keep``."""
    if keep <= 0:
        return
    steps = _list_steps(root)
    sound = [s for s in steps
             if _quick_valid(os.path.join(root, _step_dirname(s)))]
    # keep-last-K counts only COMMITTED dirs (_list_steps never sees a
    # temp dir), and a step an in-flight background write is still
    # producing is never deleted — without this, an emergency save's
    # rotation could reap the dir the writer is about to commit onto
    with _WRITERS_LOCK:
        in_flight = {s for r, s in _ACTIVE_STEPS
                     if r == os.path.abspath(root)}
    retain = set(sound[-keep:]) | {int(protect_step)} | in_flight
    for old in steps:
        if old not in retain:
            shutil.rmtree(os.path.join(root, _step_dirname(old)),
                          ignore_errors=True)


# --------------------------------------------------------------------------
# snapshot (the only phase an async save ever blocks the step loop on)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LeafSnapshot:
    """One leaf, captured on the host: keystr path, an owned (or, for
    the in-line sync path, borrowed) numpy array, the PRNG-key flag
    (always False in the port) and the manifest dtype name (``bfloat16``
    for a bf16 leaf, whose ``array`` holds its raw bits) — everything a
    writer needs so that nothing about the LIVE training state is read
    after the snapshot returns."""

    path: str
    array: np.ndarray
    prng_key: bool = False
    dtype: Optional[str] = None     # None: array.dtype.name
    spec: Any = None                # partition spec (sharded saves only)

    def __post_init__(self):
        if self.dtype is None:
            self.dtype = self.array.dtype.name


@dataclasses.dataclass
class TreeSnapshot:
    """A host-side copy of a whole pytree plus the metadata a background
    writer needs (mesh stamp, shard-grid axis sizes).  Produced by
    :func:`snapshot_tree` / the managers' ``snapshot`` methods; consumed
    by their ``write_snapshot`` methods (possibly on another thread)."""

    leaves: list
    mesh: Optional[dict] = None          # manifest "mesh" stamp
    axis_sizes: Optional[dict] = None    # shard grid (sharded saves only)

    @property
    def nbytes(self) -> int:
        return sum(leaf.array.nbytes for leaf in self.leaves)


def _may_alias_live_state(leaf: Any) -> bool:
    """Can ``leaf_to_numpy(leaf)`` hand back memory the training loop
    might mutate?  A CUDA tensor comes to the host as a fresh owned copy;
    a CPU tensor's ``.numpy()`` is a VIEW of the live storage (which
    PyTorch's optimizers update in place), and numpy leaves come back as
    the caller's own object — those must be copied."""
    return not (isinstance(leaf, torch.Tensor) and leaf.device.type
                != "cpu")


def _leaf_snapshots(tree: Any, *, copy: bool) -> list[LeafSnapshot]:
    """Flatten + one device→host transfer a leaf.  ``copy=True``
    guarantees owned host buffers: leaves whose host form may alias live
    memory (see :func:`_may_alias_live_state`) get one extra host copy,
    so an in-place optimizer step can never overwrite them while a
    background writer is still serializing them — while device leaves
    stay a single device→host transfer (no doubled blocking cost)."""
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        arr = leaf_to_numpy(leaf)
        if copy and _may_alias_live_state(leaf):
            arr = np.array(arr, copy=True)
        out.append(LeafSnapshot(path=path, array=arr,
                                prng_key=is_prng_key(leaf),
                                dtype=dtype_name(leaf)))
    return out


_AUTO_MESH = object()  # sentinel: None is a valid (absent) mesh stamp


@_observed("snapshot")
def snapshot_tree(tree: Any, *, mesh_meta: Any = _AUTO_MESH) -> TreeSnapshot:
    """Snapshot ``tree`` to owned host memory — the fast, blocking phase
    of an asynchronous save (``apex_checkpoint_duration_seconds``
    ``{op="snapshot"}``).  Every leaf whose host form could alias live
    memory is copied (CUDA leaves are already a fresh copy — one
    transfer, not two), so the step loop may update the live state in
    place the moment this returns while a background writer serializes
    the snapshot.  ``mesh_meta``
    overrides the manifest mesh stamp (the sharded snapshot passes its
    axis-sizes-keyed record; default reads the installed parallel
    state)."""
    t0 = time.monotonic()
    leaves = _leaf_snapshots(tree, copy=True)
    snap = TreeSnapshot(
        leaves=leaves,
        mesh=_mesh_metadata() if mesh_meta is _AUTO_MESH else mesh_meta)
    emit_event("checkpoint_snapshot", bytes=snap.nbytes,
               n_leaves=len(leaves), t0=t0)
    return snap


# flush+fsync cadence for the payload stream: bounds dirty-page debt so
# the final fsync (and the host page cache) never owes the whole
# multi-GB payload at once — a background writer must not convert the
# step loop's savings into one giant I/O stall at commit time
_FSYNC_INTERVAL_BYTES = 64 * 2**20


def _write_step_dir(root: str, step: int, payload: Callable, *,
                    head_fields: dict,
                    mesh_meta: Optional[dict],
                    commit_gate: Optional[Callable[[], None]] = None,
                    ) -> tuple[str, list, int]:
    """The atomic-write scaffolding shared by BOTH formats (and by the
    sync and background callers of each): orphan sweep, live-claimed
    temp dir, payload streaming, fsynced manifest, vetoable commit,
    hard-kill-aware cleanup.  One implementation, so a fix to the
    crash/veto machinery cannot drift between v1 and v2.

    ``payload(f) -> (records, nbytes)`` streams the data file and
    returns the manifest leaf records; ``head_fields`` leads the
    manifest (``format_version``, v2's ``sharded`` flag) so the on-disk
    key order stays byte-identical to the historical writers.
    ``commit_gate`` (async pipeline) runs immediately before the atomic
    rename: raising there aborts the commit with the temp dir cleaned
    up — the consistency-veto hook.  An exception carrying
    ``preserve_partial_write=True`` (the simulated-hard-kill fault)
    leaves the partial temp dir on disk exactly as a SIGKILL would —
    never committable (temp names are invisible to ``_list_steps``),
    reclaimed by the next save's orphan sweep.  Returns
    ``(final_dir, records, nbytes)``; the caller rotates and emits its
    format's ``checkpoint_saved`` event.
    """
    os.makedirs(root, exist_ok=True)
    _sweep_tmp_dirs(root)
    final_dir = os.path.join(root, _step_dirname(step))
    with _live_writer(root, step) as tmp_dir:
        try:
            with open(os.path.join(tmp_dir, _DATA), "wb") as f:
                records, nbytes = payload(f)
                f.flush()
                os.fsync(f.fileno())
            manifest = {
                **head_fields,
                "step": int(step),
                "data_nbytes": nbytes,
                "mesh": mesh_meta,
                "leaves": records,
            }
            with open(os.path.join(tmp_dir, _MANIFEST), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            if commit_gate is not None:
                commit_gate()
            _commit_step_dir(root, tmp_dir, final_dir)
        except BaseException as e:
            if not getattr(e, "preserve_partial_write", False):
                shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
    return final_dir, records, nbytes


def _write_checkpoint(root: str, step: int, leaves: list[LeafSnapshot], *,
                      keep: int,
                      mesh_meta: Optional[dict],
                      t0: Optional[float] = None,
                      commit_gate: Optional[Callable[[], None]] = None,
                      progress_hook: Optional[Callable[[dict], None]] = None,
                      event_fields: Optional[dict] = None) -> str:
    """The v1 serialize/CRC machinery over :func:`_write_step_dir`, fed
    from host snapshots — shared verbatim by the sync save and the
    background writer, so the two paths cannot drift a byte.
    ``progress_hook`` fires after every leaf record (fault injection /
    tests)."""
    t0 = time.monotonic() if t0 is None else t0

    def payload(f):
        # stream leaves straight to disk (no second in-RAM bytes copy
        # of a potentially multi-GB state), offsets/CRCs as we go,
        # fsync incrementally so a crash mid-write leaves bounded
        # unsynced bytes in a dir that was never committable anyway
        records, offset, unsynced = [], 0, 0
        for i, snap in enumerate(leaves):
            arr = snap.array
            # ONE bytes copy per leaf: CRC and write share it.  (NB
            # shape is recorded from `arr`, not the contiguous copy —
            # ascontiguousarray promotes 0-d to 1-d.)
            data = np.ascontiguousarray(arr).tobytes()
            records.append({
                "path": snap.path,
                "shape": list(arr.shape),
                "dtype": snap.dtype,
                "prng_key": snap.prng_key,  # informational only
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
            if progress_hook is not None:
                progress_hook({"step": int(step), "record": i,
                               "path": snap.path, "bytes": offset})
        return records, offset

    final_dir, _, nbytes = _write_step_dir(
        root, step, payload,
        head_fields={"format_version": _FORMAT_VERSION},
        mesh_meta=mesh_meta, commit_gate=commit_gate)
    _rotate(root, keep, protect_step=int(step))
    emit_event("checkpoint_saved", step=int(step), bytes=nbytes,
               path=final_dir, t0=t0, **(event_fields or {}))
    return final_dir


@_observed("save")
def save_checkpoint(root: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Write ``tree`` as the step-``step`` checkpoint; returns its path.

    Write order is the crash-safety argument: (1) leaves + manifest into a
    temp directory, fsynced; (2) one atomic ``os.replace`` onto the final
    name; (3) only then rotate old checkpoints down to ``keep``.  A kill
    between any two of these leaves a restorable set on disk.

    ``root`` must have a SINGLE writer: the orphan sweep below reclaims
    every ``tmp_*`` dir this process is not actively producing, so a
    concurrent foreign saver's in-progress temp dir would be deleted out
    from under it.  In multi-process runs gate the save on
    ``torch.distributed.get_rank() == 0`` or give each process its own
    root.
    In-process, :class:`~apex_tpu_torch.resilience.async_checkpoint.
    AsyncCheckpointer` serializes background writes against this path by construction.
    """
    t0 = time.monotonic()
    leaves = _leaf_snapshots(tree, copy=False)
    return _write_checkpoint(root, step, leaves, keep=keep,
                             mesh_meta=_mesh_metadata(), t0=t0)


def _read_manifest(ckpt_dir: str) -> dict:
    """Manifest + structural checks (readable, right version, payload size
    matches — catches truncation and half-writes without touching data).

    Defensive throughout: bit corruption can hit the MANIFEST as easily as
    the payload, and a corrupt-but-parsable manifest must surface as
    :class:`CheckpointError` (so the restore walk falls back) rather than
    a stray KeyError/TypeError that aborts the walk.
    """
    manifest_path = os.path.join(ckpt_dir, _MANIFEST)
    data_path = os.path.join(ckpt_dir, _DATA)
    # ANY OSError here — missing, PermissionError after an orchestrator
    # restart — rejects the candidate so the fallback walk continues to an
    # older step: the manifest probe decides "is this a usable checkpoint",
    # unlike _read_record's mid-payload reads where an OSError on an open
    # file is environmental and propagates for the manager's retry.
    # UnicodeDecodeError: json.load on bit-flipped manifest bytes.
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(f"{ckpt_dir}: unreadable manifest: {e}") from e
    if not isinstance(manifest, dict) or not isinstance(
            manifest.get("leaves"), list):
        raise CheckpointError(f"{ckpt_dir}: manifest is not a leaf listing")
    if not isinstance(manifest.get("step"), int):
        raise CheckpointError(
            f"{ckpt_dir}: manifest step {manifest.get('step')!r} "
            f"is not an integer")
    if manifest.get("format_version") not in _KNOWN_VERSIONS:
        raise CheckpointError(
            f"{ckpt_dir}: format_version {manifest.get('format_version')} "
            f"not in {_KNOWN_VERSIONS}")
    try:
        actual = os.path.getsize(data_path)
    except OSError as e:
        raise CheckpointError(f"{ckpt_dir}: missing data.bin: {e}") from e
    if actual != manifest.get("data_nbytes"):
        raise CheckpointError(
            f"{ckpt_dir}: data.bin is {actual} bytes, manifest says "
            f"{manifest.get('data_nbytes')} (truncated or overgrown)")
    return manifest


def _read_record(f, rec: dict, ckpt_dir: str) -> np.ndarray:
    """Seek/read/CRC-check ONE manifest record; the single shared reader
    under both :func:`validate_checkpoint` and :func:`_load_validated`.
    Any defect a corrupted record can produce — bad offsets, nbytes not a
    dtype multiple, unknown dtype name, shape/size mismatch, CRC failure —
    comes back as :class:`CheckpointError`."""
    try:
        offset, nbytes = int(rec["offset"]), int(rec["nbytes"])
        if offset < 0 or nbytes < 0:
            raise ValueError(f"negative extent ({offset}, {nbytes})")
        f.seek(offset)
        # a mutable buffer: the array over it is writable, so a tensor
        # made from it (leaf_from_numpy) shares it without a copy
        chunk = bytearray(nbytes)
        got = f.readinto(chunk)
        if got != nbytes:
            raise ValueError(f"short read ({got} of {nbytes} bytes)")
        arr = np.frombuffer(chunk, dtype=np_dtype(rec["dtype"]))
        arr = arr.reshape(rec["shape"])
    except CheckpointError:
        raise
    except OSError:
        # seek/read failure on an OPEN file is host I/O (a blipping
        # network filesystem), not evidence about the checkpoint's bytes —
        # propagate unwrapped so CheckpointManager's RetryPolicy engages
        # instead of the fallback walk silently resuming an older step
        raise
    except Exception as e:  # corrupt record metadata, not a code path bug
        raise CheckpointError(
            f"{ckpt_dir}: unusable leaf record "
            f"{rec.get('path', '?')!r}: {type(e).__name__}: {e}") from e
    # CRC the bytes as read — the file bytes ARE the contiguous form the
    # manifest CRC was computed from, so this avoids leaf_crc32's tobytes()
    # copy (a second transient per-leaf allocation on multi-GB restores)
    if (zlib.crc32(chunk) & 0xFFFFFFFF) != rec.get("crc32"):
        raise CheckpointError(
            f"{ckpt_dir}: CRC mismatch on leaf {rec.get('path', '?')!r}")
    return arr


def _quick_valid(ckpt_dir: str) -> bool:
    """Cheap structural validity (no CRC pass) — the rotation-time check."""
    try:
        _read_manifest(ckpt_dir)
        return True
    except CheckpointError:
        return False


@_observed("validate")
def validate_checkpoint(ckpt_dir: str) -> None:
    """Prove a checkpoint directory internally consistent.

    Raises :class:`CheckpointError` on any defect: missing/unparsable
    manifest, wrong format version, payload size mismatch (truncation),
    or any per-leaf CRC mismatch (bit corruption).
    """
    manifest = _read_manifest(ckpt_dir)
    if manifest.get("format_version") == _SHARDED_FORMAT_VERSION:
        # v2 dirs validate shard by shard (tiling, then every CRC)
        from apex_tpu_torch.resilience.elastic import _validate_shards

        _validate_shards(ckpt_dir, manifest)
        return
    with open(os.path.join(ckpt_dir, _DATA), "rb") as f:
        for rec in manifest["leaves"]:
            _read_record(f, rec, ckpt_dir)


def _load_validated(ckpt_dir: str, like: Any,
                    shardings: Optional[dict] = None) -> tuple[Any, int]:
    """Validate-and-load in ONE pass over the payload: structural checks
    up front, then each leaf streamed (seek+read per manifest record, so
    peak host memory is one leaf, not the whole payload) and CRC-verified
    before it is materialized — no leaf reaches the caller without its
    CRC having passed, and restore never re-reads a multi-GB data.bin
    just to prove it good first."""
    manifest = _read_manifest(ckpt_dir)
    if manifest.get("format_version") == _SHARDED_FORMAT_VERSION:
        from apex_tpu_torch.resilience.elastic import _load_validated_sharded

        return _load_validated_sharded(ckpt_dir, like, shardings)
    shardings = shardings or {}
    # (the JAX package refuses a v1 checkpoint saved on another mesh
    # shape; the port has no model-parallel mesh, so every v1 tree is
    # whole and the guard has nothing to protect)
    by_path = {r.get("path"): r for r in manifest["leaves"]
               if isinstance(r, dict)}
    # strict BOTH ways: checkpoint leaves the template does not expect
    # mean structure drift, and a silent partial restore is the failure
    # mode this subsystem exists to prevent (checked before any read)
    extra = set(by_path) - {p for p, _ in tree_flatten_with_path(like)}
    if extra:
        raise CheckpointError(
            f"{ckpt_dir}: checkpoint has leaves the template does not: "
            f"{sorted(extra)[:5]}")

    with open(os.path.join(ckpt_dir, _DATA), "rb") as f:
        def load(key, tmpl):
            rec = by_path.get(key)
            if rec is None:
                raise CheckpointError(
                    f"{ckpt_dir}: checkpoint has no leaf {key!r} "
                    f"(template/checkpoint structure mismatch)")
            if rec.get("prng_key"):
                raise CheckpointError(
                    f"{ckpt_dir}: leaf {key!r} holds a JAX PRNG key; a "
                    f"torch tree has no key leaf to restore it into")
            # spec check without reading the live template off its device
            want_shape, want_dtype = leaf_spec(tmpl)
            sl = shardings.get(key)
            if sl is not None:
                # the template is the block; the record the whole leaf
                want_shape = sl.whole_shape(want_shape)
            if (list(want_shape) != rec.get("shape")
                    or want_dtype != rec.get("dtype")):
                raise CheckpointError(
                    f"{ckpt_dir}: leaf {key!r} is "
                    f"{rec.get('dtype')}{rec.get('shape')}, template wants "
                    f"{want_dtype}{list(want_shape)}")
            arr = _read_record(f, rec, ckpt_dir)
            if sl is not None:
                start, stop = sl.bounds(arr.shape[sl.dim])
                arr = np.ascontiguousarray(
                    arr[(slice(None),) * sl.dim + (slice(start, stop),)])
            return leaf_from_numpy(arr, tmpl)

        tree = tree_map_with_path(load, like)
    return tree, manifest["step"]


def in_flight_steps(root: str) -> set:
    """Steps an in-process writer is producing under ``root`` RIGHT NOW
    (the live-writer registry's view).  A reader walking the root —
    ``latest_valid_step``, the serving reload watcher — must skip
    these: a re-save of an existing step swaps the old dir aside before
    the new one lands, so the committed dir a concurrent reader sees
    for an in-flight step can vanish mid-read.  Steps a FOREIGN process
    is writing are invisible here (single-writer-root contract); their
    commits are atomic renames, so a reader only ever sees them whole.
    """
    root_abs = os.path.abspath(root)
    with _WRITERS_LOCK:
        return {s for r, s in _ACTIVE_STEPS if r == root_abs}


def latest_valid_step(root: str) -> Optional[int]:
    """Newest step whose checkpoint passes validation, or None.

    Race-hardened against a live writer sharing the root: steps the
    live-writer registry marks in flight (an ``AsyncCheckpointer``
    mid-commit) are skipped rather than half-read, and a step dir that
    vanishes mid-validation (rotation, or a re-save's aside swap) is
    treated as invalid-and-skipped instead of aborting the walk with a
    stray ``FileNotFoundError``."""
    live = in_flight_steps(root)
    for step in reversed(_list_steps(root)):
        if step in live:
            continue
        step_dir = os.path.join(root, _step_dirname(step))
        try:
            validate_checkpoint(step_dir)
            return step
        except CheckpointError:
            continue
        except OSError:
            if os.path.isdir(step_dir):
                raise          # environmental I/O error: genuinely fatal
            continue           # dir vanished under the walk: fall back
    return None


@_observed("restore")
def restore_checkpoint(root: str, like: Any, *,
                       step: Optional[int] = None,
                       shardings: Optional[dict] = None) -> tuple[Any, int]:
    """Restore the newest *valid* checkpoint into ``like``'s structure.

    Returns ``(tree, step)``.  Invalid candidates (corrupt, truncated, or
    structurally incompatible with ``like``) are skipped with a logged
    ``checkpoint_rejected`` event and the walk continues to older steps —
    the automatic-fallback contract.  ``step`` pins an exact step instead
    (no fallback).  Raises :class:`CheckpointError` when nothing valid
    remains.  A v2 (sharded) candidate restores here too, reassembled
    onto ``like`` (:mod:`~apex_tpu_torch.resilience.elastic`); with
    ``shardings`` only the named leaves' blocks are restored.
    """
    candidates = ([step] if step is not None
                  else list(reversed(_list_steps(root))))
    errors: list[str] = []
    for s in candidates:
        ckpt_dir = os.path.join(root, _step_dirname(s))
        t0 = time.monotonic()
        try:
            # validation is fused into the load (structural checks, then
            # per-leaf CRC as each chunk is sliced) — one payload pass
            tree, got_step = _load_validated(ckpt_dir, like, shardings)
        except CheckpointError as e:
            errors.append(str(e))
            emit_event("checkpoint_rejected", step=int(s), reason=str(e))
            if step is not None:
                raise
            continue
        emit_event("checkpoint_restored", step=int(got_step),
                   fallback=bool(candidates[0] != s), t0=t0)
        return tree, got_step
    raise CheckpointError(
        f"no valid checkpoint under {root!r}"
        + (f"; rejected: {errors}" if errors else " (directory empty)"))


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-K manager over one checkpoint root.

    ``retry`` (a :class:`~apex_tpu_torch.resilience.retry.RetryPolicy`) makes
    save/restore survive *transient* host I/O errors — a blipping
    network filesystem, a busy disk.  Safe to retry by construction:
    the save path sweeps its own temp litter and commits by atomic
    rename (re-running is idempotent), and on restore only the
    transient class is retried — a :class:`CheckpointError` is
    deterministic (corrupt bytes stay corrupt) and propagates at once
    so the newest-valid fallback walk proceeds instead of stalling.

    >>> mgr = CheckpointManager("/ckpts/run7", keep=3)
    >>> mgr.save(step, {"params": model.state_dict(),
    ...                 "opt": opt.state_dict()["state"], "step": step})
    >>> state, resume_step = mgr.restore(like=template)   # newest valid
    """

    root: str
    keep: int = 3
    retry: Optional["RetryPolicy"] = None

    def _retrying(self, fn, what: str):
        if self.retry is None:
            return fn()
        from apex_tpu_torch.resilience.retry import retry_transient

        return retry_transient(fn, policy=self.retry, what=what)

    def save(self, step: int, tree: Any) -> str:
        return self._retrying(
            lambda: save_checkpoint(self.root, step, tree, keep=self.keep),
            "checkpoint_save")

    # -- the async pipeline's two-phase surface ---------------------------
    # (apex_tpu_torch.resilience.async_checkpoint calls snapshot() on the step
    # loop's thread and write_snapshot() on the writer thread; together
    # they produce the EXACT bytes save() would — same machinery)

    def snapshot(self, tree: Any, *, specs: Any = None) -> TreeSnapshot:
        """Host snapshot of ``tree`` (blocking, fast, donation-safe).
        ``specs`` is accepted for drop-in symmetry with the JAX sharded
        manager and must be None here."""
        if specs is not None:
            raise ValueError(
                "CheckpointManager.snapshot takes no partition specs — "
                "use resilience.elastic.ShardedCheckpointManager")
        return snapshot_tree(tree)

    def write_snapshot(self, step: int, snapshot: TreeSnapshot, *,
                       commit_gate: Optional[Callable[[], None]] = None,
                       progress_hook: Optional[Callable[[dict], None]] = None,
                       ) -> str:
        """Serialize/commit a :class:`TreeSnapshot` (the slow phase; safe
        to run on a background thread).  Applies the manager's ``retry``
        policy exactly as :meth:`save` does."""
        return self._retrying(
            lambda: _write_checkpoint(
                self.root, step, snapshot.leaves, keep=self.keep,
                mesh_meta=snapshot.mesh, commit_gate=commit_gate,
                progress_hook=progress_hook,
                event_fields={"background": True}),
            "checkpoint_write")

    def restore(self, like: Any, *, step: Optional[int] = None):
        return self._retrying(
            lambda: restore_checkpoint(self.root, like, step=step),
            "checkpoint_restore")

    def all_steps(self) -> list[int]:
        return _list_steps(self.root)

    def latest_valid_step(self) -> Optional[int]:
        return latest_valid_step(self.root)

    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.root, _step_dirname(step))
