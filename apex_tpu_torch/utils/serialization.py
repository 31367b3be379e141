"""Host-side tree serialization: crash-safe JSON writers and the leaf
layer under :mod:`apex_tpu_torch.resilience.checkpoint`.

The port of ``apex_tpu.utils.serialization``.  The JSON writers
(:func:`atomic_write_json`, :func:`atomic_write_jsonl`,
:func:`json_finite`) are copied whole.  The leaf helpers work over the
port's trees: nested ``dict`` / ``OrderedDict`` (a ``state_dict``),
lists, tuples and named tuples, whose leaves are tensors, numpy arrays
or Python scalars; ``None`` is an empty subtree.  A leaf's
path is written as ``jax.tree_util.keystr`` writes it for the same
containers (``['params']['embed_tokens.weight']``, ``[0]``, ``.field``),
and leaves come in the same order (a plain ``dict``'s keys sorted, an
``OrderedDict``'s as inserted), so one manifest names the same leaf in
both packages.

A dtype numpy lacks (``bfloat16``, the float8s) is named as JAX names it
(through ``ml_dtypes`` there), but its bytes travel as an unsigned
integer array of the same width: :func:`np_dtype` maps such a name to that
integer type, :func:`leaf_to_numpy` views a bf16 tensor's bits as it, and
:func:`leaf_from_numpy` views them back.  Nothing here imports
``ml_dtypes``.  A torch tree holds no PRNG-key leaf, so
:func:`is_prng_key` is ``False`` throughout.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch


def atomic_write_json(path: str, payload: Any, **dump_kwargs) -> None:
    """Crash-safe JSON rewrite: temp file + ``fsync`` + ``os.replace``.

    The temp name embeds pid AND thread id, so concurrent writers (the
    watchdog monitor thread marking a stall while the main thread
    beats) never share a temp file and every rename stays atomic.  One
    helper for every small-JSON writer in the tree — heartbeats, metric
    snapshots, trace exports.
    """
    _atomic_write_text(path, lambda f: json.dump(payload, f,
                                                 **dump_kwargs))


def atomic_write_jsonl(path: str, rows: Any, **dump_kwargs) -> None:
    """Crash-safe JSON-Lines rewrite: one compact ``json.dumps`` line
    per row, through the same temp + ``fsync`` + ``os.replace`` dance
    as :func:`atomic_write_json` — a reader never sees a half-written
    file.  Rows must each be JSON-serializable under ``dump_kwargs``
    (pre-sanitize with :func:`json_finite` for ``allow_nan=False``)."""
    def write(f):
        for row in rows:
            f.write(json.dumps(row, **dump_kwargs))
            f.write("\n")

    _atomic_write_text(path, write)


def _atomic_write_text(path: str, write_fn) -> None:
    """The one temp + ``fsync`` + ``os.replace`` implementation both
    JSON writers share — a future fix to the atomic dance (parent-dir
    fsync, collision handling) lands in exactly one place."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # an unserializable payload must not litter half-written temp
        # files next to checkpoints on every failed export
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def json_finite(obj: Any) -> Any:
    """Deep-copy with non-finite floats replaced by None (JSON has no
    NaN/Inf; a strict parser must never choke on an exported snapshot).
    Tuples/sets normalize to lists — ``json.dump`` serializes them
    natively, so a NaN nested in a tuple would otherwise slip past this
    walk straight into ``allow_nan=False``'s raise.  Shared by the
    metrics and trace exporters."""
    if isinstance(obj, float):
        return obj if -float("inf") < obj < float("inf") else None
    if isinstance(obj, dict):
        return {k: json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [json_finite(v) for v in obj]
    return obj


# dtypes numpy has no type for: the unsigned integer of the same width
# their bytes are read as, the signed one torch views them through, and
# the torch dtype itself
_RAW_BITS = {
    "bfloat16": (np.uint16, torch.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.uint8, torch.float8_e5m2),
}
_TORCH_ONLY = {v[2]: k for k, v in _RAW_BITS.items()}


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf of dtype ``name`` is held as on the host:
    ``np.dtype(name)``, or for ``bfloat16`` and the float8s the unsigned
    integer of the same width (their raw bits), whether or not
    ``ml_dtypes`` is loaded."""
    if name in _RAW_BITS:
        return np.dtype(_RAW_BITS[name][0])
    return np.dtype(name)


def is_prng_key(leaf: Any) -> bool:
    """Always False: a torch tree holds no typed PRNG key (kept for the
    JAX module's surface)."""
    return False


def dtype_name(leaf: Any) -> str:
    """A leaf's dtype as a manifest names it (``float32``, ``bfloat16``,
    ``int64`` for a Python int)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.dtype(getattr(leaf, "dtype", None)
                    or np.asarray(leaf).dtype).name


def leaf_spec(leaf: Any) -> tuple[tuple, str]:
    """``(shape, dtype name)`` of a leaf's serialized form, read without
    moving it off its device.  (The JAX function returns a numpy dtype;
    this one returns its name, since numpy has no bf16.)"""
    return tuple(np.shape(leaf) if not isinstance(leaf, torch.Tensor)
                 else leaf.shape), dtype_name(leaf)


def leaf_to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array: a tensor is brought to the CPU (a CPU
    tensor's array shares its memory), a bf16 or float8 tensor as its raw
    bits (:func:`np_dtype`)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        raw = _TORCH_ONLY.get(t.dtype)
        if raw is not None:
            bits = _RAW_BITS[raw]
            return t.view(bits[1]).cpu().numpy().view(bits[0])
        return t.cpu().numpy()
    return np.asarray(leaf)


def leaf_from_numpy(arr: np.ndarray, like: Any) -> Any:
    """A host array as a leaf matching ``like``: a tensor of ``like``'s
    dtype on ``like``'s device (bf16 and float8 rebuilt from their bits),
    a numpy array of ``like``'s dtype, or a Python or numpy scalar of
    ``like``'s type.  On the CPU the tensor may share ``arr``'s memory."""
    if isinstance(like, torch.Tensor):
        # ascontiguousarray returns a 0-d array as 1-d: keep the shape
        arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
        raw = _TORCH_ONLY.get(like.dtype)
        if raw is not None:
            bits = _RAW_BITS[raw]
            t = torch.from_numpy(arr.view(
                np.dtype(str(bits[1]).removeprefix("torch."))))
            t = t.view(bits[2])
        else:
            t = torch.from_numpy(arr)
        return t.to(like.device)
    if isinstance(like, np.ndarray):
        if arr.dtype != like.dtype and arr.dtype.itemsize == \
                like.dtype.itemsize:
            return arr.view(like.dtype)      # raw bits of an ml_dtypes leaf
        return arr
    if isinstance(like, np.generic):
        return arr.astype(like.dtype)[()]
    return type(like)(arr.item())


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any):
    """``(key string, child)`` pairs of a container in JAX's flatten
    order, or None for a leaf."""
    if isinstance(tree, OrderedDict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree: Any, children: list) -> Any:
    """A container like ``tree`` holding ``children`` (in
    :func:`_children`'s order)."""
    if isinstance(tree, dict):
        keys = (list(tree) if isinstance(tree, OrderedDict)
                else sorted(tree))
        made = dict(zip(keys, children))
        out = type(tree)() if isinstance(tree, OrderedDict) else {}
        for k in tree:                       # the caller's key order
            out[k] = made[k]
        return out
    if _is_namedtuple(tree):
        return type(tree)(*children)
    return type(tree)(children)


def tree_flatten_with_path(tree: Any, prefix: str = "") -> list:
    """``[(keystr path, leaf)]`` in flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(tree_flatten_with_path(child, prefix + key))
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """A tree like ``tree`` with every leaf replaced by ``fn(path,
    leaf)``, called in flatten order."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [tree_map_with_path(fn, child, prefix + key)
                           for key, child in kids])


def tree_paths(tree: Any) -> list[str]:
    """``keystr`` path of every leaf, in flatten order."""
    return [p for p, _ in tree_flatten_with_path(tree)]


def tree_to_host_dict(tree: Any) -> dict[str, np.ndarray]:
    """Flatten a tree to ``{keystr_path: numpy array}`` (the checkpointable
    form; bf16 leaves as their raw bits)."""
    return {p: leaf_to_numpy(l) for p, l in tree_flatten_with_path(tree)}


def tree_from_host_dict(d: dict[str, np.ndarray], like: Any) -> Any:
    """Rebuild a tree structured like ``like`` from a host dict.

    Strict: every template leaf must be present with matching shape and
    dtype (a bf16 leaf may come as its raw bits) — a silent partial
    restore is exactly the failure mode the resilience subsystem exists
    to prevent.
    """
    seen = set()

    def leaf(key, tmpl):
        if key not in d:
            raise KeyError(f"state dict is missing leaf {key!r}")
        seen.add(key)
        arr = np.asarray(d[key])
        want_shape, want_dtype = leaf_spec(tmpl)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {key!r}: shape {arr.shape} != template {want_shape}")
        if arr.dtype.name != want_dtype and arr.dtype != np_dtype(
                want_dtype):
            raise ValueError(
                f"leaf {key!r}: dtype {arr.dtype} != template {want_dtype}")
        return leaf_from_numpy(arr, tmpl)

    out = tree_map_with_path(leaf, like)
    extra = set(d) - seen
    if extra:
        raise KeyError(
            f"state dict has leaves the template does not: "
            f"{sorted(extra)[:5]}")
    return out


def leaf_crc32(arr: Any) -> int:
    """crc32 of the leaf's raw little-endian bytes (manifest validation);
    a tensor is read through :func:`leaf_to_numpy`."""
    if not isinstance(arr, np.ndarray):
        arr = leaf_to_numpy(arr)
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
