"""Crash-safe JSON writers shared by the metric and trace exporters.

The port of the first part of ``apex_tpu.utils.serialization``:
:func:`atomic_write_json`, :func:`atomic_write_jsonl`,
:func:`_atomic_write_text` and :func:`json_finite`, copied whole.  The
pytree and leaf helpers after them in the JAX module (``np_dtype``,
``leaf_spec``, ``tree_to_host_dict`` / ``tree_from_host_dict``,
``leaf_crc32``, ...) are the leaf layer under the checkpoint manager and
wait for the resilience slice.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any


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
