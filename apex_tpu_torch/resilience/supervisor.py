"""The training supervisor's heartbeat file.

The port of ``write_heartbeat`` / ``read_heartbeat`` of
``apex_tpu.resilience.supervisor``: ``beat`` atomically rewrites a small
JSON file (step, wall and monotonic time, pid, newest checkpoint path,
stall mark) that an external orchestrator — or a serving-side
:class:`~apex_tpu_torch.serving.reload.WeightWatcher` — watches.  Its
``ckpt_path`` is written strictly after the checkpoint's commit, so the
step it names is always whole.  The file is the JAX package's, field for
field, so either package reads the other's.  The rest of the supervisor
(step watchdog, escalation, emergency checkpoint) comes with the
training-side resilience slice of the port.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from apex_tpu_torch.utils.serialization import atomic_write_json

__all__ = ["read_heartbeat", "write_heartbeat"]


def write_heartbeat(path: str, step: int, *,
                    ckpt_path: Optional[str] = None,
                    stalled: bool = False) -> dict:
    """Atomically rewrite the heartbeat file; returns the payload.

    Same crash-safety move as the checkpoint writer (temp + ``os.replace``):
    a watcher never reads a half-written heartbeat.  ``monotonic`` rides
    along so in-process readers can compute stall-safe ages; external
    watchers use mtime / ``time``.  (The JAX writer adds the mesh
    coordinates of a model-parallel run; the port has no model-parallel
    state yet.)
    """
    payload = {
        "step": int(step),
        "time": time.time(),
        "monotonic": time.monotonic(),
        "pid": os.getpid(),
        "ckpt_path": ckpt_path,
        "stalled": bool(stalled),
    }
    # atomic_write_json embeds the thread ident in its temp name: a
    # monitor thread and the main thread may write concurrently
    atomic_write_json(path, payload)
    return payload


def read_heartbeat(path: str) -> dict:
    """Parse a heartbeat file (the watcher side of :func:`write_heartbeat`)."""
    with open(path) as f:
        return json.load(f)
