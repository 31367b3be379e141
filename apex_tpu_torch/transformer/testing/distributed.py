"""Run a function on every rank of a fresh ``torch.distributed`` world of
spawned processes (counterpart of the reference's
``transformer/testing/distributed_test_base.py``; the JAX package runs
its ranks as virtual devices of one process instead).

>>> results = run_world(fn, 4, args=(weights,), timeout=120)

``fn(rank, world, *args)`` runs in ``world`` processes started with the
``spawn`` method, after ``torch.distributed.init_process_group`` over a
``file://`` rendezvous in a fresh temporary directory (no port to
collide with other worlds on the host) with ``timeout=`` on every
collective, and with ``torch`` limited to ``threads`` CPU threads.  It
must be a module-level function of an importable module; its return
values (picklable) come back as a list, rank by rank.  A rank that
raises fails the world with that rank's traceback.  The world as a whole
has the same ``timeout``: a rank still running then (a hung collective)
is killed with the others and :class:`WorldTimeout` is raised, so a test
fails instead of running its suite into its time limit.  Every process
started here is gone when ``run_world`` returns or raises.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

__all__ = ["run_world", "WorldTimeout", "WorldError"]


class WorldTimeout(RuntimeError):
    """A world did not finish within its timeout."""


class WorldError(RuntimeError):
    """A rank of a world raised."""


def _child(rank, world, path, backend, timeout, threads, fn, args, out):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{path}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            from apex_tpu_torch.transformer import parallel_state

            parallel_state.destroy_model_parallel()
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_world(fn, world: int, *, args=(), timeout: float = 120.0,
              backend: str = "gloo", threads: int = 1) -> list:
    """``[fn(r, world, *args) for r in ranks]``, each rank in its own
    process; see the module docstring."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tpworld_")
    out = ctx.Queue()
    procs = [ctx.Process(
        target=_child,
        args=(r, world, os.path.join(tmp, "rendezvous"), backend, timeout,
              threads, fn, tuple(args), out), daemon=True)
        for r in range(world)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise WorldTimeout(
                    f"world of {world} did not finish within {timeout} s "
                    f"(ranks done: {sorted(results)}, failed: "
                    f"{sorted(errors)})")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if dead:
                    # a rank that died without reporting (a signal)
                    raise WorldError(f"rank(s) {dead} of a world of {world} "
                                     f"exited with codes "
                                     f"{[procs[r].exitcode for r in dead]}")
                continue
            (results if ok else errors)[rank] = val
            if not ok:
                break
        if errors:
            rank = min(errors)
            raise WorldError(f"rank {rank} of a world of {world} raised:\n"
                             f"{errors[rank]}")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
