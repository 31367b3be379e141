"""Trace annotation ranges (counterpart of ``apex_tpu/utils/nvtx.py``, the
NVTX ranges apex inserts by hand in ``parallel/distributed.py`` and
``sync_batchnorm.py``).

One annotation does two jobs, as in the JAX module:

- on the card, an NVTX range (``torch.cuda.nvtx``), which Nsight shows on
  the device timeline;
- on the host, a ``torch.profiler.record_function`` span, which a
  ``torch.profiler`` trace shows on the CPU timeline.

The NVTX half runs only where ``torch.cuda.is_available()``: a CPU-only
build of PyTorch has no NVTX library.  :func:`range_push` /
:func:`range_pop` mirror ``torch.cuda.nvtx``'s pair so ported scripts keep
working; prefer the :func:`range` context manager in new code.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

import torch

__all__ = ["range", "range_push", "range_pop"]

_stack: List = []


@contextlib.contextmanager
def range(name: str) -> Iterator[None]:  # noqa: A001 - the nvtx API name
    """Label everything run inside with ``name``: an NVTX range on the card
    and a profiler span on the host."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def range_push(name: str) -> int:
    """``torch.cuda.nvtx.range_push``: open a :func:`range`; returns the
    new depth of the stack."""
    cm = range(name)
    cm.__enter__()
    _stack.append(cm)
    return len(_stack)


def range_pop() -> int:
    """``torch.cuda.nvtx.range_pop``: close the innermost open range;
    returns the depth it was popped from.  Raises without an open one."""
    if not _stack:
        raise RuntimeError("range_pop without a matching range_push")
    depth = len(_stack)
    _stack.pop().__exit__(None, None, None)
    return depth
