"""Pre-allocated memory buffers (counterpart of
``apex_tpu/transformer/tensor_parallel/memory.py``).

:class:`MemoryBuffer` hands out views of one flat device tensor, a bump
allocator over it: each :meth:`MemoryBuffer.get` takes the next
``prod(shape)`` elements, and :meth:`MemoryBuffer.reset` rewinds the
offset (views already handed out stay valid and share the storage).
:class:`RingMemBuffer` rotates round-robin over ``num_buffers`` of them.
The JAX buffers hand out copies of slices of an immutable array; these
hand out views, so a write through one shows in the buffer, as in the
reference.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["MemoryBuffer", "RingMemBuffer"]


class MemoryBuffer:
    """``numel`` zeros of ``dtype`` on ``device`` (CUDA by default)."""

    def __init__(self, name: str, numel: int, dtype: torch.dtype,
                 device="cuda"):
        self.name = name
        self.numel = numel
        self.dtype = dtype
        self.data = torch.zeros((numel,), dtype=dtype,
                                device=resolve_device(device))
        self._offset = 0

    def reset(self) -> None:
        """Rewind the offset to the start."""
        self._offset = 0

    def get(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """A view of the next ``prod(shape)`` elements, in ``shape``;
        ``AssertionError`` when they pass the end."""
        size = math.prod(shape)
        if self._offset + size > self.numel:
            raise AssertionError("MemoryBuffer out of space")
        out = self.data[self._offset:self._offset + size].view(shape)
        self._offset += size
        return out


class RingMemBuffer:
    """``num_buffers`` :class:`MemoryBuffer` s named ``"{name} {i}"``."""

    def __init__(self, name: str, num_buffers: int, numel: int,
                 dtype: torch.dtype, device="cuda"):
        self.num_buffers = num_buffers
        self.buffers = [MemoryBuffer(f"{name} {i}", numel, dtype, device)
                        for i in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self) -> MemoryBuffer:
        """The next buffer of the ring, reset."""
        self._index = (self._index + 1) % self.num_buffers
        buf = self.buffers[self._index]
        buf.reset()
        return buf
