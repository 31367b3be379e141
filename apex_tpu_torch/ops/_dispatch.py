"""Kernel dispatch: which implementation a tensor goes to.

Counterpart of ``apex_tpu/ops/_dispatch.py``.  The rule here is by the
tensor's device alone:

- a CUDA tensor always goes to the hand-written kernel;
- a CPU tensor goes to the plain PyTorch version in the same module.

Nothing else decides: no environment switch, no shape predicate that
falls back, no ``try`` around a build or a launch.  A shape or dtype a
kernel does not take raises in its wrapper.

Each kernel is described by one :class:`Kernel` object, which also keeps
the plain integer count of its launches (``Kernel.launches``): the wrapper
adds one where it launches, and nowhere else, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

__all__ = ["Kernel", "KERNELS", "kernel_path", "resolve_device",
           "reset_launches"]


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source under ``csrc/``, the C entry
    point the source exports, the TPU kernel it replaces, and its launch
    count."""

    name: str
    source: str
    symbol: str
    replaces: str
    launches: int = 0


#: every kernel of the package, module by module (see ``ops/__init__.py``)
KERNELS: List[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def kernel_path(*tensors: Optional[torch.Tensor]) -> bool:
    """True if these tensors go to the hand-written kernel (all on CUDA),
    False if they go to the plain version (all on the CPU).  Raises on a
    mix of devices or on any other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"tensors lie on {sorted(kinds)}: a kernel call takes tensors that "
        f"all lie on CUDA (the kernel) or all on the CPU (its plain version)")


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on.  The default is CUDA; a caller
    that wants the CPU asks for it.  Asking for CUDA on a host without a
    usable card raises: an entry point never moves to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' (the default) but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
