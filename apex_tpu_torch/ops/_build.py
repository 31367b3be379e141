"""Build the CUDA sources under ``apex_tpu_torch/csrc/`` on first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, which :mod:`ctypes` loads::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/apex_tpu_torch/<name>-<hash>.so <name>.cu

The sources share the device helpers in ``csrc/*.cuh``.  The library
lands in ``build/apex_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of the source, the shared headers and the
flags, so an edited source or header builds anew and an unchanged one is
reused.  Importing this module builds nothing and needs no ``nvcc``: the
build starts at the first launch on a CUDA tensor, or when a caller asks
for it with :func:`build_all`, which starts one ``nvcc`` per source, all
together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library",
           "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of apex_tpu_torch are "
        "built from csrc/ on the machine with the card")


def _target(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str) -> tuple:
    """Start ``nvcc`` for one source; returns (target, process) or
    (target, None) when the library is already built."""
    out = _target(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(out: Path, job) -> None:
    if job is None:
        return
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)


def build_all(sources: Iterable[str]) -> List[Path]:
    """Build every source that is not built yet, one ``nvcc`` each, all
    started together; returns the libraries' paths."""
    jobs = [(s, *_start(s)) for s in sources]
    for _, out, job in jobs:
        _finish(out, job)
    return [out for _, out, _ in jobs]


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            (path,) = build_all([source])
            lib = _LIBS[source] = ctypes.CDLL(str(path))
        return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
