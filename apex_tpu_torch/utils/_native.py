"""The host runtime ``csrc/packing.cpp``, built and bound on first use
(counterpart of ``apex_tpu/utils/_native.py``).

The source compiles with the host C++ compiler (``$CXX``, else ``c++``)
into ``build/apex_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of the source and the flags, and loads
through :mod:`ctypes`::

    c++ -O3 -shared -fPIC -std=c++17 -o build/apex_tpu_torch/packing-<hash>.so packing.cpp

Importing this module builds nothing.  A failed build, or a library whose
interface version is not this module's, raises: unlike the JAX module,
whose ``lib()`` returns None and lets its callers take a numpy loop,
nothing here degrades quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

__all__ = ["lib", "flatten_into", "unflatten_from"]

_ABI = 1
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX, c++ or g++ on PATH) "
                           "to build csrc/packing.cpp")
    return cxx


def _build() -> ctypes.CDLL:
    from apex_tpu_torch.ops._build import BUILD_DIR, CSRC

    src = CSRC / "packing.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode())
    out = BUILD_DIR / f"packing-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a name of this process's own: concurrent builds must not write
        # into one file before the atomic replace
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"building csrc/packing.cpp failed "
                               f"({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    native = ctypes.CDLL(str(out))
    native.apex_tpu_torch_native_abi.restype = ctypes.c_int32
    abi = native.apex_tpu_torch_native_abi()
    if abi != _ABI:
        raise RuntimeError(f"{out}: interface version {abi}, expected {_ABI}")
    native.apex_tpu_torch_flatten.restype = ctypes.c_int64
    native.apex_tpu_torch_flatten.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_void_p]
    native.apex_tpu_torch_unflatten.restype = ctypes.c_int64
    native.apex_tpu_torch_unflatten.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p)]
    return native


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = _build()
        return _lib


def flatten_into(arrays: Sequence[np.ndarray], out: np.ndarray) -> int:
    """Copy every C-contiguous array of ``arrays`` end to end into ``out``
    (C-contiguous, at least their bytes together).  Returns the bytes
    written."""
    n = len(arrays)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    sizes = (ctypes.c_int64 * n)(*[a.nbytes for a in arrays])
    return lib().apex_tpu_torch_flatten(srcs, sizes, n,
                                        ctypes.c_void_p(out.ctypes.data))


def unflatten_from(flat: np.ndarray, arrays: Sequence[np.ndarray]) -> int:
    """The inverse of :func:`flatten_into`: ``flat``'s bytes scattered
    into the C-contiguous ``arrays`` in order.  Returns the bytes read."""
    n = len(arrays)
    dsts = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    sizes = (ctypes.c_int64 * n)(*[a.nbytes for a in arrays])
    return lib().apex_tpu_torch_unflatten(ctypes.c_void_p(flat.ctypes.data),
                                          sizes, n, dsts)
