"""Packed LAMB over flat buffers: the phase-1 CUDA kernel, its plain
version, and the phase-2 trust ratios.

Counterpart of ``apex_tpu/ops/packed_update.py``'s LAMB path
(``packed_lamb_update``): the model's parameters, gradients and moments
live in flat fp32 buffers (:mod:`apex_tpu_torch.utils.packing`), and one
elementwise sweep updates them all, where the CUDA original walks a table
of tensor pointers.

- **Phase 1** (moments and raw update): on CUDA tensors the hand-written
  kernel ``csrc/lamb_phase1.cu`` (the Pallas ``_lamb_phase1_kernel``), on
  CPU tensors :func:`_plain_phase1`.  The eight step scalars ``[beta1,
  beta3, beta2, eps, wd, bc1, bc2, clip]`` reach the kernel as a small fp32
  tensor on the device (:func:`lamb_scalars`), so neither the clip factor,
  computed from the global gradient norm on the device, nor the bias
  corrections are read on the host.
- **Phase 2** (per-tensor trust ratios ``||p|| / ||u||`` and the apply):
  plain PyTorch, as it is XLA in the JAX package: one norm per leaf over
  its slice of the flat buffer, and the apply on each slice, so no
  per-element segment-id array is built.

The JAX package's packed Adam and Adagrad kernels (``_adam_kernel``,
``_adagrad_kernel``) are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register
from apex_tpu_torch.utils.packing import PackedSpec

__all__ = ["packed_lamb_update", "lamb_phase1", "lamb_scalars",
           "per_leaf_norms", "LAMB_PHASE1"]

LAMB_PHASE1 = register(Kernel(
    name="lamb_phase1", source="lamb_phase1.cu", symbol="apex_lamb_phase1",
    replaces="apex_tpu/ops/packed_update.py:212 _lamb_phase1_kernel"))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
Scalar = Union[float, torch.Tensor]


def lamb_scalars(beta1: Scalar, beta3: Scalar, beta2: Scalar, eps: Scalar,
                 weight_decay: Scalar, bc1: Scalar, bc2: Scalar, clip: Scalar,
                 device) -> torch.Tensor:
    """The phase-1 scalars as an fp32 ``[8]`` tensor on ``device``.  Each
    is a Python number (filled in by a kernel, no copy from the host) or a
    0-d tensor already on ``device`` (copied on the device): building it
    never waits for the card."""
    out = torch.empty(8, dtype=torch.float32, device=device)
    for i, val in enumerate((beta1, beta3, beta2, eps, weight_decay, bc1, bc2,
                             clip)):
        if isinstance(val, torch.Tensor):
            if val.device != out.device:
                raise ValueError(f"lamb_scalars: scalar {i} lies on "
                                 f"{val.device}, the buffer on {out.device}")
            out[i].copy_(val.reshape(()))
        else:
            out[i].fill_(float(val))
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _plain_phase1(g, p, m, v, scalars, adam_w_mode: bool):
    """``(m_new, v_new, update)`` in fp32, the Pallas kernel's arithmetic."""
    b1, b3, b2, eps, wd, bc1, bc2, clip = scalars.unbind()
    g = g.float() / clip
    p32 = p.float()
    if not adam_w_mode:
        g = g + wd * p32
    m_new = b1 * m + b3 * g
    v_new = b2 * v + (1.0 - b2) * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode:
        update = update + wd * p32
    return m_new, v_new, update


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _symbol():
    fn = getattr(_build.library(LAMB_PHASE1.source), LAMB_PHASE1.symbol)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ctypes.c_longlong, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _kernel_phase1(g, p, m, v, scalars, adam_w_mode: bool):
    """Launch the CUDA kernel; ``m`` and ``v`` are updated in place and the
    fp32 update returned.  Raises on anything the kernel does not take."""
    op = "lamb_phase1"
    if g.device.type != "cuda":
        raise ValueError(f"{op}: g lies on {g.device}, the kernel takes CUDA "
                         f"tensors")
    n = g.numel()
    for t, what in ((g, "g"), (p, "p"), (m, "m"), (v, "v")):
        if t.device != g.device or t.dim() != 1 or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(f"{op}: {what} must be a contiguous 1-d tensor "
                             f"of {n} elements on {g.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if n < 1:
        raise ValueError(f"{op}: empty buffers")
    for t, what in ((g, "g"), (p, "p")):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{op}: {what} dtype {t.dtype} is not fp32, bf16 "
                            f"or fp16")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"{op}: the moments are fp32, got {m.dtype} and "
                        f"{v.dtype}")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (8,) \
            or scalars.device != g.device or not scalars.is_contiguous():
        raise ValueError(f"{op}: scalars must be a contiguous fp32 [8] "
                         f"tensor on {g.device}")
    if g.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: g lies on {g.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    update = torch.empty(n, dtype=torch.float32, device=g.device)
    status = _symbol()(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        scalars.data_ptr(), m.data_ptr(), v.data_ptr(), update.data_ptr(), n,
        int(adam_w_mode), _DTYPE_CODES[g.dtype], _DTYPE_CODES[p.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(status, op)
    LAMB_PHASE1.launches += 1
    return update


def lamb_phase1(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, scalars: torch.Tensor,
                adam_w_mode: bool = True) -> torch.Tensor:
    """LAMB's moments and raw update over flat buffers: ``m`` and ``v``
    (fp32) are updated in place and the fp32 update is returned.  The kernel
    for CUDA tensors, the plain version for CPU ones."""
    if kernel_path(g, p, m, v, scalars):
        return _kernel_phase1(g, p, m, v, scalars, adam_w_mode)
    m_new, v_new, update = _plain_phase1(g, p, m, v, scalars, adam_w_mode)
    m.copy_(m_new)
    v.copy_(v_new)
    return update


# ---------------------------------------------------------------------------
# phase 2 and the whole step
# ---------------------------------------------------------------------------


def _leaf_slices(x: torch.Tensor, spec: PackedSpec) -> Sequence[torch.Tensor]:
    return [x[o:o + s] for o, s in zip(spec.offsets, spec.sizes)]


def per_leaf_norms(x32: torch.Tensor, spec: PackedSpec) -> torch.Tensor:
    """``[num_leaves]`` fp32 L2 norms, one per leaf's slice of the flat
    buffer (the JAX ``per_leaf_sqnorms``, rooted)."""
    if not spec.num_leaves:
        return torch.zeros(0, dtype=torch.float32, device=x32.device)
    return torch.stack([torch.linalg.vector_norm(s, dtype=torch.float32)
                        for s in _leaf_slices(x32, spec)])


@torch.no_grad()
def packed_lamb_update(flat_grad, flat_param, flat_m, flat_v, *,
                       spec: PackedSpec, lr: float, beta1: float,
                       beta2: float, beta3: float, eps: float,
                       weight_decay: float, bias_correction1: Scalar,
                       bias_correction2: Scalar, global_clip: Scalar,
                       adam_w_mode: bool = True, use_nvlamb: bool = False):
    """One packed FusedLAMB step over flat 1-D buffers laid out by
    ``spec``.  Phase 1 updates the fp32 moments ``flat_m`` and ``flat_v``
    in place; phase 2 scales each leaf's update by its trust ratio
    ``||p|| / ||u||`` (1 where either norm is 0, and for every leaf when
    neither ``weight_decay`` nor ``use_nvlamb``) and applies it to
    ``flat_param`` in place, in fp32.  Unlike the JAX function, which
    returns new arrays, this one returns its updated inputs
    ``(flat_param, flat_m, flat_v)``.  The bias corrections and the clip
    factor may be 0-d tensors on the buffers' device."""
    scalars = lamb_scalars(beta1, beta3, beta2, eps, weight_decay,
                           bias_correction1, bias_correction2, global_clip,
                           flat_param.device)
    update = lamb_phase1(flat_grad, flat_param, flat_m, flat_v, scalars,
                         adam_w_mode)
    p32 = flat_param if flat_param.dtype == torch.float32 else flat_param.float()
    if weight_decay or use_nvlamb:
        p_norms = per_leaf_norms(p32, spec)
        u_norms = per_leaf_norms(update, spec)
        ratios = torch.where((p_norms > 0) & (u_norms > 0), p_norms / u_norms,
                             1.0)
        steps = ratios * lr            # lr * ratio in fp32, one per leaf
        for i, (pv, uv) in enumerate(zip(_leaf_slices(p32, spec),
                                         _leaf_slices(update, spec))):
            pv.addcmul_(uv, steps[i], value=-1.0)
        # the padding, a leaf of its own with ratio 1 (its update is 0
        # while its gradient and moments stay 0)
        p32[spec.total:].add_(update[spec.total:], alpha=-lr)
    else:
        p32.add_(update, alpha=-lr)
    if p32 is not flat_param:
        flat_param.copy_(p32)
    return flat_param, flat_m, flat_v
