"""Packed optimizer updates over flat buffers: the Adam, LAMB phase-1 and
Adagrad CUDA kernels, their plain versions, and LAMB's phase-2 trust
ratios.

Counterpart of ``apex_tpu/ops/packed_update.py``
(``packed_adam_update``, ``packed_lamb_update``,
``packed_adagrad_update``): the model's parameters, gradients and
optimizer state live in flat buffers (:mod:`apex_tpu_torch.utils.packing`),
and one elementwise sweep updates them all, where the CUDA original walks a
table of tensor pointers.

- **Adam** (:func:`packed_adam_update`): on CUDA tensors the hand-written
  kernel ``csrc/packed_adam.cu`` (the Pallas ``_adam_kernel``), on CPU
  tensors :func:`_plain_adam`.  Scalars ``[lr, beta1, beta2, eps, wd, bc1,
  bc2, noop]`` (:func:`adam_scalars`).
- **Adagrad** (:func:`packed_adagrad_update`): ``csrc/packed_adagrad.cu``
  (the Pallas ``_adagrad_kernel``) or :func:`_plain_adagrad`.  Scalars
  ``[lr, eps, wd, noop]`` (:func:`adagrad_scalars`).
- **LAMB phase 1** (moments and raw update): ``csrc/lamb_phase1.cu`` (the
  Pallas ``_lamb_phase1_kernel``) or :func:`_plain_phase1`.  Scalars
  ``[beta1, beta3, beta2, eps, wd, bc1, bc2, clip]`` (:func:`lamb_scalars`).
- **LAMB phase 2** (per-tensor trust ratios ``||p|| / ||u||`` and the
  apply), XLA in the JAX package: one ``mt_l2norm`` over the leaves' views
  of ``p`` and of the update (their per-tensor norms), then ``mt_lamb``'s
  stage 2 over the same views (:mod:`apex_tpu_torch.ops.multi_tensor`; on
  the CPU their plain versions, a leaf at a time), so no per-element
  segment-id array is built.
- **NovoGrad** (:func:`packed_novograd_update`): plain PyTorch on every
  device, as the JAX function is jnp with no Pallas kernel: per-leaf sums
  of squares over the leaves' slices and an elementwise chain.

The step scalars reach each kernel as a small fp32 tensor on the device,
so neither the bias corrections, the clip factor (computed from the global
gradient norm on the device) nor the ``noop`` flag (the loss scaler's
``found_inf``) is read on the host.  A nonzero ``noop`` leaves every
buffer as it was.

Unlike the JAX functions, which return new arrays, these update their
buffers in place and return them: the parameters and the optimizer state
(``m``, ``v``, ``h``); the gradient is never written.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import (
    Kernel,
    kernel_path,
    register,
    resolve_device,
)
from apex_tpu_torch.utils.packing import PackedSpec

__all__ = ["packed_adam_update", "packed_adagrad_update",
           "packed_lamb_update", "packed_novograd_update", "adam_scalars", "adagrad_scalars",
           "lamb_phase1", "lamb_scalars", "LAMB_PHASE1",
           "PACKED_ADAM", "PACKED_ADAGRAD", "segment_ids_for_spec",
           "per_leaf_sqnorms"]

LAMB_PHASE1 = register(Kernel(
    name="lamb_phase1", source="lamb_phase1.cu", symbol="apex_lamb_phase1",
    replaces="apex_tpu/ops/packed_update.py:212 _lamb_phase1_kernel"))
PACKED_ADAM = register(Kernel(
    name="packed_adam", source="packed_adam.cu", symbol="apex_packed_adam",
    replaces="apex_tpu/ops/packed_update.py:36 _adam_kernel"))
PACKED_ADAGRAD = register(Kernel(
    name="packed_adagrad", source="packed_adagrad.cu",
    symbol="apex_packed_adagrad",
    replaces="apex_tpu/ops/packed_update.py:342 _adagrad_kernel"))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
Scalar = Union[float, torch.Tensor]


def _scalars(what: str, values: Sequence[Optional[Scalar]],
             device) -> torch.Tensor:
    """A kernel's step scalars as an fp32 tensor on ``device``.  Each is a
    Python number (filled in by a kernel, no copy from the host), a 0-d
    tensor already on ``device`` (copied, and so converted, on the device),
    or None for 0: building it never waits for the card."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, val in enumerate(values):
        if isinstance(val, torch.Tensor):
            if val.device != out.device:
                raise ValueError(f"{what}: scalar {i} lies on {val.device}, "
                                 f"the buffer on {out.device}")
            out[i].copy_(val.reshape(()))
        else:
            out[i].fill_(0.0 if val is None else float(val))
    return out


def lamb_scalars(beta1: Scalar, beta3: Scalar, beta2: Scalar, eps: Scalar,
                 weight_decay: Scalar, bc1: Scalar, bc2: Scalar, clip: Scalar,
                 device) -> torch.Tensor:
    """LAMB phase 1's scalars as an fp32 ``[8]`` tensor on ``device``
    (see :func:`_scalars`)."""
    return _scalars("lamb_scalars", (beta1, beta3, beta2, eps, weight_decay,
                                     bc1, bc2, clip), device)


def adam_scalars(lr: Scalar, beta1: Scalar, beta2: Scalar, eps: Scalar,
                 weight_decay: Scalar, bc1: Scalar, bc2: Scalar,
                 noop: Optional[Scalar], device) -> torch.Tensor:
    """The packed Adam scalars ``[lr, beta1, beta2, eps, wd, bc1, bc2,
    noop]`` as an fp32 tensor on ``device`` (see :func:`_scalars`): a bool
    ``noop`` tensor (``found_inf``) becomes 0 or 1 on the device."""
    return _scalars("adam_scalars", (lr, beta1, beta2, eps, weight_decay, bc1,
                                     bc2, noop), device)


def adagrad_scalars(lr: Scalar, eps: Scalar, weight_decay: Scalar,
                    noop: Optional[Scalar], device) -> torch.Tensor:
    """The packed Adagrad scalars ``[lr, eps, wd, noop]`` as an fp32
    tensor on ``device`` (see :func:`_scalars`)."""
    return _scalars("adagrad_scalars", (lr, eps, weight_decay, noop), device)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _plain_adam(g, p, m, v, scalars, adam_w_mode: bool):
    """``(p_new, m_new, v_new)``, the Pallas ``_adam_kernel``'s arithmetic
    term for term in fp32; ``p_new`` in ``p``'s dtype.  A nonzero ``noop``
    gives back the old values."""
    lr, b1, b2, eps, wd, bc1, bc2, noop = scalars.unbind()
    g = g.float()
    p32 = p.float()
    if adam_w_mode:
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        denom = torch.sqrt(v_new / bc2) + eps
        p_new = p32 - lr * ((m_new / bc1) / denom + wd * p32)
    else:
        g = g + wd * p32
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        denom = torch.sqrt(v_new / bc2) + eps
        p_new = p32 - lr * (m_new / bc1) / denom
    keep = noop == 0.0
    return (torch.where(keep, p_new, p32).to(p.dtype),
            torch.where(keep, m_new, m), torch.where(keep, v_new, v))


def _plain_adagrad(g, p, h, scalars, adagrad_w_mode: bool):
    """``(p_new, h_new)``, the Pallas ``_adagrad_kernel``'s arithmetic in
    fp32; ``p_new`` in ``p``'s dtype.  A nonzero ``noop`` gives back the
    old values."""
    lr, eps, wd, noop = scalars.unbind()
    g = g.float()
    p32 = p.float()
    if not adagrad_w_mode:
        g = g + wd * p32
    h_new = h + g * g
    update = g / (torch.sqrt(h_new) + eps)
    if adagrad_w_mode:
        update = update + wd * p32
    p_new = p32 - lr * update
    keep = noop == 0.0
    return torch.where(keep, p_new, p32).to(p.dtype), torch.where(keep, h_new, h)


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
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _symbol(kernel: Kernel, nargs_before_n: int):
    """The kernel's C entry point: ``nargs_before_n`` pointers, the length,
    three ints (mode, g's and p's dtype codes) and the stream."""
    fn = getattr(_build.library(kernel.source), kernel.symbol)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * nargs_before_n + [ctypes.c_longlong, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _check_flat(op: str, scalars: torch.Tensor, n_scalars: int, g, p,
                **state) -> int:
    """Raise on anything the flat kernels do not take: every buffer a
    contiguous 1-d tensor of one length on the current CUDA device, g and
    p fp32, bf16 or fp16, the optimizer state fp32, the scalars a
    contiguous fp32 ``[n_scalars]`` tensor there.  Returns the length."""
    if g.device.type != "cuda":
        raise ValueError(f"{op}: g lies on {g.device}, the kernel takes CUDA "
                         f"tensors")
    n = g.numel()
    for what, t in (("g", g), ("p", p), *state.items()):
        if t.device != g.device or t.dim() != 1 or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(f"{op}: {what} must be a contiguous 1-d tensor "
                             f"of {n} elements on {g.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if n < 1:
        raise ValueError(f"{op}: empty buffers")
    for what, t in (("g", g), ("p", p)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{op}: {what} dtype {t.dtype} is not fp32, bf16 "
                            f"or fp16")
    for what, t in state.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {what} is fp32, got {t.dtype}")
    if scalars.dtype != torch.float32 \
            or tuple(scalars.shape) != (n_scalars,) \
            or scalars.device != g.device or not scalars.is_contiguous():
        raise ValueError(f"{op}: scalars must be a contiguous fp32 "
                         f"[{n_scalars}] tensor on {g.device}")
    if g.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: g lies on {g.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return n


def _kernel_adam(g, p, m, v, scalars, adam_w_mode: bool) -> None:
    """Launch ``csrc/packed_adam.cu``: p, m and v updated in place."""
    n = _check_flat("packed_adam", scalars, 8, g, p, m=m, v=v)
    status = _symbol(PACKED_ADAM, 5)(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        scalars.data_ptr(), n, int(adam_w_mode), _DTYPE_CODES[g.dtype],
        _DTYPE_CODES[p.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(status, "packed_adam")
    PACKED_ADAM.launches += 1


def _kernel_adagrad(g, p, h, scalars, adagrad_w_mode: bool) -> None:
    """Launch ``csrc/packed_adagrad.cu``: p and h updated in place."""
    n = _check_flat("packed_adagrad", scalars, 4, g, p, h=h)
    status = _symbol(PACKED_ADAGRAD, 4)(
        g.data_ptr(), p.data_ptr(), h.data_ptr(), scalars.data_ptr(), n,
        int(adagrad_w_mode), _DTYPE_CODES[g.dtype], _DTYPE_CODES[p.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(status, "packed_adagrad")
    PACKED_ADAGRAD.launches += 1


def _kernel_phase1(g, p, m, v, scalars, adam_w_mode: bool):
    """Launch ``csrc/lamb_phase1.cu``; ``m`` and ``v`` are updated in place
    and the fp32 update returned."""
    n = _check_flat("lamb_phase1", scalars, 8, g, p, m=m, v=v)
    update = torch.empty(n, dtype=torch.float32, device=g.device)
    status = _symbol(LAMB_PHASE1, 8)(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        scalars.data_ptr(), m.data_ptr(), v.data_ptr(), update.data_ptr(), n,
        int(adam_w_mode), _DTYPE_CODES[g.dtype], _DTYPE_CODES[p.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(status, "lamb_phase1")
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
# packed Adam and Adagrad
# ---------------------------------------------------------------------------


@torch.no_grad()
def packed_adam_update(flat_grad, flat_param, flat_m, flat_v, *, lr, beta1,
                       beta2, eps, weight_decay, bias_correction1,
                       bias_correction2, noop_flag=None,
                       adam_w_mode: bool = True):
    """One packed Adam step over flat 1-D buffers of one length (any
    length: the JAX function's n % 1024 gate has no counterpart).
    ``flat_param`` (fp32, bf16 or fp16) and the fp32 moments ``flat_m`` and
    ``flat_v`` are updated in place and returned as ``(flat_param, flat_m,
    flat_v)``.  The bias corrections and ``noop_flag`` may be 0-d tensors
    on the buffers' device; a nonzero ``noop_flag`` (the loss scaler's
    ``found_inf``) leaves all three as they were."""
    scalars = adam_scalars(lr, beta1, beta2, eps, weight_decay,
                           bias_correction1, bias_correction2, noop_flag,
                           flat_param.device)
    if kernel_path(flat_grad, flat_param, flat_m, flat_v, scalars):
        _kernel_adam(flat_grad, flat_param, flat_m, flat_v, scalars,
                     adam_w_mode)
    else:
        for dst, src in zip((flat_param, flat_m, flat_v),
                            _plain_adam(flat_grad, flat_param, flat_m, flat_v,
                                        scalars, adam_w_mode)):
            dst.copy_(src)
    return flat_param, flat_m, flat_v


@torch.no_grad()
def packed_adagrad_update(flat_grad, flat_param, flat_h, *, lr, eps,
                          weight_decay, adagrad_w_mode: bool = False,
                          noop_flag=None):
    """One packed Adagrad step over flat 1-D buffers of one length:
    ``flat_param`` and the fp32 ``flat_h`` are updated in place and
    returned as ``(flat_param, flat_h)``; a nonzero ``noop_flag`` (a number
    or a 0-d tensor on their device) leaves both as they were."""
    scalars = adagrad_scalars(lr, eps, weight_decay, noop_flag,
                              flat_param.device)
    if kernel_path(flat_grad, flat_param, flat_h, scalars):
        _kernel_adagrad(flat_grad, flat_param, flat_h, scalars,
                        adagrad_w_mode)
    else:
        for dst, src in zip((flat_param, flat_h),
                            _plain_adagrad(flat_grad, flat_param, flat_h,
                                           scalars, adagrad_w_mode)):
            dst.copy_(src)
    return flat_param, flat_h


# ---------------------------------------------------------------------------
# phase 2 and the whole step
# ---------------------------------------------------------------------------


def segment_ids_for_spec(spec: PackedSpec, device="cuda") -> torch.Tensor:
    """The leaf index of each element of a flat buffer laid out by
    ``spec`` (int32, ``[padded_total]``); the padding gets the dead
    segment ``spec.num_leaves``.  Made on ``device`` (the card unless the
    caller asks for the CPU) from the leaves' end offsets
    (``searchsorted`` over an ``arange``), as the JAX function makes it on
    its device: only the small boundary table crosses from the host."""
    device = resolve_device(device)
    if spec.padded_total >= 2 ** 31:
        raise NotImplementedError(
            f"packed buffer of {spec.padded_total} elements exceeds int32 "
            "segment-id range; shard the parameters (ZeRO) below 2**31 "
            "elements per buffer")
    ends = [o + s for o, s in zip(spec.offsets, spec.sizes)]
    if list(spec.offsets[1:]) != ends[:-1]:
        raise ValueError("segment_ids_for_spec requires a contiguous "
                         "packed layout (offsets must tile sizes)")
    boundaries = torch.tensor(ends, dtype=torch.int32, device=device)
    return torch.searchsorted(
        boundaries, torch.arange(spec.padded_total, dtype=torch.int32,
                                 device=device),
        right=True).to(torch.int32)


def per_leaf_sqnorms(x32: torch.Tensor, spec: PackedSpec) -> torch.Tensor:
    """Each leaf's ``sum(x^2)`` over its contiguous slice of the flat
    buffer, then a 0 for the dead padding slot: ``[num_leaves + 1]``, the
    JAX function's dense per-slice reductions (no scatter)."""
    sums = [torch.sum(x32[o:o + s] * x32[o:o + s])
            for o, s in zip(spec.offsets, spec.sizes)]
    sums.append(torch.zeros((), dtype=x32.dtype, device=x32.device))
    return torch.stack(sums)


def _leaf_slices(x: torch.Tensor, spec: PackedSpec) -> Sequence[torch.Tensor]:
    return [x[o:o + s] for o, s in zip(spec.offsets, spec.sizes)]


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
    from apex_tpu_torch.ops import multi_tensor as mt

    scalars = lamb_scalars(beta1, beta3, beta2, eps, weight_decay,
                           bias_correction1, bias_correction2, global_clip,
                           flat_param.device)
    update = lamb_phase1(flat_grad, flat_param, flat_m, flat_v, scalars,
                         adam_w_mode)
    p32 = flat_param if flat_param.dtype == torch.float32 else flat_param.float()
    # each leaf's slice, then the padding as a leaf of its own with ratio 1
    # (its update is 0 while its gradient and moments stay 0)
    n = spec.num_leaves
    ps, us = _leaf_slices(p32, spec), _leaf_slices(update, spec)
    if p32.numel() > spec.total:
        ps.append(p32[spec.total:])
        us.append(update[spec.total:])
    norms = None
    if (weight_decay or use_nvlamb) and n:
        # one norm a leaf: p's slices, then the update's
        norms = mt.l2norm(ps[:n] + us[:n]).per_tensor
    mt.lamb_apply(ps, us, lr=lr, norms=norms, n_ratio=n)
    if p32 is not flat_param:
        flat_param.copy_(p32)
    return flat_param, flat_m, flat_v


@torch.no_grad()
def packed_novograd_update(flat_grad, flat_param, flat_m, seg_v, *,
                           spec: PackedSpec, lr: Scalar, beta1: float,
                           beta2: float, beta3: float, eps: float,
                           weight_decay: float, bias_correction1: Scalar,
                           bias_correction2: Scalar,
                           is_first_step: Union[bool, torch.Tensor],
                           init_zero: bool = False,
                           reg_inside_moment: bool = False):
    """One packed FusedNovoGrad step over flat 1-D buffers laid out by
    ``spec`` (the JAX ``packed_novograd_update``, with the leaves' offsets
    in place of its segment ids): ``seg_v`` is the per-tensor second moment
    ``[num_leaves + 1]`` (its last slot the padding's).  Plain PyTorch on
    every device, as the JAX function is jnp with no Pallas kernel: each
    leaf's ``sum(g^2)`` over its slice, then one elementwise chain.  Like
    the JAX function it writes nothing and returns ``(new_param, new_m,
    new_seg_v)``, the parameter in ``flat_param``'s dtype; the bias
    corrections and ``is_first_step`` may be 0-d tensors on the buffers'
    device."""
    p32 = flat_param.float()
    g = flat_grad.float()
    sizes = list(spec.sizes) + [flat_grad.numel() - spec.total]
    starts = list(spec.offsets) + [spec.total]
    g_sq = torch.stack([torch.sum(g[o:o + n] * g[o:o + n])
                        for o, n in zip(starts, sizes)])
    v_upd = beta2 * seg_v + (1.0 - beta2) * g_sq
    v_init = torch.zeros_like(g_sq) if init_zero else g_sq
    if isinstance(is_first_step, torch.Tensor):
        v_new = torch.where(is_first_step, v_init, v_upd)
    else:
        v_new = v_init if is_first_step else v_upd
    denom = torch.sqrt(v_new / bias_correction2) + eps
    # each segment's denominator over its elements (the JAX take(seg_ids))
    per_element = torch.cat([d.expand(n) for d, n in zip(denom.unbind(), sizes)])
    g_hat = g / per_element
    if weight_decay and reg_inside_moment:
        g_hat = g_hat + weight_decay * p32
    m_new = beta1 * flat_m + beta3 * g_hat
    update = m_new / bias_correction1
    if weight_decay and not reg_inside_moment:
        update = update + weight_decay * p32
    p_new = p32 - lr * update
    return p_new.to(flat_param.dtype), m_new, v_new
