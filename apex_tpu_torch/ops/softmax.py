"""Scaled (masked) softmax, forward and backward: CUDA kernels and their
plain versions.

Counterpart of ``apex_tpu/ops/softmax.py`` (the Megatron fused softmax
family).  On CUDA tensors the forward is the hand-written kernel
``csrc/scaled_softmax_fwd.cu`` (the Pallas ``_fwd_kernel``) and the
backward ``csrc/scaled_softmax_bwd.cu`` (the Pallas ``_bwd_kernel``); on CPU
tensors they are :func:`_plain_forward` and :func:`_plain_backward`.  The
function is the Pallas kernel's, for ``x [b, np, sq, sk]``:

- ``valid = (col <= row + (sk - sq) if causal) and not mask``, the mask
  ``[b, 1, sq, sk]`` (or broadcastable to it) with True meaning masked
  out, broadcast over heads;
- ``y = softmax(where(valid, x * scale, -10000))`` over each row in fp32,
  stored in ``x``'s dtype;
- a row with no valid element is all zeros, in the causal case as well as
  the masked one;
- the backward ``dx = scale * y * (dy - sum(y * dy))`` in fp32, stored in
  ``dy``'s dtype.  After a causal forward the kernel skips y and dy past a
  row's causal edge where y is 0 there (all but rows whose every valid
  score lay near the fill), which is the same formula for finite ``dy``.

The JAX package disagrees with itself on one point, and the port follows
its Pallas kernel: in a causal row with no valid key (``sq > sk``, rows
``row < sq - sk``), the kernel writes zeros and the jnp fallback
``_jnp_softmax``, which zeroes only rows its explicit mask covers, writes
a uniform row.

The JAX gate (``_kernel_ok``: ``sk % 128 == 0``, ``sk <= 4096``, ``sq`` a
multiple of 128) is the TPU's VMEM tiling and is not carried over: the
kernels take any ``sq`` and any ``sk`` from 1 to :data:`MAX_SK` (the
reference CUDA kernels' limit), fp32, bf16 and fp16, and raise on
anything else.  :func:`generic_scaled_masked_softmax` computes the same
function as :func:`scaled_masked_softmax` (the JAX ``_jnp_custom`` zeroes
fully masked rows too), so on the card it runs the same kernel.

A call that records a gradient goes through :class:`_SoftmaxFunction`,
which saves ``y`` (as the JAX ``_softmax_fwd`` does); a call that records
none runs the forward alone and saves nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["scaled_softmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax",
           "scaled_causal_masked_softmax", "generic_scaled_masked_softmax",
           "softmax_fwd", "softmax_bwd", "MAX_SK", "SCALED_SOFTMAX_FWD",
           "SCALED_SOFTMAX_BWD"]

SCALED_SOFTMAX_FWD = register(Kernel(
    name="scaled_softmax_fwd", source="scaled_softmax_fwd.cu",
    symbol="apex_scaled_softmax_fwd",
    replaces="apex_tpu/ops/softmax.py:69 _fwd_kernel"))
SCALED_SOFTMAX_BWD = register(Kernel(
    name="scaled_softmax_bwd", source="scaled_softmax_bwd.cu",
    symbol="apex_scaled_softmax_bwd",
    replaces="apex_tpu/ops/softmax.py:93 _bwd_kernel"))

#: the longest row the kernels take (the reference CUDA kernels' limit);
#: longer attention rows belong to flash attention
MAX_SK = 16384
_MASK_VALUE = -10000.0      # the additive fill of scaled_masked_softmax.h
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: fp32, or fp64 for fp64
    input (the CPU's ``gradcheck``)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _broadcast_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``mask`` as a bool ``[b, 1, sq, sk]`` view (the JAX
    ``broadcast_to``); raises if it does not broadcast."""
    b, _, sq, sk = x.shape
    return mask.to(torch.bool).expand(b, 1, sq, sk)


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _plain_forward(x, scale: float, mask=None, causal: bool = False):
    x32 = _acc(x) * scale
    sq, sk = x.shape[-2], x.shape[-1]
    valid = None
    if causal:
        valid = torch.ones(sq, sk, dtype=torch.bool,
                           device=x.device).tril(sk - sq)
    if mask is not None:
        keep = ~_broadcast_mask(mask, x)
        valid = keep if valid is None else valid & keep
    if valid is not None:
        x32 = torch.where(valid, x32, _MASK_VALUE)
    m = torch.amax(x32, dim=-1, keepdim=True)
    e = torch.exp(x32 - m)
    y = e / torch.sum(e, dim=-1, keepdim=True)
    if valid is not None:
        y = torch.where(torch.any(valid, dim=-1, keepdim=True), y, 0.0)
    return y.to(x.dtype)


def _plain_backward(y, dy, scale: float):
    y32, dy32 = _acc(y), _acc(dy)
    inner = torch.sum(y32 * dy32, dim=-1, keepdim=True)
    return (scale * y32 * (dy32 - inner)).to(dy.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _fwd_symbol():
    fn = getattr(_build.library(SCALED_SOFTMAX_FWD.source),
                 SCALED_SOFTMAX_FWD.symbol)
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, ll, i, i, i, ll, ll, ctypes.c_float, i, i,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def _bwd_symbol():
    fn = getattr(_build.library(SCALED_SOFTMAX_BWD.source),
                 SCALED_SOFTMAX_BWD.symbol)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i, i, ctypes.c_float,
                       i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _check_rows(t: torch.Tensor, what: str, op: str):
    if t.device.type != "cuda":
        raise ValueError(f"{op}: {what} lies on {t.device}, the kernel takes "
                         f"CUDA tensors")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: {what} dtype {t.dtype} is not fp32, bf16 or "
                        f"fp16")
    if t.dim() != 4 or min(t.shape) < 1:
        raise ValueError(f"{op}: {what} must be a non-empty [b, np, sq, sk], "
                         f"got {tuple(t.shape)}")
    if t.shape[-1] > MAX_SK:
        raise ValueError(f"{op}: sk = {t.shape[-1]} is above the kernel's "
                         f"maximum of {MAX_SK}; rows this long belong to "
                         f"flash attention")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {what} is not contiguous; make it "
                         f"contiguous where it is produced")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: {what} lies on {t.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def softmax_fwd(x: torch.Tensor, scale: float, mask: Optional[torch.Tensor],
                causal: bool) -> torch.Tensor:
    """Launch the CUDA forward on ``x [b, np, sq, sk]`` with an optional
    bool mask broadcastable to ``[b, 1, sq, sk]``; returns ``y`` like ``x``.
    Raises on anything the kernel does not take."""
    op = "scaled_softmax_fwd"
    _check_rows(x, "x", op)
    b, h, sq, sk = x.shape
    mask_bs = mask_rs = 0
    if mask is not None:
        if mask.device != x.device:
            raise ValueError(f"{op}: mask lies on {mask.device}, x on "
                             f"{x.device}")
        m = _broadcast_mask(mask, x)
        if m.stride(-1) != 1:
            m = m.contiguous()
        mask = m
        mask_bs, mask_rs = m.stride(0), m.stride(2)
    y = torch.empty_like(x)
    status = _fwd_symbol()(
        x.data_ptr(), None if mask is None else mask.data_ptr(), y.data_ptr(),
        b * h * sq, h, sq, sk, mask_bs, mask_rs, float(scale), int(causal),
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(status, op)
    SCALED_SOFTMAX_FWD.launches += 1
    return y


def softmax_bwd(y: torch.Tensor, dy: torch.Tensor, scale: float,
                causal: bool = False) -> torch.Tensor:
    """Launch the CUDA backward on the forward's ``y`` and ``dy``, both
    ``[b, np, sq, sk]`` of one dtype; returns ``dx`` like ``dy``.
    ``causal`` says that ``y`` came from a causal forward, whose rows hold
    one value past their edge: the kernel then reads y and dy only up to
    the edge where that value is 0."""
    op = "scaled_softmax_bwd"
    _check_rows(dy, "dy", op)
    _check_rows(y, "y", op)
    if y.shape != dy.shape or y.dtype != dy.dtype or y.device != dy.device:
        raise ValueError(f"{op}: y {y.dtype} {tuple(y.shape)} on {y.device} "
                         f"against dy {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device}")
    dx = torch.empty_like(dy)
    status = _bwd_symbol()(
        y.data_ptr(), dy.data_ptr(), dx.data_ptr(), y.numel() // y.shape[-1],
        y.shape[-2], y.shape[-1], float(scale), int(causal),
        _DTYPE_CODES[dy.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(status, op)
    SCALED_SOFTMAX_BWD.launches += 1
    return dx


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _forward(x, mask, scale, causal):
    if x.dim() != 4:
        raise ValueError(f"scaled softmax: x must be [b, np, sq, sk], got "
                         f"{tuple(x.shape)}")
    if kernel_path(x, mask):
        return softmax_fwd(x, scale, mask, causal)
    return _plain_forward(x, scale, mask, causal)


def _backward(y, dy, scale, causal):
    if kernel_path(y, dy):
        return softmax_bwd(y, dy, scale, causal)
    return _plain_backward(y, dy, scale)


class _SoftmaxFunction(torch.autograd.Function):
    """The softmax under autograd: the forward kernel (or plain version)
    forward, the backward kernel (or plain version) backward; saves ``y``."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        y = _forward(x, mask, scale, causal)
        ctx.scale, ctx.causal = scale, causal
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        # autograd hands over a gradient in whatever layout its producer
        # left; the kernel reads rows
        return (_backward(y, dy.contiguous(), ctx.scale, ctx.causal), None,
                None, None)


def _softmax(x, mask, scale: float, causal: bool):
    if torch.is_grad_enabled() and x.requires_grad:
        return _SoftmaxFunction.apply(x, mask, scale, causal)
    return _forward(x, mask, scale, causal)


# Public API (apex_tpu/ops/softmax.py:197-234) --------------------------------


def scaled_softmax(x, scale: float = 1.0):
    """scale + softmax, no mask (``scaled_softmax_cuda``); x
    ``[b, np, sq, sk]``."""
    return _softmax(x, None, float(scale), False)


def scaled_masked_softmax(x, mask, scale: float = 1.0):
    """Scaled softmax with a boolean mask (True = mask out), ``[b, 1, sq,
    sk]`` or broadcastable; fully masked rows give zeros
    (``scaled_masked_softmax_cuda``)."""
    return _softmax(x, mask.to(torch.bool), float(scale), False)


def scaled_upper_triang_masked_softmax(x, scale: float = 1.0):
    """Causal scaled softmax (``scaled_upper_triang_masked_softmax_cuda``),
    the triangle aligned to the last query: ``col <= row + (sk - sq)``."""
    return _softmax(x, None, float(scale), True)


def scaled_causal_masked_softmax(x, mask, scale: float = 1.0):
    """The causal triangle AND an explicit ``[b, 1, sq, sk]`` padding
    mask (the JAX package's combined path)."""
    return _softmax(x, mask.to(torch.bool), float(scale), True)


def generic_scaled_masked_softmax(x, mask, scale: float = 1.0):
    """Arbitrary-size masked softmax (``generic_scaled_masked_softmax_cuda``):
    the same function as :func:`scaled_masked_softmax`, so the same kernel
    on the card."""
    return _softmax(x, mask.to(torch.bool), float(scale), False)
