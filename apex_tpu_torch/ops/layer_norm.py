"""Fused LayerNorm / RMSNorm, forward and backward: CUDA kernels and their
plain versions.

Counterpart of ``apex_tpu/ops/layer_norm.py``.  On CUDA tensors the
forward is the hand-written kernel ``csrc/layer_norm_fwd.cu`` (the Pallas
``_fwd_kernel``) and the backward ``csrc/layer_norm_bwd.cu`` (the Pallas
``_bwd_kernel``); on CPU tensors they are :func:`_plain_forward` and
:func:`_plain_backward`, the counterparts of ``_jnp_forward`` and the jnp
branch of ``_norm_bwd``.  All keep the mixed-dtype rule: statistics, the
affine step and the gradients run in fp32, ``y`` and ``dx`` are cast back
to ``x.dtype``, ``dw`` and ``db`` to the weight's and bias's dtypes, and
the weight and bias may be fp32, bf16 or fp16 independently of ``x``.

The forward kernel's grid is chosen here, by :func:`fwd_grid`, as the
backward's is by :func:`bwd_grid`: the lanes a row, the 16-byte vectors of
it a lane keeps in registers, the warps a block and the blocks.  A weight
and a bias of two different dtypes are both widened to fp32 before the
forward's launch (exact: the kernel computes in fp32), so its C interface
takes one dtype for the pair.

A call that records a gradient goes through :class:`_NormFunction`, which
saves ``x`` (or, with ``memory_efficient``, the output ``y``, from which
the backward recovers ``xhat = (y - b) / w``) with ``mean`` and ``rstd``,
as the JAX ``_norm_fwd`` does.  A call that records none (under
``no_grad``/``inference_mode``, or on tensors that need no gradient) runs
the forward alone and saves nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["fused_layer_norm", "fused_layer_norm_affine", "fused_rms_norm",
           "fused_rms_norm_affine", "layer_norm_fwd", "layer_norm_bwd",
           "LAYER_NORM_FWD", "LAYER_NORM_BWD"]

LAYER_NORM_FWD = register(Kernel(
    name="layer_norm_fwd", source="layer_norm_fwd.cu",
    symbol="apex_layer_norm_fwd",
    replaces="apex_tpu/ops/layer_norm.py:84 _fwd_kernel"))
LAYER_NORM_BWD = register(Kernel(
    name="layer_norm_bwd", source="layer_norm_bwd.cu",
    symbol="apex_layer_norm_bwd",
    replaces="apex_tpu/ops/layer_norm.py:113 _bwd_kernel"))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# shared memory a block may use on Hopper, an SM's in all, and what the
# card keeps of it for each resident block
_SMEM_MAX = 232448
_SMEM_SM = 233472
_SMEM_BLOCK_RESERVED = 1024
# the forward (csrc/layer_norm_fwd.cu): at most 8 warps a block; the 16-
# byte vectors of a row a lane may keep in registers (64 values), the
# counts instantiated, and the blocks an SM each count's registers allow
# (the kernel's __launch_bounds__, fwd_blocks_per_sm: the current row and
# the next take 8 registers a vector); a CPU test holds both to the source
_FWD_WARPS = 8
_FWD_MAX_VALUES = 64
_FWD_VECS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
_REGS_PER_SM = 65536
# the backward (csrc/layer_norm_bwd.cu): the register form's threads a
# block (kThreads), the vector counts instantiated (up to kMaxVecs), the
# rows each count keeps in shared memory (bwd_stages) and the blocks an SM
# its registers allow (bwd_blocks_per_sm, its __launch_bounds__), its
# static shared memory (the row sums across warps); the streaming form's
# blocks an SM; a CPU test holds them to the source
_BWD_THREADS = 256
_BWD_VECS = (1, 2, 3, 4)
_BWD_STATIC_SMEM = 2 * 8 * 2 * 4
_BWD_STREAM_BLOCKS_PER_SM = 3


def _fwd_blocks_per_sm(vecs: int) -> int:
    return 4 if vecs <= 2 else 3 if vecs <= 4 else 2 if vecs <= 8 else 1


def _bwd_stages(vecs: int) -> int:
    return 2 if vecs >= 3 else 3


def _bwd_blocks_per_sm(vecs: int) -> int:
    return 3 if vecs <= 2 else 2


def _bwd_smem(h: int, threads: int, vecs: int, rows: int, affine: bool,
              bias: bool, memory_efficient: bool) -> int:
    """The register form's dynamic shared memory (``rows_smem`` in the
    source): the weight (and, for ``memory_efficient``, the bias) as fp32,
    then ``_bwd_stages(vecs)`` rows of each thread's ``vecs`` chunks of dy
    and s and its row's mean and rstd; after the rows, the block's column
    sums ``[rows, 1 + bias, h]`` fp32 reuse it."""
    staged = 4 * h * (1 + (memory_efficient and bias)) if affine else 0
    loop = -(-staged // 16) * 16 + _bwd_stages(vecs) * threads * (32 * vecs + 8)
    return max(loop, rows * (1 + bias) * h * 4 if affine else 0)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: fp32, or fp64 for fp64
    input (the CPU's ``gradcheck``)."""
    return t.double() if t.dtype == torch.float64 else t.float()


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _plain_forward(x2d, weight, bias, eps: float, rms_only: bool):
    x32 = _acc(x2d)
    if rms_only:
        mean = torch.zeros(x32.shape[:-1], dtype=x32.dtype,
                           device=x32.device)
        var = torch.mean(x32 * x32, dim=-1)
        xhat = x32 * torch.rsqrt(var + eps)[..., None]
    else:
        mean = torch.mean(x32, dim=-1)
        xc = x32 - mean[..., None]
        var = torch.mean(xc * xc, dim=-1)
        xhat = xc * torch.rsqrt(var + eps)[..., None]
    rstd = torch.rsqrt(var + eps)
    y = xhat
    if weight is not None:
        y = y * _acc(weight)
    if bias is not None:
        y = y + _acc(bias)
    return y.to(x2d.dtype), mean, rstd


def _plain_backward(dy2d, saved, mean, rstd, weight, bias, rms_only: bool,
                    memory_efficient: bool):
    """``(dx, dw, db)`` for ``dy2d [n, h]``: ``saved`` is ``x``, or ``y``
    when ``memory_efficient`` (then ``xhat = (y - b) / w``).  ``dw`` and
    ``db`` are None without a weight or bias."""
    s32 = _acc(saved)
    if memory_efficient:
        xhat = s32
        if weight is not None:
            if bias is not None:
                xhat = xhat - _acc(bias)
            xhat = xhat / _acc(weight)
    elif rms_only:
        xhat = s32 * rstd[:, None]
    else:
        xhat = (s32 - mean[:, None]) * rstd[:, None]
    h = xhat.shape[-1]
    dy32 = _acc(dy2d)
    wdy = dy32 * _acc(weight) if weight is not None else dy32
    c2 = torch.sum(wdy * xhat, dim=-1, keepdim=True) / h
    if rms_only:
        dx = (wdy - xhat * c2) * rstd[:, None]
    else:
        c1 = torch.sum(wdy, dim=-1, keepdim=True) / h
        dx = (wdy - c1 - xhat * c2) * rstd[:, None]
    dw = (torch.sum(dy32 * xhat, dim=0).to(weight.dtype)
          if weight is not None else None)
    db = torch.sum(dy32, dim=0).to(bias.dtype) if bias is not None else None
    return dx.to(dy2d.dtype), dw, db


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _symbol():
    fn = getattr(_build.library(LAYER_NORM_FWD.source), LAYER_NORM_FWD.symbol)
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float] + [ctypes.c_int] * 7 + [vp]
        fn.restype = ctypes.c_int
    return fn


def _bwd_symbol():
    fn = getattr(_build.library(LAYER_NORM_BWD.source), LAYER_NORM_BWD.symbol)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 10 + [ctypes.c_longlong] + [i] * 11 + [vp]
        fn.restype = ctypes.c_int
    return fn


def _bwd_rows_grid(n: int, h: int, lanes: int, wn: int, vecs: int,
                   affine: bool, bias: bool, memory_efficient: bool,
                   sms: int):
    """``(warps, blocks)`` of the register form for rows of ``lanes`` x
    ``wn`` threads, ``vecs`` vectors each (see :func:`bwd_grid`)."""
    per_warp = 32 // lanes
    groups = math.ceil(n / per_warp)          # row groups of wn warps
    per_block = _BWD_THREADS // 32 // wn      # row groups a block
    while per_block > 1 and math.ceil(groups / per_block) < sms:
        per_block //= 2
    warps = per_block * wn
    smem = _bwd_smem(h, 32 * warps, vecs, per_block * per_warp, affine, bias,
                     memory_efficient)
    per_sm = min(_bwd_blocks_per_sm(vecs), _SMEM_SM // (
        smem + _BWD_STATIC_SMEM + _SMEM_BLOCK_RESERVED))
    strides = math.ceil(groups / per_block)      # a block's rows at once
    rounds = math.ceil(strides / min(strides, per_sm * sms))
    return warps, math.ceil(strides / rounds)


def bwd_grid(n: int, h: int, dtype: torch.dtype, affine: bool, bias: bool,
             memory_efficient: bool, aligned: bool, sms: int):
    """``(lanes, wn, vecs, warps, blocks)`` of the backward for ``dy [n,
    h]`` of ``dtype``.

    The register form (``vecs`` 1-4): a row to ``lanes`` x ``wn`` threads:
    ``lanes`` 8 for a row of up to 8 vectors, 16 up to 32 (OpenFold's h
    128 and 256 in 16 bits: two rows a warp, 1 or 2 vectors a thread), 32
    beyond, and ``wn`` warps where a row is longer than 32 lanes x 4
    vectors (Llama's h 2048 and GPT-2-large's h 1280: two), each thread
    ``vecs`` 16-byte vectors of it (the least instantiated count that
    covers the row); ``warps`` a block: the most (up to 8) that still give
    every SM a block; ``blocks``: no more than the registers and shared
    memory let be resident at once, each striding over the rows, and as
    few as take the same number of strides, so that no block walks one
    stride more than the others.  It takes whole, 16-byte aligned vectors
    (``aligned``: dy and the saved input) of rows up to 256 threads x 4
    vectors.

    Otherwise the streaming form (``vecs`` 0, a warp a row): with a weight
    each warp keeps fp32 column sums of ``(1 + bias) h`` floats in shared
    memory, so the most warps (up to 4) whose sums leave room for three
    blocks an SM, and three blocks an SM; without, 8 warps and a block per
    8 rows.  Raises for an ``h`` whose sums do not fit."""
    per_vec = 16 // dtype.itemsize
    nvec = h // per_vec
    max_vecs = _BWD_VECS[-1]
    if aligned and h % per_vec == 0 and nvec <= _BWD_THREADS * max_vecs:
        lanes = 8 if nvec <= 8 else 16 if nvec <= 32 else 32
        wn = 1
        while lanes * wn * max_vecs < nvec:
            wn *= 2
        vecs = next(v for v in _BWD_VECS if lanes * wn * v >= nvec)
        return (lanes, wn, vecs) + _bwd_rows_grid(
            n, h, lanes, wn, vecs, affine, bias, memory_efficient, sms)
    if not affine:
        return 32, 1, 0, 8, math.ceil(n / 8)
    per_warp = (1 + bias) * h * 4
    if per_warp > _SMEM_MAX:
        raise ValueError(f"layer_norm_bwd: h = {h} needs {per_warp} bytes of "
                         f"shared memory for one warp's column sums; the "
                         f"card has {_SMEM_MAX}")
    warps = 4
    while warps > 1 and warps * per_warp > _SMEM_MAX // _BWD_STREAM_BLOCKS_PER_SM:
        warps //= 2
    return 32, 1, 0, warps, max(1, min(math.ceil(n / warps),
                                       _BWD_STREAM_BLOCKS_PER_SM * sms))


def fwd_grid(n: int, h: int, dtype: torch.dtype, sms: int):
    """``(lanes, vecs, warps, blocks)`` of the forward for ``x [n, h]`` of
    ``dtype``: a row to a group of ``lanes`` lanes (8, 16 or 32, the fewest
    that keep a lane at 4 vectors or under, so several short rows share a
    warp), ``vecs`` 16-byte vectors of it a lane in registers (the least
    instantiated count that covers the row), ``warps`` a block and
    ``blocks``: the most warps (up to 8) that still give every SM a block,
    and no more blocks than the registers let be resident at once, each
    warp striding over its rows.  ``vecs`` 0 is the streaming kernel: rows
    longer than 64 values a lane, or an ``h`` that is not whole vectors."""
    per_vec = 16 // dtype.itemsize
    nvec = h // per_vec
    lanes, vecs = 32, 0
    if h % per_vec == 0 and nvec <= 32 * (_FWD_MAX_VALUES // per_vec):
        lanes = 8 if nvec <= 32 else 16 if nvec <= 64 else 32
        vecs = next(v for v in _FWD_VECS if v * lanes >= nvec)
    per_sm = _fwd_blocks_per_sm(vecs) if vecs else 2
    warps_needed = math.ceil(n / (32 // lanes))
    warps = _FWD_WARPS
    while warps > 1 and math.ceil(warps_needed / warps) < sms:
        warps //= 2
    blocks = max(1, min(math.ceil(warps_needed / warps), per_sm * sms))
    return lanes, vecs, warps, blocks


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_operand(t: torch.Tensor, what: str, h: Optional[int] = None,
                   op: str = "layer_norm_fwd"):
    if t.device.type != "cuda":
        raise ValueError(f"{op}: {what} lies on {t.device}, "
                         f"the kernel takes CUDA tensors")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: {what} dtype {t.dtype} is not "
                        f"fp32, bf16 or fp16")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {what} is not contiguous; make "
                         f"it contiguous where it is produced")
    if h is not None and tuple(t.shape) != (h,):
        raise ValueError(f"{op}: {what} shape {tuple(t.shape)} "
                         f"!= ({h},)")


def layer_norm_fwd(x2d: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float,
                   rms_only: bool):
    """Launch the CUDA kernel on ``x2d [n, h]``; returns ``(y, mean,
    rstd)``.  Raises on anything the kernel does not take: a tensor off
    CUDA or on another card, a dtype other than fp32/bf16/fp16, a
    non-contiguous input, a bias without a weight, an empty input."""
    _check_operand(x2d, "x")
    if x2d.dim() != 2 or x2d.shape[0] < 1 or x2d.shape[1] < 1:
        raise ValueError(f"layer_norm_fwd: x must be [n>=1, h>=1], got "
                         f"{tuple(x2d.shape)}")
    n, h = x2d.shape
    if bias is not None and weight is None:
        raise ValueError("layer_norm_fwd: a bias needs a weight")
    for t, what in ((weight, "weight"), (bias, "bias")):
        if t is not None:
            _check_operand(t, what, h)
            if t.device != x2d.device:
                raise ValueError(f"layer_norm_fwd: {what} on {t.device}, "
                                 f"x on {x2d.device}")
    if x2d.device.index != torch.cuda.current_device():
        raise ValueError(f"layer_norm_fwd: x lies on {x2d.device}, the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    if bias is not None and bias.dtype != weight.dtype:
        weight, bias = weight.float(), bias.float()
    lanes, vecs, warps, blocks = fwd_grid(n, h, x2d.dtype,
                                          _sm_count(x2d.device.index))
    y = torch.empty_like(x2d)
    mean = torch.empty((n,), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x2d.device)
    status = _symbol()(
        x2d.data_ptr(), None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), n, h, float(eps), int(rms_only),
        _DTYPE_CODES[x2d.dtype],
        -1 if weight is None else _DTYPE_CODES[weight.dtype],
        lanes, vecs, warps, blocks, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "layer_norm_fwd")
    LAYER_NORM_FWD.launches += 1
    return y, mean, rstd


def layer_norm_bwd(dy2d: torch.Tensor, saved: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor,
                   weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                   rms_only: bool, memory_efficient: bool):
    """Launch the CUDA backward on ``dy2d [n, h]`` and the saved ``x`` (or
    ``y`` when ``memory_efficient``) of the same shape and dtype, with the
    forward's fp32 ``mean`` and ``rstd [n]``; returns ``(dx, dw, db)``,
    ``dw``/``db`` None without a weight/bias.  Raises on anything the
    kernel does not take, as :func:`layer_norm_fwd` does."""
    op = "layer_norm_bwd"
    _check_operand(dy2d, "dy", op=op)
    if dy2d.dim() != 2 or dy2d.shape[0] < 1 or dy2d.shape[1] < 1:
        raise ValueError(f"{op}: dy must be [n>=1, h>=1], got "
                         f"{tuple(dy2d.shape)}")
    n, h = dy2d.shape
    _check_operand(saved, "saved input", op=op)
    if saved.shape != dy2d.shape or saved.dtype != dy2d.dtype:
        raise ValueError(f"{op}: saved input {saved.dtype} "
                         f"{tuple(saved.shape)} against dy {dy2d.dtype} "
                         f"{tuple(dy2d.shape)}")
    for t, what in ((mean, "mean"), (rstd, "rstd")):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{op}: {what} must be contiguous fp32 ({n},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if bias is not None and weight is None:
        raise ValueError(f"{op}: a bias needs a weight")
    for t, what in ((saved, "saved input"), (mean, "mean"), (rstd, "rstd"),
                    (weight, "weight"), (bias, "bias")):
        if t is not None:
            if t is weight or t is bias:
                _check_operand(t, what, h, op=op)
            if t.device != dy2d.device:
                raise ValueError(f"{op}: {what} on {t.device}, dy on "
                                 f"{dy2d.device}")
    if dy2d.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: dy lies on {dy2d.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    aligned = dy2d.data_ptr() % 16 == 0 and saved.data_ptr() % 16 == 0
    lanes, wn, vecs, warps, blocks = bwd_grid(
        n, h, dy2d.dtype, weight is not None, bias is not None,
        memory_efficient, aligned, _sm_count(dy2d.device.index))
    dx = torch.empty_like(dy2d)
    dw = torch.empty_like(weight) if weight is not None else None
    db = torch.empty_like(bias) if bias is not None else None
    part = (torch.empty((blocks, 1 + (bias is not None), h),
                        dtype=torch.float32, device=dy2d.device)
            if weight is not None else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    status = _bwd_symbol()(
        dy2d.data_ptr(), saved.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        ptr(weight), ptr(bias), dx.data_ptr(), ptr(dw), ptr(db), ptr(part),
        n, h, int(rms_only), int(memory_efficient), _DTYPE_CODES[dy2d.dtype],
        -1 if weight is None else _DTYPE_CODES[weight.dtype],
        -1 if bias is None else _DTYPE_CODES[bias.dtype], lanes, wn, vecs,
        warps, blocks, torch.cuda.current_stream().cuda_stream)
    _build.check(status, op)
    LAYER_NORM_BWD.launches += 1
    return dx, dw, db


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _norm_forward(x, weight, bias, eps: float, rms_only: bool):
    """``(y, mean, rstd)`` over the last dim of ``x``; the kernel for a
    CUDA ``x``, the plain version for a CPU one."""
    h = x.shape[-1]
    if kernel_path(x, weight, bias):
        if not x.is_contiguous():
            raise ValueError("layer_norm_fwd: x is not contiguous; make it "
                             "contiguous where it is produced")
        y2d, mean, rstd = layer_norm_fwd(x.view(-1, h), weight, bias, eps,
                                         rms_only)
    else:
        y2d, mean, rstd = _plain_forward(x.reshape(-1, h), weight, bias, eps,
                                         rms_only)
    return y2d.view(x.shape), mean, rstd


def _norm_backward(dy, saved, mean, rstd, weight, bias, rms_only: bool,
                   memory_efficient: bool):
    """``(dx, dw, db)`` for ``dy`` shaped like the forward's ``x``; the
    kernel for CUDA tensors, the plain version for CPU ones."""
    h = dy.shape[-1]
    if kernel_path(dy, saved, weight, bias):
        dx, dw, db = layer_norm_bwd(dy.reshape(-1, h), saved.view(-1, h),
                                    mean, rstd, weight, bias, rms_only,
                                    memory_efficient)
    else:
        dx, dw, db = _plain_backward(dy.reshape(-1, h), saved.reshape(-1, h),
                                     mean, rstd, weight, bias, rms_only,
                                     memory_efficient)
    return dx.view(dy.shape), dw, db


class _NormFunction(torch.autograd.Function):
    """The norm under autograd: the forward kernel (or plain version)
    forward, the backward kernel (or plain version) backward.  Saves ``x``,
    or ``y`` when ``memory_efficient``, with ``mean`` and ``rstd``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rms_only, memory_efficient):
        y, mean, rstd = _norm_forward(x, weight, bias, eps, rms_only)
        ctx.rms_only, ctx.memory_efficient = rms_only, memory_efficient
        ctx.save_for_backward(y if memory_efficient else x, mean, rstd,
                              weight, bias)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved, mean, rstd, weight, bias = ctx.saved_tensors
        # autograd hands over a gradient in whatever layout its producer
        # left; the kernel reads rows
        dx, dw, db = _norm_backward(dy.contiguous(), saved, mean, rstd,
                                    weight, bias, ctx.rms_only,
                                    ctx.memory_efficient)
        return dx, dw, db, None, None, None


def _norm(x, weight, bias, eps, rms_only, memory_efficient):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _NormFunction.apply(x, weight, bias, eps, rms_only,
                                   memory_efficient)
    return _norm_forward(x, weight, bias, eps, rms_only)[0]


# Public functional API (apex.normalization functional forms,
# apex_tpu/ops/layer_norm.py:326-359).


def fused_layer_norm(x, normalized_shape, eps: float = 1e-5, *,
                     memory_efficient: bool = False):
    _check_shape(x, normalized_shape)
    h = _numel(normalized_shape)
    y = _norm(_flat(x, normalized_shape, h), None, None, eps,
              False, memory_efficient)
    return y.reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape,
                            eps: float = 1e-5, *,
                            memory_efficient: bool = False):
    _check_shape(x, normalized_shape)
    h = _numel(normalized_shape)
    y = _norm(_flat(x, normalized_shape, h), weight.reshape(h),
              bias.reshape(h), eps, False, memory_efficient)
    return y.reshape(x.shape)


def fused_rms_norm(x, normalized_shape, eps: float = 1e-5, *,
                   memory_efficient: bool = False):
    _check_shape(x, normalized_shape)
    h = _numel(normalized_shape)
    y = _norm(_flat(x, normalized_shape, h), None, None, eps,
              True, memory_efficient)
    return y.reshape(x.shape)


def fused_rms_norm_affine(x, weight, normalized_shape, eps: float = 1e-5, *,
                          memory_efficient: bool = False):
    _check_shape(x, normalized_shape)
    h = _numel(normalized_shape)
    y = _norm(_flat(x, normalized_shape, h), weight.reshape(h),
              None, eps, True, memory_efficient)
    return y.reshape(x.shape)


def _numel(shape) -> int:
    out = 1
    for s in tuple(shape):
        out *= int(s)
    return out


def _flat(x, normalized_shape, h: int):
    """``x`` as ``[..., h]``: a view on CUDA (the kernel never copies its
    input quietly), a reshape on the CPU."""
    nd = len(tuple(normalized_shape))
    shape = (*x.shape[: x.dim() - nd], h)
    return x.view(shape) if x.is_cuda else x.reshape(shape)


def _check_shape(x, normalized_shape):
    ns = tuple(int(s) for s in tuple(normalized_shape))
    if tuple(x.shape[x.dim() - len(ns):]) != ns:
        raise ValueError(
            f"input trailing shape {tuple(x.shape[x.dim() - len(ns):])} != "
            f"normalized_shape {ns}")
