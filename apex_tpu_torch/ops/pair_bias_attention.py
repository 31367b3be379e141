"""Pair-bias flash attention, forward and backward: CUDA kernels and their
plain versions.

Counterpart of ``apex_tpu/ops/pair_bias_attention.py``, the Evoformer
attention core with the pair bias and the kv mask in one kernel.  On CUDA
tensors the forward is the hand-written kernel
``csrc/pair_bias_attention_fwd.cu`` (the Pallas ``_fwd_kernel``) and the
backward the three kernels of ``csrc/pair_bias_attention_bwd.cu`` (the
Pallas ``_dq_kernel``, ``_dkv_kernel`` and ``_dbias_kernel``); on CPU
tensors they are :func:`_plain_forward` (whose ``o`` is
:func:`pair_bias_reference`, the JAX ``pair_bias_reference``) and
:func:`_plain_backward`, the math of the JAX ``_pallas_bwd``.  All keep the
JAX semantics:

- q, k, v ``[R, h, s, d]`` with ``R = r * b`` flattening (MSA rows, batch)
  **rows-major**: R index ``t * b + bi``, so the bias of flattened row
  ``R_idx`` is ``bias[R_idx % b]`` (the bias tiles over the rows);
- the pair bias ``[b, h, s, s]``, shared by the ``r`` rows of a batch
  element and differentiable: its gradient sums ``ds`` over those rows;
- an optional kv mask ``[R, s]`` bool (True = attend); masked scores at
  ``-1e30``, and a row with no valid key gives ``o = 0`` and ``lse =
  +inf`` (where a materialized softmax over ``-inf`` would give NaN);
- ``scale`` defaults to 1: OpenFold scales q before the call.

A call that records a gradient goes through :class:`_PairBiasFunction`,
which saves q, k, v, the bias, the mask, o and lse (never the scores); its
backward recomputes the probabilities from lse.

The 16-bit kernels, forward and backward, read q, k, v (the backward do
too) and the bias through TMA maps (:func:`_tma_geometry`,
:func:`_bias_geometry`): q, k and v through maps of their own strides,
which TMA needs to be positive multiples of 16 bytes (an axis of extent 1
excepted).  A broadcast view (a zero stride over more than one element) is
copied first (:func:`_tma_readable`), in the backward too, whose gradients
take the operands' strides; a row, head or R stride that is not whole
16-byte chunks raises, naming the stride.  The backward takes ``do`` as
autograd hands it over and ``o`` as the caller does, with any strides: each
is copied where no map can step over it (:func:`_map_ready`).  The bias
goes through a map of its contiguous ``[b, h, s, s]`` where its rows are
whole 16-byte chunks (``s`` a multiple of 8 in 16 bits, of 4 in fp32), and
by each lane's own loads elsewhere.  The kv mask goes through a map of its
bytes (:func:`_mask_geometry`), a padded copy where its rows are not whole
16-byte chunks (``s`` not a multiple of 16) and all ones where there is no
mask (:func:`_mask_bytes`): a workspace of ``R`` rows of ``s`` rounded up
to 16 bytes, made only then.

One difference from the JAX function, on purpose: where the JAX
``pair_bias_flash_attention`` finds a shape its TPU kernel does not take,
it quietly computes :func:`pair_bias_reference` instead; here a CUDA
tensor always goes to the kernels, which take any ``s``, any ``b`` dividing
``R``, ``d`` a multiple of 8 up to 128 and fp32, bf16 or fp16 (the bias in
any of the three, independently), and raise on anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["pair_bias_flash_attention", "pair_bias_flash_attention_fwd",
           "pair_bias_flash_attention_bwd", "pair_bias_reference",
           "PAIR_BIAS_FWD", "PAIR_BIAS_DQ", "PAIR_BIAS_DKV", "PAIR_BIAS_DBIAS"]

_JAX = "apex_tpu/ops/pair_bias_attention.py"
PAIR_BIAS_FWD = register(Kernel(
    name="pair_bias_attention_fwd", source="pair_bias_attention_fwd.cu",
    symbol="apex_pair_bias_attention_fwd", replaces=f"{_JAX}:85 _fwd_kernel"))
PAIR_BIAS_DQ = register(Kernel(
    name="pair_bias_attention_dq", source="pair_bias_attention_bwd.cu",
    symbol="apex_pair_bias_attention_dq", replaces=f"{_JAX}:140 _dq_kernel"))
PAIR_BIAS_DKV = register(Kernel(
    name="pair_bias_attention_dkv", source="pair_bias_attention_bwd.cu",
    symbol="apex_pair_bias_attention_dkv", replaces=f"{_JAX}:164 _dkv_kernel"))
PAIR_BIAS_DBIAS = register(Kernel(
    name="pair_bias_attention_dbias", source="pair_bias_attention_bwd.cu",
    symbol="apex_pair_bias_attention_dbias",
    replaces=f"{_JAX}:195 _dbias_kernel"))

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 128
# the rows of every box the 16-bit forward's maps read: a warpgroup's
# queries, a key tile, a bias box's rows; and the keys of a tile, the
# bytes of a mask box
_BOX_ROWS = 64
_MASK_BOX = 64


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: fp32, or fp64 for fp64
    input (the CPU's ``gradcheck``)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _check_shapes(q, k, v, bias, mask) -> None:
    """The layout both paths take: q, k, v ``[R, h, s, d]``, bias ``[b, h,
    s, s]`` with ``R % b == 0``, mask ``[R, s]``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"pair_bias_flash_attention: q, k, v must be one "
                         f"[R, h, s, d] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    R, h, s, _ = q.shape
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (h, s, s) \
            or bias.shape[0] < 1 or R % bias.shape[0]:
        raise ValueError(f"pair_bias_flash_attention: bias {tuple(bias.shape)}"
                         f" is not [b, {h}, {s}, {s}] with b dividing R = {R}")
    if mask is not None and tuple(mask.shape) != (R, s):
        raise ValueError(f"pair_bias_flash_attention: mask "
                         f"{tuple(mask.shape)} != ({R}, {s})")


def _scores(q, k, bias, mask, scale):
    """``q kᵀ · scale + bias`` over ``[R, h, s, s]``, masked keys at
    -1e30: the bias tiles over the rows (rows-major R, ``concatenate``,
    not ``repeat``)."""
    r = q.shape[0] // bias.shape[0]
    sc = torch.matmul(_acc(q) * scale, _acc(k).transpose(-1, -2))
    sc = sc + torch.cat([_acc(bias)] * r, dim=0)
    if mask is not None:
        sc = torch.where(mask[:, None, None, :], sc, _NEG_INF)
    return sc


def _plain_forward(q, k, v, bias, mask=None, scale: float = 1.0):
    """``(o, lse)``: the JAX ``pair_bias_reference``'s ``o`` in q's dtype
    and the Pallas forward's ``lse`` (``m + log l`` over the valid keys,
    ``+inf`` on a row with no valid key)."""
    sc = _scores(q, k, bias, mask, scale)
    m = torch.amax(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    if mask is not None:
        p = torch.where(mask[:, None, None, :], p, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    live = l > 0
    safe_l = torch.where(live, l, 1.0)
    p = torch.where(live, p / safe_l, 0.0)
    lse = torch.where(live, m + torch.log(safe_l), torch.inf)[..., 0]
    return torch.matmul(p, _acc(v)).to(q.dtype), lse


def pair_bias_reference(q, k, v, bias, mask=None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Materialized attention with the kernels' semantics (the JAX
    ``pair_bias_reference``): ``[R, h, s, d]`` in q's dtype."""
    _check_shapes(q, k, v, bias, mask)
    return _plain_forward(q, k, v, bias, mask,
                          1.0 if scale is None else float(scale))[0]


def _plain_backward(q, k, v, bias, mask, o, lse, do, scale: float = 1.0):
    """``(dq, dk, dv, dbias)`` with the math of the JAX ``_pallas_bwd``:
    delta = rowsum(do o), p = exp(s - lse) (0 on a masked key and on a row
    with no valid key, whose lse is +inf), ds = p (do vᵀ - delta), dq =
    scale ds k, dk = scale dsᵀ q, dv = pᵀ do, and dbias the sum of ds over
    the r rows that share each bias plane, in the bias's dtype."""
    R, h, s, d = q.shape
    b = bias.shape[0]
    q32, k32, v32, do32 = _acc(q), _acc(k), _acc(v), _acc(do)
    delta = torch.sum(do32 * _acc(o), dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, bias, mask, scale)
                  - lse[..., None].to(q32.dtype))
    ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta)
    dq = scale * torch.matmul(ds, k32)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q32)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dbias = ds.view(R // b, b, h, s, s).sum(0)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dbias.to(bias.dtype))


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _symbol(kernel: Kernel):
    """One of the four entry points; all take one argument list and, after
    it, the geometry of the 16-bit kernels' maps."""
    fn = getattr(_build.library(kernel.source), kernel.symbol)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 13 + [i] * 5 + [vp, ctypes.c_float, i, i, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _padded_head_dim(d: int) -> int:
    """The head dim the 16-bit forward's tiles hold (32, 64 or 128); TMA
    fills the columns past ``d`` with zeros."""
    return 32 if d <= 32 else 64 if d <= 64 else 128


def _tma_geometry(shape, strides, dtype, rows: int = _BOX_ROWS) -> tuple:
    """The rank-4 TMA map of a 16-bit ``[R, h, s, d]`` operand with element
    ``strides``, as ``encode_map`` (``csrc/pair_bias_attention_fwd.cu``)
    takes it: 12 values, the dims ``(d, s, h, R)``, the byte strides of s,
    h and R, the box ``(columns, rows, 1, 1)`` and the swizzle span in
    bytes.  The box is as wide as a swizzle span of the padded head dim (32
    columns, 64 bytes, up to d = 32; else 64 columns, 128 bytes, read twice
    side by side at d > 64), its columns past ``d`` zero-filled.  An axis of
    extent 1 takes the packed stride (TMA steps over none of it); any other
    stride must be a positive multiple of 16 bytes, as TMA requires, or this
    raises naming it."""
    R, h, s, d = shape
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"TMA maps are for bf16 and fp16 operands, not {dtype}")
    if d % 8 or not 8 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not a multiple of 8 up to "
                         f"{_MAX_HEAD_DIM}")
    if strides[3] != 1:
        raise ValueError(f"the last stride must be 1, got strides "
                         f"{tuple(strides)}")
    esize = 2
    byte_strides = []
    packed = d * esize
    for axis, extent, st in (("row", s, strides[2]), ("head", h, strides[1]),
                             ("R", R, strides[0])):
        st = st * esize if extent > 1 else packed
        if st <= 0 or st % 16:
            raise ValueError(
                f"TMA needs strides that are positive multiples of 16 bytes: "
                f"the {axis} stride is {st} bytes (element strides "
                f"{tuple(strides)}, shape {tuple(shape)})")
        byte_strides.append(st)
        packed = st * extent
    span = 64 if _padded_head_dim(d) == 32 else 128
    return (d, s, h, R, *byte_strides, span // esize, rows, 1, 1, span)


def _tma_readable(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where it has a zero stride over more than
    one element (a broadcast): TMA steps over no such dimension."""
    if all(st or n == 1 for n, st in zip(t.shape, t.stride())):
        return t
    return t.contiguous()


def _map_ready(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where a map cannot step over it as it is
    (nor the dq kernel's 16-byte row loads of ``o`` and ``do``): a last
    stride other than 1, a start off 16 bytes, or another stride over more
    than one element that is not a positive multiple of 16 bytes (a
    broadcast's 0 among them).  The backward takes ``do``, which autograd
    hands over with any strides, and ``o`` through it."""
    es = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            n == 1 or (st > 0 and st * es % 16 == 0)
            for n, st in zip(t.shape[:-1], t.stride()[:-1])):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _bias_staged(s: int, dtype) -> bool:
    """True where a bias row of ``s`` values is whole 16-byte chunks, which
    a TMA map can read (and the 16-bit forward stages); elsewhere each lane
    loads its bias values itself."""
    return s * dtype.itemsize % 16 == 0


def _bias_geometry(shape, dtype) -> tuple:
    """The rank-4 map of the contiguous bias ``[b, h, s, s]`` as
    :func:`_tma_geometry` lays it out: dims ``(s, s, h, b)``, boxes of 64
    rows by 128 bytes (64 16-bit or 32 fp32 columns), 128-byte swizzle."""
    b, h, s, _ = shape
    if not _bias_staged(s, dtype):
        raise ValueError(f"a bias row of {s} {dtype} values is not whole "
                         f"16-byte chunks: no TMA map reads it")
    es = dtype.itemsize
    return (s, s, h, b, s * es, s * s * es, h * s * s * es, 128 // es,
            _BOX_ROWS, 1, 1, 128)


def _mask_row_bytes(s: int) -> int:
    """The row stride of the mask bytes the 16-bit kernels read: ``s``
    rounded up to 16 bytes, as TMA requires."""
    return -(-s // 16) * 16


def _mask_geometry(R: int, s: int) -> tuple:
    """The map of the mask bytes ``[R, s]`` in rows of
    :func:`_mask_row_bytes` (as rank 4, two unit axes): dims ``(s, R, 1,
    1)``, boxes of one row of 64 bytes (a key tile), no swizzle; keys past
    ``s`` read as 0, masked."""
    row = _mask_row_bytes(s)
    return (s, R, 1, 1, row, row * R, row * R, _MASK_BOX, 1, 1, 1, 0)


def _mask_bytes(mask, R: int, s: int, device) -> torch.Tensor:
    """The kv mask as the 16-bit kernels' map reads it: ``[R, s]`` bytes
    (nonzero = attend) in rows of :func:`_mask_row_bytes`, starting on 16
    bytes.  ``mask`` (``[R, s]`` bytes) itself where it is laid out so,
    else a padded copy; all ones where there is no mask."""
    row = _mask_row_bytes(s)
    if mask is not None and row == s and mask.data_ptr() % 16 == 0:
        return mask
    out = torch.zeros((R, row), dtype=torch.uint8, device=device)
    out[:, :s] = 1 if mask is None else mask
    return out


@functools.lru_cache(maxsize=64)
def _tma_maps(dtype, parts: tuple, bias_shape: tuple, bias_dtype):
    """A 16-bit kernel's maps as the values of its ``maps`` argument, 12 a
    map: ``parts`` (each ``(shape, strides)``: q, k, v for the forward's 60
    values, and do for the backward's 72), the bias, or zeros where it is
    not staged, and the mask bytes (:func:`_mask_geometry`).  Cached: every
    block of a model passes the same shapes and strides."""
    bias = (_bias_geometry(bias_shape, bias_dtype)
            if _bias_staged(bias_shape[-1], bias_dtype) else (0,) * 12)
    R, _, s, _ = parts[0][0]
    return (ctypes.c_longlong * (12 * (len(parts) + 2)))(
        *(x for shape, strides in parts
          for x in _tma_geometry(shape, strides, dtype)), *bias,
        *_mask_geometry(R, s))


def _check_operand(t: torch.Tensor, what: str, like: torch.Tensor, op: str,
                   laid_out: bool = True):
    """``t`` lies where q does, in its dtype and shape and, where
    ``laid_out``, with a unit last stride, a start on 16 bytes and strides
    that are multiples of 8 elements."""
    if t.device != like.device:
        raise ValueError(f"{op}: {what} lies on {t.device}, q on {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{op}: {what} dtype {t.dtype} != q dtype {like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{op}: {what} must be {tuple(like.shape)}, got "
                         f"{tuple(t.shape)}")
    if not laid_out:
        return
    if t.stride(-1) != 1:
        raise ValueError(f"{op}: {what} must have a unit last stride, got "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
        raise ValueError(f"{op}: {what} must start on 16 bytes with strides "
                         f"that are multiples of 8 elements, got strides "
                         f"{t.stride()}")


def _check_kernel_inputs(q, k, v, bias, mask, op: str):
    """What the four kernels share; returns the mask as ``[R, s]`` bytes
    (or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"{op}: q lies on {q.device}, the kernels take CUDA "
                         f"tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: dtype {q.dtype} is not fp32, bf16 or fp16")
    _check_shapes(q, k, v, bias, mask)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, what, q, op)
    R, h, s, d = q.shape
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"{op}: head dim {d} is not a multiple of 8 up to "
                         f"{_MAX_HEAD_DIM}")
    if bias.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: bias dtype {bias.dtype} is not fp32, bf16 or "
                        f"fp16")
    if bias.device != q.device or not bias.is_contiguous() \
            or bias.data_ptr() % 16:
        raise ValueError(f"{op}: bias must be contiguous on {q.device}, "
                         f"starting on 16 bytes")
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != q.device:
            raise ValueError(f"{op}: mask must be bool on {q.device}, got "
                             f"{mask.dtype} on {mask.device}")
        mask = mask.contiguous().view(torch.uint8)
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: q lies on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return mask


class _Launch:
    """The argument list of the four kernels for one call, with the
    outputs they write: the forward's ``o`` (q's strides) and ``lse``, or
    the backward's ``dq``, ``dk``, ``dv`` (q's, k's and v's strides),
    ``dbias`` (the bias's dtype, contiguous) and ``delta`` (written by dq,
    read by dk/dv and dbias).  :meth:`launch` runs one kernel."""

    def __init__(self, q, k, v, bias, mask, scale, o=None, lse=None, do=None):
        op = "pair_bias_attention_" + ("fwd" if do is None else "bwd")
        mask = _check_kernel_inputs(q, k, v, bias, mask, op)
        # a broadcast operand is copied: the forward's maps cannot step over
        # it, and the backward's gradients take its strides
        q, k, v = (_tma_readable(t) for t in (q, k, v))
        tma = q.dtype != torch.float32
        R, h, s, d = q.shape
        stats = (R, h, s)
        if tma:
            mask = _mask_bytes(mask, R, s, q.device)
        if do is None:
            o = torch.empty_like(q)
            lse = torch.empty(stats, dtype=torch.float32, device=q.device)
            grads = (None,) * 5
        else:
            for t, what in ((o, "o"), (do, "do")):
                _check_operand(t, what, q, op, laid_out=False)
            o, do = _map_ready(o), _map_ready(do)
            if (lse.dtype != torch.float32 or tuple(lse.shape) != stats
                    or not lse.is_contiguous() or lse.device != q.device):
                raise ValueError(f"{op}: lse must be contiguous fp32 {stats} "
                                 f"on {q.device}, got {lse.dtype} "
                                 f"{tuple(lse.shape)}")
            grads = tuple(torch.empty_strided(t.shape, t.stride(),
                                              dtype=t.dtype, device=t.device)
                          for t in (q, k, v)) + (
                torch.empty_like(bias, memory_format=torch.contiguous_format),
                torch.empty(stats, dtype=torch.float32, device=q.device))
        self.o, self.lse = o, lse
        self.dq, self.dk, self.dv, self.dbias, self.delta = grads
        operands = (q, k, v, o, do, self.dq, self.dk, self.dv)
        strides = [st for t in operands
                   for st in (t.stride()[:3] if t is not None else (0, 0, 0))]
        self._strides = (ctypes.c_longlong * 24)(*strides)
        self._maps = None
        if tma:
            self._maps = _tma_maps(
                q.dtype, tuple((tuple(t.shape), t.stride())
                               for t in (q, k, v, do) if t is not None),
                tuple(bias.shape), bias.dtype)
        # the tensors behind the raw pointers below stay alive with the call
        self._keep = (q, k, v, bias, mask, o, lse, do)
        ptr = lambda t: None if t is None else t.data_ptr()
        self._args = (
            ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(o), ptr(lse),
            ptr(do), ptr(self.delta), ptr(self.dq), ptr(self.dk),
            ptr(self.dv), ptr(self.dbias), R, h, s, d, bias.shape[0],
            self._strides, float(scale), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[bias.dtype])

    def launch(self, kernel: Kernel) -> None:
        status = _symbol(kernel)(*self._args,
                                 torch.cuda.current_stream().cuda_stream,
                                 self._maps)
        _build.check(status, kernel.name)
        kernel.launches += 1


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def pair_bias_flash_attention_fwd(q, k, v, bias, mask=None,
                                  scale: Optional[float] = None):
    """``(o, lse)``: ``o [R, h, s, d]`` in q's dtype and ``lse [R, h, s]``
    (``+inf`` on a row with no valid key), no gradient recorded.  The kernel
    for CUDA tensors, the plain version for CPU ones."""
    scale = 1.0 if scale is None else float(scale)
    if kernel_path(q, k, v, bias, mask):
        call = _Launch(q, k, v, bias, mask, scale)
        call.launch(PAIR_BIAS_FWD)
        return call.o, call.lse
    _check_shapes(q, k, v, bias, mask)
    return _plain_forward(q, k, v, bias, mask, scale)


def pair_bias_flash_attention_bwd(q, k, v, bias, o, lse, do, mask=None,
                                  scale: Optional[float] = None):
    """``(dq, dk, dv, dbias)`` for the forward's ``o`` and ``lse`` and the
    upstream ``do`` (like ``o``, with any strides): the
    dq, dk/dv and dbias kernels for CUDA tensors (dq first: it writes the
    delta the other two read), the plain version for CPU ones."""
    scale = 1.0 if scale is None else float(scale)
    if kernel_path(q, k, v, bias, o, lse, do, mask):
        call = _Launch(q, k, v, bias, mask, scale, o=o, lse=lse, do=do)
        for kernel in (PAIR_BIAS_DQ, PAIR_BIAS_DKV, PAIR_BIAS_DBIAS):
            call.launch(kernel)
        return call.dq, call.dk, call.dv, call.dbias
    _check_shapes(q, k, v, bias, mask)
    return _plain_backward(q, k, v, bias, mask, o, lse, do, scale)


class _PairBiasFunction(torch.autograd.Function):
    """The attention under autograd (the JAX ``_flash``'s custom_vjp):
    saves q, k, v, the bias, the mask, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        o, lse = pair_bias_flash_attention_fwd(q, k, v, bias, mask, scale)
        ctx.save_for_backward(q, k, v, bias, mask, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        # do comes with whatever strides autograd gives it (an expanded
        # zero-stride gradient, say): the wrapper copies it where the
        # kernels cannot read it as it is
        q, k, v, bias, mask, o, lse = ctx.saved_tensors
        dq, dk, dv, dbias = pair_bias_flash_attention_bwd(
            q, k, v, bias, o, lse, do, mask, ctx.scale)
        return dq, dk, dv, dbias, None, None


def pair_bias_flash_attention(q, k, v, bias, mask=None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q kᵀ · scale + bias [+ mask]) v`` without materializing
    the scores.

    q, k, v: ``[R, h, s, d]`` with ``R = r * b`` rows-major (see the module
    docstring); OpenFold passes q already scaled, so ``scale`` defaults to
    1.  bias: ``[b, h, s, s]``, differentiable, shared across the rows.
    mask: optional ``[R, s]`` bool kv validity (True = attend).  Returns
    ``[R, h, s, d]`` in q's dtype; a row with no valid key gives zeros.
    Differentiable in q, k, v and the bias."""
    scale = 1.0 if scale is None else float(scale)
    bias = bias.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias)):
        return _PairBiasFunction.apply(q, k, v, bias, mask, scale)
    return pair_bias_flash_attention_fwd(q, k, v, bias, mask, scale)[0]
