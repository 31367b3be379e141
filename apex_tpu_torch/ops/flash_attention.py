"""Flash attention, forward and backward: CUDA kernels and their plain
versions.

Counterpart of ``apex_tpu/ops/flash_attention.py``.  On CUDA tensors the
forward is the hand-written kernel ``csrc/flash_attention_fwd.cu`` (the
Pallas ``_fwd_kernel``) and the backward the two kernels of
``csrc/flash_attention_bwd.cu`` (the Pallas ``_dq_kernel`` and
``_dkv_kernel``); for bf16 and fp16 all three read their operands through
TMA maps (:func:`_tma_geometry`) and run their products on ``wgmma``
(``csrc/flash_sm90.cuh``), fp32 on CUDA cores.  On CPU tensors they are
:func:`_plain_forward` (whose ``o`` is :func:`mha_reference`, the
counterpart of the JAX ``mha_reference``) and :func:`_plain_backward`, the
math of the JAX ``_pallas_bwd``, with :func:`_fmix32` / :func:`_hash_keep`
carried over bit for bit.  All keep the JAX semantics:

- layout ``[b, h, sq, d]`` for q and ``[b, hk, sk, d]`` for k and v;
- causal masking aligned to the last query (``col <= row + (sk - sq)``);
- segment ids, one ``[b, s]`` tensor or a ``(q_seg, kv_seg)`` pair:
  query ``i`` attends key ``j`` iff their ids are equal;
- masked scores at ``-1e30``; a fully-masked row gives ``o = 0`` and
  ``lse = +inf``;
- dropout on the normalised probabilities, kept values scaled by
  ``1 / (1 - rate)``, the keep bit a counter hash of ``(seed, b * h +
  head, qpos, kpos)`` that regenerates the JAX bits exactly; the softmax
  denominator sums the undropped probabilities.

Grouped-query attention: k and v may carry fewer heads than q
(``h % hk == 0``); query head ``i`` then reads kv head ``i // (h / hk)``,
which is what repeating each kv head ``h / hk`` times (the JAX model's
``jnp.repeat``) computes, without the copy.

A call that records a gradient goes through :class:`_FlashFunction`,
which saves q, k, v, o, lse and the seed (never the scores); its backward
recomputes the probabilities from lse.  A call that records none runs the
forward alone and saves nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "mha_reference", "FLASH_ATTENTION_FWD", "FLASH_ATTENTION_DQ",
           "FLASH_ATTENTION_DKV"]

FLASH_ATTENTION_FWD = register(Kernel(
    name="flash_attention_fwd", source="flash_attention_fwd.cu",
    symbol="apex_flash_attention_fwd",
    replaces="apex_tpu/ops/flash_attention.py:191 _fwd_kernel"))
FLASH_ATTENTION_DQ = register(Kernel(
    name="flash_attention_dq", source="flash_attention_bwd.cu",
    symbol="apex_flash_attention_dq",
    replaces="apex_tpu/ops/flash_attention.py:323 _dq_kernel"))
FLASH_ATTENTION_DKV = register(Kernel(
    name="flash_attention_dkv", source="flash_attention_bwd.cu",
    symbol="apex_flash_attention_dkv",
    replaces="apex_tpu/ops/flash_attention.py:367 _dkv_kernel"))

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128)
# the 16-bit kernels' tiles (csrc/flash_attention_{fwd,bwd}.cu): a block
# owns kBlockRows rows (queries for the forward and dq, keys for dk/dv),
# the other operands stream in tiles of kTileRows rows
_BLOCK_ROWS = 128
_TILE_ROWS = 64


# ---------------------------------------------------------------------------
# the counter hash, in int64 arithmetic kept to 32 bits
# ---------------------------------------------------------------------------


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in ``[0, 2**32)``: the constant
    is split in 16-bit halves so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _seed_bits(seed) -> int:
    """An int (or int32) seed as the uint32 the JAX kernels hash: a
    negative int32 wraps, as ``jnp.asarray(seed, uint32)`` does."""
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    return int(seed) & _MASK32


def _threshold(rate: float) -> int:
    """``P(h < T) = rate`` for a uniform uint32 ``h``."""
    return min(int(rate * 4294967296.0), 4294967295)


def _hash_keep(seed: int, g, qpos, kpos, rate: float) -> torch.Tensor:
    """The keep bit for coordinates ``(g, qpos, kpos)`` (broadcasting int64
    tensors of values in ``[0, 2**32)``): ``fmix(fmix(fmix(seed ^ qpos) ^
    kpos) ^ g) >= rate * 2**32``, as the JAX ``_hash_keep``."""
    h = _fmix32(_seed_bits(seed) ^ qpos)
    h = _fmix32(h ^ kpos)
    h = _fmix32(h ^ g)
    return h >= _threshold(rate)


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: fp32, or fp64 for fp64
    input (the CPU's ``gradcheck``)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _split_segments(segment_ids):
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        return segment_ids[0], segment_ids[1]
    return segment_ids, segment_ids


def _plain_forward(q, k, v, *, causal=False, q_segment_ids=None,
                   kv_segment_ids=None, scale=None, dropout_rate=0.0,
                   dropout_seed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` with the semantics of the JAX ``mha_reference`` (whose
    ``o`` it returns) and the Pallas forward's ``lse``: ``m + log(l)`` over
    the valid keys, ``+inf`` on a fully-masked row."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if hk != h:
        rep = h // hk
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s = torch.matmul(_acc(q) * scale, _acc(k).transpose(-1, -2))
    valid = _valid(q.device, sq, sk, causal, q_segment_ids, kv_segment_ids)
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / l
    lse = (m + torch.log(l))[..., 0]
    if valid is not None:
        any_valid = torch.any(valid, dim=-1, keepdim=True)
        p = torch.where(any_valid, p, 0.0)
        lse = torch.where(any_valid[..., 0], lse, torch.inf)
    if dropout_rate > 0.0:
        keep = _keep(q.device, b, h, sq, sk, dropout_seed, dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(p, _acc(v))
    return out.to(q.dtype), lse


def _valid(device, sq, sk, causal, q_segment_ids, kv_segment_ids):
    """The ``[b | 1, 1, sq, sk]`` bool mask of visible (query, key) pairs,
    or None when every pair is visible."""
    valid = None
    if causal:
        row = torch.arange(sq, device=device)[:, None]
        col = torch.arange(sk, device=device)[None, :]
        valid = (col <= row + (sk - sq))[None, None]
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, None, :, None]
               == kv_segment_ids[:, None, None, :])
        valid = seg if valid is None else valid & seg
    return valid


def _keep(device, b, h, sq, sk, seed, rate):
    """The dropout keep bits ``[b, h, sq, sk]`` of the counter hash."""
    g = torch.arange(b * h, dtype=torch.int64, device=device).view(b, h, 1, 1)
    qpos = torch.arange(sq, dtype=torch.int64, device=device).view(1, 1, sq, 1)
    kpos = torch.arange(sk, dtype=torch.int64, device=device).view(1, 1, 1, sk)
    return _hash_keep(seed, g, qpos, kpos, rate)


def _plain_backward(q, k, v, o, lse, do, *, causal=False, q_segment_ids=None,
                    kv_segment_ids=None, scale=None, dropout_rate=0.0,
                    dropout_seed=None):
    """``(dq, dk, dv)`` with the math of the JAX ``_pallas_bwd``: delta =
    rowsum(do o), p = exp(s scale - lse) (0 on a dead row, whose lse is
    +inf), dv = p_kept^T do, ds = p (dp_kept - delta), dq = scale ds k,
    dk = scale ds^T q; a kv head's dk and dv sum its query group."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = (1.0 / d ** 0.5) if scale is None else scale
    q32, do32 = _acc(q), _acc(do)
    k32 = _acc(k).repeat_interleave(rep, dim=1)
    v32 = _acc(v).repeat_interleave(rep, dim=1)
    delta = torch.sum(do32 * _acc(o), dim=-1, keepdim=True)
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    valid = _valid(q.device, sq, sk, causal, q_segment_ids, kv_segment_ids)
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    p = torch.exp(s - lse[..., None].to(s.dtype))
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    p_kept = p
    if dropout_rate > 0.0:
        keep = _keep(q.device, b, h, sq, sk, dropout_seed, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        p_kept = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = p * (dp - delta)
    dq = scale * torch.matmul(ds, k32)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q32)
    dv = torch.matmul(p_kept.transpose(-1, -2), do32)
    dk = dk.view(b, hk, rep, sk, d).sum(2)
    dv = dv.view(b, hk, rep, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_reference(q, k, v, *, causal=False, q_segment_ids=None,
                  kv_segment_ids=None, scale=None, dropout_rate=0.0,
                  dropout_seed=None):
    """Materialized attention with the flash kernel's masking semantics
    (the JAX ``mha_reference``): ``[b, h, sq, d]`` in q's dtype."""
    return _plain_forward(q, k, v, causal=causal,
                          q_segment_ids=q_segment_ids,
                          kv_segment_ids=kv_segment_ids, scale=scale,
                          dropout_rate=dropout_rate,
                          dropout_seed=dropout_seed)[0]


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _symbol():
    fn = getattr(_build.library(FLASH_ATTENTION_FWD.source),
                 FLASH_ATTENTION_FWD.symbol)
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([vp] * 7 + [i] * 6 + [ll] * 12 + [vp]
                       + [ctypes.c_float, i, i, ctypes.c_uint, ctypes.c_uint,
                          ctypes.c_float, i, vp])
        fn.restype = ctypes.c_int
    return fn


def _bwd_symbol(kernel: Kernel):
    """The dq or dk/dv entry point; both take one argument list."""
    fn = getattr(_build.library(kernel.source), kernel.symbol)
    if fn.argtypes is None:
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = ([vp] * 12 + [i] * 6 + [vp, vp]
                       + [ctypes.c_float, i, i, u, u, ctypes.c_float, i, vp])
        fn.restype = ctypes.c_int
    return fn


def _tma_geometry(shape, strides, dtype, rows: int) -> tuple:
    """The rank-4 TMA map of a 16-bit ``[b, heads, s, d]`` operand with
    element ``strides``, read in boxes of ``rows`` rows, as the 16-bit
    kernels' ``flash_tensor_map`` (``csrc/flash_sm90.cuh``) takes it: 12
    values, the dims ``(d, s, heads, b)``, the byte strides of s, heads and
    b, the box ``(columns, rows, 1, 1)`` and the swizzle span in bytes.  A
    box row is one swizzle span: 64 columns (128 bytes) for d = 64 and 128
    (which reads two boxes side by side), 32 (64 bytes) for d = 32.  A
    dimension of extent 1 takes the packed stride (TMA steps over none of
    it); any other stride must be a positive multiple of 16 bytes, as TMA
    requires, or this raises."""
    b, n, s, d = shape
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"TMA maps are for bf16 and fp16 operands, not {dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {_HEAD_DIMS}")
    if strides[3] != 1:
        raise ValueError(f"the last stride must be 1, got strides {tuple(strides)}")
    esize = 2
    byte_strides = []
    packed = d * esize
    for extent, st in ((s, strides[2]), (n, strides[1]), (b, strides[0])):
        st = st * esize if extent > 1 else packed
        if st <= 0 or st % 16:
            raise ValueError(f"TMA needs strides that are positive multiples of 16 "
                             f"bytes, got element strides {tuple(strides)} for "
                             f"shape {tuple(shape)}")
        byte_strides.append(st)
        packed = st * extent
    row_bytes = min(d * esize, 128)
    return (d, s, n, b, *byte_strides, row_bytes // esize, rows, 1, 1, row_bytes)


@functools.lru_cache(maxsize=64)
def _tma_maps(dtype, parts: tuple):
    """One kernel's maps, ``parts`` a tuple of ``(shape, strides, rows)``
    (three for the forward, four for each backward kernel), as the 12
    values a map of its C argument.  Cached: every layer of a model passes
    the same shapes and strides, so the geometry is worked out once and not
    on every call of a training step."""
    return (ctypes.c_longlong * (12 * len(parts)))(
        *(x for shape, strides, rows in parts
          for x in _tma_geometry(shape, strides, dtype, rows)))


def _tma_part(t: torch.Tensor, rows: int) -> tuple:
    """``(shape, strides, rows)`` of one operand, as :func:`_tma_maps`
    takes it."""
    return tuple(t.shape), t.stride(), rows


def _tma_readable(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where it has a zero stride over more than
    one element (a broadcast): TMA steps over no such dimension."""
    if all(st or n == 1 for n, st in zip(t.shape, t.stride())):
        return t
    return t.contiguous()


def _check_operand(t: torch.Tensor, what: str, dtype, device,
                   op: str = "flash_attention_fwd"):
    if t.device != device:
        raise ValueError(f"{op}: {what} lies on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {what} dtype {t.dtype} != q dtype {dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"{op}: {what} must be 4-d with a unit last stride, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
        raise ValueError(f"{op}: {what} must start on 16 bytes with strides "
                         f"that are multiples of 8 elements, got strides "
                         f"{t.stride()}")


def _check_segments(seg, b: int, s: int, what: str, device, op: str):
    if tuple(seg.shape) != (b, s):
        raise ValueError(f"{op}: {what} shape {tuple(seg.shape)} != ({b}, {s})")
    if seg.device != device:
        raise ValueError(f"{op}: {what} lies on {seg.device}, q on {device}")


def _check_qkv(q, k, v, qseg, kseg, op: str):
    """The checks of dtype, shape and layout the forward and backward
    kernels share (the device comes after, in :func:`_check_device`, so
    that these raise on any host); returns the segment ids as contiguous
    int32 (or None)."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: dtype {q.dtype} is not fp32, bf16 or fp16")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, what, q.dtype, q.device, op)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"{op}: head dim {d} is not one of {_HEAD_DIMS}")
    if (k.shape[0], k.shape[3]) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{op}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not agree")
    if hk < 1 or h % hk:
        raise ValueError(f"{op}: {h} query heads over {hk} kv heads")
    if min(b, h, sq, sk) < 1:
        raise ValueError(f"{op}: empty input, q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if (qseg is None) != (kseg is None):
        raise ValueError(f"{op}: give both segment-id tensors or neither")
    if qseg is not None:
        # ids of any integer dtype; the kernels read int32
        qseg = qseg.to(torch.int32).contiguous()
        kseg = kseg.to(torch.int32).contiguous()
        _check_segments(qseg, b, sq, "q_segment_ids", q.device, op)
        _check_segments(kseg, b, sk, "kv_segment_ids", q.device, op)
    return qseg, kseg


def _check_device(q, op: str):
    """Raise unless q lies on the current CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"{op}: q lies on {q.device}, the kernels take CUDA "
                         f"tensors")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: q lies on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _kernel_forward(q, k, v, qseg, kseg, causal: bool, scale: float,
                    dropout_rate: float, dropout_seed):
    """Launch the CUDA kernel; returns ``(o, lse)``.  ``o`` has q's
    strides, ``lse`` is a contiguous ``[b, h, sq]`` fp32 tensor.  Raises
    on anything the kernel does not take: for bf16 and fp16, also on a
    layout its TMA maps cannot read (:func:`_tma_geometry`), on any host."""
    op = "flash_attention_fwd"
    qseg, kseg = _check_qkv(q, k, v, qseg, kseg, op)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    maps = None
    if q.dtype != torch.float32:
        q, k, v = (_tma_readable(t) for t in (q, k, v))
        maps = _tma_maps(q.dtype, (_tma_part(q, _BLOCK_ROWS),
                                   _tma_part(k, _TILE_ROWS),
                                   _tma_part(v, _TILE_ROWS)))
    _check_device(q, op)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    seed = 0 if dropout_seed is None else _seed_bits(dropout_seed)
    status = _symbol()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(),
        None if qseg is None else qseg.data_ptr(),
        None if kseg is None else kseg.data_ptr(),
        b, h, hk, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        maps, float(scale), int(causal), int(dropout_rate > 0.0), seed,
        _threshold(dropout_rate), float(1.0 / (1.0 - dropout_rate)),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(status, "flash_attention_fwd")
    FLASH_ATTENTION_FWD.launches += 1
    return o, lse


def _empty_like_strided(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor with ``t``'s shape, dtype and strides."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device)


class _BwdLaunch:
    """The argument list of the two backward kernels for one call, with
    their outputs: ``dq`` with q's strides, ``dk`` and ``dv`` with k's and
    v's, and ``delta`` (fp32 ``[b, h, sq]``, written by dq, read by
    dk/dv); for 16-bit inputs each kernel's four TMA maps
    (:func:`_tma_maps`).  :meth:`launch` runs one kernel; dq must run
    first."""

    def __init__(self, q, k, v, o, lse, do, qseg, kseg, causal, scale,
                 dropout_rate, dropout_seed):
        op = "flash_attention_bwd"
        qseg, kseg = _check_qkv(q, k, v, qseg, kseg, op)
        for t, what in ((o, "o"), (do, "do")):
            _check_operand(t, what, q.dtype, q.device, op)
            if t.shape != q.shape:
                raise ValueError(f"{op}: {what} shape {tuple(t.shape)} != q "
                                 f"shape {tuple(q.shape)}")
        b, h, sq, d = q.shape
        hk, sk = k.shape[1], k.shape[2]
        if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq)
                or not lse.is_contiguous() or lse.device != q.device):
            raise ValueError(f"{op}: lse must be contiguous fp32 "
                             f"({b}, {h}, {sq}) on {q.device}, got "
                             f"{lse.dtype} {tuple(lse.shape)}")
        self._maps = {FLASH_ATTENTION_DQ.name: None, FLASH_ATTENTION_DKV.name: None}
        if q.dtype != torch.float32:
            # the 16-bit kernels read q, k, v and do through TMA maps
            q, k, v, do = (_tma_readable(t) for t in (q, k, v, do))
            self._maps[FLASH_ATTENTION_DQ.name] = _tma_maps(q.dtype, (
                _tma_part(q, _BLOCK_ROWS), _tma_part(do, _BLOCK_ROWS),
                _tma_part(k, _TILE_ROWS), _tma_part(v, _TILE_ROWS)))
            self._maps[FLASH_ATTENTION_DKV.name] = _tma_maps(q.dtype, (
                _tma_part(k, _BLOCK_ROWS), _tma_part(v, _BLOCK_ROWS),
                _tma_part(q, _TILE_ROWS), _tma_part(do, _TILE_ROWS)))
        _check_device(q, op)
        self.dq, self.dk, self.dv = (_empty_like_strided(t) for t in (q, k, v))
        self.delta = torch.empty((b, h, sq), dtype=torch.float32,
                                 device=q.device)
        # the tensors behind the raw pointers below stay alive with the call
        self._keep = (q, k, v, o, lse, do, qseg, kseg)
        strides = [st for t in (q, k, v, o, do, self.dq, self.dk, self.dv)
                   for st in t.stride()[:3]]
        self._strides = (ctypes.c_longlong * 24)(*strides)
        seed = 0 if dropout_seed is None else _seed_bits(dropout_seed)
        ptr = lambda t: None if t is None else t.data_ptr()
        self._head = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), self.delta.data_ptr(), ptr(qseg),
            ptr(kseg), self.dq.data_ptr(), self.dk.data_ptr(),
            self.dv.data_ptr(), b, h, hk, sq, sk, d, self._strides)
        self._tail = (
            float(scale), int(causal), int(dropout_rate > 0.0), seed,
            _threshold(dropout_rate), float(1.0 / (1.0 - dropout_rate)),
            _DTYPE_CODES[q.dtype])

    def launch(self, kernel: Kernel) -> None:
        status = _bwd_symbol(kernel)(*self._head, self._maps[kernel.name],
                                     *self._tail,
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(status, kernel.name)
        kernel.launches += 1


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _check_dropout(dropout_rate, dropout_seed) -> float:
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    return dropout_rate


def _forward(q, k, v, qseg, kseg, causal, scale, dropout_rate, dropout_seed):
    if kernel_path(q, k, v, qseg, kseg):
        return _kernel_forward(q, k, v, qseg, kseg, causal, scale,
                               dropout_rate, dropout_seed)
    return _plain_forward(q, k, v, causal=causal, q_segment_ids=qseg,
                          kv_segment_ids=kseg, scale=scale,
                          dropout_rate=dropout_rate, dropout_seed=dropout_seed)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        segment_ids=None, scale: Optional[float] = None,
                        dropout_rate: float = 0.0, dropout_seed=None):
    """``(dq, dk, dv)`` for the forward's ``o`` and ``lse`` and the
    upstream ``do`` (like ``o``, any strides with a unit last one); the
    kernels for CUDA tensors (dq with q's strides, dk and dv with k's and
    v's), the plain version for CPU ones.  Other arguments as in
    :func:`flash_attention`."""
    qseg, kseg = _split_segments(segment_ids)
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    dropout_rate = _check_dropout(dropout_rate, dropout_seed)
    if kernel_path(q, k, v, o, lse, do, qseg, kseg):
        call = _BwdLaunch(q, k, v, o, lse, do, qseg, kseg, causal, scale,
                          dropout_rate, dropout_seed)
        call.launch(FLASH_ATTENTION_DQ)
        call.launch(FLASH_ATTENTION_DKV)
        return call.dq, call.dk, call.dv
    return _plain_backward(q, k, v, o, lse, do, causal=causal,
                           q_segment_ids=qseg, kv_segment_ids=kseg,
                           scale=scale, dropout_rate=dropout_rate,
                           dropout_seed=dropout_seed)


class _FlashFunction(torch.autograd.Function):
    """Flash attention under autograd: returns ``(o, lse)`` (lse carries no
    gradient) and saves q, k, v, o, lse, the segment ids and the seed."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, scale, dropout_rate,
                dropout_seed):
        o, lse = _forward(q, k, v, qseg, kseg, causal, scale, dropout_rate,
                          dropout_seed)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.args = (causal, scale, dropout_rate, dropout_seed)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        causal, scale, dropout_rate, dropout_seed = ctx.args
        if do.stride(-1) != 1:
            # the kernels read rows of do; autograd may hand over another
            # layout (an expanded zero-stride gradient, say)
            do = do.contiguous()
        seg = None if qseg is None else (qseg, kseg)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, segment_ids=seg, scale=scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_fwd(q, k, v, *, causal: bool = False, segment_ids=None,
                        scale: Optional[float] = None,
                        dropout_rate: float = 0.0, dropout_seed=None):
    """``(o, lse)``: ``o [b, h, sq, d]`` in q's dtype and ``lse [b, h,
    sq]`` in fp32 (``+inf`` on a fully-masked row).  The kernel for CUDA
    tensors, the plain version for CPU ones; ``o`` is differentiable
    (through :class:`_FlashFunction`) when q, k or v needs a gradient.
    Arguments as in :func:`flash_attention`."""
    qseg, kseg = _split_segments(segment_ids)
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    dropout_rate = _check_dropout(dropout_rate, dropout_seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFunction.apply(q, k, v, qseg, kseg, causal, scale,
                                    dropout_rate, dropout_seed)
    return _forward(q, k, v, qseg, kseg, causal, scale, dropout_rate,
                    dropout_seed)


def flash_attention(q, k, v, *, causal: bool = False, segment_ids=None,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed=None):
    """Fused attention ``softmax(q kᵀ · scale [+ masks]) [dropout] v``.

    ``q [b, h, sq, d]``; ``k``, ``v [b, hk, sk, d]`` with ``h % hk == 0``.
    ``causal`` aligns the mask to the last query; ``segment_ids`` is
    None, one ``[b, s]`` int tensor, or a ``(q_seg, kv_seg)`` pair;
    ``scale`` defaults to ``1/sqrt(d)``; ``dropout_rate > 0`` needs an int
    ``dropout_seed``.  Returns ``[b, h, sq, d]`` in q's dtype; a
    fully-masked row gives zeros.  Differentiable in q, k and v.  The
    kernels take d = 32, 64 or 128 and fp32, bf16 or fp16, and raise on
    anything else."""
    return flash_attention_fwd(q, k, v, causal=causal,
                               segment_ids=segment_ids, scale=scale,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)[0]
