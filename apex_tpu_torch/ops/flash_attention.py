"""Flash attention forward: a CUDA kernel and its plain version.

Counterpart of ``apex_tpu/ops/flash_attention.py`` (forward only).  On
CUDA tensors the forward is the hand-written kernel
``csrc/flash_attention_fwd.cu``, which replaces the Pallas ``_fwd_kernel``;
on CPU tensors it is :func:`mha_reference`, the counterpart of the JAX
``mha_reference``, with :func:`_fmix32` / :func:`_hash_keep` carried over
bit for bit.  Both keep the JAX semantics:

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

On CUDA the forward is inference-only: the dq and dk/dv kernels come with
the training slice of the port, so a CUDA call that would record a
gradient raises ``NotImplementedError``.  On the CPU, autograd through the
plain version works.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["flash_attention", "flash_attention_fwd", "mha_reference",
           "FLASH_ATTENTION_FWD"]

FLASH_ATTENTION_FWD = register(Kernel(
    name="flash_attention_fwd", source="flash_attention_fwd.cu",
    symbol="apex_flash_attention_fwd",
    replaces="apex_tpu/ops/flash_attention.py:191 _fwd_kernel"))

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)


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
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    valid = None
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        valid = (col <= row + (sk - sq))[None, None]
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, None, :, None]
               == kv_segment_ids[:, None, None, :])
        valid = seg if valid is None else valid & seg
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
        dev = q.device
        g = torch.arange(b * h, dtype=torch.int64, device=dev).view(b, h, 1, 1)
        qpos = torch.arange(sq, dtype=torch.int64, device=dev).view(1, 1, sq, 1)
        kpos = torch.arange(sk, dtype=torch.int64, device=dev).view(1, 1, 1, sk)
        keep = _hash_keep(dropout_seed, g, qpos, kpos, dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(p, v.float())
    return out.to(q.dtype), lse


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
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _symbol():
    fn = getattr(_build.library(FLASH_ATTENTION_FWD.source),
                 FLASH_ATTENTION_FWD.symbol)
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([vp] * 7 + [i] * 6 + [ll] * 12
                       + [ctypes.c_float, i, i, ctypes.c_uint, ctypes.c_uint,
                          ctypes.c_float, i, vp])
        fn.restype = ctypes.c_int
    return fn


def _check_operand(t: torch.Tensor, what: str, dtype, device):
    if t.device != device:
        raise ValueError(f"flash_attention_fwd: {what} lies on {t.device}, "
                         f"q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention_fwd: {what} dtype {t.dtype} != "
                        f"q dtype {dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"flash_attention_fwd: {what} must be 4-d with a "
                         f"unit last stride, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
        raise ValueError(f"flash_attention_fwd: {what} must start on 16 "
                         f"bytes with strides that are multiples of 8 "
                         f"elements, got strides {t.stride()}")


def _check_segments(seg, b: int, s: int, what: str, device):
    if tuple(seg.shape) != (b, s):
        raise ValueError(f"flash_attention_fwd: {what} shape "
                         f"{tuple(seg.shape)} != ({b}, {s})")
    if seg.device != device:
        raise ValueError(f"flash_attention_fwd: {what} lies on "
                         f"{seg.device}, q on {device}")


def _kernel_forward(q, k, v, qseg, kseg, causal: bool, scale: float,
                    dropout_rate: float, dropout_seed):
    """Launch the CUDA kernel; returns ``(o, lse)``.  ``o`` has q's
    strides, ``lse`` is a contiguous ``[b, h, sq]`` fp32 tensor.  Raises
    on anything the kernel does not take."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd: dtype {q.dtype} is not fp32, "
                        f"bf16 or fp16")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, what, q.dtype, q.device)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} is not one of "
                         f"{_HEAD_DIMS}")
    if (k.shape[0], k.shape[3]) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if hk < 1 or h % hk:
        raise ValueError(f"flash_attention_fwd: {h} query heads over {hk} "
                         f"kv heads")
    if min(b, h, sq, sk) < 1:
        raise ValueError(f"flash_attention_fwd: empty input, q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if (qseg is None) != (kseg is None):
        raise ValueError("flash_attention_fwd: give both segment-id tensors "
                         "or neither")
    if qseg is not None:
        # ids of any integer dtype; the kernel reads int32
        qseg = qseg.to(torch.int32).contiguous()
        kseg = kseg.to(torch.int32).contiguous()
        _check_segments(qseg, b, sq, "q_segment_ids", q.device)
        _check_segments(kseg, b, sk, "kv_segment_ids", q.device)
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention_fwd: q lies on {q.device}, the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
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
        float(scale), int(causal), int(dropout_rate > 0.0), seed,
        _threshold(dropout_rate), float(1.0 / (1.0 - dropout_rate)),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(status, "flash_attention_fwd")
    FLASH_ATTENTION_FWD.launches += 1
    return o, lse


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


def flash_attention_fwd(q, k, v, *, causal: bool = False, segment_ids=None,
                        scale: Optional[float] = None,
                        dropout_rate: float = 0.0, dropout_seed=None):
    """``(o, lse)``: ``o [b, h, sq, d]`` in q's dtype and ``lse [b, h,
    sq]`` in fp32 (``+inf`` on a fully-masked row).  The kernel for CUDA
    tensors, the plain version for CPU ones; arguments as in
    :func:`flash_attention`."""
    qseg, kseg = _split_segments(segment_ids)
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else float(scale)
    dropout_rate = _check_dropout(dropout_rate, dropout_seed)
    if kernel_path(q, k, v, qseg, kseg):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention_fwd on CUDA is inference-only: the dq and "
                "dk/dv kernels come with the training slice of the port.  "
                "Run under torch.no_grad()/inference_mode(), or on the CPU")
        return _kernel_forward(q, k, v, qseg, kseg, causal, scale,
                               dropout_rate, dropout_seed)
    return _plain_forward(q, k, v, causal=causal, q_segment_ids=qseg,
                          kv_segment_ids=kseg, scale=scale,
                          dropout_rate=dropout_rate,
                          dropout_seed=dropout_seed)


def flash_attention(q, k, v, *, causal: bool = False, segment_ids=None,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed=None):
    """Fused attention ``softmax(q kᵀ · scale [+ masks]) [dropout] v``.

    ``q [b, h, sq, d]``; ``k``, ``v [b, hk, sk, d]`` with ``h % hk == 0``.
    ``causal`` aligns the mask to the last query; ``segment_ids`` is
    None, one ``[b, s]`` int tensor, or a ``(q_seg, kv_seg)`` pair;
    ``scale`` defaults to ``1/sqrt(d)``; ``dropout_rate > 0`` needs an int
    ``dropout_seed``.  Returns ``[b, h, sq, d]`` in q's dtype; a
    fully-masked row gives zeros.  The kernel takes d = 64 or 128 and
    fp32, bf16 or fp16, and raises on anything else."""
    return flash_attention_fwd(q, k, v, causal=causal,
                               segment_ids=segment_ids, scale=scale,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)[0]
