"""Fused LM-head cross-entropy forward: a CUDA kernel and its plain version.

Counterpart of ``apex_tpu/ops/fused_lm_head.py`` (forward only).  The
per-token loss of ``hidden @ embedding.T`` is computed without the
``[tokens, vocab]`` logits ever reaching memory.  On CUDA tensors it is
the hand-written kernel ``csrc/fused_lm_head_fwd.cu``, which replaces the
Pallas ``_fwd_kernel``; on CPU tensors it is :func:`_plain_forward`,
whose loss is the JAX ``lm_head_loss_reference``.

The label contract is the JAX one: a label outside ``[0, vocab)`` (an
ignore id such as ``-100``, or ``vocab``) gets a target logit of exactly
0, so its loss is ``lse``; it is not clamped.  Mask such tokens
explicitly where a cross-entropy is meant.

The JAX kernel's shape gate (tokens a multiple of 512, hidden a multiple
of 128) is a TPU tiling limit and is not carried over: the CUDA kernel
takes any number of tokens, any vocab, and a hidden size that is a
multiple of 8, and raises on anything else.

On CUDA the forward is inference-only: the dH and dE kernels come with the
training slice of the port, so a CUDA call that would record a gradient
raises ``NotImplementedError``.  On the CPU, autograd through the plain
version works.
"""

from __future__ import annotations

import ctypes
import math

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["fused_lm_head_loss", "fused_lm_head_fwd",
           "lm_head_loss_reference", "FUSED_LM_HEAD_FWD"]

FUSED_LM_HEAD_FWD = register(Kernel(
    name="fused_lm_head_fwd", source="fused_lm_head_fwd.cu",
    symbol="apex_fused_lm_head_fwd",
    replaces="apex_tpu/ops/fused_lm_head.py:74 _fwd_kernel"))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 128          # the kernel's token and vocab tile (bf16/fp16 path)


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _plain_forward(h2, e, labels):
    """``(loss, lse)`` over the materialised fp32 logits ``h2 @ e.T``."""
    logits = torch.matmul(h2.float(), e.float().t())
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    vocab = e.shape[0]
    valid = (labels >= 0) & (labels < vocab)
    safe = labels.clamp(0, vocab - 1).long()
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    return lse - torch.where(valid, tgt, 0.0), lse


def lm_head_loss_reference(hidden, embedding, labels):
    """Materialized reference (the JAX ``lm_head_loss_reference``): per-token
    fp32 loss ``[...]`` of ``hidden [..., h] @ embedding.T``."""
    lead = hidden.shape[:-1]
    loss, _ = _plain_forward(hidden.reshape(-1, hidden.shape[-1]), embedding,
                             labels.reshape(-1))
    return loss.reshape(lead)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _symbol():
    fn = getattr(_build.library(FUSED_LM_HEAD_FWD.source),
                 FUSED_LM_HEAD_FWD.symbol)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 6 + [ctypes.c_longlong] + [i] * 5 + [vp]
        fn.restype = ctypes.c_int
    return fn


def vocab_split(tokens: int, vocab: int, sms: int):
    """``(chunk, nsplit)``: the vocab columns each block covers and the
    number of chunks.  The grid aims at 16 blocks per SM, about eight
    waves of the two that fit at once, so the last wave's idle SMs cost
    little.  ``chunk`` is a multiple of the 128-column tile."""
    tiles = math.ceil(vocab / _TILE)
    want = max(1, min(tiles, math.ceil(16 * sms / math.ceil(tokens / _TILE))))
    per = math.ceil(tiles / want)
    return per * _TILE, math.ceil(tiles / per)


def _check_operand(t: torch.Tensor, what: str, dtype, device):
    if t.device != device:
        raise ValueError(f"fused_lm_head_fwd: {what} lies on {t.device}, "
                         f"hidden on {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_lm_head_fwd: {what} dtype {t.dtype} != "
                        f"hidden dtype {dtype}")
    if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_lm_head_fwd: {what} must be a contiguous "
                         f"2-d tensor on 16 bytes, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _kernel_forward(h2, e, labels):
    """Launch the CUDA kernel on ``h2 [T, hid]``, ``e [V, hid]`` and
    ``labels [T]``; returns fp32 ``(loss [T], lse [T])``."""
    if h2.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_lm_head_fwd: dtype {h2.dtype} is not fp32, "
                        f"bf16 or fp16")
    _check_operand(h2, "hidden", h2.dtype, h2.device)
    _check_operand(e, "embedding", h2.dtype, h2.device)
    t, hid = h2.shape
    vocab = e.shape[0]
    if e.shape[1] != hid or hid % 8 or t < 1 or vocab < 1:
        raise ValueError(f"fused_lm_head_fwd: hidden {tuple(h2.shape)} and "
                         f"embedding {tuple(e.shape)}: the kernel takes "
                         f"T >= 1, V >= 1 and one hidden size, a multiple "
                         f"of 8")
    if tuple(labels.shape) != (t,):
        raise ValueError(f"fused_lm_head_fwd: labels shape "
                         f"{tuple(labels.shape)} != ({t},)")
    if h2.device.index != torch.cuda.current_device():
        raise ValueError(f"fused_lm_head_fwd: hidden lies on {h2.device}, "
                         f"the current device is cuda:"
                         f"{torch.cuda.current_device()}")
    # ids of any integer dtype; the kernel reads int32
    labels = labels.to(torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(h2.device).multi_processor_count
    chunk, nsplit = vocab_split(t, vocab, sms)
    loss = torch.empty((t,), dtype=torch.float32, device=h2.device)
    lse = torch.empty((t,), dtype=torch.float32, device=h2.device)
    ws = torch.empty((3, nsplit, t), dtype=torch.float32, device=h2.device)
    status = _symbol()(
        h2.data_ptr(), e.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), ws.data_ptr(), t, vocab, hid, chunk, nsplit,
        _DTYPE_CODES[h2.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(status, "fused_lm_head_fwd")
    FUSED_LM_HEAD_FWD.launches += 1
    return loss, lse


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def fused_lm_head_fwd(hidden, embedding, labels):
    """``(loss, lse)``, each fp32 ``[...]``, for ``hidden [..., h]``, a
    ``[vocab, h]`` table and ``labels [...]``.  The kernel for CUDA
    tensors, the plain version for CPU ones."""
    lead = hidden.shape[:-1]
    hid = hidden.shape[-1]
    if tuple(labels.shape) != tuple(lead):
        raise ValueError(f"fused_lm_head_fwd: labels shape "
                         f"{tuple(labels.shape)} != hidden's leading shape "
                         f"{tuple(lead)}")
    if kernel_path(hidden, embedding, labels):
        if torch.is_grad_enabled() and (hidden.requires_grad
                                        or embedding.requires_grad):
            raise NotImplementedError(
                "fused_lm_head_fwd on CUDA is inference-only: the dH and dE "
                "kernels come with the training slice of the port.  Run "
                "under torch.no_grad()/inference_mode(), or on the CPU")
        if not hidden.is_contiguous():
            raise ValueError("fused_lm_head_fwd: hidden is not contiguous; "
                             "make it contiguous where it is produced")
        loss, lse = _kernel_forward(hidden.view(-1, hid), embedding,
                                    labels.reshape(-1))
    else:
        loss, lse = _plain_forward(hidden.reshape(-1, hid), embedding,
                                   labels.reshape(-1))
    return loss.reshape(lead), lse.reshape(lead)


def fused_lm_head_loss(hidden, embedding, labels):
    """Per-token cross-entropy ``logsumexp(logits) - logits[label]`` of
    ``hidden @ embedding.T``, fp32 ``[...]``, without materialising the
    logits on the card.  See the module docstring for the label
    contract."""
    return fused_lm_head_fwd(hidden, embedding, labels)[0]
