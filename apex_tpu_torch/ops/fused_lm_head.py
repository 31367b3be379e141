"""Fused LM-head cross-entropy, forward and backward: CUDA kernels and
their plain versions.

Counterpart of ``apex_tpu/ops/fused_lm_head.py``.  The per-token loss of
``hidden @ embedding.T`` is computed without the ``[tokens, vocab]``
logits ever reaching memory.  On CUDA tensors the forward is the
hand-written kernel ``csrc/fused_lm_head_fwd.cu`` (the Pallas
``_fwd_kernel``) and the backward the two kernels of
``csrc/fused_lm_head_bwd.cu`` (the Pallas ``_dh_kernel`` and
``_de_kernel``); on CPU tensors they are :func:`_plain_forward`, whose
loss is the JAX ``lm_head_loss_reference``, and :func:`_plain_backward`.
For bf16 and fp16 the forward's logits product runs on the TMA and
``wgmma`` mainloop of ``csrc/wgmma_sm90.cuh``, whose epilogue reduces each
128 x 256 tile to per-token partials in a workspace (:func:`_workspace`)
that a second pass merges.  The backward kernels write ``dlog`` once in
the input dtype (the logits are recomputed once, not in each of dH and dE
as on the TPU); for bf16 and fp16 its three products (the logits, dH, dE)
run on the same mainloop (see the sources' notes).

The label contract is the JAX one: a label outside ``[0, vocab)`` (an
ignore id such as ``-100``, or ``vocab``) gets a target logit of exactly
0, so its loss is ``lse``; it is not clamped.  Mask such tokens
explicitly where a cross-entropy is meant.

The JAX kernel's shape gate (tokens a multiple of 512, hidden a multiple
of 128) is a TPU tiling limit and is not carried over: the CUDA kernel
takes any number of tokens, any vocab, and a hidden size that is a
multiple of 8, and raises on anything else.

A call that records a gradient goes through :class:`_HeadFunction`,
which saves the hidden states, the table, the labels and lse, as the JAX
``_fused_fwd`` does; the upstream cotangent of each token's loss need
not be uniform.  A call that records none runs the forward alone.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["fused_lm_head_loss", "fused_lm_head_fwd", "fused_lm_head_bwd",
           "lm_head_loss_reference", "padded_vocab", "FUSED_LM_HEAD_FWD",
           "FUSED_LM_HEAD_DH", "FUSED_LM_HEAD_DE"]

FUSED_LM_HEAD_FWD = register(Kernel(
    name="fused_lm_head_fwd", source="fused_lm_head_fwd.cu",
    symbol="apex_fused_lm_head_fwd",
    replaces="apex_tpu/ops/fused_lm_head.py:74 _fwd_kernel"))
FUSED_LM_HEAD_DH = register(Kernel(
    name="fused_lm_head_dh", source="fused_lm_head_bwd.cu",
    symbol="apex_fused_lm_head_dh",
    replaces="apex_tpu/ops/fused_lm_head.py:169 _dh_kernel"))
FUSED_LM_HEAD_DE = register(Kernel(
    name="fused_lm_head_de", source="fused_lm_head_bwd.cu",
    symbol="apex_fused_lm_head_de",
    replaces="apex_tpu/ops/fused_lm_head.py:198 _de_kernel"))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_VOCAB_TILE = 256    # the forward kernels' vocab tile: one workspace entry each


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: fp32, or fp64 for fp64
    input (the CPU's ``gradcheck``)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _plain_forward(h2, e, labels):
    """``(loss, lse)`` over the materialised fp32 logits ``h2 @ e.T``."""
    logits = torch.matmul(_acc(h2), _acc(e).t())
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    vocab = e.shape[0]
    valid = (labels >= 0) & (labels < vocab)
    safe = labels.clamp(0, vocab - 1).long()
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    return lse - torch.where(valid, tgt, 0.0), lse


def _plain_backward(h2, e, labels, lse, g):
    """``(dh, de)``: ``dlog = (softmax - onehot(label)) * g`` from the
    materialised logits and the forward's ``lse``; a label outside ``[0,
    vocab)`` matches no column, so it puts no -1 anywhere."""
    logits = torch.matmul(_acc(h2), _acc(e).t())
    p = torch.exp(logits - lse[:, None].to(logits.dtype))
    cols = torch.arange(e.shape[0], device=h2.device)
    onehot = (labels.long()[:, None] == cols[None, :]).to(p.dtype)
    dlog = (p - onehot) * g[:, None].to(p.dtype)
    dh = torch.matmul(dlog, _acc(e))
    de = torch.matmul(dlog.t(), _acc(h2))
    return dh.to(h2.dtype), de.to(e.dtype)


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
        fn.argtypes = [vp] * 6 + [ctypes.c_longlong] + [i] * 4 + [vp]
        fn.restype = ctypes.c_int
    return fn


def _bwd_symbol(kernel: Kernel):
    fn = getattr(_build.library(kernel.source), kernel.symbol)
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        n_ptrs = 7 if kernel is FUSED_LM_HEAD_DH else 3
        fn.argtypes = [vp] * n_ptrs + [ll] + [i] * 4 + [vp]
        fn.restype = ctypes.c_int
    return fn


def vocab_tiles(vocab: int) -> int:
    """The forward kernels' vocab tiles: 256 columns each, the last one
    ragged; tile ``s`` covers columns ``[256 s, 256 (s + 1))``."""
    return -(-vocab // _VOCAB_TILE)


def _workspace(tokens: int, vocab: int, device) -> torch.Tensor:
    """The forward kernels' fp32 scratch ``[3, vocab_tiles, tokens]``: each
    token's (max, sum of exp, target) over each vocab tile, which the
    kernel's second pass merges (12.3 MB at 8,192 tokens and vocab 32000)."""
    return torch.empty((3, vocab_tiles(vocab), tokens), dtype=torch.float32,
                       device=device)


def _check_operand(t: torch.Tensor, what: str, dtype, device,
                   op: str = "fused_lm_head_fwd"):
    if t.device != device:
        raise ValueError(f"{op}: {what} lies on {t.device}, hidden on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {what} dtype {t.dtype} != hidden dtype "
                        f"{dtype}")
    if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{op}: {what} must be a contiguous 2-d tensor on "
                         f"16 bytes, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def _check_head(h2, e, labels, op: str):
    """The checks the forward and backward kernels share: the operands'
    dtypes, shapes and layout first (the backward's tensor maps read rows
    of 16-byte-aligned, contiguous operands), then their device; returns
    the labels as contiguous int32."""
    if h2.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: dtype {h2.dtype} is not fp32, bf16 or fp16")
    _check_operand(h2, "hidden", h2.dtype, h2.device, op)
    _check_operand(e, "embedding", h2.dtype, h2.device, op)
    t, hid = h2.shape
    vocab = e.shape[0]
    if e.shape[1] != hid or hid % 8 or t < 1 or vocab < 1:
        raise ValueError(f"{op}: hidden {tuple(h2.shape)} and embedding "
                         f"{tuple(e.shape)}: the kernel takes T >= 1, V >= 1 "
                         f"and one hidden size, a multiple of 8")
    if tuple(labels.shape) != (t,) or labels.device != h2.device:
        raise ValueError(f"{op}: labels shape {tuple(labels.shape)} on "
                         f"{labels.device} != ({t},) on {h2.device}")
    if h2.device.type != "cuda":
        raise ValueError(f"{op}: hidden lies on {h2.device}, the kernels take "
                         f"CUDA tensors")
    if h2.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: hidden lies on {h2.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    # ids of any integer dtype; the kernels read int32
    return labels.to(torch.int32).contiguous()


def padded_vocab(vocab: int) -> int:
    """Vp, the width of the backward's ``dlog [T, Vp]`` scratch: the vocab
    rounded up to 64, so that its rows are whole 128-byte boxes of 16-bit
    values for the wgmma products' tensor maps; the kernels write zeros in
    the columns ``[vocab, Vp)``."""
    return -(-vocab // 64) * 64


def _kernel_forward(h2, e, labels):
    """Launch the CUDA kernel on ``h2 [T, hid]``, ``e [V, hid]`` and
    ``labels [T]``; returns fp32 ``(loss [T], lse [T])``."""
    labels = _check_head(h2, e, labels, "fused_lm_head_fwd")
    t, hid = h2.shape
    vocab = e.shape[0]
    loss = torch.empty((t,), dtype=torch.float32, device=h2.device)
    lse = torch.empty((t,), dtype=torch.float32, device=h2.device)
    ws = _workspace(t, vocab, h2.device)
    status = _symbol()(
        h2.data_ptr(), e.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), ws.data_ptr(), t, vocab, hid, ws.shape[1],
        _DTYPE_CODES[h2.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(status, "fused_lm_head_fwd")
    FUSED_LM_HEAD_FWD.launches += 1
    return loss, lse


class _BwdLaunch:
    """The arguments of the dH and dE kernels for one call, with their
    outputs and the ``dlog [T, Vp]`` scratch (input dtype, Vp = vocab
    rounded up to 64) that dH writes and dE reads.  :meth:`launch` runs
    one kernel; dH must run first."""

    def __init__(self, h2, e, labels, lse, g):
        op = "fused_lm_head_bwd"
        labels = _check_head(h2, e, labels, op)
        t, hid = h2.shape
        for x, what in ((lse, "lse"), (g, "g")):
            if (x.dtype != torch.float32 or tuple(x.shape) != (t,)
                    or not x.is_contiguous() or x.device != h2.device):
                raise ValueError(f"{op}: {what} must be contiguous fp32 "
                                 f"({t},) on {h2.device}, got {x.dtype} "
                                 f"{tuple(x.shape)}")
        vocab = e.shape[0]
        self.vp = padded_vocab(vocab)
        self.dlog = torch.empty((t, self.vp), dtype=h2.dtype, device=h2.device)
        self.dh = torch.empty_like(h2)
        self.de = torch.empty_like(e)
        # the tensors behind the raw pointers below stay alive with the call
        self._keep = (h2, e, labels, lse, g)
        self._shape = (t, vocab, hid, self.vp, _DTYPE_CODES[h2.dtype])
        self._dh_ptrs = (h2.data_ptr(), e.data_ptr(), labels.data_ptr(),
                         lse.data_ptr(), g.data_ptr(), self.dlog.data_ptr(),
                         self.dh.data_ptr())
        self._de_ptrs = (self.dlog.data_ptr(), h2.data_ptr(),
                         self.de.data_ptr())

    def launch(self, kernel: Kernel) -> None:
        ptrs = self._dh_ptrs if kernel is FUSED_LM_HEAD_DH else self._de_ptrs
        status = _bwd_symbol(kernel)(*ptrs, *self._shape,
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(status, kernel.name)
        kernel.launches += 1


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _forward(h2, e, labels):
    if kernel_path(h2, e, labels):
        return _kernel_forward(h2, e, labels)
    return _plain_forward(h2, e, labels)


def fused_lm_head_bwd(h2, e, labels, lse, g):
    """``(dh, de)`` for ``h2 [T, h]``, ``e [V, h]``, ``labels [T]``, the
    forward's ``lse [T]`` and the per-token upstream cotangent ``g [T]``
    (fp32, not necessarily uniform); the kernels for CUDA tensors, the
    plain version for CPU ones."""
    if kernel_path(h2, e, labels, lse, g):
        call = _BwdLaunch(h2, e, labels, lse, g)
        call.launch(FUSED_LM_HEAD_DH)
        call.launch(FUSED_LM_HEAD_DE)
        return call.dh, call.de
    return _plain_backward(h2, e, labels, lse, g)


class _HeadFunction(torch.autograd.Function):
    """The fused head under autograd: returns ``(loss, lse)`` (lse carries
    no gradient) and saves the hidden states, the table, the labels and
    lse."""

    @staticmethod
    def forward(ctx, h2, e, labels):
        loss, lse = _forward(h2, e, labels)
        ctx.save_for_backward(h2, e, labels, lse)
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _dlse):
        h2, e, labels, lse = ctx.saved_tensors
        # a mean's gradient arrives expanded (stride 0): the kernels read
        # one fp32 value per token
        dh, de = fused_lm_head_bwd(h2, e, labels, lse, _acc(g).contiguous())
        return dh, de, None


def fused_lm_head_fwd(hidden, embedding, labels):
    """``(loss, lse)``, each fp32 ``[...]``, for ``hidden [..., h]``, a
    ``[vocab, h]`` table and ``labels [...]``.  The kernel for CUDA
    tensors, the plain version for CPU ones; the loss is differentiable
    in ``hidden`` and ``embedding`` (through :class:`_HeadFunction`)."""
    lead = hidden.shape[:-1]
    hid = hidden.shape[-1]
    if tuple(labels.shape) != tuple(lead):
        raise ValueError(f"fused_lm_head_fwd: labels shape "
                         f"{tuple(labels.shape)} != hidden's leading shape "
                         f"{tuple(lead)}")
    if hidden.is_cuda:
        if not hidden.is_contiguous():
            raise ValueError("fused_lm_head_fwd: hidden is not contiguous; "
                             "make it contiguous where it is produced")
        h2 = hidden.view(-1, hid)
    else:
        h2 = hidden.reshape(-1, hid)
    lab = labels.reshape(-1)
    if torch.is_grad_enabled() and (hidden.requires_grad
                                    or embedding.requires_grad):
        loss, lse = _HeadFunction.apply(h2, embedding, lab)
    else:
        loss, lse = _forward(h2, embedding, lab)
    return loss.reshape(lead), lse.reshape(lead)


def fused_lm_head_loss(hidden, embedding, labels):
    """Per-token cross-entropy ``logsumexp(logits) - logits[label]`` of
    ``hidden @ embedding.T``, fp32 ``[...]``, without materialising the
    logits on the card.  See the module docstring for the label
    contract."""
    return fused_lm_head_fwd(hidden, embedding, labels)[0]
