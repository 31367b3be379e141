"""RNN-T (transducer) joint and loss (counterpart of
``apex_tpu.contrib.transducer.transducer``).

- :func:`transducer_joint`: the broadcast-add joint ``h[b, t, u] = f[b, t]
  + g[b, u]`` with optional ReLU and dropout (drawn from a
  ``torch.Generator``), positions past ``f_len`` / ``g_len`` zeroed;
  :func:`pack_joint_output` keeps only the valid ``(t, u)`` rows.
- :func:`transducer_loss`: the RNN-T negative log-likelihood over the
  ``(T, U)`` lattice, in fp32.  The forward computes the beta lattice (and,
  when a gradient is wanted, alpha) and saves the logits, alpha and beta;
  the backward recomputes the log-softmax and fuses its backward.

The lattice DP loops over T, as JAX's ``lax.scan`` does.  Along U each row
solves a linear recurrence in the (logaddexp, +) semiring, ``v[u] =
logaddexp(a[u] + v[u - 1], c[u])`` (or its mirror for beta); JAX runs it
as an associative scan, here it is its closed form ``v = P + logcumsumexp(c
- P)`` with ``P`` the prefix sums of ``a`` (suffix sums and a reversed
``logcumsumexp`` for beta).  The only blocked transitions (``a = -1e30``,
JAX's finite stand-in for log 0, kept so that no ``inf - inf`` appears)
are the label emissions past ``y_len``, a suffix of each row: the closed
form runs over the unblocked prefix, with the blocked ``a`` taken as 0 in
the sums, and a position behind a blocked transition takes ``c`` alone,
which is what the recurrence gives there.  A row costs a fixed handful of
launches, independent of U.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.utils.dropout import dropout

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_joint",
           "transducer_loss"]

_NEG_INF = -1e30  # finite stand-in for log(0)


def _time_mask(lengths, size):
    return (torch.arange(size, device=lengths.device)[None, :]
            < lengths[:, None])


# ---------------------------------------------------------------------------
# joint
# ---------------------------------------------------------------------------


def transducer_joint(f, g, f_len=None, g_len=None, *, relu=False,
                     dropout_prob=0.0,
                     generator: Optional[torch.Generator] = None):
    """``h[b, t, u] = f[b, t] + g[b, u]`` with optional ReLU and dropout.

    f: ``[B, T, H]`` encoder states; g: ``[B, U, H]`` predictor states.
    Positions past ``f_len`` / ``g_len`` are zeroed."""
    h = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        h = torch.relu(h)
    if dropout_prob > 0.0:
        if generator is None:
            raise ValueError("dropout_prob > 0 requires a generator")
        h = dropout(h, dropout_prob, generator)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    if f_len is not None:
        h = torch.where(_time_mask(f_len, h.shape[1])[:, :, None, None], h,
                        zero)
    if g_len is not None:
        h = torch.where(_time_mask(g_len, h.shape[2])[:, None, :, None], h,
                        zero)
    return h


def pack_joint_output(h, f_len, g_len, batch_offset, packed_batch: int):
    """The valid ``(t < f_len, u < g_len)`` rows of ``[B, T, U, H]`` in a
    dense ``[packed_batch, H]`` buffer, laid out as the reference's packed
    form: batch b's rows start at ``batch_offset[b - 1]``, t-major.  Rows
    whose destination falls outside the buffer are dropped."""
    B, T, U, H = h.shape
    dev = h.device
    starts = batch_offset - f_len * g_len                      # [B]
    t_idx = torch.arange(T, device=dev)[None, :, None]
    u_idx = torch.arange(U, device=dev)[None, None, :]
    valid = (t_idx < f_len[:, None, None]) & (u_idx < g_len[:, None, None])
    dest = starts[:, None, None] + t_idx * g_len[:, None, None] + u_idx
    keep = valid & (dest >= 0) & (dest < packed_batch)
    out = h.new_zeros((packed_batch, H))
    return out.index_put((dest[keep],), h[keep])


class TransducerJoint(nn.Module):
    """Module form of :func:`transducer_joint` (apex's
    ``TransducerJoint``).  ``opt``, ``fwd_tile_size`` and ``probe_mask``
    are CUDA tiling knobs of the reference, accepted and ignored;
    ``generator`` draws the dropout."""

    def __init__(self, pack_output=False, relu=False, dropout=False, opt=1,
                 fwd_tile_size=4, dropout_prob=0.0, probe_mask=False):
        super().__init__()
        del opt, fwd_tile_size, probe_mask
        self.pack_output = pack_output
        self.relu = relu
        self.dropout = dropout
        self.dropout_prob = dropout_prob

    def forward(self, f, g, f_len, g_len, batch_offset=None,
                packed_batch: int = 0,
                generator: Optional[torch.Generator] = None):
        if self.pack_output and (batch_offset is None or packed_batch == 0):
            raise ValueError(
                "pack_output=True requires batch_offset and packed_batch")
        prob = self.dropout_prob if self.dropout else 0.0
        h = transducer_joint(f, g, f_len, g_len, relu=self.relu,
                             dropout_prob=prob, generator=generator)
        if self.pack_output:
            return pack_joint_output(h, f_len, g_len, batch_offset,
                                     packed_batch)
        return h


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _lattice_terms(x, label, y_len, blank_idx):
    """``(lse, blank, lab)``: the log-softmax's normalizer ``[B, T, U]``,
    the blank and label transitions' log-probs, label emissions past
    ``y_len`` at -1e30."""
    x32 = x.float()
    lse = torch.logsumexp(x32, dim=-1)                         # [B, T, U]
    blank = x32[..., blank_idx] - lse
    U = x.shape[2]
    lab_ids = torch.zeros((x.shape[0], U), dtype=torch.int64, device=x.device)
    lab_ids[:, :label.shape[1]] = label
    lab = x32.gather(-1, lab_ids[:, None, :, None].expand(
        -1, x.shape[1], -1, 1))[..., 0] - lse
    del x32
    lab = torch.where(_time_mask(y_len, U)[:, None, :], lab, _NEG_INF)
    return lse, blank, lab, lab_ids


def _alpha(blank, lab, y_len):
    """alpha[b, t, u]: log-prob of reaching node (t, u); alpha[0, 0] = 0.
    Row t solves ``v[u] = logaddexp(lab[t, u - 1] + v[u - 1], c[u])``,
    ``c = alpha[t - 1] + blank[t - 1]`` (row 0: ``c = [0, -1e30, ...]``)."""
    B, T, U = blank.shape
    u_pos = torch.arange(U, device=blank.device)[None, :]
    open_ = u_pos <= y_len[:, None]                            # [B, U]
    # a[t, u] = lab[t, u - 1] (u >= 1); blocked past y_len and at u = 0,
    # taken as 0 in the prefix sums P
    a = torch.nn.functional.pad(lab[:, :, :-1], (1, 0))
    a = torch.where(open_[:, None, :], a, 0.0)
    P = torch.cumsum(a, dim=-1)                                # [B, T, U]
    rows = []
    c = torch.where(u_pos == 0, 0.0, _NEG_INF).expand(B, U)
    for t in range(T):
        if t:
            c = rows[-1] + blank[:, t - 1]
        p = P[:, t]
        rows.append(torch.where(open_, p + torch.logcumsumexp(c - p, -1), c))
    return torch.stack(rows, dim=1)


def _beta(blank, lab, f_len, y_len):
    """beta[b, t, u]: log-prob of completing from node (t, u); the final
    blank at ``(f_len - 1, y_len)`` enters as an emission term.  Row t
    solves ``v[u] = logaddexp(lab[t, u] + v[u + 1], c[u])``, ``c =
    logaddexp(beta[t + 1] + blank[t], emit[t])``."""
    B, T, U = blank.shape
    dev = blank.device
    t_pos = torch.arange(T, device=dev)[None, :, None]
    u_pos = torch.arange(U, device=dev)[None, None, :]
    blank_g = torch.where(t_pos + 1 < f_len[:, None, None], blank, _NEG_INF)
    emit = torch.where((t_pos == f_len[:, None, None] - 1)
                       & (u_pos == y_len[:, None, None]), blank, _NEG_INF)
    open_ = u_pos[:, 0] <= y_len[:, None]                      # [B, U]
    a = torch.where(u_pos < y_len[:, None, None], lab, 0.0)
    # S[u] = sum_{k >= u} a[k]; sum_{k=u}^{j-1} a[k] = S[u] - S[j]
    S = torch.flip(torch.cumsum(torch.flip(a, (-1,)), dim=-1), (-1,))
    rows = [None] * T
    nxt = torch.full((B, U), _NEG_INF, device=dev)
    for t in range(T - 1, -1, -1):
        c = torch.logaddexp(nxt + blank_g[:, t], emit[:, t])
        s = S[:, t]
        tail = torch.flip(torch.logcumsumexp(torch.flip(c - s, (-1,)), -1),
                          (-1,))
        nxt = rows[t] = torch.where(open_, s + tail, c)
    return torch.stack(rows, dim=1)


class _TransducerLossFn(torch.autograd.Function):
    """The loss ``-beta[:, 0, 0]``; saves the logits, alpha and beta and
    recomputes the log-softmax in the backward."""

    @staticmethod
    def forward(ctx, x, label, f_len, y_len, blank_idx):
        _, blank, lab, _ = _lattice_terms(x, label, y_len, blank_idx)
        beta = _beta(blank, lab, f_len, y_len)
        alpha = (_alpha(blank, lab, y_len) if ctx.needs_input_grad[0]
                 else None)
        ctx.save_for_backward(x, label, f_len, y_len, alpha, beta)
        ctx.blank_idx = blank_idx
        return -beta[:, 0, 0]

    @staticmethod
    def backward(ctx, grad_loss):
        x, label, f_len, y_len, alpha, beta = ctx.saved_tensors
        blank_idx = ctx.blank_idx
        lse, blank, lab, lab_ids = _lattice_terms(x, label, y_len, blank_idx)
        B, T, U, V = x.shape
        dev = x.device
        t_pos = torch.arange(T, device=dev)[None, :, None]
        u_pos = torch.arange(U, device=dev)[None, None, :]
        in_lattice = ((t_pos < f_len[:, None, None])
                      & (u_pos <= y_len[:, None, None]))
        # each transition's posterior, scaled by the incoming gradient
        scale = -grad_loss.float()[:, None, None]
        log_node = alpha - beta[:, 0:1, 0:1]                   # alpha - log P
        beta_next_u = torch.cat(
            [beta[:, :, 1:], torch.full((B, T, 1), _NEG_INF, device=dev)], 2)
        d_lab = scale * torch.exp(log_node + lab + beta_next_u)
        d_lab = torch.where(in_lattice, d_lab, 0.0)
        beta_next_t = torch.cat(
            [beta[:, 1:], torch.full((B, 1, U), _NEG_INF, device=dev)], 1)
        is_final = ((t_pos == f_len[:, None, None] - 1)
                    & (u_pos == y_len[:, None, None]))
        blank_exit = torch.where(is_final, 0.0, _NEG_INF) + blank
        d_blank = scale * (torch.exp(log_node + blank + beta_next_t)
                           + torch.exp(log_node + blank_exit))
        d_blank = torch.where(in_lattice, d_blank, 0.0)
        # dlogp holds d_lab at each row's label and d_blank at the blank;
        # the log-softmax backward is dx = dlogp - softmax * sum_v(dlogp)
        dx = torch.exp(x.float() - lse[..., None])
        dx.mul_(-(d_lab + d_blank)[..., None])
        dx.scatter_add_(-1, lab_ids[:, None, :, None].expand(B, T, U, 1),
                        d_lab[..., None])
        dx[..., blank_idx] += d_blank
        return dx.to(x.dtype), None, None, None, None


def transducer_loss(x, label, f_len, y_len, blank_idx):
    """RNN-T negative log-likelihood per batch element.

    x: ``[B, T, U, V]`` joint logits (``U = max(y_len) + 1``); label:
    ``[B, U - 1]``; f_len, y_len: ``[B]`` valid time and label lengths.
    Returns ``[B]`` fp32 losses."""
    return _TransducerLossFn.apply(x, label.to(torch.int64),
                                   f_len.to(torch.int64),
                                   y_len.to(torch.int64), int(blank_idx))


class TransducerLoss(nn.Module):
    """Module form (apex's ``TransducerLoss``).  The backward always fuses
    the log-softmax; ``fuse_softmax_backward`` and ``opt`` are accepted for
    API parity; ``packed_input`` is not supported (keep the lattice dense
    and rely on the length masks)."""

    def __init__(self, fuse_softmax_backward=True, opt=1, packed_input=False):
        super().__init__()
        if packed_input:
            raise NotImplementedError(
                "packed_input is a CUDA memory layout of the reference; "
                "keep the [B, T, U, V] lattice dense and rely on length "
                "masking")
        del fuse_softmax_backward, opt

    def forward(self, x, label, f_len, y_len, blank_idx, batch_offset=None,
                max_f_len=None, debug_list=None):
        if debug_list is not None:
            with torch.no_grad():
                _, blank, lab, _ = _lattice_terms(x, label.to(torch.int64),
                                                  y_len, blank_idx)
                debug_list.extend([_alpha(blank, lab, y_len),
                                   _beta(blank, lab, f_len, y_len)])
        return transducer_loss(x, label, f_len, y_len, blank_idx)
