"""Stacked and bidirectional RNNs (counterpart of ``apex_tpu/RNN/rnn.py``).

Each layer and direction is a :class:`_Layer`: the input side of the
gates, ``x @ w_ih + b_ih``, is one ``[T*B, gate]`` product over the whole
sequence before the loop over time, and each step runs only the
recurrent product ``h @ w_hh + b_hh`` and the cell
(:mod:`apex_tpu_torch.RNN.cells`).  The multiplicative LSTM (mLSTM) also
takes ``x @ w_mih`` before the loop (it does not depend on ``h``); each
step forms ``m = (x_t @ w_mih) * (h @ w_mhh)`` and the gates from ``m @
w_hh``.  The reverse direction steps from the last time to the first; the
two directions' features are concatenated on the last axis.

The parameters keep the JAX names and layout, ``layer{l}_dir{d}.w_ih``
``[in, gate]``, ``w_hh`` ``[hidden, gate]``, ``b_ih``, ``b_hh``
``[gate]`` and for mLSTM ``w_mih`` ``[in, hidden]``, ``w_mhh``
``[hidden, hidden]``, initialized as flax does (``lecun_normal`` weights,
zero biases) from a seeded generator.  The hidden state is explicit, as
in JAX: ``forward(x, hidden=None)`` returns ``(output, finals)``, and
``finals`` feeds the next call.  Plain PyTorch: autograd gives the
backward.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.RNN.cells import CELL_SPECS
from apex_tpu_torch.utils.dropout import dropout as _dropout

__all__ = ["RNNBackend"]

Hidden = Tuple[torch.Tensor, ...]


def _lecun_normal(shape, *, dtype, device, generator) -> nn.Parameter:
    """flax's ``lecun_normal()`` for a 2-d ``[in, out]`` kernel:
    truncated normal (within 2 std) of variance ``1 / in``."""
    std = math.sqrt(1.0 / shape[0]) / .87962566103423978
    out = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    return nn.Parameter(out.to(dtype))


class _Layer(nn.Module):
    """One layer in one direction: the parameters and the loop over time."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int,
                 bias: bool, mlstm: bool, *, dtype, device, generator):
        super().__init__()
        mult, _, self.cell = CELL_SPECS[cell_type]
        gate = mult * hidden_size
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_ih = _lecun_normal((input_size, gate), **kw)
        self.w_hh = _lecun_normal((hidden_size, gate), **kw)
        if bias:
            self.b_ih = nn.Parameter(torch.zeros(gate, dtype=dtype,
                                                 device=device))
            self.b_hh = nn.Parameter(torch.zeros(gate, dtype=dtype,
                                                 device=device))
        else:
            self.b_ih = self.b_hh = None
        self.mlstm = mlstm
        if mlstm:
            self.w_mih = _lecun_normal((input_size, hidden_size), **kw)
            self.w_mhh = _lecun_normal((hidden_size, hidden_size), **kw)

    def _project(self, x2d, w, b):
        return x2d @ w if b is None else torch.addmm(b, x2d, w)

    def forward(self, xs: torch.Tensor, hidden: Hidden, reverse: bool = False
                ) -> Tuple[torch.Tensor, Hidden]:
        """``xs`` ``[T, B, in]``, ``hidden`` a tuple of ``[B, hidden]``:
        ``(ys [T, B, hidden], final hidden)``."""
        T, B = xs.shape[0], xs.shape[1]
        flat = xs.reshape(T * B, xs.shape[2])
        # unbind, not igates[t]: the backward of one unbind stacks the
        # steps' gradients once, where each step's index would build and
        # add a zero gradient of the whole [T, B, gate] tensor
        igates = self._project(flat, self.w_ih, self.b_ih).view(
            T, B, -1).unbind(0)
        if self.mlstm:
            xm = (flat @ self.w_mih).view(T, B, -1).unbind(0)
        ys: List[Optional[torch.Tensor]] = [None] * T
        h = tuple(hidden)
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            rec = xm[t] * (h[0] @ self.w_mhh) if self.mlstm else h[0]
            h = self.cell(igates[t], self._project(rec, self.w_hh, self.b_hh),
                          h)
            ys[t] = h[0]
        return torch.stack(ys), h


class RNNBackend(nn.Module):
    """Stacked (optionally bidirectional) RNN of ``cell_type`` ``"lstm"``,
    ``"gru"``, ``"relu"`` or ``"tanh"`` (``mlstm=True``: the
    multiplicative LSTM).

    ``forward(x, hidden=None, *, dropout_generator=None)`` with ``x``
    ``[T, B, F]`` (``[B, T, F]`` with ``batch_first``) returns ``(output,
    finals)``: output ``[T, B, H * dirs]`` (``[B, T, ...]`` with
    ``batch_first``) and ``finals`` the hidden tuple of each layer and
    direction, layer by layer, forward before reverse.  ``dropout``
    applies between layers in training mode only, its masks drawn from
    ``dropout_generator`` (a ``torch.Generator`` on the input's device;
    flax's ``nn.Dropout``).  The parameters are ``dtype`` on ``device``
    (CUDA by default), drawn from ``generator``.

    Unlike JAX, whose module is deterministic unless the caller passes
    ``deterministic=False``, a fresh module is in training mode: with
    ``dropout > 0`` and more than one layer, a call without
    ``dropout_generator`` raises; call ``.eval()`` for JAX's default."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 batch_first: bool = False, dropout: float = 0.0,
                 bidirectional: bool = False, mlstm: bool = False, *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cell_type not in CELL_SPECS:
            raise ValueError(f"cell_type {cell_type!r} is not one of "
                             f"{sorted(CELL_SPECS)}")
        device = resolve_device(device)
        self.cell_type, self.input_size = cell_type, input_size
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.bias, self.batch_first = bias, batch_first
        self.dropout, self.bidirectional = float(dropout), bidirectional
        self.mlstm, self.dtype = mlstm, dtype
        self.dirs = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * self.dirs
            for d in range(self.dirs):
                self.add_module(f"layer{layer}_dir{d}", _Layer(
                    cell_type, in_size, hidden_size, bias, mlstm,
                    dtype=dtype, device=device, generator=generator))

    def init_hidden(self, bsz: int) -> List[Hidden]:
        """Zero hidden states for every layer and direction, on the
        parameters' device."""
        n_states = CELL_SPECS[self.cell_type][1]
        device = self.layer0_dir0.w_ih.device
        return [tuple(torch.zeros(bsz, self.hidden_size, dtype=self.dtype,
                                  device=device) for _ in range(n_states))
                for _ in range(self.num_layers * self.dirs)]

    def forward(self, x: torch.Tensor,
                hidden: Optional[Sequence[Hidden]] = None, *,
                dropout_generator: Optional[torch.Generator] = None):
        if self.batch_first:
            x = x.transpose(0, 1)
        if hidden is None:
            hidden = self.init_hidden(x.shape[1])
        drop = self.training and self.dropout > 0.0 and self.num_layers > 1
        if drop and dropout_generator is None:
            raise ValueError("dropout in training mode needs a "
                             "dropout_generator (a torch.Generator on the "
                             "input's device)")
        finals: List[Hidden] = []
        feat = x
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.dirs):
                ys, fin = getattr(self, f"layer{layer}_dir{d}")(
                    feat, hidden[layer * self.dirs + d], reverse=d == 1)
                outs.append(ys)
                finals.append(fin)
            feat = outs[0] if self.dirs == 1 else torch.cat(outs, dim=-1)
            if drop and layer < self.num_layers - 1:
                feat = _dropout(feat, self.dropout, dropout_generator)
        if self.batch_first:
            feat = feat.transpose(0, 1)
        return feat, finals
