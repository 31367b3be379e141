"""Recurrent cell math (counterpart of ``apex_tpu/RNN/cells.py``).

Each cell is a plain function ``cell(igates, hgates, hidden) -> hidden'``
over gate projections computed before it: ``igates`` from the input,
``hgates`` from the previous hidden state.  That split lets the sequence
loop take the input projection of a whole sequence in one product before
the loop (:mod:`apex_tpu_torch.RNN.rnn`).  The gate order is PyTorch's
(``nn.LSTMCell``: i, f, g, o; ``nn.GRUCell``: r, z, n, with ``b_hh``
inside ``hn``).
"""

from __future__ import annotations

import torch

__all__ = ["lstm_cell", "gru_cell", "relu_cell", "tanh_cell", "CELL_SPECS"]


def lstm_cell(igates, hgates, hidden):
    """4-gate LSTM: ``hidden = (h, c)``."""
    _, cx = hidden
    i, f, g, o = (igates + hgates).chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * cx + i * torch.tanh(g)
    return (o * torch.tanh(c), c)


def gru_cell(igates, hgates, hidden):
    """3-gate GRU: ``hidden = (h,)``; ``n = tanh(in + r * hn)``."""
    (hx,) = hidden
    ir, iz, in_ = igates.chunk(3, dim=-1)
    hr, hz, hn = hgates.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return ((1 - z) * n + z * hx,)


def relu_cell(igates, hgates, hidden):
    """Elman cell with a ReLU: ``hidden = (h,)``."""
    del hidden
    return (torch.relu(igates + hgates),)


def tanh_cell(igates, hgates, hidden):
    """Elman cell with a tanh: ``hidden = (h,)``."""
    del hidden
    return (torch.tanh(igates + hgates),)


# name -> (gate multiplier, hidden states, cell function)
CELL_SPECS = {
    "lstm": (4, 2, lstm_cell),
    "gru": (3, 1, gru_cell),
    "relu": (1, 1, relu_cell),
    "tanh": (1, 1, tanh_cell),
}
