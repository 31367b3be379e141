"""The RNN factories (counterpart of ``apex_tpu/RNN/models.py``): each an
:class:`~apex_tpu_torch.RNN.rnn.RNNBackend` of one cell type.
``output_size`` (the reference's recurrent projection) is ignored, as in
JAX.  The keywords after ``output_size`` go to ``RNNBackend``: ``dtype``,
``device`` (CUDA by default) and ``generator``."""

from __future__ import annotations

from apex_tpu_torch.RNN.rnn import RNNBackend

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM"]


def LSTM(input_size, hidden_size, num_layers, bias=True, batch_first=False,
         dropout=0, bidirectional=False, output_size=None, **kw):
    """Stacked LSTM."""
    del output_size
    return RNNBackend("lstm", input_size, hidden_size, num_layers, bias=bias,
                      batch_first=batch_first, dropout=dropout,
                      bidirectional=bidirectional, **kw)


def GRU(input_size, hidden_size, num_layers, bias=True, batch_first=False,
        dropout=0, bidirectional=False, output_size=None, **kw):
    """Stacked GRU."""
    del output_size
    return RNNBackend("gru", input_size, hidden_size, num_layers, bias=bias,
                      batch_first=batch_first, dropout=dropout,
                      bidirectional=bidirectional, **kw)


def ReLU(input_size, hidden_size, num_layers, bias=True, batch_first=False,
         dropout=0, bidirectional=False, output_size=None, **kw):
    """Elman RNN with a ReLU."""
    del output_size
    return RNNBackend("relu", input_size, hidden_size, num_layers, bias=bias,
                      batch_first=batch_first, dropout=dropout,
                      bidirectional=bidirectional, **kw)


def Tanh(input_size, hidden_size, num_layers, bias=True, batch_first=False,
         dropout=0, bidirectional=False, output_size=None, **kw):
    """Elman RNN with a tanh."""
    del output_size
    return RNNBackend("tanh", input_size, hidden_size, num_layers, bias=bias,
                      batch_first=batch_first, dropout=dropout,
                      bidirectional=bidirectional, **kw)


def mLSTM(input_size, hidden_size, num_layers, bias=True, batch_first=False,
          dropout=0, bidirectional=False, output_size=None, **kw):
    """Multiplicative LSTM."""
    del output_size
    return RNNBackend("lstm", input_size, hidden_size, num_layers, bias=bias,
                      batch_first=batch_first, dropout=dropout,
                      bidirectional=bidirectional, mlstm=True, **kw)
