"""apex_tpu_torch.RNN: stacked and bidirectional LSTM, GRU, Elman and
multiplicative LSTM (counterpart of ``apex_tpu.RNN``)."""

from apex_tpu_torch.RNN import models
from apex_tpu_torch.RNN.models import GRU, LSTM, ReLU, Tanh, mLSTM
from apex_tpu_torch.RNN.rnn import RNNBackend

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "RNNBackend", "models"]
