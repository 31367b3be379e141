"""Column/Row-parallel linears and the vocab-parallel embedding, at tp
world size 1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/layers.py`` on its
single-shard paths: ``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding`` and ``parallel_lm_logits``.  The projections
are plain ``torch.matmul``, as the JAX package leaves them to XLA.
At world size 1 the column and row split is the same product, and the
gather/scatter/reduce flags of the JAX layers have nothing to do; the
layers and their flags come back with the tensor-parallel slice of the
port.

Weights follow PyTorch's layout: a linear's ``weight`` is ``[out, in]``
(the flax ``kernel`` transposed) and the embedding's ``weight`` is
``[vocab, h]``.  Fresh weights are drawn from an explicit
``torch.Generator``: ``normal(0, 1/sqrt(in))`` for the linears (the
variance of flax's ``lecun_normal``) and ``normal(0, 0.02)`` for the
embedding, as in Megatron.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "parallel_lm_logits", "normal_"]


def normal_(shape, std: float, *, dtype, device, generator=None):
    """A fresh ``normal(0, std)`` tensor, drawn in fp32 on ``device``."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return (out * std).to(dtype)


def _matmul(x, weight):
    """``x @ weight.T`` in ``x``'s dtype (fp32 accumulation on the card,
    as the JAX package's ``preferred_element_type=float32``)."""
    return torch.matmul(x, weight.to(x.dtype).t())


class _Linear(nn.Module):
    """``skip_bias_add`` returns ``(x A, b)`` and leaves the bias add to the
    caller (to fuse it with what follows), as the JAX layers do."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 *, skip_bias_add: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_bias_add = skip_bias_add
        dev = resolve_device(device)
        self.weight = nn.Parameter(normal_(
            (output_size, input_size), 1.0 / math.sqrt(input_size),
            dtype=dtype, device=dev, generator=generator))
        self.bias = (nn.Parameter(torch.zeros(output_size, dtype=dtype,
                                              device=dev))
                     if bias else None)

    def forward(self, x):
        y = _matmul(x, self.weight)
        if self.skip_bias_add:
            return y, self.bias
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ColumnParallelLinear(_Linear):
    """``Y = XA + b`` with A split by columns across tp ranks; at world
    size 1 the whole A (``layers.py:106``)."""


class RowParallelLinear(_Linear):
    """``Y = XA + b`` with A split by rows across tp ranks; at world size
    1 the whole A (``layers.py:161``)."""


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab split across tp ranks; at world size 1 a
    plain lookup (``layers.py:218``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(normal_(
            (num_embeddings, embedding_dim), 0.02, dtype=dtype,
            device=resolve_device(device), generator=generator))

    def forward(self, ids):
        return nn.functional.embedding(ids, self.weight)


def parallel_lm_logits(hidden, word_embeddings):
    """Logits ``H @ E^T`` in fp32 (``layers.py:251``): ``[s, b, vocab]``.

    The operands go up to fp32 before the product, which is what the JAX
    package's ``preferred_element_type=float32`` computes: a product of
    two bf16 values is exact in fp32, and the sum runs in fp32."""
    return torch.matmul(hidden.float(), word_embeddings.float().t())
