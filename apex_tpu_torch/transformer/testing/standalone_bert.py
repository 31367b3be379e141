"""Standalone BERT (counterpart of
``apex_tpu/transformer/testing/standalone_bert.py``).

:class:`BertModel` is a bidirectional (``AttnMaskType.padding``)
:class:`~apex_tpu_torch.transformer.testing.standalone_transformer_lm.
TransformerLanguageModel` with the masked-LM head (:class:`BertLMHead`:
dense, gelu, LayerNorm, then the **tied** word embedding through
:func:`~apex_tpu_torch.transformer.tensor_parallel.parallel_lm_logits`), and
with ``add_binary_head`` the pooler and the next-sentence (binary) head.

A ``[b, s]`` padding mask (1 keep, 0 pad, the BERT convention) reaches the
attention in two forms, as in the JAX model: segment ids for the flash
path (pads 0, kept tokens 1: a kept query sees the kept keys; a pad
query's output is a don't-care) and a ``[b, 1, s, s]`` mask (True masks a
pad key out) for the materialized path's
:class:`~apex_tpu_torch.transformer.functional.FusedScaleMaskSoftmax`.

The dense layers of the heads are flax's ``nn.Dense``: :class:`Dense`
computes in the promoted dtype of its input, weight and bias, so under an
O2 cast (bf16 weights, fp32 biases) the heads run in fp32, as the JAX
model's do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.layers import FusedLayerNorm
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import normal_
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerLanguageModel,
    parallel_lm_logits,
)

__all__ = ["Dense", "Pooler", "BertLMHead", "BertModel",
           "bert_model_provider"]


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias`` in the promoted dtype of
    the three (``weight`` is ``[out, in]``, the kernel transposed).  The
    initial weight is ``normal(0, 1 / sqrt(in))``, the bias zeros."""

    def __init__(self, in_features: int, out_features: int, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(normal_(
            (out_features, in_features), in_features ** -0.5,
            dtype=torch.float32, device=device, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        dt = torch.promote_types(torch.promote_types(x.dtype,
                                                     self.weight.dtype),
                                 self.bias.dtype)
        return nn.functional.linear(x.to(dt), self.weight.to(dt),
                                    self.bias.to(dt))


class Pooler(nn.Module):
    """``tanh(dense(first token))`` on ``[s, b, h]`` hidden states."""

    def __init__(self, hidden_size: int, *, device, generator=None):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, device=device,
                           generator=generator)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[0]))


class BertLMHead(nn.Module):
    """Dense, ``gelu(approximate="tanh")``, LayerNorm; the logits against
    the tied embedding are :class:`BertModel`'s."""

    def __init__(self, hidden_size: int, *, device, generator=None):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, device=device,
                           generator=generator)
        self.layernorm = FusedLayerNorm(hidden_size, device=device)

    def forward(self, hidden):
        h = nn.functional.gelu(self.dense(hidden), approximate="tanh")
        return self.layernorm(h)


class BertModel(nn.Module):
    """The JAX ``BertModel``'s fields as constructor arguments (the same
    defaults), plus ``device`` (CUDA unless the caller asks for the CPU)
    and ``generator`` for the initial weights."""

    def __init__(self, num_layers: int = 2, hidden_size: int = 64,
                 num_attention_heads: int = 4, vocab_size: int = 128,
                 max_sequence_length: int = 64, add_binary_head: bool = True,
                 use_flash_attention: bool = True,
                 params_dtype: torch.dtype = torch.float32, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.vocab_size = vocab_size
        self.add_binary_head = add_binary_head
        self.language_model = TransformerLanguageModel(
            num_layers, hidden_size, num_attention_heads, vocab_size,
            max_sequence_length, attn_mask_type=AttnMaskType.padding,
            use_flash_attention=use_flash_attention,
            params_dtype=params_dtype, device=dev, generator=generator)
        self.lm_head = BertLMHead(hidden_size, device=dev,
                                  generator=generator)
        if add_binary_head:
            self.pooler = Pooler(hidden_size, device=dev, generator=generator)
            self.binary_head = Dense(hidden_size, 2, device=dev,
                                     generator=generator)

    def forward(self, input_ids, attention_mask=None, lm_labels=None,
                deterministic: bool = True, *,
                dropout_generator: Optional[torch.Generator] = None):
        """``(logits [s, b, vocab / tp], binary [b, 2])``, or with
        ``lm_labels [b, s]`` ``(per-token loss [b, s], binary)`` (fp32;
        ``binary`` is None without the binary head).  ``attention_mask``
        is ``[b, s]``, 1 keep and 0 pad."""
        mask4d = segment_ids = None
        if attention_mask is not None:
            keep = attention_mask.to(torch.bool)
            b, s = keep.shape
            mask4d = (~keep)[:, None, None, :].expand(b, 1, s, s)
            segment_ids = keep.to(torch.int32)
        hidden = self.language_model(input_ids, None, mask4d, segment_ids,
                                     deterministic=deterministic,
                                     dropout_generator=dropout_generator)
        lm_hidden = self.lm_head(hidden)
        word_emb = self.language_model.embedding.word_embeddings.weight
        logits = parallel_lm_logits(lm_hidden, word_emb.to(lm_hidden.dtype))
        binary = (self.binary_head(self.pooler(hidden))
                  if self.add_binary_head else None)
        if lm_labels is None:
            return logits, binary
        return vocab_parallel_cross_entropy(logits.transpose(0, 1),
                                            lm_labels), binary


def bert_model_provider(pre_process: bool = True, post_process: bool = True,
                        **kwargs) -> BertModel:
    """``standalone_bert.bert_model_provider`` (the pipeline flags are
    accepted, as in the JAX function, and unused)."""
    del pre_process, post_process
    return BertModel(**kwargs)
