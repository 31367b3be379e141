"""Standalone GPT (counterpart of
``apex_tpu/transformer/testing/standalone_gpt.py``).

:class:`GPTModel` is a causal :class:`TransformerLanguageModel` whose
output head is the **tied** word embedding: with ``labels`` at
tensor-parallel size 1 without sequence parallelism the per-token loss
goes through :func:`~apex_tpu_torch.ops.fused_lm_head.fused_lm_head_loss`
on that table (the fused LM-head kernels on the card; the logits never
reach memory), and the embedding's gradient is the sum of the lookup's
and the head's.  Otherwise, as in the JAX model, the fp32 logits of the
rank's vocab shard come from
:func:`~apex_tpu_torch.transformer.tensor_parallel.parallel_lm_logits`
(which all-gathers the sequence under sequence parallelism), and with
``labels`` the loss from
:func:`~apex_tpu_torch.transformer.tensor_parallel.vocab_parallel_cross_entropy`
over them.
The repo's benchmark flagship (``bench.py``'s ``large`` card) is this
model at GPT-2-large's widths, and its ``1.3b`` card this model at 24 x
2048 with whole-layer recompute (``activations_checkpoint=True``);
:mod:`apex_tpu_torch.examples.gpt_pretrain` trains them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.fused_lm_head import fused_lm_head_loss
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.tensor_parallel import (
    tp_world_size,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerLanguageModel,
    parallel_lm_logits,
)

__all__ = ["GPTModel", "gpt_model_provider"]


class GPTModel(nn.Module):
    """The JAX ``GPTModel``'s fields as constructor arguments (the same
    defaults), plus the port's ``device`` (CUDA unless the caller asks for
    the CPU) and ``generator`` (a ``torch.Generator`` on that device for
    the initial weights)."""

    def __init__(self, num_layers: int = 2, hidden_size: int = 64,
                 num_attention_heads: int = 4, vocab_size: int = 128,
                 max_sequence_length: int = 64, apply_rope: bool = False,
                 use_flash_attention: bool = True,
                 activations_checkpoint: bool = False,
                 activations_checkpoint_policy: Optional[str] = None,
                 sequence_parallel_enabled: bool = False,
                 params_dtype: torch.dtype = torch.float32, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.vocab_size = vocab_size
        self.max_sequence_length = max_sequence_length
        self.use_flash_attention = use_flash_attention
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.language_model = TransformerLanguageModel(
            num_layers, hidden_size, num_attention_heads, vocab_size,
            max_sequence_length, attn_mask_type=AttnMaskType.causal,
            apply_rope=apply_rope, use_flash_attention=use_flash_attention,
            activations_checkpoint=activations_checkpoint,
            activations_checkpoint_policy=activations_checkpoint_policy,
            sequence_parallel_enabled=sequence_parallel_enabled,
            params_dtype=params_dtype, device=resolve_device(device),
            generator=generator)

    def forward(self, input_ids, labels=None, position_ids=None,
                deterministic: bool = True, *,
                dropout_generator: Optional[torch.Generator] = None):
        """The per-token loss ``[b, s]`` (fp32) with ``labels [b, s]``, else
        the logits ``[s, b, vocab / tp]`` (fp32).  ``deterministic`` and
        ``dropout_generator`` go to the layers (whose dropout rates this
        model leaves at 0, as the JAX model does)."""
        hidden = self.language_model(input_ids, position_ids,
                                     deterministic=deterministic,
                                     dropout_generator=dropout_generator)
        # weight tying: the head reuses the (vocab-parallel) embedding table
        word_emb = self.language_model.embedding.word_embeddings.weight
        sp = self.sequence_parallel_enabled
        if labels is not None and tp_world_size() == 1 and not sp:
            return fused_lm_head_loss(hidden, word_emb.to(hidden.dtype),
                                      labels.T).T       # [s, b] token order
        logits = parallel_lm_logits(hidden, word_emb.to(hidden.dtype),
                                    sequence_parallel_enabled=sp)
        if labels is None:
            return logits
        # [s, b, v / tp] -> [b, s, v / tp]
        return vocab_parallel_cross_entropy(logits.transpose(0, 1), labels)


def gpt_model_provider(pre_process: bool = True, post_process: bool = True,
                       **kwargs) -> GPTModel:
    """``standalone_gpt.gpt_model_provider`` (the pipeline flags are
    accepted, as in the JAX function, and unused)."""
    del pre_process, post_process
    return GPTModel(**kwargs)
