"""The GPT cut into pipeline stages (counterpart of
``apex_tpu/transformer/testing/commons.py``, apex's
``transformer/testing/commons.py``).

:func:`build_gpt_pipeline` gives one pp rank's
:class:`~apex_tpu_torch.transformer.pipeline_parallel.PipelineStageSpec`
of a GPT, as the JAX module's stage functions do for every rank:

- ``first`` (the first stage): :class:`~.standalone_transformer_lm.Embedding`,
  vocab-parallel word embeddings plus learned positions (none with
  ``apply_rope``), ``{"ids": [b, s]}`` to the ``[s, b, h]`` wire (the
  rank's ``[s / tp, b, h]`` block under sequence parallelism);
- ``stage`` (every stage): ``layers_per_stage``
  :class:`~.standalone_transformer_lm.ParallelTransformerLayer`\\ s,
  causal, on flash attention;
- ``last`` (the last stage): the final :class:`~apex_tpu_torch.transformer.
  layers.FusedLayerNorm`, :func:`~apex_tpu_torch.transformer.
  tensor_parallel.parallel_lm_logits` on the **tied** word embeddings and
  :func:`~apex_tpu_torch.transformer.tensor_parallel.
  vocab_parallel_cross_entropy` against ``{"labels": [b, s]}``, then the
  mean.

Built inside a tensor-parallel region each module is the rank's tp shard.
Under a virtual pipeline of ``vpp_size`` chunks a rank builds one spec a
chunk (``virtual_rank``): chunk ``v`` of rank ``r`` is global stage ``v *
pp + r``, the embedding on global stage 0 and the head on the last, as
Megatron's ``build_model`` gives ``pre_process`` / ``post_process``.

**The tied embeddings across stages.**  The JAX module keeps the
embedding and the head on every pp rank and the driver ``psum``\\ s their
gradients over pp.  Here one process runs one stage, so with pp > 1 the
first and the last stage each hold a copy of the word embeddings
(``first.word_embeddings.weight`` and ``last.word_embeddings.weight``),
Megatron's layout: the copies start equal (:func:`sync_word_embeddings`
broadcasts the first stage's) and :func:`allreduce_word_embedding_grads`
sums their gradients over ``parallel_state.get_embedding_group()``, so
one optimizer step keeps them equal.  At pp 1 the head reads the
embedding's own parameter (one parameter used twice, whose gradient
autograd sums), and there is nothing to reduce.  The position embeddings
live on the first stage and the final norm on the last, each alone.

:func:`init_gpt_pipeline_params` slices one seeded init of the whole
model, so a pipeline of any pp and tp trains the same model;
:func:`~apex_tpu_torch.models.convert.gpt_pipeline_params_from_jax`
carries a JAX rank's weights over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.layers import FusedLayerNorm
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding,
    parallel_lm_logits,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    Embedding,
    ParallelTransformerLayer,
)

__all__ = ["GPTPipeConfig", "build_gpt_pipeline", "init_gpt_pipeline_params",
           "sync_word_embeddings", "allreduce_word_embedding_grads"]


@dataclasses.dataclass(frozen=True)
class GPTPipeConfig:
    vocab_size: int = 128
    hidden_size: int = 64
    num_attention_heads: int = 4
    layers_per_stage: int = 2
    max_sequence_length: int = 64
    sequence_parallel_enabled: bool = False
    apply_rope: bool = False
    params_dtype: torch.dtype = torch.float32


class GPTPipeEmbed(Embedding):
    """The first stage's adapter: ``{"ids": [b, s]}`` to the wire."""

    def __init__(self, cfg: GPTPipeConfig, *, device, generator=None):
        super().__init__(cfg.hidden_size, cfg.vocab_size,
                         cfg.max_sequence_length,
                         use_position_embedding=not cfg.apply_rope,
                         sequence_parallel_enabled=cfg.sequence_parallel_enabled,
                         params_dtype=cfg.params_dtype, device=device,
                         generator=generator)

    def forward(self, mb):
        return super().forward(mb["ids"])


class GPTPipeBlock(nn.Module):
    """A stage's ``layers_per_stage`` causal transformer layers."""

    def __init__(self, cfg: GPTPipeConfig, *, device, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                attn_mask_type=AttnMaskType.causal, apply_rope=cfg.apply_rope,
                sequence_parallel_enabled=cfg.sequence_parallel_enabled,
                params_dtype=cfg.params_dtype, device=device,
                generator=generator)
            for _ in range(cfg.layers_per_stage))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class GPTPipeHead(nn.Module):
    """The last stage: final LayerNorm, logits on the tied word embeddings
    (``embedding``'s own at pp 1, else a copy of this stage's), the mean
    vocab-parallel cross entropy against ``mb["labels"] [b, s]``."""

    def __init__(self, cfg: GPTPipeConfig, *, embedding: Optional[
            VocabParallelEmbedding] = None, device, generator=None):
        super().__init__()
        self.sp = cfg.sequence_parallel_enabled
        self.final_layernorm = FusedLayerNorm(
            cfg.hidden_size, sequence_parallel_enabled=self.sp, device=device)
        if embedding is None:
            self.word_embeddings = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, dtype=cfg.params_dtype,
                device=device, generator=generator)
        else:
            # the first stage's module, not registered here: its parameter
            # is the first stage's, listed once
            self.__dict__["word_embeddings"] = embedding

    def forward(self, y, mb):
        y = self.final_layernorm(y)
        word = self.word_embeddings.weight
        logits = parallel_lm_logits(y, word.to(y.dtype),
                                    sequence_parallel_enabled=self.sp)
        return vocab_parallel_cross_entropy(logits.transpose(0, 1),
                                            mb["labels"]).mean()


def _stage_coords(pp_rank, pp_size, virtual_rank, vpp_size):
    """(global stage, global stages) of chunk ``virtual_rank`` of pp rank
    ``pp_rank`` (``parallel_state``'s rank and size by default)."""
    if pp_rank is None or pp_size is None:
        from apex_tpu_torch.transformer import parallel_state as ps

        pp_rank = ps.get_pipeline_model_parallel_rank()
        pp_size = ps.get_pipeline_model_parallel_world_size()
    return (int(virtual_rank) * int(pp_size) + int(pp_rank),
            int(pp_size) * int(vpp_size))


def build_gpt_pipeline(cfg: GPTPipeConfig, *, pp_rank: Optional[int] = None,
                       pp_size: Optional[int] = None, virtual_rank: int = 0,
                       vpp_size: int = 1, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> PipelineStageSpec:
    """Chunk ``virtual_rank`` of ``vpp_size`` of stage ``pp_rank`` of
    ``pp_size`` (``parallel_state``'s by default; one chunk without a
    virtual pipeline): its block, the embedding as ``first`` on the first
    global stage and the head as ``last`` on the last.  Microbatches are
    ``{"ids": [b, s], "labels": [b, s]}``."""
    stage, stages = _stage_coords(pp_rank, pp_size, virtual_rank, vpp_size)
    dev = resolve_device(device)
    kw = dict(device=dev, generator=generator)
    first = GPTPipeEmbed(cfg, **kw) if stage == 0 else None
    last = None
    if stage == stages - 1:
        last = GPTPipeHead(cfg, embedding=(first.word_embeddings
                                           if first is not None else None),
                           **kw)
    return PipelineStageSpec(stage=GPTPipeBlock(cfg, **kw), first=first,
                             last=last)


def init_gpt_pipeline_params(cfg: GPTPipeConfig, *, seed: int = 0,
                             pp_rank: Optional[int] = None,
                             pp_size: Optional[int] = None,
                             virtual_rank: int = 0, vpp_size: int = 1,
                             tp_rank: int = 0, tp_size: int = 1,
                             device="cuda") -> dict:
    """The ``state_dict`` of chunk ``virtual_rank`` of this (pp, tp) rank
    (:func:`build_gpt_pipeline`'s) of the GPT of ``layers_per_stage * pp
    * vpp`` layers drawn from ``torch.Generator(device).manual_seed(
    seed)`` (a whole ``TransformerLanguageModel``'s init, in
    ``cfg.params_dtype``, and a final LayerNorm): its global stage's
    entries (the last stage's word embeddings a copy of the first's), its
    tp slice (``convert.shard_gpt_state_dict``)."""
    from apex_tpu_torch.models.convert import shard_gpt_state_dict
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )

    stage, stages = _stage_coords(pp_rank, pp_size, virtual_rank, vpp_size)
    dev = resolve_device(device)
    lps = cfg.layers_per_stage
    whole = TransformerLanguageModel(
        lps * stages, cfg.hidden_size, cfg.num_attention_heads,
        cfg.vocab_size, cfg.max_sequence_length, apply_rope=cfg.apply_rope,
        params_dtype=cfg.params_dtype, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)).state_dict()
    lo, state = stage * lps, {}
    for name, t in whole.items():
        if name.startswith("transformer.layers."):
            idx, rest = name[len("transformer.layers."):].split(".", 1)
            if lo <= int(idx) < lo + lps:
                state[f"stage.layers.{int(idx) - lo}.{rest}"] = t
        elif name.startswith("transformer.final_layernorm."):
            if stage == stages - 1:
                state[name.replace("transformer.", "last.")] = t
        elif name.startswith("embedding."):
            if stage == 0:
                state[name.replace("embedding.", "first.")] = t
            if (stage == stages - 1 and stages > 1
                    and name.endswith("word_embeddings.weight")):
                state["last.word_embeddings.weight"] = t.clone()
    return shard_gpt_state_dict(state, tp_rank, tp_size)


def _word_embedding_copy(spec: PipelineStageSpec):
    """This stage's copy of the tied word embeddings, or None where there
    is no second copy (pp 1, where the head reads the first's, and the
    middle stages)."""
    first, last = spec.first, spec.last
    if first is not None and last is not None:
        return None
    if first is not None:
        return first.word_embeddings.weight
    if last is not None:
        return last.word_embeddings.weight
    return None


def sync_word_embeddings(spec: PipelineStageSpec, group=None) -> None:
    """Make the last stage's copy of the word embeddings the first stage's
    (a broadcast from the first stage over ``group``, the embedding
    group of ``parallel_state`` by default).  Nothing at pp 1."""
    weight = _word_embedding_copy(spec)
    if weight is None:
        return
    if group is None:
        from apex_tpu_torch.transformer import parallel_state as ps

        group = ps.get_embedding_group()
    with torch.no_grad():
        dist.broadcast(weight.data, dist.get_global_rank(group, 0),
                       group=group)


def allreduce_word_embedding_grads(spec: PipelineStageSpec,
                                   group=None) -> None:
    """Sum the gradients of the two copies of the word embeddings over
    ``group`` (``parallel_state``'s embedding group by default: the
    first and last stage of this rank's pipeline), in place; the JAX
    driver's ``psum`` of the embedding gradients over pp.  Nothing at pp
    1 (one parameter, whose gradient is already whole) and nothing on a
    middle stage."""
    weight = _word_embedding_copy(spec)
    if weight is None or weight.grad is None:
        return
    if group is None:
        from apex_tpu_torch.transformer import parallel_state as ps

        group = ps.get_embedding_group()
    dist.all_reduce(weight.grad, group=group)
