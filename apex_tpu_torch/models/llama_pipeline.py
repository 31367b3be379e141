"""Pipeline-parallel stages of the Llama decoder (counterpart of
``apex_tpu/models/llama_pipeline.py``).

The stages are the JAX module's: the vocab-parallel embedding (the first
stage's input adapter), ``layers_per_stage`` :class:`~apex_tpu_torch.
models.llama.LlamaDecoderLayer` blocks (every stage's body), and the
final RMSNorm + vocab-sharded LM head + vocab-parallel cross entropy (the
last stage's loss).  The head is :func:`~apex_tpu_torch.transformer.
tensor_parallel.parallel_lm_logits` with :func:`~apex_tpu_torch.
transformer.tensor_parallel.vocab_parallel_cross_entropy`, as in JAX, and
never the fused LM head that ``LlamaForCausalLM`` takes at tp 1.  The
wire between stages is ``[s, b, h]`` (``[s / tp, b, h]`` under sequence
parallelism) in the projections' dtype.

**Each stage holds what it runs.**  The JAX stage keeps the embedding and
the head on every pp rank and ``psum``s their gradients over pp; off
their owner those gradients are zero (the first stage's output is masked
by ``rank == 0`` and the loss seed is zero off the last rank), so the
owner's gradient is the sum.  Here the embedding lives on the first
stage only and the norm and head on the last (:func:`build_llama_pipeline`),
and no pp reduction is needed.  A stage's ``state_dict`` names are
``first.*``, ``stage.layers.<i>.*`` (``i`` counted within the stage) and
``last.*`` (:meth:`~apex_tpu_torch.transformer.pipeline_parallel.
PipelineStageSpec.named_parameters`).

:func:`init_llama_pipeline_params` slices one seeded whole
``LlamaForCausalLM`` init (``llama_pretrain.build_model``'s), so a
pipeline of any pp and tp trains the same model as the 2-d driver;
:func:`~apex_tpu_torch.models.convert.llama_pipeline_params_from_jax`
carries a JAX stage's weights over.  :func:`make_llama_3d_train_step` is
the dp x pp x tp step of ``examples/llama/pretrain.py --pp``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaDecoderLayer,
    _rope_freqs,
    mark_sequence_parallel,
)
from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
    grads_by_param,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    average_losses_across_data_parallel_group,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding,
    all_reduce_gradients,
    allreduce_sequence_parallel_grads,
    divide,
    parallel_lm_logits,
    scatter_to_sequence_parallel_region,
    shard_init,
    tensor_parallel_region,
    tp_world_size,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import normal_

__all__ = ["LlamaPipeConfig", "build_llama_pipeline",
           "init_llama_pipeline_params", "make_llama_3d_train_step"]


@dataclasses.dataclass(frozen=True)
class LlamaPipeConfig:
    config: LlamaConfig
    layers_per_stage: int = 2
    sequence_parallel_enabled: bool = False
    params_dtype: torch.dtype = torch.float32


class LlamaPipeEmbed(nn.Module):
    """The first stage's adapter: ids ``{"ids": [b, s]}`` -> the wire."""

    def __init__(self, pcfg: LlamaPipeConfig, *, device, generator=None):
        super().__init__()
        cfg = pcfg.config
        self.sp = pcfg.sequence_parallel_enabled
        self.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, dtype=pcfg.params_dtype,
            device=device, generator=generator)

    def forward(self, mb):
        # [b, s, h] -> [s, b, h]; the norm kernel takes contiguous input
        x = self.embed_tokens(mb["ids"]).transpose(0, 1).contiguous()
        return scatter_to_sequence_parallel_region(x) if self.sp else x


class LlamaPipeBlock(nn.Module):
    """A stage's ``layers_per_stage`` decoder layers."""

    def __init__(self, pcfg: LlamaPipeConfig, *, device, generator=None):
        super().__init__()
        cfg = self.config = pcfg.config
        self.sp = pcfg.sequence_parallel_enabled
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg, dtype=pcfg.params_dtype, device=device,
                              generator=generator,
                              sequence_parallel_enabled=self.sp)
            for _ in range(pcfg.layers_per_stage))

    def forward(self, x):
        cfg = self.config
        # the rope positions span the whole sequence, which the column
        # linears gather under sequence parallelism
        s = x.shape[0] * (tp_world_size() if self.sp else 1)
        freqs = _rope_freqs(s, cfg.hidden_size // cfg.num_attention_heads,
                            cfg.rope_theta, device=x.device)
        for layer in self.layers:
            x = layer(x, freqs)
        return x


class LlamaPipeHead(nn.Module):
    """The last stage: final RMSNorm, the vocab-sharded head, the mean
    vocab-parallel cross entropy against ``mb["labels"] [b, s]``."""

    def __init__(self, pcfg: LlamaPipeConfig, *, device, generator=None):
        super().__init__()
        cfg = pcfg.config
        self.sp = pcfg.sequence_parallel_enabled
        dev = resolve_device(device)
        self.norm = FusedRMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                 dtype=pcfg.params_dtype, device=dev)
        if self.sp:
            mark_sequence_parallel(self.norm)
        self.lm_head = nn.Parameter(normal_(
            (divide(cfg.vocab_size, tp_world_size()), cfg.hidden_size), 0.02,
            dtype=pcfg.params_dtype, device=dev,
            generator=shard_init(generator, dev)))

    def forward(self, y, mb):
        y = self.norm(y)
        logits = parallel_lm_logits(y, self.lm_head.to(y.dtype),
                                    sequence_parallel_enabled=self.sp)
        return vocab_parallel_cross_entropy(logits.transpose(0, 1),
                                            mb["labels"]).mean()


def _pp_coords(pp_rank, pp_size):
    if pp_rank is None or pp_size is None:
        from apex_tpu_torch.transformer import parallel_state as ps

        pp_rank = ps.get_pipeline_model_parallel_rank()
        pp_size = ps.get_pipeline_model_parallel_world_size()
    return int(pp_rank), int(pp_size)


def build_llama_pipeline(pcfg: LlamaPipeConfig, *, pp_rank: Optional[int] = None,
                         pp_size: Optional[int] = None, device="cuda",
                         generator: Optional[torch.Generator] = None
                         ) -> PipelineStageSpec:
    """Stage ``pp_rank`` of ``pp_size`` (``parallel_state``'s by default)
    as a :class:`PipelineStageSpec`: its block, with the embedding as
    ``first`` on the first stage and the head as ``last`` on the last.
    Built inside a tensor-parallel region, each module is the rank's tp
    shard.  Microbatches are ``{"ids": [b, s], "labels": [b, s]}``."""
    pp_rank, pp_size = _pp_coords(pp_rank, pp_size)
    dev = resolve_device(device)
    kw = dict(device=dev, generator=generator)
    return PipelineStageSpec(
        stage=LlamaPipeBlock(pcfg, **kw),
        first=LlamaPipeEmbed(pcfg, **kw) if pp_rank == 0 else None,
        last=LlamaPipeHead(pcfg, **kw) if pp_rank == pp_size - 1 else None)


def _stage_state_dict(whole: dict, pcfg: LlamaPipeConfig, pp_rank: int,
                     pp_size: int) -> dict:
    """Stage ``pp_rank``'s entries of a whole ``LlamaForCausalLM``
    ``state_dict`` of ``layers_per_stage * pp_size`` layers, under the
    stage's names (the embedding on the first stage, the norm and head on
    the last, layer ``pp_rank * layers_per_stage + i`` as the stage's
    ``i``)."""
    lps = pcfg.layers_per_stage
    lo = pp_rank * lps
    out = {}
    for name, t in whole.items():
        if name.startswith("layers."):
            idx, rest = name[len("layers."):].split(".", 1)
            if lo <= int(idx) < lo + lps:
                out[f"stage.layers.{int(idx) - lo}.{rest}"] = t
        elif name.startswith("embed_tokens."):
            if pp_rank == 0:
                out[f"first.{name}"] = t
        elif pp_rank == pp_size - 1:
            out[f"last.{name}"] = t
    return out


def init_llama_pipeline_params(pcfg: LlamaPipeConfig, *, seed: int = 0,
                               pp_rank: Optional[int] = None,
                               pp_size: Optional[int] = None,
                               tp_rank: int = 0, tp_size: int = 1,
                               device="cuda") -> dict:
    """This (pp, tp) rank's ``state_dict`` of the fp32 ``LlamaForCausalLM``
    of ``layers_per_stage * pp_size`` layers drawn from
    ``torch.Generator(device).manual_seed(seed)`` (the init of
    ``llama_pretrain.build_model``): its stage's entries, its tp slice."""
    from apex_tpu_torch.models.convert import shard_state_dict
    from apex_tpu_torch.models.llama import LlamaForCausalLM

    pp_rank, pp_size = _pp_coords(pp_rank, pp_size)
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        pcfg.config, num_hidden_layers=pcfg.layers_per_stage * pp_size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    whole = LlamaForCausalLM(cfg, device=dev, generator=gen).state_dict()
    state = _stage_state_dict(whole, pcfg, pp_rank, pp_size)
    if tp_size == 1:
        return state
    return shard_state_dict(state, tp_rank, tp_size)


def _wire_dtype(spec: PipelineStageSpec) -> torch.dtype:
    """The activations' dtype: that of the stage's projections (the
    embedding and the projections are cast alike)."""
    return next(p.dtype for p in spec.stage.parameters() if p.dim() >= 2)


def make_llama_3d_train_step(pcfg: LlamaPipeConfig, opt: Callable, schedule,
                             *, device="cuda", grad_scaler=None,
                             cast: Optional[Callable] = None):
    """``(init_fn, train_step)`` for a dp x pp x tp world cut by
    ``parallel_state.initialize_model_parallel(tp, pp)``.

    - ``init_fn(seed=0, state=None) -> (spec, optimizer)``: this rank's
      stage (:func:`build_llama_pipeline`, inside its tensor-parallel
      region), loaded with ``state`` or with its slice of the seeded init
      (:func:`init_llama_pipeline_params`), then ``cast`` applied to each
      stage module (``llama_pretrain.o2_cast``, say), then
      ``opt(parameters)`` (a ``FusedAdam`` factory, say).
    - ``train_step(spec, optimizer, batches, scaler_state=None)`` with
      ``batches = {"ids", "labels"}`` of ``[n_micro, b, s]``: the
      ``schedule`` (any pipeline schedule, or ``get_forward_backward_func
      (None, 1)``) inside the tensor-parallel region; the
      sequence-parallel gradients summed over tp
      (:func:`~apex_tpu_torch.transformer.tensor_parallel.
      allreduce_sequence_parallel_grads`; the JAX step leaves them
      partial); the gradients and the loss averaged over dp
      (``all_reduce_gradients(average=True)`` and
      ``average_losses_across_data_parallel_group``, the JAX step's
      ``pmean``);
      the optimizer's step, from the gradients the schedule returned
      (``FusedOptimizer.step(grads=)``: ``.grad``, or the fp32 microbatch
      sums of ``forward_backward_no_pipelining``, checked by the
      scaler before any cast, as JAX's are).  The embedding and head gradients need no
      reduction over pp: each lives on its one stage.  Returns the loss;
      with ``grad_scaler`` (a :class:`~apex_tpu_torch.transformer.amp.
      GradScaler`) ``(loss, found_inf, new_scaler_state)``, the
      optimizer stepping with ``grad_scale`` and the flag shared by the
      model-parallel group, nothing read on the host."""
    from apex_tpu_torch.transformer import parallel_state as ps

    dev = resolve_device(device)

    def init_fn(seed: int = 0, state: Optional[dict] = None):
        tp_group = ps.get_tensor_model_parallel_group()
        with tensor_parallel_region(tp_group):
            spec = build_llama_pipeline(pcfg, device=dev)
        if state is None:
            state = init_llama_pipeline_params(
                pcfg, seed=seed, tp_rank=dist.get_rank(tp_group),
                tp_size=dist.get_world_size(tp_group), device=dev)
        nn.ModuleDict(spec.modules()).load_state_dict(state)
        if cast is not None:
            for module in spec.modules().values():
                cast(module)
        return spec, opt(spec.parameters())

    def train_step(spec, optimizer, batches, scaler_state=None):
        tp_group = ps.get_tensor_model_parallel_group()
        dp_group = ps.get_data_parallel_group()
        ids = batches["ids"]
        s = ids.shape[-1] // (dist.get_world_size(tp_group)
                              if pcfg.sequence_parallel_enabled else 1)
        with tensor_parallel_region(tp_group):
            loss, grads = schedule(
                spec, batches, grad_scaler=grad_scaler,
                scaler_state=scaler_state,
                group=ps.get_pipeline_model_parallel_group(),
                tensor_shape=(s, ids.shape[1], pcfg.config.hidden_size),
                dtype=_wire_dtype(spec))
        # what the schedule returned: .grad, or at pp 1 the fp32 sums
        grads = grads_by_param(spec, grads)
        allreduce_sequence_parallel_grads(spec.parameters(), tp_group,
                                          grads=grads)
        all_reduce_gradients(list(grads.values()), dp_group, average=True)
        loss = average_losses_across_data_parallel_group([loss], dp_group)[0]
        if grad_scaler is None:
            optimizer.step(grads=grads)
            return loss
        found_inf = grad_scaler.has_overflow(list(grads.values()))
        optimizer.step(grad_scale=scaler_state.scale, found_inf=found_inf,
                       grads=grads)
        return loss, found_inf, grad_scaler.update(scaler_state, found_inf)

    return init_fn, train_step
