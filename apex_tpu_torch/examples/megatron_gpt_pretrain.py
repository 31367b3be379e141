"""Megatron-style GPT pretraining on a dp x pp x tp world: the counterpart
of the repo's ``examples/gpt/pretrain.py``.  (:mod:`~apex_tpu_torch.
examples.gpt_pretrain` is ``bench.py``'s GPT step, a different driver.)

    python -m apex_tpu_torch.examples.megatron_gpt_pretrain \\
        --num-layers 4 --hidden-size 128 --num-attention-heads 2 \\
        --seq-length 128 --max-position-embeddings 128 --vocab-size 512 \\
        --micro-batch-size 2 --global-batch-size 8 --lr 1e-3 \\
        --train-iters 10 --bf16
    torchrun --nproc-per-node 8 -m apex_tpu_torch.examples.megatron_gpt_pretrain \\
        --device cpu --num-layers 4 --hidden-size 64 \\
        --num-attention-heads 4 --seq-length 32 --max-position-embeddings 32 \\
        --vocab-size 256 --micro-batch-size 2 --global-batch-size 16 \\
        --lr 1e-3 --train-iters 10 \\
        --tensor-model-parallel-size 2 --pipeline-model-parallel-size 2

The pieces the reference spreads over Megatron-LM's ``pretrain_gpt.py``
and apex's testing harness: the Megatron flags
(:mod:`~apex_tpu_torch.transformer.testing.arguments`, plus the port's
``--device``: ``cuda`` by default, ``cpu`` when asked), the global
singletons (microbatch calculator, timers), the GPT cut into pipeline
stages (:mod:`~apex_tpu_torch.transformer.testing.commons`), the schedule
of ``get_forward_backward_func(vpp, pp)`` and the fused optimizer of
``--optimizer``.  One process a rank over ``torch.distributed``: the
caller's process group, else one from ``torchrun``'s environment, else a
world of this one process over a ``file://`` rendezvous in a temporary
directory (NCCL on ``cuda``, gloo on ``cpu``).  The world is cut into dp x
pp x tp (``parallel_state.initialize_model_parallel``); sequence
parallelism is on at tp > 1.  With ``--num-layers-per-virtual-pipeline-
stage`` each rank holds ``vpp`` model chunks of that many layers
(``commons.build_gpt_pipeline``'s ``virtual_rank``) and the schedule is
the interleaved 1F1B; the JAX driver passes its one stage spec to that
schedule without ``num_model_chunks`` and stops there.

A step, as the JAX driver's: the schedule over this rank's stage inside
its tensor-parallel region; the sequence-parallel gradients summed over
tp (the JAX step leaves them partial: ``tensor_parallel.
allreduce_sequence_parallel_grads``); the two copies of the tied word
embeddings' gradients summed over the embedding group (the JAX driver's
``psum`` over pp: ``commons.allreduce_word_embedding_grads``); every
gradient and the loss averaged over dp; the optimizer's step.  The
synthetic batches are the JAX driver's numpy stream: ``default_rng(seed)``
draws ``(n_micro, micro_batch * dp, seq)`` ids each iteration (one draw
first, which the JAX driver spends on its init), labels the ids rolled by
one, and each dp rank takes its rows.  ``get_num_microbatches()`` is read
again every iteration: ``--rampup-batch-size`` changes it.

:func:`main` takes, for tests and measurements, this rank's initial stage
``state_dict`` (``init_state``, e.g. JAX's weights through
:func:`~apex_tpu_torch.models.convert.gpt_pipeline_params_from_jax`) in
place of the seeded init (a list of them, one a chunk, under a virtual
pipeline), and ``on_iteration(it, loss, model)``, called after each
iteration with the rank's stage spec (the list of its chunks' specs
under a virtual pipeline).
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.examples.imagenet_main import _process_group
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedNovoGrad,
    FusedSGD,
)
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    grads_by_param,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    average_losses_across_data_parallel_group,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    all_reduce_gradients,
    allreduce_sequence_parallel_grads,
    tensor_parallel_region,
)
from apex_tpu_torch.transformer.testing import (
    destroy_global_vars,
    get_num_microbatches,
    get_timers,
    set_global_variables,
    update_num_microbatches,
)
from apex_tpu_torch.transformer.testing.commons import (
    GPTPipeConfig,
    allreduce_word_embedding_grads,
    build_gpt_pipeline,
    init_gpt_pipeline_params,
    sync_word_embeddings,
)

__all__ = ["OPTIMIZERS", "main"]

OPTIMIZERS = {"adam": FusedAdam, "sgd": FusedSGD, "lamb": FusedLAMB,
              "novograd": FusedNovoGrad, "adagrad": FusedAdagrad}


def _add_device_arg(parser: argparse.ArgumentParser):
    g = parser.add_argument_group(title="device")
    g.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return parser


def main(args_list: Optional[Sequence[str]] = None, *,
         init_state: Optional[dict] = None,
         on_iteration: Optional[Callable] = None) -> float:
    """Train ``--train-iters`` iterations (10 by default) and return the
    last loss; raises unless it is finite.  ``args_list`` defaults to
    ``sys.argv[1:]``."""
    argv = list(sys.argv[1:] if args_list is None else args_list)
    device = resolve_device(_add_device_arg(argparse.ArgumentParser(
        add_help=False)).parse_known_args(argv)[0].device)
    with _process_group(device):
        args = set_global_variables(extra_args_provider=_add_device_arg,
                                    args_list=argv, ignore_unknown_args=True,
                                    device=device)
        try:
            parallel_state.check_group_device(None, device)
            parallel_state.initialize_model_parallel(
                args.tensor_model_parallel_size,
                args.pipeline_model_parallel_size,
                args.virtual_pipeline_model_parallel_size)
            try:
                return _train(args, device, init_state, on_iteration)
            finally:
                parallel_state.destroy_model_parallel()
        finally:
            destroy_global_vars()


def _train(args, device, init_state, on_iteration) -> float:
    tp = args.tensor_model_parallel_size
    pp = args.pipeline_model_parallel_size
    dp = args.data_parallel_size
    if args.num_layers % pp:
        raise ValueError(f"--num-layers ({args.num_layers}) must divide by "
                         f"pipeline stages ({pp})")
    for flag in ("seq_length", "vocab_size", "lr"):
        if getattr(args, flag) is None:
            raise ValueError(f"--{flag.replace('_', '-')} is required")
    vpp = args.virtual_pipeline_model_parallel_size
    cfg = GPTPipeConfig(
        vocab_size=args.vocab_size, hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        layers_per_stage=(args.num_layers_per_virtual_pipeline_stage if vpp
                          else args.num_layers // pp),
        max_sequence_length=args.seq_length,
        sequence_parallel_enabled=args.sequence_parallel or tp > 1,
        params_dtype=args.params_dtype)
    tp_group = parallel_state.get_tensor_model_parallel_group()
    pp_group = parallel_state.get_pipeline_model_parallel_group()
    dp_group = parallel_state.get_data_parallel_group()
    n_chunks = vpp or 1
    with tensor_parallel_region(tp_group):
        chunks = [build_gpt_pipeline(cfg, virtual_rank=v, vpp_size=n_chunks,
                                     device=device)
                  for v in range(n_chunks)]
    if init_state is None:
        init_state = [init_gpt_pipeline_params(
            cfg, seed=args.seed, virtual_rank=v, vpp_size=n_chunks,
            tp_rank=dist.get_rank(tp_group), tp_size=tp, device=device)
            for v in range(n_chunks)]
    elif isinstance(init_state, dict):
        init_state = [init_state]
    for spec, state in zip(chunks, init_state, strict=True):
        nn.ModuleDict(spec.modules()).load_state_dict(state)
        sync_word_embeddings(spec)
    # the schedule's model: the spec, or the list of chunks with their count
    model, chunk_kw = ((chunks, {"num_model_chunks": vpp}) if vpp
                       else (chunks[0], {}))
    fwd_bwd = get_forward_backward_func(vpp, pp)
    opt_kwargs = {"lr": args.lr}
    if args.optimizer in ("adam", "lamb"):
        opt_kwargs.update(betas=(args.adam_beta1, args.adam_beta2),
                          eps=args.adam_eps, weight_decay=args.weight_decay)
    params = [p for spec in chunks for p in spec.parameters()]
    opt = OPTIMIZERS[args.optimizer](params, **opt_kwargs)

    mb, s = args.micro_batch_size, args.seq_length
    wire = (s // tp if cfg.sequence_parallel_enabled else s, mb,
            cfg.hidden_size)
    rows = slice(parallel_state.get_data_parallel_rank() * mb,
                 (parallel_state.get_data_parallel_rank() + 1) * mb)
    rng = np.random.default_rng(args.seed)

    def synth_batches():
        # re-read each call: --rampup-batch-size grows the count between
        # iterations
        ids = rng.integers(0, args.vocab_size,
                           (get_num_microbatches(), mb * dp, s))
        return {"ids": torch.from_numpy(ids[:, rows]).to(device),
                "labels": torch.from_numpy(
                    np.roll(ids, -1, axis=-1)[:, rows]).to(device)}

    def train_step(batches):
        with tensor_parallel_region(tp_group):
            loss, grads = fwd_bwd(model, batches, group=pp_group,
                                  tensor_shape=wire, dtype=cfg.params_dtype,
                                  **chunk_kw)
        # what the schedule returned: .grad, or at pp 1 the fp32 sums
        grads = grads_by_param(model, grads)
        allreduce_sequence_parallel_grads(params, tp_group, grads=grads)
        for spec in chunks:
            allreduce_word_embedding_grads(spec)
        all_reduce_gradients(list(grads.values()), dp_group, average=True)
        loss = average_losses_across_data_parallel_group([loss], dp_group)[0]
        opt.step(grads=grads)
        return loss

    speak = dist.get_rank() == 0
    timers = get_timers()
    synth_batches()    # the JAX driver's init draw
    iters = args.train_iters or 10
    consumed, loss = 0, float("nan")
    for it in range(iters):
        with timers("iteration").timing():
            loss = float(train_step(synth_batches()))
        consumed += get_num_microbatches() * mb * dp
        update_num_microbatches(consumed, consistency_check=False)
        if speak and (it % max(1, args.log_interval // 10) == 0
                      or it == iters - 1):
            print(f"iter {it:4d}  loss {loss:.4f}  "
                  f"({timers.log(['iteration'])})", flush=True)
        if on_iteration is not None:
            on_iteration(it, loss, model)
    if not math.isfinite(loss):
        raise AssertionError(f"final loss {loss} is not finite")
    if speak:
        print(f"pretrain OK: dp={dp} pp={pp} tp={tp}, final loss {loss:.4f}",
              flush=True)
    return loss


if __name__ == "__main__":
    main()
