"""Llama pretraining driver: the counterpart of ``examples/llama/pretrain.py``,
its 2-d ``dp x tp`` path and its 3-d ``dp x pp x tp`` one (``--pp``).

    python -m apex_tpu_torch.examples.llama_pretrain [--layers 4] [--steps 10]
    python -m apex_tpu_torch.examples.llama_pretrain --device cpu
    torchrun --nproc-per-node 4 -m apex_tpu_torch.examples.llama_pretrain \\
        --device cpu --tp 2
    torchrun --nproc-per-node 8 -m apex_tpu_torch.examples.llama_pretrain \\
        --device cpu --tp 2 --pp 2 --micro-batch 2

Synthetic next-token data: one fixed seeded batch, labels the ids rolled
by one, so the loss falls by memorisation (the JAX driver asserts the
same).  Each step is ``model(ids, labels=labels).mean()``, its backward
and a :class:`~apex_tpu_torch.optimizers.FusedAdam` update.  ``--o2``
applies the precision of ``bench.py``'s ``llama-1b`` card (:func:`o2_cast`
and bf16 optimizer moments); ``--amp`` trains in fp16 amp O2 instead
(fp32 masters, the dynamic loss scaler).

**Tensor parallelism** (``--tp N``, any N, 1 included): one process a
rank over ``torch.distributed``.  The driver takes the process group its
caller already started, else starts one from ``torchrun``'s environment
(NCCL on ``cuda``, gloo on ``cpu``), else raises with the ``torchrun``
recipe: it never falls back to one process.
``parallel_state.initialize_model_parallel(N)`` cuts the world into tp
groups of N and dp groups of ``world / N``.  Each rank builds its shard
of the model inside its tensor-parallel region and loads its slice of one
seeded init (:func:`build_model`), so every tp size trains the same
model.  Each rank takes its dp rows of the one fixed batch
(``tp_replicated_rows``), broadcast from its tp group's first rank
(``broadcast_data``); after the backward the gradients and the loss are
averaged over the dp group (``tensor_parallel.all_reduce_gradients``
and ``pipeline_parallel.utils.average_losses_across_data_parallel_group``,
the JAX step's ``pmean``), and FusedAdam updates the rank's shards.  Under ``--amp`` the
loss scaler is :class:`~apex_tpu_torch.transformer.amp.GradScaler`, whose
overflow flag is shared by the tp group.

**Pipeline parallelism** (``--pp N``, N > 1, exactly where the JAX driver
takes its ``main_3d``): ``initialize_model_parallel(tp, N)`` cuts the
world into dp x pp x tp in the JAX mesh's rank order (``--tp`` unset
means 1), the decoder is cut into N stages of ``--layers / N`` layers
(:mod:`apex_tpu_torch.models.llama_pipeline`, each stage its slice of the
same seeded init), and each step is
:func:`~apex_tpu_torch.models.llama_pipeline.make_llama_3d_train_step`
over the 1F1B schedule: ``--n-micro`` microbatches of ``--micro-batch``
rows a dp rank, so the global batch is ``micro-batch x dp x n-micro``
(``--batch`` with ``--pp`` raises).  Sequence parallelism is on when tp >
1, with the sequence-parallel gradients summed over tp (the JAX step
leaves them partial).  ``--o2`` and ``--amp`` apply to the stages as to
the 2-d model.

On the card the flash attention kernels take head dims 32, 64 and 128,
so the JAX trainer's defaults (hidden 128 over 4 heads, head dim 32) run
there; another head dim raises rather than falling back.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from apex_tpu_torch.models.convert import shard_state_dict
from apex_tpu_torch.models.llama import validate_tp_divisibility
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    average_losses_across_data_parallel_group,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    all_reduce_gradients,
    broadcast_data,
    tensor_parallel_region,
    tp_replicated_rows,
)

__all__ = ["o2_cast", "build_model", "train_step", "amp_train_step", "main"]

_RECIPE = ("--tp and --pp need one process a rank under torch.distributed: "
           "start it "
           "with torchrun, e.g. `torchrun --nproc-per-node 4 -m "
           "apex_tpu_torch.examples.llama_pretrain --device cpu --tp 2` "
           "(gloo on the CPU; NCCL with --device cuda, one card a process), "
           "or call main() from a process that has already called "
           "torch.distributed.init_process_group")


def o2_cast(model: torch.nn.Module,
            dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """``bench.py``'s O2 cast, in place: every fp32 parameter of two or
    more dims (embedding, projections, head) to ``dtype``; the rest (the
    RMSNorm scales) stay fp32.  Returns the model."""
    for p in model.parameters():
        if p.dtype == torch.float32 and p.dim() >= 2:
            p.data = p.data.to(dtype)
    return model


def build_model(config: LlamaConfig, *, device, seed: int,
                group=None) -> LlamaForCausalLM:
    """The fp32 model drawn from ``torch.Generator(device).manual_seed(
    seed)``; with a tensor-parallel ``group``, this rank's shard of that
    same model, built inside the group's region (its slice of the whole
    ``state_dict``, :func:`~apex_tpu_torch.models.convert.
    shard_state_dict`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    whole = LlamaForCausalLM(config, device=device, generator=gen)
    if group is None:
        return whole
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    validate_tp_divisibility(config, size)
    with tensor_parallel_region(group):
        shard = LlamaForCausalLM(config, device=device)
    shard.load_state_dict(shard_state_dict(whole.state_dict(), rank, size))
    return shard


def _params(opt: torch.optim.Optimizer) -> list:
    return [p for g in opt.param_groups for p in g["params"]]


def _average_over_dp(params, loss, group) -> torch.Tensor:
    """The gradients of ``params`` averaged over ``group`` in place (one
    all-reduce a dtype) and the mean of ``loss`` over it: the JAX step's
    ``pmean`` over ``dp``."""
    all_reduce_gradients([p.grad for p in params if p.grad is not None],
                         group, average=True)
    return average_losses_across_data_parallel_group([loss], group)[0]


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               ids: torch.Tensor, *, dp_group=None) -> torch.Tensor:
    """One step on ``ids [b, s]``: labels are the ids rolled by one; the
    mean per-token loss, its backward, with ``dp_group`` the gradients and
    the loss averaged over it, one optimizer update.  Returns the loss
    (detached, on the model's device).  A sharded model is called inside
    its tensor-parallel region, by the caller."""
    labels = torch.roll(ids, -1, dims=1)
    opt.zero_grad(set_to_none=True)
    loss = model(ids, labels=labels).mean()
    loss.backward()
    loss = loss.detach()
    if dp_group is not None:
        loss = _average_over_dp(_params(opt), loss, dp_group)
    opt.step()
    return loss


def amp_train_step(amped: amp.AmpState, opt: torch.optim.Optimizer,
                   ids: torch.Tensor, scaler, state, *, dp_group=None):
    """One amp step (``examples/simple``'s flow): the mean loss scaled in
    fp32, its backward, with ``dp_group`` the gradients and the loss
    averaged over it, ``found_inf`` (shared by the tp group under a
    :class:`GradScaler`), the update with ``grad_scale`` and
    ``found_inf``, the scaler's update.  Returns ``(loss, found_inf,
    state)``, device tensors: nothing is read on the host."""
    labels = torch.roll(ids, -1, dims=1)
    opt.zero_grad(set_to_none=True)
    loss = amped.model(ids, labels=labels).mean()
    scaler.scale_loss(loss, state).backward()
    loss = loss.detach()
    params = _params(opt)
    if dp_group is not None:
        loss = _average_over_dp(params, loss, dp_group)
    found_inf = scaler.has_overflow([p.grad for p in params])
    opt.step(grad_scale=state.scale, found_inf=found_inf)
    return loss, found_inf, scaler.update(state, found_inf)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="On the card the flash attention kernels take head dims 32, "
               "64 and 128; another head dim raises there.")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--ffn", type=int, default=352)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (2-d path; default 8), a multiple of "
                         "dp = world / tp.  With --pp > 1 the global batch "
                         "is micro-batch * dp * n-micro: passing --batch "
                         "there is an error")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor parallel size: one process a rank under "
                         "torch.distributed (torchrun); unset, one process "
                         "at dp = tp = 1")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages; > 1 uses the 1F1B schedule over a "
                         "dp x pp x tp world (one process a rank)")
    ap.add_argument("--micro-batch", type=int, default=2,
                    help="per-rank microbatch (pp > 1 only)")
    ap.add_argument("--n-micro", type=int, default=4,
                    help="microbatches per step (pp > 1 only)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--o2", action="store_true",
                    help="bf16 2-d parameters (norm scales fp32) and bf16 "
                         "Adam moments, as bench.py's llama-1b card")
    ap.add_argument("--amp", action="store_true",
                    help="fp16 amp O2: fp32 masters, the dynamic loss "
                         "scaler (GradScaler under --tp)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


@contextlib.contextmanager
def _process_group(device_arg: str):
    """The caller's process group, else one started from torchrun's
    environment (destroyed after), else a RuntimeError with the recipe."""
    if dist.is_available() and dist.is_initialized():
        yield
        return
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                  "MASTER_PORT")):
        raise RuntimeError("no torch.distributed world: " + _RECIPE)
    cuda = torch.device(device_arg).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train ``--steps`` steps and return the last loss; raises unless it
    is finite and below the first."""
    args = _parser().parse_args(argv)
    if args.o2 and args.amp:
        raise ValueError("--o2 (bf16) and --amp (fp16) are two precisions; "
                         "give one")
    if args.pp > 1:
        if args.batch is not None:
            raise ValueError(
                "--batch applies to the 2-d path only; with --pp the global "
                "batch is --micro-batch * dp * --n-micro")
        if args.layers % args.pp:
            raise ValueError(f"--layers {args.layers} must divide by --pp "
                             f"{args.pp}")
        with _process_group(args.device):
            device = resolve_device(args.device)
            parallel_state.check_group_device(None, device)
            parallel_state.initialize_model_parallel(args.tp or 1, args.pp)
            try:
                return _train_3d(args, device)
            finally:
                parallel_state.destroy_model_parallel()
    if args.batch is None:
        args.batch = 8
    if args.tp is None:
        return _train(args, resolve_device(args.device), None)
    with _process_group(args.device):
        device = resolve_device(args.device)
        parallel_state.check_group_device(None, device)
        parallel_state.initialize_model_parallel(args.tp)
        try:
            return _train(args, device,
                          parallel_state.get_tensor_model_parallel_group())
        finally:
            parallel_state.destroy_model_parallel()


def _config(args) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        intermediate_size=args.ffn, num_hidden_layers=args.layers,
        num_attention_heads=args.heads, num_key_value_heads=args.kv_heads,
        max_position_embeddings=args.seq)


def _report(losses_fn, steps: int, speak: bool, label: str) -> float:
    """Run ``steps`` steps (``losses_fn()`` one step's loss), print every
    other, and raise unless the last loss is finite and below the
    first."""
    first = last = None
    for it in range(steps):
        last = float(losses_fn())
        first = last if first is None else first
        if speak and (it % 2 == 0 or it == steps - 1):
            print(f"step {it:3d}  loss {last:.4f}  {label}", flush=True)
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if speak:
        print(f"llama pretrain OK: {label.rsplit(' device', 1)[0]}, loss "
              f"{first:.4f} -> {last:.4f}")
    return last


def _train_3d(args, device: torch.device) -> float:
    """The port of the JAX driver's ``main_3d``: the 1F1B step of
    :func:`make_llama_3d_train_step` on this rank's stage."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models.llama_pipeline import (
        LlamaPipeConfig,
        make_llama_3d_train_step,
    )
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_1f1b,
    )

    cfg = _config(args)
    sizes = parallel_state.mesh_axis_sizes()
    dp, pp, tp = sizes["dp"], sizes["pp"], sizes["tp"]
    validate_tp_divisibility(cfg, tp)
    pcfg = LlamaPipeConfig(config=cfg, layers_per_stage=args.layers // pp,
                           sequence_parallel_enabled=tp > 1)
    kw, scaler = {}, None
    if args.amp:
        policy = get_policy("O2", half_dtype=torch.float16)
        scaler = GradScaler.from_scaler(policy.make_scaler())
        kw = dict(cast=policy.cast_params, grad_scaler=scaler)
        opt = functools.partial(FusedAdam, lr=args.lr, master_weights=True)
    elif args.o2:
        kw = dict(cast=o2_cast)
        opt = functools.partial(FusedAdam, lr=args.lr,
                                state_dtype=torch.bfloat16)
    else:
        opt = functools.partial(FusedAdam, lr=args.lr)
    init_fn, train_step = make_llama_3d_train_step(
        pcfg, opt, forward_backward_pipelining_1f1b, device=device, **kw)
    spec, optimizer = init_fn(args.seed)
    rng = np.random.default_rng(args.seed)
    ids = rng.integers(0, args.vocab,
                       (args.n_micro, args.micro_batch * dp, args.seq))
    rows = slice(parallel_state.get_data_parallel_rank() * args.micro_batch,
                 (parallel_state.get_data_parallel_rank() + 1)
                 * args.micro_batch)
    batches = {"ids": torch.from_numpy(ids[:, rows]).to(device),
               "labels": torch.from_numpy(
                   np.roll(ids, -1, axis=-1)[:, rows]).to(device)}
    state = scaler.init(device) if scaler is not None else None

    def step():
        nonlocal state
        if scaler is None:
            return train_step(spec, optimizer, batches)
        loss, _, state = train_step(spec, optimizer, batches, state)
        return loss

    return _report(step, args.steps, dist.get_rank() == 0,
                   f"dp={dp} pp={pp} tp={tp} device={device.type}")


def _train(args, device: torch.device, group) -> float:
    cfg = _config(args)
    dp, tp, dp_group = 1, 1, None
    if group is not None:
        dp = parallel_state.get_data_parallel_world_size()
        tp = parallel_state.get_tensor_model_parallel_world_size()
        dp_group = parallel_state.get_data_parallel_group()
        if args.batch % dp:
            raise ValueError(f"--batch {args.batch} must be a multiple of "
                             f"dp={dp}")
    model = build_model(cfg, device=device, seed=args.seed, group=group)
    rng = np.random.default_rng(args.seed)
    batch = torch.from_numpy(
        rng.integers(0, args.vocab, (args.batch, args.seq)))
    ids = broadcast_data(["ids"], {"ids": tp_replicated_rows(batch)},
                         torch.int64, group, device=device)["ids"]
    if args.amp:
        amped = amp.initialize(model, "O2", half_dtype=torch.float16)
        scaler, state = amped.scaler, amped.scaler_state
        if group is not None:
            scaler = GradScaler.from_scaler(scaler)
        opt = FusedAdam(model.parameters(), lr=args.lr, master_weights=True)

        def step():
            nonlocal state
            loss, _, state = amp_train_step(amped, opt, ids, scaler, state,
                                            dp_group=dp_group)
            return loss
    else:
        state_dtype = torch.float32
        if args.o2:
            o2_cast(model)
            state_dtype = torch.bfloat16
        opt = FusedAdam(model.parameters(), lr=args.lr,
                        state_dtype=state_dtype)

        def step():
            return train_step(model, opt, ids, dp_group=dp_group)

    speak = group is None or dist.get_rank() == 0
    region = (tensor_parallel_region(group) if group is not None
              else contextlib.nullcontext())
    with region:
        return _report(step, args.steps, speak,
                       f"dp={dp} tp={tp} device={device.type}")


if __name__ == "__main__":
    main()
