"""Llama pretraining driver: the counterpart of the 2-d ``dp x tp`` path of
``examples/llama/pretrain.py``.

    python -m apex_tpu_torch.examples.llama_pretrain [--layers 4] [--steps 10]
    python -m apex_tpu_torch.examples.llama_pretrain --device cpu
    torchrun --nproc-per-node 4 -m apex_tpu_torch.examples.llama_pretrain \\
        --device cpu --tp 2

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
averaged over the dp group (:func:`average_gradients`, the JAX step's
``pmean``), and FusedAdam updates the rank's shards.  Under ``--amp`` the
loss scaler is :class:`~apex_tpu_torch.transformer.amp.GradScaler`, whose
overflow flag is shared by the tp group.  Pipeline parallelism (``--pp``
> 1) raises: it comes with the port's ``pipeline_parallel``.

On the card the flash attention kernels take head dims 32, 64 and 128,
so the JAX trainer's defaults (hidden 128 over 4 heads, head dim 32) run
there; another head dim raises rather than falling back.
"""

from __future__ import annotations

import argparse
import contextlib
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
from apex_tpu_torch.transformer.tensor_parallel import (
    broadcast_data,
    tensor_parallel_region,
    tp_replicated_rows,
)

__all__ = ["o2_cast", "build_model", "average_gradients", "train_step",
           "amp_train_step", "main"]

_RECIPE = ("--tp needs one process a rank under torch.distributed: start it "
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


def average_gradients(params, group) -> None:
    """Each gradient summed over ``group`` and divided by its size, in
    place (the JAX step's ``pmean`` over ``dp``; gloo has no average):
    one all-reduce a dtype, over the gradients of that dtype flattened."""
    world = dist.get_world_size(group)
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        if world > 1:
            flat.div_(world)
        for g, f in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            g.copy_(f)


def _mean_over(loss: torch.Tensor, group) -> torch.Tensor:
    out = loss.detach().reshape(1).clone()
    dist.all_reduce(out, group=group)
    world = dist.get_world_size(group)
    return (out / world if world > 1 else out)[0]


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
        average_gradients(_params(opt), dp_group)
        loss = _mean_over(loss, dp_group)
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
        average_gradients(params, dp_group)
        loss = _mean_over(loss, dp_group)
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
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch; a multiple of dp = world / tp")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor parallel size: one process a rank under "
                         "torch.distributed (torchrun); unset, one process "
                         "at dp = tp = 1")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages; only 1 (pipeline_parallel is not "
                         "ported yet)")
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
    if args.pp > 1:
        raise NotImplementedError(
            f"--pp {args.pp}: pipeline parallelism comes with the port's "
            f"pipeline_parallel (NCCL point-to-point between stages); this "
            f"driver runs dp x tp")
    if args.o2 and args.amp:
        raise ValueError("--o2 (bf16) and --amp (fp16) are two precisions; "
                         "give one")
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


def _train(args, device: torch.device, group) -> float:
    cfg = LlamaConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        intermediate_size=args.ffn, num_hidden_layers=args.layers,
        num_attention_heads=args.heads, num_key_value_heads=args.kv_heads,
        max_position_embeddings=args.seq)
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

    first = last = None
    speak = group is None or dist.get_rank() == 0
    region = (tensor_parallel_region(group) if group is not None
              else contextlib.nullcontext())
    with region:
        for it in range(args.steps):
            last = float(step())
            first = last if first is None else first
            if speak and (it % 2 == 0 or it == args.steps - 1):
                print(f"step {it:3d}  loss {last:.4f}  dp={dp} tp={tp} "
                      f"device={device.type}", flush=True)
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if speak:
        print(f"llama pretrain OK: dp={dp} tp={tp}, loss {first:.4f} -> "
              f"{last:.4f}")
    return last


if __name__ == "__main__":
    main()
