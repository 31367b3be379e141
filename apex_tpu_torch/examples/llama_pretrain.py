"""Llama pretraining driver at dp = tp = 1: the counterpart of the 2-d path
of ``examples/llama/pretrain.py``, on one card.

    python -m apex_tpu_torch.examples.llama_pretrain [--layers 4] [--steps 10]
    python -m apex_tpu_torch.examples.llama_pretrain --device cpu

Synthetic next-token data: one fixed seeded batch, labels the ids rolled
by one, so the loss falls by memorisation (the JAX driver asserts the
same).  Each step is ``model(ids, labels=labels).mean()``, its backward
and a :class:`~apex_tpu_torch.optimizers.FusedAdam` update.  ``--o2``
applies the precision of ``bench.py``'s ``llama-1b`` card (:func:`o2_cast`
and bf16 optimizer moments).

On the card the flash attention kernels take head dims 32, 64 and 128,
so the JAX trainer's defaults (hidden 128 over 4 heads, head dim 32) run
there; another head dim raises rather than falling back.  Tensor and
pipeline parallelism (``--tp``/``--pp`` > 1) need NCCL and come with a
later slice of the port; they raise.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdam

__all__ = ["o2_cast", "train_step", "main"]


def o2_cast(model: torch.nn.Module,
            dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """``bench.py``'s O2 cast, in place: every fp32 parameter of two or
    more dims (embedding, projections, head) to ``dtype``; the rest (the
    RMSNorm scales) stay fp32.  Returns the model."""
    for p in model.parameters():
        if p.dtype == torch.float32 and p.dim() >= 2:
            p.data = p.data.to(dtype)
    return model


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               ids: torch.Tensor) -> torch.Tensor:
    """One step on ``ids [b, s]``: labels are the ids rolled by one; the
    mean per-token loss, its backward, one optimizer update.  Returns the
    loss (detached, on the model's device)."""
    labels = torch.roll(ids, -1, dims=1)
    opt.zero_grad(set_to_none=True)
    loss = model(ids, labels=labels).mean()
    loss.backward()
    opt.step()
    return loss.detach()


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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallel size; only 1 (the JAX driver's "
                         "default of 2 needs the NCCL slice of the port)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages; only 1 (NCCL slice)")
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train ``--steps`` steps and return the last loss; raises unless it
    is finite and below the first."""
    args = _parser().parse_args(argv)
    if args.tp > 1 or args.pp > 1:
        raise NotImplementedError(
            f"--tp {args.tp} --pp {args.pp}: tensor and pipeline "
            f"parallelism need NCCL and come with the multi-card slice of "
            f"the port; this driver runs dp = tp = pp = 1")
    device = resolve_device(args.device)
    cfg = LlamaConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        intermediate_size=args.ffn, num_hidden_layers=args.layers,
        num_attention_heads=args.heads, num_key_value_heads=args.kv_heads,
        max_position_embeddings=args.seq)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = LlamaForCausalLM(cfg, device=device, generator=gen)
    state_dtype = torch.float32
    if args.o2:
        o2_cast(model)
        state_dtype = torch.bfloat16
    opt = FusedAdam(model.parameters(), lr=args.lr, state_dtype=state_dtype)
    rng = np.random.default_rng(args.seed)
    ids = torch.from_numpy(
        rng.integers(0, args.vocab, (args.batch, args.seq))).to(device)

    first = last = None
    for it in range(args.steps):
        last = float(train_step(model, opt, ids))
        first = last if first is None else first
        if it % 2 == 0 or it == args.steps - 1:
            print(f"step {it:3d}  loss {last:.4f}  dp=1 tp=1 "
                  f"device={device.type}", flush=True)
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    print(f"llama pretrain OK: dp=1 tp=1, loss {first:.4f} -> {last:.4f}")
    return last


if __name__ == "__main__":
    main()
