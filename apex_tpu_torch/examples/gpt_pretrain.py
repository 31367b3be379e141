"""GPT pretraining at dp = tp = pp = 1: the counterpart of
``bench.py::run_config``'s GPT step (``bench.py:2343-2385``), on one card.

    python -m apex_tpu_torch.examples.gpt_pretrain [--layers 2] [--steps 10]
    python -m apex_tpu_torch.examples.gpt_pretrain --no-flash --packed-lamb
    python -m apex_tpu_torch.examples.gpt_pretrain --device cpu
    python -m apex_tpu_torch.examples.gpt_pretrain --config 1.3b --steps 4

fp32 init from a seeded ``torch.Generator``, then ``bench.py``'s O2 cast
(:func:`~apex_tpu_torch.examples.llama_pretrain.o2_cast`: every 2-d
parameter bf16, biases and LayerNorm parameters fp32); one fixed seeded
batch with labels the ids rolled by one, so the loss falls by
memorisation.  Each step is ``model(ids, labels=labels).mean()``,
its backward and a :class:`~apex_tpu_torch.optimizers.FusedLAMB` update
(``lr=1e-3``; its moments' dtype the card's, else bf16).  Two forms:

- the flagship (the default): flash attention and the unpacked LAMB;
- ``--no-flash``: the materialized attention core through the fused
  softmax kernels; ``--packed-lamb``: the packed LAMB (fp32 flat moments)
  over the phase-1 kernel.

The default widths are small; ``--config`` takes one of ``bench.py``'s
GPT cards (``bench.py:81-98``) with its widths, its recompute and its LAMB
moments' dtype: ``large`` (GPT-2-large: 36 x 1280, 20 heads, vocab 50304,
s 1024, b 8, no recompute, bf16 moments), ``medium`` (24 x 1024, 16
heads, fp32 moments) or ``1.3b`` (24 x 2048, 32 heads, whole-layer
recompute, bf16 moments).  The named recompute policies of
:mod:`apex_tpu_torch.transformer.recompute` are ``GPTModel``'s
``activations_checkpoint_policy``.  This is
``bench.py``'s GPT step; the repo's own GPT trainer,
``examples/gpt/pretrain.py`` (the Megatron harness's dp x pp x tp
trainer), is :mod:`~apex_tpu_torch.examples.megatron_gpt_pretrain`.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.examples.llama_pretrain import o2_cast, train_step
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.transformer.testing import GPTModel

__all__ = ["CONFIGS", "LARGE", "build", "main"]

#: bench.py's GPT cards (bench.py:81-98): widths, recompute, LAMB moments
CONFIGS = {
    "large": dict(layers=36, hidden=1280, heads=20, vocab=50304, seq=1024,
                  batch=8, remat=None, state_dtype=torch.bfloat16),
    "medium": dict(layers=24, hidden=1024, heads=16, vocab=50304, seq=1024,
                   batch=8, remat=None, state_dtype=torch.float32),
    "1.3b": dict(layers=24, hidden=2048, heads=32, vocab=50304, seq=1024,
                 batch=8, remat="full", state_dtype=torch.bfloat16),
}
#: bench.py's "large" card (bench.py:81-84)
LARGE = CONFIGS["large"]


def build(layers: int, hidden: int, heads: int, vocab: int, seq: int, *,
          flash: bool = True, packed_lamb: bool = False, lr: float = 1e-3,
          seed: int = 0, remat: Optional[str] = None,
          state_dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """``(model, optimizer)``: the GPT at these widths, fp32 init from
    ``seed``, O2-cast, and its FusedLAMB (packed with fp32 flat moments,
    or unpacked with ``state_dtype`` moments).
    ``remat`` is ``bench.py``'s: None or ``"full"`` (whole-layer
    recompute)."""
    if remat not in (None, "full"):
        raise ValueError(f"remat {remat!r} is not None or 'full'")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = GPTModel(num_layers=layers, hidden_size=hidden,
                     num_attention_heads=heads, vocab_size=vocab,
                     max_sequence_length=seq, use_flash_attention=flash,
                     activations_checkpoint=remat == "full",
                     device=dev, generator=gen)
    o2_cast(model)
    if packed_lamb:
        state_dtype = torch.float32
    opt = FusedLAMB(model.parameters(), lr=lr, packed=packed_lamb,
                    state_dtype=state_dtype)
    return model, opt


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    help="one of bench.py's GPT cards (widths, recompute "
                         "and LAMB moments)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-flash", action="store_true",
                    help="the materialized attention core (fused softmax)")
    ap.add_argument("--packed-lamb", action="store_true",
                    help="FusedLAMB(packed=True) over the phase-1 kernel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train ``--steps`` steps and return the last loss; raises unless it
    is finite and below the first."""
    args = _parser().parse_args(argv)
    card = dict(remat=None, state_dtype=torch.bfloat16)
    if args.config is not None:
        card = CONFIGS[args.config]
        for k in ("layers", "hidden", "heads", "vocab", "seq", "batch"):
            setattr(args, k, card[k])
    remat, state_dtype = card["remat"], card["state_dtype"]
    device = resolve_device(args.device)
    model, opt = build(args.layers, args.hidden, args.heads, args.vocab,
                       args.seq, flash=not args.no_flash,
                       packed_lamb=args.packed_lamb, lr=args.lr,
                       seed=args.seed, remat=remat, state_dtype=state_dtype,
                       device=device)
    rng = np.random.default_rng(args.seed)
    ids = torch.from_numpy(
        rng.integers(0, args.vocab, (args.batch, args.seq))).to(device)
    form = (f"{'materialized' if args.no_flash else 'flash'} attention, "
            f"{'packed' if args.packed_lamb else 'unpacked'} LAMB, "
            f"recompute {remat or 'none'}")
    first = last = None
    for it in range(args.steps):
        last = float(train_step(model, opt, ids))
        first = last if first is None else first
        if it % 2 == 0 or it == args.steps - 1:
            print(f"step {it:3d}  loss {last:.4f}  {form}  "
                  f"device={device.type}", flush=True)
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    print(f"gpt pretrain OK: {form}, loss {first:.4f} -> {last:.4f}")
    return last


if __name__ == "__main__":
    main()
