"""BERT pretraining, data parallel: the port of the repo's
``examples/bert/pretrain.py`` (FusedLAMB + FusedLayerNorm, the masked-LM
and next-sentence objective on one fixed synthetic batch).

    python -m apex_tpu_torch.examples.bert_pretrain --device cpu
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.bert_pretrain \\
        --device cpu
    python -m apex_tpu_torch.examples.bert_pretrain --large --steps 4

The world is the caller's process group, else one from torchrun's
environment, else this one process (NCCL on ``cuda``, gloo on ``cpu``).
:class:`~apex_tpu_torch.parallel.DistributedDataParallel` broadcasts the
model from rank 0 and averages the gradients after each backward; each
rank trains on its rows of the global batch, and the loss printed is the
mean over the ranks (the JAX example's ``pmean`` of the gradients and the
loss under ``shard_map``).  Each rank's loss is the masked-LM loss averaged
over its masked positions plus the NSP cross entropy averaged over its
rows.

Two batches, both drawn with numpy from ``--seed``:

- the example's (the default): ids in ``[5, vocab)``, ``--mask-prob`` of
  them replaced by ``MASK_ID`` 4, a pad tail of fewer than ``seq / 4``
  tokens a row;
- ``tools/model_bench.py``'s (with ``--large``): ids in ``[0, vocab)``,
  15% replaced by 103, lengths in ``[0.9 seq, seq]``, no loss on padding.

``--large`` is ``tools/model_bench.py``'s BERT-large card: 24 x 1024, 16
heads, vocab 30592, s 512, b 16, its batch, the O2 cast (every 2-d fp32
parameter bf16) and bf16 LAMB moments.
"""

from __future__ import annotations

import argparse
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.examples.imagenet_main import _process_group
from apex_tpu_torch.examples.llama_pretrain import o2_cast
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.parallel import DistributedDataParallel
from apex_tpu_torch.transformer.testing import BertModel

__all__ = ["MASK_ID", "BENCH_MASK_ID", "LARGE", "synth_batch",
           "bench_batch", "build", "loss_fn", "train_step", "main"]

MASK_ID = 4             # the example's [MASK] id
BENCH_MASK_ID = 103     # tools/model_bench.py's
#: tools/model_bench.py's BERT-large card (tools/model_bench.py:175-233)
LARGE = dict(layers=24, hidden=1024, heads=16, vocab=30592, seq=512,
             batch=16)


def synth_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
                mask_prob: float = 0.15) -> tuple:
    """The example's batch, as numpy ``(ids, attention_mask, lm_labels,
    masked, nsp_labels)``, drawn in the JAX example's order."""
    ids = rng.integers(5, vocab, (batch, seq))
    lm_labels = ids.copy()
    masked = rng.random(ids.shape) < mask_prob
    ids[masked] = MASK_ID
    pad = rng.integers(0, seq // 4, (batch,))
    attn = np.ones_like(ids)
    for i, n in enumerate(pad):
        if n:
            attn[i, -n:] = 0
    nsp = rng.integers(0, 2, (batch,))
    return ids, attn, lm_labels, masked & (attn == 1), nsp


def bench_batch(rng: np.random.Generator, batch: int, seq: int,
                vocab: int) -> tuple:
    """``tools/model_bench.py``'s BERT-large batch, in the same form as
    :func:`synth_batch`."""
    orig = rng.integers(0, vocab, (batch, seq))
    mlm_mask = rng.random((batch, seq)) < 0.15
    ids = np.where(mlm_mask, BENCH_MASK_ID, orig)
    lengths = rng.integers(int(seq * 0.9), seq + 1, batch)
    attn = np.arange(seq)[None, :] < lengths[:, None]
    nsp = rng.integers(0, 2, batch)
    return ids, attn.astype(np.int64), orig, mlm_mask & attn, nsp


def to_device(batch: tuple, device) -> tuple:
    """A numpy batch as tensors on ``device`` (ids and labels int64, the
    mask int32, ``masked`` bool)."""
    ids, attn, labels, masked, nsp = batch
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device=device,
                                                         dtype=dt)
    return (t(ids, torch.int64), t(attn, torch.int32),
            t(labels, torch.int64), t(masked, torch.bool),
            t(nsp, torch.int64))


def build(layers: int, hidden: int, heads: int, vocab: int, seq: int, *,
          o2: bool = False,
          state_dtype: torch.dtype = torch.float32, lr: float = 1e-3,
          seed: int = 0, state_dict: Optional[Mapping] = None,
          device="cuda"):
    """``(model, optimizer)``: the BERT at these widths drawn from
    ``seed`` (or loaded from ``state_dict``), with ``o2`` cast, and its
    ``FusedLAMB(lr, state_dtype=)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = BertModel(num_layers=layers, hidden_size=hidden,
                      num_attention_heads=heads, vocab_size=vocab,
                      max_sequence_length=seq, device=dev, generator=gen)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if o2:
        o2_cast(model)
    opt = FusedLAMB(model.parameters(), lr=lr, state_dtype=state_dtype)
    return model, opt


def loss_fn(model, ids, attn, labels, masked, nsp) -> torch.Tensor:
    """The masked-LM loss averaged over the masked positions, plus the
    NSP cross entropy averaged over the rows (fp32)."""
    per_tok, binary = model(ids, attn, lm_labels=labels)
    m = masked.to(per_tok.dtype)
    mlm = (per_tok * m).sum() / m.sum().clamp_min(1.0)
    b = binary.float()
    tgt = b.gather(1, nsp[:, None])[:, 0]
    return mlm + (torch.logsumexp(b, dim=-1) - tgt).mean()


def train_step(model, opt, batch: tuple, group=None) -> torch.Tensor:
    """One step on this rank's ``batch``: the loss, its backward (a
    :class:`DistributedDataParallel` model averages the gradients over its
    group at the end of it), the loss averaged over ``group`` when one is
    given, the LAMB update.  Returns the loss (detached)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, *batch)
    loss.backward()
    loss = loss.detach()
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
    opt.step()
    return loss


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16, help="global")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mask-prob", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--large", action="store_true",
                    help="tools/model_bench.py's BERT-large card: its "
                         "widths and batch, O2, bf16 LAMB moments")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None,
         state_dict: Optional[Mapping] = None) -> list:
    """Train ``--steps`` steps and return the losses (the mean over the
    ranks); raises unless the last is finite and below the first.
    ``state_dict`` replaces the seeded initial weights."""
    args = _parser().parse_args(argv)
    if args.large:
        for k, v in LARGE.items():
            setattr(args, k, v)
    device = resolve_device(args.device)
    with _process_group(device):
        world, rank = dist.get_world_size(), dist.get_rank()
        if args.batch % world:
            raise SystemExit(f"--batch {args.batch} must be a multiple of "
                             f"the world size ({world})")
        model, opt = build(
            args.layers, args.hidden, args.heads, args.vocab, args.seq,
            o2=args.large,
            state_dtype=torch.bfloat16 if args.large else torch.float32,
            lr=args.lr, seed=args.seed, state_dict=state_dict, device=device)
        ddp = DistributedDataParallel(model)
        rng = np.random.default_rng(args.seed)
        whole = (bench_batch(rng, args.batch, args.seq, args.vocab)
                 if args.large else
                 synth_batch(rng, args.batch, args.seq, args.vocab,
                             args.mask_prob))
        # a FIXED batch, memorised: the loss falls reliably
        batch = ddp.shard_batch(to_device(whole, device))
        losses = []
        for it in range(args.steps):
            losses.append(float(train_step(ddp, opt, batch,
                                           group=dist.group.WORLD)))
            if rank == 0 and (it % 2 == 0 or it == args.steps - 1):
                print(f"step {it:3d}  mlm+nsp loss {losses[-1]:.4f}  "
                      f"dp={world}  device={device.type}", flush=True)
    first, last = losses[0], losses[-1]
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if rank == 0:
        print(f"bert pretrain OK: dp={world}, loss {first:.4f} -> "
              f"{last:.4f}")
    return losses


if __name__ == "__main__":
    main()
