"""Vocab-parallel cross entropy (counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

The logits' vocab dim is split across tp ranks; the loss is computed
without gathering the whole vocab:

1. the local max, all-reduced (max) for stability, carrying no gradient;
2. the target logit picked where the target lies in the rank's range,
   all-reduced (sum);
3. the local sum of ``exp``, all-reduced (sum), then its log;
4. ``loss = log(sum_exp) - target_logit``, with optional label smoothing.

The sums go through :func:`reduce_from_tensor_model_parallel_region`,
whose backward is the identity: the loss is the same on every rank and
each rank back-propagates the one cotangent into its own shard (a raw
all-reduce in the backward would add the ranks' cotangents up and scale
the gradient by the world size).  Autograd through these steps gives
Megatron's hand-written ``softmax - one_hot`` backward.  Outside a
tensor-parallel region (and with no ``group``) it is the plain
single-shard loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    _group,
    reduce_from_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility

__all__ = ["vocab_parallel_cross_entropy"]


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0, group=None):
    """Per-token fp32 loss for ``[..., vocab / tp]`` logits and ``[...]``
    int targets."""
    g = _group(group)
    world = 1 if g is None else dist.get_world_size(g)
    rank = 0 if g is None else dist.get_rank(g)

    logits32 = vocab_parallel_logits.float()
    partition_vocab = logits32.shape[-1]

    global_max = torch.amax(logits32, dim=-1).detach()
    if g is not None:
        global_max = global_max.clone()
        dist.all_reduce(global_max, op=dist.ReduceOp.MAX, group=g)
    logits32 = logits32 - global_max[..., None]

    first, last = VocabUtility.vocab_range_from_per_partition_vocab_size(
        partition_vocab, rank, world)
    in_range = (target >= first) & (target < last)
    masked_target = torch.where(in_range, target - first,
                                torch.zeros_like(target))
    target_logit = torch.gather(logits32, -1, masked_target[..., None])[..., 0]
    target_logit = torch.where(in_range, target_logit,
                               torch.zeros_like(target_logit))

    sum_exp = torch.sum(torch.exp(logits32), dim=-1)
    if g is not None:
        target_logit = reduce_from_tensor_model_parallel_region(
            target_logit, g)
        sum_exp = reduce_from_tensor_model_parallel_region(sum_exp, g)

    loss = torch.log(sum_exp) - target_logit
    if label_smoothing > 0:
        vocab_size = partition_vocab * world
        smoothing = label_smoothing * vocab_size / (vocab_size - 1)
        log_probs = logits32 - torch.log(sum_exp)[..., None]
        mean_log_probs = torch.sum(log_probs, dim=-1) / vocab_size
        if g is not None:
            mean_log_probs = reduce_from_tensor_model_parallel_region(
                mean_log_probs, g)
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs
    return loss
