"""Mixture-of-experts with expert parallelism over a process group
(counterpart of ``apex_tpu/transformer/moe.py``).

Switch-style top-1 routing: an fp32 router picks each token's expert, a
token takes the next free slot of its expert's queue (tokens in order)
and is dropped past ``capacity`` slots (its output is 0: the layer's
residual carries it), the experts' FFNs run as one batched product pair
over ``[experts, capacity, h]``, and each kept token's output is its
expert's output scaled by the router's probability.  The load-balancing
loss of Switch (eq. 4), ``e * sum_e(frac_tokens_e * frac_probs_e)``, is
returned beside the output.

**Dispatch and combine.**  The JAX module writes both as einsums against
the dense ``[tokens, experts, capacity]`` one-hot.  Top-1 gives each
output row of either product exactly one nonzero term, so the port
gathers instead: each expert slot reads its token's row
(``index_select`` over the tokens and one zero row for empty slots), and
each token reads its slot's row times its gate (``index_select`` over
the slots and one zero row for dropped tokens).  The values are the
einsums' (a sum of one product and zeros), and the backward of each
gather adds at most one term into a real row, so it is deterministic.
:func:`top1_dispatch` still returns the JAX function's dense tensors.

**Expert parallelism.**  ``axis_name`` takes a ``torch.distributed``
process group (the JAX module takes a mesh axis name and runs under
``shard_map``; a string raises ``ValueError``).  Each of the group's
``ep`` ranks holds ``num_experts / ep`` experts and its own tokens; the
slots go to their experts' rank and back by ``all_to_all_single`` in an
autograd function whose backward is the same exchange, in JAX's
``[ep, local_e, capacity, h]`` layout.  Each rank cuts its own queues,
so where capacity binds the drops differ from the one-rank module by
design (as in JAX).  The router is replicated over the group and, as in
JAX, its gradient on a rank is that rank's tokens' share only.  It
carries ``expert_replicated = True``, and a trainer sums the tagged
gradients over the group with
:func:`~apex_tpu_torch.transformer.tensor_parallel.
allreduce_expert_replicated_grads` (the JAX package has no such call).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.parallel_state import axis_group
from apex_tpu_torch.transformer.tensor_parallel.layers import shard_init

__all__ = ["ExpertParallelMLP", "top1_dispatch"]

def _route(logits32: torch.Tensor, capacity: int):
    """``(tokens_per_expert, slot, kept, gate, aux)``: how many tokens
    chose each expert; each token's slot ``expert * capacity + position``
    in its expert's queue (its expert the first of the largest
    probabilities, its position its rank among that expert's tokens in
    order), whether the position is within capacity, its router
    probability; and the load-balancing loss.  No host sync."""
    t, e = logits32.shape
    probs = torch.softmax(logits32, dim=-1)
    expert = torch.argmax(probs, dim=-1)                       # [t]
    # the one-hot expert-major, [e, t]: the queue positions are a scan
    # along its rows (a scan down the columns of [t, e] runs on e threads)
    onehot = (torch.arange(e, device=expert.device)[:, None] == expert
              ).to(torch.int64)
    pos = torch.cumsum(onehot, dim=1).gather(0, expert[None, :])[0] - 1
    kept = pos < capacity
    gate = probs.gather(1, expert[:, None])[:, 0]              # [t]
    counts = onehot.sum(dim=1)
    aux = e * torch.sum(counts.to(torch.float32) / t * probs.mean(dim=0))
    return counts, expert * capacity + pos, kept, gate, aux


def top1_dispatch(logits32: torch.Tensor, capacity: int):
    """Switch-style top-1 routing with position-in-expert capacity.

    ``logits32``: ``[tokens, experts]`` fp32.  Returns ``(dispatch [t, e,
    c], combine [t, e, c], aux_loss)`` as the JAX function does:
    ``dispatch`` the 0/1 one-hot of each kept token's slot, ``combine``
    it times the token's router probability."""
    t, e = logits32.shape
    _, slot, kept, gate, aux = _route(logits32, capacity)
    dispatch = torch.zeros(t, e * capacity, dtype=torch.float32,
                           device=logits32.device)
    rows = torch.arange(t, device=logits32.device)[kept]
    dispatch[rows, slot[kept]] = 1.0
    dispatch = dispatch.view(t, e, capacity)
    return dispatch, dispatch * gate[:, None, None], aux


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 (block ``i`` to rank ``i``, block
    ``j`` from rank ``j``); its transpose is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _lecun_normal(shape, *, dtype, device, generator) -> torch.Tensor:
    """flax's ``lecun_normal()``: truncated normal (within 2 std) of
    variance ``1 / fan_in``, ``fan_in`` the second-to-last dim times the
    leading (batch) dims, as flax counts it."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    out = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    return out.to(dtype)


class ExpertParallelMLP(nn.Module):
    """Top-1 MoE FFN; experts split over the ``axis_name`` group when set.

    Input ``[tokens, hidden]``; returns ``(output [tokens, hidden],
    aux_loss)``.  Parameters: ``router [h, e]`` fp32, ``w_in [local_e, h,
    ffn]`` and ``w_out [local_e, ffn, h]`` in ``param_dtype`` (the rank's
    experts, JAX's layout).  The product ``x @ router`` runs in fp32 with
    the router cast up, whatever the dtypes (under O2 the router may be
    bf16, as the JAX policy casts it); the experts run in ``x``'s dtype
    with ``gelu(approximate="tanh")``.  ``capacity = max(1, int(
    capacity_factor * tokens / num_experts))`` slots an expert on each
    rank.  The routing of the last call stays readable as
    ``last_tokens_per_expert`` (this rank's tokens routed to each of the
    ``e`` experts) and ``last_dropped`` (its tokens past capacity), both
    device tensors."""

    def __init__(self, num_experts: int, hidden_size: int,
                 ffn_hidden_size: Optional[int] = None,
                 capacity_factor: float = 1.25, axis_name=None, *,
                 param_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.axis_name = axis_group(axis_name, "axis_name")
        ep = 1 if self.axis_name is None else dist.get_world_size(
            self.axis_name)
        if num_experts % ep:
            raise ValueError(f"num_experts ({num_experts}) must divide by "
                             f"the ep group's size ({ep})")
        self.num_experts = num_experts
        self.hidden_size = hidden_size
        self.ffn_hidden_size = ffn = ffn_hidden_size or 4 * hidden_size
        self.capacity_factor = capacity_factor
        self.ep = ep
        self.local_experts = local_e = num_experts // ep
        dev = resolve_device(device)
        self.router = nn.Parameter(_lecun_normal(
            (hidden_size, num_experts), dtype=torch.float32, device=dev,
            generator=generator))
        # replicated over the ep group: each rank's gradient a share
        self.router.expert_replicated = True
        # this rank's experts: a generator folded with the ep rank
        if ep > 1:
            generator = shard_init(generator, dev,
                                   rank=dist.get_rank(self.axis_name))
        kw = dict(dtype=param_dtype, device=dev, generator=generator)
        self.w_in = nn.Parameter(_lecun_normal((local_e, hidden_size, ffn),
                                               **kw))
        self.w_out = nn.Parameter(_lecun_normal((local_e, ffn, hidden_size),
                                                **kw))
        self.last_tokens_per_expert = None
        self.last_dropped = None

    def capacity(self, tokens: int) -> int:
        """Slots an expert for ``tokens`` tokens on a rank."""
        return max(1, int(self.capacity_factor * tokens / self.num_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t, h = x.shape
        e, local_e, c = self.num_experts, self.local_experts, self.capacity(t)
        logits = x.float() @ self.router.float()
        counts, slot, kept, gate, aux = _route(logits, c)
        self.last_tokens_per_expert = counts
        self.last_dropped = (~kept).sum()
        # each token's slot, e * c for a dropped token: there the zero row
        # of ``outs`` below, and a scratch entry of ``token_of_slot``
        slot_of_token = torch.where(kept, slot, e * c)
        # each slot's token, t (the zero row of ``rows``) for an empty slot
        token_of_slot = torch.full((e * c + 1,), t, dtype=torch.long,
                                   device=x.device)
        token_of_slot.scatter_(0, slot_of_token,
                               torch.arange(t, device=x.device))
        rows = torch.cat([x, x.new_zeros(1, h)])
        expert_in = rows.index_select(0, token_of_slot[:e * c])  # [e * c, h]
        group = self.axis_name
        if group is not None:
            # [ep, local_e, c, h]: block r to rank r, which receives its
            # experts' slots from every rank
            expert_in = _AllToAll.apply(expert_in.view(self.ep, local_e, c, h),
                                        group)
            expert_in = expert_in.transpose(0, 1).reshape(local_e,
                                                          self.ep * c, h)
        else:
            expert_in = expert_in.view(local_e, c, h)
        hmid = nn.functional.gelu(
            torch.bmm(expert_in, self.w_in.to(x.dtype)), approximate="tanh")
        expert_out = torch.bmm(hmid, self.w_out.to(x.dtype))
        if group is not None:
            expert_out = expert_out.view(local_e, self.ep, c, h).transpose(0, 1)
            expert_out = _AllToAll.apply(expert_out, group)
        outs = torch.cat([expert_out.reshape(e * c, h), x.new_zeros(1, h)])
        out = outs.index_select(0, slot_of_token) * torch.where(
            kept, gate, 0.0).to(x.dtype)[:, None]
        return out, aux
