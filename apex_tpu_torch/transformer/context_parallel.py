"""Ring attention: context parallelism for long sequences (counterpart of
``apex_tpu/transformer/context_parallel.py``).

The sequence is split over a process group of ``cp`` ranks, rank ``r``
holding positions ``[r * s_local, (r + 1) * s_local)``.  Each rank
attends its queries to its own key/value block, then passes the block it
holds to the next rank (``r -> r + 1``) and attends to the block it
receives, ``cp - 1`` times, merging the blocks by the online softmax
(running max, normalizer and weighted sum in fp32), so no rank ever holds
more than ``s_local`` keys and no ``[s, s]`` score matrix exists.

- **Causal masking is block-level**: a block from a later rank is dead
  (its merge is an exact no-op, so its products are skipped; its keys
  and values still travel on), the rank's own block gets the in-block
  triangle, earlier blocks attend fully.
- **The rotation** is one ``batch_isend_irecv`` of the key and value
  blocks a step, in an autograd function whose backward sends the
  gradients the other way (JAX gets that transpose from ``ppermute``).
- **Memory**: each step's block products are recomputed in the backward
  (``torch.utils.checkpoint``, where JAX puts ``jax.checkpoint``), so the
  saved state is the ``O(cp * block)`` tensors the ring carries.  The
  running maxima take no gradient: the output does not depend on them in
  exact arithmetic.
- **Products** are ``torch.matmul`` on fp32 copies of the blocks (JAX's
  ``preferred_element_type=float32``); no kernel of the port is involved,
  as none is in JAX.

``axis_name`` takes the ``torch.distributed`` process group (the JAX
functions take a mesh axis name under ``shard_map``; a string raises
``ValueError``); None is one rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.transformer.parallel_state import axis_group

__all__ = ["ring_self_attention", "ring_attention"]

_NEG_INF = -1e30


def _block_attend(q, k, v, *, scale, mask):
    """Unnormalized block attention in fp32: ``(scores_max, exp-sum,
    o_partial)``; ``mask`` is ``[sq, sk]`` bool (True attends) or None.
    The max takes no gradient."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    if mask is not None:
        s.masked_fill_(~mask, _NEG_INF)
    m = s.detach().amax(dim=-1)                               # [b, h, sq]
    p = s.sub_(m[..., None]).exp_()
    return m, p.sum(dim=-1), torch.matmul(p, v.float())


def _step(q, k_blk, v_blk, m_acc, l_acc, o_acc, *, scale, mask):
    """One block's attention merged into the running state."""
    m_blk, l_blk, o_blk = _block_attend(q, k_blk, v_blk, scale=scale,
                                        mask=mask)
    m_new = torch.maximum(m_acc, m_blk)
    a = torch.exp(m_acc - m_new)
    bfac = torch.exp(m_blk - m_new)
    return (m_new, l_acc * a + l_blk * bfac,
            o_acc * a[..., None] + o_blk * bfac[..., None])


def _rotate(k, v, group, step: int):
    """Send ``k`` and ``v`` to rank ``r + step`` of ``group`` and receive
    the blocks of rank ``r - step`` (mod the group's size)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (r + step) % n)
    frm = dist.get_global_rank(group, (r - step) % n)
    k_in, v_in = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (k, v))
    ops = [dist.P2POp(dist.isend, k.contiguous(), to, group),
           dist.P2POp(dist.isend, v.contiguous(), to, group),
           dist.P2POp(dist.irecv, k_in, frm, group),
           dist.P2POp(dist.irecv, v_in, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return k_in, v_in


class _RingShift(torch.autograd.Function):
    """The key and value blocks one hop on (``r -> r + 1``); the backward
    returns their gradients one hop back."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return _rotate(k, v, group, 1)

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = _rotate(dk, dv, ctx.group, -1)
        return dk, dv, None


class _KeepInGraph(torch.autograd.Function):
    """``out`` as it is, with zero gradients for the last blocks the ring
    delivered: where those were dead their rotation still runs its
    backward, so every rank makes the same sends and receives."""

    @staticmethod
    def forward(ctx, out, k_blk, v_blk):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (k_blk, v_blk)]
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.like))


def ring_attention(q, k, v, *, axis_name, causal: bool = True,
                   scale: Optional[float] = None):
    """Attention over a sequence split over the ``axis_name`` group.

    q/k/v: the rank's blocks ``[b, h, s_local, d]``.  Returns the rank's
    output block ``[b, h, s_local, d]`` in q's dtype; the values are dense
    attention's over the whole sequence (up to rounding)."""
    group = axis_group(axis_name, "axis_name")
    n = 1 if group is None else dist.get_world_size(group)
    my = 0 if group is None else dist.get_rank(group)
    b, h, s_local, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    tri = (torch.ones(s_local, s_local, dtype=torch.bool,
                      device=q.device).tril() if causal else None)
    recompute = torch.is_grad_enabled()

    def attend(k_blk, v_blk, src, state):
        mask = tri if src == my else None
        if recompute:
            return checkpoint(_step, q, k_blk, v_blk, *state, scale=scale,
                              mask=mask, use_reentrant=False)
        return _step(q, k_blk, v_blk, *state, scale=scale, mask=mask)

    state = (torch.full((b, h, s_local), _NEG_INF, dtype=torch.float32,
                        device=q.device),
             torch.zeros((b, h, s_local), dtype=torch.float32,
                         device=q.device),
             torch.zeros((b, h, s_local, d), dtype=torch.float32,
                         device=q.device))
    # step 0 attends the rank's own block; each of the n - 1 steps after
    # it moves the blocks one hop, so the block held after r hops is rank
    # (my - r) mod n's
    state = attend(k, v, my, state)
    k_blk, v_blk = k, v
    dead = False
    for r in range(1, n):
        k_blk, v_blk = _RingShift.apply(k_blk, v_blk, group)
        src = (my - r) % n
        dead = causal and src > my
        if not dead:
            state = attend(k_blk, v_blk, src, state)
    _, l_acc, o_acc = state
    # fully-masked rows (none in self-attention) give zeros
    safe_l = torch.where(l_acc == 0.0, 1.0, l_acc)
    out = (o_acc / safe_l[..., None]).to(q.dtype)
    if dead and recompute:
        out = _KeepInGraph.apply(out, k_blk, v_blk)
    return out


def ring_self_attention(qkv, *, axis_name, causal: bool = True,
                        scale: Optional[float] = None):
    """Convenience for a fused qkv ``[b, h, s_local, 3, d]``."""
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                          scale=scale)
