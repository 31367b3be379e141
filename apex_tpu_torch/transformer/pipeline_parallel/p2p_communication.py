"""Point-to-point communication between pipeline stages (counterpart of
``apex_tpu/transformer/pipeline_parallel/p2p_communication.py``, apex's
``p2p_communication.py:34-690``).

The JAX package moves a tensor one stage along the ``pp`` mesh axis with
``jax.lax.ppermute``: one collective in which every stage sends and
receives.  The port does the same over the pipeline's process group with
``torch.distributed.P2POp`` and ``batch_isend_irecv``: every send and
receive of one exchange is posted in one batch, so two neighbours that
send to each other cannot deadlock.  :func:`shift_forward` delivers each
stage's tensor to the next stage (stage 0 receives zeros, or the last
stage's tensor with ``wrap``, the interleaved schedule's ring);
:func:`shift_backward` to the previous one.  The nine reference-named
combinators map onto those two, as in the JAX package.

At pp 1 a stage has no neighbour and no call is made: the JAX
permutation is empty there (the identity with ``wrap``), and an empty
batch is not a valid call.  :func:`p2p_calls` counts the batches posted
in this process, one a call of ``batch_isend_irecv``.

NCCL requires the first point-to-point batch of a group to involve all
of its ranks; :func:`ready` makes a barrier the group's first call (once
a group, nothing on gloo), and the schedules call it before their first
tick.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["shift_forward", "shift_backward", "send_forward_recv_forward",
           "send_backward_recv_backward", "send_forward", "recv_forward",
           "send_backward", "recv_backward", "send_forward_recv_backward",
           "send_backward_recv_forward", "exchange", "ready", "p2p_calls"]

# batch_isend_irecv calls this process made (the chip check counts a step's)
_CALLS = {"n": 0}
# the groups whose first call has been made (held, so an id is not reused)
_READY: dict = {}


def p2p_calls() -> int:
    """Batches of point-to-point operations posted in this process."""
    return _CALLS["n"]


def _pp_group(group):
    if group is None:
        from apex_tpu_torch.transformer import parallel_state

        group = parallel_state.get_pipeline_model_parallel_group()
    return group


def ready(group=None) -> None:
    """Make a barrier the first call of an NCCL pipeline group of two or
    more ranks (every rank of the group calls this at the same point);
    nothing otherwise."""
    group = _pp_group(group)
    if id(group) in _READY or dist.get_world_size(group) == 1:
        return
    if str(dist.get_backend(group)) == "nccl":
        dist.barrier(group=group)
    _READY[id(group)] = group


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[tuple, torch.dtype, int]], group=None, *,
             device=None) -> List[torch.Tensor]:
    """Post ``sends`` (``(tensor, peer)``) and ``recvs`` (``(shape,
    dtype, peer)``), peers being ranks of ``group`` (the pipeline group
    by default), as one ``batch_isend_irecv`` and wait for all of them;
    returns the received tensors in ``recvs``' order.  Sends and receives
    between the same two ranks match in the order they are posted.  With
    nothing to post, no call is made."""
    if not sends and not recvs:
        return []
    group = _pp_group(group)
    ops, out = [], []
    for tensor, peer in sends:
        ops.append(dist.P2POp(dist.isend, tensor.contiguous(),
                              dist.get_global_rank(group, peer), group))
    for shape, dtype, peer in recvs:
        buf = torch.empty(shape, dtype=dtype, device=device)
        out.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group))
    _CALLS["n"] += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _shift(x: torch.Tensor, step: int, group, wrap: bool) -> torch.Tensor:
    group = _pp_group(group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x if wrap else torch.zeros_like(x)
    to, frm = r + step, r - step
    sends = [(x, to % n)] if wrap or 0 <= to < n else []
    recvs = ([(tuple(x.shape), x.dtype, frm % n)]
             if wrap or 0 <= frm < n else [])
    got = exchange(sends, recvs, group, device=x.device)
    return got[0] if got else torch.zeros_like(x)


def shift_forward(x: torch.Tensor, group=None,
                  wrap: bool = False) -> torch.Tensor:
    """Deliver each stage's tensor to the *next* stage; returns what the
    previous stage sent (zeros on stage 0, or the last stage's tensor
    with ``wrap``).  Every stage of the group calls it."""
    return _shift(x, 1, group, wrap)


def shift_backward(x: torch.Tensor, group=None,
                   wrap: bool = False) -> torch.Tensor:
    """Deliver each stage's tensor to the *previous* stage."""
    return _shift(x, -1, group, wrap)


# --- reference-named combinators (p2p_communication.py:385-690) ------------


def send_forward_recv_forward(output, group=None):
    """This stage's output goes to the next stage; returns what the
    previous stage sent here."""
    return shift_forward(output, group)


def send_backward_recv_backward(input_grad, group=None):
    return shift_backward(input_grad, group)


def send_forward(output, group=None):
    return shift_forward(output, group)


def recv_forward(output, group=None):
    return shift_forward(output, group)


def send_backward(grad, group=None):
    return shift_backward(grad, group)


def recv_backward(grad, group=None):
    return shift_backward(grad, group)


def _both(output, grad, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch: ``output`` to the next stage and ``grad`` to the
    previous one; returns (from the previous, from the next)."""
    group = _pp_group(group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    sends, recvs = [], []
    if r + 1 < n:
        sends.append((output, r + 1))
        recvs.append((tuple(grad.shape), grad.dtype, r + 1))
    if r > 0:
        sends.append((grad, r - 1))
        recvs.append((tuple(output.shape), output.dtype, r - 1))
    got = exchange(sends, recvs, group, device=output.device)
    from_next = got.pop(0) if r + 1 < n else torch.zeros_like(grad)
    from_prev = got.pop(0) if r > 0 else torch.zeros_like(output)
    return from_prev, from_next


def send_forward_recv_backward(output, grad, group=None):
    """The 1F1B steady-state exchange: activations flow down while grads
    flow up, both in one batch.  Returns (the previous stage's output,
    the next stage's grad)."""
    return _both(output, grad, group)


def send_backward_recv_forward(grad, output, group=None):
    """Returns (the next stage's grad, the previous stage's output)."""
    from_prev, from_next = _both(output, grad, group)
    return from_next, from_prev
