"""Shared schedule machinery: stage specs, ``build_model`` and the tick
loop every pipelined schedule runs (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/common.py``, apex's
``schedules/common.py:30-420``).

**Stage specs.**  The JAX package describes a pipeline stage as pure
functions of a parameter tree, applied by every pp rank (SPMD) with the
first and last stage's work masked by the rank.  The port runs one
process a rank, so a :class:`PipelineStageSpec` holds what that rank
runs: ``stage`` (its block, usually an ``nn.Module``), ``first`` (the
input adapter, the embedding: called on the first stage only) and
``last`` (head and loss: called on the last stage only).  Each rank's
gradients land in its modules' ``.grad``.

**The tick loop** (:func:`run_pipeline`).  Every pipelined schedule is
one timetable of *units* (a microbatch through one model chunk) on two
streams, JAX's grouped virtual stream (``fwd_bwd_1f1b_interleaved.py:
15-21``): at tick ``t`` rank ``r`` of ``p`` forwards unit ``kf = t - r``
and backwards unit ``kb = t - (p - 1 - r) - lag``.  A unit ``k`` decodes
as Megatron's grouped order (group ``k // (p * vpp)``, chunk ``(k // p) %
vpp``, reversed for the backward, lane ``k % p``), so at ``vpp = 1`` unit
``k`` is microbatch ``k``.  Every output moves one stage a tick: the
forward wire from rank ``r`` to ``r + 1`` (rank ``p - 1``'s chunk-``v``
output on to rank 0's chunk ``v + 1``), the backward wire back, and a
message's sender and receiver agree on whether it exists from the
timetable alone, so inactive units cost no compute and no message.

- 1F1B (``overlap=True``): both streams in one loop, ``lag = S - 1``
  (``S = vpp * p`` global stages), ``n_units + p + S - 2`` ticks.  The
  forward runs under ``no_grad`` and banks the stage input in a
  ``2 S - 1``-slot bank; the backward recomputes the stage from its
  banked input and back-propagates through it (JAX's whole-stage
  recompute: residuals never outlive their tick, so memory is flat in
  the number of microbatches).
- two sweeps (``overlap=False``, the autodiff schedules' GPipe profile):
  every forward first, then every backward (``lag = 0``), keeping each
  unit's graph, or with ``recompute`` its input only.

The last stage seeds each microbatch's loss with ``scale / n_micro``;
gradients accumulate in ``.grad`` in the parameters' dtype (JAX's
``zeros_like(params)``), still scaled when a scaler is given.  The loss
is summed on the last stage in fp32, over the pp group, and divided by
``n_micro``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["PipelineStageSpec", "accumulated_found_inf", "build_model",
           "grads_by_param", "listify_model", "run_pipeline", "pipelined"]


@dataclasses.dataclass
class PipelineStageSpec:
    """What one pp rank runs of a pipeline (one model chunk of it under a
    virtual pipeline).

    - ``stage(x)``: the rank's block; ``x`` and the result have the same
      shape and dtype (the wire between stages).
    - ``first(mb)``: the first stage's input adapter (an embedding): maps
      a microbatch to the wire.  Called on the first stage only.
    - ``last(y, mb)``: the last stage's head and loss: a scalar loss of
      one microbatch.  Called on the last stage only.

    The members that are ``nn.Module``s hold the rank's parameters:
    :meth:`named_parameters` names them ``first.*``, ``stage.*`` and
    ``last.*``."""

    stage: Callable[[Any], Any]
    first: Optional[Callable[[Any], Any]] = None
    last: Optional[Callable[[Any, Any], Any]] = None

    def modules(self) -> Dict[str, nn.Module]:
        return {k: m for k in ("first", "stage", "last")
                if isinstance(m := getattr(self, k), nn.Module)}

    def named_parameters(self):
        for key, mod in self.modules().items():
            for name, p in mod.named_parameters():
                yield f"{key}.{name}", p

    def parameters(self) -> List[nn.Parameter]:
        return [p for _, p in self.named_parameters()]


def listify_model(model) -> List[Any]:
    """common.py listify_model parity."""
    return list(model) if isinstance(model, (list, tuple)) else [model]


def build_model(
    model_provider_func: Callable,
    wrap_with_ddp: bool = True,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    **kwargs,
) -> List[Any]:
    """One model chunk per virtual pipeline stage (common.py:30-151).

    With virtual pp the provider is called vpp times, the virtual rank
    set to each chunk's, with ``pre_process``/``post_process`` saying
    whether the chunk holds the input embedding / the head, as in the
    reference.  ``wrap_with_ddp`` is accepted for the reference's
    signature: the port's trainers average gradients over dp themselves
    (``tensor_parallel.all_reduce_gradients(average=True)``)."""
    from apex_tpu_torch.transformer import parallel_state

    del wrap_with_ddp
    if (parallel_state.get_pipeline_model_parallel_world_size() > 1
            and virtual_pipeline_model_parallel_size is not None):
        models = []
        for i in range(virtual_pipeline_model_parallel_size):
            parallel_state.set_virtual_pipeline_model_parallel_rank(i)
            pre = i == 0
            post = i == virtual_pipeline_model_parallel_size - 1
            models.append(model_provider_func(
                pre_process=pre, post_process=post, **kwargs))
        return models
    return [model_provider_func(pre_process=True, post_process=True, **kwargs)]


def accumulated_found_inf(grads: Any, *, group=None) -> torch.Tensor:
    """Step-level overflow flag for microbatch-accumulated gradients: a
    0-d bool on the device.

    Skipping is all or nothing for a step: every schedule sums the
    microbatches' gradients, and non-finite values are absorbing under
    addition, so ONE check of the sums (``mt_scale``'s, one launch on
    CUDA) is the OR over the microbatches.  A pipeline rank sees only
    its stage's gradients: pass the pp ``group`` to take the MAX over it,
    so every stage skips (or applies) the same step."""
    from apex_tpu_torch.multi_tensor_apply import _nonfinite

    flag = _nonfinite(grads)
    if group is not None:
        flag = flag.to(torch.float32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        flag = flag[0] > 0
    return flag


def index_microbatch(batches: Any, i: int) -> Any:
    """Microbatch ``i`` of ``batches``: a tensor, or a dict / list /
    tuple of tensors, each ``[n_micro, ...]``."""
    if isinstance(batches, torch.Tensor):
        return batches[i]
    if isinstance(batches, dict):
        return {k: index_microbatch(v, i) for k, v in batches.items()}
    if isinstance(batches, (list, tuple)):
        return type(batches)(index_microbatch(v, i) for v in batches)
    raise TypeError(f"microbatches must be tensors (or dicts / lists of "
                    f"them), got {type(batches).__name__}")


def _first_leaf(batches: Any) -> torch.Tensor:
    while not isinstance(batches, torch.Tensor):
        batches = (next(iter(batches.values())) if isinstance(batches, dict)
                   else batches[0])
    return batches


def num_microbatches(batches: Any) -> int:
    return _first_leaf(batches).shape[0]


def zero_grads(chunks) -> None:
    for spec in chunks:
        for p in spec.parameters():
            p.grad = None


def loss_seed(grad_scaler, scaler_state, n_micro: int):
    """The last stage's loss cotangent, ``scale / n_micro`` (a device
    tensor under a scaler: nothing is read on the host)."""
    if grad_scaler is not None and scaler_state is not None:
        return scaler_state.scale / n_micro
    return 1.0 / n_micro


def grads_of(chunks):
    """``{name: .grad}`` of each chunk's parameters: one dict, or a list
    of them under a virtual pipeline."""
    out = [{n: p.grad for n, p in spec.named_parameters()}
           for spec in chunks]
    return out if len(out) > 1 else out[0]


def grads_by_param(model, grads) -> Dict[torch.Tensor, torch.Tensor]:
    """A schedule's returned ``grads`` keyed by parameter: what a step
    reduces and what the optimizer steps from
    (``FusedOptimizer.step(grads=)``).  ``model`` is the spec (or
    module) the schedule ran, or the list of chunks under a virtual
    pipeline, whose ``grads`` is then a list of dicts.  The pipelined
    schedules' gradients are the parameters' ``.grad``;
    ``forward_backward_no_pipelining``'s are the fp32 sums, of which
    ``.grad`` holds the cast.  Parameters without a gradient are left
    out."""
    chunks = model if isinstance(model, (list, tuple)) else [model]
    dicts = grads if isinstance(grads, (list, tuple)) else [grads]
    out: Dict[torch.Tensor, torch.Tensor] = {}
    for spec, named in zip(chunks, dicts):
        for name, p in spec.named_parameters():
            g = named.get(name)
            if g is not None:
                out[p] = g
    return out


class _Bank:
    """The banked stage inputs of the units in flight, by slot."""

    def __init__(self, slots: Optional[int]):
        self.slots, self.held, self.high_water = slots, {}, 0

    def put(self, k: int, x) -> None:
        key = k if self.slots is None else k % self.slots
        if key in self.held:
            raise RuntimeError(f"bank slot {key} is still in flight")
        self.held[key] = x
        self.high_water = max(self.high_water, len(self.held))

    def take(self, k: int):
        return self.held.pop(k if self.slots is None else k % self.slots)


def run_pipeline(chunks: List[PipelineStageSpec], batches: Any, *,
                 overlap: bool, recompute: bool, forward_only: bool,
                 group, seed, tensor_shape, dtype,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """The tick loop of the module docstring over this rank's ``chunks``
    (one spec a virtual stage); returns the mean microbatch loss, summed
    over the pp ``group`` (the same on every rank).  ``seed`` is the loss
    cotangent; ``tensor_shape`` / ``dtype`` the wire's (needed when a
    stage receives: pp > 1).  ``stats``, when given, receives the ticks,
    the bank's slots and high water and the point-to-point batches."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p,
    )

    p, r = dist.get_world_size(group), dist.get_rank(group)
    vpp, n = len(chunks), num_microbatches(batches)
    S = vpp * p                             # global stages, a unit group
    units = -(-n // p) * S                  # a partial last group is skipped
    device = _first_leaf(batches).device
    if p > 1:
        if tensor_shape is None:
            raise ValueError("a pipeline of two or more stages needs the "
                             "wire's tensor_shape (and dtype)")
        p2p.ready(group)
    wire = (tuple(tensor_shape) if tensor_shape is not None else None,
            dtype or torch.float32)
    first_rank, last_rank = r == 0, r == p - 1

    def fwd_unit(k):
        """(microbatch, chunk) of forward unit k, or None if inactive."""
        if not 0 <= k < units:
            return None
        mb, v = (k // S) * p + k % p, (k // p) % vpp
        return (mb, v) if mb < n else None

    def bwd_unit(k):
        """(microbatch, chunk, its forward unit) of backward unit k."""
        if not 0 <= k < units:
            return None
        g, lane = k // S, k % p
        v = vpp - 1 - (k // p) % vpp
        mb = g * p + lane
        return (mb, v, g * S + v * p + lane) if mb < n else None

    def injects(v):
        return first_rank and v == 0

    def emits(v):
        return last_rank and v == vpp - 1

    def run(v, x, mb):
        spec = chunks[v]
        mbatch = index_microbatch(batches, mb)
        y = spec.stage(spec.first(mbatch) if injects(v) else x)
        return y, (spec.last(y, mbatch) if emits(v) else None)

    lag = S - 1 if overlap else 0
    if forward_only:
        ticks_f, ticks_b = units + p - 1, 0
    elif overlap:
        ticks_f, ticks_b = units + p + S - 2, 0
    else:
        ticks_f, ticks_b = units + p - 1, units + p - 1
    bank = _Bank(2 * S - 1 if overlap else None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    fwd_in: Dict[int, torch.Tensor] = {}    # wire inputs for the next tick
    bwd_in: Dict[int, torch.Tensor] = {}
    calls0 = p2p.p2p_calls()
    keep_graph = not (forward_only or overlap or recompute)

    def forward(k):
        nonlocal loss_sum
        unit = fwd_unit(k)
        if unit is None:
            return None
        mb, v = unit
        x = None if injects(v) else fwd_in.pop(k)
        if keep_graph:
            if x is not None:
                x.requires_grad_(x.is_floating_point())
            y, loss = run(v, x, mb)
            bank.put(k, (x, y, loss))
        else:
            with torch.no_grad():
                y, loss = run(v, x, mb)
            if not forward_only:
                bank.put(k, x)
        if loss is not None:
            loss_sum = loss_sum + loss.detach().float()
        return None if emits(v) else y.detach()

    def backward(k):
        unit = bwd_unit(k)
        if unit is None:
            return None
        mb, v, kf = unit
        if keep_graph:
            x, y, loss = bank.take(kf)
        else:
            x = bank.take(kf)
            if x is not None:
                x = x.detach().requires_grad_(x.is_floating_point())
            y, loss = run(v, x, mb)
        if emits(v):
            torch.autograd.backward(
                loss, torch.as_tensor(seed, dtype=loss.dtype,
                                      device=loss.device))
        else:
            torch.autograd.backward(y, bwd_in.pop(k))
        return None if injects(v) else x.grad

    for t in range(ticks_f + ticks_b):
        sweep_b = t >= ticks_f                 # the two-sweep backward
        tb = t - ticks_f if sweep_b else t     # the backward stream's tick
        kf = None if sweep_b else t - r
        kb = (tb - (p - 1 - r) - lag
              if (overlap and not forward_only) or sweep_b else None)
        y = forward(kf) if kf is not None else None
        dx = backward(kb) if kb is not None else None
        # the wire: what leaves this tick and what the next tick takes in
        sends, recvs, keys = [], [], []
        if y is not None:
            sends.append((y, (r + 1) % p))
        if dx is not None:
            sends.append((dx, (r - 1) % p))
        if kf is not None and t + 1 < ticks_f:
            nxt = fwd_unit(kf + 1)
            if nxt is not None and not injects(nxt[1]):
                recvs.append(wire + ((r - 1) % p,))
                keys.append(("f", kf + 1))
        if kb is not None:
            # (the first backward tick of the two sweeps receives nothing:
            # its only active unit is the last stage's loss seed)
            nxt = bwd_unit(kb + 1)
            if nxt is not None and not emits(nxt[1]):
                recvs.append(wire + ((r + 1) % p,))
                keys.append(("b", kb + 1))
        got = p2p.exchange(sends, recvs, group, device=device)
        for (kind, k), buf in zip(keys, got):
            (fwd_in if kind == "f" else bwd_in)[k] = buf
    if p > 1:
        dist.all_reduce(loss_sum, group=group)
    if stats is not None:
        stats.update(ticks=ticks_f + ticks_b, bank_slots=bank.slots,
                     bank_high_water=bank.high_water,
                     p2p_calls=p2p.p2p_calls() - calls0)
    return loss_sum / n


def pipelined(chunks: List[PipelineStageSpec], batches: Any, *, overlap: bool,
              recompute: bool, forward_only: bool, group, grad_scaler,
              scaler_state, tensor_shape, dtype, stats):
    """A pipelined schedule's body: the parameters' ``.grad`` cleared,
    :func:`run_pipeline` over the pp ``group`` (``parallel_state``'s by
    default), and ``(loss, grads)`` (grads None when ``forward_only``)."""
    if group is None:
        from apex_tpu_torch.transformer import parallel_state

        group = parallel_state.get_pipeline_model_parallel_group()
    if not forward_only:
        zero_grads(chunks)
    loss = run_pipeline(
        chunks, batches, overlap=overlap, recompute=recompute,
        forward_only=forward_only, group=group,
        seed=loss_seed(grad_scaler, scaler_state, num_microbatches(batches)),
        tensor_shape=tensor_shape, dtype=dtype, stats=stats)
    return loss, (None if forward_only else grads_of(chunks))
