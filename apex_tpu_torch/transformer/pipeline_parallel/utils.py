"""Pipeline-parallel utilities (counterpart of
``apex_tpu/transformer/pipeline_parallel/utils.py``, apex's
``pipeline_parallel/utils.py``).

The microbatch-calculator singleton (``utils.py:58-157``), rank-0 and
last-rank printing, the left-to-right masks and position ids
(``:200-250``), the loss average over the data-parallel group, the
parameters' L2 norm, memory reports from ``torch.cuda``'s allocator
stats, and ``unwrap_model``.  Ranks are ``torch.distributed``'s (rank 0
alone when no process group is started), where the JAX package reads
``jax.process_index``.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)

logger = logging.getLogger(__name__)

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_AUTORESUME = None
_GLOBAL_TIMERS = None


def setup_microbatch_calculator(rank: int, rampup_batch_size: Optional[List[int]],
                                global_batch_size: int, micro_batch_size: int,
                                data_parallel_size: int) -> None:
    """utils.py:58-104 parity (global singleton with ensure-none check)."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise AssertionError("num microbatches calculator is already initialized.")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def _reconfigure_microbatch_calculator(rank, rampup_batch_size,
                                       global_batch_size, micro_batch_size,
                                       data_parallel_size) -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def destroy_microbatch_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def get_micro_batch_size():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.micro_batch_size


def get_num_microbatches():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples, consistency_check=True):
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples, consistency_check)


def get_autoresume():
    """ADLR autoresume hook (utils.py:142): the registered object or None."""
    return _GLOBAL_AUTORESUME


def get_timers(device="cuda"):
    """The process's :class:`~._timers.Timers`, made on the first call
    (whose ``device`` its barriers sync)."""
    global _GLOBAL_TIMERS
    if _GLOBAL_TIMERS is None:
        from apex_tpu_torch.transformer.pipeline_parallel._timers import Timers

        _GLOBAL_TIMERS = Timers(device)
    return _GLOBAL_TIMERS


def _rank_and_world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def print_rank_0(message: str) -> None:
    """Only global rank 0 prints (utils.py:159)."""
    if _rank_and_world()[0] == 0:
        print(message, flush=True)


def is_last_rank() -> bool:
    rank, world = _rank_and_world()
    return rank == world - 1


def print_rank_last(message: str) -> None:
    if is_last_rank():
        print(message, flush=True)


def listify_model(model: Any) -> List[Any]:
    return list(model) if isinstance(model, (list, tuple)) else [model]


def unwrap_model(model, module_instances=None):
    """utils.py unwrap_model parity: the port wraps no model chunk, so
    the identity, a chunk at a time (a list stays a list)."""
    del module_instances
    return list(model) if isinstance(model, list) else model


def get_ltor_masks_and_position_ids(data: torch.Tensor, eod_token=None,
                                    reset_position_ids: bool = False,
                                    reset_attention_mask: bool = False,
                                    eod_mask_loss: bool = False):
    """Left-to-right masks + position ids (utils.py:200-250) for ``data
    [b, s]`` token ids.

    Returns (attention_mask [b,1,s,s] bool where True = MASKED OUT,
    loss_mask [b,s] fp32, position_ids [b,s] int32), on ``data``'s
    device.  The per-document resets are computed without a host loop,
    as in the JAX package."""
    b, s = data.shape
    dev = data.device
    att = torch.triu(torch.ones((s, s), dtype=torch.bool, device=dev),
                     diagonal=1)
    att = att.expand(b, 1, s, s)

    loss_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    if eod_mask_loss and eod_token is not None:
        loss_mask = torch.where(data == eod_token, 0.0, loss_mask)

    arange = torch.arange(s, dtype=torch.int32, device=dev)
    position_ids = arange.expand(b, s)
    if eod_token is not None and (reset_position_ids or reset_attention_mask):
        is_eod = (data == eod_token).to(torch.int32)
        # an EOD at i - 1 starts a segment at i
        eod_before = torch.cat(
            [torch.zeros((b, 1), dtype=torch.int32, device=dev),
             is_eod[:, :-1]], dim=1)
        if reset_position_ids:
            seg_start = torch.cummax(
                torch.where(eod_before == 1, arange[None, :],
                            torch.zeros_like(eod_before)), dim=1).values
            position_ids = arange[None, :] - seg_start
        if reset_attention_mask:
            seg_id = torch.cumsum(eod_before, dim=1)
            same_seg = seg_id[:, :, None] == seg_id[:, None, :]
            att = att | ~same_seg[:, None, :, :]
    return att, loss_mask, position_ids


def average_losses_across_data_parallel_group(losses, group=None):
    """utils.py:253 parity: the losses stacked in fp32 and averaged over
    the data-parallel group (``parallel_state``'s by default), one
    all-reduce."""
    if group is None:
        from apex_tpu_torch.transformer import parallel_state

        group = parallel_state.get_data_parallel_group()
    stacked = torch.stack([torch.as_tensor(l, dtype=torch.float32).detach()
                           .reshape(()) for l in losses])
    dist.all_reduce(stacked, group=group)
    return stacked / dist.get_world_size(group)


def calc_params_l2_norm(params, across_model_parallel: bool = True):
    """The fp32 L2 norm of ``params`` (a module or an iterable of
    tensors), one ``mt_l2norm`` on CUDA.  ``across_model_parallel`` is
    accepted for the reference's signature; the norm is this rank's, as
    the JAX function's."""
    from apex_tpu_torch.utils.tree_math import tree_l2norm

    del across_model_parallel
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return tree_l2norm([p.detach() for p in params])


def report_memory(name: str, device="cuda") -> str:
    """utils.py:253 report_memory from ``torch.cuda``'s allocator stats:
    bytes in use, the peak and the card's total, in GiB.  With
    ``device="cpu"`` there are no allocator stats: zeros, and a debug
    line says so."""
    from apex_tpu_torch.ops._dispatch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        used = torch.cuda.memory_allocated(dev) / 2**30
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        limit = torch.cuda.get_device_properties(dev).total_memory / 2**30
    else:
        logger.debug("report_memory(%r): no allocator stats on the CPU", name)
        used = peak = limit = 0.0
    msg = (f"[{name}] memory (GiB) | in use: {used:.2f} | "
           f"peak: {peak:.2f} | limit: {limit:.2f}")
    print_rank_0(msg)
    return msg


def print_params_min_max_norm(params) -> None:
    """utils.py:265 parity: per-parameter min/max/norm dump of a module's
    named parameters (or a ``{name: tensor}`` mapping)."""
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    for name, leaf in items:
        leaf32 = leaf.detach().float()
        print_rank_0(
            f"{name}: min={float(leaf32.min()):.3e} "
            f"max={float(leaf32.max()):.3e} "
            f"norm={float(torch.linalg.norm(leaf32)):.3e}")
