"""ZeRO-2 optimizer core: optimizer state sharded over a data-parallel
process group (counterpart of ``apex_tpu/contrib/optimizers/_zero_base.py``).

apex's ``DistributedFusedAdam`` keeps each data-parallel rank's slice of
the flattened optimizer state, reduce-scatters the gradients where DDP
all-reduces them, updates its slice and all-gathers the parameters.  The
JAX package builds the step from ``psum_scatter``, an elementwise shard
update and ``all_gather`` inside ``shard_map``; here, over a
``torch.distributed`` group, one step is:

1. every parameter's gradient packed, in ``grad_sync_dtype`` (fp32 by
   default), into one flat buffer padded to a multiple of ``1024 * world``
   elements (:func:`~apex_tpu_torch.utils.packing.pack_pytree`);
2. ``dist.reduce_scatter_tensor`` of that buffer: rank ``r`` receives the
   sum of its contiguous shard ``[r * shard, (r + 1) * shard)``, averaged
   over the group (``average_grad_sync``), unscaled by ``grad_scale``;
3. the shard's update in fp32 on the rank's fp32 masters
   (``store_params``), or on masters rebuilt from the bf16 parameters and
   their stored low 16 bits (``store_param_remainders``), with the moments
   in ``state_dtype`` (or fp16 with per-parameter scales,
   ``with_scaled_states``): the subclass's ``_update_shard``;
4. a true ``found_inf`` (a 0-d bool on the device) keeps the whole state,
   the step count included, and the shard's old values;
5. ``dist.all_gather_into_tensor`` of the updated shards (bf16 under
   ``store_param_remainders``, else fp32 or ``param_sync_dtype``) and each
   parameter copied back from the gathered buffer.

Per-parameter quantities over a shard (LAMB's trust ratios, the state
scales) come from the element -> parameter map of
:func:`~apex_tpu_torch.ops.packed_update.segment_ids_for_spec`, made on
the device once for the layout, summed with ``index_add_`` or maxed with
``scatter_reduce`` and all-reduced over the group.  The update is plain
PyTorch, as the JAX update is plain jnp.

The optimizer is a ``torch.optim.Optimizer`` over one parameter group,
updated in place by :meth:`ZeROOptimizer.step`; its sharded state is
:attr:`ZeROOptimizer.zero_state` (a :class:`ZeROState`), made from the
parameters by :meth:`~ZeROOptimizer.init` or at the first step.
``process_group=None`` is the default group (the whole world).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.packed_update import segment_ids_for_spec
from apex_tpu_torch.utils.packing import (
    PackedSpec,
    make_packed_spec,
    pack_pytree,
    unpack_pytree,
)

__all__ = ["ZeROState", "ZeROOptimizer"]


def _split_bf16(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (bf16 high half, int16 holding the low 16 bits); the halves
    read from an int16 view of the fp32 words (little-endian: low, high),
    so the round trip is exact for every bit pattern."""
    halves = x32.contiguous().view(torch.int16).view(-1, 2)
    return (halves[:, 1].contiguous().view(torch.bfloat16),
            halves[:, 0].contiguous())


def _merge_bf16(hi_bf16: torch.Tensor, lo_i16: torch.Tensor) -> torch.Tensor:
    """(bf16 high half, int16 low half) -> the exact fp32."""
    words = torch.stack([lo_i16, hi_bf16.contiguous().view(torch.int16)],
                        dim=-1)
    return words.view(-1).view(torch.float32)


class ZeROState(NamedTuple):
    """A rank's sharded optimizer state; each ``*_shard`` tensor and the
    moments hold ``padded_total / world`` elements."""

    step: torch.Tensor                        # int32 0-d, the same on every rank
    param_shard: Optional[torch.Tensor]       # fp32 masters (store_params)
    remainder_shard: Optional[torch.Tensor]   # int16 low bits (remainders)
    exp_avg: torch.Tensor                     # state_dtype
    exp_avg_sq: torch.Tensor
    exp_avg_scale: Optional[torch.Tensor]     # fp32 [n_params + 1]
    exp_avg_sq_scale: Optional[torch.Tensor]


def _where(found: Optional[torch.Tensor], old, new):
    if found is None or new is None:
        return new
    return torch.where(found, old, new)


class ZeROOptimizer(torch.optim.Optimizer):
    """Shared ZeRO-2 machinery; a subclass implements ``_update_shard``
    (see the module docstring).  The gradients in ``p.grad`` are this
    rank's own, unreduced: the step reduces them itself (a parameter
    without a gradient counts as a zero gradient)."""

    def __init__(self, params, defaults: dict, *, process_group=None,
                 state_dtype: Optional[torch.dtype] = None,
                 grad_sync_dtype: Optional[torch.dtype] = None,
                 param_sync_dtype: Optional[torch.dtype] = None,
                 average_grad_sync: bool = True, store_params: bool = True,
                 store_param_remainders: bool = False,
                 with_scaled_states: bool = False):
        if store_param_remainders and not store_params:
            raise ValueError("store_param_remainders requires store_params")
        if state_dtype is None:
            # scaled state keeps fp16 moments in range; else fp32 moments
            state_dtype = torch.float16 if with_scaled_states else torch.float32
        elif with_scaled_states and state_dtype == torch.float32:
            raise ValueError(
                "with_scaled_states keeps per-tensor scales for low-precision "
                "state; it is incompatible with explicit state_dtype=float32")
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__} shards one flat buffer: "
                             f"give it one parameter group")
        self.group = process_group
        self.state_dtype = state_dtype
        self.grad_sync_dtype = grad_sync_dtype or torch.float32
        self._param_sync_dtype = param_sync_dtype
        self.average_grad_sync = average_grad_sync
        self.store_params = store_params
        self.store_param_remainders = store_param_remainders
        self.with_scaled_states = with_scaled_states
        self.zero_state: Optional[ZeROState] = None
        self._seg_cache = None

    # ---- layout -----------------------------------------------------------

    @property
    def _params(self):
        return list(self.param_groups[0]["params"])

    def _layout(self) -> Tuple[PackedSpec, int, int, int]:
        if not dist.is_initialized():
            raise RuntimeError(
                f"{type(self).__name__} shards its state over a process "
                f"group: call torch.distributed.init_process_group first")
        n = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        spec = make_packed_spec(self._params, pad_to=1024 * n)
        return spec, n, spec.padded_total // n, rank

    def _shard_segment_ids(self, spec, shard: int, rank: int, device):
        """Element -> parameter index for this rank's shard, made on the
        device once for the layout."""
        key = (spec.shapes, shard, rank, device)
        if self._seg_cache is None or self._seg_cache[0] != key:
            ids = segment_ids_for_spec(spec, device)
            self._seg_cache = (key, ids[rank * shard:(rank + 1) * shard]
                               .contiguous())
        return self._seg_cache[1]

    def _param_sync_dtype_for(self) -> torch.dtype:
        if self._param_sync_dtype is not None:
            return self._param_sync_dtype
        if self.store_param_remainders:
            return torch.bfloat16
        return torch.float32

    def _check_remainder_dtypes(self, spec: PackedSpec) -> None:
        if self.store_param_remainders:
            bad = {str(d) for d in spec.dtypes if d != torch.bfloat16}
            if bad:
                raise ValueError(
                    "store_param_remainders needs every parameter in bf16 "
                    f"(fp32 is reconstructed from bf16 bits); got {bad}")

    # ---- per-tensor scaled state -----------------------------------------

    def _decode_state(self, x, scale, seg_ids):
        if scale is None:
            return x.float()
        return x.float() * scale[seg_ids]

    def _encode_state(self, x32, seg_ids, num_segments):
        """Each parameter's state scaled to fill fp16's range (its largest
        magnitude to 2**14), the maximum taken over the group."""
        if not self.with_scaled_states:
            return x32.to(self.state_dtype), None
        per = torch.zeros(num_segments, dtype=torch.float32,
                          device=x32.device).scatter_reduce_(
            0, seg_ids.long(), x32.abs(), "amax", include_self=True)
        dist.all_reduce(per, op=dist.ReduceOp.MAX, group=self.group)
        scale = torch.clamp(per / 16384.0, min=1e-30)
        return (x32 / scale[seg_ids]).to(self.state_dtype), scale

    # ---- state ------------------------------------------------------------

    @torch.no_grad()
    def init(self) -> ZeROState:
        """This rank's state from the parameters as they are: its shard of
        the padded fp32 buffer as masters (or, with remainders, their low
        bits), zero moments, step 0."""
        spec, n, shard, rank = self._layout()
        self._check_remainder_dtypes(spec)
        device = self._params[0].device
        flat32 = pack_pytree(self._params, dtype=torch.float32,
                             pad_to=1024 * n).flat
        master = flat32[rank * shard:(rank + 1) * shard].clone()
        del flat32
        param_shard = remainder = None
        if self.store_param_remainders:
            _, remainder = _split_bf16(master)
        elif self.store_params:
            param_shard = master
        zeros = torch.zeros(shard, dtype=self.state_dtype, device=device)
        scales = None
        if self.with_scaled_states:
            scales = torch.full((spec.num_leaves + 1,), 1e-30,
                                dtype=torch.float32, device=device)
        self.zero_state = ZeROState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            param_shard=param_shard, remainder_shard=remainder,
            exp_avg=zeros, exp_avg_sq=zeros.clone(),
            exp_avg_scale=scales,
            exp_avg_sq_scale=None if scales is None else scales.clone())
        return self.zero_state

    def _master_shard(self, state: ZeROState, flat_param_shard):
        if self.store_param_remainders:
            return _merge_bf16(flat_param_shard, state.remainder_shard)
        if self.store_params:
            return state.param_shard
        return flat_param_shard.float()

    # ---- the step ---------------------------------------------------------

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None, *,
             grad_scale: Union[None, float, torch.Tensor] = None,
             found_inf: Union[None, bool, torch.Tensor] = None):
        """One ZeRO-2 step (the module docstring's five parts): no
        all-reduce of the gradients anywhere, one reduce-scatter and one
        all-gather.  ``grad_scale`` divides the gradients in fp32; a true
        ``found_inf`` leaves the parameters and the state as they were."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.zero_state is None:
            self.init()
        state = self.zero_state
        spec, n, shard, rank = self._layout()
        params = self._params
        device = params[0].device

        # -- the gradients' reduce-scatter -------------------------------
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat_g = pack_pytree(grads, dtype=self.grad_sync_dtype,
                             pad_to=1024 * n).flat
        g_shard = torch.empty(shard, dtype=flat_g.dtype, device=device)
        dist.reduce_scatter_tensor(g_shard, flat_g, group=self.group)
        del flat_g, grads
        g32 = g_shard.float()
        if self.average_grad_sync:
            g32 = g32 / n
        if grad_scale is not None:
            scale = torch.as_tensor(grad_scale, dtype=torch.float32,
                                    device=device)
            g32 = g32 * (1.0 / scale)

        # -- the shard's update ---------------------------------------------
        psync = self._param_sync_dtype_for()
        flat_p_shard = pack_pytree(params, dtype=psync, pad_to=1024 * n
                                   ).flat[rank * shard:(rank + 1) * shard]
        master = self._master_shard(state, flat_p_shard)
        nseg = spec.num_leaves + 1
        seg_ids = (self._shard_segment_ids(spec, shard, rank, device)
                   if self._needs_segments() else None)
        step_count = state.step + 1
        m32 = self._decode_state(state.exp_avg, state.exp_avg_scale, seg_ids)
        v32 = self._decode_state(state.exp_avg_sq, state.exp_avg_sq_scale,
                                 seg_ids)
        new_master, new_m32, new_v32 = self._update_shard(
            g32, master, m32, v32, step_count, seg_ids=seg_ids,
            num_segments=nseg)
        del g32, m32, v32
        new_m, m_scale = self._encode_state(new_m32, seg_ids, nseg)
        del new_m32
        new_v, v_scale = self._encode_state(new_v32, seg_ids, nseg)
        del new_v32
        new_param_shard = new_remainder = None
        if self.store_param_remainders:
            out_shard, new_remainder = _split_bf16(new_master)
        else:
            if self.store_params:
                new_param_shard = new_master
            out_shard = new_master.to(psync)

        # -- a skipped step keeps everything (the step count too) -----------
        found = None
        if found_inf is not None:
            found = torch.as_tensor(found_inf, device=device).to(torch.bool)
        out_shard = _where(found, flat_p_shard, out_shard)
        self.zero_state = ZeROState(*(
            _where(found, old, new) for old, new in zip(state, ZeROState(
                step=step_count, param_shard=new_param_shard,
                remainder_shard=new_remainder, exp_avg=new_m,
                exp_avg_sq=new_v, exp_avg_scale=m_scale,
                exp_avg_sq_scale=v_scale))))

        # -- the parameters' all-gather ---------------------------------------
        flat_new = torch.empty(shard * n, dtype=out_shard.dtype, device=device)
        dist.all_gather_into_tensor(flat_new, out_shard.contiguous(),
                                    group=self.group)
        for p, new in zip(params, unpack_pytree(flat_new, spec)):
            p.copy_(new)
        return loss

    # -- subclass hooks ------------------------------------------------------

    def _needs_segments(self) -> bool:
        return self.with_scaled_states

    def _update_shard(self, g32, master, m32, v32, step_count, *,
                      seg_ids, num_segments):
        """``(new_master, new_m32, new_v32)``, fp32 ``[shard]``."""
        raise NotImplementedError

    # -- norms shared by subclasses --------------------------------------------

    def _global_sqsum(self, x32: torch.Tensor) -> torch.Tensor:
        s = torch.sum(x32 * x32)
        dist.all_reduce(s, group=self.group)
        return s

    def _per_param_sqsum(self, x32, seg_ids, num_segments) -> torch.Tensor:
        s = torch.zeros(num_segments, dtype=torch.float32,
                        device=x32.device).index_add_(0, seg_ids, x32 * x32)
        dist.all_reduce(s, group=self.group)
        return s
