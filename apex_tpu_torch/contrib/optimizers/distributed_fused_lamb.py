"""DistributedFusedLAMB: LAMB with ZeRO-2 sharded state (counterpart of
``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``).

The global gradient norm clips the gradient before the update; each
parameter's trust ratio ``||p|| / ||update||`` comes from its elements'
squares summed over the rank's shard by segment (``index_add_`` over the
element -> parameter map) and all-reduced over the group.  Plain
PyTorch, as the JAX update is plain jnp.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.contrib.optimizers._zero_base import ZeROOptimizer
from apex_tpu_torch.optimizers._common import bias_corrections

__all__ = ["DistributedFusedLAMB"]


class DistributedFusedLAMB(ZeROOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, adam_w_mode: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, **zero_kwargs):
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults, **zero_kwargs)
        self.adam_w_mode = adam_w_mode
        self.use_nvlamb = use_nvlamb

    def _needs_segments(self) -> bool:
        return True

    def _update_shard(self, g32, master, m32, v32, step_count, *,
                      seg_ids, num_segments):
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        eps, lr, wd = group["eps"], group["lr"], group["weight_decay"]
        max_norm = group["max_grad_norm"]
        if max_norm:
            # the global gradient norm's clip before the update
            gnorm = torch.sqrt(self._global_sqsum(g32))
            g32 = g32 / torch.clamp(gnorm / max_norm, min=1.0)
        if group["bias_correction"]:
            bc1, bc2 = bias_corrections(step_count, b1, b2)
        else:
            bc1 = bc2 = 1.0
        beta3 = 1.0 - b1 if group["grad_averaging"] else 1.0
        if not self.adam_w_mode and wd:
            g32 = g32 + wd * master
        m32 = b1 * m32 + beta3 * g32
        v32 = b2 * v32 + (1.0 - b2) * g32 * g32
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if self.adam_w_mode and wd:
            update = update + wd * master
        # each parameter's trust ratio ||p|| / ||update|| over the shards
        p_norm = torch.sqrt(self._per_param_sqsum(master, seg_ids,
                                                  num_segments))
        u_norm = torch.sqrt(self._per_param_sqsum(update, seg_ids,
                                                  num_segments))
        ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                            torch.ones_like(p_norm))
        if not (wd or self.use_nvlamb):
            ratio = torch.ones_like(ratio)
        return master - lr * ratio[seg_ids] * update, m32, v32
