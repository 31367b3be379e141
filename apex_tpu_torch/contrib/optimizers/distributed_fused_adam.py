"""DistributedFusedAdam: Adam / AdamW with ZeRO-2 sharded state
(counterpart of ``apex_tpu/contrib/optimizers/distributed_fused_adam.py``).

The math is :class:`~apex_tpu_torch.optimizers.FusedAdam`'s (apex's
``multi_tensor_adam``) on each rank's shard of the flat fp32 state; the
sharding, the gradients' reduce-scatter and the parameters' all-gather
are :class:`~apex_tpu_torch.contrib.optimizers._zero_base.ZeROOptimizer`'s.
Plain PyTorch, as the JAX update is plain jnp: ``mt_adam`` does not run.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.contrib.optimizers._zero_base import ZeROOptimizer
from apex_tpu_torch.optimizers._common import bias_corrections

__all__ = ["DistributedFusedAdam"]


class DistributedFusedAdam(ZeROOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, **zero_kwargs):
        if amsgrad:
            raise RuntimeError(
                "DistributedFusedAdam does not support the AMSGrad variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults, **zero_kwargs)
        self.adam_w_mode = adam_w_mode

    def _update_shard(self, g32, master, m32, v32, step_count, *,
                      seg_ids, num_segments):
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        eps, lr, wd = group["eps"], group["lr"], group["weight_decay"]
        if group["bias_correction"]:
            bc1, bc2 = bias_corrections(step_count, b1, b2)
        else:
            bc1 = bc2 = 1.0
        if not self.adam_w_mode and wd:
            g32 = g32 + wd * master      # L2 regularization into the gradient
        m32 = b1 * m32 + (1.0 - b1) * g32
        v32 = b2 * v32 + (1.0 - b2) * g32 * g32
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if self.adam_w_mode and wd:
            update = update + wd * master    # decoupled (AdamW)
        return master - lr * update, m32, v32
