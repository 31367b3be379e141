"""SyncBatchNorm: batch norm with its statistics reduced over a process
group (counterpart of ``apex_tpu/parallel/sync_batchnorm.py``).

apex's ``SyncBatchNorm`` (the Python fallback and the ``syncbn`` kernels
over ``csrc/welford.cu``) computes Welford statistics on each rank, merges
them across the group and normalizes, with a fused-ReLU form.  The JAX
module merges locally centred fp32 ``(n, n * mean, M2, n * mean^2)`` with
one ``psum`` and gets the backward by differentiating through it.  Here:

- the forward takes the same local statistics and merges them with one
  all-reduce of a ``[4, C]`` fp32 tensor (:func:`sync_batch_stats`);
  without a group and with ``use_fast_variance`` the local statistics take
  one pass, ``E[x^2] - E[x]^2`` clamped at 0, as in the JAX module;
- ``torch.distributed.all_reduce`` records no gradient, so the backward is
  written out (:class:`_SyncBatchNormFn`): the per-channel sums ``sum(dy)``
  and ``sum(dy * xhat)`` are all-reduced in one ``[2, C]`` call, as
  apex's ``syncbn`` backward does, and give each rank the gradient of the
  global batch's normalization; the weight and bias gradients stay local
  (the data-parallel reduction sums them);
- the running variance takes the unbiased variance over the **global**
  count; parameters and statistics are fp32, the output is in the input's
  dtype; ``fuse_relu`` applies the ReLU and masks the gradient by it.

The channel dimension defaults to 1 (PyTorch's NCHW); the JAX module's
default is -1 (NHWC), and ``channel_axis`` takes either.  Outside
training (``model.eval()`` with running statistics) the module is a
plain normalization by the running buffers.  ``process_group=None`` is
local statistics, as the JAX module's ``axis_name=None``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

__all__ = ["SyncBatchNorm", "sync_batch_stats", "convert_syncbn_model"]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


# the backward's reduction of (sum(dy), sum(dy * xhat)); a module-level
# name so that a test can show what a forward-only sync gets wrong
_backward_all_reduce = _all_reduce


def _dims(x: torch.Tensor, ca: int):
    dims = tuple(i for i in range(x.dim()) if i != ca)
    shape = tuple(x.shape[i] if i == ca else 1 for i in range(x.dim()))
    return dims, shape


def sync_batch_stats(x: torch.Tensor, channel_axis: int = 1, group=None,
                     use_fast_variance: bool = True):
    """``(mean, var, n)`` of ``x`` over every dimension but
    ``channel_axis`` and over the ranks of ``group``, in fp32: the biased
    variance (``1 / n``) and the global count ``n`` (a 0-d fp32 tensor).

    With a group, each rank's locally centred ``(n, n * mean, M2, n *
    mean^2)`` go through one all-reduce and merge as Welford statistics;
    without one, ``use_fast_variance`` takes ``E[x^2] - E[x]^2`` in one
    pass (clamped at 0) and otherwise the same centred form."""
    ca = channel_axis % x.dim()
    dims, shape = _dims(x, ca)
    x32 = x.float()
    n_l = float(x.numel() // x.shape[ca])
    if group is None and use_fast_variance:
        mean = x32.mean(dims)
        mean2 = (x32 * x32).mean(dims)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        return mean, var, torch.tensor(n_l, device=x.device)
    mean_l = x32.mean(dims)
    centred = x32 - mean_l.view(shape)
    m2_l = (centred * centred).sum(dims)
    stats = torch.stack([torch.full_like(mean_l, n_l), n_l * mean_l, m2_l,
                         n_l * (mean_l * mean_l)])
    if group is not None:
        _all_reduce(stats, group)
    n, s1, m2, s2 = stats.unbind()
    mean = s1 / n
    var = torch.clamp((m2 + s2 - n * (mean * mean)) / n, min=0.0)
    return mean, var, n[0]


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode batch norm over the group's batch, with the backward
    written out (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, n, ca, fuse_relu, group):
        _, shape = _dims(x, ca)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        y = xhat
        if weight is not None:
            y = y * weight.view(shape)
        if bias is not None:
            y = y + bias.view(shape)
        if fuse_relu:
            y = torch.relu(y)
        y = y.to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, y if fuse_relu else None)
        ctx.ca, ctx.n, ctx.group = ca, n, group
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, y = ctx.saved_tensors
        dims, shape = _dims(x, ctx.ca)
        dy32 = dy.float()
        if y is not None:
            dy32 = dy32 * (y > 0)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_dy = dy32.sum(dims)
        sum_dy_xhat = (dy32 * xhat).sum(dims)
        dw = sum_dy_xhat if weight is not None else None
        db = sum_dy if ctx.has_bias else None
        dx = None
        if ctx.needs_input_grad[0]:
            sums = torch.stack([sum_dy, sum_dy_xhat])
            if ctx.group is not None:
                sums = _backward_all_reduce(sums, ctx.group)
            n = ctx.n
            scale = invstd if weight is None else invstd * weight
            dx = (dy32 - (sums[0] / n).view(shape)
                  - xhat * (sums[1] / n).view(shape)) * scale.view(shape)
            dx = dx.to(x.dtype)
        return dx, dw, db, None, None, None, None, None, None


class SyncBatchNorm(_BatchNorm):
    """Synchronized batch norm (apex's ``SyncBatchNorm``): PyTorch's
    ``BatchNorm`` parameters and buffers (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``) in fp32,
    statistics over ``process_group`` in training.

    ``channel_axis`` is the channel dimension (1, PyTorch's layout, by
    default; -1 for channels-last data); ``fuse_relu`` applies a ReLU;
    ``use_fast_variance`` picks the one-pass local statistics (without a
    group only).  ``momentum`` is the running update's weight of the new
    statistics, as in PyTorch and the JAX module."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, process_group=None,
                 channel_axis: int = 1, fuse_relu: bool = False,
                 use_fast_variance: bool = True, device=None):
        if momentum is None:
            raise ValueError("SyncBatchNorm: momentum=None (a cumulative "
                             "average) is not supported")
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device=device,
                         dtype=torch.float32)
        self.process_group = process_group
        self.channel_axis = channel_axis
        self.fuse_relu = fuse_relu
        self.use_fast_variance = use_fast_variance

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"SyncBatchNorm expects at least 2-d input, "
                             f"got {x.dim()}-d")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._normalize(x, self.fuse_relu)

    def _normalize(self, x: torch.Tensor, fuse_relu: bool) -> torch.Tensor:
        self._check_input_dim(x)
        ca = self.channel_axis % x.dim()
        if x.shape[ca] != self.num_features:
            raise ValueError(f"SyncBatchNorm({self.num_features}): input has "
                             f"{x.shape[ca]} channels on dim {ca}")
        if self.training or not self.track_running_stats:
            group = self.process_group
            with torch.no_grad():
                mean, var, n = sync_batch_stats(x, ca, group,
                                                self.use_fast_variance)
                if self.training and self.track_running_stats:
                    m = self.momentum
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * unbiased)
                    self.num_batches_tracked.add_(1)
                invstd = torch.rsqrt(var + self.eps)
            return _SyncBatchNormFn.apply(
                x, self.weight, self.bias, mean, invstd, n, ca, fuse_relu,
                group)
        _, shape = _dims(x, ca)
        y = (x.float() - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + self.eps)
        if self.weight is not None:
            y = y * self.weight.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        if fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def convert_syncbn_model(module: nn.Module, process_group=None,
                         channel_axis: int = 1) -> nn.Module:
    """``module`` with every ``torch.nn.BatchNorm{1,2,3}d`` (and
    ``torch.nn.SyncBatchNorm``) replaced by :class:`SyncBatchNorm` over
    ``process_group``, its weights, running buffers, momentum and eps
    carried across (apex's ``convert_syncbn_model``); a module that is
    itself a batch norm comes back converted.  Modules are replaced in
    place in their parents."""
    if isinstance(module, _BatchNorm) and not isinstance(module,
                                                         SyncBatchNorm):
        new = SyncBatchNorm(module.num_features, module.eps,
                            0.1 if module.momentum is None else module.momentum,
                            module.affine, module.track_running_stats,
                            process_group, channel_axis,
                            device=(module.weight.device if module.affine
                                    else None))
        with torch.no_grad():
            if module.affine:
                new.weight.copy_(module.weight)
                new.bias.copy_(module.bias)
            if module.track_running_stats:
                new.running_mean.copy_(module.running_mean)
                new.running_var.copy_(module.running_var)
                new.num_batches_tracked.copy_(module.num_batches_tracked)
        new.train(module.training)
        return new
    for name, child in module.named_children():
        converted = convert_syncbn_model(child, process_group, channel_axis)
        if converted is not child:
            setattr(module, name, converted)
    return module
