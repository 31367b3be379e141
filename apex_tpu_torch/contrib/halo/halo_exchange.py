"""Halo exchange for spatial parallelism (counterpart of
``apex_tpu/contrib/halo/halo_exchange.py``).

A tensor split along H (or W) over a line of ranks: each rank needs its
neighbors' edge rows to convolve its own rows.  :func:`left_right_halo_exchange`
swaps the edges with both neighbors by one ``batch_isend_irecv`` (ranks
at the two ends of the line get zeros from outside it: the line does not
wrap), in an autograd function whose backward sends each halo's gradient
back to the rank that owns those rows (JAX gets it from ``ppermute``).
:func:`halo_exchange_1d` returns the rank's unpadded block with the
neighbors' rows attached, :func:`spatial_conv2d` convolves that as the
unsplit tensor's ``SAME`` convolution would.

Differences from the JAX functions, kept on purpose: the layout is NCHW
with OIHW weights (PyTorch's, as the port's ResNet), so ``spatial_dim``
is 2 for H and 3 for W (JAX: 1 and 2 in NHWC); ``axis_name`` takes a
``torch.distributed`` process group (a mesh axis name under
``shard_map`` in JAX; a string raises ``ValueError``), and None is a line
of one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch.transformer.parallel_state import axis_group

__all__ = ["HaloExchanger1d", "halo_exchange_1d", "left_right_halo_exchange",
           "spatial_conv2d"]


def _swap(left_out, right_out, group):
    """``(left_in, right_in)``: ``left_out`` to rank ``r - 1``,
    ``right_out`` to rank ``r + 1``; what came from ``r - 1`` and ``r +
    1``, zeros past the line's ends."""
    left_in, right_in = (torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                         for t in (right_out, left_out))
    if group is None:
        return left_in, right_in
    n, r = dist.get_world_size(group), dist.get_rank(group)
    ops = []
    for peer, send, recv in ((r - 1, left_out, left_in),
                             (r + 1, right_out, right_in)):
        if 0 <= peer < n:
            peer = dist.get_global_rank(group, peer)
            ops += [dist.P2POp(dist.isend, send.contiguous(), peer, group),
                    dist.P2POp(dist.irecv, recv, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return left_in, right_in


class _HaloSwap(torch.autograd.Function):
    """The swap; its transpose is the same swap of the halos' gradients
    (rank ``r``'s left halo came from ``r - 1``'s right edge, whose
    gradient goes back there as that rank's right-edge gradient)."""

    @staticmethod
    def forward(ctx, left_out, right_out, group):
        ctx.group = group
        return _swap(left_out, right_out, group)

    @staticmethod
    def backward(ctx, d_left_in, d_right_in):
        d_left_out, d_right_out = _swap(d_left_in, d_right_in, ctx.group)
        return d_left_out, d_right_out, None


def left_right_halo_exchange(left_output_halo, right_output_halo, axis_name):
    """Swap halos with the line neighbors: rank ``i`` sends
    ``left_output_halo`` to rank ``i - 1`` and ``right_output_halo`` to
    rank ``i + 1``; returns ``(left_input_halo, right_input_halo)``, what
    arrived from the left and right neighbors, zeros at the line's ends."""
    group = axis_group(axis_name, "axis_name")
    return _HaloSwap.apply(left_output_halo, right_output_halo, group)


def _check_dim(spatial_dim: int) -> None:
    if spatial_dim not in (2, 3):
        raise ValueError(f"spatial_dim must be 2 (H) or 3 (W) of an NCHW "
                         f"tensor, got {spatial_dim}")


def halo_exchange_1d(y, half_halo: int, axis_name, spatial_dim: int = 2):
    """The rank's unpadded block ``y`` (``[N, C, H_local, W]`` for the
    default ``spatial_dim=2``) with ``half_halo`` neighbor rows attached on
    each side: ``[N, C, H_local + 2 * half_halo, W]``, zeros at the line's
    edges."""
    _check_dim(spatial_dim)
    if half_halo <= 0:
        return y
    size = y.shape[spatial_dim]
    if size < half_halo:
        raise ValueError(
            f"local spatial extent ({size}) smaller than half_halo "
            f"({half_halo}): the block is too thin to donate a halo")
    low_edge = y.narrow(spatial_dim, 0, half_halo)
    high_edge = y.narrow(spatial_dim, size - half_halo, half_halo)
    low_halo, high_halo = left_right_halo_exchange(low_edge, high_edge,
                                                   axis_name)
    return torch.cat([low_halo, y, high_halo], dim=spatial_dim)


class HaloExchanger1d:
    """The object form, ``PeerHaloExchanger1d``'s call shape: ``ex(y,
    H_split=True)`` attaches ``half_halo`` rows along H, or along W with
    ``H_split=False``."""

    def __init__(self, axis_name, half_halo: int):
        self.axis_name = axis_group(axis_name, "axis_name")
        self.half_halo = half_halo

    def __call__(self, y, H_split: bool = True):
        return halo_exchange_1d(y, self.half_halo, self.axis_name,
                                spatial_dim=2 if H_split else 3)


def spatial_conv2d(x, weight, axis_name, bias=None, stride: int = 1,
                   spatial_dim: int = 2):
    """A 2-D convolution of an H-split (or, with ``spatial_dim=3``,
    W-split) NCHW tensor by halo exchange: the unsplit tensor's ``SAME``
    convolution, split the same way.  ``weight`` is OIHW with odd extents;
    ``half_halo = (k - 1) // 2`` along the split dim."""
    _check_dim(spatial_dim)
    kh, kw = weight.shape[2], weight.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("spatial_conv2d needs odd kernel extents")
    if stride != 1:
        # SAME padding is asymmetric at stride > 1, so symmetric halos
        # would put the windows off the global stride grid
        raise NotImplementedError(
            "stride > 1 needs stride-grid-aligned asymmetric halos; split "
            "the batch or the other spatial dim instead")
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    padded = halo_exchange_1d(x, ph if spatial_dim == 2 else pw, axis_name,
                              spatial_dim)
    # the split dim is convolved VALID (the neighbors supplied its
    # padding), the other keeps SAME
    padding = (0, pw) if spatial_dim == 2 else (ph, 0)
    return F.conv2d(padded, weight, bias, stride, padding)
