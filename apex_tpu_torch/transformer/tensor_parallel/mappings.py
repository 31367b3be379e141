"""TP collective mappings with explicit forward/backward pairing
(counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``).

The Megatron f/g functions as ``torch.autograd.Function``s; each backward
is the conjugate collective:

| mapping                                 | forward        | backward       |
|-----------------------------------------|----------------|----------------|
| copy_to_tensor_model_parallel_region    | identity       | all-reduce     |
| reduce_from_tensor_model_parallel_region| all-reduce     | identity       |
| scatter_to_tensor_model_parallel_region | split last dim | all-gather     |
| gather_from_tensor_model_parallel_region| all-gather     | split last dim |
| scatter_to_sequence_parallel_region     | split dim 0    | all-gather 0   |
| gather_from_sequence_parallel_region    | all-gather 0   | reduce-scatter |
| reduce_scatter_to_sequence_parallel_region | reduce-scatter | all-gather 0 |

**The tensor-parallel region.** The JAX functions run inside
``shard_map`` over the tp axis and are the identity where the axis is
unbound (world size 1).  The port's twin of that binding is
:func:`tensor_parallel_region`: inside it, a mapping called without an
explicit ``group`` runs over the bound group; outside it, and with no
group given, every mapping is the identity.  The serving engine binds its
group around each model call (``DecodeEngine(tp=)``), and the
tensor-parallel layers read the bound group's size and rank when they are
built (:func:`tp_world_size`, :func:`maybe_axis_index`), as the flax
layers read the bound axis at init.

:func:`override_forward_allreduce` swaps the forward all-reduce of
:func:`reduce_from_tensor_model_parallel_region` calls tagged with a
matching ``kind`` for another function (the serving engine's quantized
all-reduce over the ``"row_linear"`` pair).  The JAX override is read
when a program is traced; here it is read at each call.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "override_forward_allreduce",
    "tensor_parallel_region",
    "bound_group",
    "current_tp_group",
    "tp_world_size",
    "maybe_axis_index",
    "collective_calls",
]

# the group bound by tensor_parallel_region (the port's shard_map binding)
_REGION: dict = {"group": None}
# every collective a mapping issued (the chip check counts them a step)
_CALLS = {"n": 0}


@contextlib.contextmanager
def tensor_parallel_region(group=None):
    """Bind ``group`` (default: ``parallel_state``'s tensor-parallel
    group) as the tp axis for the block; the previous binding comes back
    after it.  Binding a different group inside a bound region raises."""
    if group is None:
        from apex_tpu_torch.transformer import parallel_state

        group = parallel_state.get_tensor_model_parallel_group()
    prev = _REGION["group"]
    if prev is not None and prev is not group:
        raise RuntimeError("a different tensor-parallel group is already "
                           "bound; regions of two groups do not nest")
    _REGION["group"] = group
    try:
        yield group
    finally:
        _REGION["group"] = prev


def bound_group():
    """The group bound by :func:`tensor_parallel_region`, or None."""
    return _REGION["group"]


def current_tp_group():
    """The tensor-parallel group a training primitive acts over: the bound
    region's, else ``parallel_state``'s once it is initialized, else None
    (one process)."""
    if _REGION["group"] is not None:
        return _REGION["group"]
    from apex_tpu_torch.transformer import parallel_state

    if parallel_state.model_parallel_is_initialized():
        return parallel_state.get_tensor_model_parallel_group()
    return None


def tp_world_size(group=None) -> int:
    """Static tp world size: the group's (by default the bound one's), or
    1 outside a region (single-shard semantics)."""
    g = _REGION["group"] if group is None else group
    return 1 if g is None else dist.get_world_size(g)


def maybe_axis_index(group=None):
    """This process's rank in the group (by default the bound one), or
    None outside a region."""
    g = _REGION["group"] if group is None else group
    return None if g is None else dist.get_rank(g)


def collective_calls() -> int:
    """Collectives the mappings have issued in this process (all-reduce,
    all-gather and reduce-scatter each count one)."""
    return _CALLS["n"]


def _group(group):
    return _REGION["group"] if group is None else group


# --- the collectives -------------------------------------------------------


def _all_reduce(x, group):
    _CALLS["n"] += 1
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather_dim(x, dim, group):
    world = dist.get_world_size(group)
    _CALLS["n"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _split_my_shard(x, dim, group):
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    chunk = x.shape[dim] // world
    return x.narrow(dim, rank * chunk, chunk).contiguous()


def _reduce_scatter_dim(x, dim, group):
    world = dist.get_world_size(group)
    _CALLS["n"] += 1
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // world,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # renamed reduce_scatter_single in newer releases; the card's
        # PyTorch has only this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


# --- autograd pairs --------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split_my_shard(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, g.dim() - 1, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_dim(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        return _split_my_shard(g, g.dim() - 1, ctx.group), None


class _SPScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split_my_shard(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, 0, ctx.group), None


class _SPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tensor_parallel_output_grad):
        ctx.group = group
        ctx.reduce = tensor_parallel_output_grad
        return _all_gather_dim(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return _reduce_scatter_dim(g, 0, ctx.group), None, None
        return _split_my_shard(g, 0, ctx.group), None, None


class _SPReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_dim(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, 0, ctx.group), None


# --- public wrappers: identity outside a region ----------------------------


def copy_to_tensor_model_parallel_region(x, group=None):
    """Identity forward / all-reduce backward (the Megatron ``f``)."""
    g = _group(group)
    return x if g is None else _Copy.apply(x, g)


# the forward all-reduce override, read at each call: fn(x, group) for the
# reduce calls whose kind is in kinds
_FWD_ALLREDUCE_OVERRIDE: dict = {"fn": None, "kinds": ()}


@contextlib.contextmanager
def override_forward_allreduce(fn, kinds=("row_linear",)):
    """Within the block, :func:`reduce_from_tensor_model_parallel_region`
    calls with a matching ``kind`` compute ``fn(x, group)`` in place of
    the exact all-reduce.  Forward only: ``fn`` carries no backward, so
    this is a serving construct.  Nesting a different ``fn`` raises."""
    prev = dict(_FWD_ALLREDUCE_OVERRIDE)
    if (_FWD_ALLREDUCE_OVERRIDE["fn"] is not None
            and _FWD_ALLREDUCE_OVERRIDE["fn"] is not fn):
        raise RuntimeError(
            "override_forward_allreduce is already active with a "
            "different replacement — nested conflicting overrides are "
            "not supported")
    _FWD_ALLREDUCE_OVERRIDE["fn"] = fn
    _FWD_ALLREDUCE_OVERRIDE["kinds"] = tuple(kinds)
    try:
        yield
    finally:
        _FWD_ALLREDUCE_OVERRIDE.update(prev)


def reduce_from_tensor_model_parallel_region(x, group=None, *,
                                             kind="generic"):
    """All-reduce forward / identity backward (the Megatron ``g``).

    ``kind`` names the call site for :func:`override_forward_allreduce`:
    the row-parallel linears tag theirs ``"row_linear"``; every other
    caller keeps ``"generic"`` and the exact all-reduce."""
    g = _group(group)
    if g is None:
        return x
    fn = _FWD_ALLREDUCE_OVERRIDE["fn"]
    if fn is not None and kind in _FWD_ALLREDUCE_OVERRIDE["kinds"]:
        return fn(x, g)
    return _Reduce.apply(x, g)


def scatter_to_tensor_model_parallel_region(x, group=None):
    """Split last dim forward / all-gather backward."""
    g = _group(group)
    return x if g is None else _Scatter.apply(x, g)


def gather_from_tensor_model_parallel_region(x, group=None):
    """All-gather last dim forward / split backward."""
    g = _group(group)
    return x if g is None else _Gather.apply(x, g)


def scatter_to_sequence_parallel_region(x, group=None):
    """Split dim 0 forward / all-gather backward."""
    g = _group(group)
    return x if g is None else _SPScatter.apply(x, g)


def gather_from_sequence_parallel_region(x, group=None,
                                         tensor_parallel_output_grad=True):
    """All-gather dim 0 forward; reduce-scatter (or split) backward."""
    g = _group(group)
    if g is None:
        return x
    return _SPGather.apply(x, g, bool(tensor_parallel_output_grad))


def reduce_scatter_to_sequence_parallel_region(x, group=None):
    """Reduce-scatter dim 0 forward / all-gather backward."""
    g = _group(group)
    return x if g is None else _SPReduceScatter.apply(x, g)
