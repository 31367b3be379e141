"""Column/Row-parallel linears and the vocab-parallel embedding
(counterpart of ``apex_tpu/transformer/tensor_parallel/layers.py``).

A layer built inside a tensor-parallel region
(:func:`~apex_tpu_torch.transformer.tensor_parallel.mappings.
tensor_parallel_region`, the port's twin of the JAX layers' ``shard_map``
binding) holds its rank's shard and runs Megatron's collectives; built
outside one it is the whole layer.  The world size and rank come from the
bound group when the layer is built (:func:`tp_world_size`,
:func:`maybe_axis_index`); a layer refuses to run in a region of another
size, and a sharded layer refuses to run outside its region.

Weights follow PyTorch's layout: a linear's ``weight`` is ``[out, in]``
(the flax ``kernel`` transposed).  A column layer shards dim 0 of its
weight (``[out / tp, in]``, with its bias), a row layer dim 1 (``[out,
in / tp]``, its bias whole, added after the reduction); the embedding's
``weight`` is ``[vocab / tp, h]``.

- column forward: identity into the region (or the sequence-parallel
  all-gather); with ``gather_output`` the output shards all-gathered.
- row forward: the input split across ranks unless ``input_is_parallel``;
  the output all-reduced (tagged ``"row_linear"``, the pair the serving
  engine may quantize) or reduce-scattered under sequence parallelism.
  Inside a region the reduction runs at every world size, world 1
  included, where the JAX layer skips it (an all-reduce of one rank
  returns its input bit for bit): a one-card tp server issues the same
  collectives as a larger one.
- the embedding masks the ids outside its vocab range, looks the rest up
  and all-reduces (above world size 1).

**Sequence-parallel gradients.**  Under sequence parallelism a rank sees
``s / tp`` of the tokens, so a replicated parameter used on that block
gets only its rank's part of the gradient: a row layer's bias (added
after the reduce-scatter) here, and the Llama RMSNorm scales.  Such a
parameter carries Megatron's ``sequence_parallel = True`` attribute, and
:func:`allreduce_sequence_parallel_grads` sums their gradients over the
tp group after the backward, so every rank holds the whole one.  The JAX
package leaves them partial (``layers.py:214``); the port's trainers make
the call (a deliberate difference).  Expert parallelism has the same
kind of parameter: the MoE router, replicated over the ep group, gets
only its rank's tokens' share.  It carries ``expert_replicated = True``,
and :func:`allreduce_expert_replicated_grads` sums those gradients over
the ep group.

The projections are plain ``torch.matmul``, as the JAX package leaves
them to XLA.  Fresh weights are drawn from an explicit
``torch.Generator``: ``normal(0, 1/sqrt(in))`` for the linears (the
variance of flax's ``lecun_normal``, over the whole input width) and
``normal(0, 0.02)`` for the embedding; inside a region each rank draws
its own shard from a generator seeded by one draw of the given generator
and the rank (:func:`shard_init`, the JAX ``fold_in``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    bound_group,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    maybe_axis_index,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
    tp_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "parallel_lm_logits", "normal_",
           "maybe_axis_index", "shard_init", "tp_world_size",
           "allreduce_sequence_parallel_grads", "all_reduce_gradients"]

# odd 64-bit constant folded with the rank (the golden-ratio increment)
_FOLD = 0x9E3779B97F4A7C15


def normal_(shape, std: float, *, dtype, device, generator=None):
    """A fresh ``normal(0, std)`` tensor, drawn in fp32 on ``device``."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return (out * std).to(dtype)


def shard_init(generator: Optional[torch.Generator], device,
               rank: Optional[int] = None) -> Optional[torch.Generator]:
    """The generator a rank draws its shard from: ``generator`` itself
    outside a region; inside one, a fresh generator on ``device`` seeded
    with one draw of ``generator`` (every rank draws the same value)
    folded with the rank, so shards draw independent values.  ``rank``
    names the shard of another group (an expert-parallel rank) in place
    of the bound region's."""
    if rank is None:
        rank = maybe_axis_index()
    if rank is None:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=device).item())
    g = torch.Generator(device=device)
    g.manual_seed((seed ^ (int(rank) * _FOLD)) % (1 << 63))
    return g


def _matmul(x, weight):
    """``x @ weight.T`` in ``x``'s dtype (fp32 accumulation on the card,
    as the JAX package's ``preferred_element_type=float32``)."""
    return torch.matmul(x, weight.to(x.dtype).t())


def _region_world(layer) -> int:
    """The bound region's world size, checked against the one the layer
    was built for: a sharded layer outside its region, or in a region of
    another size, would compute a partial product silently."""
    world = tp_world_size()
    bound = bound_group() is not None
    if (bound and world != layer.world) or (not bound and layer.world > 1):
        where = f"a tp region of {world}" if bound else "no tp region"
        raise RuntimeError(
            f"{type(layer).__name__} was built for tp world "
            f"{layer.world} and called in {where}: call a sharded model "
            f"inside tensor_parallel_region(group) of its own size")
    return world


class _Linear(nn.Module):
    """``skip_bias_add`` returns ``(x A, b)`` and leaves the bias add to the
    caller (to fuse it with what follows), as the JAX layers do.  The
    subclasses shard ``weight`` along ``_shard_dim`` and say in
    :meth:`_forward_with` which collectives surround the product."""

    _shard_dim = 0

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 *, skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.world = tp_world_size()
        dev = resolve_device(device)
        shape = [output_size, input_size]
        shape[self._shard_dim] = divide(shape[self._shard_dim], self.world)
        self.weight = nn.Parameter(normal_(
            tuple(shape), 1.0 / math.sqrt(input_size), dtype=dtype,
            device=dev, generator=shard_init(generator, dev)))
        nb = shape[0] if self._shard_dim == 0 else output_size
        self.bias = (nn.Parameter(torch.zeros(nb, dtype=dtype, device=dev))
                     if bias else None)

    def forward(self, x):
        return self._forward_with(x, self.weight)

    def _finish(self, y):
        if self.skip_bias_add:
            return y, self.bias
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ColumnParallelLinear(_Linear):
    """``Y = XA + b`` with A split by output columns (``weight`` rows)
    across tp ranks (``layers.py:106``).  The input is whole on every
    rank (or sequence-sharded with ``sequence_parallel_enabled``); the
    output is the rank's column shard unless ``gather_output``."""

    _shard_dim = 0

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 *, gather_output: bool = True, **kw):
        super().__init__(input_size, output_size, bias, **kw)
        if gather_output and self.sequence_parallel_enabled:
            raise RuntimeError(
                "gather_output is incompatible with sequence parallelism")
        self.gather_output = gather_output

    def _forward_with(self, x, weight):
        world = _region_world(self)
        if self.sequence_parallel_enabled:
            if world > 1:
                x = gather_from_sequence_parallel_region(x, None, True)
        elif bound_group() is not None:
            x = copy_to_tensor_model_parallel_region(x)
        y = _matmul(x, weight)
        if self.bias is not None and not self.skip_bias_add:
            y = y + self.bias.to(y.dtype)
        if self.gather_output and world > 1:
            y = gather_from_tensor_model_parallel_region(y)
        return (y, self.bias) if self.skip_bias_add else y


class RowParallelLinear(_Linear):
    """``Y = XA + b`` with A split by input rows (``weight`` columns)
    across tp ranks (``layers.py:161``).  The input is the rank's shard
    with ``input_is_parallel`` (after a column layer), else it is split
    here; the output is all-reduced (reduce-scattered under sequence
    parallelism) and then the whole bias is added."""

    _shard_dim = 1

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 *, input_is_parallel: bool = False, **kw):
        super().__init__(input_size, output_size, bias, **kw)
        if self.sequence_parallel_enabled and not input_is_parallel:
            raise RuntimeError(
                "To enable `sequence_parallel_enabled`, "
                "`input_is_parallel` must be `True`")
        self.input_is_parallel = input_is_parallel
        if self.bias is not None and self.sequence_parallel_enabled:
            # added whole to each rank's sequence block: partial gradients
            self.bias.sequence_parallel = True

    def _forward_with(self, x, weight):
        world = _region_world(self)
        if not self.input_is_parallel and world > 1:
            x = scatter_to_tensor_model_parallel_region(x)
        y = _matmul(x, weight)
        if bound_group() is not None:
            if self.sequence_parallel_enabled:
                y = reduce_scatter_to_sequence_parallel_region(y)
            else:
                # the per-layer pair (o_proj, down_proj) the serving
                # engine's quantized all-reduce may take over; every
                # other reduction stays exact
                y = reduce_from_tensor_model_parallel_region(
                    y, kind="row_linear")
        return self._finish(y)


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab split across tp ranks (``layers.py:218``):
    ids outside the rank's range look up row 0 and are zeroed, then the
    ranks' rows are all-reduced; at world size 1 a plain lookup."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.world = tp_world_size()
        self.num_embeddings = num_embeddings
        dev = resolve_device(device)
        self.weight = nn.Parameter(normal_(
            (divide(num_embeddings, self.world), embedding_dim), 0.02,
            dtype=dtype, device=dev, generator=shard_init(generator, dev)))

    def forward(self, ids):
        world = _region_world(self)
        if world == 1:
            return nn.functional.embedding(ids, self.weight)
        first, last = VocabUtility.vocab_range_from_per_partition_vocab_size(
            self.weight.shape[0], maybe_axis_index(), world)
        in_range = (ids >= first) & (ids < last)
        masked = torch.where(in_range, ids - first, torch.zeros_like(ids))
        out = nn.functional.embedding(masked, self.weight)
        out = torch.where(in_range[..., None], out, torch.zeros_like(out))
        return reduce_from_tensor_model_parallel_region(out)


def parallel_lm_logits(hidden, word_embeddings, group=None,
                       sequence_parallel_enabled: bool = False,
                       gather_output: bool = False):
    """Logits ``H @ E^T`` in fp32 (``layers.py:251``) with ``E``
    vocab-sharded: ``[s, b, vocab / tp]``, or the whole vocab with
    ``gather_output``.

    The operands go up to fp32 before the product, which is what the JAX
    package's ``preferred_element_type=float32`` computes: a product of
    two bf16 values is exact in fp32, and the sum runs in fp32."""
    if sequence_parallel_enabled:
        hidden = gather_from_sequence_parallel_region(hidden, group, True)
    else:
        hidden = copy_to_tensor_model_parallel_region(hidden, group)
    logits = torch.matmul(hidden.float(), word_embeddings.float().t())
    if gather_output:
        logits = gather_from_tensor_model_parallel_region(logits, group)
    return logits


def allreduce_sequence_parallel_grads(module, group=None, *,
                                      grads=None) -> None:
    """Sum over ``group`` (the bound or ``parallel_state``'s tp group by
    default) the gradients of the parameters tagged ``sequence_parallel``
    (see the module docstring), as :func:`_allreduce_tagged_grads` does;
    ``grads`` (a parameter-to-gradient mapping) stands in for ``.grad``."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        current_tp_group,
    )

    _allreduce_tagged_grads(module, "sequence_parallel",
                            current_tp_group() if group is None else group,
                            grads)


def allreduce_expert_replicated_grads(module, group) -> None:
    """Sum over the expert-parallel ``group`` the gradients of the
    parameters tagged ``expert_replicated`` (the MoE router), as
    :func:`_allreduce_tagged_grads` does."""
    _allreduce_tagged_grads(module, "expert_replicated", group)


def _allreduce_tagged_grads(module, tag: str, group, grads=None) -> None:
    """Sum over ``group`` the gradients of the parameters whose attribute
    ``tag`` is true, in place: one all-reduce a dtype, over those
    gradients flattened.  ``module`` is an ``nn.Module`` or an iterable of
    parameters; ``grads`` maps a parameter to its gradient (default: its
    ``.grad``).  Nothing is called when no tagged parameter has a
    gradient."""
    params = (module.parameters() if isinstance(module, nn.Module)
              else module)
    of = ((lambda p: p.grad) if grads is None
          else (lambda p: grads.get(p)))
    tagged = [of(p) for p in params if getattr(p, tag, False)]
    tagged = [g for g in tagged if g is not None]
    if tagged:
        all_reduce_gradients(tagged, group)


def all_reduce_gradients(grads, group, *, average: bool = False) -> None:
    """Sum ``grads`` over ``group`` in place, or with ``average`` divide
    the sums by the group's size (gloo has no average): one all-reduce a
    dtype, over the gradients of that dtype flattened."""
    world = torch.distributed.get_world_size(group)
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch._utils._flatten_dense_tensors(same)
        torch.distributed.all_reduce(flat, group=group)
        if average and world > 1:
            flat.div_(world)
        for g, f in zip(same, torch._utils._unflatten_dense_tensors(
                flat, same)):
            g.copy_(f)
