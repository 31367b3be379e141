"""Quantized serving: int8 weights and an int8 KV cache (counterpart of
``apex_tpu/serving/quant.py`` without its tensor-parallel pieces).

Opt-in with ``DecodeEngine(..., quant=QuantConfig(...))``; an engine
without it is the fp engine.  Two levers, both on the int8 primitives of
:mod:`apex_tpu_torch.amp.quant`:

- **weights**: the seven projections of every layer (q/k/v/o/gate/up/
  down) and the LM head when it is untied are held as :class:`QTensor`
  (int8 payload + one fp32 scale per output channel) by
  :func:`quantize_params`; the embedding and the norm scales stay as they
  are.  Each projection dequantizes its own weight inside its forward, to
  the weight's original dtype, right before its product
  (:class:`QuantLinear`): the same values the JAX engine gets from
  ``dequant_params`` inside its jitted bodies, with one projection's
  float copy alive at a time and the resident weights at int8.
- **kv**: the decode cache stores int8 K/V with one fp32 scale per
  (position, kv head) (:class:`~apex_tpu_torch.serving.kv_cache.
  QuantKVCache` dense, :class:`~apex_tpu_torch.serving.paged_kv_cache.
  QuantPagedKVCache` paged).  Reads dequantize; capture hands out
  dequantized fp32 rows and restore requantizes them, so an int8 payload
  survives capture -> restore bit for bit.

``QuantConfig(allreduce=True)`` (the quantized tensor-parallel psum)
needs ``tp=``: the engine runs :func:`quantized_allreduce` in place of
the exact all-reduce of the per-layer ``row_linear`` pair (o_proj,
down_proj) and refuses it without ``tp=``, as the JAX engine does.

Under tensor parallelism each rank holds its shard of the int8 weights
(:func:`serving_param_spec`): a payload shards like the weight it
replaced, a scale with the output rows of column layers and the LM head,
and whole on every rank for row layers.  A row layer's scale reduces over
the whole input width, which no rank holds, so quantizing a row shard
all-reduces the rows' amax (max) over the group first: every rank gets
the scales of the whole weight, as the JAX engine quantizes the whole
tree before sharding it.

Acceptance is agreement, not bits: greedy streams against the fp engine
at a high rate with a bounded per-position logit error
(:func:`evaluate_quant`).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from apex_tpu_torch._logging import emit_event
from apex_tpu_torch.amp.quant import INT8_QMAX, dequantize_int8, quantize_int8
from apex_tpu_torch.transformer.parallel_state import TENSOR_PARALLEL_AXIS
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    RowParallelLinear,
    _Linear,
)

__all__ = ["QuantConfig", "QTensor", "QuantLinear", "quantize_params",
           "quantize_state_dict", "dequant_params", "is_quantized", "stream_agreement",
           "max_logit_error", "kv_bytes_per_token", "param_bytes",
           "evaluate_quant", "serving_param_spec", "quantized_allreduce"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Which quantization levers a :class:`DecodeEngine` turns on:
    ``weights`` (projections + untied LM head int8, per output channel),
    ``kv`` (the decode cache int8, per (position, head)), ``allreduce``
    (the tp psum pair as an int8 exchange; needs ``tp=``)."""

    weights: bool = True
    kv: bool = True
    allreduce: bool = False

    def __post_init__(self):
        if not (self.weights or self.kv or self.allreduce):
            raise ValueError(
                "QuantConfig with every lever off — pass quant=None "
                "instead (the default-off path is the fp engine)")


class QTensor(nn.Module):
    """One int8-quantized weight: ``q`` int8 (the weight's shape) and
    ``scale`` fp32 (the shape without ``axis``, the reduced input axis),
    both buffers; ``dtype`` is the weight's original dtype, which
    :meth:`dequantize` returns."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, axis: int,
                 dtype: torch.dtype):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.axis = int(axis)
        self.dtype = dtype

    @classmethod
    def quantize(cls, weight: torch.Tensor, axis: int,
                 group=None) -> "QTensor":
        """``group``: the input axis is split across its ranks (a row
        shard), so the amax is all-reduced before the scale is taken."""
        with torch.no_grad():
            q, scale = _quantize(weight.detach(), axis, group)
        return cls(q, scale, axis, weight.dtype)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def dequantize(self) -> torch.Tensor:
        return dequantize_int8(self.q, self.scale, axis=self.axis,
                               dtype=self.dtype)

    def extra_repr(self) -> str:
        return (f"shape={tuple(self.q.shape)}, axis={self.axis}, "
                f"dtype={self.dtype}")


def _quantize(x: torch.Tensor, axis: int, group=None):
    """:func:`quantize_int8` over ``axis``; with a ``group`` of more than
    one rank the amax is all-reduced (max) over it first, so the scale is
    the whole weight's (the same arithmetic, step for step)."""
    if group is None or torch.distributed.get_world_size(group) == 1:
        return quantize_int8(x, axis=axis)
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=axis, keepdim=True)
    torch.distributed.all_reduce(amax, op=torch.distributed.ReduceOp.MAX,
                                 group=group)
    scale = torch.where(amax > 0, amax / INT8_QMAX,
                        torch.ones((), dtype=torch.float32, device=x.device))
    q = torch.clamp(torch.round(xf / scale), -INT8_QMAX,
                    INT8_QMAX).to(torch.int8)
    return q, scale.squeeze(axis)


# the float layer's attributes its product and collectives read
_LAYER_ATTRS = ("skip_bias_add", "sequence_parallel_enabled", "world",
                "gather_output", "input_is_parallel")


class QuantLinear(nn.Module):
    """A projection whose ``weight`` is a :class:`QTensor` (``[out, in]``,
    one scale per output row): the forward dequantizes it to its original
    dtype and runs the float layer's product and collectives.
    ``float_cls`` is the layer class it replaced, which
    :func:`dequant_params` builds again.  A row-parallel shard takes its
    scales over the bound tensor-parallel group (:func:`_quantize`)."""

    def __init__(self, linear: _Linear):
        super().__init__()
        self.float_cls = type(linear)
        for attr in _LAYER_ATTRS:
            if hasattr(linear, attr):
                setattr(self, attr, getattr(linear, attr))
        group = (mappings.bound_group()
                 if isinstance(linear, RowParallelLinear) else None)
        self.weight = QTensor.quantize(linear.weight, axis=1, group=group)
        self.bias = linear.bias

    _finish = _Linear._finish

    def forward(self, x):
        return self.float_cls._forward_with(self, x, self.weight.dequantize())


# the projections quantize_params touches: per output channel, reducing
# over the input axis (axis 1 of torch's [out, in], the flax kernel's
# axis 0); the LM head [vocab, h] per vocab row (axis 1)
_WEIGHT_QUANT_MODULES = ("q_proj", "k_proj", "v_proj", "o_proj",
                         "gate_proj", "up_proj", "down_proj")


def _quant_targets(model: nn.Module):
    """``(name, module)`` of every float projection to quantize."""
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, _Linear)
            and name.rsplit(".", 1)[-1] in _WEIGHT_QUANT_MODULES]


def _set_submodule(root: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, child, module)


def quantize_params(model: nn.Module) -> nn.Module:
    """A new module with every projection of
    ``_WEIGHT_QUANT_MODULES`` and the untied LM head held int8
    (:class:`QuantLinear`, :class:`QTensor`); the embedding and the norm
    scales are copied as they are.  The caller's model is not altered.  A
    model already quantized comes back as it is."""
    if is_quantized(model):
        return model
    targets = _quant_targets(model)
    head = getattr(model, "lm_head", None)
    quant_head = isinstance(head, nn.Parameter)
    # the weights about to be quantized are not copied: the memo maps
    # each to an empty placeholder that the replacement below drops
    memo = {id(mod.weight): torch.empty(0) for _, mod in targets}
    if quant_head:
        memo[id(head)] = torch.empty(0)
    new = copy.deepcopy(model, memo)
    for name, mod in targets:
        quant = QuantLinear(mod)
        quant.bias = new.get_submodule(name).bias       # the copy's
        _set_submodule(new, name, quant)
    if quant_head:
        del new.lm_head
        new.lm_head = QTensor.quantize(head, axis=1)
    return new


def quantize_state_dict(state: dict, group=None) -> dict:
    """A float ``state_dict`` in the layout of ``quantize_params(model)``:
    every weight that function holds int8 (the projections of
    ``_WEIGHT_QUANT_MODULES`` and an ``lm_head``, by name) becomes its
    ``<name>.q`` payload and ``<name>.scale`` scales, quantized as it
    quantizes them; every other tensor is kept as it is (by reference).
    A hot reload hands an int8 engine a float checkpoint through this.
    With ``group`` (a tp rank's shard dict) the row-parallel weights take
    their scales over the group, as :class:`QuantLinear` does."""
    out = {}
    for name, t in state.items():
        prefix, _, attr = name.rpartition(".")
        module = prefix.rsplit(".", 1)[-1]
        if name == "lm_head" or (
                attr == "weight" and module in _WEIGHT_QUANT_MODULES):
            row = module in ("o_proj", "down_proj")
            with torch.no_grad():
                q, scale = _quantize(t.detach(), 1, group if row else None)
            out[f"{name}.q"], out[f"{name}.scale"] = q, scale
        else:
            out[name] = t
    return out


def is_quantized(model: nn.Module) -> bool:
    """True when the module holds any :class:`QTensor`."""
    return any(isinstance(m, QTensor) for m in model.modules())


def dequant_params(model: nn.Module) -> nn.Module:
    """A new float module with every :class:`QTensor` expanded back to
    its original dtype (the projections as their float layer class); a
    float model comes back as a copy."""
    new = copy.deepcopy(model)
    for name, mod in list(new.named_modules()):
        if isinstance(mod, QuantLinear):
            lin = mod.float_cls.__new__(mod.float_cls)
            nn.Module.__init__(lin)
            for attr in _LAYER_ATTRS:
                if hasattr(mod, attr):
                    setattr(lin, attr, getattr(mod, attr))
            lin.weight = nn.Parameter(mod.weight.dequantize())
            lin.bias = mod.bias
            _set_submodule(new, name, lin)
    head = getattr(new, "lm_head", None)
    if isinstance(head, QTensor):
        del new.lm_head
        new.lm_head = nn.Parameter(head.dequantize())
    return new


# ---- tensor parallelism ----------------------------------------------------


def serving_param_spec(name: str, axis_name: str = TENSOR_PARALLEL_AXIS
                       ) -> tuple:
    """Quant-aware tp partition spec of one serving ``state_dict`` entry
    (``apex_tpu/serving/quant.py:207``), in the port's ``[out, in]``
    layout.

    Float entries take :func:`~apex_tpu_torch.models.llama.tp_param_spec`.
    A quantized weight's ``<name>.q`` payload shards like ``<name>``; its
    per-output-row ``<name>.scale`` follows the output rows: split for the
    column layers and the LM head, whole for the row layers (their output
    survives the all-reduce whole on every rank)."""
    from apex_tpu_torch.models.llama import _TP_COLUMN_MODULES, tp_param_spec

    if name.endswith(".q"):
        return tp_param_spec(name[:-len(".q")], axis_name)
    if name.endswith(".weight.scale") or name == "lm_head.scale":
        module = name.split(".")[-3] if name.count(".") > 1 else "lm_head"
        if module == "lm_head" or module in _TP_COLUMN_MODULES:
            return (axis_name,)
        return ()       # row layers: whole-output scales on every rank
    return tp_param_spec(name, axis_name)


def quantized_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Grouped-scale int8 all-reduce (``apex_tpu/serving/quant.py:238``):
    each rank quantizes its partial sum with one scale a last-dim row,
    the int8 payloads and fp32 scales are all-gathered, and the sum of
    the dequantized parts is taken in fp32 and cast back.

    Plain PyTorch over two all-gathers (the JAX function is ``jnp``); on
    the wire it moves ``(1 + 4 / h) / itemsize`` of the exact all-reduce's
    bytes.  Every rank sums the same gathered parts in the same order, so
    the result is the same on every rank."""
    q, scale = quantize_int8(x, axis=-1)
    qg = mappings._all_gather_dim(q[None], 0, group)       # [world, ..., h]
    sg = mappings._all_gather_dim(scale[None], 0, group)   # [world, ...]
    out = torch.sum(dequantize_int8(qg, sg, axis=-1), dim=0)
    return out.to(x.dtype)


# ---- acceptance accounting -----------------------------------------------


def stream_agreement(ref_tokens, got_tokens) -> float:
    """Positionwise agreement rate of two greedy streams over their
    common length (1.0 = identical)."""
    n = min(len(ref_tokens), len(got_tokens))
    if n == 0:
        return 1.0
    return sum(1 for a, b in zip(ref_tokens, got_tokens)
               if int(a) == int(b)) / n


def max_logit_error(ref_logits, got_logits) -> float:
    """Largest absolute per-position logit deviation between two
    ``[steps, vocab]`` stacks, over their common prefix."""
    r = np.asarray(torch.as_tensor(ref_logits).float().cpu())
    g = np.asarray(torch.as_tensor(got_logits).float().cpu())
    n = min(r.shape[0], g.shape[0])
    if n == 0:
        return 0.0
    return float(np.max(np.abs(r[:n] - g[:n])))


def _row_bytes(t: torch.Tensor) -> int:
    """Bytes of one token row of a cache array ``[layers, slots or
    blocks, max_len or block_size, ...]`` across every layer."""
    return t.element_size() * t.shape[0] * int(np.prod(t.shape[3:]))


def kv_bytes_per_token(cache) -> float:
    """Device bytes one cached token costs across every layer: payload
    plus scales, fp and quant caches, dense and paged alike.  (The JAX
    function divides the pool bytes by its rows; the port's paged pool
    carries one sink block more, which holds no token, so the bytes of a
    row are counted directly.)"""
    arrays = [cache.k, cache.v]
    for name in ("k_scale", "v_scale"):
        arr = getattr(cache, name, None)
        if arr is not None:
            arrays.append(arr)
    return float(sum(_row_bytes(a) for a in arrays))


def param_bytes(model: nn.Module) -> int:
    """Bytes of a module's parameters and buffers (a :class:`QTensor`
    counts its payload and its scales)."""
    return sum(t.nbytes for t in model.parameters()) + sum(
        t.nbytes for t in model.buffers())


def evaluate_quant(ref_tokens, quant_tokens, *, ref_logits=None,
                   quant_logits=None, bytes_per_token=None,
                   fp_bytes_per_token=None) -> dict:
    """Score a quantized stream against its fp reference: ``agreement``,
    ``tokens`` compared, ``max_logit_error`` (with both logit stacks),
    ``bytes_per_token`` / ``capacity_ratio`` (with the byte accounting).
    Publishes the dict as the ``serving_quant_eval`` event, which the obs
    bridge turns into the ``apex_serving_quant_*`` metrics, and returns
    it."""
    out: dict = {
        "agreement": stream_agreement(ref_tokens, quant_tokens),
        "tokens": min(len(ref_tokens), len(quant_tokens)),
    }
    if ref_logits is not None and quant_logits is not None:
        out["max_logit_error"] = max_logit_error(ref_logits, quant_logits)
    if bytes_per_token is not None:
        out["bytes_per_token"] = float(bytes_per_token)
        if fp_bytes_per_token:
            out["capacity_ratio"] = float(fp_bytes_per_token) / float(
                bytes_per_token)
    emit_event("serving_quant_eval", **out)
    return out
