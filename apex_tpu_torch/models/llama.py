"""Llama-family causal LM (counterpart of ``apex_tpu/models/llama.py``).

Embedding -> decoder stack (RMSNorm, grouped-query attention with rotary
embeddings, RMSNorm, SwiGLU MLP) -> final RMSNorm -> LM head.  Every norm
is :class:`~apex_tpu_torch.normalization.FusedRMSNorm`, which on the card
is the hand-written CUDA kernel: ``2 * layers + 1`` launches a forward.

Activations keep the Megatron ``[s, b, h]`` layout of the JAX model, so
each intermediate compares with its counterpart directly; inputs are
``[b, s]`` token ids and logits come out ``[s, b, vocab]`` in fp32.

Four modes, as in the JAX model:

- **uncached forward** (``kv_cache=None``): causal attention over the
  input through :func:`~apex_tpu_torch.ops.flash_attention.flash_attention`
  (on the card the flash attention forward kernel, one launch a layer; k
  and v keep their kv heads, and each query head reads its group's).
- **per-token loss** (``labels=`` ``[b, s]``, no cache): the same forward,
  then :func:`~apex_tpu_torch.ops.fused_lm_head.fused_lm_head_loss` in
  place of the logits (on the card the fused LM-head kernel, one launch);
  returns the ``[b, s]`` fp32 loss, as the JAX model does at tp 1.
- **chunked prefill** (``input_ids [1, s>1]``, ``slot``, ``position`` =
  the chunk's start offset): rope at the true positions, the chunk's K/V
  written into the cache, and the chunk attends the whole ``max_len``
  slot under per-row bounds ``idx <= offset + row``.
- **batched decode** (``input_ids [slots, 1]``, ``position [slots]``):
  rope at each slot's depth, K/V appended at ``position``, attention over
  the masked cache.

The cache is updated in place: a dense one
(:mod:`apex_tpu_torch.serving.kv_cache`) or a paged block pool
(:mod:`apex_tpu_torch.serving.paged_kv_cache`), fp or int8, told apart by
its type; both hand attention the same ``[max_len]``-extent rows, so the
two give the same bits.  The cached modes return ``(logits, kv_cache)``
like the JAX model, with the same cache object, and refuse ``labels``.
A quantized model (:func:`apex_tpu_torch.serving.quant.quantize_params`)
dequantizes each projection's weight, and the head's, right before its
product.

**Tensor parallelism.** A model built inside a tensor-parallel region
(:func:`~apex_tpu_torch.transformer.tensor_parallel.tensor_parallel_region`)
is one rank's shard: q/k/v and gate/up split by output rows, o/down by
input columns, the embedding and the LM head by vocab rows
(:func:`tp_param_spec`), and each rank runs ``heads / tp`` query and
``kv_heads / tp`` kv heads.  Called inside its region it returns its
vocab shard of the logits, ``[s, b, vocab / tp]``; with ``labels`` the
per-token loss of the fused LM-head kernel at world size 1, and of
:func:`~apex_tpu_torch.transformer.tensor_parallel.parallel_lm_logits` +
:func:`~apex_tpu_torch.transformer.tensor_parallel.vocab_parallel_cross_entropy`
above it.  :func:`~apex_tpu_torch.models.convert.llama_params_from_jax`
(``tp_rank=``, ``tp_size=``) gives a rank its slice of the JAX weights.

**Sequence parallelism** (``sequence_parallel_enabled``, as in the JAX
model): the embedding's output is scattered along the sequence, the
column linears all-gather their input and the row linears reduce-scatter
their output, so the norms and residuals run on the rank's ``[s / tp, b,
h]`` block; the logits all-gather it back, and the loss is always the
vocab-parallel one.  The norms are the JAX model's
:class:`~apex_tpu_torch.normalization.FusedRMSNorm`, with no reduction
over the group in the backward: each rank's norm-scale gradient covers
its own block of the tokens, as JAX's does.  Under sequence parallelism
the scales carry ``sequence_parallel = True``, and a trainer sums their
gradients over the group with
:func:`~apex_tpu_torch.transformer.tensor_parallel.allreduce_sequence_parallel_grads`
after the backward (the JAX package leaves them partial).

The uncached modes are differentiable: under autograd each norm, the
flash attention and the fused LM head run their backward kernels on the
card (their plain versions on the CPU), the embedding's gradient sums the
lookup's and, with ``tie_word_embeddings``, the head's.  Training drives
``model(ids, labels=labels).mean().backward()`` (see
:mod:`apex_tpu_torch.examples.llama_pretrain`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.fused_lm_head import fused_lm_head_loss
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb
from apex_tpu_torch.serving import kv_cache as kvc
from apex_tpu_torch.serving import paged_kv_cache as pkv
from apex_tpu_torch.serving.quant import QTensor
from apex_tpu_torch.transformer.parallel_state import TENSOR_PARALLEL_AXIS
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    divide,
    parallel_lm_logits,
    scatter_to_sequence_parallel_region,
    shard_init,
    tp_world_size,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import normal_
from apex_tpu_torch.transformer.tensor_parallel.random import checkpoint

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaDecoderLayer",
           "LlamaAttention", "LlamaMLP", "tp_param_spec",
           "validate_tp_divisibility"]

# masked attention scores (the JAX flash kernels' _NEG_INF): exp of a
# masked score minus the row max underflows to exactly 0 in fp32
_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-2/3 architecture knobs (HF LlamaConfig field names)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None   # None = MHA; < heads = GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        """Llama-2 7B: 32 x 4096, MHA, 32k vocab (the dataclass defaults)."""
        return cls()

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        """Llama-3 8B: GQA 8 kv heads, 128k vocab, theta 5e5, 8k context."""
        return cls(vocab_size=128256, intermediate_size=14336,
                   num_key_value_heads=8, rope_theta=500000.0,
                   max_position_embeddings=8192)

    @classmethod
    def llama_1b(cls) -> "LlamaConfig":
        """The ``llama-1b`` card of ``bench.py`` (TinyLlama-1.1B shape):
        22 x 2048, 32 heads over 8 kv heads (GQA 4:1), intermediate 5632,
        32k vocab, 2048 positions; about 1.1 B parameters."""
        return cls(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                   num_hidden_layers=22, num_attention_heads=32,
                   num_key_value_heads=8, max_position_embeddings=2048)


# which weights the tensor-parallel layers shard, by module name: the model
# owns this layout, and the engine, the weight loader and the sharded
# checkpoints take their per-rank slices from tp_param_spec
_TP_COLUMN_MODULES = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_TP_ROW_MODULES = ("o_proj", "down_proj")


def tp_param_spec(name: str, axis_name: str = TENSOR_PARALLEL_AXIS) -> tuple:
    """Partition spec of one ``state_dict`` entry of the model under a 1-D
    tp mesh, in PyTorch's layout: a tuple with the mesh axis on the
    sharded dim and ``None`` elsewhere (``()`` = replicated).

    - ``embed_tokens.weight`` and ``lm_head``: ``[vocab / tp, h]`` ->
      ``(axis, None)``;
    - column-parallel weights (q/k/v/gate/up) ``[out / tp, in]`` ->
      ``(axis, None)``, their biases ``(axis,)``;
    - row-parallel weights (o/down) ``[out, in / tp]`` -> ``(None, axis)``;
      their biases are added after the reduction, whole -> ``()``;
    - everything else (the norm scales): ``()``.

    The JAX ``tp_param_spec`` (``apex_tpu/models/llama.py:93``) states the
    same split on flax's ``[in, out]`` kernels, so its column and row
    specs are these transposed."""
    if "embed_tokens" in name or "lm_head" in name:
        return (axis_name, None)
    module = name.rsplit(".", 2)[-2] if name.count(".") else ""
    attr = name.rsplit(".", 1)[-1]
    if module in _TP_COLUMN_MODULES:
        return (axis_name, None) if attr == "weight" else (axis_name,)
    if module in _TP_ROW_MODULES and attr == "weight":
        return (None, axis_name)
    return ()


def validate_tp_divisibility(config: "LlamaConfig", tp: int) -> None:
    """Raise ``ValueError`` unless every tp-sharded dimension divides by
    ``tp``: attention heads and kv heads (the KV cache splits head-wise),
    the vocab (embedding and LM head) and the MLP intermediate width."""
    tp = int(tp)
    for what, dim in (("num_attention_heads", config.num_attention_heads),
                      ("kv_heads", config.kv_heads),
                      ("vocab_size", config.vocab_size),
                      ("intermediate_size", config.intermediate_size)):
        if dim % tp:
            raise ValueError(
                f"{what}={dim} is not divisible by tp={tp} — every "
                f"tensor-parallel shard must be equal-sized (heads, kv "
                f"heads, vocab rows, and MLP intermediate columns are "
                f"the sharded dimensions)")


def mark_sequence_parallel(*modules: nn.Module) -> None:
    """Tag the parameters of ``modules`` (norms run on a rank's sequence
    block) ``sequence_parallel = True``: their gradients are per-rank
    partial sums until
    :func:`~apex_tpu_torch.transformer.tensor_parallel.allreduce_sequence_parallel_grads`."""
    for m in modules:
        for p in m.parameters():
            p.sequence_parallel = True


def _rope_freqs(s: int, dim: int, theta: float, offset=0, *,
                device=None) -> torch.Tensor:
    """Rotary frequencies for ``s`` positions starting at ``offset``.

    A scalar ``offset`` (an int or a 0-d tensor) yields ``[s, 1, 1, dim]``;
    a ``[b]`` tensor, one start per batch element (batched decode, each
    slot at its own depth), yields ``[s, b, 1, dim]``.  Position ``p``'s
    row is ``p * inv`` in both forms."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    pos = torch.arange(s, dtype=torch.float32, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim():
        t = pos[:, None] + offset.float()[None, :]          # [s, b]
        f = t[..., None] * inv
        return torch.cat([f, f], dim=-1)[:, :, None, :]      # [s, b, 1, d]
    t = pos + (offset.float() if isinstance(offset, torch.Tensor)
               else float(offset))
    f = torch.outer(t, inv)
    return torch.cat([f, f], dim=-1)[:, None, None, :]       # [s, 1, 1, d]


def _cached_attention(qt, kt, vt, bounds):
    """Length-masked attention read over a full KV-cache buffer.

    ``qt [b, nq, m, hd]`` query rows; ``kt`` / ``vt [b, nkv, max_len,
    hd]`` with ``nq % nkv == 0``: kv head ``g`` serves query heads ``g *
    rep .. g * rep + rep - 1`` (the JAX model's ``jnp.repeat`` expansion,
    done here by grouping the query heads instead of copying K/V);
    ``bounds [b, m]``: row ``i`` of batch element ``b`` attends cache
    positions ``idx <= bounds[b, i]``, and everything past is masked.

    The op sequence is the JAX function's: scale folded into fp32 q,
    fp32 scores, ``-1e30`` mask, max / exp / sum / divide, fp32 PV, cast
    back to ``qt.dtype``.  Its ``_DECODE_QPAD`` row padding only kept
    XLA-CPU's rounding of gemv and gemm apart and changes no result, so
    it is not carried over."""
    b, nq, m, hd = qt.shape
    nkv, max_len = kt.shape[1], kt.shape[2]
    rep = divide(nq, nkv)
    scale = 1.0 / hd ** 0.5
    q = (qt.float() * scale).reshape(b, nkv, rep * m, hd)
    s = torch.matmul(q, kt.float().transpose(-1, -2))
    s = s.view(b, nkv, rep, m, max_len)
    idx = torch.arange(max_len, device=qt.device)
    valid = idx[None, None, :] <= bounds[:, :, None]          # [b, m, max]
    s = torch.where(valid[:, None, None], s, _NEG_INF)
    mx = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    p = e / torch.sum(e, dim=-1, keepdim=True)
    out = torch.matmul(p.view(b, nkv, rep * m, max_len), vt.float())
    return out.view(b, nq, m, hd).to(qt.dtype)


def _decode_attention(qt, kt, vt, position):
    """Single-token cached read: ``qt [b, h, 1, hd]``, one visibility
    bound per slot (``idx <= position[b]``)."""
    return _cached_attention(qt, kt, vt, position[:, None])


class LlamaMLP(nn.Module):
    """SwiGLU: down( silu(gate(x)) * up(x) )."""

    def __init__(self, config: LlamaConfig, *, dtype, device, generator=None,
                 sequence_parallel_enabled: bool = False):
        super().__init__()
        c = config
        kw = dict(bias=False, dtype=dtype, device=device, generator=generator,
                  sequence_parallel_enabled=sequence_parallel_enabled)
        self.gate_proj = ColumnParallelLinear(c.hidden_size,
                                              c.intermediate_size,
                                              gather_output=False, **kw)
        self.up_proj = ColumnParallelLinear(c.hidden_size,
                                            c.intermediate_size,
                                            gather_output=False, **kw)
        self.down_proj = RowParallelLinear(c.intermediate_size,
                                           c.hidden_size,
                                           input_is_parallel=True, **kw)

    def forward(self, x):
        return self.down_proj(nn.functional.silu(self.gate_proj(x))
                              * self.up_proj(x))


class LlamaAttention(nn.Module):
    """Grouped-query attention with rotary embeddings."""

    def __init__(self, config: LlamaConfig, *, dtype, device, generator=None,
                 sequence_parallel_enabled: bool = False):
        super().__init__()
        c = config
        self.config = c
        self.head_dim = divide(c.hidden_size, c.num_attention_heads)
        kw = dict(bias=False, dtype=dtype, device=device, generator=generator,
                  sequence_parallel_enabled=sequence_parallel_enabled)
        kv = c.kv_heads * self.head_dim
        col = dict(gather_output=False, **kw)
        self.q_proj = ColumnParallelLinear(c.hidden_size, c.hidden_size, **col)
        self.k_proj = ColumnParallelLinear(c.hidden_size, kv, **col)
        self.v_proj = ColumnParallelLinear(c.hidden_size, kv, **col)
        self.o_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                        input_is_parallel=True, **kw)

    def forward(self, x, freqs, *, kv_cache=None, layer_idx=None,
                position=None, slot=None):
        """``x [s, b, h]``; ``freqs`` the rotary frequencies for these
        positions (see :func:`_rope_freqs`).  The cache arguments are as
        in :meth:`LlamaForCausalLM.forward`; ``position`` is the decode
        ``[b]`` depth vector or the prefill chunk's int offset."""
        cfg = self.config
        # under tp each rank holds heads / tp query and kv heads
        world = tp_world_size()
        hd = self.head_dim
        nq, nkv = cfg.num_attention_heads // world, cfg.kv_heads // world
        q = self.q_proj(x)
        # the whole sequence: the column linears gather it under sequence
        # parallelism
        s, b = q.shape[0], q.shape[1]
        q = fused_apply_rotary_pos_emb(q.view(s, b, nq, hd), freqs)
        k = fused_apply_rotary_pos_emb(self.k_proj(x).view(s, b, nkv, hd),
                                       freqs)
        v = self.v_proj(x).view(s, b, nkv, hd)
        qt = q.permute(1, 2, 0, 3)                           # [b, nq, s, hd]
        if kv_cache is None:
            # [b, nkv, s, hd] views: the kernel reads kv head i // (nq/nkv)
            # for query head i, the JAX model's jnp.repeat without the copy
            ctx = flash_attention(qt, k.permute(1, 2, 0, 3),
                                  v.permute(1, 2, 0, 3), causal=True)
        elif s == 1:
            # a paged cache writes through the slot tables and reads the
            # same [max_len]-extent rows back, as the dense cache hands
            # them out; the int8 caches quantize on write and dequantize
            # on read, so attention never spells a scale.  Inactive lanes
            # reach a paged append as position -1: it drops their write
            if isinstance(kv_cache, pkv.PagedKVCache):
                pkv.paged_append(kv_cache, layer_idx, k[0], v[0], position)
                kc, vc = pkv.decode_view(kv_cache, layer_idx)
            else:
                kvc.append_token(kv_cache, layer_idx, k[0], v[0], position)
                kc, vc = kvc.decode_read(kv_cache, layer_idx)
            # [b, max, nkv, hd]
            ctx = _decode_attention(qt, kc.to(q.dtype).permute(0, 2, 1, 3),
                                    vc.to(q.dtype).permute(0, 2, 1, 3),
                                    position)
        else:
            if b != 1:
                raise ValueError(f"prefill expects one slot per call (b=1), "
                                 f"got b={b}")
            if isinstance(kv_cache, pkv.PagedKVCache):
                pkv.paged_prefill_write(kv_cache, layer_idx, slot, k[:, 0],
                                        v[:, 0], start=position)
                kc, vc = pkv.prefill_view(kv_cache, layer_idx, slot)
            else:
                kvc.prefill_into_slot(kv_cache, layer_idx, slot, k[:, 0],
                                      v[:, 0], start=position)
                kc, vc = kvc.slot_read(kv_cache, layer_idx, slot)
            bounds = (position + torch.arange(s, device=x.device))[None]
            # [max, nkv, hd]
            ctx = _cached_attention(qt, kc.to(q.dtype).permute(1, 0, 2)[None],
                                    vc.to(q.dtype).permute(1, 0, 2)[None],
                                    bounds)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, nq * hd)
        return self.o_proj(ctx)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, dtype, device, generator=None,
                 sequence_parallel_enabled: bool = False):
        super().__init__()
        c = config
        kw = dict(dtype=dtype, device=device)
        sp = dict(generator=generator,
                  sequence_parallel_enabled=sequence_parallel_enabled)
        self.input_layernorm = FusedRMSNorm(c.hidden_size, eps=c.rms_norm_eps,
                                            **kw)
        self.self_attn = LlamaAttention(c, **sp, **kw)
        self.post_attention_layernorm = FusedRMSNorm(
            c.hidden_size, eps=c.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(c, **sp, **kw)
        if sequence_parallel_enabled:
            mark_sequence_parallel(self.input_layernorm,
                                   self.post_attention_layernorm)

    def forward(self, x, freqs, **cache_kw):
        x = x + self.self_attn(self.input_layernorm(x), freqs, **cache_kw)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaForCausalLM(nn.Module):
    """Embedding -> decoder stack -> final RMSNorm -> LM head.

    ``dtype`` is the parameters' dtype (the activations follow it);
    ``device`` defaults to CUDA, and ``generator`` (a ``torch.Generator``
    on that device) draws the initial weights: ``normal(0, 1/sqrt(in))``
    for the projections, ``normal(0, 0.02)`` for the embedding and head,
    ones for the norm scales.  ``sequence_parallel_enabled`` as in the
    module docstring.  ``activations_checkpoint`` recomputes each decoder
    layer in the backward of a training call (no ``kv_cache``; serving
    never recomputes), through
    :func:`~apex_tpu_torch.transformer.tensor_parallel.checkpoint`."""

    def __init__(self, config: LlamaConfig, *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 sequence_parallel_enabled: bool = False,
                 activations_checkpoint: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.activations_checkpoint = activations_checkpoint
        self.sequence_parallel_enabled = sequence_parallel_enabled
        kw = dict(dtype=dtype, device=dev)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, generator=generator, **kw)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(
                config, generator=generator,
                sequence_parallel_enabled=sequence_parallel_enabled, **kw)
            for _ in range(config.num_hidden_layers))
        self.norm = FusedRMSNorm(config.hidden_size, eps=config.rms_norm_eps,
                                 **kw)
        if sequence_parallel_enabled:
            mark_sequence_parallel(self.norm)
        if not config.tie_word_embeddings:
            # vocab-sharded like the embedding ([vocab / tp, h] a rank)
            self.lm_head = nn.Parameter(normal_(
                (divide(config.vocab_size, tp_world_size()),
                 config.hidden_size), 0.02,
                generator=shard_init(generator, dev), **kw))

    def forward(self, input_ids, labels=None, *, kv_cache=None,
                position=None, slot=None):
        """Logits ``[s, b, vocab]`` (fp32); with ``labels [b, s]`` the
        per-token loss ``[b, s]`` (fp32) instead; ``(logits, kv_cache)``
        with a cache: ``input_ids [1, s>1]`` + ``slot`` + int ``position``
        (the chunk's start offset, None for 0) prefills one chunk of one
        slot; ``input_ids [slots, 1]`` + ``position [slots]`` runs one
        batched decode step."""
        cfg = self.config
        if kv_cache is not None and labels is not None:
            raise ValueError("kv_cache is a serving-mode argument; "
                             "labels is training-only")
        sp = self.sequence_parallel_enabled
        # [b, s, h] -> [s, b, h]; the norm kernel takes contiguous input
        x = self.embed_tokens(input_ids).transpose(0, 1).contiguous()
        s = x.shape[0]
        if sp:
            x = scatter_to_sequence_parallel_region(x)
        hd = cfg.hidden_size // cfg.num_attention_heads
        cache_kw = {}
        if kv_cache is None:
            freqs = _rope_freqs(s, hd, cfg.rope_theta, device=x.device)
        elif s == 1:
            freqs = _rope_freqs(s, hd, cfg.rope_theta, offset=position)
            cache_kw = dict(kv_cache=kv_cache, position=position)
        else:
            position = 0 if position is None else int(position)
            freqs = _rope_freqs(s, hd, cfg.rope_theta, offset=position,
                                device=x.device)
            cache_kw = dict(kv_cache=kv_cache, position=position, slot=slot)
        remat = (self.activations_checkpoint and kv_cache is None
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            if kv_cache is not None:
                cache_kw["layer_idx"] = i
            if remat:
                x = checkpoint(layer, False, x, freqs)
            else:
                x = layer(x, freqs, **cache_kw)
        x = self.norm(x)
        head = (self.embed_tokens.weight if cfg.tie_word_embeddings
                else self.lm_head)
        if isinstance(head, QTensor):         # an int8 serving head
            head = head.dequantize()
        if labels is not None and tp_world_size() == 1 and not sp:
            return fused_lm_head_loss(x, head.to(x.dtype), labels.T).T
        logits = parallel_lm_logits(x, head.to(x.dtype),
                                    sequence_parallel_enabled=sp)
        if kv_cache is not None:
            return logits, kv_cache
        if labels is None:
            return logits
        # above world size 1 or under sequence parallelism: the
        # vocab-sharded logits and the vocab-parallel loss, as the JAX model
        return vocab_parallel_cross_entropy(logits.transpose(0, 1), labels)
