"""Standalone Megatron-style transformer LM (counterpart of
``apex_tpu/transformer/testing/standalone_transformer_lm.py``).

Embeddings, :class:`ParallelAttention` with two attention cores,
:class:`ParallelMLP`, pre-LN :class:`ParallelTransformerLayer`\\ s and the
final norm, over the port's tensor-parallel linears.  Activations keep
the Megatron ``[s, b, h]`` layout of the JAX model, so each intermediate
compares with its counterpart directly.

**Tensor parallelism.** Built inside a tensor-parallel region
(:func:`~apex_tpu_torch.transformer.tensor_parallel.tensor_parallel_region`)
the model is one rank's shard, as the JAX model under ``shard_map``: the
QKV and ``dense_h_to_4h`` linears split by output rows (a rank holds
``heads / tp`` whole heads), ``dense`` and ``dense_4h_to_h`` by input
columns, the word embedding by vocab rows.  With
``sequence_parallel_enabled`` the activations between the parallel
linears are the rank's ``[s / tp, b, h]`` block of the sequence: the
embedding's output is scattered along ``s``, each column linear
all-gathers its input and each row linear reduce-scatters its output,
and the LayerNorms sum their parameters' gradients over the group
(:class:`~apex_tpu_torch.transformer.layers.FusedLayerNorm`).

The attention core is, as in the JAX module:

- **flash** (``use_flash_attention`` and a causal mask without a 4-D mask,
  or segment ids): :func:`~apex_tpu_torch.ops.flash_attention.flash_attention`,
  the flash kernels forward and backward on the card;
- **materialized** (otherwise: ``use_flash_attention=False``, or an
  explicit ``attention_mask``): ``scores = q k^T`` in the activation dtype
  (fp32 accumulation, then cast), :class:`FusedScaleMaskSoftmax` with scale
  ``1 / sqrt(head_dim)`` (the fused softmax kernels on the card), and
  ``probs v``.  The two products stay ``torch.matmul``, as the JAX package
  leaves them to XLA.

The fused ``query_key_value`` output is ``[s, b, heads, 3 * head_dim]``:
each head's q, k and v are adjacent (the JAX ``reshape`` and ``split`` on
the last axis), not three ``[heads, head_dim]`` blocks.

**Dropout** (active only with ``deterministic=False``): the attention
dropout of :class:`ParallelAttention` runs inside the flash kernels (the
counter-hash keep bits of :mod:`apex_tpu_torch.ops.flash_attention`, one
int seed a call) or, on the materialized path, on the probabilities; the
hidden dropout of :class:`ParallelTransformerLayer` on the attention and
MLP outputs before each residual add.  The seed and the masks come from
the ``dropout_generator`` the caller passes to ``forward`` (a
``torch.Generator`` on the activations' device), the counterpart of
flax's ``rngs={"dropout": key}``: the same generator state gives the same
masks.  The layer and the stack also take ``attention_dropout`` and hand
it to their attention; the JAX layer leaves its attention at 0.

**Activation recompute**: ``ParallelTransformer(activations_checkpoint=,
activations_checkpoint_policy=)`` recomputes each layer in the backward
under one of the JAX policies (:mod:`apex_tpu_torch.transformer.recompute`
says what each re-runs and how); a recompute draws the forward's dropout
masks again.

**Context parallelism** (``context_parallel_axis``, a
``torch.distributed`` process group, as every mesh-axis keyword of the
port takes one): the activations are the rank's ``[s / cp, b, h]`` block
of the sequence, rank ``r`` holding positions ``[r * s / cp, (r + 1) * s
/ cp)``; the attention core is
:func:`~apex_tpu_torch.transformer.context_parallel.ring_attention` over
the group, and RoPE takes the block's global positions (offset ``r * s /
cp``).  A mask, segment ids or active attention dropout raise under it,
as in JAX.  :class:`Embedding`'s default position ids stay the local
``0 .. s / cp - 1`` (JAX's default): with learned positions a cp caller
passes the global ids.

**Mixture of experts** (``moe_num_experts``): every layer's MLP is a
:class:`MoEParallelMLP` (top-1 experts of
:mod:`apex_tpu_torch.transformer.moe`, split over the
``expert_parallel_axis`` group when one is given).  The JAX layer sows
its load-balancing loss into flax's ``"moe_losses"`` collection; here
each MoE layer keeps its last loss (``aux_loss``, in the autograd graph)
and :meth:`ParallelTransformer.moe_losses` /
:meth:`TransformerLanguageModel.moe_losses` return them, one a layer in
order.  The trainer adds them to its objective itself.  MoE with
sequence parallelism raises, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.transformer import recompute

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb
from apex_tpu_torch.transformer.context_parallel import ring_attention
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
from apex_tpu_torch.transformer.layers import FusedLayerNorm
from apex_tpu_torch.transformer.moe import ExpertParallelMLP
from apex_tpu_torch.transformer.parallel_state import axis_group
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    divide,
    parallel_lm_logits,
    scatter_to_sequence_parallel_region,
    tp_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import normal_
from apex_tpu_torch.transformer.tensor_parallel.random import checkpoint
from apex_tpu_torch.utils.dropout import dropout, dropout_seed

__all__ = ["ParallelMLP", "ParallelAttention", "ParallelTransformerLayer",
           "ParallelTransformer", "Embedding", "TransformerLanguageModel",
           "parallel_lm_logits"]


def _check_rate(rate: float, what: str) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what} must be in [0, 1), got {rate}")
    return rate


def _active(rate: float, deterministic: bool, generator) -> bool:
    """Whether a dropout of ``rate`` draws masks in this call; raises when
    it should and has no generator (flax raises without a dropout rng)."""
    if rate == 0.0 or deterministic:
        return False
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a "
                         "dropout_generator (a torch.Generator on the "
                         "activations' device)")
    return True


class ParallelMLP(nn.Module):
    """``h -> ffn`` (column) ``-> gelu -> ffn -> h`` (row); the column
    layer's bias is added just before ``gelu(approximate="tanh")``.  Under
    tp the ``ffn`` activations stay the rank's columns between the two."""

    def __init__(self, hidden_size: int, ffn_hidden_size: Optional[int] = None,
                 sequence_parallel_enabled: bool = False, *,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ffn = ffn_hidden_size or 4 * hidden_size
        kw = dict(dtype=params_dtype, device=device, generator=generator,
                  sequence_parallel_enabled=sequence_parallel_enabled)
        self.dense_h_to_4h = ColumnParallelLinear(
            hidden_size, ffn, gather_output=False, skip_bias_add=True, **kw)
        self.dense_4h_to_h = RowParallelLinear(ffn, hidden_size,
                                               input_is_parallel=True, **kw)

    def forward(self, x):
        h, bias = self.dense_h_to_4h(x)
        pre = h + bias.to(h.dtype)
        gelu = nn.functional.gelu
        # the largest activation of the layer; "except_activations"
        # recomputes it from the saved pre-activation
        h = recompute.checkpoint_name(
            gelu(pre, approximate="tanh"), "mlp_act",
            functools.partial(gelu, pre, approximate="tanh"), (pre,))
        return self.dense_4h_to_h(h)


def _rope_freqs(s: int, dim: int, offset=0, *, device=None) -> torch.Tensor:
    """``[s, 1, 1, dim]`` rotary frequencies for positions ``offset ..
    offset + s - 1`` (the JAX module's own ``_rope_freqs``, base 10000)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=device) / dim))
    t = torch.arange(s, dtype=torch.float32, device=device) + offset
    f = torch.outer(t, inv)
    return torch.cat([f, f], dim=-1)[:, None, None, :]


class ParallelAttention(nn.Module):
    """Multi-head self-attention on ``[s, b, h]`` activations (``[s / tp,
    b, h]`` under sequence parallelism, ``[s / cp, b, h]`` under context
    parallelism); a rank attends with its ``heads / tp`` heads over the
    whole sequence (around the ring under cp)."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 attention_dropout: float = 0.0, apply_rope: bool = False,
                 use_flash_attention: bool = True,
                 sequence_parallel_enabled: bool = False,
                 context_parallel_axis=None, *,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.context_parallel_axis = axis_group(context_parallel_axis,
                                                "context_parallel_axis")
        self.attention_dropout = _check_rate(attention_dropout,
                                             "attention_dropout")
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.head_dim = divide(hidden_size, num_attention_heads)
        self.attn_mask_type = attn_mask_type
        self.apply_rope = apply_rope
        self.use_flash_attention = use_flash_attention
        kw = dict(dtype=params_dtype, device=device, generator=generator,
                  sequence_parallel_enabled=sequence_parallel_enabled)
        self.query_key_value = ColumnParallelLinear(
            hidden_size, 3 * hidden_size, gather_output=False, **kw)
        self.dense = RowParallelLinear(hidden_size, hidden_size,
                                       input_is_parallel=True, **kw)

    def forward(self, x, attention_mask=None, segment_ids=None, *,
                deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None):
        """``deterministic=False`` with ``attention_dropout > 0`` drops
        probabilities, its seed or mask drawn from ``dropout_generator``."""
        cp = self.context_parallel_axis
        if cp is not None:
            if attention_mask is not None or segment_ids is not None:
                raise NotImplementedError(
                    "context parallelism composes with causal masking "
                    "only; express padding by trimming the global sequence")
            if not deterministic and self.attention_dropout > 0.0:
                raise NotImplementedError(
                    "attention dropout under context parallelism would "
                    "need a ring-consistent RNG; disable it for cp training")
        drop = _active(self.attention_dropout, deterministic,
                       dropout_generator)
        # the rank's heads, over the whole sequence (gathered by the column
        # linear under sequence parallelism)
        np_ = self.num_attention_heads // tp_world_size()
        hd = self.head_dim
        qkv = self.query_key_value(x)
        s, b = qkv.shape[0], qkv.shape[1]
        qkv = qkv.view(s, b, np_, 3 * hd)
        q, k, v = torch.split(qkv, hd, dim=-1)          # [s, b, np, hd] each
        if self.apply_rope:
            # under cp, the global positions of this rank's block
            offset = 0 if cp is None else dist.get_rank(cp) * s
            freqs = _rope_freqs(s, hd, offset, device=x.device)
            q = fused_apply_rotary_pos_emb(q, freqs)
            k = fused_apply_rotary_pos_emb(k, freqs)
        qt, kt, vt = (t.permute(1, 2, 0, 3) for t in (q, k, v))  # [b, np, s, hd]
        scale = 1.0 / float(hd) ** 0.5      # the JAX expression, bit for bit
        causal = self.attn_mask_type == AttnMaskType.causal
        use_flash = self.use_flash_attention and (
            segment_ids is not None or (causal and attention_mask is None))
        if cp is not None:
            ctx = ring_attention(qt, kt, vt, axis_name=cp, causal=causal,
                                 scale=scale)
        elif use_flash:
            rate, seed = 0.0, None
            if drop:
                rate, seed = (self.attention_dropout,
                              dropout_seed(dropout_generator))
            ctx = flash_attention(qt, kt, vt, causal=causal,
                                  segment_ids=segment_ids, scale=scale,
                                  dropout_rate=rate, dropout_seed=seed)
        else:
            scores = torch.matmul(qt, kt.transpose(-1, -2))  # [b, np, s, s]
            softmax = FusedScaleMaskSoftmax(
                input_in_bf16=qt.dtype == torch.bfloat16,
                input_in_fp16=qt.dtype == torch.float16,
                attn_mask_type=self.attn_mask_type, scale=scale)
            probs = softmax(scores, attention_mask)
            if drop:
                probs = dropout(probs, self.attention_dropout,
                                dropout_generator)
            ctx = torch.matmul(probs, vt)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, np_ * hd)
        return self.dense(ctx)


class MoEParallelMLP(nn.Module):
    """The MLP's drop-in replacement: ``[s, b, h]`` tokens through an
    :class:`~apex_tpu_torch.transformer.moe.ExpertParallelMLP`
    (``experts``), experts split over ``expert_parallel_axis`` when it is
    a group.  The load-balancing loss of the last call is ``aux_loss``
    (JAX sows it into ``"moe_losses"``)."""

    def __init__(self, hidden_size: int, num_experts: int,
                 ffn_hidden_size: Optional[int] = None,
                 capacity_factor: float = 1.25, expert_parallel_axis=None, *,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.experts = ExpertParallelMLP(
            num_experts, hidden_size, ffn_hidden_size, capacity_factor,
            axis_group(expert_parallel_axis, "expert_parallel_axis"),
            param_dtype=params_dtype, device=device, generator=generator)
        self.aux_loss = None

    def forward(self, x):
        s, b, h = x.shape
        if h != self.hidden_size:
            raise ValueError(f"input feature dim ({h}) != hidden_size "
                             f"({self.hidden_size})")
        out, self.aux_loss = self.experts(x.reshape(s * b, h))
        return out.view(s, b, h)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: LN -> attention -> [dropout] + residual -> LN -> MLP
    -> [dropout] + residual.  ``attention_dropout`` goes to the attention
    (the port's addition: the JAX layer builds its attention without)."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 hidden_dropout: float = 0.0, apply_rope: bool = False,
                 use_flash_attention: bool = True,
                 sequence_parallel_enabled: bool = False,
                 context_parallel_axis=None,
                 moe_num_experts: Optional[int] = None,
                 expert_parallel_axis=None, moe_capacity_factor: float = 1.25,
                 *, attention_dropout: float = 0.0,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dropout = _check_rate(hidden_dropout, "hidden_dropout")
        if moe_num_experts and sequence_parallel_enabled:
            raise NotImplementedError(
                "MoE + sequence parallelism needs tp-grad-synced replicated "
                "experts; route tokens with expert_parallel_axis instead")
        dev = resolve_device(device)
        self.input_layernorm = FusedLayerNorm(
            hidden_size, sequence_parallel_enabled=sequence_parallel_enabled,
            device=dev)
        self.self_attention = ParallelAttention(
            hidden_size, num_attention_heads, attn_mask_type=attn_mask_type,
            attention_dropout=attention_dropout,
            apply_rope=apply_rope, use_flash_attention=use_flash_attention,
            sequence_parallel_enabled=sequence_parallel_enabled,
            context_parallel_axis=context_parallel_axis,
            params_dtype=params_dtype, device=dev, generator=generator)
        self.post_attention_layernorm = FusedLayerNorm(
            hidden_size, sequence_parallel_enabled=sequence_parallel_enabled,
            device=dev)
        self.mlp = (
            MoEParallelMLP(hidden_size, moe_num_experts,
                           capacity_factor=moe_capacity_factor,
                           expert_parallel_axis=expert_parallel_axis,
                           params_dtype=params_dtype, device=dev,
                           generator=generator)
            if moe_num_experts else
            ParallelMLP(hidden_size,
                        sequence_parallel_enabled=sequence_parallel_enabled,
                        params_dtype=params_dtype, device=dev,
                        generator=generator))

    def forward(self, x, attention_mask=None, segment_ids=None, *,
                deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None):
        """The dropouts draw from ``dropout_generator`` in a fixed order
        (the attention's seed or mask, then the two hidden masks)."""
        drop = _active(self.hidden_dropout, deterministic, dropout_generator)
        ln1 = self.input_layernorm(x)
        # each recipe binds its input now: ``x`` is rebound below
        ln1 = recompute.checkpoint_name(
            ln1, "ln_out", functools.partial(self.input_layernorm, x),
            (x, *self.input_layernorm.parameters()))
        attn = self.self_attention(ln1, attention_mask, segment_ids,
                                   deterministic=deterministic,
                                   dropout_generator=dropout_generator)
        if drop:
            attn = dropout(attn, self.hidden_dropout, dropout_generator)
        x = x + attn
        ln2 = self.post_attention_layernorm(x)
        ln2 = recompute.checkpoint_name(
            ln2, "ln_out", functools.partial(self.post_attention_layernorm, x),
            (x, *self.post_attention_layernorm.parameters()))
        mlp = self.mlp(ln2)
        if drop:
            mlp = dropout(mlp, self.hidden_dropout, dropout_generator)
        return x + mlp


class ParallelTransformer(nn.Module):
    """A stack of ``num_layers`` layers (``layers.i``) and, with
    ``final_layernorm``, the final LayerNorm.

    ``activations_checkpoint`` (or a policy, which implies it) recomputes
    each layer in the backward under ``activations_checkpoint_policy``:
    ``None`` the whole layer, ``"dots"`` / ``"dots_no_batch"`` all but the
    products, ``"except_activations"`` only the norm outputs and the gelu
    output (:mod:`apex_tpu_torch.transformer.recompute`).  Both attributes
    may be changed after construction.  ``hidden_dropout`` and
    ``attention_dropout`` go to every layer (the JAX stack has neither).
    With ``moe_num_experts``, :meth:`moe_losses` lists each layer's
    load-balancing loss of the last forward."""

    def __init__(self, num_layers: int, hidden_size: int,
                 num_attention_heads: int,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 apply_rope: bool = False, use_flash_attention: bool = True,
                 activations_checkpoint: bool = False,
                 activations_checkpoint_policy: Optional[str] = None,
                 sequence_parallel_enabled: bool = False,
                 context_parallel_axis=None,
                 moe_num_experts: Optional[int] = None,
                 expert_parallel_axis=None, moe_capacity_factor: float = 1.25,
                 final_layernorm: bool = True, *,
                 hidden_dropout: float = 0.0, attention_dropout: float = 0.0,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activations_checkpoint_policy not in recompute.POLICIES:
            raise ValueError(
                f"activations_checkpoint_policy "
                f"{activations_checkpoint_policy!r} is not one of "
                f"{recompute.POLICIES}")
        self.activations_checkpoint = activations_checkpoint
        self.activations_checkpoint_policy = activations_checkpoint_policy
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(
                hidden_size, num_attention_heads,
                attn_mask_type=attn_mask_type, hidden_dropout=hidden_dropout,
                attention_dropout=attention_dropout, apply_rope=apply_rope,
                use_flash_attention=use_flash_attention,
                sequence_parallel_enabled=sequence_parallel_enabled,
                context_parallel_axis=context_parallel_axis,
                moe_num_experts=moe_num_experts,
                expert_parallel_axis=expert_parallel_axis,
                moe_capacity_factor=moe_capacity_factor,
                params_dtype=params_dtype, device=dev, generator=generator)
            for _ in range(num_layers))
        self.final_layernorm = (
            FusedLayerNorm(hidden_size,
                           sequence_parallel_enabled=sequence_parallel_enabled,
                           device=dev)
            if final_layernorm else None)

    def _layer(self, layer, x, attention_mask, segment_ids, deterministic,
               dropout_generator):
        def run(x, attention_mask, segment_ids, dropout_generator):
            return layer(x, attention_mask, segment_ids,
                         deterministic=deterministic,
                         dropout_generator=dropout_generator)

        # the generator among the arguments: a recompute draws the forward's
        # masks again
        args = (x, attention_mask, segment_ids, dropout_generator)
        policy = self.activations_checkpoint_policy
        if not ((self.activations_checkpoint or policy)
                and torch.is_grad_enabled()):
            return run(*args)
        if policy == "except_activations":
            with recompute.drop_named_activations(("ln_out", "mlp_act")):
                return run(*args)
        if policy is None:
            return checkpoint(run, False, *args)
        return checkpoint(run, False, *args,
                          context_fn=recompute.dots_context(
                              batched=policy == "dots"))

    def moe_losses(self) -> list:
        """Each MoE layer's load-balancing loss of the last forward, in
        layer order (empty without experts)."""
        return [layer.mlp.aux_loss for layer in self.layers
                if isinstance(layer.mlp, MoEParallelMLP)]

    def forward(self, x, attention_mask=None, segment_ids=None, *,
                deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = self._layer(layer, x, attention_mask, segment_ids,
                            deterministic, dropout_generator)
        if self.final_layernorm is not None:
            x = self.final_layernorm(x)
        return x


class Embedding(nn.Module):
    """Token embedding plus learned positions (RoPE models skip the
    position table): ``[b, s]`` ids to ``[s, b, h]`` activations, the
    rank's ``[s / tp, b, h]`` block under sequence parallelism."""

    def __init__(self, hidden_size: int, vocab_size: int,
                 max_sequence_length: int, use_position_embedding: bool = True,
                 sequence_parallel_enabled: bool = False, *,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sequence_parallel_enabled = sequence_parallel_enabled
        dev = resolve_device(device)
        self.word_embeddings = VocabParallelEmbedding(
            vocab_size, hidden_size, dtype=params_dtype, device=dev,
            generator=generator)
        self.position_embeddings = (
            nn.Parameter(normal_((max_sequence_length, hidden_size), 0.02,
                                 dtype=params_dtype, device=dev,
                                 generator=generator))
            if use_position_embedding else None)

    def forward(self, input_ids, position_ids=None):
        emb = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = torch.arange(input_ids.shape[1],
                                            device=input_ids.device)[None, :]
            emb = emb + self.position_embeddings[position_ids].to(emb.dtype)
        # [b, s, h] -> [s, b, h]; the norm kernel takes contiguous input
        x = emb.transpose(0, 1).contiguous()
        if self.sequence_parallel_enabled:
            x = scatter_to_sequence_parallel_region(x)
        return x


class TransformerLanguageModel(nn.Module):
    """:class:`Embedding` then :class:`ParallelTransformer`: ``[b, s]`` ids
    to ``[s, b, h]`` hidden states after the final norm.  With
    ``moe_num_experts`` a training caller adds :meth:`moe_losses` to its
    objective."""

    def __init__(self, num_layers: int, hidden_size: int,
                 num_attention_heads: int, vocab_size: int,
                 max_sequence_length: int,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 apply_rope: bool = False, use_flash_attention: bool = True,
                 activations_checkpoint: bool = False,
                 activations_checkpoint_policy: Optional[str] = None,
                 sequence_parallel_enabled: bool = False,
                 context_parallel_axis=None,
                 moe_num_experts: Optional[int] = None,
                 expert_parallel_axis=None, moe_capacity_factor: float = 1.25,
                 *, params_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(params_dtype=params_dtype, device=dev, generator=generator)
        self.embedding = Embedding(
            hidden_size, vocab_size, max_sequence_length,
            use_position_embedding=not apply_rope,
            sequence_parallel_enabled=sequence_parallel_enabled, **kw)
        self.transformer = ParallelTransformer(
            num_layers, hidden_size, num_attention_heads,
            attn_mask_type=attn_mask_type, apply_rope=apply_rope,
            use_flash_attention=use_flash_attention,
            activations_checkpoint=activations_checkpoint,
            activations_checkpoint_policy=activations_checkpoint_policy,
            sequence_parallel_enabled=sequence_parallel_enabled,
            context_parallel_axis=context_parallel_axis,
            moe_num_experts=moe_num_experts,
            expert_parallel_axis=expert_parallel_axis,
            moe_capacity_factor=moe_capacity_factor, **kw)

    def moe_losses(self) -> list:
        """:meth:`ParallelTransformer.moe_losses` of the stack."""
        return self.transformer.moe_losses()

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                segment_ids=None, *, deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None):
        x = self.embedding(input_ids, position_ids)
        return self.transformer(x, attention_mask, segment_ids,
                                deterministic=deterministic,
                                dropout_generator=dropout_generator)
