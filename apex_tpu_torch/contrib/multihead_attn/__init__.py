"""Multi-head attention blocks over the flash and softmax kernels
(counterpart of ``apex_tpu.contrib.multihead_attn``).

``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` are ``[time, batch,
channel]`` attention blocks with ±bias, ±"norm-add" (pre-LayerNorm and a
residual add), binary or additive key-padding masks and separate or
packed QKV weights, under the JAX modules' parameter names.  The
projections are ``F.linear``; the attention core takes one of two routes,
as in JAX:

- ``impl="fast"`` with no ``attn_mask`` and a binary (or no) key-padding
  mask: :func:`apex_tpu_torch.ops.flash_attention.flash_attention` (the
  flash forward, dq and dk/dv kernels on the card), the mask as a
  ``(q_seg, kv_seg)`` pair of segment ids (queries 1, keys 1 or 0 where
  padded), attention dropout inside the kernel with an int seed drawn
  from the module's generator;
- otherwise the materialized route: fp32 scores cast to q's dtype, the
  masks filled at -10000 (or added), an fp32 softmax cast back to q's
  dtype, dropout drawn from the generator, an fp32 product with v.

The two routes differ on a batch row whose keys are all padded: the flash
route gives zeros there (no key is visible), the materialized route a
uniform softmax over the -10000 fill (the mean of v).

q, k and v reach the flash kernels as strided views of the projection's
output (``[s, b, h, d]`` permuted to ``[b, h, s, d]``, whose strides are
multiples of 8 elements and whose starts lie 16 bytes apart for an
embedding a multiple of 8); nothing is copied on the way in.

Dtypes follow JAX's promotion.  Under ``include_norm_add`` the normalized
stream is multiplied by the fp32 ``lyr_nrm_gamma_weights``, so with 16-bit
inputs and fp32 parameters the projections run in fp32 and fp32 q, k and
v reach the flash kernel's fp32 path; the output is then fp32 too.  No
cast is added that JAX lacks, and no global flag (TF32 and the like) is
set here.

``fast_mask_softmax_dropout_func`` is the standalone softmax(+pad
mask)(+dropout) on ``[b * h, sq, sk]`` scores: the scaled softmax kernels
on the card.  Without a mask (and with an additive mask, added first) it
calls :func:`~apex_tpu_torch.ops.softmax.scaled_softmax`, which computes
what JAX's call with an all-False mask computes without reading one.

Dropout draws come from an explicit ``torch.Generator`` (the modules'
``generator``, which first draws their initial parameters, and
``generator=`` of the function) where JAX takes a PRNG key; the draws
differ from JAX's, their distribution does not.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.softmax import scaled_masked_softmax, scaled_softmax
from apex_tpu_torch.utils.dropout import dropout, dropout_seed

__all__ = [
    "SelfMultiheadAttn",
    "EncdecMultiheadAttn",
    "fast_mask_softmax_dropout_func",
]

_MASK_VALUE = -10000.0


def _need_generator(generator):
    if generator is None:
        raise ValueError("dropout in training needs a generator (a "
                         "torch.Generator on the activations' device)")
    return generator


def fast_mask_softmax_dropout_func(is_training, heads, inputs, pad_mask,
                                   mask_additive, dropout_prob,
                                   generator: Optional[torch.Generator] = None):
    """softmax(+pad mask)(+dropout) on ``[b * h, sq, sk]`` scores.

    ``pad_mask`` is ``[b, sk]`` with 1s on padded keys (binary) or additive
    float values (``mask_additive``).  Fully masked rows give zeros."""
    bh, sq, sk = inputs.shape
    if pad_mask is None:
        probs = scaled_softmax(inputs.reshape(bh, 1, sq, sk).contiguous())
    elif mask_additive:
        b = pad_mask.shape[0]
        x = inputs.reshape(b, bh // b, sq, sk)
        x = x + pad_mask[:, None, None, :].to(x.dtype)
        probs = scaled_softmax(x)
    else:
        b = pad_mask.shape[0]
        mask = pad_mask[:, None, None, :].to(torch.bool).expand(b, 1, sq, sk)
        probs = scaled_masked_softmax(
            inputs.reshape(b, bh // b, sq, sk).contiguous(), mask)
    probs = probs.reshape(bh, sq, sk)
    if is_training and dropout_prob > 0.0:
        probs = dropout(probs, dropout_prob, _need_generator(generator))
    return probs


def _attention_core(q, k, v, *, key_padding_mask, attn_mask, mask_additive,
                    scale, dropout_p, deterministic, generator, impl):
    """``[b, h, s, d]`` attention with the reference's mask conventions.

    key_padding_mask: ``[b, sk]``, 1/True = pad (exclude).  attn_mask:
    ``[sq, sk]`` time mask, 1/True = exclude.  Additive masks carry float
    values."""
    drop = not deterministic and dropout_p > 0.0
    if impl == "fast" and attn_mask is None and not mask_additive:
        seg = None
        if key_padding_mask is not None:
            b = key_padding_mask.shape[0]
            kseg = torch.where(key_padding_mask.to(torch.bool), 0, 1).to(
                torch.int32)
            qseg = torch.ones((b, q.shape[2]), dtype=torch.int32,
                              device=q.device)
            seg = (qseg, kseg)
        rate, seed = 0.0, None
        if drop:
            rate, seed = dropout_p, dropout_seed(_need_generator(generator))
        return flash_attention(q, k, v, segment_ids=seg, scale=scale,
                               dropout_rate=rate, dropout_seed=seed)

    scores = torch.matmul(q.float() * scale,
                          k.float().transpose(-1, -2)).to(q.dtype)
    if attn_mask is not None:
        scores = torch.where(attn_mask.to(torch.bool)[None, None],
                             _MASK_VALUE, scores)
    if key_padding_mask is not None:
        if mask_additive:
            scores = scores + key_padding_mask[:, None, None, :].to(
                scores.dtype)
        else:
            scores = torch.where(
                key_padding_mask.to(torch.bool)[:, None, None, :],
                _MASK_VALUE, scores)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if drop:
        probs = dropout(probs, dropout_p, _need_generator(generator))
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def _sbc_to_bhsd(x, heads):
    """``[s, b, h*d]`` -> ``[b, h, s, d]``, a view where the strides allow."""
    s, b, e = x.shape
    return x.reshape(s, b, heads, e // heads).permute(1, 2, 0, 3)


def _bhsd_to_sbc(x):
    b, h, s, d = x.shape
    return x.permute(2, 0, 1, 3).reshape(s, b, h * d)


def _layer_norm(x, gamma, beta):
    """JAX's inline LayerNorm: fp32 statistics, the normalized stream in
    x's dtype, then ``* gamma + beta`` in the promoted dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = ((x - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    return y * gamma + beta


def _linear(x, w, b=None):
    y = F.linear(x, w.to(x.dtype))
    return y if b is None else y + b.to(y.dtype)


def _param(shape, dtype, device, init=None, generator=None, gain=1.0):
    t = torch.empty(shape, dtype=dtype, device=device)
    if init == "xavier":
        nn.init.xavier_uniform_(t, gain=gain, generator=generator)
    elif init == "ones":
        t.fill_(1.0)
    else:
        t.zero_()
    return nn.Parameter(t)


class _MultiheadBase(nn.Module):
    def _common(self, embed_dim, num_heads, dropout_p, bias, include_norm_add,
                impl, params_dtype, device, generator):
        if impl not in ("fast", "default"):
            raise ValueError(f"impl must be 'fast' or 'default', got {impl!r}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.bias = float(dropout_p), bias
        self.include_norm_add, self.impl = include_norm_add, impl
        self.generator = generator
        self._kw = dict(dtype=params_dtype, device=resolve_device(device))
        if include_norm_add:
            e = embed_dim
            self.lyr_nrm_gamma_weights = _param((e,), init="ones", **self._kw)
            self.lyr_nrm_beta_weights = _param((e,), **self._kw)

    def _norm(self, x):
        if not self.include_norm_add:
            return x
        return _layer_norm(x, self.lyr_nrm_gamma_weights,
                           self.lyr_nrm_beta_weights)

    def _finish(self, ctx, residual, is_training):
        out = _linear(_bhsd_to_sbc(ctx), self.out_proj_weight,
                      self.out_proj_bias if self.bias else None)
        if self.include_norm_add:
            if is_training and self.dropout > 0.0:
                out = dropout(out, self.dropout, _need_generator(self.generator))
            out = out + residual
        return out

    def _core(self, q, k, v, key_padding_mask, attn_mask, mask_additive,
              is_training):
        h = self.num_heads
        return _attention_core(
            _sbc_to_bhsd(q, h), _sbc_to_bhsd(k, h), _sbc_to_bhsd(v, h),
            key_padding_mask=key_padding_mask, attn_mask=attn_mask,
            mask_additive=mask_additive,
            scale=(self.embed_dim // h) ** -0.5, dropout_p=self.dropout,
            deterministic=not is_training, generator=self.generator,
            impl=self.impl)


class SelfMultiheadAttn(_MultiheadBase):
    """Self multi-head attention, ``[time, batch, channel]`` layout: ±bias,
    ±include_norm_add (pre-LN + residual add), binary or additive
    key-padding mask, separate (``q_weight``, ``k_weight``, ``v_weight``)
    or packed (``in_proj_weight [3e, e]``) QKV parameters, made on
    ``device`` (CUDA by default).  ``generator`` draws the initial
    parameters, then each training call's dropout."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", separate_qkv_params: bool = False,
                 mask_additive: bool = False,
                 params_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mask_additive and include_norm_add:
            raise ValueError("additive mask not supported with layer norm")
        self._common(embed_dim, num_heads, dropout, bias, include_norm_add,
                     impl, params_dtype, device, generator)
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive = mask_additive
        e, kw, g = embed_dim, self._kw, generator
        # xavier_uniform with gain sqrt(2) on the packed [3e, e] weight is the
        # JAX variance_scaling(2.0, "fan_avg", "uniform")
        if separate_qkv_params:
            for name in ("q", "k", "v"):
                setattr(self, f"{name}_weight",
                        _param((e, e), init="xavier", generator=g, **kw))
                if bias:
                    setattr(self, f"{name}_bias", _param((e,), **kw))
        else:
            self.in_proj_weight = _param((3 * e, e), init="xavier",
                                         generator=g, gain=math.sqrt(2.0),
                                         **kw)
            if bias:
                self.in_proj_bias = _param((3 * e,), **kw)
        self.out_proj_weight = _param((e, e), init="xavier", generator=g, **kw)
        if bias:
            self.out_proj_bias = _param((e,), **kw)

    def forward(self, query, key=None, value=None, key_padding_mask=None,
                attn_mask=None, is_training: bool = True):
        del key, value  # self-attention: q == k == v (reference signature)
        residual = query
        x = self._norm(query)
        if self.separate_qkv_params:
            q, k, v = (_linear(x, getattr(self, f"{n}_weight"),
                               getattr(self, f"{n}_bias") if self.bias
                               else None) for n in ("q", "k", "v"))
        else:
            y = _linear(x, self.in_proj_weight,
                        self.in_proj_bias if self.bias else None)
            q, k, v = y.chunk(3, dim=-1)
        ctx = self._core(q, k, v, key_padding_mask, attn_mask,
                         self.mask_additive, is_training)
        return self._finish(ctx, residual, is_training)


class EncdecMultiheadAttn(_MultiheadBase):
    """Encoder-decoder attention: q from the decoder stream, k and v from
    the encoder's (``in_proj_weight_q [e, e]`` and the packed
    ``in_proj_weight_kv [2e, e]``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast",
                 params_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._common(embed_dim, num_heads, dropout, bias, include_norm_add,
                     impl, params_dtype, device, generator)
        e, kw, g = embed_dim, self._kw, generator
        self.in_proj_weight_q = _param((e, e), init="xavier", generator=g,
                                       **kw)
        # JAX's variance_scaling(sqrt(2), "fan_avg", "uniform")
        self.in_proj_weight_kv = _param((2 * e, e), init="xavier",
                                        generator=g, gain=2.0 ** 0.25, **kw)
        if bias:
            self.in_proj_bias_q = _param((e,), **kw)
            self.in_proj_bias_kv = _param((2 * e,), **kw)
        self.out_proj_weight = _param((e, e), init="xavier", generator=g, **kw)
        if bias:
            self.out_proj_bias = _param((e,), **kw)

    def forward(self, query, key, value=None, key_padding_mask=None,
                attn_mask=None, is_training: bool = True):
        del value  # the reference derives k and v from `key`
        residual = query
        x = self._norm(query)
        q = _linear(x, self.in_proj_weight_q,
                    self.in_proj_bias_q if self.bias else None)
        kv = _linear(key, self.in_proj_weight_kv,
                     self.in_proj_bias_kv if self.bias else None)
        k, v = kv.chunk(2, dim=-1)
        ctx = self._core(q, k, v, key_padding_mask, attn_mask, False,
                         is_training)
        return self._finish(ctx, residual, is_training)
