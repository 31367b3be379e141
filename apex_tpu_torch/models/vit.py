"""Vision Transformer classifier (counterpart of ``apex_tpu/models/vit.py``).

- Patch embedding as one product on unfolded patches: NHWC images
  ``[b, H, W, C]`` become ``[b, n*n, p*p*C]`` rows, channel fastest, in the
  JAX model's order, so a carried ``patch_kernel`` ``[p*p*C, h]`` keeps its
  meaning.
- Pre-LN encoder blocks over the tensor-parallel linears (``query``,
  ``key``, ``value`` and ``intermediate`` split by output rows, the two
  ``output`` linears by input columns), LayerNorm with ``eps`` 1e-12
  through :class:`apex_tpu_torch.normalization.FusedLayerNorm` (the norm
  kernels on the card), exact gelu.
- The attention is materialized in fp32 (``torch.matmul`` and
  ``torch.softmax``): the JAX model computes it outside any Pallas kernel,
  since ``n*n + 1`` tokens never meet the flash kernel's tiling.
- The ``[CLS]`` token's final state through the linear classifier.

Tokens are ``[s, b, h]`` inside the encoder, as in the JAX model.  The
top-level parameters keep the flax names and layouts (``patch_kernel``,
``patch_bias``, ``cls_token``, ``position_embeddings``,
``classifier_kernel`` ``[h, labels]``, ``classifier_bias``); the linears
of the layers are ``[out, in]`` torch weights
(:func:`~apex_tpu_torch.models.convert.vit_params_from_jax`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    tp_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import normal_

__all__ = ["ViTConfig", "ViTSelfAttention", "ViTLayer",
           "ViTForImageClassification"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT architecture knobs (HF ``ViTConfig`` field names; the JAX
    dataclass's defaults, ViT-B/16 at 224 px)."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    num_labels: int = 1000

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def vit_l16(cls) -> "ViTConfig":
        """ViT-Large/16: 24 x 1024, 16 heads, 4096 MLP, 16 px patches."""
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096)


class ViTSelfAttention(nn.Module):
    """Separate q, k, v linears (the rank's ``heads / tp`` heads), the fp32
    materialized attention, the output linear."""

    def __init__(self, config: ViTConfig, *, params_dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        kw = dict(dtype=params_dtype, device=device, generator=generator)
        self.query = ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                          gather_output=False, **kw)
        self.key = ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                        gather_output=False, **kw)
        self.value = ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                          gather_output=False, **kw)
        self.output = RowParallelLinear(c.hidden_size, c.hidden_size,
                                        input_is_parallel=True, **kw)

    def forward(self, x):
        c = self.config
        nh = c.num_attention_heads // tp_world_size()
        hd = c.hidden_size // c.num_attention_heads
        s, b = x.shape[0], x.shape[1]

        def heads(t):       # [s, b, nh * hd] -> [b, nh, s, hd] in fp32
            return t.view(s, b, nh, hd).permute(1, 2, 0, 3).float()

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scale = 1.0 / float(hd) ** 0.5
        p = torch.softmax(torch.matmul(q * scale, k.transpose(-1, -2)), dim=-1)
        ctx = torch.matmul(p, v).to(x.dtype)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, nh * hd)
        return self.output(ctx)


class ViTLayer(nn.Module):
    """Pre-LN block: LN -> attention -> + residual -> LN -> MLP (exact
    gelu) -> + residual."""

    def __init__(self, config: ViTConfig, *, params_dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        kw = dict(dtype=params_dtype, device=device, generator=generator)
        self.layernorm_before = FusedLayerNorm(
            c.hidden_size, eps=c.layer_norm_eps, dtype=params_dtype,
            device=device)
        self.attention = ViTSelfAttention(c, params_dtype=params_dtype,
                                          device=device, generator=generator)
        self.layernorm_after = FusedLayerNorm(
            c.hidden_size, eps=c.layer_norm_eps, dtype=params_dtype,
            device=device)
        self.intermediate = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, gather_output=False, **kw)
        self.output = RowParallelLinear(c.intermediate_size, c.hidden_size,
                                        input_is_parallel=True, **kw)

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        h = nn.functional.gelu(self.intermediate(self.layernorm_after(x)))
        return x + self.output(h)


class ViTForImageClassification(nn.Module):
    """Patch embedding + ``[CLS]`` + encoder + LN + linear head: NHWC
    ``pixels [b, H, W, C]`` to logits ``[b, num_labels]``.  The parameters
    are drawn from ``generator`` (lecun-normal products, ``normal(0,
    0.02)`` positions, zero biases and ``[CLS]``) in ``params_dtype`` on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: ViTConfig, *, params_dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        dev = resolve_device(device)
        self.config = c
        pdim = c.patch_size * c.patch_size * c.num_channels

        def param(shape, std):
            if std == 0.0:
                return nn.Parameter(torch.zeros(shape, dtype=params_dtype,
                                                device=dev))
            return nn.Parameter(normal_(shape, std, dtype=params_dtype,
                                        device=dev, generator=generator))

        self.patch_kernel = param((pdim, c.hidden_size), pdim ** -0.5)
        self.patch_bias = param((c.hidden_size,), 0.0)
        self.cls_token = param((1, 1, c.hidden_size), 0.0)
        self.position_embeddings = param(
            (1, c.num_patches + 1, c.hidden_size), 0.02)
        self.layers = nn.ModuleList(
            ViTLayer(c, params_dtype=params_dtype, device=dev,
                     generator=generator)
            for _ in range(c.num_hidden_layers))
        self.layernorm = FusedLayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                        dtype=params_dtype, device=dev)
        self.classifier_kernel = param((c.hidden_size, c.num_labels),
                                       c.hidden_size ** -0.5)
        self.classifier_bias = param((c.num_labels,), 0.0)

    def forward(self, pixels):
        c = self.config
        b = pixels.shape[0]
        p, n = c.patch_size, c.image_size // c.patch_size
        # NHWC -> [b, n*n, p*p*C], channel fastest (the JAX unfold)
        x = pixels.reshape(b, n, p, n, p, c.num_channels)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, n * n, -1)
        x = (torch.matmul(x, self.patch_kernel.to(x.dtype))
             + self.patch_bias.to(x.dtype))
        cls = self.cls_token.to(x.dtype).expand(b, 1, c.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings.to(x.dtype)
        # [b, s, h] -> [s, b, h]; the norm kernel takes contiguous input
        x = x.transpose(0, 1).contiguous()
        for layer in self.layers:
            x = layer(x)
        cls_out = self.layernorm(x)[0]
        return (torch.matmul(cls_out, self.classifier_kernel.to(cls_out.dtype))
                + self.classifier_bias.to(cls_out.dtype))
