"""apex_tpu_torch.contrib: the specialized modules of ``apex_tpu.contrib``,
each under its JAX twin's name and ``__all__``:

- :mod:`.multihead_attn` and :mod:`.fmha`: attention blocks and packed
  varlen attention over the flash and scaled-softmax kernels;
- :mod:`.xentropy`, :mod:`.focal_loss` and :mod:`.transducer`: the
  smoothed cross-entropy, the sigmoid focal loss and the RNN-T joint and
  loss;
- :mod:`.group_norm`, :mod:`.groupbn` and :mod:`.cudnn_gbn`: channels-last
  GroupNorm, NHWC batch norm with add+ReLU and batch norm over rank
  subgroups;
- :mod:`.conv_bias_relu` and :mod:`.index_mul_2d`: the fused convolution
  epilogues and the gather-multiply;
- :mod:`.sparsity`: ASP 2:4 masks, the optimizer hook and the
  permutation search;
- :mod:`.openfold_triton` (the Evoformer attention core over the
  pair-bias attention kernels, ``LayerNormSmallShapeOptImpl`` and
  ``FusedAdamSWA``), :mod:`.clip_grad` (on the multi-tensor kernels),
  :mod:`.optimizers` (the ZeRO-2 ``DistributedFusedAdam`` and
  ``DistributedFusedLAMB``) and :mod:`.halo` (halo exchange, the spatially
  split convolution and bottleneck).

Submodules load on first use, as in the JAX package."""

import importlib as _importlib

_SUBMODULES = (
    "clip_grad",
    "conv_bias_relu",
    "cudnn_gbn",
    "fmha",
    "focal_loss",
    "halo",
    "group_norm",
    "groupbn",
    "index_mul_2d",
    "multihead_attn",
    "openfold_triton",
    "optimizers",
    "sparsity",
    "transducer",
    "xentropy",
)


def __getattr__(name):
    if name in _SUBMODULES:
        module = _importlib.import_module(f"apex_tpu_torch.contrib.{name}")
        globals()[name] = module
        return module
    raise AttributeError(
        f"module 'apex_tpu_torch.contrib' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_SUBMODULES))
