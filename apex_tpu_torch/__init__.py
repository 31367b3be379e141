"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

The port lives beside the JAX package, which stays the reference: each
module here mirrors its counterpart in ``apex_tpu`` and is held against it
on the same inputs and weights.  Plain tensor code is PyTorch; every
Pallas kernel on a ported path becomes a kernel written by hand for
``sm_90a`` under ``csrc/``, built with ``nvcc`` on first use.

Every entry point runs on CUDA unless the caller passes ``device="cpu"``;
on the CPU each kernel is replaced by its plain PyTorch version.  The
package never imports JAX or ``apex_tpu``.

What is ported so far, on one card: serving of the Llama family —
:mod:`~apex_tpu_torch.serving` over :mod:`~apex_tpu_torch.models.llama` —
the model's uncached forward and ``labels=`` per-token loss (evaluation),
and its training: the loss's backward through the LayerNorm/RMSNorm,
flash attention and fused LM-head kernels, forward and backward
(:mod:`~apex_tpu_torch.ops.layer_norm`,
:mod:`~apex_tpu_torch.ops.flash_attention`,
:mod:`~apex_tpu_torch.ops.fused_lm_head`), and
:class:`~apex_tpu_torch.optimizers.FusedAdam`
(:mod:`~apex_tpu_torch.examples.llama_pretrain` drives it); and GPT
training: :class:`~apex_tpu_torch.transformer.testing.GPTModel` with
flash attention or the fused scaled/masked softmax
(:mod:`~apex_tpu_torch.ops.softmax`), under
:class:`~apex_tpu_torch.optimizers.FusedLAMB`, unpacked or over the packed
LAMB kernel (:mod:`~apex_tpu_torch.ops.packed_update`)
(:mod:`~apex_tpu_torch.examples.gpt_pretrain` drives it); and OpenFold's
MSA row attention with pair bias:
:mod:`~apex_tpu_torch.contrib.openfold_triton` (``attention_core`` over
the pair-bias attention kernels of
:mod:`~apex_tpu_torch.ops.pair_bias_attention`, forward, dq, dk/dv and
d(bias); ``LayerNormSmallShapeOptImpl``; ``FusedAdamSWA``); and mixed
precision: :mod:`~apex_tpu_torch.amp` (``initialize`` with the O0-O3
policies, the dynamic loss scaler on the device),
:mod:`~apex_tpu_torch.fp16_utils` (``FP16Optimizer``), fp32 master
weights and the capturable ``step(grad_scale=, found_inf=)`` in every
fused optimizer, and :class:`~apex_tpu_torch.optimizers.FusedAdagrad`,
with the packed Adam and Adagrad kernels of
:mod:`~apex_tpu_torch.ops.packed_update`
(:mod:`~apex_tpu_torch.examples.simple` drives the amp flow); and data
parallelism: :mod:`~apex_tpu_torch.parallel` (``DistributedDataParallel``,
``SyncBatchNorm``, ``LARC``) and the ZeRO-2 optimizers of
:mod:`~apex_tpu_torch.contrib.optimizers`, with the ImageNet ResNet
trainer (:mod:`~apex_tpu_torch.examples.imagenet_main`); and the Megatron
harness (:mod:`~apex_tpu_torch.transformer.testing`'s arguments, global
singletons and pipeline-stage GPT) with its dp x pp x tp GPT driver
(:mod:`~apex_tpu_torch.examples.megatron_gpt_pretrain`), amp O1's op
namespace (:mod:`~apex_tpu_torch.amp.functional`), and expert, context
and spatial parallelism.
"""

__version__ = "0.1.0"

from apex_tpu_torch._logging import _install_rank_aware_logging, set_logging_level

# The rank-aware handler on the ``apex_tpu_torch`` logger, installed at
# import as the JAX package installs its own.
_install_rank_aware_logging()
