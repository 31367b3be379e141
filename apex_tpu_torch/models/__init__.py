"""Model families of the port (counterpart of ``apex_tpu.models``):
:mod:`~apex_tpu_torch.models.llama` for serving and training,
:mod:`~apex_tpu_torch.models.llama_pipeline` for its pipeline-parallel
stages, and :mod:`~apex_tpu_torch.models.convert` to carry flax weights
over (Llama, its pipeline stages, the GPT, its pipeline stages and the BERT of
:mod:`apex_tpu_torch.transformer.testing`, the ViT and the ImageNet
example's ResNet); :mod:`~apex_tpu_torch.models.vit` is the Vision
Transformer classifier."""

from apex_tpu_torch.models.convert import (
    bert_params_from_jax,
    gpt_params_from_jax,
    gpt_pipeline_params_from_jax,
    llama_params_from_jax,
    llama_pipeline_params_from_jax,
    resnet_params_from_jax,
    vit_params_from_jax,
)
from apex_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from apex_tpu_torch.models.llama_pipeline import (
    LlamaPipeConfig,
    build_llama_pipeline,
    init_llama_pipeline_params,
    make_llama_3d_train_step,
)
from apex_tpu_torch.models.vit import (
    ViTConfig,
    ViTForImageClassification,
    ViTLayer,
    ViTSelfAttention,
)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaPipeConfig",
           "build_llama_pipeline", "init_llama_pipeline_params",
           "make_llama_3d_train_step", "gpt_params_from_jax",
           "gpt_pipeline_params_from_jax",
           "llama_params_from_jax", "llama_pipeline_params_from_jax",
           "resnet_params_from_jax", "bert_params_from_jax",
           "vit_params_from_jax", "ViTConfig", "ViTForImageClassification",
           "ViTLayer", "ViTSelfAttention"]
