"""Model families of the port (counterpart of ``apex_tpu.models``):
:mod:`~apex_tpu_torch.models.llama` for serving, and
:mod:`~apex_tpu_torch.models.convert` to carry flax weights over (Llama,
and the GPT of :mod:`apex_tpu_torch.transformer.testing`)."""

from apex_tpu_torch.models.convert import (
    gpt_params_from_jax,
    llama_params_from_jax,
)
from apex_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "gpt_params_from_jax",
           "llama_params_from_jax"]
