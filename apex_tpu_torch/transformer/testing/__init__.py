"""apex_tpu_torch.transformer.testing: the standalone models (counterpart
of ``apex_tpu.transformer.testing``): the GPT and the transformer LM it is
built from.  The BERT model and the argument/global-variable fixtures of
the JAX package are not ported yet."""

from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTModel,
    gpt_model_provider,
)

__all__ = ["GPTModel", "gpt_model_provider"]
