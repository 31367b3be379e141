"""apex_tpu_torch.transformer.testing: the standalone models (counterpart
of ``apex_tpu.transformer.testing``): the GPT, the BERT and the
transformer LM they are built from.  The Megatron harness's argument and
global-variable fixtures (``arguments.py``, ``global_vars.py``,
``commons.py``) are not ported yet."""

from apex_tpu_torch.transformer.testing.standalone_bert import (
    BertModel,
    bert_model_provider,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTModel,
    gpt_model_provider,
)

__all__ = ["BertModel", "bert_model_provider", "GPTModel",
           "gpt_model_provider"]
