"""apex_tpu_torch.transformer.testing: the standalone models and the
Megatron harness (counterpart of ``apex_tpu.transformer.testing``): the
GPT, the BERT and the transformer LM they are built from; the argument
parser (``arguments.py``), the global singletons (``global_vars.py``)
and the GPT cut into pipeline stages (``commons.py``)."""

from apex_tpu_torch.transformer.testing.arguments import (
    core_transformer_config_from_args,
    parse_args,
)
from apex_tpu_torch.transformer.testing.global_vars import (
    destroy_global_vars,
    get_args,
    get_current_global_batch_size,
    get_num_microbatches,
    get_tensorboard_writer,
    get_timers,
    set_global_variables,
    update_num_microbatches,
)
from apex_tpu_torch.transformer.testing.standalone_bert import (
    BertModel,
    bert_model_provider,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTModel,
    gpt_model_provider,
)

__all__ = [
    "BertModel", "bert_model_provider", "GPTModel", "gpt_model_provider",
    "parse_args", "core_transformer_config_from_args",
    "set_global_variables", "destroy_global_vars", "get_args",
    "get_num_microbatches", "get_current_global_batch_size",
    "update_num_microbatches", "get_tensorboard_writer", "get_timers",
]
