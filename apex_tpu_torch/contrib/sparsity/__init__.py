"""ASP 2:4 structured sparsity (counterpart of
``apex_tpu.contrib.sparsity``)."""

from apex_tpu_torch.contrib.sparsity.asp import ASP
from apex_tpu_torch.contrib.sparsity.permutation_search import (
    accelerated_search_for_good_permutation,
    apply_permutation,
    invert_permutation,
    sum_after_2_to_4,
)
from apex_tpu_torch.contrib.sparsity.sparse_masklib import create_mask

__all__ = ["ASP", "create_mask",
           "accelerated_search_for_good_permutation", "apply_permutation",
           "invert_permutation", "sum_after_2_to_4"]
