"""apex_tpu_torch.utils: flat-buffer packing, host-side tree serialization
and tree math (counterpart of ``apex_tpu.utils``).  The package exports the
packing and serialization names the JAX package does; its JAX pytree math
(``tree_add``, ``tree_axpby``, ...) has no export here (the port's
``utils.tree_math`` holds what the port's optimizers use)."""

from apex_tpu_torch.utils.packing import (
    PackedBuffer,
    flatten_dense_tensors,
    pack_pytree,
    unflatten_dense_tensors,
    unpack_pytree,
)
from apex_tpu_torch.utils.serialization import (
    leaf_crc32,
    tree_from_host_dict,
    tree_paths,
    tree_to_host_dict,
)

__all__ = [
    "leaf_crc32",
    "tree_from_host_dict",
    "tree_paths",
    "tree_to_host_dict",
    "flatten_dense_tensors",
    "unflatten_dense_tensors",
    "PackedBuffer",
    "pack_pytree",
    "unpack_pytree",
]
