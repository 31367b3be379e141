"""Feature registry (counterpart of ``apex_tpu/feature_registry.py``).

apex gates each native extension behind a ``setup.py`` build flag and
guards its imports where it is used.  The port's components are always
importable; this registry records, for each one, whether it has a
hand-written CUDA kernel (and which, by their names in
``ops._dispatch.KERNELS``), so that users and tests can ask as the
reference's import guards allowed.  A component's kernels run on CUDA
tensors and its plain PyTorch version on CPU tensors (``ops/_dispatch.py``).

It is introspection only: nothing here switches a kernel off, because
the dispatch has no such switch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

__all__ = ["Feature", "register", "available_features", "on_cuda"]


@dataclasses.dataclass(frozen=True)
class Feature:
    name: str
    description: str
    kernels: Tuple[str, ...]    # its names in ops._dispatch.KERNELS
    plain: str                  # what computes it without a kernel

    @property
    def cuda(self) -> bool:
        """Whether the component has a hand-written CUDA kernel."""
        return bool(self.kernels)


_FEATURES: Dict[str, Feature] = {}


def register(name: str, description: str, kernels: Tuple[str, ...] = (),
             plain: str = "plain PyTorch") -> None:
    """Record a component; ``kernels`` names its hand-written kernels (none
    for a component that is plain PyTorch on every device)."""
    _FEATURES[name] = Feature(name, description, tuple(kernels), plain)


def available_features() -> Dict[str, Feature]:
    return dict(_FEATURES)


def on_cuda() -> bool:
    """Whether a CUDA card is usable (the kernels' route)."""
    return torch.cuda.is_available()


_ADAM, _LAMB = ("mt_adam", "packed_adam"), ("mt_lamb", "lamb_phase1")
register("multi_tensor_apply", "multi-tensor scale/l2norm/Adam/LAMB over "
         "tensor lists", ("mt_l2norm", "mt_scale", "mt_adam", "mt_lamb"))
register("fused_optimizers", "FusedAdam/LAMB/SGD/NovoGrad/Adagrad",
         _ADAM + _LAMB + ("packed_adagrad", "mt_l2norm", "mt_scale"))
register("fused_layer_norm", "LayerNorm/RMSNorm forward and backward",
         ("layer_norm_fwd", "layer_norm_bwd"))
register("scaled_masked_softmax", "scaled (masked/causal) softmax",
         ("scaled_softmax_fwd", "scaled_softmax_bwd"))
register("flash_attention", "fused multihead attention, forward and "
         "backward", ("flash_attention_fwd", "flash_attention_dq",
                      "flash_attention_dkv"))
register("fused_lm_head", "LM head + softmax cross-entropy without the "
         "logits", ("fused_lm_head_fwd", "fused_lm_head_dh",
                    "fused_lm_head_de"))
register("pair_bias_attention", "OpenFold MSA attention with pair bias",
         ("pair_bias_attention_fwd", "pair_bias_attention_dq",
          "pair_bias_attention_dkv", "pair_bias_attention_dbias"))
register("fused_rope", "rotary position embedding (sbhd/cached/thd/2d)")
register("amp", "O0-O3 policies, the O1 op namespace, the loss scaler")
register("sync_batchnorm", "distributed batch norm statistics",
         plain="all-reduce over the process group")
register("halo_exchange", "spatial-parallel halo exchange",
         plain="point-to-point over the process group")
register("tensor_parallel", "Megatron column/row/vocab-parallel layers, "
         "sequence parallelism", plain="collectives over the tp group")
register("pipeline_parallel", "the 1F1B, interleaved and no-pipelining "
         "schedules", plain="point-to-point over the pp group")
register("moe", "top-1 experts over an expert-parallel group",
         plain="all-to-all over the ep group")
register("context_parallel", "ring attention over a context-parallel group",
         plain="point-to-point over the cp group")
register("resilience", "validated checkpoints, fault injection, heartbeat",
         plain="host I/O")
register("serving", "slotted and paged KV-cache decode, continuous "
         "batching, speculation, prefix caching, int8, tp, the fleet",
         ("layer_norm_fwd",), plain="host scheduler + plain PyTorch")
register("obs", "metrics registry, span tracing, exporters",
         plain="host-side stdlib")
register("host_packing", "flatten/unflatten of host arrays",
         plain="C++ (csrc/packing.cpp) through ctypes")
