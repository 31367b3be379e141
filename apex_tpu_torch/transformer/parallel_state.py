"""Model-parallel topology state over ``torch.distributed`` process groups
(counterpart of ``apex_tpu/transformer/parallel_state.py``).

The JAX package installs one ``('dp', 'pp', 'tp')`` mesh and its getters
return axis names and mesh shapes.  The port follows the PyTorch idiom
Megatron's ``mpu`` was written for: one process per rank, and
:func:`initialize_model_parallel` cuts the ``torch.distributed`` world
into tensor-parallel and data-parallel process groups.  Rank order is
Megatron's (and the JAX mesh's): tp fastest, so the ranks
``[i * tp, (i + 1) * tp)`` form one tensor-parallel group.

The world-size and rank getters return Python ints.  The axis-name
constants stay, for the partition-spec strings the checkpoint layer
writes (:mod:`apex_tpu_torch.resilience.elastic`).  Pipeline parallelism
is not ported: ``pipeline_model_parallel_size_ > 1`` raises.

Start the process group yourself first (``torch.distributed.
init_process_group(backend, init_method=..., rank=..., world_size=...)``:
NCCL for CUDA tensors, gloo for CPU ones).  :func:`serving_group` is the
port's twin of ``apex_tpu.utils.compat.serving_mesh``: the tensor-parallel
group a serving engine of ``size`` ranks runs over.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "DATA_PARALLEL_AXIS", "PIPELINE_PARALLEL_AXIS", "TENSOR_PARALLEL_AXIS",
    "initialize_model_parallel", "model_parallel_is_initialized",
    "destroy_model_parallel", "get_tensor_model_parallel_group",
    "get_data_parallel_group", "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_data_parallel_world_size", "get_model_parallel_world_size",
    "get_tensor_model_parallel_rank", "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank", "get_rank_info", "mesh_axis_sizes",
    "serving_group",
]

# canonical axis names (the reference's group names)
DATA_PARALLEL_AXIS = "dp"
PIPELINE_PARALLEL_AXIS = "pp"
TENSOR_PARALLEL_AXIS = "tp"

_TP_GROUP = None
_DP_GROUP = None
_AXIS_SIZES: Optional[dict] = None

_LAUNCH = ("start one process per rank and call torch.distributed."
           "init_process_group(backend, init_method='file:///tmp/rdv' or "
           "'tcp://localhost:<port>', rank=r, world_size=n) in each before "
           "building the model ('nccl' for CUDA tensors, 'gloo' for CPU "
           "ones)")


def _require_world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialized: "
                           + _LAUNCH)
    return dist.get_world_size()


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        pipeline_model_parallel_split_rank_: Optional[int] = None, *,
        tensor_model_parallel_size: Optional[int] = None,
        default_backend: Optional[str] = None,
        p2p_backend: Optional[str] = None) -> dict:
    """Cut the ``torch.distributed`` world into tp and dp groups; returns
    the ``{'dp', 'pp', 'tp'}`` axis sizes.

    Every rank must call it (group creation is collective).  The world
    must divide by ``tp * pp``, with the JAX package's error.
    ``default_backend`` / ``p2p_backend`` are accepted and ignored: the
    groups take the default group's backend."""
    global _TP_GROUP, _DP_GROUP, _AXIS_SIZES
    del default_backend, p2p_backend
    tp = int(tensor_model_parallel_size if tensor_model_parallel_size
             is not None else tensor_model_parallel_size_)
    pp = int(pipeline_model_parallel_size_)
    if pp != 1 or virtual_pipeline_model_parallel_size_ is not None \
            or pipeline_model_parallel_split_rank_ is not None:
        raise NotImplementedError(
            "pipeline model parallelism comes with the pipeline-parallel "
            "slice of the port (apex_tpu.transformer.pipeline_parallel); "
            "this parallel state takes tensor and data parallelism")
    if tp < 1:
        raise ValueError(f"tensor_model_parallel_size must be >= 1, got "
                         f"{tp}")
    world = _require_world()
    if world % (tp * pp) != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor parallel "
            f"size ({tp}) times pipeline parallel size ({pp})")
    if _TP_GROUP is not None:
        raise RuntimeError("model parallel state is already initialized; "
                           "destroy_model_parallel() first")
    dp = world // tp
    rank = dist.get_rank()
    # every rank creates every group, in the same order
    for i in range(dp):
        ranks = list(range(i * tp, (i + 1) * tp))
        group = dist.new_group(ranks)
        if rank in ranks:
            _TP_GROUP = group
    for j in range(tp):
        ranks = list(range(j, world, tp))
        group = dist.new_group(ranks)
        if rank in ranks:
            _DP_GROUP = group
    _AXIS_SIZES = {DATA_PARALLEL_AXIS: dp, PIPELINE_PARALLEL_AXIS: pp,
                   TENSOR_PARALLEL_AXIS: tp}
    return dict(_AXIS_SIZES)


def model_parallel_is_initialized() -> bool:
    return _TP_GROUP is not None


def destroy_model_parallel() -> None:
    """Forget the groups (``parallel_state.py:761`` parity); the default
    process group is the caller's to destroy."""
    global _TP_GROUP, _DP_GROUP, _AXIS_SIZES
    _TP_GROUP = _DP_GROUP = _AXIS_SIZES = None


def _initialized():
    if _TP_GROUP is None:
        raise AssertionError("model parallel group is not initialized")


def get_tensor_model_parallel_group():
    _initialized()
    return _TP_GROUP


def get_data_parallel_group():
    _initialized()
    return _DP_GROUP


def get_tensor_model_parallel_world_size() -> int:
    _initialized()
    return _AXIS_SIZES[TENSOR_PARALLEL_AXIS]


def get_pipeline_model_parallel_world_size() -> int:
    _initialized()
    return _AXIS_SIZES[PIPELINE_PARALLEL_AXIS]


def get_data_parallel_world_size() -> int:
    _initialized()
    return _AXIS_SIZES[DATA_PARALLEL_AXIS]


def get_model_parallel_world_size() -> int:
    return (get_tensor_model_parallel_world_size()
            * get_pipeline_model_parallel_world_size())


def get_tensor_model_parallel_rank() -> int:
    _initialized()
    return dist.get_rank(_TP_GROUP)


def get_pipeline_model_parallel_rank() -> int:
    _initialized()
    return 0


def get_data_parallel_rank() -> int:
    _initialized()
    return dist.get_rank(_DP_GROUP)


def get_rank_info() -> str:
    """Short rank descriptor for logging."""
    if _TP_GROUP is None:
        return "uninitialized"
    return (f"mesh(dp={get_data_parallel_world_size()}, "
            f"pp={get_pipeline_model_parallel_world_size()}, "
            f"tp={get_tensor_model_parallel_world_size()}), "
            f"process={dist.get_rank()}")


def mesh_axis_sizes() -> Optional[dict]:
    """``{'dp': N, 'pp': N, 'tp': N}`` of the installed groups, or None
    (what checkpoint manifests stamp as the saving mesh)."""
    return None if _AXIS_SIZES is None else dict(_AXIS_SIZES)


def serving_group(size: int):
    """The tensor-parallel group a ``size``-rank serving engine runs over.

    The ``torch.distributed`` world must be exactly ``size`` ranks, each
    one serving process; raises ``RuntimeError`` with the launch recipe
    otherwise.  Initializes the model-parallel state at ``tp = size`` if
    no state is installed (every rank constructs its engine, so the
    collective group creation lines up), and checks an installed one's tp
    size."""
    size = int(size)
    if size < 1:
        raise ValueError(f"tp size must be >= 1, got {size}")
    world = _require_world()
    if world != size:
        raise RuntimeError(
            f"serving_group({size}): the torch.distributed world has "
            f"{world} rank(s); a tp={size} server runs one process per "
            f"rank over a world of exactly {size}: " + _LAUNCH)
    if _TP_GROUP is None:
        initialize_model_parallel(size)
    elif _AXIS_SIZES[TENSOR_PARALLEL_AXIS] != size:
        raise RuntimeError(
            f"serving_group({size}): model parallel state is installed "
            f"at tp={_AXIS_SIZES[TENSOR_PARALLEL_AXIS]}")
    return _TP_GROUP


def _backend(group) -> str:
    return str(dist.get_backend(group))


def check_group_device(group, device: torch.device) -> None:
    """Refuse a group whose backend cannot carry ``device``'s tensors:
    NCCL for CUDA, gloo for the CPU (gloo is never used for CUDA
    tensors, and NCCL takes no CPU tensors)."""
    backend = _backend(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(
            f"the tp group's backend is {backend!r}; tensors on "
            f"{device.type} need {want!r}")
