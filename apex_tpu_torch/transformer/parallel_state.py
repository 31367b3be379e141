"""Model-parallel topology state over ``torch.distributed`` process groups
(counterpart of ``apex_tpu/transformer/parallel_state.py``).

The JAX package installs one ``('dp', 'pp', 'tp')`` mesh and its getters
return axis names and mesh shapes.  The port follows the PyTorch idiom
Megatron's ``mpu`` was written for: one process per rank, and
:func:`initialize_model_parallel` cuts the ``torch.distributed`` world
into tensor-, pipeline- and data-parallel process groups, the
model-parallel group (tp x pp) and the embedding groups (each pipeline's
first and last stage).  Rank order is the JAX mesh's: its devices are
laid out ``reshape(pp, dp, tp).transpose(1, 0, 2)``, so the rank at
pipeline stage ``p``, data-parallel replica ``d`` and tensor-parallel
shard ``t`` is ``p * dp * tp + d * tp + t`` (:func:`rank_grid`), and port
rank ``r`` plays JAX device ``r``.  tp is fastest: the ranks ``[i * tp,
(i + 1) * tp)`` form one tensor-parallel group.

The world-size and rank getters return Python ints, and the predicates
(:func:`is_pipeline_first_stage`, :func:`is_pipeline_last_stage`)
Python bools.  The axis-name constants stay, for the partition-spec
strings the checkpoint layer writes (:mod:`apex_tpu_torch.resilience.
elastic`).  The virtual-pipeline rank and the split rank are module
state, as in the JAX package.  ``get_mesh`` and ``initialize_distributed``
(JAX mesh set-up) have no counterpart: the caller starts the process
group.

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
    "rank_grid", "initialize_model_parallel",
    "model_parallel_is_initialized", "destroy_model_parallel",
    "get_tensor_model_parallel_group", "get_pipeline_model_parallel_group",
    "get_data_parallel_group", "get_model_parallel_group",
    "get_embedding_group", "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_data_parallel_world_size", "get_model_parallel_world_size",
    "get_tensor_model_parallel_rank", "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank",
    "is_pipeline_first_stage", "is_pipeline_last_stage",
    "get_virtual_pipeline_model_parallel_world_size",
    "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "get_pipeline_model_parallel_split_rank",
    "set_pipeline_model_parallel_split_rank", "get_rank_info",
    "mesh_axis_sizes", "serving_group", "axis_group",
]

# canonical axis names (the reference's group names)
DATA_PARALLEL_AXIS = "dp"
PIPELINE_PARALLEL_AXIS = "pp"
TENSOR_PARALLEL_AXIS = "tp"

_TP_GROUP = None
_PP_GROUP = None
_DP_GROUP = None
_MP_GROUP = None
_EMBEDDING_GROUP = None
_AXIS_SIZES: Optional[dict] = None
_VIRTUAL_PIPELINE_WORLD_SIZE: Optional[int] = None
_VIRTUAL_PIPELINE_RANK: Optional[int] = None
_PIPELINE_SPLIT_RANK: Optional[int] = None

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


def rank_grid(world: int, tp: int, pp: int) -> dict:
    """The global ranks of every group of a ``world`` cut into tp x pp x
    dp, in the JAX mesh's device order (rank ``p * dp * tp + d * tp +
    t``): ``{"tp", "pp", "dp", "model", "embedding"}``, each a list of
    rank lists.  ``"model"`` is each replica's tp x pp ranks; an
    ``"embedding"`` group is a pipeline's first and last stage (its one
    stage at pp 1).  Pure: it needs no process group."""
    if tp < 1 or pp < 1 or world % (tp * pp):
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor parallel "
            f"size ({tp}) times pipeline parallel size ({pp})")
    dp = world // (tp * pp)

    def rank(p, d, t):
        return p * dp * tp + d * tp + t

    pipes = [[rank(p, d, t) for p in range(pp)]
             for d in range(dp) for t in range(tp)]
    return {
        "tp": [[rank(p, d, t) for t in range(tp)]
               for p in range(pp) for d in range(dp)],
        "dp": [[rank(p, d, t) for d in range(dp)]
               for p in range(pp) for t in range(tp)],
        "pp": pipes,
        "model": [[rank(p, d, t) for p in range(pp) for t in range(tp)]
                  for d in range(dp)],
        "embedding": [sorted({ranks[0], ranks[-1]}) for ranks in pipes],
    }


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        pipeline_model_parallel_split_rank_: Optional[int] = None, *,
        tensor_model_parallel_size: Optional[int] = None,
        default_backend: Optional[str] = None,
        p2p_backend: Optional[str] = None) -> dict:
    """Cut the ``torch.distributed`` world into the groups of
    :func:`rank_grid`; returns the ``{'dp', 'pp', 'tp'}`` axis sizes.

    Every rank must call it (group creation is collective).  The world
    must divide by ``tp * pp``, and a virtual pipeline needs pp >= 2,
    with the JAX package's errors.  ``default_backend`` /
    ``p2p_backend`` are accepted and ignored: the groups take the default
    group's backend."""
    global _TP_GROUP, _PP_GROUP, _DP_GROUP, _MP_GROUP, _EMBEDDING_GROUP
    global _AXIS_SIZES, _VIRTUAL_PIPELINE_WORLD_SIZE
    global _VIRTUAL_PIPELINE_RANK, _PIPELINE_SPLIT_RANK
    del default_backend, p2p_backend
    tp = int(tensor_model_parallel_size if tensor_model_parallel_size
             is not None else tensor_model_parallel_size_)
    pp = int(pipeline_model_parallel_size_)
    if tp < 1 or pp < 1:
        raise ValueError(f"tensor and pipeline parallel sizes must be >= 1, "
                         f"got tp={tp}, pp={pp}")
    world = _require_world()
    grid = rank_grid(world, tp, pp)
    if virtual_pipeline_model_parallel_size_ is not None and pp < 2:
        raise RuntimeError(
            "pipeline-model-parallel size should be greater than 1 with "
            "interleaved schedule")
    if _TP_GROUP is not None:
        raise RuntimeError("model parallel state is already initialized; "
                           "destroy_model_parallel() first")
    rank = dist.get_rank()
    mine = {}
    # every rank creates every group, in the same order
    for kind in ("tp", "dp", "pp", "model", "embedding"):
        for ranks in grid[kind]:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[kind] = group
    _TP_GROUP, _DP_GROUP, _PP_GROUP = mine["tp"], mine["dp"], mine["pp"]
    _MP_GROUP, _EMBEDDING_GROUP = mine["model"], mine.get("embedding")
    _VIRTUAL_PIPELINE_WORLD_SIZE = virtual_pipeline_model_parallel_size_
    _VIRTUAL_PIPELINE_RANK = (0 if virtual_pipeline_model_parallel_size_
                              else None)
    _PIPELINE_SPLIT_RANK = pipeline_model_parallel_split_rank_
    _AXIS_SIZES = {DATA_PARALLEL_AXIS: world // (tp * pp),
                   PIPELINE_PARALLEL_AXIS: pp, TENSOR_PARALLEL_AXIS: tp}
    return dict(_AXIS_SIZES)


def model_parallel_is_initialized() -> bool:
    return _TP_GROUP is not None


def destroy_model_parallel() -> None:
    """Forget the groups and the virtual-pipeline and split ranks
    (``parallel_state.py:761`` parity); the default process group is the
    caller's to destroy."""
    global _TP_GROUP, _PP_GROUP, _DP_GROUP, _MP_GROUP, _EMBEDDING_GROUP
    global _AXIS_SIZES, _VIRTUAL_PIPELINE_WORLD_SIZE
    global _VIRTUAL_PIPELINE_RANK, _PIPELINE_SPLIT_RANK
    _TP_GROUP = _PP_GROUP = _DP_GROUP = _MP_GROUP = _EMBEDDING_GROUP = None
    _AXIS_SIZES = _VIRTUAL_PIPELINE_WORLD_SIZE = None
    _VIRTUAL_PIPELINE_RANK = _PIPELINE_SPLIT_RANK = None


def _initialized():
    if _TP_GROUP is None:
        raise AssertionError("model parallel group is not initialized")


def get_tensor_model_parallel_group():
    _initialized()
    return _TP_GROUP


def get_pipeline_model_parallel_group():
    _initialized()
    return _PP_GROUP


def get_data_parallel_group():
    _initialized()
    return _DP_GROUP


def get_model_parallel_group():
    """The replica's tp x pp ranks (the group the model-parallel
    :class:`~apex_tpu_torch.transformer.amp.GradScaler` reduces over)."""
    _initialized()
    return _MP_GROUP


def get_embedding_group():
    """The first and last stage of this rank's pipeline (Megatron's
    embedding group, ``parallel_state.py:282-305``).  The JAX package
    returns the pp axis name: there the embedding-gradient reduction is
    a psum over pp."""
    _initialized()
    return _EMBEDDING_GROUP


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
    return dist.get_rank(_PP_GROUP)


def get_data_parallel_rank() -> int:
    _initialized()
    return dist.get_rank(_DP_GROUP)


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    """``parallel_state.py:589-610``: pp rank 0, and virtual rank 0 when a
    virtual pipeline is set, unless ``ignore_virtual``."""
    if not ignore_virtual and _VIRTUAL_PIPELINE_WORLD_SIZE is not None:
        if _VIRTUAL_PIPELINE_RANK != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual and _VIRTUAL_PIPELINE_WORLD_SIZE is not None:
        if _VIRTUAL_PIPELINE_RANK != _VIRTUAL_PIPELINE_WORLD_SIZE - 1:
            return False
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPELINE_WORLD_SIZE


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PIPELINE_RANK


def set_virtual_pipeline_model_parallel_rank(rank: int) -> None:
    global _VIRTUAL_PIPELINE_RANK
    _VIRTUAL_PIPELINE_RANK = rank


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _PIPELINE_SPLIT_RANK


def set_pipeline_model_parallel_split_rank(rank: int) -> None:
    global _PIPELINE_SPLIT_RANK
    _PIPELINE_SPLIT_RANK = rank


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


def axis_group(group, keyword: str):
    """``group`` as given for a mesh-axis keyword (``axis_name=``,
    ``expert_parallel_axis=``, ``context_parallel_axis=``, ...): the JAX
    modules take a mesh axis name there and run under ``shard_map``; the
    port takes the ``torch.distributed.ProcessGroup`` the collectives run
    over, or None for one rank.  A bare string raises ``ValueError``."""
    if isinstance(group, str):
        raise ValueError(
            f"{keyword}={group!r}: the port takes a torch.distributed "
            f"ProcessGroup here (or None for one rank), not a mesh axis "
            f"name")
    return group


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
