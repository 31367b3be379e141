"""Global singletons for Megatron-style training scripts (counterpart of
``apex_tpu/transformer/testing/global_vars.py``, apex's
``transformer/testing/global_vars.py``).

``get_args`` / ``get_num_microbatches`` / ``get_current_global_batch_size``
/ ``update_num_microbatches`` / ``get_tensorboard_writer`` / ``get_timers``
behind ``set_global_variables``, over the port's microbatch calculator
(:mod:`apex_tpu_torch.transformer.microbatches`) and pipeline
:class:`~apex_tpu_torch.transformer.pipeline_parallel._timers.Timers`.
apex's autoresume hook (cluster infrastructure) is left out, as in the
JAX module.  The timers sync ``device`` (CUDA unless the caller asks for
the CPU) when a timer is stopped with ``barrier=True``.
"""

from __future__ import annotations

from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.pipeline_parallel._timers import Timers
from apex_tpu_torch.transformer.testing.arguments import parse_args

_GLOBAL_ARGS = None
_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TENSORBOARD_WRITER = None
_GLOBAL_TIMERS = None

__all__ = [
    "get_args", "get_num_microbatches", "get_current_global_batch_size",
    "update_num_microbatches", "get_tensorboard_writer", "get_timers",
    "set_global_variables", "destroy_global_vars",
]


def _ensure_initialized(var, name):
    if var is None:
        raise RuntimeError(f"{name} is not initialized "
                           "(call set_global_variables first)")
    return var


def _ensure_not_initialized(var, name):
    if var is not None:
        raise RuntimeError(f"{name} is already initialized")


def get_args():
    return _ensure_initialized(_GLOBAL_ARGS, "args")


def get_num_microbatches() -> int:
    return _ensure_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    ).get()


def get_current_global_batch_size() -> int:
    return _ensure_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    ).get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int, *,
                            consistency_check: bool = True) -> None:
    _ensure_initialized(
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR, "num microbatches calculator"
    ).update(consumed_samples, consistency_check)


def get_tensorboard_writer():
    """The ``SummaryWriter`` of ``--tensorboard-dir``, or None."""
    return _GLOBAL_TENSORBOARD_WRITER


def get_timers() -> Timers:
    return _ensure_initialized(_GLOBAL_TIMERS, "timers")


def set_global_variables(extra_args_provider=None, args_defaults=None,
                         override_args=None, ignore_unknown_args=False,
                         args_list=None, *, device="cuda"):
    """Parse the arguments (:func:`parse_args`) and build every singleton;
    returns the arguments.  Raises if they are already set; a failure
    part way leaves every singleton unset."""
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR, _GLOBAL_TIMERS
    global _GLOBAL_TENSORBOARD_WRITER
    _ensure_not_initialized(_GLOBAL_ARGS, "args")
    # build every component before assigning any global: a failure part
    # way must leave the singletons clean, not half set
    args = parse_args(extra_args_provider=extra_args_provider,
                      defaults=args_defaults, override_args=override_args,
                      ignore_unknown_args=ignore_unknown_args,
                      args_list=args_list)
    calculator = build_num_microbatches_calculator(
        args.rank, args.rampup_batch_size, args.global_batch_size,
        args.micro_batch_size, args.data_parallel_size)
    timers = Timers(device)
    writer = None
    if args.tensorboard_dir is not None:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            # tensorboard is an optional package: no writer without it,
            # as in the JAX module
            SummaryWriter = None
        if SummaryWriter is not None:
            writer = SummaryWriter(log_dir=args.tensorboard_dir)
    _GLOBAL_ARGS = args
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = calculator
    _GLOBAL_TENSORBOARD_WRITER = writer
    _GLOBAL_TIMERS = timers
    return args


def destroy_global_vars():
    """Unset every singleton (the testing hook beside
    ``parallel_state.destroy_model_parallel``)."""
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR, _GLOBAL_TIMERS
    global _GLOBAL_TENSORBOARD_WRITER
    _GLOBAL_ARGS = None
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
    _GLOBAL_TENSORBOARD_WRITER = None
    _GLOBAL_TIMERS = None
