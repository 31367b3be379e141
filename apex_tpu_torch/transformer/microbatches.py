"""Microbatch calculators, including batch-size rampup (the port's own
copy of ``apex_tpu/transformer/microbatches.py``, which is host Python).

Parity target: ``apex.transformer.microbatches`` (microbatches.py:26-168) and
``setup_microbatch_calculator`` (pipeline_parallel/utils.py:58-104): the
global singleton that answers ``get_micro_batch_size`` /
``get_num_microbatches`` / ``get_current_global_batch_size``, with a
constant and a ramp-up implementation.
"""

from __future__ import annotations

import logging
from typing import List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "build_num_microbatches_calculator",
    "ConstantNumMicroBatches",
    "RampupBatchsizeNumMicroBatches",
]


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
):
    """Select the constant or ramp-up calculator (microbatches.py:26-63)."""
    if rampup_batch_size is None:
        calculator = ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size)
        if rank == 0:
            logger.info("using a constant microbatch count of %d",
                        calculator.get())
        return calculator

    if len(rampup_batch_size) != 3:
        raise ValueError(
            "rampup_batch_size takes exactly three values: "
            "[start_batch_size, batch_size_increment, rampup_samples]; "
            f"got {rampup_batch_size!r}")
    start, increment, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatches(
        start, increment, samples,
        global_batch_size, micro_batch_size, data_parallel_size)


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches = None
        self.current_global_batch_size = None

    def get(self):
        return self.num_micro_batches

    def get_current_global_batch_size(self):
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check):
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """Fixed global batch → fixed microbatch count (microbatches.py:66-84)."""

    def __init__(self, global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        per_step = micro_batch_size * data_parallel_size
        if global_batch_size % per_step != 0:
            raise ValueError(
                f"global_batch_size={global_batch_size} must be a multiple of "
                f"micro_batch_size*dp = {micro_batch_size}*{data_parallel_size}"
                f" = {per_step}")
        self.num_micro_batches = global_batch_size // per_step
        if self.num_micro_batches < 1:
            raise ValueError(
                f"config yields {self.num_micro_batches} microbatches; "
                "need at least one")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Batch-size rampup (microbatches.py:87-168): global batch grows from
    ``start_batch_size`` by ``batch_size_increment`` every
    ``rampup_samples / steps`` consumed samples."""

    def __init__(self, start_batch_size, batch_size_increment, rampup_samples,
                 global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)

        for label, value in (("micro_batch_size*dp",
                              self.micro_batch_times_data_parallel_size),
                             ("start_batch_size", start_batch_size),
                             ("global_batch_size", global_batch_size),
                             ("batch_size_increment", batch_size_increment)):
            if value <= 0:
                raise ValueError(f"{label} must be positive, got {value}")
        if rampup_samples < 0:
            raise ValueError(
                f"rampup_samples must be non-negative, got {rampup_samples}")

        self.start_batch_size = start_batch_size
        self.global_batch_size = global_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = rampup_samples  # legacy-compatible attribute name

        span = global_batch_size - start_batch_size
        if span < 0:
            raise ValueError(
                f"start_batch_size={start_batch_size} exceeds "
                f"global_batch_size={global_batch_size}")
        if span % batch_size_increment != 0:
            raise ValueError(
                f"the ramp from {start_batch_size} to {global_batch_size} "
                f"(span {span}) must be a whole number of "
                f"{batch_size_increment}-sized increments")
        num_increments = span // batch_size_increment
        if num_increments == 0 or rampup_samples == 0:
            # degenerate ramp (start == global, or no samples to ramp over):
            # jump straight to the target batch size
            self.rampup_samples_per_increment = float("inf")
        else:
            self.rampup_samples_per_increment = rampup_samples / num_increments
        self.update(0, False)

    def update(self, consumed_samples, consistency_check):
        if consumed_samples >= self.ramup_samples:
            self.current_global_batch_size = self.global_batch_size
        else:
            completed = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + completed * self.batch_size_increment)
            if self.current_global_batch_size > self.global_batch_size:
                raise RuntimeError(
                    "rampup overshot the target global batch size "
                    f"({self.current_global_batch_size} > "
                    f"{self.global_batch_size})")
        if consistency_check:
            per_step = self.micro_batch_times_data_parallel_size
            if self.current_global_batch_size % per_step != 0:
                raise ValueError(
                    f"ramped global batch {self.current_global_batch_size} is "
                    f"not a multiple of micro_batch_size*dp = {per_step}")
        self.num_micro_batches = (
            self.current_global_batch_size
            // self.micro_batch_times_data_parallel_size)
