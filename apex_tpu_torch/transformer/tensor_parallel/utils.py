"""TP utility helpers (counterpart of
``apex_tpu/transformer/tensor_parallel/utils.py``)."""

from __future__ import annotations

from typing import Tuple

__all__ = ["VocabUtility", "divide", "ensure_divisibility",
           "split_tensor_along_last_dim"]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise AssertionError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False):
    """Split along the last dim into ``num_partitions`` equal chunks
    (views unless ``contiguous_split_chunks``)."""
    chunk = divide(tensor.shape[-1], num_partitions)
    parts = tensor.split(chunk, dim=-1)
    if contiguous_split_chunks:
        return tuple(p.contiguous() for p in parts)
    return tuple(parts)


class VocabUtility:
    """Vocab-range bookkeeping for the vocab-parallel embedding and
    cross-entropy: rank ``r`` owns global ids ``[first, last)``."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
            global_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        """The global size must divide evenly (the reference's contract)."""
        per_partition = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition, rank, world_size)
