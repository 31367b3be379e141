"""DP-sharded batch samplers (apex/transformer/_data/_batchsampler.py:38-160;
the port's own copy of ``apex_tpu/transformer/_data/_batchsampler.py``).

They yield lists of dataset indices for this data-parallel rank, usable
with any loader (a ``torch.utils.data.DataLoader``'s ``batch_sampler``
among them).  The random sampler draws its permutation from
``np.random.default_rng(epoch)``, as the JAX package's does, so both
yield the same index lists.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]


class _Base:
    def __init__(self, total_samples, consumed_samples, micro_batch_size,
                 data_parallel_rank, data_parallel_size):
        if total_samples <= 0:
            raise RuntimeError(f"no sample to consume: {total_samples}")
        if micro_batch_size <= 0:
            raise RuntimeError(f"micro_batch_size size must be greater than 0, but {micro_batch_size}")
        if data_parallel_size <= 0:
            raise RuntimeError(f"data parallel size must be greater than 0, but {data_parallel_size}")
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank should be smaller than data size, but "
                f"{data_parallel_rank} >= {data_parallel_size}")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)


class MegatronPretrainingSampler(_Base):
    """Sequential DP-sharded sampler (_batchsampler.py:38-94)."""

    def __init__(self, total_samples, consumed_samples, micro_batch_size,
                 data_parallel_rank, data_parallel_size,
                 drop_last: bool = True):
        super().__init__(total_samples, consumed_samples, micro_batch_size,
                         data_parallel_rank, data_parallel_size)
        self.drop_last = drop_last

    def __len__(self):
        return self.total_samples

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.micro_batch_size
        return start, start + self.micro_batch_size

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_data_parallel_size:
                s, e = self.get_start_end_idx()
                yield batch[s:e]
                batch = []
        if len(batch) > 0 and not self.drop_last:
            s, e = self.get_start_end_idx()
            yield batch[s:e]


class MegatronPretrainingRandomSampler(_Base):
    """Shuffled epoch-bucketed sampler (_batchsampler.py:97-160)."""

    def __init__(self, total_samples, consumed_samples, micro_batch_size,
                 data_parallel_rank, data_parallel_size):
        super().__init__(total_samples, consumed_samples, micro_batch_size,
                         data_parallel_rank, data_parallel_size)
        self.last_batch_size = (
            self.total_samples % self.micro_batch_times_data_parallel_size)

    def __len__(self):
        return self.total_samples

    def __iter__(self):
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples
        if current_epoch_samples % self.micro_batch_times_data_parallel_size != 0:
            raise AssertionError

        # data sharding and random sampling
        bucket_size = ((self.total_samples // self.micro_batch_times_data_parallel_size)
                       * self.micro_batch_size)
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        g = np.random.default_rng(self.epoch)
        random_idx = g.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.micro_batch_size:
                self.consumed_samples += self.micro_batch_times_data_parallel_size
                yield batch
                batch = []
