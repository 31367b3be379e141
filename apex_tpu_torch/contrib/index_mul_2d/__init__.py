"""Fused gather-multiply (counterpart of ``apex_tpu.contrib.index_mul_2d``)."""

from apex_tpu_torch.contrib.index_mul_2d.index_mul_2d import index_mul_2d

__all__ = ["index_mul_2d"]
