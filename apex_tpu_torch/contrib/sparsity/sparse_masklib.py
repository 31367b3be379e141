"""N:M structured-sparsity masks (counterpart of
``apex_tpu.contrib.sparsity.sparse_masklib``).

Given a weight and a pattern like ``"m4n2_1d"``, keep the n
largest-magnitude entries of every group of m along the reduction
dimension.  The search is the reference's: enumerate the C(m, n)
patterns and take, per group, the pattern whose kept ``|w|`` sum is
largest, the first on a tie (JAX's ``argmax``).  Each pattern's score is
the fp32 sum of its kept ``|w|`` (a gather and a sum, no product that
TF32 could round), so for m4n2 the scores are the same fp32 values as
JAX's product with the 0/1 patterns.

The reduction dimension is PyTorch's: dimension 1 of a ``[out, in]``
linear weight (its last) and of an OIHW convolution weight (``I``), where
JAX groups along axis -2 of a flax ``[in, out]`` kernel or ``HWIO`` one.
For the same weight the port's mask is the transpose of JAX's.
"""

from __future__ import annotations

import itertools
import re
from functools import lru_cache

import numpy as np
import torch

__all__ = ["create_mask", "mn_1d_best", "compute_valid_1d_patterns"]


@lru_cache(maxsize=None)
def compute_valid_1d_patterns(m: int, n: int) -> np.ndarray:
    """All C(m, n) binary patterns with n ones, ``[C(m, n), m]`` fp32."""
    patterns = [
        [1.0 if i in keep else 0.0 for i in range(m)]
        for keep in itertools.combinations(range(m), n)
    ]
    return np.asarray(patterns, np.float32)


@lru_cache(maxsize=None)
def _kept_indices(m: int, n: int) -> np.ndarray:
    """Each pattern's kept positions, ``[C(m, n), n]``."""
    return np.asarray(list(itertools.combinations(range(m), n)), np.int64)


def mn_1d_best(matrix: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The best n:m bool mask per m-group along the last dimension."""
    if matrix.shape[-1] % m:
        raise ValueError(
            f"last dim ({matrix.shape[-1]}) must be a multiple of m={m}")
    kept = torch.as_tensor(_kept_indices(m, n), device=matrix.device)
    groups = matrix.detach().float().abs().reshape(-1, m)      # [G, m]
    scores = groups[:, kept].sum(-1)                           # [G, P]
    best = torch.argmax(scores, dim=-1)                        # first max
    patterns = torch.as_tensor(compute_valid_1d_patterns(m, n),
                               device=matrix.device)
    return (patterns[best] > 0.5).reshape(matrix.shape)


_PATTERN_RE = re.compile(r"m(\d+)n(\d+)_1d")


def create_mask(tensor: torch.Tensor, pattern: str = "m4n2_1d",
                axis: int = 1) -> torch.Tensor:
    """Bool keep-mask for ``tensor`` under an ``mMnN_1d`` pattern, grouped
    along ``axis`` (default 1: the ``in`` of a ``[out, in]`` weight and
    the ``I`` of an OIHW one); a 1-D tensor groups along its only axis."""
    match = _PATTERN_RE.fullmatch(pattern)
    if not match:
        raise ValueError(f"unsupported sparsity pattern {pattern!r} "
                         "(expected 'mMnN_1d', e.g. 'm4n2_1d')")
    m, n = int(match.group(1)), int(match.group(2))
    if tensor.dim() == 1:
        return mn_1d_best(tensor, m, n)
    moved = torch.movedim(tensor, axis, -1)
    return torch.movedim(mn_1d_best(moved, m, n), -1, axis)
