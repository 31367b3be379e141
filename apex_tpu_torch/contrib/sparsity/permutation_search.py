"""Input-channel permutation search for 2:4 structured sparsity
(the port's own copy of ``apex_tpu.contrib.sparsity.permutation_search``:
numpy only, run on the host).

Permuting a weight matrix's input channels before applying the n:m mask
can keep large-magnitude weights that a fixed channel order would prune.
Three composable strategies, as in the reference's search:

- greedy: each round evaluates every cross-stripe column swap with one
  batched [pairs, 16, rows, 4] top-2 reduction;
- escape: on convergence, force the least-bad non-improving swap and keep
  descending, returning the best permutation seen (``escape_attempts``);
- exhaustive(window=2): for every stripe pair, score all 35 unique
  bipartitions of their 8 columns into two groups of 4 (order within and
  between groups is irrelevant, so column 0 stays in group A) in one
  [pairs, 35, ...] batch.

The search works on a ``[rows, columns]`` matrix and permutes its
columns; for a torch ``[out, in]`` weight those are the input channels.
Apply the returned permutation with :func:`apply_permutation` and its
inverse on the producing layer.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

__all__ = ["sum_after_2_to_4", "accelerated_search_for_good_permutation",
           "apply_permutation", "invert_permutation"]


def _retained(groups: np.ndarray) -> np.ndarray:
    """Retained |magnitude| after 2:4 pruning of a [..., 4]-grouped view,
    reduced over the trailing two axes (rows, 4) — the ONE implementation
    of the keep rule (permutation_utilities.py:44-79), fp32 throughout."""
    g = np.abs(groups.astype(np.float32, copy=False))
    kept = g.sum(axis=(-1, -2)) - np.sort(g, axis=-1)[..., :2].sum(axis=(-1, -2))
    return kept


def sum_after_2_to_4(matrix: np.ndarray) -> float:
    """Total |magnitude| retained by 2:4 pruning along the last axis."""
    m = np.asarray(matrix)
    if m.shape[-1] % 4:
        raise ValueError(f"columns ({m.shape[-1]}) must be a multiple of 4")
    return float(_retained(m.reshape(-1, 1, 4)).sum())


# the 35 unique bipartitions of 8 columns into two unordered groups of 4:
# fix column 0 in group A (kills the A<->B symmetry), choose its 3 partners
_PAIR_COMBOS = np.array(
    [[0, *c] + [x for x in range(1, 8) if x not in c]
     for c in itertools.combinations(range(1, 8), 3)])  # [35, 8]


def _swap_gains(m, pair_a, pair_b, ci, cj):
    """Gain of every cross-stripe single-column swap: [pairs, 16]."""
    rows = m.shape[0]
    n_stripes = m.shape[1] // 4
    stripes = np.abs(m).reshape(rows, n_stripes, 4).transpose(1, 0, 2)
    base = _retained(stripes)
    sa = np.broadcast_to(stripes[pair_a, None],
                         (len(pair_a), 16, rows, 4)).copy()
    sb = np.broadcast_to(stripes[pair_b, None],
                         (len(pair_b), 16, rows, 4)).copy()
    for idx in range(16):
        sa[:, idx, :, ci[idx]] = stripes[pair_b][:, :, cj[idx]]
        sb[:, idx, :, cj[idx]] = stripes[pair_a][:, :, ci[idx]]
    return (_retained(sa) + _retained(sb)
            - base[pair_a, None] - base[pair_b, None])


def _apply_swap(m, perm, i, j):
    m[:, [i, j]] = m[:, [j, i]]
    perm[[i, j]] = perm[[j, i]]


def _greedy_with_escape(m, perm, max_rounds, escape_attempts):
    """Greedy swap descent; on convergence, force the least-bad swap and
    keep going (channel_swap.py:148-155's jiggle).  Tracks and restores
    the best state seen, so escapes can only help."""
    rows, cols = m.shape
    n_stripes = cols // 4
    pair_a, pair_b = np.triu_indices(n_stripes, k=1)
    ci, cj = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    ci, cj = ci.ravel(), cj.ravel()

    best_perm = perm.copy()
    best_score = _retained(np.abs(m).reshape(rows, n_stripes, 4)
                           .transpose(1, 0, 2)).sum()
    used_escapes = 0
    for _ in range(max_rounds):
        gains = _swap_gains(m, pair_a, pair_b, ci, cj)
        order = np.argsort(gains.ravel())[::-1]
        best_gain = gains.ravel()[order[0]]
        if best_gain <= 1e-6:
            if used_escapes >= escape_attempts:
                break
            # converged: jiggle out with the (used_escapes+1)-th best
            # (non-improving) swap, deterministically
            used_escapes += 1
            flat = int(order[min(used_escapes, order.size - 1)])
        else:
            flat = int(order[0])
        p_idx, combo = divmod(flat, 16)
        _apply_swap(m, perm, pair_a[p_idx] * 4 + ci[combo],
                    pair_b[p_idx] * 4 + cj[combo])
        score = _retained(np.abs(m).reshape(rows, n_stripes, 4)
                          .transpose(1, 0, 2)).sum()
        if score > best_score + 1e-6:
            best_score, best_perm = score, perm.copy()
    return best_perm, best_score


def _exhaustive_pairs(m, perm, max_rounds):
    """Bounded exhaustive regrouping (exhaustive_search.py, window=2):
    repeatedly apply the best of the 35 unique bipartitions over every
    stripe pair until none improves."""
    rows, cols = m.shape
    n_stripes = cols // 4
    if n_stripes < 2:
        return perm
    pair_a, pair_b = np.triu_indices(n_stripes, k=1)
    for _ in range(max_rounds):
        stripes = np.abs(m).reshape(rows, n_stripes, 4).transpose(1, 0, 2)
        base = _retained(stripes)
        cols8 = np.concatenate([stripes[pair_a], stripes[pair_b]], axis=-1)
        # [P, rows, 35, 8] -> two [P, 35, rows, 4] group views
        cand = cols8[:, :, _PAIR_COMBOS]          # [P, rows, 35, 8]
        ga = cand[..., :4].transpose(0, 2, 1, 3)
        gb = cand[..., 4:].transpose(0, 2, 1, 3)
        gains = (_retained(ga) + _retained(gb)
                 - base[pair_a, None] - base[pair_b, None])  # [P, 35]
        flat = int(np.argmax(gains))
        if gains.ravel()[flat] <= 1e-6:
            break
        p_idx, combo = divmod(flat, 35)
        a, b = pair_a[p_idx], pair_b[p_idx]
        idx8 = np.concatenate([a * 4 + np.arange(4), b * 4 + np.arange(4)])
        new8 = idx8[_PAIR_COMBOS[combo]]
        m[:, idx8] = m[:, new8]
        perm[idx8] = perm[new8]
    return perm


def accelerated_search_for_good_permutation(
        matrix, options: Optional[dict] = None
) -> np.ndarray:
    """Channel-permutation search (channel_swap.py:177-200 +
    exhaustive_search.py strategies).

    Returns a permutation ``perm`` of the input channels such that
    ``matrix[:, perm]`` retains at least as much magnitude under 2:4
    pruning as ``matrix``; identity when nothing helps.  Deterministic.

    options:
      max_rounds (1000)      — per-phase iteration cap.
      escape_attempts (10)   — forced non-improving swaps after greedy
                               convergence (0 = plain greedy descent).
      exhaustive_window (2)  — 0 disables the exhaustive phase; 2 runs the
                               35-bipartition stripe-pair regrouping.
    """
    options = options or {}
    max_rounds = int(options.get("max_rounds", 1000))
    escape_attempts = int(options.get("escape_attempts", 10))
    window = int(options.get("exhaustive_window", 2))
    src = np.asarray(matrix)
    m = np.array(src.astype(np.float32).reshape(-1, src.shape[-1]), copy=True)
    rows, cols = m.shape
    if cols % 4:
        raise ValueError(f"columns ({cols}) must be a multiple of 4")
    n_stripes = cols // 4
    perm = np.arange(cols)
    if n_stripes < 2:
        return perm

    perm, _ = _greedy_with_escape(m, perm, max_rounds, escape_attempts)
    # re-derive m from the best perm (escape may have left m off-best)
    m = np.array(src.astype(np.float32).reshape(rows, cols)[:, perm])
    if window >= 2:
        perm = _exhaustive_pairs(m, perm, max_rounds)
        # a regroup can open new single-swap wins; one cheap final descent
        perm, _ = _greedy_with_escape(
            np.array(src.astype(np.float32).reshape(rows, cols)[:, perm]),
            perm, max_rounds, 0)
    return perm


def apply_permutation(matrix, perm, axis: int = -1):
    """Reorder channels; the producing layer applies the inverse on its
    output dimension so the network function is unchanged."""
    return np.take(np.asarray(matrix), perm, axis=axis)


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv
