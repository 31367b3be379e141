"""Prompt-lookup drafting for exact-greedy speculative decoding.

Counterpart of ``apex_tpu/serving/draft.py``, copied whole (pure host
logic over Python ints).

Plain decode pays one full weight read per token per step.  Speculative
decoding amortizes that read over several tokens: a *drafter* proposes k
candidate tokens, one **verify** forward scores all k+1 positions through
the chunked-prefill path
(:meth:`~apex_tpu_torch.serving.engine.DecodeEngine.verify_draft`), and
the scheduler accepts the longest prefix where the target model's greedy
argmax agrees with the draft.  Acceptance compares the target's own
argmax against the draft, and a rejected position rolls the slot back
before its rows are ever readable, so the emitted stream is the one
plain decode would emit from the same logits.  On the card a verify row
is a product of ``bucket + 1`` rows where a decode row is one of
``slots``: cuBLAS picks its algorithm by the row count, so a verify row
may round differently from the decode row at the same depth, and a
speculative stream may part from the plain one at a near tie
(``chip_smoke.py`` holds it with ``compare_streams``).

The drafter is **prompt lookup** (n-gram suffix matching over the
request's own prompt + generated history): no draft model, no device
cost, no extra weights.  It pays off where decode traffic repeats
itself (summarization, code edit, RAG with quoted context) and degrades
to a no-op (empty proposal: the slot rides the plain batched decode
step) on incompressible token streams, so the worst case pays only a
host-side list scan.

``adapt_k`` is the accept/fall-back policy: full acceptance doubles the
next draft length (up to ``max_draft``), anything less halves it (down
to ``min_draft``).  Sampled (``temperature > 0``) requests never enter
this module: the scheduler bypasses drafting for them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

__all__ = ["SpeculationConfig", "adapt_k", "propose"]


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """Knobs for the prompt-lookup speculative path.

    ``max_draft`` is the widest draft the scheduler will ever propose
    (the verify bucket table must cover it — see
    ``DecodeEngine(draft_buckets=...)``); ``min_draft`` the floor the
    adaptive controller shrinks to.  ``ngram_max``/``ngram_min`` bound
    the suffix length the lookup tries (longest first — a longer
    matched suffix is stronger evidence the continuation repeats).
    ``adaptive=False`` pins the draft length at ``max_draft``.
    """

    max_draft: int = 8
    min_draft: int = 1
    ngram_max: int = 4
    ngram_min: int = 1
    adaptive: bool = True

    def __post_init__(self):
        if self.min_draft < 1:
            raise ValueError(f"min_draft must be >= 1, got {self.min_draft}")
        if self.max_draft < self.min_draft:
            raise ValueError(f"max_draft {self.max_draft} < min_draft "
                             f"{self.min_draft}")
        if self.ngram_min < 1:
            raise ValueError(f"ngram_min must be >= 1, got {self.ngram_min}")
        if self.ngram_max < self.ngram_min:
            raise ValueError(f"ngram_max {self.ngram_max} < ngram_min "
                             f"{self.ngram_min}")


def propose(history: Sequence[int], k: int, *, ngram_max: int = 4,
            ngram_min: int = 1) -> List[int]:
    """Draft up to ``k`` tokens by longest-suffix n-gram lookup.

    Tries suffix lengths ``ngram_max`` down to ``ngram_min``; for the
    longest suffix of ``history`` that re-occurs earlier, returns the
    (up to ``k``) tokens that followed an earlier occurrence — the
    continuation the stream itself predicts.  Among occurrences it
    prefers the **most recent one with a full k-token continuation**
    (on a periodic tail — the classic greedy collapse — the very
    latest occurrence sits so close to the end that only a sliver
    follows it; a slightly older one yields the whole draft), falling
    back to whichever match has the longest continuation.  Returns
    ``[]`` when nothing matches (the caller falls back to plain
    decode: an unpredictable stream costs one host-side scan, zero
    device work).  Pure host logic over Python ints;
    O(ngram·len(history)) worst case, trivial next to a decode
    dispatch.
    """
    h = [int(t) for t in history]
    n_hist = len(h)
    if k < 1 or n_hist < ngram_min + 1:
        return []
    for n in range(min(ngram_max, n_hist - 1), ngram_min - 1, -1):
        suffix = h[n_hist - n:]
        best = None          # lowest-j partial match == longest draft
        # scan most-recent-first (start strictly before the suffix
        # itself, so a match always has a continuation)
        for j in range(n_hist - n - 1, -1, -1):
            if h[j:j + n] != suffix:
                continue
            if j + n + k <= n_hist:
                return h[j + n:j + n + k]
            if best is None or j < best:
                best = j
        if best is not None:
            return h[best + n:best + n + k]
    return []


def adapt_k(k: int, drafted: int, accepted: int,
            config: SpeculationConfig) -> int:
    """Next draft length after a verify that accepted ``accepted`` of
    ``drafted`` proposed tokens.

    Full acceptance doubles ``k`` (capped at ``max_draft``); any
    rejection halves it (floored at ``min_draft``).  Multiplicative so
    both directions converge in O(log max_draft) verifies, and a
    deterministic function of the acceptance record only — replays
    reproduce the exact dispatch sequence.  With ``adaptive=False`` the
    draft length pins at ``max_draft``.
    """
    if not config.adaptive:
        return config.max_draft
    if drafted > 0 and accepted >= drafted:
        return min(2 * k, config.max_draft)
    return max(config.min_draft, k // 2)
