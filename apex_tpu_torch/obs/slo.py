"""SLO percentile reports over per-request serving samples.

Serving systems are graded in percentiles, not means: the Gemma-on-TPU
serving comparison and the MLPerf-on-TPU-pods methodology (PAPERS.md)
both state results as p50/p95/p99 TTFT / TPOT at a controlled offered
load, plus goodput under overload.  This module computes exactly those
numbers from the **exact per-request samples** a
:class:`~apex_tpu_torch.obs.request_trace.RequestTraceRecorder` assembled —
no bucketing error — and can cross-check them against the
bucket-interpolated estimates of the live Prometheus histograms
(:meth:`~apex_tpu_torch.obs.metrics.Histogram.quantile`), so the in-process
dashboards and the offline reports provably tell one story.

Definitions (the serving-literature conventions, pinned here so every
later scheduling-policy PR is graded identically):

- **TTFT** — submit → first token (queue wait + prefill), per request.
- **TPOT** — decode seconds per generated token past the first
  (``decode_s / (new_tokens - 1)``), per request; undefined for
  one-token requests (excluded from the distribution, counted in
  ``n``'s shortfall rather than faked as 0).
- **Queue wait** — submit → slot admission.
- **Goodput** — requests completing within their deadline / requests
  *offered* (shed and still-running requests count against it; a
  workload with no deadlines has goodput ``None``, not 1.0).

Percentiles are **nearest-rank** (`p = sorted[ceil(q·n) − 1]`): an
actual sample, deterministic, exact at every rank — the convention
MLPerf loadgen reports.  :meth:`SLOReport.to_dict` renders a stable,
rounded, JSON-ready dict for bench blocks and offline diffing
(``tools/bench_compare.py``).
"""

from __future__ import annotations

import dataclasses
import math
from bisect import bisect_left
from typing import Dict, List, Mapping, Optional, Sequence

from apex_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "SLOReport",
    "build_report",
    "crosscheck_quantiles",
    "percentile",
    "summarize",
]

#: the quantiles every report states (the literature's set)
REPORT_QUANTILES = (0.5, 0.95, 0.99)


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``samples``: the smallest sample x
    with ``CDF(x) >= q`` (``sorted[ceil(q*n) - 1]``; ``q=0`` → min).
    Deterministic, always an actual sample; NaN for an empty list.
    ``q`` must be a finite value in [0, 1]."""
    if not 0 <= q <= 1:                  # False for NaN too
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    if not samples:
        return float("nan")
    ordered = sorted(samples)
    rank = max(math.ceil(q * len(ordered)), 1)
    return float(ordered[rank - 1])


def summarize(samples: Sequence[float],
              quantiles: Sequence[float] = REPORT_QUANTILES) -> dict:
    """``{"n", "mean", "min", "max", "p50", "p95", "p99"}`` over exact
    samples (NaN statistics for an empty list — a report over a run
    that produced no samples must still render)."""
    out = {"n": len(samples)}
    if samples:
        out["mean"] = float(sum(samples) / len(samples))
        out["min"] = float(min(samples))
        out["max"] = float(max(samples))
    else:
        out["mean"] = out["min"] = out["max"] = float("nan")
    for q in quantiles:
        out[f"p{round(q * 100):d}"] = percentile(samples, q)
    return out


def crosscheck_quantiles(samples: Sequence[float],
                         histogram: "obs_metrics.Histogram",
                         quantiles: Sequence[float] = REPORT_QUANTILES,
                         **labels) -> dict:
    """Exact-vs-bucket-interpolated agreement for one series.

    For each quantile: the exact nearest-rank sample, the histogram's
    :meth:`~apex_tpu_torch.obs.metrics.Histogram.quantile` estimate, and
    ``agree`` — whether both land in the same bucket (the strongest
    claim bucket interpolation supports; see its documented error
    bound).  ``aligned`` reports whether the histogram's sample count
    matches ``len(samples)`` — agreement is only *meaningful* when the
    histogram observed exactly these samples (reset the registry before
    an isolated run)."""
    edges = histogram.buckets
    count = histogram.count(**labels)

    def bucket_of(v: float) -> int:
        return bisect_left(edges, v)

    checks = {}
    for q in quantiles:
        exact = percentile(samples, q)
        estimate = histogram.quantile(q, **labels)
        if math.isnan(exact) or math.isnan(estimate):
            agree = False
        else:
            bi_exact, bi_est = bucket_of(exact), bucket_of(estimate)
            # an overflow-bucket quantile is clamped to the last finite
            # edge by design — that IS agreement for an overflow sample
            agree = (bi_exact == bi_est
                     or (bi_exact == len(edges)
                         and estimate == edges[-1]))
        checks[f"p{round(q * 100):d}"] = {
            "exact": exact, "estimate": estimate, "agree": agree}
    return {"aligned": count == len(samples),
            "histogram_count": count, "sample_count": len(samples),
            "quantiles": checks}


@dataclasses.dataclass(frozen=True)
class SLOReport:
    """One run's SLO summary (build via :func:`build_report`)."""

    offered: int
    completed: int
    incomplete: int                  # offered - completed (shed + open)
    duration_s: Optional[float]
    throughput_rps: Optional[float]
    output_tokens: int
    tokens_per_s: Optional[float]
    ttft: dict
    tpot: dict
    queue_wait: dict
    total: dict
    goodput: Optional[float]
    deadline_misses: int
    crosscheck: Optional[dict] = None

    def to_dict(self, ndigits: int = 6) -> dict:
        """Deterministic JSON-ready dict, floats rounded to
        ``ndigits`` (stable across runs of the same virtual-clock
        workload; NaN survives for empty distributions and is mapped to
        null by the atomic JSON writers)."""
        def r(v):
            if isinstance(v, bool) or v is None:
                return v
            if isinstance(v, float):
                return round(v, ndigits) if math.isfinite(v) else v
            if isinstance(v, dict):
                return {k: r(x) for k, x in v.items()}
            return v

        return {
            "offered": self.offered, "completed": self.completed,
            "incomplete": self.incomplete,
            "duration_s": r(self.duration_s),
            "throughput_rps": r(self.throughput_rps),
            "output_tokens": self.output_tokens,
            "tokens_per_s": r(self.tokens_per_s),
            "ttft_s": r(self.ttft), "tpot_s": r(self.tpot),
            "queue_wait_s": r(self.queue_wait),
            "total_s": r(self.total),
            "goodput": r(self.goodput),
            "deadline_misses": self.deadline_misses,
            "crosscheck": r(self.crosscheck),
        }


def build_report(records: Sequence, *,
                 offered: Optional[int] = None,
                 deadlines: Optional[Mapping[str, Optional[float]]] = None,
                 arrivals: Optional[Mapping[str, float]] = None,
                 duration_s: Optional[float] = None,
                 histograms: Optional[Mapping[str, object]] = None
                 ) -> SLOReport:
    """Fold completed :class:`~apex_tpu_torch.obs.request_trace.RequestRecord`
    samples into an :class:`SLOReport`.

    ``offered`` defaults to ``len(records)`` — pass the load
    generator's offered count so shed/unfinished requests weigh on
    goodput.  ``deadlines`` maps rid → completion deadline relative to
    *arrival* (``None`` entries = no deadline); pass ``arrivals``
    (rid → absolute arrival stamp on the recorder's clock, e.g.
    ``LoadgenResult.arrivals``) so a submit that lagged its arrival at
    a step boundary tightens the budget instead of extending it —
    without ``arrivals`` the deadline is measured from submission
    (``t_queued``).  ``histograms`` optionally maps
    ``{"ttft" | "queue_wait" | "tpot": Histogram}`` to attach a
    :func:`crosscheck_quantiles` block per series (meaningful when the
    histograms observed exactly this run — reset the registry first).

    Control-plane terminals: a record whose ``finish_reason`` is
    ``"cancelled"`` or ``"shed"`` never counts toward goodput (service
    was not delivered in full), though a cancelled-mid-decode record
    with every stamp still contributes its real TTFT/queue-wait
    samples — those latencies genuinely happened.
    """
    done = [st for st in records if st.complete]
    ttft = [st.ttft_s for st in done]
    queue_wait = [st.queue_wait_s for st in done]
    total = [st.total_s for st in done]
    tpot = [st.tpot_s for st in done
            if st.tpot_s is not None and st.new_tokens
            and st.new_tokens > 1]
    n_offered = len(records) if offered is None else int(offered)
    if n_offered < len(done):
        raise ValueError(f"offered={n_offered} < {len(done)} completed "
                         f"records — the denominator cannot undercount")
    output_tokens = sum(st.new_tokens or 0 for st in done)
    goodput: Optional[float] = None
    misses = 0
    if deadlines is not None and any(d is not None
                                     for d in deadlines.values()):
        by_rid = {st.rid: st for st in done}
        met = 0
        for rid, deadline in deadlines.items():
            st = by_rid.get(rid)
            if st is None:
                continue
            if st.finish_reason in ("cancelled", "shed"):
                # the record closed, but service was never delivered in
                # full — a cancelled stream that "finished" early must
                # not inflate goodput (mirrors the load generator's
                # SERVED_REASONS accounting)
                continue
            if deadline is None:
                met += 1
                continue
            if arrivals is not None and rid in arrivals:
                elapsed = st.t_finished - arrivals[rid]
            else:
                elapsed = st.total_s
            met += bool(elapsed <= deadline)
        goodput = met / max(n_offered, 1)
        misses = n_offered - met
    crosscheck = None
    if histograms:
        by_series = {"ttft": ttft, "queue_wait": queue_wait, "tpot": tpot}
        crosscheck = {}
        for name, hist in sorted(histograms.items()):
            if name not in by_series:
                raise ValueError(
                    f"unknown crosscheck series {name!r} (expected one "
                    f"of {sorted(by_series)})")
            crosscheck[name] = crosscheck_quantiles(by_series[name], hist)
    return SLOReport(
        offered=n_offered, completed=len(done),
        incomplete=n_offered - len(done),
        duration_s=duration_s,
        throughput_rps=(len(done) / duration_s
                        if duration_s else None),
        output_tokens=output_tokens,
        tokens_per_s=(output_tokens / duration_s
                      if duration_s else None),
        ttft=summarize(ttft), tpot=summarize(tpot),
        queue_wait=summarize(queue_wait), total=summarize(total),
        goodput=goodput, deadline_misses=misses,
        crosscheck=crosscheck)
