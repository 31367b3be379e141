"""Process-local metrics: a thread-safe Counter/Gauge/Histogram registry.

The answer to "what is my p99 step time, queue depth, or TTFT *right
now*" must not require grepping JSON log lines.  Production LLM systems
(vLLM's Prometheus ``/metrics``; Megatron-LM's built-in timers — see
PAPERS.md) treat the metrics registry as a first-class subsystem; this
is the apex_tpu_torch equivalent, deliberately dependency-free:

- **Three instrument kinds.**  :class:`Counter` (monotonically
  increasing totals — requests, retries, skips), :class:`Gauge` (a
  value that goes both ways — queue depth, slot occupancy; optionally
  bound to a callable evaluated at export time, for ages and cache
  stats), :class:`Histogram` (latency distributions over **fixed
  log-spaced buckets**, so percentile queries never depend on when the
  process started sampling).
- **Labeled series.**  Every instrument may declare ``labelnames``; one
  instrument then holds one series per distinct label-value tuple
  (``apex_events_total{event="retry_attempt"}``).
- **Bounded scope labels.**  An instrument may additionally declare
  ``scope_labels`` — labels that are *optional per update* (absent ⇒
  the plain series, byte-identical to an instrument that never heard
  of the scope; present ⇒ an attributed series such as
  ``{replica="r0"}``).  A scope label may only take values while a
  cardinality bound is declared (:meth:`MetricsRegistry.declare_scope`
  — the fleet router declares its fleet size), so per-replica
  attribution can never explode a process's series count.
- **Exporters, not a server.**  :meth:`MetricsRegistry.prometheus_text`
  renders the Prometheus text exposition format (serve it from any
  HTTP handler, or dump it to a file for a node-exporter textfile
  collector); :meth:`MetricsRegistry.write_json` atomically writes a
  JSON snapshot for tooling that speaks JSON.  Nothing runs unless
  called — with no exporter attached the only cost per update is one
  lock + one dict write (measured by ``bench.py``'s ``obs`` block).
- **Naming is linted.**  Metric names must match ``^apex_[a-z0-9_]+$``
  (enforced here at registration AND statically by
  ``tools/check_metrics.py``); counters end in ``_total``, histograms
  carry a unit suffix (``_seconds`` / ``_bytes`` / ``_tokens``).  The
  conventions and the full metric inventory live in
  ``docs/api/observability.md``.

Updates are thread-safe (the supervisor's watchdog monitor thread and
the serving host loop write concurrently); reads (:func:`snapshot`,
exposition) take a point-in-time copy and never block writers for long.
"""

from __future__ import annotations

import re
import threading
import time
from bisect import bisect_left
from typing import (Callable, Dict, Iterable, Mapping, Optional, Sequence,
                    Tuple)

__all__ = [
    "LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "declare_scope",
    "gauge",
    "histogram",
    "prometheus_text",
    "reset",
    "snapshot",
    "write_json",
]

_NAME_RE = re.compile(r"^apex_[a-z0-9_]+$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# Fixed log-spaced latency buckets: 4 per decade, 100 µs .. 100 s (25
# edges + the implicit +Inf).  Fixed-by-construction so two processes —
# or two rounds of the same benchmark — always aggregate bucket-to-bucket.
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(
    round(10.0 ** (exp / 4.0), 10) for exp in range(-16, 9))


def _check_labels(labelnames: Sequence[str]) -> Tuple[str, ...]:
    names = tuple(labelnames)
    for n in names:
        if not _LABEL_RE.match(n):
            raise ValueError(f"invalid label name {n!r} "
                             f"(must match {_LABEL_RE.pattern})")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate label names in {names}")
    return names


def _fmt(value: float) -> str:
    """Prometheus sample-value formatting: integral floats render without
    the trailing ``.0`` (matches what prometheus clients emit)."""
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 2 ** 53:
        return str(int(value))
    return repr(float(value))


def _escape(value: str) -> str:
    """Label-VALUE escaping: backslash, line feed, and double quote."""
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(value: str) -> str:
    """HELP-line escaping: the text format defines only backslash and
    line feed here — escaping quotes too would emit a sequence strict
    (OpenMetrics) parsers reject."""
    return value.replace("\\", r"\\").replace("\n", r"\n")


class _Metric:
    """Common machinery: name validation, labeled series, one lock.

    Series keys are canonical sorted ``(labelname, labelvalue)`` pair
    tuples, so one instrument can hold both its plain series (scope
    labels absent — exactly the pre-scope byte layout) and attributed
    ``{replica=...}`` series side by side.
    """

    kind = "untyped"
    _registry: Optional["MetricsRegistry"] = None

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 scope_labels: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {_NAME_RE.pattern} "
                f"(see docs/api/observability.md naming conventions)")
        self.name = name
        self.help = help
        self.labelnames = _check_labels(labelnames)
        self.scope_labels = _check_labels(scope_labels)
        overlap = set(self.labelnames) & set(self.scope_labels)
        if overlap:
            raise ValueError(
                f"{name}: {sorted(overlap)} declared as both labelnames "
                f"and scope_labels — a label is required or optional, "
                f"never both")
        self._lock = threading.Lock()
        self._series: Dict[Tuple, object] = {}

    def _key(self, labels: Mapping[str, object]) -> Tuple:
        base = self.labelnames
        if not self.scope_labels:
            if tuple(sorted(labels)) != tuple(sorted(base)):
                raise ValueError(
                    f"{self.name}: got labels {sorted(labels)}, declared "
                    f"labelnames {sorted(base)}")
        else:
            extras = [k for k in labels if k not in base]
            if (sorted(k for k in labels if k in base) != sorted(base)
                    or any(k not in self.scope_labels for k in extras)):
                raise ValueError(
                    f"{self.name}: got labels {sorted(labels)}, declared "
                    f"labelnames {sorted(base)} (+ optional scope labels "
                    f"{sorted(self.scope_labels)})")
            if extras:
                key = tuple(sorted((k, str(v))
                                   for k, v in labels.items()))
                # bound enforcement is an O(series) scan — only a key
                # the metric has never seen can add a new scope value,
                # so the established hot path skips it entirely (racy
                # membership read is benign: both racers just enforce)
                if key not in self._series:
                    self._enforce_scope_bound(labels, extras)
                return key
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def _enforce_scope_bound(self, labels: Mapping[str, object],
                             extras: Sequence[str]) -> None:
        """A scope label may only grow a new series value while its
        declared cardinality bound allows it — the mechanism exists so
        per-replica attribution stays bounded by fleet size, never
        open-ended like a rid or a user string."""
        reg = self._registry
        for k in extras:
            bound = reg.scope_bound(k) if reg is not None else None
            if bound is None:
                raise ValueError(
                    f"{self.name}: scope label {k!r} has no declared "
                    f"cardinality bound — declare_scope({k!r}, n) first "
                    f"(the fleet router and named schedulers do this at "
                    f"construction)")
            value = str(labels[k])
            with self._lock:
                seen = {dict(key).get(k) for key in self._series}
            seen.discard(None)
            if value not in seen and len(seen) >= bound:
                raise ValueError(
                    f"{self.name}: scope label {k!r}={value!r} would "
                    f"exceed its declared cardinality bound {bound} "
                    f"(values already present: {sorted(seen)})")

    def _label_order(self, key: Tuple) -> list:
        """Render order for one series key: declared labelnames first,
        then any scope labels present — so pre-scope output is
        byte-identical and attributed series read naturally."""
        present = dict(key)
        return [n for n in (*self.labelnames, *self.scope_labels)
                if n in present]

    def _signature(self):
        return (type(self), self.labelnames, self.scope_labels)

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def _collect(self):
        """``[(label_pairs, value), ...]`` point-in-time copy, sorted
        for deterministic export."""
        with self._lock:
            return sorted(self._series.items())

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonically increasing total.  ``inc`` only; negative deltas
    raise (a counter that can go down lies to every rate() query)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        # finite AND >= 0: one NaN or +Inf increment would poison the
        # running total irreversibly and break every rate() query for
        # the life of the process
        if not 0 <= amount < float("inf"):
            raise ValueError(f"{self.name}: counter increment must be "
                             f"finite and >= 0, got {amount}")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Gauge(_Metric):
    """A value that goes both ways (queue depth, occupancy, ages).

    ``set_function(fn)`` binds a callable evaluated at *export* time —
    the idiom for values whose truth lives elsewhere (heartbeat age,
    cache utilization): the scrape reads the current state instead of
    the last pushed sample.  A bound function shadows any pushed value
    for that label set; binding ``None`` unbinds.
    """

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 scope_labels: Sequence[str] = ()):
        super().__init__(name, help, labelnames, scope_labels)
        self._functions: Dict[Tuple, Callable[[], float]] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn: Optional[Callable[[], float]],
                     **labels) -> None:
        key = self._key(labels)
        with self._lock:
            if fn is None:
                self._functions.pop(key, None)
            else:
                self._functions[key] = fn

    def bound_function(self, **labels) -> Optional[Callable[[], float]]:
        """The currently bound provider (None when unbound) — lets an
        owner unbind only if a newer owner has not replaced it."""
        key = self._key(labels)
        with self._lock:
            return self._functions.get(key)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            fn = self._functions.get(key)
        if fn is not None:
            return float(fn())
        with self._lock:
            return float(self._series.get(key, 0.0))

    def _collect(self):
        with self._lock:
            out = dict(self._series)
            fns = list(self._functions.items())
        for key, fn in fns:
            try:
                out[key] = float(fn())
            except Exception as e:  # a dead provider must not kill export
                import logging

                logging.getLogger("apex_tpu_torch.obs").debug(
                    "gauge %s function failed: %s: %s", self.name,
                    type(e).__name__, e)
                out[key] = float("nan")
        return sorted(out.items())

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()
            # bound functions survive reset(): they describe live state,
            # not accumulated history


class Histogram(_Metric):
    """Fixed-bucket latency/size distribution.

    Buckets are *upper-inclusive* edges (Prometheus ``le`` semantics);
    an implicit ``+Inf`` bucket catches everything past the last edge.
    Per-series state is ``(per-bucket counts, sum, count)``; exposition
    renders the cumulative form.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_S,
                 scope_labels: Sequence[str] = ()):
        super().__init__(name, help, labelnames, scope_labels)
        if "le" in self.labelnames or "le" in self.scope_labels:
            # the exposition adds its own le= per bucket; a user 'le'
            # label would emit duplicate labels and fail the scrape
            raise ValueError(
                f"{name}: label name 'le' is reserved for histograms")
        edges = tuple(float(b) for b in buckets)
        if not edges:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        if any(b >= a for b, a in zip(edges, edges[1:])):
            raise ValueError(f"{name}: bucket edges must be strictly "
                             f"increasing, got {edges}")
        self.buckets = edges

    def _signature(self):
        return (type(self), self.labelnames, self.scope_labels,
                self.buckets)

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        # NaN has no bucket, and either infinity poisons the running
        # sum permanently — a histogram records measurements, and a
        # non-finite "measurement" is a caller bug worth raising on
        if not -float("inf") < value < float("inf"):
            raise ValueError(
                f"{self.name}: cannot observe non-finite value {value}")
        key = self._key(labels)
        idx = bisect_left(self.buckets, float(value))
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            state["counts"][idx] += 1
            state["sum"] += float(value)
            state["count"] += 1

    def _state(self, **labels) -> dict:
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                return {"counts": [0] * (len(self.buckets) + 1),
                        "sum": 0.0, "count": 0}
            return {"counts": list(state["counts"]),
                    "sum": state["sum"], "count": state["count"]}

    def count(self, **labels) -> int:
        return self._state(**labels)["count"]

    def sum(self, **labels) -> float:
        return self._state(**labels)["sum"]

    def cumulative_counts(self, **labels) -> Tuple[int, ...]:
        """Per-bucket cumulative counts (``le`` semantics), +Inf last."""
        counts = self._state(**labels)["counts"]
        out, running = [], 0
        for c in counts:
            running += c
            out.append(running)
        return tuple(out)

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate (Prometheus
        ``histogram_quantile`` semantics, computed in-process).

        The target rank ``q * count`` is located in the cumulative
        bucket counts and linearly interpolated between the bucket's
        edges (the first bucket's lower edge is taken as 0 when its
        upper edge is positive; a rank landing in the implicit ``+Inf``
        bucket clamps to the largest finite edge).  **Exact at bucket
        edges**: when the rank coincides with a cumulative count the
        estimate is exactly that bucket's upper edge — so a quantile
        backed by samples observed *at* edges reproduces them exactly.

        Error bound: the true sample quantile lies in the same bucket
        as the estimate, i.e. within one bucket width ``(lo, hi]`` —
        for the default log-spaced :data:`LATENCY_BUCKETS_S` (4/decade)
        that is a ≤ 78% relative band (``10^(1/4) ≈ 1.78``).  Use
        exact per-request samples (:mod:`apex_tpu_torch.obs.slo`) when
        tighter truth is needed; this estimate is the scrape-side
        cross-check.

        ``q`` must be a finite value in [0, 1] (the same guard family
        as :meth:`observe`); an empty series returns NaN.
        """
        if not 0 <= q <= 1:              # False for NaN too
            raise ValueError(
                f"{self.name}: quantile must be in [0, 1], got {q}")
        state = self._state(**labels)
        count = state["count"]
        if count == 0:
            return float("nan")
        counts = state["counts"]
        edges = self.buckets

        def lower_edge(i: int) -> float:
            if i > 0:
                return edges[i - 1]
            return 0.0 if edges[0] > 0 else edges[0]

        target = q * count
        if target <= 0:
            # q == 0: the lower edge of the first populated bucket
            for i, c in enumerate(counts):
                if c > 0:
                    return (edges[-1] if i == len(edges)
                            else float(lower_edge(i)))
        running = 0
        for i, c in enumerate(counts[:-1]):
            running += c
            if running >= target:
                # smallest bucket whose cumulative count reaches the
                # rank; c > 0 here by construction
                lo, hi = lower_edge(i), edges[i]
                frac = (target - (running - c)) / c
                return float(lo + (hi - lo) * frac)
        # rank lives in the +Inf bucket: clamp to the largest finite
        # edge (the Prometheus convention — the estimate cannot invent
        # an upper bound the buckets never recorded)
        return float(edges[-1])

    def _collect(self):
        with self._lock:
            return sorted(
                (key, {"counts": list(st["counts"]), "sum": st["sum"],
                       "count": st["count"]})
                for key, st in self._series.items())


class MetricsRegistry:
    """Get-or-create registry keyed by metric name.

    Re-registering a name with the same kind/labelnames/buckets returns
    the existing instrument (the idiom for "declared once at module
    level, imported everywhere"); a *conflicting* re-registration
    raises — two definitions of one name would silently split a series.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._scope_bounds: Dict[str, int] = {}

    # -- registration ------------------------------------------------------

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                candidate = cls(name, help, labelnames, **kw)
                if got._signature() != candidate._signature():
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(got).__name__}{got.labelnames} — "
                        f"conflicting re-registration as "
                        f"{cls.__name__}{candidate.labelnames}")
                return got
            metric = cls(name, help, labelnames, **kw)
            metric._registry = self
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                scope_labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames,
                              scope_labels=scope_labels)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              scope_labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames,
                              scope_labels=scope_labels)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  scope_labels: Sequence[str] = ()) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets, scope_labels=scope_labels)

    def declare_scope(self, label: str, bound: int) -> int:
        """Declare (or widen) the cardinality bound for a scope label.

        Bounds only ever widen — ``max(existing, bound)`` — so two
        independent declarers (a fleet router sizing ``replica`` to its
        fleet, a named standalone scheduler declaring 1) compose instead
        of fighting.  Returns the effective bound."""
        if not _LABEL_RE.match(label):
            raise ValueError(f"invalid scope label {label!r} "
                             f"(must match {_LABEL_RE.pattern})")
        bound = int(bound)
        if bound < 1:
            raise ValueError(
                f"scope label {label!r}: bound must be >= 1, got {bound}")
        with self._lock:
            bound = max(self._scope_bounds.get(label, 0), bound)
            self._scope_bounds[label] = bound
            return bound

    def scope_bound(self, label: str) -> Optional[int]:
        """The declared cardinality bound for ``label`` (None when the
        label has never been declared)."""
        with self._lock:
            return self._scope_bounds.get(label)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._metrics))

    def reset(self) -> None:
        """Zero every series (registrations and gauge functions survive
        — tests zero between runs without re-wiring call sites)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    # -- export ------------------------------------------------------------

    def snapshot(self, names: Optional[Iterable[str]] = None
                 ) -> Dict[str, dict]:
        """Point-in-time ``{name: {type, help, labelnames, series}}``.

        Series are ``[{labels: {...}, ...value fields...}]``; histograms
        carry ``buckets`` (edges), cumulative ``bucket_counts``, ``sum``
        and ``count`` per series.  This is the read tests assert against.
        ``names=`` restricts the walk to the listed metrics (unknown
        names are simply absent) — per-step readers like the alert
        engine pay for the series they evaluate, not the whole registry.
        """
        with self._lock:
            metrics = sorted(self._metrics.items())
        if names is not None:
            want = set(names)
            metrics = [(n, m) for n, m in metrics if n in want]
        out: Dict[str, dict] = {}
        for name, m in metrics:
            entry = {"type": m.kind, "help": m.help,
                     "labelnames": list(m.labelnames), "series": []}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            for key, value in m._collect():
                kv = dict(key)
                labels = {n: kv[n] for n in m._label_order(key)}
                if isinstance(m, Histogram):
                    cum, running = [], 0
                    for c in value["counts"]:
                        running += c
                        cum.append(running)
                    entry["series"].append(
                        {"labels": labels, "bucket_counts": cum,
                         "sum": value["sum"], "count": value["count"]})
                else:
                    entry["series"].append(
                        {"labels": labels, "value": value})
            out[name] = entry
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4), deterministically
        ordered (names, then label tuples) so goldens are stable."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, value in m._collect():
                kv = dict(key)
                pairs = ",".join(
                    f'{ln}="{_escape(kv[ln])}"'
                    for ln in m._label_order(key))
                if isinstance(m, Histogram):
                    running = 0
                    for edge, c in zip(m.buckets, value["counts"]):
                        running += c
                        le = ((pairs + ",") if pairs else "") \
                            + f'le="{_fmt(edge)}"'
                        lines.append(
                            f"{name}_bucket{{{le}}} {running}")
                    running += value["counts"][-1]
                    le = ((pairs + ",") if pairs else "") + 'le="+Inf"'
                    lines.append(f"{name}_bucket{{{le}}} {running}")
                    suffix = f"{{{pairs}}}" if pairs else ""
                    lines.append(
                        f"{name}_sum{suffix} {_fmt(value['sum'])}")
                    lines.append(f"{name}_count{suffix} {value['count']}")
                else:
                    suffix = f"{{{pairs}}}" if pairs else ""
                    lines.append(f"{name}{suffix} {_fmt(float(value))}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_json(self, path: str) -> dict:
        """Atomically write (temp + ``os.replace``) a JSON snapshot; the
        payload carries a wall-clock stamp for cross-host correlation.
        Non-finite values (a failed gauge provider exports NaN) are
        mapped to ``null`` so the file stays valid for strict parsers —
        ``allow_nan=False`` makes that a hard guarantee, not a hope."""
        from apex_tpu_torch.utils.serialization import (
            atomic_write_json,
            json_finite,
        )

        payload = {"time": time.time(),
                   "metrics": json_finite(self.snapshot())}
        atomic_write_json(path, payload, sort_keys=True, allow_nan=False)
        return payload


#: The process-default registry every apex_tpu_torch subsystem registers into.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = (),
            scope_labels: Sequence[str] = ()) -> Counter:
    """Get-or-create a :class:`Counter` in the default registry."""
    return REGISTRY.counter(name, help, labelnames, scope_labels)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = (),
          scope_labels: Sequence[str] = ()) -> Gauge:
    """Get-or-create a :class:`Gauge` in the default registry."""
    return REGISTRY.gauge(name, help, labelnames, scope_labels)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS_S,
              scope_labels: Sequence[str] = ()) -> Histogram:
    """Get-or-create a :class:`Histogram` in the default registry."""
    return REGISTRY.histogram(name, help, labelnames, buckets,
                              scope_labels)


def declare_scope(label: str, bound: int) -> int:
    """Default-registry :meth:`MetricsRegistry.declare_scope`."""
    return REGISTRY.declare_scope(label, bound)


def snapshot() -> Dict[str, dict]:
    """Default-registry :meth:`MetricsRegistry.snapshot`."""
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    """Default-registry :meth:`MetricsRegistry.prometheus_text`."""
    return REGISTRY.prometheus_text()


def write_json(path: str) -> dict:
    """Default-registry :meth:`MetricsRegistry.write_json`."""
    return REGISTRY.write_json(path)


def reset() -> None:
    """Default-registry :meth:`MetricsRegistry.reset`."""
    REGISTRY.reset()
