"""Per-request serving lifecycle traces, assembled from the event stream.

The serving scheduler already narrates every request's life as
structured ``emit_event`` lines — ``serving_request_queued`` /
``serving_request_admitted`` / ``serving_prefix_hit`` /
``serving_prefill_chunk`` / ``serving_first_token`` /
``serving_spec_verify`` / ``serving_request_finished`` — but events are
a flat stream, and SLO questions ("where did this request's p99 TTFT
go: queue wait, prefill, or decode?") need the *per-request* view.
:class:`RequestTraceRecorder` is an event **sink**
(:func:`apex_tpu_torch._logging.add_event_sink`, exactly like
:mod:`apex_tpu_torch.obs.bridge`) that folds the stream back into one
lifecycle record per request — **zero hot-path call-site churn**, and
with no recorder installed nothing runs at all (the sink does not
exist; the scheduler's event emission is byte-identical either way).

Each :class:`RequestRecord` carries:

- **Phase boundaries** on the recorder's clock (injectable; default
  ``time.monotonic`` — a virtual clock shared with the scheduler and
  load generator makes every duration deterministic in tests):
  ``t_queued`` → ``t_admitted`` → ``t_first`` → ``t_finished``, and the
  derived ``queue_wait_s`` / ``prefill_s`` / ``decode_s`` / ``total_s``.
  Durations are exact stamp differences; because the three phases and
  the total are computed from the *same four stamps*, their sum equals
  ``total_s`` up to float re-association (≤ 1 µs at any realistic run
  length — the recorder's stated rounding bound).
- **Annotations** matched from the event payloads: slot id, prompt /
  generated token counts, finish reason, per-chunk prefill records
  (bucket, tokens, offset, dispatch wall time), speculation accounting
  (verify dispatches, drafted/accepted/emitted totals), prefix-cache
  outcome (hit with saved tokens, or miss), paged zero-copy block
  aliasing, and the scheduler's own clock measurements (``ttft_s``,
  ``per_token_ms``, ``tokens_per_s``) for cross-checking.

Exports follow the :class:`~apex_tpu_torch.obs.trace.TraceRecorder`
conventions: bounded memory (``max_requests`` completed + open records;
overflow counted in :attr:`dropped`, surfaced in the exported
``otherData``, warned once), :meth:`to_chrome_trace` /
:meth:`export` produce Chrome/Perfetto trace-event JSON with **one
track per request** (a ``thread_name`` metadata row names the track
after the rid; phases and chunk/verify slices nest by containment),
and :meth:`export_jsonl` writes one JSON line per completed record for
offline analysis — both through the same atomic-write + non-finite
sanitizing machinery the metrics/trace exporters share.

:mod:`apex_tpu_torch.obs.slo` consumes :meth:`records` to build percentile
SLO reports; :mod:`apex_tpu_torch.serving.loadgen` drives the workloads worth
recording.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

from apex_tpu_torch import _logging
from apex_tpu_torch._logging import get_logger

__all__ = [
    "RequestRecord",
    "RequestTraceRecorder",
    "recording_requests",
]

logger = get_logger("obs.request_trace")

#: stated reconciliation bound: queue_wait_s + prefill_s + decode_s
#: differs from total_s only by float re-association of the same four
#: stamps — never more than this (tests assert against it).
PHASE_SUM_TOLERANCE_S = 1e-6


@dataclasses.dataclass
class RequestRecord:
    """One request's assembled lifecycle (all stamps on the recorder's
    clock; ``None`` for boundaries the recorder never saw — e.g. it was
    installed mid-flight)."""

    rid: str
    slot: Optional[int] = None
    prompt_tokens: Optional[int] = None
    new_tokens: Optional[int] = None
    finish_reason: Optional[str] = None
    # phase boundaries (recorder clock, absolute)
    t_queued: Optional[float] = None
    t_admitted: Optional[float] = None
    t_first: Optional[float] = None
    t_finished: Optional[float] = None
    # per-phase annotations
    chunks: List[dict] = dataclasses.field(default_factory=list)
    spec: Dict[str, int] = dataclasses.field(default_factory=dict)
    prefix: Optional[dict] = None      # {"hit": bool, ...} when caching on
    alias: Optional[dict] = None       # paged zero-copy block reuse
    # control-plane annotations (empty/zero without a policy)
    preemptions: int = 0               # lossless suspend/resume cycles
    preempts: List[dict] = dataclasses.field(default_factory=list)
    # fleet annotations (empty/None off a fleet router): the hop trail
    # — placed / failover / resumed / shed entries with the replica
    # names and recorder-clock stamps — and the replica the request
    # last landed on (its placement, updated by a mid-stream resume)
    hops: List[dict] = dataclasses.field(default_factory=list)
    replica: Optional[str] = None
    # the scheduler's own clock measurements (cross-check material)
    scheduler_ttft_s: Optional[float] = None
    scheduler_queue_wait_s: Optional[float] = None
    per_token_ms: Optional[float] = None
    tokens_per_s: Optional[float] = None

    # -- derived durations (exact stamp differences) -----------------------
    def _diff(self, a: Optional[float], b: Optional[float]
              ) -> Optional[float]:
        return (b - a) if a is not None and b is not None else None

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Submit → slot admission."""
        return self._diff(self.t_queued, self.t_admitted)

    @property
    def prefill_s(self) -> Optional[float]:
        """Admission → first token (prefix restore + every chunk +
        first-token sampling)."""
        return self._diff(self.t_admitted, self.t_first)

    @property
    def decode_s(self) -> Optional[float]:
        """First token → finished (0-ish for one-token requests)."""
        return self._diff(self.t_first, self.t_finished)

    @property
    def total_s(self) -> Optional[float]:
        """Submit → finished (== the three phases, within
        :data:`PHASE_SUM_TOLERANCE_S`)."""
        return self._diff(self.t_queued, self.t_finished)

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit → first token on the recorder clock (the scheduler's
        own measure rides :attr:`scheduler_ttft_s`)."""
        return self._diff(self.t_queued, self.t_first)

    @property
    def tpot_s(self) -> Optional[float]:
        """Decode seconds per generated token past the first (the
        serving-literature TPOT; ``None`` until finished, and ``None``
        for one-token requests — TPOT is *undefined* there, and a
        fabricated sample would pollute any offline percentile computed
        over the exported JSONL)."""
        decode = self.decode_s
        if decode is None or not self.new_tokens or self.new_tokens < 2:
            return None
        return decode / (self.new_tokens - 1)

    @property
    def complete(self) -> bool:
        """True when every phase boundary was observed."""
        return None not in (self.t_queued, self.t_admitted, self.t_first,
                            self.t_finished)

    def to_dict(self) -> dict:
        """Flat JSON-ready dict (the JSONL row)."""
        out = {
            "rid": self.rid, "slot": self.slot,
            "prompt_tokens": self.prompt_tokens,
            "new_tokens": self.new_tokens,
            "finish_reason": self.finish_reason,
            "t_queued": self.t_queued, "t_admitted": self.t_admitted,
            "t_first": self.t_first, "t_finished": self.t_finished,
            "queue_wait_s": self.queue_wait_s,
            "prefill_s": self.prefill_s, "decode_s": self.decode_s,
            "total_s": self.total_s, "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s,
            "chunks": list(self.chunks),
            "spec": dict(self.spec),
            "prefix": self.prefix, "alias": self.alias,
            "preemptions": self.preemptions,
            "preempts": list(self.preempts),
            "hops": list(self.hops),
            "replica": self.replica,
            "scheduler_ttft_s": self.scheduler_ttft_s,
            "scheduler_queue_wait_s": self.scheduler_queue_wait_s,
            "per_token_ms": self.per_token_ms,
            "tokens_per_s": self.tokens_per_s,
        }
        return out


class RequestTraceRecorder:
    """Assemble per-request lifecycle records from the live event stream.

    >>> rec = RequestTraceRecorder()
    >>> rec.install()                  # or: with recording_requests() as rec:
    >>> sched.run()
    >>> rec.uninstall()
    >>> rec.records()                  # [RequestRecord, ...]
    >>> rec.export("/tmp/requests.trace.json")   # Perfetto, 1 track/request
    >>> rec.export_jsonl("/tmp/requests.jsonl")  # offline analysis

    ``clock`` is injectable (default ``time.monotonic``) so a virtual
    clock shared with the scheduler + load generator yields
    deterministic phase durations in tests.  ``max_requests`` bounds
    memory exactly like :class:`~apex_tpu_torch.obs.trace.TraceRecorder`'s
    ``max_events``: past the cap, newly *queued* requests are dropped
    and counted (requests already open still complete — a record is
    never truncated mid-flight), keeping the run's beginning.
    """

    #: fleet lanes sit far above the per-request tracks: requests use
    #: tid 0..N (assembly order), replicas use tid >= 1 << 20 (sorted
    #: by name), and the fleet control lane sits just below them
    REPLICA_TID_BASE = 1 << 20
    FLEET_TID = REPLICA_TID_BASE - 1

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 max_requests: int = 100_000,
                 max_fleet_events: int = 10_000):
        if max_requests < 1:
            raise ValueError(
                f"max_requests must be >= 1, got {max_requests}")
        self._clock = clock
        self.max_requests = int(max_requests)
        self.max_fleet_events = int(max_fleet_events)
        self.dropped = 0
        self.fleet_dropped = 0
        self._lock = threading.Lock()
        self._open: Dict[str, RequestRecord] = {}
        self._done: List[RequestRecord] = []
        self._track: Dict[str, int] = {}       # rid -> stable track index
        # rid-less fleet/rollout control events (health transitions,
        # rollout waves, weight swaps) — the timeline bands that give
        # the per-request hop trails their context.  Bounded like the
        # request map; overflow counts in fleet_dropped.
        self._fleet_events: List[dict] = []
        self._warned_full = False

    # ---- sink lifecycle --------------------------------------------------
    def install(self) -> "RequestTraceRecorder":
        """Subscribe to the event stream (idempotent)."""
        _logging.add_event_sink(self._sink)
        return self

    def uninstall(self) -> None:
        """Unsubscribe (records already assembled are kept)."""
        _logging.remove_event_sink(self._sink)

    def installed(self) -> bool:
        return self._sink in _logging.event_sinks()

    # ---- event assembly --------------------------------------------------
    def _get(self, rid: str, *, create: bool,
             count_drop: bool = False) -> Optional[RequestRecord]:
        """Open record for ``rid`` (caller holds the lock).  ``create``
        only on events that legitimately start a lifecycle — a stray
        finished-event for a rid the recorder never saw must not
        fabricate an empty record per event.  ``count_drop`` only on
        the lifecycle's FIRST event (``serving_request_queued``): both
        queued and admitted can create, but a request refused at the
        cap must count as ONE drop, not once per event that retried."""
        st = self._open.get(rid)
        if st is None and create:
            if (len(self._open) + len(self._done)) >= self.max_requests:
                if count_drop:
                    self.dropped += 1
                if not self._warned_full:
                    self._warned_full = True
                    logger.warning(
                        "RequestTraceRecorder full (%d requests): "
                        "dropping further requests (count rides the "
                        "exported otherData)", self.max_requests)
                return None
            st = self._open[rid] = RequestRecord(rid=rid)
            # setdefault: a rid REUSED across workloads keeps its first
            # track index — overwriting would hand the same index out
            # twice (len() unchanged) and interleave two unrelated
            # requests on one Perfetto track
            self._track.setdefault(rid, len(self._track))
        return st

    @staticmethod
    def _num(event: dict, field: str) -> Optional[float]:
        value = event.get(field)
        return float(value) if isinstance(value, (int, float)) else None

    # rid-less fleet/rollout control events worth a timeline band (the
    # per-request fleet events — routed/failover/resumed/shed — fold
    # into hop trails instead)
    _FLEET_BAND_KINDS = frozenset((
        "serving_fleet_replica_state",
        "serving_rollout_started",
        "serving_rollout_replica_upgraded",
        "serving_rollout_canary_verdict",
        "serving_rollout_promoted",
        "serving_rollout_halted",
        "serving_rollout_rolled_back",
        "serving_weights_swapped",
    ))

    def _sink(self, event: dict) -> None:
        kind = event.get("event")
        if not isinstance(kind, str) or not kind.startswith("serving_"):
            return
        if kind in self._FLEET_BAND_KINDS:
            now = self._clock()
            with self._lock:
                if len(self._fleet_events) >= self.max_fleet_events:
                    self.fleet_dropped += 1
                    return
                entry = {k: v for k, v in event.items()
                         if k not in ("event", "time")}
                entry["kind"] = kind
                entry["t"] = now
                self._fleet_events.append(entry)
            return
        rid = event.get("rid")
        if not isinstance(rid, str):
            return                      # step samples etc. carry no rid
        now = self._clock()
        with self._lock:
            if kind == "serving_request_queued":
                st = self._get(rid, create=True, count_drop=True)
                if st is None:
                    return
                if st.t_queued is None:
                    # a failover REQUEUE re-emits queued on the
                    # survivor; queue_wait must span from the
                    # original submit, not restart at the requeue
                    st.t_queued = now
                pt = self._num(event, "prompt_tokens")
                st.prompt_tokens = int(pt) if pt is not None else None
            elif kind == "serving_request_admitted":
                st = self._get(rid, create=True)
                if st is None:
                    return
                st.t_admitted = now
                slot = self._num(event, "slot")
                st.slot = int(slot) if slot is not None else None
                if st.prompt_tokens is None:
                    pt = self._num(event, "prompt_tokens")
                    st.prompt_tokens = int(pt) if pt is not None else None
                st.scheduler_queue_wait_s = self._num(event, "queue_wait_s")
            elif kind == "serving_prefix_hit":
                st = self._get(rid, create=False)
                if st is not None:
                    st.prefix = {
                        "hit": True,
                        "saved_tokens": self._num(event, "saved_tokens"),
                        "blocks": self._num(event, "blocks"),
                        "duration_s": self._num(event, "duration_s")}
            elif kind == "serving_prefix_miss":
                st = self._get(rid, create=False)
                if st is not None:
                    st.prefix = {"hit": False}
            elif kind == "serving_block_alias":
                st = self._get(rid, create=False)
                if st is not None:
                    st.alias = {
                        "blocks": self._num(event, "blocks"),
                        "saved_tokens": self._num(event, "saved_tokens")}
            elif kind == "serving_prefill_chunk":
                st = self._get(rid, create=False)
                if st is not None:
                    dur = self._num(event, "duration_s")
                    st.chunks.append({
                        "bucket": self._num(event, "bucket"),
                        "chunk_tokens": self._num(event, "chunk_tokens"),
                        "offset_tokens": self._num(event, "offset_tokens"),
                        "duration_s": dur, "t_end": now})
            elif kind == "serving_first_token":
                st = self._get(rid, create=False)
                if st is not None:
                    st.t_first = now
                    st.scheduler_ttft_s = self._num(event, "ttft_s")
            elif kind == "serving_spec_verify":
                st = self._get(rid, create=False)
                if st is not None:
                    for f in ("drafted", "accepted", "emitted"):
                        v = self._num(event, f)
                        if v is not None:
                            st.spec[f] = st.spec.get(f, 0) + int(v)
                    st.spec["dispatches"] = st.spec.get("dispatches", 0) + 1
                    dur = self._num(event, "duration_s")
                    st.spec.setdefault("verifies", []).append(
                        {"duration_s": dur, "t_end": now})
            elif kind == "serving_request_preempted":
                st = self._get(rid, create=False)
                if st is not None:
                    st.preemptions += 1
                    st.preempts.append({"t_preempted": now,
                                        "t_resumed": None})
            elif kind == "serving_request_resumed":
                st = self._get(rid, create=False)
                if st is not None and st.preempts and (
                        st.preempts[-1].get("t_resumed") is None):
                    st.preempts[-1]["t_resumed"] = now
            elif kind == "serving_fleet_routed":
                # create=True: the router may route a request the
                # recorder missed queueing (installed mid-flight)
                st = self._get(rid, create=True)
                if st is None:
                    return
                replica = event.get("replica")
                st.hops.append({
                    "kind": "placed", "replica": replica,
                    "retries": self._num(event, "retries"),
                    "weights_step": self._num(event, "weights_step"),
                    "t": now})
                if isinstance(replica, str):
                    st.replica = replica
            elif kind == "serving_fleet_failover":
                st = self._get(rid, create=False)
                if st is not None:
                    # event's replica is the DONOR the stream left
                    st.hops.append({
                        "kind": "failover",
                        "replica": event.get("replica"),
                        "mode": event.get("mode"),
                        "new_tokens": self._num(event, "new_tokens"),
                        "t": now})
            elif kind == "serving_fleet_resumed":
                st = self._get(rid, create=False)
                if st is not None:
                    replica = event.get("replica")
                    st.hops.append({
                        "kind": "resumed", "replica": replica,
                        "from_replica": event.get("from_replica"),
                        "mode": event.get("mode"),
                        "duration_s": self._num(event, "duration_s"),
                        "t": now})
                    if isinstance(replica, str):
                        st.replica = replica
            elif kind == "serving_fleet_shed":
                # a router-level terminal: the stream never lands again
                # (shed at submit, at failover with failover off, or
                # when no surviving capacity could absorb the victim)
                st = self._open.pop(rid, None)
                if st is None:
                    return
                st.hops.append({
                    "kind": "shed", "reason": event.get("reason"),
                    "t": now})
                st.t_finished = now
                st.finish_reason = "fleet_shed"
                self._done.append(st)
            elif kind in ("serving_request_cancelled",
                          "serving_request_shed"):
                # a non-served terminal: close the record (it will be
                # `complete` only if it reached DECODE before dying —
                # an incomplete record is counted, never distributed)
                st = self._open.pop(rid, None)
                if st is None:
                    return
                st.t_finished = now
                st.finish_reason = ("cancelled"
                                    if kind.endswith("cancelled")
                                    else "shed")
                nt = self._num(event, "new_tokens")
                st.new_tokens = int(nt) if nt is not None else None
                self._done.append(st)
            elif kind == "serving_request_finished":
                st = self._open.pop(rid, None)
                if st is None:
                    return
                st.t_finished = now
                reason = event.get("finish_reason")
                st.finish_reason = (reason if isinstance(reason, str)
                                    else None)
                nt = self._num(event, "new_tokens")
                st.new_tokens = int(nt) if nt is not None else None
                st.per_token_ms = self._num(event, "per_token_ms")
                st.tokens_per_s = self._num(event, "tokens_per_s")
                self._done.append(st)

    # ---- introspection ---------------------------------------------------
    def records(self) -> List[RequestRecord]:
        """Completed records in finish order (copies of the list, live
        record objects — callers read, they don't mutate)."""
        with self._lock:
            return list(self._done)

    def open_records(self) -> List[RequestRecord]:
        """Requests seen but not yet finished (in-flight at read time,
        or evicted/abandoned without a finished event)."""
        with self._lock:
            return list(self._open.values())

    def fleet_events(self) -> List[dict]:
        """Captured rid-less fleet/rollout control events (health
        transitions, rollout waves, weight swaps) in arrival order."""
        with self._lock:
            return [dict(e) for e in self._fleet_events]

    def __len__(self) -> int:
        with self._lock:
            return len(self._done)

    # ---- export ----------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto trace-event JSON: **one track per request**
        (``tid`` = stable per-request index, named after the rid via
        ``thread_name`` metadata), a ``request`` slice spanning the
        whole lifecycle, phase slices (``queued`` / ``prefill`` /
        ``decode``) nested inside it, and per-chunk / per-verify
        slices nested inside their phase (placed at
        ``[event time - dispatch duration, event time]``)."""
        import os

        pid = os.getpid()
        with self._lock:
            done = list(self._done)
            open_count = len(self._open)
            dropped = self.dropped
            fleet_dropped = self.fleet_dropped
            track = dict(self._track)
            fleet = [dict(e) for e in self._fleet_events]
        events: List[dict] = []

        def _us(t: float) -> float:
            return round(t * 1e6, 3)

        def slice_(name, tid, t0, t1, **args):
            if t0 is None or t1 is None:
                return
            ev = {"name": name, "ph": "X", "cat": "apex_request",
                  "ts": _us(t0), "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
                  "pid": pid, "tid": tid}
            if args:
                ev["args"] = {k: v for k, v in args.items()
                              if v is not None}
            events.append(ev)

        for st in done:
            tid = track.get(st.rid, 0)
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": st.rid}})
            events.append({"name": "thread_sort_index", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"sort_index": tid}})
            slice_("request", tid, st.t_queued, st.t_finished,
                   rid=st.rid, slot=st.slot,
                   prompt_tokens=st.prompt_tokens,
                   new_tokens=st.new_tokens,
                   finish_reason=st.finish_reason,
                   prefix=st.prefix, alias=st.alias,
                   spec={k: v for k, v in st.spec.items()
                         if k != "verifies"} or None)
            slice_("queued", tid, st.t_queued, st.t_admitted)
            slice_("prefill", tid, st.t_admitted, st.t_first,
                   chunks=len(st.chunks),
                   ttft_s=st.ttft_s,
                   scheduler_ttft_s=st.scheduler_ttft_s)
            slice_("decode", tid, st.t_first, st.t_finished,
                   tpot_s=st.tpot_s, per_token_ms=st.per_token_ms)
            for gap in st.preempts:
                # a suspension gap inside the decode phase; a stream
                # cancelled/shed while suspended never resumed — its
                # gap runs to the terminal stamp
                slice_("preempted", tid, gap.get("t_preempted"),
                       (gap.get("t_resumed")
                        if gap.get("t_resumed") is not None
                        else st.t_finished))
            for chunk in st.chunks:
                dur = chunk.get("duration_s")
                end = chunk.get("t_end")
                if dur is None or end is None:
                    continue
                slice_(f"prefill_chunk[{int(chunk['bucket'])}]"
                       if chunk.get("bucket") is not None
                       else "prefill_chunk",
                       tid, end - dur, end,
                       chunk_tokens=chunk.get("chunk_tokens"),
                       offset_tokens=chunk.get("offset_tokens"))
            for verify in st.spec.get("verifies", []):
                dur = verify.get("duration_s")
                end = verify.get("t_end")
                if dur is None or end is None:
                    continue
                slice_("spec_verify", tid, end - dur, end)
        self._fleet_lanes(events, done, fleet, pid, slice_)
        events.sort(key=lambda e: (e.get("ts", -1.0), e["tid"]))
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        other = {}
        if dropped:
            other["dropped_requests"] = dropped
            other["max_requests"] = self.max_requests
        if fleet_dropped:
            other["dropped_fleet_events"] = fleet_dropped
            other["max_fleet_events"] = self.max_fleet_events
        if open_count:
            other["open_requests"] = open_count
        if other:
            payload["otherData"] = other
        return payload

    def _fleet_lanes(self, events: List[dict], done: List[RequestRecord],
                     fleet: List[dict], pid: int, slice_) -> None:
        """One lane per replica (stream residency from the hop trails +
        health-state bands + reload-swap slices) plus one fleet control
        lane (rollout waves, weight swaps).  A run that never touched a
        fleet adds NOTHING here — the single-engine export stays
        byte-identical."""
        replicas = set()
        for st in done:
            for hop in st.hops:
                for field in ("replica", "from_replica"):
                    name = hop.get(field)
                    if isinstance(name, str):
                        replicas.add(name)
        for ev in fleet:
            name = ev.get("replica")
            if isinstance(name, str):
                replicas.add(name)
        if not replicas and not fleet:
            return
        lane = {name: self.REPLICA_TID_BASE + i
                for i, name in enumerate(sorted(replicas))}

        def instant(name, tid, t, **args):
            if t is None:
                return
            ev = {"name": name, "ph": "i", "cat": "apex_fleet",
                  "ts": round(t * 1e6, 3), "pid": pid, "tid": tid,
                  "s": "t"}
            if args:
                ev["args"] = {k: v for k, v in args.items()
                              if v is not None}
            events.append(ev)

        for name, tid in lane.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"replica {name}"}})
            events.append({"name": "thread_sort_index", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"sort_index": tid}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": self.FLEET_TID, "args": {"name": "fleet"}})
        events.append({"name": "thread_sort_index", "ph": "M",
                       "pid": pid, "tid": self.FLEET_TID,
                       "args": {"sort_index": self.FLEET_TID}})

        # residency: walk each hop trail; placed/resumed opens a span
        # on that replica's lane, failover closes the donor span (the
        # migration reads as the rid ending on one lane and reappearing
        # on another), the terminal stamp closes whatever is open
        for st in done:
            open_span = None            # (replica, t_start, how)
            for hop in st.hops:
                k = hop.get("kind")
                if k in ("placed", "resumed"):
                    if open_span is not None:
                        slice_(st.rid, lane.get(open_span[0],
                                                self.FLEET_TID),
                               open_span[1], hop.get("t"),
                               rid=st.rid, via=open_span[2])
                    name = hop.get("replica")
                    if isinstance(name, str):
                        open_span = (name, hop.get("t"), k)
                elif k in ("failover", "shed"):
                    if open_span is not None:
                        slice_(st.rid, lane.get(open_span[0],
                                                self.FLEET_TID),
                               open_span[1], hop.get("t"),
                               rid=st.rid, via=open_span[2],
                               ended_by=k, mode=hop.get("mode"))
                        open_span = None
            if open_span is not None:
                slice_(st.rid, lane.get(open_span[0], self.FLEET_TID),
                       open_span[1], st.t_finished,
                       rid=st.rid, via=open_span[2],
                       finish_reason=st.finish_reason)

        # control bands: health transitions on the replica's own lane,
        # rollout/reload milestones on the fleet lane; a reload swap
        # pause renders as a slice ending at the upgrade event
        for ev in fleet:
            kind = ev.get("kind")
            t = ev.get("t")
            name = ev.get("replica")
            tid = lane.get(name, self.FLEET_TID)
            if kind == "serving_fleet_replica_state":
                instant(f"health:{ev.get('state')}", tid, t,
                        replica=name, from_state=ev.get("from_state"))
            elif kind == "serving_rollout_replica_upgraded":
                swap_s = self._num(ev, "swap_s")
                if swap_s is not None and t is not None:
                    slice_("reload_swap", tid, t - swap_s, t,
                           replica=name, step=ev.get("step"))
                else:
                    instant("reload_swap", tid, t, replica=name)
            elif kind == "serving_weights_swapped":
                swap_s = self._num(ev, "swap_s")
                if swap_s is not None and t is not None:
                    slice_("weights_swap", tid, t - swap_s, t,
                           step=ev.get("step"))
                else:
                    instant("weights_swap", tid, t, step=ev.get("step"))
            else:
                # rollout lifecycle milestones (started / canary
                # verdict / promoted / halted / rolled back)
                label = kind.replace("serving_", "", 1)
                instant(label, self.FLEET_TID, t,
                        verdict=ev.get("verdict"),
                        step=ev.get("step"),
                        replicas=ev.get("replicas"))

    def export(self, path: str) -> dict:
        """Atomically write the Perfetto-loadable trace JSON (same
        non-finite → ``null`` + ``default=str`` degradation contract as
        :meth:`TraceRecorder.export`); returns the payload."""
        from apex_tpu_torch.utils.serialization import (
            atomic_write_json,
            json_finite,
        )

        payload = json_finite(self.to_chrome_trace())
        atomic_write_json(path, payload, allow_nan=False, default=str)
        return payload

    def export_jsonl(self, path: str) -> int:
        """Atomically write one JSON line per completed record (finish
        order) for offline analysis; returns the number of rows."""
        from apex_tpu_torch.utils.serialization import (
            atomic_write_jsonl,
            json_finite,
        )

        rows = [json_finite(st.to_dict()) for st in self.records()]
        atomic_write_jsonl(path, rows, allow_nan=False, default=str)
        return len(rows)


@contextlib.contextmanager
def recording_requests(clock: Callable[[], float] = time.monotonic,
                       max_requests: int = 100_000
                       ) -> Iterator[RequestTraceRecorder]:
    """``with recording_requests() as rec:`` — record request lifecycles
    for the block only (the sink is removed on exit; assembled records
    stay readable)."""
    rec = RequestTraceRecorder(clock=clock, max_requests=max_requests)
    rec.install()
    try:
        yield rec
    finally:
        rec.uninstall()
