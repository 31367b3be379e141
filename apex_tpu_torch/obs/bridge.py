"""Event → metric/span bridge: every ``emit_event`` feeds the registry.

The repo already has a complete structured-event vocabulary
(``checkpoint_saved`` / ``checkpoint_rejected``, ``retry_attempt`` /
``retry_exhausted``, ``replica_desync``, ``batch_skipped``,
``serving_request_queued`` / ``serving_first_token`` /
``serving_request_finished``, ``watchdog_stall``, ``fault_injected``,
…) — but events are log lines, and log lines cannot answer "how many,
how fast, right now".  This module subscribes one sink to
:func:`apex_tpu_torch._logging.add_event_sink` that, for every event:

1. increments ``apex_events_total{event=<kind>}`` — every event kind is
   countable with **zero call-site churn**;
2. stamps the kind onto the active trace span (so a trace of a slow
   step shows the retries/skips that happened inside it);
3. runs a per-kind handler for the events whose payloads carry real
   measurements (TTFT and per-token latency histograms, retry/skip/
   desync counters, …).

Installed automatically when :mod:`apex_tpu_torch.obs` is imported (which the
supervisor, checkpoint manager, and serving scheduler all do), and
idempotent.  The default log sink is untouched: ``emit_event`` output
stays byte-identical with or without the bridge.

Serving **gauges** (queue depth, slot occupancy, cache utilization,
prefill backlog, decode compiles, speculation speedup, prefix-cache
cached tokens) are declared
here but *set directly* by the scheduler each step — a gauge describes current state, and
routing it through the event stream would tie its freshness to
``log_interval``.  Pipeline timers publish through
:data:`TIMER_SECONDS` via ``Timers.publish_metrics()``.

This is the port of ``apex_tpu.obs.bridge``: the whole metric inventory
and handler table, so the slices still to come (weight reload, the
fleet, rollouts, tensor parallelism, resilience) register nothing new.
One gauge is declared and never set here:
``apex_serving_decode_compiles`` (the port compiles nothing).
``apex_serving_tp_size`` and ``apex_serving_collective_seconds`` are set
from the ``serving_tp_step`` events of a ``DecodeEngine(tp=)``.
"""

from __future__ import annotations

from apex_tpu_torch import _logging
from apex_tpu_torch.obs import metrics, trace

__all__ = ["install", "uninstall", "installed", "register_replica"]

# -- the metric inventory (each name registered at exactly ONE call site;
#    tools/check_metrics.py enforces naming + uniqueness + documentation
#    in docs/api/observability.md) ------------------------------------------

EVENTS_TOTAL = metrics.counter(
    "apex_events_total", "structured emit_event lines by kind", ("event",))
RETRY_ATTEMPTS = metrics.counter(
    "apex_retry_attempts_total",
    "transient-failure retry attempts by call site", ("what",))
RETRY_EXHAUSTED = metrics.counter(
    "apex_retry_exhausted_total",
    "retries that ran out of attempts, by call site", ("what",))
BATCHES_SKIPPED = metrics.counter(
    "apex_batches_skipped_total",
    "corrupt batches dropped by the data guard")
REPLICA_DESYNC = metrics.counter(
    "apex_replica_desync_total",
    "diverged (leaf, replica) observations from verify_replicas")
SUPERVISOR_FAILURES = metrics.counter(
    "apex_supervisor_failures_total",
    "unrecovered supervisor failures by exception type", ("failure",))
WATCHDOG_STALLS = metrics.counter(
    "apex_watchdog_stalls_total",
    "step-deadline violations observed by the watchdog")
FAULTS_INJECTED = metrics.counter(
    "apex_faults_injected_total",
    "deterministic test faults fired, by fault kind", ("fault",))
CHECKPOINTS_REJECTED = metrics.counter(
    "apex_checkpoints_rejected_total",
    "checkpoints skipped by the newest-valid fallback walk")
SERVING_TTFT = metrics.histogram(
    "apex_serving_ttft_seconds",
    "request submit -> first token (queue wait + prefill)",
    scope_labels=("replica",))
SERVING_QUEUE_WAIT = metrics.histogram(
    "apex_serving_queue_wait_seconds",
    "request submit -> slot admission (time spent waiting for "
    "capacity; the queueing component of TTFT)",
    scope_labels=("replica",))
SERVING_GOODPUT = metrics.gauge(
    "apex_serving_goodput_ratio",
    "requests meeting their deadline / requests offered, for the most "
    "recent deadline-carrying open-loop loadgen run")
SERVING_PREFILL_DURATION = metrics.histogram(
    "apex_serving_prefill_duration_seconds",
    "wall time of one prefill-chunk dispatch, by bucket size",
    ("bucket",))
SERVING_PER_TOKEN = metrics.histogram(
    "apex_serving_decode_per_token_seconds",
    "steady-state decode latency per generated token",
    scope_labels=("replica",))
SERVING_TOKENS_PER_S = metrics.gauge(
    "apex_serving_tokens_per_second",
    "throughput of the most recently finished request",
    scope_labels=("replica",))
SERVING_QUEUE_DEPTH = metrics.gauge(
    "apex_serving_queue_depth", "requests waiting for a decode slot",
    scope_labels=("replica",))
SERVING_SLOT_OCCUPANCY = metrics.gauge(
    "apex_serving_slot_occupancy", "active decode slots / total slots",
    scope_labels=("replica",))
SERVING_CACHE_UTILIZATION = metrics.gauge(
    "apex_serving_cache_utilization",
    "filled KV-cache positions / total capacity",
    scope_labels=("replica",))
SERVING_DECODE_COMPILES = metrics.gauge(
    "apex_serving_decode_compiles",
    "distinct compiles of the batched decode step (1 == shape-stable)",
    scope_labels=("replica",))
SERVING_PREFILL_BACKLOG = metrics.gauge(
    "apex_serving_prefill_backlog",
    "prompt tokens admitted or queued but not yet cached (deferred by "
    "the per-step prefill budget)",
    scope_labels=("replica",))
SERVING_PREFIX_HITS = metrics.counter(
    "apex_serving_prefix_hit_total",
    "admissions that restored a cached prompt prefix (prefill resumed "
    "mid-prompt, bit-identically)")
SERVING_PREFIX_MISSES = metrics.counter(
    "apex_serving_prefix_miss_total",
    "admissions with no cached prefix to reuse (full prefill)")
SERVING_PREFIX_SAVED = metrics.histogram(
    "apex_serving_prefix_saved_tokens",
    "prompt tokens restored from the prefix cache per hit — prefill "
    "work not re-run (block-granular, so the floor is one block)",
    buckets=tuple(float(b) for b in (16, 32, 64, 128, 256, 512, 1024,
                                     2048, 4096, 8192)))
SERVING_PREFIX_CACHED_TOKENS = metrics.gauge(
    "apex_serving_prefix_cached_tokens",
    "tokens of K/V held by the cross-request prefix cache (refreshed "
    "per scheduler step while prefix caching is enabled)",
    scope_labels=("replica",))
SERVING_SPEC_DRAFTED = metrics.counter(
    "apex_serving_spec_drafted_total",
    "draft tokens proposed by prompt lookup (speculative decode)")
SERVING_SPEC_ACCEPTED = metrics.counter(
    "apex_serving_spec_accepted_total",
    "drafted tokens the verify forward's greedy argmax accepted")
SERVING_SPEC_REJECTED = metrics.counter(
    "apex_serving_spec_rejected_total",
    "drafted tokens rejected at verification (rolled back, never "
    "emitted)")
SERVING_SPEC_ACCEPT_LENGTH = metrics.histogram(
    "apex_serving_spec_accepted_tokens",
    "accepted draft length per verify dispatch (0 == immediate "
    "rejection; the distribution behind the speculation speedup)",
    buckets=tuple(float(b) for b in (0, 1, 2, 3, 4, 6, 8, 12, 16, 24,
                                     32)))
SERVING_SPEC_SPEEDUP = metrics.gauge(
    "apex_serving_spec_speedup",
    "tokens emitted per verify dispatch on the speculative path "
    "(1.0 == plain decode's one token per dispatch)",
    scope_labels=("replica",))
SERVING_BLOCK_POOL_UTILIZATION = metrics.gauge(
    "apex_serving_block_pool_utilization",
    "allocated KV pool blocks / allocatable blocks (paged cache; "
    "refreshed per scheduler step while a paged engine serves)",
    scope_labels=("replica",))
SERVING_BLOCK_ALIAS_HITS = metrics.counter(
    "apex_serving_block_alias_hits_total",
    "prefix-cache blocks reused by block-table aliasing — zero-copy "
    "hits: no K/V moved, the block just gained a reference")
SERVING_BLOCK_COW = metrics.counter(
    "apex_serving_block_cow_total",
    "copy-on-write block copies (a write targeted a block whose "
    "refcount exceeded one — sharers stay bit-isolated)")
SERVING_PREEMPTED = metrics.counter(
    "apex_serving_preempted_total",
    "DECODE streams losslessly preempted by a higher-priority "
    "admission (each resumes bit-exactly later)",
    scope_labels=("replica",))
SERVING_CANCELLED = metrics.counter(
    "apex_serving_cancelled_total",
    "requests cancelled by the caller (slot/blocks/pins released; "
    "partial output kept in the result)",
    scope_labels=("replica",))
SERVING_SHED = metrics.counter(
    "apex_serving_shed_total",
    "queued or suspended requests shed at an expired deadline before "
    "spending further prefill budget (charged against goodput)",
    scope_labels=("replica",))
SERVING_TP_SIZE = metrics.gauge(
    "apex_serving_tp_size",
    "tensor-parallel mesh width the decode engine's programs run over "
    "(1 == single-chip; set from serving_tp_step events)")
SERVING_COLLECTIVE_SECONDS = metrics.histogram(
    "apex_serving_collective_seconds",
    "wall time of one tensor-parallel decode step, dispatch to "
    "completion — an honest UPPER BOUND on the per-step collective "
    "cost (the per-layer psum pair rides inside; exact attribution "
    "needs a profiler)",
    buckets=tuple(b / 1e3 for b in (0.25, 0.5, 1, 2, 5, 10, 25, 50,
                                    100, 250, 1000)))
SERVING_TENANT_INFLIGHT = metrics.gauge(
    "apex_serving_tenant_inflight",
    "active decode/prefill streams per tenant (refreshed per scheduler "
    "step while a scheduling policy is enabled)", ("tenant",))
SERVING_WEIGHTS_STEP = metrics.gauge(
    "apex_serving_weights_step",
    "training step of the weights currently serving (set at boot load "
    "and on every hot swap/rollback — a fleet dashboard's 'what am I "
    "running' answer)")
SERVING_RELOAD_DURATION = metrics.histogram(
    "apex_serving_reload_duration_seconds",
    "hot-reload phase wall time: restore (checkpoint read+validate+"
    "place), validate (pre-swap spec gate), swap (pointer swap + "
    "prefix-cache invalidation — the only phase the serving loop "
    "ever waits on)", ("phase",))
SERVING_FLEET_REPLICAS_HEALTHY = metrics.gauge(
    "apex_serving_fleet_replicas_healthy",
    "replicas in the HEALTHY state (refreshed every fleet router "
    "step; suspect/draining/dead replicas do not count)")
SERVING_FLEET_ROUTED = metrics.counter(
    "apex_serving_fleet_routed_total",
    "requests placed onto a replica by the fleet router (affinity or "
    "WRR; cardinality bounded by the fleet size)", ("replica",))
SERVING_FLEET_TRANSITIONS = metrics.counter(
    "apex_serving_fleet_transitions_total",
    "replica health-state transitions, by destination state",
    ("state",))
SERVING_FLEET_FAILOVERS = metrics.counter(
    "apex_serving_fleet_failovers_total",
    "streams evacuated from a dead or draining replica, by mode "
    "(capture-resume: cache bytes travel, bit-exact mid-stream; "
    "requeue: deterministic replay from the request record)",
    ("mode",))
SERVING_FLEET_RESUMES = metrics.counter(
    "apex_serving_fleet_resumes_total",
    "failover victims that landed on a survivor with their captured "
    "cache intact (mid-stream bit-exact resumes; requeued victims "
    "count in failovers only)")
SERVING_FLEET_SHED = metrics.counter(
    "apex_serving_fleet_shed_total",
    "requests the fleet router shed: every healthy replica at "
    "capacity, no replica available, or a failover victim that no "
    "surviving capacity could absorb")
SERVING_FLEET_FAILOVER_SECONDS = metrics.histogram(
    "apex_serving_fleet_failover_seconds",
    "replica failure (or drain) to the victim stream landing on a "
    "survivor, per stream, on the fleet's shared clock")
SERVING_ROLLOUT_ACTIVE = metrics.gauge(
    "apex_serving_rollout_active",
    "1 while a rolling fleet upgrade is in flight (set at "
    "serving_rollout_started, cleared at the promoted/halted "
    "terminal)")
SERVING_ROLLOUT_REPLICAS_UPGRADED = metrics.counter(
    "apex_serving_rollout_replicas_upgraded_total",
    "replicas that completed the drain -> reload -> rejoin upgrade "
    "during a rolling fleet upgrade")
SERVING_ROLLOUT_VERDICTS = metrics.counter(
    "apex_serving_rollout_verdicts_total",
    "canary gate decisions by verdict (pass promotes the rollout to "
    "the remaining replicas; fail halts it)", ("verdict",))
SERVING_ROLLOUT_HALTS = metrics.counter(
    "apex_serving_rollout_halts_total",
    "rolling upgrades halted before promotion (gate failure, refused "
    "candidate, or a replica death mid-rollout)")
SERVING_ROLLOUT_ROLLBACKS = metrics.counter(
    "apex_serving_rollout_rollbacks_total",
    "replicas rolled back byte-exact from their retained previous "
    "buffer by a halted rolling upgrade")
SERVING_ROLLOUT_PROMOTIONS = metrics.counter(
    "apex_serving_rollout_promotions_total",
    "rolling upgrades that promoted: every replica serving the new "
    "weights_step with zero dropped streams")
SERVING_ROLLOUT_SWAP_PAUSE_SECONDS = metrics.histogram(
    "apex_serving_rollout_swap_pause_seconds",
    "per-replica serving pause during a rolling upgrade (the reload's "
    "pointer swap only — the restore/validate ran off-path via "
    "prefetch)")
SERVING_ROLLOUT_VERDICT_LATENCY_SECONDS = metrics.histogram(
    "apex_serving_rollout_verdict_latency_seconds",
    "canary window open (traffic pinned) to gate verdict, on the "
    "fleet's shared clock")
SERVING_ROLLOUT_WALL_SECONDS = metrics.histogram(
    "apex_serving_rollout_wall_seconds",
    "rollout start to terminal (promoted or halted+rolled back), on "
    "the fleet's shared clock")
SERVING_QUANT_BYTES_PER_TOKEN = metrics.gauge(
    "apex_serving_quant_bytes_per_token",
    "KV-cache bytes pinned per cached token position under the active "
    "quantization config (int8 payload + fp32 scales; fp32 serving "
    "reports its plain payload bytes — the capacity denominator behind "
    "streams-per-GB)")
SERVING_QUANT_LOGIT_ERROR = metrics.histogram(
    "apex_serving_quant_logit_error",
    "max |fp32 logit - quantized logit| per quant evaluation window "
    "(dimensionless logit-space distance; the numeric-drift companion "
    "to the token-agreement gauge)",
    buckets=tuple(float(b) for b in (0.001, 0.0025, 0.005, 0.01, 0.025,
                                     0.05, 0.1, 0.25, 0.5, 1.0)))
SERVING_QUANT_AGREEMENT = metrics.gauge(
    "apex_serving_quant_agreement_ratio",
    "greedy token-stream agreement of the quantized engine against its "
    "fp32 reference over the most recent evaluation window (1.0 == "
    "bit-identical token stream)")
SERVING_ALERTS_FIRING = metrics.gauge(
    "apex_serving_alerts_firing",
    "1 while the named alert rule is in the FIRING state, 0 after it "
    "resolves (set from serving_alert_firing/resolved events; rule "
    "cardinality is the AlertEngine's declared rule list)", ("rule",))
SERVING_ALERT_TRANSITIONS = metrics.counter(
    "apex_serving_alert_transitions_total",
    "alert lifecycle transitions (firing + resolved) across all rules "
    "— a flapping rule shows up here long before a dashboard does")
TIMER_SECONDS = metrics.gauge(
    "apex_timer_seconds",
    "pipeline Timers accumulated seconds by region", ("region",))

# -- per-replica attribution ------------------------------------------------
#
# Named schedulers register here before stamping `replica` onto their
# events; the set's size IS the scope's cardinality bound (fleet size),
# widened monotonically so replacement replicas with fresh names still
# fit.  Unnamed schedulers never call this and keep today's unlabeled
# series byte-identical.

_KNOWN_REPLICAS: set = set()


def register_replica(name: str) -> None:
    """Declare a replica name as a legal ``replica`` label value (widens
    the scope's cardinality bound to the count of distinct names)."""
    _KNOWN_REPLICAS.add(str(name))
    metrics.REGISTRY.declare_scope("replica", len(_KNOWN_REPLICAS))


def _replica(event: dict) -> dict:
    """``{"replica": name}`` when the event is replica-attributed (a
    named scheduler stamped it), else ``{}`` — splatting this into a
    metric update dual-writes the attributed series beside the
    fleet-aggregate one without branching at every call site."""
    name = event.get("replica")
    return {"replica": name} if isinstance(name, str) else {}


def _on_retry_attempt(event: dict) -> None:
    RETRY_ATTEMPTS.inc(what=str(event.get("what", "unknown")))


def _on_retry_exhausted(event: dict) -> None:
    RETRY_EXHAUSTED.inc(what=str(event.get("what", "unknown")))


def _on_batch_skipped(event: dict) -> None:
    BATCHES_SKIPPED.inc()


def _on_replica_desync(event: dict) -> None:
    REPLICA_DESYNC.inc()


def _on_supervisor_failure(event: dict) -> None:
    SUPERVISOR_FAILURES.inc(failure=str(event.get("failure", "unknown")))


def _on_watchdog_stall(event: dict) -> None:
    WATCHDOG_STALLS.inc()


def _on_fault_injected(event: dict) -> None:
    FAULTS_INJECTED.inc(fault=str(event.get("fault", "unknown")))


def _on_checkpoint_rejected(event: dict) -> None:
    CHECKPOINTS_REJECTED.inc()


def _measurement(event: dict, field: str):
    """The event's measurement, or None when absent/non-numeric —
    emit_event is a free-form API, and a malformed event must be
    SKIPPED, not recorded as a fabricated 0.0 sample that drags every
    percentile query down for the life of the process."""
    value = event.get(field)
    return float(value) if isinstance(value, (int, float)) else None


def _on_serving_first_token(event: dict) -> None:
    ttft_s = _measurement(event, "ttft_s")
    if ttft_s is not None:
        SERVING_TTFT.observe(ttft_s)
        replica = _replica(event)
        if replica:
            SERVING_TTFT.observe(ttft_s, **replica)


def _on_serving_request_admitted(event: dict) -> None:
    queue_wait_s = _measurement(event, "queue_wait_s")
    if queue_wait_s is not None:
        SERVING_QUEUE_WAIT.observe(queue_wait_s)
        replica = _replica(event)
        if replica:
            SERVING_QUEUE_WAIT.observe(queue_wait_s, **replica)


def _on_serving_prefill_chunk(event: dict) -> None:
    duration_s = _measurement(event, "duration_s")
    bucket = event.get("bucket")
    # the bucket label comes from the engine's fixed bucket table, so
    # cardinality is bounded by construction (log2(prefill_len) series)
    if duration_s is not None and isinstance(bucket, int):
        SERVING_PREFILL_DURATION.observe(duration_s, bucket=str(bucket))


def _on_serving_spec_verify(event: dict) -> None:
    drafted = _measurement(event, "drafted")
    accepted = _measurement(event, "accepted")
    # drafted/accepted travel together (the scheduler emits both); a
    # malformed event is skipped whole rather than half-counted, so the
    # rejected = drafted - accepted identity survives any input
    if drafted is None or accepted is None or not 0 <= accepted <= drafted:
        return
    SERVING_SPEC_DRAFTED.inc(drafted)
    SERVING_SPEC_ACCEPTED.inc(accepted)
    SERVING_SPEC_REJECTED.inc(drafted - accepted)
    SERVING_SPEC_ACCEPT_LENGTH.observe(accepted)


def _on_serving_prefix_hit(event: dict) -> None:
    SERVING_PREFIX_HITS.inc()
    saved = _measurement(event, "saved_tokens")
    if saved is not None:
        SERVING_PREFIX_SAVED.observe(saved)


def _on_serving_prefix_miss(event: dict) -> None:
    SERVING_PREFIX_MISSES.inc()


def _on_serving_block_alias(event: dict) -> None:
    blocks = _measurement(event, "blocks")
    if blocks is not None and blocks > 0:
        SERVING_BLOCK_ALIAS_HITS.inc(blocks)


def _on_serving_block_cow(event: dict) -> None:
    blocks = _measurement(event, "blocks")
    if blocks is not None and blocks > 0:
        SERVING_BLOCK_COW.inc(blocks)


def _on_serving_request_preempted(event: dict) -> None:
    SERVING_PREEMPTED.inc()
    replica = _replica(event)
    if replica:
        SERVING_PREEMPTED.inc(**replica)


def _on_serving_request_cancelled(event: dict) -> None:
    SERVING_CANCELLED.inc()
    replica = _replica(event)
    if replica:
        SERVING_CANCELLED.inc(**replica)


def _on_serving_request_shed(event: dict) -> None:
    SERVING_SHED.inc()
    replica = _replica(event)
    if replica:
        SERVING_SHED.inc(**replica)


def _on_serving_request_finished(event: dict) -> None:
    replica = _replica(event)
    per_token_ms = _measurement(event, "per_token_ms")
    if per_token_ms is not None:
        SERVING_PER_TOKEN.observe(per_token_ms / 1e3)
        if replica:
            SERVING_PER_TOKEN.observe(per_token_ms / 1e3, **replica)
    tokens_per_s = _measurement(event, "tokens_per_s")
    if tokens_per_s is not None:
        SERVING_TOKENS_PER_S.set(tokens_per_s)
        if replica:
            SERVING_TOKENS_PER_S.set(tokens_per_s, **replica)


def _on_serving_tp_step(event: dict) -> None:
    tp = _measurement(event, "tp")
    if tp is not None and tp >= 1:
        SERVING_TP_SIZE.set(tp)
    duration_s = _measurement(event, "duration_s")
    if duration_s is not None:
        SERVING_COLLECTIVE_SECONDS.observe(duration_s)


def _on_serving_weights_loaded(event: dict) -> None:
    step = _measurement(event, "step")
    if step is not None:
        SERVING_WEIGHTS_STEP.set(step)
    # the load event's duration IS the restore phase (boot and reload
    # flow through the same load_serving_params call)
    duration_s = _measurement(event, "duration_s")
    if duration_s is not None:
        SERVING_RELOAD_DURATION.observe(duration_s, phase="restore")


def _on_serving_weights_swapped(event: dict) -> None:
    step = _measurement(event, "step")
    if step is not None:
        SERVING_WEIGHTS_STEP.set(step)
    for phase in ("validate", "swap"):
        v = _measurement(event, f"{phase}_s")
        if v is not None:
            SERVING_RELOAD_DURATION.observe(v, phase=phase)


def _on_serving_fleet_routed(event: dict) -> None:
    SERVING_FLEET_ROUTED.inc(
        replica=str(event.get("replica", "unknown")))


def _on_serving_fleet_replica_state(event: dict) -> None:
    SERVING_FLEET_TRANSITIONS.inc(
        state=str(event.get("state", "unknown")))


def _on_serving_fleet_failover(event: dict) -> None:
    SERVING_FLEET_FAILOVERS.inc(
        mode=str(event.get("mode", "unknown")))


def _on_serving_fleet_resumed(event: dict) -> None:
    if event.get("mode") == "capture-resume":
        SERVING_FLEET_RESUMES.inc()
    duration_s = _measurement(event, "duration_s")
    if duration_s is not None:
        SERVING_FLEET_FAILOVER_SECONDS.observe(duration_s)


def _on_serving_fleet_shed(event: dict) -> None:
    SERVING_FLEET_SHED.inc()


def _on_serving_rollout_started(event: dict) -> None:
    SERVING_ROLLOUT_ACTIVE.set(1)


def _on_serving_rollout_replica_upgraded(event: dict) -> None:
    SERVING_ROLLOUT_REPLICAS_UPGRADED.inc()
    swap_s = _measurement(event, "swap_s")
    if swap_s is not None:
        SERVING_ROLLOUT_SWAP_PAUSE_SECONDS.observe(swap_s)


def _on_serving_rollout_canary_verdict(event: dict) -> None:
    SERVING_ROLLOUT_VERDICTS.inc(
        verdict=str(event.get("verdict", "unknown")))
    duration_s = _measurement(event, "duration_s")
    if duration_s is not None:
        SERVING_ROLLOUT_VERDICT_LATENCY_SECONDS.observe(duration_s)


def _on_serving_rollout_halted(event: dict) -> None:
    SERVING_ROLLOUT_HALTS.inc()
    SERVING_ROLLOUT_ACTIVE.set(0)
    duration_s = _measurement(event, "duration_s")
    if duration_s is not None:
        SERVING_ROLLOUT_WALL_SECONDS.observe(duration_s)


def _on_serving_rollout_rolled_back(event: dict) -> None:
    replicas = _measurement(event, "replicas")
    if replicas is not None and replicas >= 1:
        SERVING_ROLLOUT_ROLLBACKS.inc(replicas)


def _on_serving_quant_eval(event: dict) -> None:
    agreement = _measurement(event, "agreement")
    if agreement is not None and 0 <= agreement <= 1:
        SERVING_QUANT_AGREEMENT.set(agreement)
    err = _measurement(event, "max_logit_error")
    if err is not None:
        SERVING_QUANT_LOGIT_ERROR.observe(err)
    bpt = _measurement(event, "bytes_per_token")
    if bpt is not None:
        SERVING_QUANT_BYTES_PER_TOKEN.set(bpt)


def _on_serving_rollout_promoted(event: dict) -> None:
    SERVING_ROLLOUT_PROMOTIONS.inc()
    SERVING_ROLLOUT_ACTIVE.set(0)
    duration_s = _measurement(event, "duration_s")
    if duration_s is not None:
        SERVING_ROLLOUT_WALL_SECONDS.observe(duration_s)


def _on_serving_alert_firing(event: dict) -> None:
    SERVING_ALERTS_FIRING.set(1, rule=str(event.get("rule", "unknown")))
    SERVING_ALERT_TRANSITIONS.inc()


def _on_serving_alert_resolved(event: dict) -> None:
    SERVING_ALERTS_FIRING.set(0, rule=str(event.get("rule", "unknown")))
    SERVING_ALERT_TRANSITIONS.inc()


_HANDLERS = {
    "retry_attempt": _on_retry_attempt,
    "retry_exhausted": _on_retry_exhausted,
    "batch_skipped": _on_batch_skipped,
    "replica_desync": _on_replica_desync,
    "supervisor_failure": _on_supervisor_failure,
    "watchdog_stall": _on_watchdog_stall,
    "fault_injected": _on_fault_injected,
    "checkpoint_rejected": _on_checkpoint_rejected,
    "serving_first_token": _on_serving_first_token,
    "serving_request_admitted": _on_serving_request_admitted,
    "serving_prefill_chunk": _on_serving_prefill_chunk,
    "serving_prefix_hit": _on_serving_prefix_hit,
    "serving_prefix_miss": _on_serving_prefix_miss,
    "serving_block_alias": _on_serving_block_alias,
    "serving_block_cow": _on_serving_block_cow,
    "serving_spec_verify": _on_serving_spec_verify,
    "serving_request_preempted": _on_serving_request_preempted,
    "serving_request_cancelled": _on_serving_request_cancelled,
    "serving_request_shed": _on_serving_request_shed,
    "serving_request_finished": _on_serving_request_finished,
    "serving_tp_step": _on_serving_tp_step,
    "serving_weights_loaded": _on_serving_weights_loaded,
    "serving_weights_swapped": _on_serving_weights_swapped,
    "serving_fleet_routed": _on_serving_fleet_routed,
    "serving_fleet_replica_state": _on_serving_fleet_replica_state,
    "serving_fleet_failover": _on_serving_fleet_failover,
    "serving_fleet_resumed": _on_serving_fleet_resumed,
    "serving_fleet_shed": _on_serving_fleet_shed,
    "serving_rollout_started": _on_serving_rollout_started,
    "serving_rollout_replica_upgraded":
        _on_serving_rollout_replica_upgraded,
    "serving_rollout_canary_verdict": _on_serving_rollout_canary_verdict,
    "serving_rollout_halted": _on_serving_rollout_halted,
    "serving_rollout_rolled_back": _on_serving_rollout_rolled_back,
    "serving_rollout_promoted": _on_serving_rollout_promoted,
    "serving_quant_eval": _on_serving_quant_eval,
    "serving_alert_firing": _on_serving_alert_firing,
    "serving_alert_resolved": _on_serving_alert_resolved,
}


def _bridge_sink(event: dict) -> None:
    kind = str(event.get("event", "unknown"))
    EVENTS_TOTAL.inc(event=kind)
    live = trace.current_span()
    if live is not None:
        live.add_event(kind)
    handler = _HANDLERS.get(kind)
    if handler is not None:
        handler(event)


def install() -> None:
    """Subscribe the bridge sink (idempotent; on by default via
    ``import apex_tpu_torch.obs``)."""
    _logging.add_event_sink(_bridge_sink)


def uninstall() -> None:
    """Unsubscribe the bridge sink (events stop feeding the registry;
    already-accumulated series are untouched)."""
    _logging.remove_event_sink(_bridge_sink)


def installed() -> bool:
    return _bridge_sink in _logging.event_sinks()
