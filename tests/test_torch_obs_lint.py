"""The metric and event lints of ``tools/`` run over apex_tpu_torch.

``tools/check_metrics.py`` and ``tools/check_events.py`` scan
``apex_tpu/`` only; these tests call their functions on the port's
files instead, and hold the port's inventory to the JAX package's:

- every metric the port registers obeys the naming, suffix and
  single-registration rules (the documentation rule is left out: the
  docs describe the JAX package, and the inventory check below covers
  the port's names through JAX's), is registered by JAX with the same
  kind, labels, scope labels and help in the twin of the same file, and
  every metric the JAX bridge declares the port's bridge declares too;
- the metrics JAX registers outside its bridge are registered by the
  port's twin of their file (the checkpoint layer's and the
  supervisor's), or wait for the slice that ports it, listed here;
- every event kind the port emits is one the JAX package emits, and has
  a bridge handler or an entry in the event lint's allowlist.
"""

import os
import sys
from collections import defaultdict
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import check_events  # noqa: E402
import check_metrics  # noqa: E402

#: metrics the JAX package registers outside ``obs/bridge.py`` whose
#: file the port has ported: registered by the port's twin of that file
PORTED_ELSEWHERE = {
    "apex_tpu/resilience/checkpoint.py": {"apex_checkpoint_duration_seconds"},
    "apex_tpu/resilience/async_checkpoint.py": {
        "apex_checkpoint_inflight", "apex_checkpoint_backpressure_total"},
    "apex_tpu/resilience/supervisor.py": {
        "apex_step_duration_seconds", "apex_supervisor_steps_total",
        "apex_heartbeat_age_seconds"},
}

#: ...and those whose file waits for a later slice: none since the
#: training-side resilience slice ported the supervisor's instruments
WAITING = {}

#: event kinds the port's bridge handles that nothing in the port emits:
#: none since the guarded step, replica consistency and the supervisor's
#: watchdog came with the training-side resilience slice
HANDLED_NOT_YET_EMITTED = set()


def _sources(package):
    for path in sorted((ROOT / package).rglob("*.py")):
        yield path, os.path.relpath(path, ROOT)


@pytest.fixture(scope="module")
def port_regs():
    regs = []
    for path, rel in _sources("apex_tpu_torch"):
        regs.extend(check_metrics.collect_from_source(path.read_text(), rel))
    return regs


@pytest.fixture(scope="module")
def jax_regs():
    return check_metrics.collect()


def test_port_metrics_pass_the_metric_lint(port_regs):
    assert port_regs, "the scan found no registration in apex_tpu_torch/"
    problems = check_metrics.check(port_regs, doc_text=None)
    missing_doc = [p for p in problems if p.startswith("missing ")]
    assert len(missing_doc) == 1          # the documentation rule, left out
    assert [p for p in problems if p not in missing_doc] == []


def test_every_port_metric_is_a_jax_metric(port_regs, jax_regs):
    jax_by_name = {r.name: r for r in jax_regs}
    for r in port_regs:
        ref = jax_by_name.get(r.name)
        assert ref is not None, f"{r.name} is not a JAX metric"
        # registered in the port's twin of the JAX file
        assert r.relpath == ref.relpath.replace("apex_tpu", "apex_tpu_torch",
                                                1), r
        assert (r.kind, r.labels) == (ref.kind, ref.labels), r.name


def test_jax_bridge_inventory_is_the_ports(port_regs, jax_regs):
    bridge = os.path.join("apex_tpu", "obs", "bridge.py")
    jax_bridge = [(r.name, r.kind, r.labels) for r in jax_regs
                  if r.relpath == bridge]
    port = [(r.name, r.kind, r.labels) for r in port_regs
            if r.relpath == os.path.join("apex_tpu_torch", "obs",
                                         "bridge.py")]
    assert port == jax_bridge             # same names, same order


def test_live_instruments_match_jax():
    """Help text, label names, scope labels and buckets of every live
    instrument the port registers (its bridge and its checkpoint layer),
    against JAX's."""
    import apex_tpu.resilience.async_checkpoint  # noqa: F401
    import apex_tpu_torch.resilience.async_checkpoint  # noqa: F401
    from apex_tpu.obs import REGISTRY as JREG
    from apex_tpu_torch.obs import REGISTRY as TREG

    for name in TREG.names():
        t, j = TREG.get(name), JREG.get(name)
        assert j is not None, name
        assert (type(t).__name__, t.help, t.labelnames, t.scope_labels,
                getattr(t, "buckets", None)) == (
            type(j).__name__, j.help, j.labelnames, j.scope_labels,
            getattr(j, "buckets", None)), name


def test_metrics_registered_elsewhere_wait_for_their_slices(port_regs,
                                                            jax_regs):
    bridge = os.path.join("apex_tpu", "obs", "bridge.py")
    elsewhere = defaultdict(set)
    for r in jax_regs:
        if r.relpath != bridge:
            elsewhere[r.relpath].add(r.name)
    assert dict(elsewhere) == {**PORTED_ELSEWHERE, **WAITING}
    port_elsewhere = defaultdict(set)
    for r in port_regs:
        if r.relpath != os.path.join("apex_tpu_torch", "obs", "bridge.py"):
            port_elsewhere[r.relpath.replace("apex_tpu_torch", "apex_tpu",
                                             1)].add(r.name)
    assert dict(port_elsewhere) == PORTED_ELSEWHERE
    ported = {r.name for r in port_regs}
    assert not ported & set().union(*WAITING.values())


def test_pipeline_timers_publish_into_the_bridge_gauge():
    """The pipeline timers (``transformer/pipeline_parallel/_timers.py``,
    ported with the pipeline slice) register no metric of their own in
    either package: ``publish_metrics`` sets the bridge's
    ``apex_timer_seconds`` series, region by region."""
    from apex_tpu_torch.obs import REGISTRY as TREG
    from apex_tpu_torch.obs.bridge import TIMER_SECONDS
    from apex_tpu_torch.transformer.pipeline_parallel._timers import Timers

    for pkg in ("apex_tpu", "apex_tpu_torch"):
        path = ROOT / pkg / "transformer" / "pipeline_parallel" / "_timers.py"
        text = path.read_text()
        assert check_metrics.collect_from_source(
            text, os.path.relpath(path, ROOT)) == []
        assert "TIMER_SECONDS.set(" in text
    timers = Timers("cpu")
    with timers("lint-probe").timing():
        pass
    snap = timers.publish_metrics()
    assert TREG.get("apex_timer_seconds") is TIMER_SECONDS
    assert TIMER_SECONDS.value(region="lint-probe") == snap[
        "lint-probe"]["total_s"]


def _emits(package):
    out = []
    for path, rel in _sources(package):
        out.extend(check_events.collect_emits_from_source(
            path.read_text(), rel))
    return out


def test_port_event_kinds_are_jax_kinds_and_bridged():
    port = _emits("apex_tpu_torch")
    assert port and all(e.literal for e in port), [
        e for e in port if not e.literal]
    port_kinds = {e.kind for e in port}
    jax_kinds = {e.kind for e in check_events.collect_emits()}
    assert port_kinds <= jax_kinds, port_kinds - jax_kinds
    handlers = check_events.collect_handlers(
        (ROOT / "apex_tpu_torch" / "obs" / "bridge.py").read_text())
    assert handlers == check_events.collect_handlers(
        (ROOT / "apex_tpu" / "obs" / "bridge.py").read_text())
    # the lint's own rules over the port, with the allowlist cut to what
    # the port emits: no unbridged kind, no stale allowlist entry, and
    # the only dead handlers are those whose emitters wait for a slice
    problems = check_events.check(
        port, handlers,
        allowlist=frozenset(check_events.ALLOWLIST) & port_kinds)
    dead = {p.split("'")[1] for p in problems if "dead handler" in p}
    assert [p for p in problems if "dead handler" not in p] == []
    assert dead == HANDLED_NOT_YET_EMITTED
    assert not dead & port_kinds


def test_serving_kinds_the_port_emits():
    kinds = {e.kind for e in _emits("apex_tpu_torch")}
    assert kinds == {
        "serving_request_queued", "serving_request_admitted",
        "serving_request_preempted", "serving_request_resumed",
        "serving_request_shed", "serving_request_cancelled",
        "serving_prefix_miss", "serving_block_alias", "serving_prefix_hit",
        "serving_prefill_chunk", "serving_first_token",
        "serving_request_finished", "serving_spec_verify", "serving_step",
        "serving_quant_enabled", "serving_block_cow", "serving_quant_eval",
        # tensor-parallel serving
        "serving_tp_step",
        "loadgen_started", "loadgen_request_shed", "loadgen_finished",
        "fault_injected", "serving_alert_firing", "serving_alert_resolved",
        # the weight lifecycle, the fleet and rollouts
        "serving_weights_loaded", "serving_weights_swapped",
        "serving_reload_failed", "serving_fleet_routed",
        "serving_fleet_replica_state", "serving_fleet_failover",
        "serving_fleet_resumed", "serving_fleet_shed",
        "serving_rollout_started", "serving_rollout_replica_upgraded",
        "serving_rollout_canary_verdict", "serving_rollout_halted",
        "serving_rollout_rolled_back", "serving_rollout_promoted",
        # the checkpoint layer and retry
        "checkpoint_snapshot", "checkpoint_saved", "checkpoint_rejected",
        "checkpoint_restored", "checkpoint_backpressure",
        "checkpoint_commit_vetoed", "retry_attempt", "retry_exhausted",
        "retry_recovered",
        # the training side: the data guard, replica consistency, the
        # supervisor and its watchdog, the guarded step's floor trip
        "batch_skipped", "data_stall", "replica_desync",
        "replica_verify_failed", "replica_resync", "supervisor_failure",
        "supervisor_abort", "watchdog_stall", "loss_scale_floor_halved"}
