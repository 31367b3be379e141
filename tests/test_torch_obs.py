"""apex_tpu_torch.obs and apex_tpu_torch._logging against the JAX package.

The observability layer is host code copied from ``apex_tpu.obs`` and
``apex_tpu._logging`` with JAX taken out, so each test runs the same
operations through both packages and holds the outputs equal: metric
snapshots, the Prometheus text byte for byte, the JSON export apart from
its ``time`` stamp, histogram quantiles, the Chrome-trace structure of
nested spans, the sink registry's behaviour, the default log line's JSON
byte for byte, the request recorder's records and exports over one
synthetic serving and fleet event stream, the SLO report, and an alert
engine's ledger.  The two packages keep separate registries and sink
lists; each test feeds both the same thing and never lets one package's
sink see the other's events.  No model, no engine.
"""

import json
import logging

import pytest

from apex_tpu import _logging as jlog
from apex_tpu import obs as jobs
from apex_tpu_torch import _logging as tlog
from apex_tpu_torch import obs as tobs

BOTH = (("jax", jlog, jobs), ("torch", tlog, tobs))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _drive_registry(obs):
    """The same registrations and updates on a fresh registry of
    ``obs``'s package; returns it."""
    reg = obs.MetricsRegistry()
    reg.declare_scope("replica", 2)
    c = reg.counter("apex_unit_requests_total", "requests by route",
                    ("route",))
    g = reg.gauge("apex_unit_depth", "queue depth", scope_labels=("replica",))
    h = reg.histogram("apex_unit_latency_seconds", "latency",
                      scope_labels=("replica",))
    hb = reg.histogram("apex_unit_size_bytes", "sizes",
                       buckets=(1.0, 10.0, 100.0), labelnames=("kind",))
    for i in range(7):
        c.inc(route="a" if i % 3 else "b")
        c.inc(0.5 * i, route="c")
    g.set(3.0)
    g.set(1.0, replica="r0")
    g.inc(2.5, replica="r1")
    g.dec(0.5, replica="r1")
    for v in (0.001, 0.02, 0.02, 0.3, 4.0, 1e3):
        h.observe(v)
        h.observe(v / 2, replica="r0")
    with pytest.raises(ValueError, match="non-finite"):
        h.observe(float("inf"))
    for v in (0.5, 5.0, 50.0, 500.0):
        hb.observe(v, kind="x" if v < 10 else "y")
    reg.gauge("apex_unit_fn_value", "from a function").set_function(
        lambda: 42.0)
    return reg


def test_metric_updates_match_jax(tmp_path):
    jreg, treg = _drive_registry(jobs), _drive_registry(tobs)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.prometheus_text() == jreg.prometheus_text()
    jpay = jreg.write_json(str(tmp_path / "j.json"))
    tpay = treg.write_json(str(tmp_path / "t.json"))
    jpay.pop("time"), tpay.pop("time")
    assert tpay == jpay
    jfile = json.loads((tmp_path / "j.json").read_text())
    tfile = json.loads((tmp_path / "t.json").read_text())
    jfile.pop("time"), tfile.pop("time")
    assert tfile == jfile


def test_scope_bound_and_reregistration_match_jax():
    outcomes = []
    for _, _, obs in BOTH:
        reg = obs.MetricsRegistry()
        reg.declare_scope("replica", 1)
        g = reg.gauge("apex_unit_scoped", "x", scope_labels=("replica",))
        g.set(1.0, replica="a")
        with pytest.raises(ValueError) as err:
            g.set(1.0, replica="b")
        same = reg.gauge("apex_unit_scoped", "x", scope_labels=("replica",))
        with pytest.raises(ValueError) as conflict:
            reg.counter("apex_unit_scoped_total", "y")
            reg.gauge("apex_unit_scoped", "x", ("other",))
        outcomes.append((same is g, str(err.value), str(conflict.value)))
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0])
def test_histogram_quantile_matches_jax(q):
    got = []
    for _, _, obs in BOTH:
        h = obs.Histogram("apex_unit_q_seconds", buckets=obs.LATENCY_BUCKETS_S)
        for i in range(200):
            h.observe(1e-4 * (1.07 ** i))
        got.append(h.quantile(q))
    assert got[1] == got[0]
    assert tobs.LATENCY_BUCKETS_S == jobs.LATENCY_BUCKETS_S


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _span_tree(logmod, obs):
    """Nested spans with attributes and stamped events under a recorder;
    returns (name, parent name, args without ids) per span."""
    rec = obs.TraceRecorder()
    obs.install_recorder(rec)
    try:
        with obs.span("step", step=3):
            with obs.span("forward", layers=2):
                obs.current_span().add_event("marker")
            with obs.span("optimizer", lr=0.5):
                with obs.span("allreduce"):
                    pass
    finally:
        obs.uninstall_recorder()
    events = rec.to_chrome_trace()["traceEvents"]
    by_id = {e["args"]["span_id"]: e["name"] for e in events}
    out = []
    for e in sorted(events, key=lambda e: e["args"]["span_id"]):
        args = dict(e["args"])
        args.pop("span_id")
        parent = args.pop("parent_id", None)
        # stamped events keep their names; their times are the clock's
        args["events"] = [ev["name"] for ev in args.get("events", [])]
        out.append((e["name"], e["ph"], e["cat"],
                    None if parent is None else by_id[parent], args))
    return out


def test_nested_spans_give_jax_chrome_structure():
    assert _span_tree(tlog, tobs) == _span_tree(jlog, jobs)


def test_span_without_recorder_is_inert():
    for _, _, obs in BOTH:
        with obs.span("free") as live:
            assert live is None and obs.current_span() is None
    with tobs.recording() as rec:
        with tobs.span("kept") as live:
            assert tobs.current_span() is live
    assert [e["name"] for e in rec.to_chrome_trace()["traceEvents"]] == [
        "kept"]


def test_trace_export_parses(tmp_path):
    rec = tobs.TraceRecorder()
    tobs.install_recorder(rec)
    try:
        with tobs.span("outer", loss=float("nan")):
            with tobs.span("inner"):
                pass
    finally:
        tobs.uninstall_recorder()
    payload = rec.export(str(tmp_path / "t.json"))
    loaded = json.loads((tmp_path / "t.json").read_text())
    assert loaded == payload
    assert {e["name"] for e in loaded["traceEvents"]} == {"outer", "inner"}
    outer = next(e for e in loaded["traceEvents"] if e["name"] == "outer")
    assert outer["args"]["loss"] is None


def test_torch_profiler_hook_round_trip(tmp_path):
    """The JAX package's ``jax.profiler`` hook becomes
    ``start_torch_profiler`` / ``stop_torch_profiler`` with its contract:
    idempotent start, a stop with nothing running returns False, and the
    stop writes a Chrome trace into the log directory."""
    from apex_tpu_torch.obs import trace

    assert trace.stop_torch_profiler() is False
    assert trace.start_torch_profiler(str(tmp_path)) is True
    try:
        assert trace.start_torch_profiler(str(tmp_path)) is False
        import torch
        torch.ones(8).sum()
    finally:
        assert trace.stop_torch_profiler() is True
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
    hook = trace.profile_on_stall(str(tmp_path / "stall"))
    hook({"step": 7})
    assert trace.stop_torch_profiler() is True


# ---------------------------------------------------------------------------
# _logging: the sink registry and the default log line
# ---------------------------------------------------------------------------

def _sink_registry_behaviour(logmod):
    seen = []
    calls = []

    def sink(event):
        seen.append(event["event"])

    def bad(event):
        calls.append(event["event"])
        raise RuntimeError("broken sink")

    n0 = len(logmod.event_sinks())
    logmod.add_event_sink(sink)
    logmod.add_event_sink(sink)                 # idempotent
    logmod.add_event_sink(bad)
    try:
        grown = len(logmod.event_sinks()) - n0
        out = logmod.emit_event("unit_event", a=1)
    finally:
        logmod.remove_event_sink(sink)
        logmod.remove_event_sink(sink)          # no-op when absent
        logmod.remove_event_sink(bad)
    logmod.emit_event("after_removal")
    return (grown, seen, calls, sorted(out), len(logmod.event_sinks()) - n0)


def test_sink_registry_behaves_like_jax():
    assert _sink_registry_behaviour(tlog) == _sink_registry_behaviour(jlog)
    assert tlog.event_sinks()[0] is tlog._log_sink


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("fields", [
    dict(rid="r0", prompt_tokens=12, queue_depth=3),
    dict(finish_reason="eos", tokens_per_s=12.5, per_token_ms=3.25,
         weights_step=None, nested={"b": [1, 2.5], "a": None}),
    dict(obj=object.__name__, value=float("inf"), t=(1, 2)),
], ids=["queued", "finished", "odd_values"])
def test_default_log_line_json_is_jax_bytes(fields, monkeypatch):
    monkeypatch.setattr(jlog.time, "time", lambda: 1700000000.125)
    lines = []
    for logger_name, logmod in (("apex_tpu.events", jlog),
                                ("apex_tpu_torch.events", tlog)):
        logger = logging.getLogger(logger_name)
        cap = _Capture()
        level = logger.level
        logger.addHandler(cap)
        logger.setLevel(logging.INFO)
        try:
            event = logmod.emit_event("serving_unit", t0=None, **fields)
        finally:
            logger.removeHandler(cap)
            logger.setLevel(level)
        assert cap.messages == [json.dumps(event, sort_keys=True,
                                           default=str)]
        lines.append(cap.messages[0])
    assert lines[1] == lines[0]


def test_rank_info_and_loggers():
    assert tlog._rank_info() == "p0"
    assert tlog.get_logger("obs").name == "apex_tpu_torch.obs"
    handlers = logging.getLogger("apex_tpu_torch").handlers
    assert tlog._HANDLER in handlers
    assert not logging.getLogger("apex_tpu_torch").propagate


# ---------------------------------------------------------------------------
# request traces and SLO reports over one synthetic event stream
# ---------------------------------------------------------------------------

#: (virtual time, kind, fields): three served requests (a prefix hit, a
#: speculative one, a preempted and resumed one), a cancelled and a shed
#: one, and a fleet run's hops and bands (routed, failover, resumed,
#: health transitions, rollout milestones and a weight swap)
STREAM = [
    (0.0, "serving_request_queued", dict(rid="a", prompt_tokens=40)),
    (0.0, "serving_request_queued", dict(rid="b", prompt_tokens=20)),
    (0.0, "serving_fleet_routed", dict(rid="a", replica="r0", retries=0,
                                       weights_step=100)),
    (0.25, "serving_request_admitted", dict(rid="a", slot=0, queue_wait_s=0.25,
                                            prompt_tokens=40)),
    (0.25, "serving_prefix_hit", dict(rid="a", saved_tokens=32, blocks=2,
                                      duration_s=0.0)),
    (0.25, "serving_block_alias", dict(rid="a", blocks=2, saved_tokens=32)),
    (0.25, "serving_prefill_chunk", dict(rid="a", bucket=8, chunk_tokens=8,
                                         offset_tokens=32, duration_s=0.125)),
    (0.25, "serving_first_token", dict(rid="a", ttft_s=0.25)),
    (0.25, "serving_request_admitted", dict(rid="b", slot=1, queue_wait_s=0.25)),
    (0.25, "serving_prefix_miss", dict(rid="b", prompt_tokens=20)),
    (0.5, "serving_prefill_chunk", dict(rid="b", bucket=16, chunk_tokens=16,
                                        offset_tokens=0, duration_s=0.25)),
    (0.5, "serving_fleet_replica_state", dict(replica="r0", state="suspect",
                                              from_state="healthy")),
    (0.75, "serving_prefill_chunk", dict(rid="b", bucket=4, chunk_tokens=4,
                                         offset_tokens=16, duration_s=0.0625)),
    (0.75, "serving_first_token", dict(rid="b", ttft_s=0.75)),
    (0.75, "serving_fleet_failover", dict(rid="a", replica="r0",
                                          mode="capture-resume",
                                          new_tokens=3)),
    (0.75, "serving_fleet_resumed", dict(rid="a", replica="r1",
                                         from_replica="r0",
                                         mode="capture-resume",
                                         duration_s=0.001)),
    (1.0, "serving_spec_verify", dict(rid="b", bucket=2, drafted=2, accepted=1,
                                      emitted=2, duration_s=0.0)),
    (1.0, "serving_request_queued", dict(rid="c", prompt_tokens=8)),
    (1.0, "serving_request_queued", dict(rid="d", prompt_tokens=8)),
    (1.0, "serving_request_queued", dict(rid="e", prompt_tokens=8)),
    (1.25, "serving_request_preempted", dict(rid="b", slot=1, priority=0,
                                             by_priority=5, new_tokens=3,
                                             cached_tokens=23)),
    (1.25, "serving_request_admitted", dict(rid="c", slot=1, queue_wait_s=0.25)),
    (1.25, "serving_request_cancelled", dict(rid="d", phase="queued",
                                             new_tokens=0)),
    (1.25, "serving_rollout_started", dict(step=200)),
    (1.5, "serving_rollout_replica_upgraded", dict(replica="r1", step=200,
                                                   swap_s=0.125)),
    (1.5, "serving_first_token", dict(rid="c", ttft_s=0.5)),
    (1.5, "serving_request_finished", dict(rid="c", finish_reason="length",
                                           new_tokens=1, tokens_per_s=2.0,
                                           per_token_ms=0.0)),
    (1.75, "serving_request_resumed", dict(rid="b", slot=1, cached_tokens=23,
                                           suspended_s=0.5)),
    (1.75, "serving_request_shed", dict(rid="e", deadline_s=0.5, waited_s=0.75,
                                        new_tokens=0, queue_depth=1)),
    (2.0, "serving_rollout_canary_verdict", dict(verdict="pass", step=200,
                                                 duration_s=0.75)),
    (2.0, "serving_weights_swapped", dict(step=200, swap_s=0.0625)),
    (2.25, "serving_request_finished", dict(rid="a", finish_reason="eos",
                                            new_tokens=6, tokens_per_s=2.67,
                                            per_token_ms=300.0)),
    (2.5, "serving_request_finished", dict(rid="b",
                                           finish_reason="preempted-resumed",
                                           new_tokens=6, tokens_per_s=2.4,
                                           per_token_ms=350.0)),
    (2.5, "serving_rollout_promoted", dict(step=200, duration_s=1.25)),
    (2.5, "serving_step", dict(step=10, queue_depth=0)),
    (2.5, "checkpoint_saved", dict(step=1)),
]


def _record_stream(logmod, obs):
    clk = FakeClock()
    rec = obs.RequestTraceRecorder(clock=clk).install()
    try:
        for t, kind, fields in STREAM:
            clk.t = t
            logmod.emit_event(kind, **fields)
    finally:
        rec.uninstall()
    return rec


@pytest.fixture(scope="module")
def recorders():
    return _record_stream(jlog, jobs), _record_stream(tlog, tobs)


def test_recorder_records_match_jax(recorders):
    jrec, trec = recorders
    assert ([r.to_dict() for r in trec.records()]
            == [r.to_dict() for r in jrec.records()])
    assert ([r.to_dict() for r in trec.open_records()]
            == [r.to_dict() for r in jrec.open_records()])
    assert trec.fleet_events() == jrec.fleet_events()
    assert [r.rid for r in trec.records()] == ["d", "c", "e", "a", "b"]


def test_recorder_exports_match_jax(recorders, tmp_path):
    jrec, trec = recorders
    jpay = jrec.export(str(tmp_path / "j.trace.json"))
    tpay = trec.export(str(tmp_path / "t.trace.json"))
    assert tpay == jpay
    assert ((tmp_path / "t.trace.json").read_text()
            == (tmp_path / "j.trace.json").read_text())
    lanes = {e["args"]["name"] for e in tpay["traceEvents"]
             if e["name"] == "thread_name"}
    assert {"replica r0", "replica r1", "fleet"} <= lanes
    assert jrec.export_jsonl(str(tmp_path / "j.jsonl")) == 5
    assert trec.export_jsonl(str(tmp_path / "t.jsonl")) == 5
    assert ((tmp_path / "t.jsonl").read_text()
            == (tmp_path / "j.jsonl").read_text())


def test_slo_report_and_percentiles_match_jax(recorders):
    jrec, trec = recorders
    kw = dict(offered=6, deadlines={"a": 3.0, "b": 2.0, "c": 2.0,
                                    "d": None, "e": 0.5, "f": 1.0},
              arrivals={"a": 0.0, "b": 0.0, "c": 1.0, "d": 1.0, "e": 1.0},
              duration_s=2.5)
    jrep = jobs.build_report(jrec.records(), **kw)
    trep = tobs.build_report(trec.records(), **kw)
    assert trep.to_dict() == jrep.to_dict()
    assert trep.to_dict(ndigits=3) == jrep.to_dict(ndigits=3)
    samples = [0.3, 0.001, 2.0, 0.05, 0.05, 7.5, 0.2]
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert tobs.percentile(samples, q) == jobs.percentile(samples, q)
    assert tobs.summarize(samples) == jobs.summarize(samples)
    jh = jobs.Histogram("apex_unit_x_seconds")
    th = tobs.Histogram("apex_unit_x_seconds")
    for v in samples:
        jh.observe(v)
        th.observe(v)
    assert (tobs.crosscheck_quantiles(samples, th)
            == jobs.crosscheck_quantiles(samples, jh))
    th.observe(1.0)
    jh.observe(1.0)
    assert (tobs.crosscheck_quantiles(samples, th)
            == jobs.crosscheck_quantiles(samples, jh))


def test_recorder_units_behave_like_jax():
    """The JAX recorder's unit behaviours (a bound with counted drops,
    stray events fabricating nothing, the context manager, idempotent
    install), run on both packages."""
    def run(logmod, obs):
        rec = obs.RequestTraceRecorder(max_requests=2).install()
        try:
            for i in range(4):
                logmod.emit_event("serving_request_queued", rid=f"r{i}",
                                  prompt_tokens=1)
                logmod.emit_event("serving_request_admitted", rid=f"r{i}",
                                  slot=0)
            logmod.emit_event("serving_request_finished", rid="ghost",
                              new_tokens=3)
            logmod.emit_event("serving_step", step=1)
        finally:
            rec.uninstall()
        with pytest.raises(ValueError):
            obs.RequestTraceRecorder(max_requests=0)
        with obs.recording_requests() as ctx:
            ctx.install()
            assert ctx.installed()
            logmod.emit_event("serving_request_queued", rid="x",
                              prompt_tokens=2)
        return (len(rec.open_records()), rec.dropped,
                rec.to_chrome_trace().get("otherData"),
                ctx.installed(), len(ctx.open_records()))

    assert run(tlog, tobs) == run(jlog, jobs)


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------

def _alert_ledger(obs):
    reg = obs.MetricsRegistry()
    healthy = reg.gauge("apex_serving_fleet_replicas_healthy", "up")
    ttft = reg.histogram("apex_serving_ttft_seconds", "ttft")
    beat = reg.counter("apex_unit_beats_total", "heartbeats")
    clk = FakeClock()
    engine = obs.AlertEngine([
        obs.ThresholdRule("replica_down",
                          "apex_serving_fleet_replicas_healthy", "<", 3,
                          for_duration_s=0.5),
        obs.AbsenceRule("no_beats", "apex_unit_beats_total",
                        stale_after_s=1.0),
        obs.BurnRateRule(
            "goodput_burn",
            good=obs.Selector("apex_serving_ttft_seconds", le=0.3),
            total=obs.Selector("apex_serving_ttft_seconds"),
            objective=0.9, long_window_s=2.0, short_window_s=0.5,
            factor=2.0),
    ], clock=clk, registry=reg)
    transitions = []
    for step in range(24):
        clk.t = 0.25 * step
        healthy.set(3 if step < 4 or step > 12 else 2)
        if step < 6 or step > 14:
            beat.inc()
        ttft.observe(0.1 if step < 8 or step > 16 else 1.5)
        transitions.append(engine.evaluate())
    return engine.ledger, transitions, engine.firing()


def test_alert_engine_ledger_matches_jax():
    jledger, jtrans, jfiring = _alert_ledger(jobs)
    tledger, ttrans, tfiring = _alert_ledger(tobs)
    assert tledger == jledger
    assert ttrans == jtrans
    assert tfiring == jfiring
    kinds = {(e["rule"], e["transition"]) for e in tledger}
    assert ("replica_down", "firing") in kinds
    assert ("replica_down", "resolved") in kinds


def test_condition_compare_matches_jax():
    for op in ("<", "<=", ">", ">=", "==", "!="):
        for v in (1.0, 2.0, 3.0):
            assert (tobs.Condition(op, 2.0).holds(v)
                    == jobs.Condition(op, 2.0).holds(v))
    for obs in (jobs, tobs):
        with pytest.raises(ValueError):
            obs.Condition("~", 1.0)


def test_bridge_inventory_names_match_jax():
    """Every metric the JAX bridge declares, the port's declares with the
    same kind, labels, help and buckets (the lint test checks the source;
    this checks the live objects)."""
    def inventory(reg):
        out = {}
        for name in reg.names():
            m = reg.get(name)
            out[name] = (type(m).__name__, m.help, m.labelnames,
                         m.scope_labels, getattr(m, "buckets", None))
        return out

    jinv = inventory(jobs.REGISTRY)
    tinv = inventory(tobs.REGISTRY)
    from apex_tpu_torch.obs import bridge
    for name in (n for n in dir(bridge) if n.isupper()):
        metric = getattr(bridge, name)
        if hasattr(metric, "name"):
            assert tinv[metric.name] == jinv[metric.name], metric.name
