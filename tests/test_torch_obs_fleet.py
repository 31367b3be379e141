"""Fleet-wide observability on the port, against the JAX package's:
per-replica metric attribution, cross-replica request traces and the SLO
alert engine driven by the fleet router's step.

The model is a small JAX ``LlamaForCausalLM`` (2 layers, hidden 64, 4
heads over 2 kv heads, vocab 128, fp32) carried to the port by
``models/convert.py``; the port's replicas are engines over one shared
module.  The JAX package's ``tests/test_obs_fleet.py`` fleet cases (its
alert-engine and scope-label units are ``tests/test_torch_obs.py``'s):
each scenario runs in both packages on one virtual schedule, and the
request records' hop trails, the Chrome trace's replica lanes, the alert
ledger, the per-replica series, the event stream (time stamp aside) and
the metric snapshot equal JAX's, with the JAX case's own assertions held
on the port's run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu import _logging as jlog
from apex_tpu import obs as jobs
from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.obs import bridge as jbridge
from apex_tpu.resilience import fault_injection as jfi
from apex_tpu_torch import _logging as tlog
from apex_tpu_torch import obs as tobs
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.obs import bridge as tbridge
from apex_tpu_torch.resilience import fault_injection as tfi

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
MAX = 96


class Pkg:
    def __init__(self, name, psv, fi, log, obs, bridge, make_engine):
        self.name, self.sv, self.fi, self.log, self.obs, self.bridge = (
            name, psv, fi, log, obs, bridge)
        self.engines = tuple(make_engine() for _ in range(3))

    def fleet(self):
        for e in self.engines:
            e.reset()
        return self.engines


@pytest.fixture(scope="module")
def pkgs():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    return {
        "jax": Pkg("jax", jsv, jfi, jlog, jobs, jbridge,
                   lambda: jsv.DecodeEngine(jmodel, params, slots=2,
                                            max_len=MAX, prefill_len=32)),
        "port": Pkg("port", sv, tfi, tlog, tobs, tbridge,
                    lambda: sv.DecodeEngine(tmodel, device="cpu", slots=2,
                                            max_len=MAX, prefill_len=32)),
    }


def _prompt(seed, n=8):
    return [int(x) for x in np.random.default_rng(seed).integers(0, 128, n)]


def _named_fleet(P, clk, *, named=True, alerts=None, max_queue=8):
    psv = P.sv
    scheds = {f"r{i}": psv.ContinuousBatchingScheduler(
        e, max_queue=max_queue, log_interval=10 ** 9, clock=clk,
        name=(f"r{i}" if named else None))
        for i, e in enumerate(P.fleet())}
    return psv.FleetRouter(scheds, config=psv.FleetConfig(), alerts=alerts)


class _Tap:
    def __init__(self, P):
        self.log, self.events = P.log, []

    def __enter__(self):
        self._sink = lambda e: self.events.append(dict(e))
        self.log.add_event_sink(self._sink)
        return self

    def __exit__(self, *exc):
        self.log.remove_event_sink(self._sink)

    def of(self, kind):
        return [e for e in self.events if e.get("event") == kind]


def _strip(events, *extra):
    drop = {"time", *extra}
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _records(rec):
    return [(st.rid, st.replica, st.hops, st.finish_reason, st.t_first,
             st.t_finished, st.new_tokens)
            for st in rec.records()]


class TestNaming:
    def test_scheduler_name_validated(self, pkgs):
        for bad in ("", 7):
            with pytest.raises(ValueError, match="non-empty string"):
                sv.ContinuousBatchingScheduler(pkgs["port"].fleet()[0],
                                               name=bad)

    def test_fleet_rejects_duplicate_scheduler_names(self, pkgs):
        e0, e1, _ = pkgs["port"].fleet()
        clk = sv.VirtualClock()
        s0 = sv.ContinuousBatchingScheduler(e0, clock=clk, name="twin")
        s1 = sv.ContinuousBatchingScheduler(e1, clock=clk, name="twin")
        with pytest.raises(ValueError, match="unique names"):
            sv.FleetRouter({"a": s0, "b": s1})


def _reconciliation_run(P):
    psv, obs, bridge = P.sv, P.obs, P.bridge
    obs.metrics.reset()
    clk = psv.VirtualClock()
    router = _named_fleet(P, clk)
    n = 6
    wl = psv.make_workload([_prompt(400 + i) for i in range(n)],
                           psv.uniform_arrivals(n, 12.0), max_new_tokens=4,
                           deadline_s=30.0, rid_prefix="rc")
    with obs.recording_requests(clock=clk) as rec:
        out = psv.LoadGenerator(router, wl, step_time_s=0.25).run()
    assert out.completed == n
    names = ("r0", "r1", "r2")
    for metric in (bridge.SERVING_TTFT, bridge.SERVING_QUEUE_WAIT,
                   bridge.SERVING_PER_TOKEN):
        agg = metric.count()
        assert agg == sum(metric.count(replica=r) for r in names) == n
        assert metric.sum() == pytest.approx(
            sum(metric.sum(replica=r) for r in names), rel=1e-12)
    assert sum(bridge.SERVING_FLEET_ROUTED.value(replica=r)
               for r in names) == n
    reports = router.replica_reports(rec.records(), deadlines=out.deadlines,
                                     arrivals=out.arrivals,
                                     duration_s=out.duration_s)
    per = {k: v for k, v in reports.items() if k != "fleet"}
    assert sum(r.completed for r in per.values()) == n
    for name, rep in per.items():
        assert rep.ttft["n"] == bridge.SERVING_TTFT.count(
            replica=name) == rep.completed
        assert rep.queue_wait["n"] == bridge.SERVING_QUEUE_WAIT.count(
            replica=name)
    snap = {k: v for k, v in obs.snapshot().items()
            if k.startswith("apex_serving_")}
    snap.pop("apex_serving_decode_compiles", None)
    return {k: (v.completed, v.ttft, v.tpot, v.queue_wait)
            for k, v in reports.items()}, snap, _records(rec)


def test_clean_drain_reconciles_exactly_and_equals_jax(pkgs):
    """Every ``{replica=...}`` series sums to its fleet aggregate, the
    per-replica reports match the labeled histograms, and reports,
    records and the serving snapshot are JAX's."""
    assert _reconciliation_run(pkgs["port"]) == \
        _reconciliation_run(pkgs["jax"])


class TestFleetChaosObservability:
    N = 12
    KILL_STEP = 6
    TTFT_GOOD_S = 0.3

    def _rules(self, P, clk):
        obs = P.obs
        return obs.AlertEngine(
            [obs.ThresholdRule("replica_down",
                               "apex_serving_fleet_replicas_healthy", "<", 3),
             obs.BurnRateRule(
                 "goodput_burn",
                 good=obs.Selector("apex_serving_ttft_seconds",
                                   le=self.TTFT_GOOD_S),
                 total=obs.Selector("apex_serving_ttft_seconds"),
                 objective=0.99, long_window_s=2.0, short_window_s=0.5,
                 factor=8.0)],
            clock=clk)

    def _chaos_run(self, P):
        psv, obs = P.sv, P.obs
        obs.metrics.reset()
        clk = psv.VirtualClock()
        alerts = self._rules(P, clk)
        router = _named_fleet(P, clk, alerts=alerts)
        wl = psv.make_workload([_prompt(100 + i) for i in range(self.N)],
                               psv.uniform_arrivals(self.N, 8.0),
                               max_new_tokens=5, deadline_s=60.0,
                               rid_prefix="fo")
        fault = P.fi.KillReplica("r0", at_step=self.KILL_STEP)
        with obs.recording_requests(clock=clk) as rec, _Tap(P) as tap:
            out = psv.LoadGenerator(router, wl, step_time_s=0.25,
                                    step_hook=fault).run()
            assert fault.killed and router.replicas_healthy == 2
            router.replace("r0", psv.ContinuousBatchingScheduler(
                router.replica("r0").engine, max_queue=8,
                log_interval=10 ** 9, clock=clk, name="r0"))
            for _ in range(12):
                router.step()
                clk.advance(0.25)
        return out, rec, tap, alerts

    def _check(self, P, out, rec, tap, alerts):
        psv, obs, bridge = P.sv, P.obs, P.bridge
        names = ("r0", "r1", "r2")
        assert out.rejected == []
        for rid, res in out.results.items():
            assert res.finish_reason in psv.SERVED_REASONS, rid
        records = rec.records()
        assert len(records) == self.N
        assert all(st.hops and st.hops[0]["kind"] == "placed"
                   and st.replica in names for st in records)
        victims = [st for st in records
                   if any(h["kind"] == "failover" for h in st.hops)]
        assert victims
        for st in victims:
            kinds = [h["kind"] for h in st.hops]
            assert kinds.index("failover") > kinds.index("placed")
            resumed = [h for h in st.hops if h["kind"] == "resumed"]
            assert resumed[-1]["from_replica"] == "r0"
            assert st.replica == resumed[-1]["replica"] != "r0"
        trace = rec.to_chrome_trace()
        evs = trace["traceEvents"]
        base = obs.RequestTraceRecorder.REPLICA_TID_BASE
        lanes = {e["args"]["name"]: e["tid"] for e in evs
                 if e.get("ph") == "M" and e["name"] == "thread_name"
                 and e["tid"] >= base}
        assert lanes == {f"replica {r}": base + i
                         for i, r in enumerate(names)}
        assert any(e["name"] == "health:dead"
                   and e["tid"] == lanes["replica r0"]
                   for e in evs if e.get("ph") == "i")
        spans = [e for e in evs if e.get("ph") == "X"
                 and e["name"] == victims[0].rid and e["tid"] >= base]
        assert len({e["tid"] for e in spans}) >= 2
        for metric in (bridge.SERVING_TTFT, bridge.SERVING_QUEUE_WAIT,
                       bridge.SERVING_PER_TOKEN):
            assert metric.count() == sum(metric.count(replica=r)
                                         for r in names)
        ledger = alerts.ledger
        by_rule = {r: [e["transition"] for e in ledger if e["rule"] == r]
                   for r in ("replica_down", "goodput_burn")}
        assert by_rule["replica_down"] == ["firing", "resolved"]
        assert by_rule["goodput_burn"][:1] == ["firing"]
        assert by_rule["goodput_burn"][-1] == "resolved"
        assert alerts.firing() == []
        down = [e for e in ledger if e["rule"] == "replica_down"]
        assert down[0]["t"] == pytest.approx((self.KILL_STEP + 1) * 0.25)
        assert bridge.SERVING_ALERT_TRANSITIONS.value() == len(ledger)
        assert len(tap.of("serving_alert_firing")) + len(
            tap.of("serving_alert_resolved")) == len(ledger)
        return trace

    def test_chaos_traces_lanes_alerts_and_reconciliation(self, pkgs):
        got = {}
        for name in ("jax", "port"):
            P = pkgs[name]
            out, rec, tap, alerts = self._chaos_run(P)
            trace = self._check(P, out, rec, tap, alerts)
            snap = {k: v for k, v in P.obs.snapshot().items()
                    if k.startswith("apex_serving_")
                    or k == "apex_events_total"}
            snap.pop("apex_serving_decode_compiles", None)
            got[name] = dict(
                ledger=alerts.ledger, records=_records(rec),
                tokens={r: list(v.tokens) for r, v in out.results.items()},
                events=_strip(tap.events), snap=snap,
                lanes=[(e.get("ph"), e.get("name"), e.get("tid"),
                        e.get("ts"), e.get("dur"))
                       for e in trace["traceEvents"]])
        for key in got["port"]:
            assert got["port"][key] == got["jax"][key], key
        # the rerun's ledger and streams are the same
        out2, _, _, alerts2 = self._chaos_run(pkgs["port"])
        assert alerts2.ledger == got["port"]["ledger"]
        assert {r: list(v.tokens) for r, v in out2.results.items()} == \
            got["port"]["tokens"]


class TestDefaultOffIdentity:
    def _run(self, P, *, named, instrumented=False):
        psv, obs = P.sv, P.obs
        obs.metrics.reset()
        clk = psv.VirtualClock()
        alerts = (obs.AlertEngine([obs.ThresholdRule(
            "replica_down", "apex_serving_fleet_replicas_healthy", "<", 3)],
            clock=clk) if instrumented else None)
        router = _named_fleet(P, clk, named=named, alerts=alerts)
        wl = psv.make_workload([_prompt(300 + i) for i in range(6)],
                               psv.uniform_arrivals(6, 6.0), max_new_tokens=3,
                               deadline_s=30.0, rid_prefix="id")
        rec = (obs.RequestTraceRecorder(clock=clk).install()
               if instrumented else None)
        try:
            with _Tap(P) as tap:
                out = psv.LoadGenerator(router, wl, step_time_s=0.25).run()
        finally:
            if rec is not None:
                rec.uninstall()
        assert out.completed == 6
        return tap.events, obs.snapshot(), rec, alerts

    def test_unattributed_run_is_byte_identical(self, pkgs):
        P = pkgs["port"]
        ev1, snap1, _, _ = self._run(P, named=False)
        ev2, snap2, _, _ = self._run(P, named=False)
        assert _strip(ev1) == _strip(ev2) and snap1 == snap2
        for e in ev1:
            if e["event"].startswith("serving_request"):
                assert "replica" not in e, e["event"]
        for series in snap1["apex_serving_ttft_seconds"]["series"]:
            assert series["labels"] == {}
        jev, _, _, _ = self._run(pkgs["jax"], named=False)
        assert _strip(ev1) == _strip(jev)

    def test_attribution_is_the_only_delta(self, pkgs):
        P = pkgs["port"]
        ev_plain, _, _, _ = self._run(P, named=False)
        ev_inst, _, rec, alerts = self._run(P, named=True,
                                            instrumented=True)
        assert alerts.ledger == []
        assert _strip(ev_inst, "replica") == _strip(ev_plain, "replica")
        finished = [e for e in ev_inst
                    if e["event"] == "serving_request_finished"]
        assert finished and all(e["replica"] in ("r0", "r1", "r2")
                                for e in finished)
        records = rec.records()
        assert len(records) == 6
        assert all(st.replica in ("r0", "r1", "r2") for st in records)
        jev, _, _, _ = self._run(pkgs["jax"], named=True, instrumented=True)
        assert _strip(ev_inst) == _strip(jev)
