"""The port's fleet router (``serving/fleet.py``) and its replica faults
(``KillReplica``, ``WedgeReplica``, ``SlowReplica``) against the JAX
package's.

The model is a small JAX ``LlamaForCausalLM`` (2 layers, hidden 64, 4
heads over 2 kv heads, vocab 128, fp32) carried to the port by
``models/convert.py``.  The port's three replicas are engines over ONE
shared module (each serves its own weights); JAX's are three engines over
the same params.  Each case of the JAX package's
``tests/test_serving_fleet.py`` (without its tensor-parallel variant,
``:694-``) runs as a scenario in both packages on the same virtual
schedule: the router's placements, health transitions, failovers,
resumes and sheds — the whole event stream apart from the wall-clock
``time`` stamp — and the results equal JAX's, and the JAX case's own
assertions hold on the port's run.  Streams are held at greedy tier:
every failover victim, captured or replayed, serves the tokens of the
same request run alone on the same package.
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
from apex_tpu.resilience import fault_injection as jfi
from apex_tpu_torch import _logging as tlog
from apex_tpu_torch import obs as tobs
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.resilience import fault_injection as tfi

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
MAX = 96


class Pkg:
    """One package's serving surface, engines and references."""

    def __init__(self, name, psv, fi, log, obs, make_engine):
        self.name, self.sv, self.fi, self.log, self.obs = (
            name, psv, fi, log, obs)
        self.make_engine = make_engine
        self.engines = tuple(make_engine(slots=2) for _ in range(3))
        self._ref = make_engine(slots=1)
        self._memo = {}

    def fleet(self):
        for e in self.engines:
            e.reset()
        return self.engines

    def isolated(self, request):
        """The request's stream run alone on a FIFO scheduler (on a
        virtual clock, so the run's own events are the same in both
        packages)."""
        key = (tuple(request.prompt), request.max_new_tokens,
               request.eos_id, request.temperature, request.top_k,
               request.seed)
        if key not in self._memo:
            self._ref.reset()
            sched = self.sv.ContinuousBatchingScheduler(
                self._ref, max_queue=4, clock=self.sv.VirtualClock())
            sched.submit(self.sv.Request(
                "ref", request.prompt, max_new_tokens=request.max_new_tokens,
                eos_id=request.eos_id, temperature=request.temperature,
                top_k=request.top_k, seed=request.seed))
            self._memo[key] = list(sched.run()["ref"].tokens)
        return self._memo[key]


@pytest.fixture(scope="module")
def pkgs():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))

    def jax_engine(slots, **kw):
        return jsv.DecodeEngine(jmodel, params, slots=slots, max_len=MAX,
                                prefill_len=32, **kw)

    def port_engine(slots, **kw):
        return sv.DecodeEngine(tmodel, device="cpu", slots=slots,
                               max_len=MAX, prefill_len=32, **kw)

    return {"jax": Pkg("jax", jsv, jfi, jlog, jobs, jax_engine),
            "port": Pkg("port", sv, tfi, tlog, tobs, port_engine)}


def _prompt(seed, n=8):
    return [int(x) for x in np.random.default_rng(seed).integers(0, 128, n)]


def _mk_fleet(P, engines, clk, *, max_queue=8, prefix=False, config=None):
    psv = P.sv
    scheds = {
        f"r{i}": psv.ContinuousBatchingScheduler(
            e, max_queue=max_queue, log_interval=10 ** 9, clock=clk,
            prefix_caching=(psv.PrefixCacheConfig() if prefix else None))
        for i, e in enumerate(engines)}
    return psv.FleetRouter(scheds, config=config if config is not None
                           else psv.FleetConfig())


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


def _tokens(results):
    return {rid: (list(r.tokens), r.finish_reason)
            for rid, r in results.items()}


def _both(pkgs, scenario):
    """Run ``scenario(P) -> dict`` in JAX, then in the port; the two
    dicts' ``events`` (time stamp aside) and ``same`` must be equal.
    Returns the port's dict."""
    out = {}
    for name in ("jax", "port"):
        P = pkgs[name]
        with _Tap(P) as tap:
            got = scenario(P)
        got["events"] = tap.events
        out[name] = got
    assert _strip(out["port"]["events"]) == _strip(out["jax"]["events"])
    assert out["port"].get("same") == out["jax"].get("same")
    return out["port"]


# ---------------------------------------------------------------------------
# router units: construction, identity, placement
# ---------------------------------------------------------------------------


class TestFleetUnits:
    def test_config_validation(self):
        with pytest.raises(ValueError, match="suspect_after_s"):
            sv.FleetConfig(suspect_after_s=0.0)
        with pytest.raises(ValueError, match="must exceed"):
            sv.FleetConfig(suspect_after_s=2.0, dead_after_s=1.0)

    def test_router_validation(self, pkgs):
        e0, e1, _ = pkgs["port"].fleet()
        clk = sv.VirtualClock()
        with pytest.raises(ValueError, match="at least one"):
            sv.FleetRouter({})
        s0 = sv.ContinuousBatchingScheduler(e0, clock=clk)
        with pytest.raises(ValueError, match="share the fleet clock"):
            sv.FleetRouter({"a": s0, "b": sv.ContinuousBatchingScheduler(
                e1, clock=sv.VirtualClock())})
        with pytest.raises(ValueError, match="shares an engine"):
            sv.FleetRouter({"a": s0, "b": sv.ContinuousBatchingScheduler(
                e0, clock=clk)})
        with pytest.raises(ValueError, match="unknown replicas"):
            sv.FleetRouter({"a": s0},
                           config=sv.FleetConfig(weights={"zz": 2.0}))

    def test_router_of_one_is_identity(self, pkgs):
        def scenario(P):
            psv = P.sv
            e0 = P.fleet()[0]
            wl = psv.make_workload([_prompt(i) for i in range(5)],
                                   psv.uniform_arrivals(5, 4.0),
                                   max_new_tokens=4, deadline_s=30.0)
            fp = wl.schedule_fingerprint()

            def one_run(wrap):
                e0.reset()
                clk = psv.VirtualClock()
                sched = psv.ContinuousBatchingScheduler(
                    e0, max_queue=8, log_interval=10 ** 9, clock=clk)
                target = psv.FleetRouter({"r0": sched}) if wrap else sched
                return psv.LoadGenerator(target, wl, step_time_s=0.25).run()

            bare, fleet = one_run(False), one_run(True)
            assert wl.schedule_fingerprint() == fp
            assert _tokens(fleet.results) == _tokens(bare.results)
            assert fleet.rejected == bare.rejected
            assert (fleet.completed, fleet.goodput, fleet.steps) == (
                bare.completed, bare.goodput, bare.steps)
            return {"same": (_tokens(fleet.results), fleet.goodput,
                             fleet.steps, fp)}

        _both(pkgs, scenario)

    def test_prefix_affinity_placement_probes_read_only(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk, prefix=True)
            shared = _prompt(7, n=40)
            router.submit(psv.Request("warm", shared, max_new_tokens=2))
            home = router.placement_of("warm")
            router.run()
            assert router.replica(home).prefix_cache.stats()["entries"] > 0
            before = {n: router.replica(n).prefix_cache.stats()
                      for n in router.replica_names}
            hit = psv.Request("hit", shared + [3, 5], max_new_tokens=2)
            router.submit(hit)
            assert router.placement_of("hit") == home
            assert {n: router.replica(n).prefix_cache.stats()
                    for n in router.replica_names} == before
            out = router.run()
            assert list(out["hit"].tokens) == P.isolated(hit)
            for n in router.replica_names:
                router.replica(n).close()
            return {"same": (home, _tokens(out))}

        _both(pkgs, scenario)

    def test_wrr_weights_spread_placements(self, pkgs):
        def scenario(P):
            psv = P.sv
            router = _mk_fleet(P, P.fleet(), psv.VirtualClock(),
                               config=psv.FleetConfig(
                                   weights={"r0": 2.0, "r1": 1.0,
                                            "r2": 1.0}))
            for i in range(8):
                router.submit(psv.Request(f"w{i}", _prompt(20 + i),
                                          max_new_tokens=1))
            placed = [router.placement_of(f"w{i}") for i in range(8)]
            assert {r: placed.count(r) for r in ("r0", "r1", "r2")} == {
                "r0": 4, "r1": 2, "r2": 2}
            router.run()
            return {"same": placed}

        _both(pkgs, scenario)

    def test_queue_full_retries_next_best_then_sheds(self, pkgs):
        def scenario(P):
            psv = P.sv
            router = _mk_fleet(P, P.fleet(), psv.VirtualClock(),
                               max_queue=1, config=psv.FleetConfig(
                                   weights={"r0": 100.0}))
            with _Tap(P) as tap:
                for i in range(3):
                    router.submit(psv.Request(f"q{i}", _prompt(30 + i),
                                              max_new_tokens=1))
                with pytest.raises(psv.QueueFull, match="every healthy"):
                    router.submit(psv.Request("q3", _prompt(33),
                                              max_new_tokens=1))
            routed = tap.of("serving_fleet_routed")
            assert [e["rid"] for e in routed] == ["q0", "q1", "q2"]
            assert routed[0]["retries"] == 0 and routed[1]["retries"] >= 1
            shed = tap.of("serving_fleet_shed")
            assert [(e["rid"], e["reason"]) for e in shed] == [
                ("q3", "all_full")]
            assert router.fleet_stats["shed"] == 1
            router.run()
            return {"same": router.fleet_stats}

        _both(pkgs, scenario)

    def test_replica_reports_partition_by_final_placement(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            wl = psv.make_workload(
                [_prompt(70 + i) for i in range(6)],
                psv.uniform_arrivals(6, 12.0), max_new_tokens=3,
                deadline_s=30.0, rid_prefix="rr")
            with P.obs.recording_requests(clock=clk) as rec:
                out = psv.LoadGenerator(router, wl, step_time_s=0.25).run()
            assert out.completed == 6
            reports = router.replica_reports(
                rec.records(), deadlines=out.deadlines,
                arrivals=out.arrivals, duration_s=out.duration_s)
            fleet = reports["fleet"]
            assert fleet.completed == 6 and fleet.goodput == 1.0
            per = {k: v for k, v in reports.items() if k != "fleet"}
            assert sum(r.completed for r in per.values()) == 6
            for name, rep in per.items():
                served = [rid for rid in out.results
                          if router.placement_of(rid) == name]
                assert rep.completed == len(served) > 0
            return {"same": {k: (v.completed, v.offered, v.ttft, v.tpot,
                                 v.goodput) for k, v in reports.items()}}

        _both(pkgs, scenario)


# ---------------------------------------------------------------------------
# health state machine + failover fidelities
# ---------------------------------------------------------------------------


def _steps(router, clk, n):
    for _ in range(n):
        router.step()
        clk.advance(0.25)


class TestFleetHealth:
    def test_straggler_goes_suspect_then_recovers(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk, config=psv.FleetConfig(
                suspect_after_s=0.75, dead_after_s=5.0))
            fault = P.fi.SlowReplica("r1", steps=[0, 1], extra_s=0.25,
                                     clock=clk)
            with _Tap(P) as tap:
                for step in range(4):
                    router.step()
                    fault(step, router)
                    clk.advance(0.25)
                    if router.state_of("r1") is psv.ReplicaState.SUSPECT:
                        router.submit(psv.Request(f"s{step}", _prompt(40),
                                                  max_new_tokens=1))
                        assert router.placement_of(f"s{step}") != "r1"
            assert [(e["replica"], e["state"])
                    for e in tap.of("serving_fleet_replica_state")] == [
                ("r1", "suspect"), ("r1", "healthy")]
            assert router.state_of("r1") is psv.ReplicaState.HEALTHY
            assert router.replicas_healthy == 3
            router.run()
            return {}

        _both(pkgs, scenario)

    def test_wedge_watchdog_death_resumes_mid_stream_bit_exact(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk, config=psv.FleetConfig(
                suspect_after_s=0.5, dead_after_s=1.1))
            victim = psv.Request("v", _prompt(50), max_new_tokens=8)
            router.submit(victim)
            home = router.placement_of("v")
            _steps(router, clk, 3)
            assert router.replica(home).phase_of("v").value == "decode"
            fault = P.fi.WedgeReplica(home, at_step=0)
            with _Tap(P) as tap:
                fault(0, router)
                _steps(router, clk, 8)
                results = router.run()
            assert fault.wedged
            assert router.state_of(home) is psv.ReplicaState.DEAD
            assert router.replicas_healthy == 2
            fo = tap.of("serving_fleet_failover")
            assert [(e["rid"], e["mode"]) for e in fo] == [
                ("v", "capture-resume")]
            assert fo[0]["new_tokens"] > 0
            rs = tap.of("serving_fleet_resumed")
            assert [(e["rid"], e["mode"]) for e in rs] == [
                ("v", "capture-resume")]
            assert rs[0]["replica"] != home
            assert results["v"].finish_reason == "preempted-resumed"
            assert list(results["v"].tokens) == P.isolated(victim)
            assert router.fleet_stats["resumed"] == 1
            return {"same": (home, _tokens(results), router.fleet_stats)}

        _both(pkgs, scenario)

    def test_kill_requeues_and_replays_deterministically(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            victim = psv.Request("k", _prompt(60), max_new_tokens=6)
            router.submit(victim)
            home = router.placement_of("k")
            _steps(router, clk, 3)
            with _Tap(P) as tap:
                router.kill(home)
                router.kill(home)                # idempotent on DEAD
                results = router.run()
            assert [(e["rid"], e["mode"]) for e in tap.of(
                "serving_fleet_failover")] == [("k", "requeue")]
            assert results["k"].finish_reason == "length"
            assert list(results["k"].tokens) == P.isolated(victim)
            assert router.state_of(home) is psv.ReplicaState.DEAD
            fresh = psv.ContinuousBatchingScheduler(
                router.replica(home).engine, max_queue=8,
                log_interval=10 ** 9, clock=clk)
            with pytest.raises(ValueError, match="replace"):
                router.rejoin(home)
            router.replace(home, fresh)
            assert router.state_of(home) is psv.ReplicaState.HEALTHY
            assert router.replicas_healthy == 3
            return {"same": (home, _tokens(results))}

        _both(pkgs, scenario)

    def test_drain_moves_streams_then_rejoin(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            reqs = [psv.Request(f"d{i}", _prompt(70 + i), max_new_tokens=6)
                    for i in range(2)]
            for r in reqs:
                router.submit(r)
            _steps(router, clk, 3)
            target = router.placement_of("d0")
            moved = router.drain(target)
            assert "d0" in moved
            assert router.state_of(target) is psv.ReplicaState.DRAINING
            assert router.replica(target).active_count == 0
            assert router.replica(target).queue_depth == 0
            after = psv.Request("after", _prompt(79), max_new_tokens=2)
            router.submit(after)
            assert router.placement_of("after") != target
            results = router.run()
            for r in reqs + [after]:
                assert list(results[r.rid].tokens) == P.isolated(r)
            router.rejoin(target)
            assert router.state_of(target) is psv.ReplicaState.HEALTHY
            with pytest.raises(ValueError, match="no other healthy"):
                for name in router.replica_names:
                    router.drain(name)
            return {"same": (target, moved, _tokens(results))}

        _both(pkgs, scenario)


# ---------------------------------------------------------------------------
# lifecycle edges: drain/watchdog interplay and the refusal paths
# ---------------------------------------------------------------------------


class TestFleetLifecycleEdges:
    def test_draining_replica_survives_slow_reload(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk, config=psv.FleetConfig(
                suspect_after_s=0.5, dead_after_s=1.0))
            req = psv.Request("sl", _prompt(200), max_new_tokens=6)
            router.submit(req)
            _steps(router, clk, 2)
            target = router.placement_of("sl")
            router.drain(target)
            with _Tap(P) as tap:
                for _ in range(8):
                    router.stall(target)
                    router.step()
                    clk.advance(0.25)
            assert router.state_of(target) is psv.ReplicaState.DRAINING
            assert [e for e in tap.of("serving_fleet_replica_state")
                    if e["replica"] == target] == []
            assert tap.of("serving_fleet_failover") == []
            router.rejoin(target)
            results = router.run()
            assert list(results["sl"].tokens) == P.isolated(req)
            router.submit(psv.Request("post", _prompt(201),
                                      max_new_tokens=1))
            assert router.run()["post"].finish_reason in psv.SERVED_REASONS
            return {"same": target}

        _both(pkgs, scenario)

    def test_rejoin_of_never_drained_replica_is_benign(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            req = psv.Request("rj", _prompt(210), max_new_tokens=6)
            router.submit(req)
            home = router.placement_of("rj")
            _steps(router, clk, 2)
            with _Tap(P) as tap:
                router.rejoin(home)
            assert router.state_of(home) is psv.ReplicaState.HEALTHY
            assert tap.of("serving_fleet_replica_state") == []
            assert router.replica(home).active_count == 1
            assert list(router.run()["rj"].tokens) == P.isolated(req)
            return {"same": home}

        _both(pkgs, scenario)

    def test_replace_of_live_replica_refused(self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            req = psv.Request("rp", _prompt(220), max_new_tokens=6)
            router.submit(req)
            home = router.placement_of("rp")
            _steps(router, clk, 2)
            original = router.replica(home)
            fresh = psv.ContinuousBatchingScheduler(
                original.engine, max_queue=8, log_interval=10 ** 9,
                clock=clk)
            with pytest.raises(ValueError, match="drain"):
                router.replace(home, fresh)
            assert router.replica(home) is original
            assert router.state_of(home) is psv.ReplicaState.HEALTHY
            assert router.replica(home).active_count == 1
            assert list(router.run()["rp"].tokens) == P.isolated(req)
            return {"same": home}

        _both(pkgs, scenario)

    def test_drain_of_last_healthy_replica_refused_fleet_untouched(
            self, pkgs):
        def scenario(P):
            psv = P.sv
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            req = psv.Request("lh", _prompt(230), max_new_tokens=6)
            router.submit(req)
            last = router.placement_of("lh")
            _steps(router, clk, 2)
            for name in router.replica_names:
                if name != last:
                    router.drain(name)
            with _Tap(P) as tap:
                with pytest.raises(ValueError, match="no other healthy"):
                    router.drain(last)
            assert router.state_of(last) is psv.ReplicaState.HEALTHY
            assert router.placement_of("lh") == last
            assert router.replica(last).active_count == 1
            assert tap.of("serving_fleet_failover") == []
            assert list(router.run()["lh"].tokens) == P.isolated(req)
            for name in router.replica_names:
                if name != last:
                    router.rejoin(name)
            assert router.replicas_healthy == 3
            return {"same": last}

        _both(pkgs, scenario)


def test_fleet_kill_releases_paged_blocks_and_pins(pkgs):
    """A killed paged replica's export + close drops every cached pool
    block and unhooks the reclaim callback; the victim requeues on the
    survivor and replays (paged capture cannot cross pools)."""
    def scenario(P):
        psv = P.sv
        engines = tuple(P.make_engine(
            slots=2, paged=psv.PagedCacheConfig(block_size=16,
                                                num_blocks=24))
            for _ in range(2))
        clk = psv.VirtualClock()
        router = _mk_fleet(P, engines, clk, prefix=True)
        prompt = _prompt(80, n=40)
        router.submit(psv.Request("warm", prompt, max_new_tokens=2))
        home = router.placement_of("warm")
        router.run()
        eng = router.replica(home).engine
        assert eng.block_pool.used_blocks > 0
        assert eng.block_pool.reclaim is not None
        victim = psv.Request("vic", prompt, max_new_tokens=4)
        router.submit(victim)
        assert router.placement_of("vic") == home
        _steps(router, clk, 2)
        with _Tap(P) as tap:
            router.kill(home)
            results = router.run()
        assert eng.block_pool.used_blocks == 0
        assert eng.block_pool.reclaim is None
        assert [(e["rid"], e["mode"]) for e in tap.of(
            "serving_fleet_failover")] == [("vic", "requeue")]
        assert list(results["vic"].tokens) == P.isolated(victim)
        return {"same": (home, _tokens(results))}

    _both(pkgs, scenario)


# ---------------------------------------------------------------------------
# the acceptance run: fleet chaos under overload
# ---------------------------------------------------------------------------


class TestFleetChaosAcceptance:
    N = 12
    KILL_STEP = 6

    def _workload(self, psv):
        return psv.make_workload([_prompt(100 + i) for i in range(self.N)],
                                 psv.uniform_arrivals(self.N, 8.0),
                                 max_new_tokens=5, deadline_s=60.0,
                                 rid_prefix="fl")

    def _run(self, P, *, failover):
        psv = P.sv
        clk = psv.VirtualClock()
        scheds = {f"r{i}": psv.ContinuousBatchingScheduler(
            e, max_queue=8, log_interval=10 ** 9, clock=clk)
            for i, e in enumerate(P.fleet())}
        router = psv.FleetRouter(scheds,
                                 config=psv.FleetConfig(failover=failover))
        fault = P.fi.KillReplica("r0", at_step=self.KILL_STEP)
        with _Tap(P) as tap:
            out = psv.LoadGenerator(router, self._workload(psv),
                                    step_time_s=0.25, step_hook=fault).run()
        assert fault.killed
        return router, out, tap

    def test_kill_mid_stream_under_overload(self, pkgs):
        """Every victim resumes on a survivor, nothing admitted drops,
        every stream equals its isolated run, failover goodput beats the
        no-failover fleet's by 0.1 or more — and the port's run, its
        events and its fleet metrics are JAX's."""
        def scenario(P):
            psv = P.sv
            P.obs.metrics.reset()
            wl = self._workload(psv)
            router, out, tap = self._run(P, failover=True)
            assert {e["rid"] for e in tap.of("serving_fleet_failover")}
            assert out.rejected == []
            assert set(out.results) == {r.rid for r in wl.requests}
            for req in wl.requests:
                res = out.results[req.rid]
                assert res.finish_reason in psv.SERVED_REASONS, req.rid
                assert list(res.tokens) == P.isolated(req), req.rid
            assert router.replicas_healthy == 2
            snap = P.obs.snapshot()
            healthy = snap["apex_serving_fleet_replicas_healthy"]["series"]
            assert healthy and healthy[0]["value"] == 2
            fleet_snap = {k: v for k, v in snap.items()
                          if k.startswith("apex_serving_fleet_")}
            _, out0, tap0 = self._run(P, failover=False)
            shed0 = {e["rid"] for e in tap0.of("serving_fleet_shed")}
            assert shed0
            for rid in shed0:
                res = out0.results.get(rid)
                assert res is None or res.finish_reason \
                    not in psv.SERVED_REASONS
            assert out.goodput >= out0.goodput + 0.1
            return {"same": (_tokens(out.results), out.goodput,
                             out0.goodput, router.fleet_stats, fleet_snap,
                             _strip(tap.events), _strip(tap0.events))}

        _both(pkgs, scenario)
