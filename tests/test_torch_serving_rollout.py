"""The port's rolling fleet upgrades (``serving/rollout.py``: the canary
gate, the controller, pinned traffic) and the rollout faults
(``CorruptCandidateMidRollout``, ``RegressingWeights``, ``KillCanary``)
against the JAX package's.

The model is a small JAX ``LlamaForCausalLM`` (2 layers, hidden 64, 4
heads over 2 kv heads, vocab 128, fp32) carried to the port by
``models/convert.py``; the port's three replicas are engines over one
shared module.  The gate and controller units are the JAX package's
``tests/test_serving_rollout.py`` cases on the port.  Each acceptance
and chaos case runs as a scenario in both packages on the same virtual
schedule (the reloaders on the fleet's clock, so every reload phase is
0 s in both): the controller's terminal state, upgrade order, verdict and
arm summaries, the goodputs, every stream, the whole event stream (wall
times, paths and refusal texts aside) and the ``apex_serving_*`` metric
snapshot equal JAX's, and the JAX case's own assertions hold on the
port's run — among them that a halted rollout leaves every replica
serving the old weights bit for bit.
"""

import os
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import _logging as jlog
from apex_tpu import obs as jobs
from apex_tpu import resilience as jrz
from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.resilience import fault_injection as jfi
from apex_tpu_torch import _logging as tlog
from apex_tpu_torch import obs as tobs
from apex_tpu_torch import resilience as trz
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.obs.slo import SLOReport
from apex_tpu_torch.resilience import fault_injection as tfi

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
MAX = 96
STEP_S = 0.25
BOOT_STEP = 100
TARGET = 200


def _mutated(tree, delta):
    return jax.tree.map(
        lambda l: l + delta if jnp.issubdtype(l.dtype, jnp.floating)
        else l, tree)


class Pkg:
    """One package's serving surface, fleet, boot weights and
    references."""

    def __init__(self, name, psv, rz, fi, log, obs, make_engine, params,
                 mutated, equal):
        self.name, self.sv, self.rz, self.fi, self.log, self.obs = (
            name, psv, rz, fi, log, obs)
        self.params, self.mutated, self.equal = params, mutated, equal
        self.engines = tuple(make_engine(2) for _ in range(3))
        self.ref = make_engine(1)
        self._memo = {}

    def fleet(self):
        for e in self.engines:
            e.swap_params(self.params)
            e.reset()
        return self.engines

    def isolated(self, request, params=None):
        key = (tuple(request.prompt), request.max_new_tokens,
               request.seed, params is not None)
        if key not in self._memo:
            if params is not None:
                self.ref.swap_params(params)
            try:
                self.ref.reset()
                sched = self.sv.ContinuousBatchingScheduler(
                    self.ref, max_queue=4, clock=self.sv.VirtualClock())
                sched.submit(self.sv.Request(
                    "ref", request.prompt,
                    max_new_tokens=request.max_new_tokens,
                    eos_id=request.eos_id, temperature=request.temperature,
                    top_k=request.top_k, seed=request.seed))
                self._memo[key] = list(sched.run()["ref"].tokens)
            finally:
                self.ref.swap_params(self.params)
                self.ref.reset()
        return self._memo[key]


@pytest.fixture(scope="module")
def pkgs():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    boot = OrderedDict(tmodel.state_dict(keep_vars=True))

    def port_mutated(delta):
        conv = llama_params_from_jax(
            jax.tree.map(np.asarray, _mutated(params, delta)), tmodel.config)
        return OrderedDict((k, conv[k]) for k in boot)

    def jax_equal(a, b):
        fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
        return len(fa) == len(fb) and all(
            np.array_equal(np.asarray(x), np.asarray(y))
            for x, y in zip(fa, fb))

    def port_equal(a, b):
        return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)

    return {
        "jax": Pkg("jax", jsv, jrz, jfi, jlog, jobs,
                   lambda slots: jsv.DecodeEngine(
                       jmodel, params, slots=slots, max_len=MAX,
                       prefill_len=32),
                   params, lambda d: _mutated(params, d), jax_equal),
        "port": Pkg("port", sv, trz, tfi, tlog, tobs,
                    lambda slots: sv.DecodeEngine(
                        tmodel, device="cpu", slots=slots, max_len=MAX,
                        prefill_len=32),
                    boot, port_mutated, port_equal),
    }


def _prompt(seed, n=8):
    return [int(x) for x in np.random.default_rng(seed).integers(0, 128, n)]


def _mk_fleet(P, engines, clk, *, max_queue=16):
    scheds = {f"r{i}": P.sv.ContinuousBatchingScheduler(
        e, max_queue=max_queue, log_interval=10 ** 9, clock=clk)
        for i, e in enumerate(engines)}
    return P.sv.FleetRouter(scheds, config=P.sv.FleetConfig())


def _mk_reloaders(P, router, root, clk=None, *, current_step=BOOT_STEP):
    kw = {} if clk is None else {"clock": clk}
    return {name: P.sv.HotReloader(router.replica(name), str(root),
                                   like={"params": P.params},
                                   params_key="params",
                                   current_step=current_step, **kw)
            for name in router.replica_names}


def _workload(psv, n=16, *, max_new=5, deadline_s=60.0, seed_base=300,
              rate=8.0):
    return psv.make_workload([_prompt(seed_base + i) for i in range(n)],
                             psv.uniform_arrivals(n, rate),
                             max_new_tokens=max_new, deadline_s=deadline_s,
                             rid_prefix="ro")


def _chain(*hooks):
    def hook(step, router):
        for h in hooks:
            h(step, router)
    return hook


def _drive_to_terminal(router, clk, ctl, *extra_hooks, limit=300):
    steps = 0
    while not ctl.done and steps < limit:
        router.step()
        clk.advance(STEP_S)
        ctl.advance()
        for h in extra_hooks:
            h(10_000 + steps, router)
        steps += 1
    assert ctl.done, f"rollout never terminal: {ctl.status}"


def _assert_zero_dropped(P, out, wl):
    for req in wl.requests:
        if req.rid in set(out.rejected):
            continue
        res = out.results.get(req.rid)
        assert res is not None and res.finish_reason \
            in P.sv.SERVED_REASONS, f"{req.rid} dropped"


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


#: events whose duration reads the wall clock (the restore and save
#: layers time themselves); every other duration is on the fleet's clock
_WALL_TIMED = ("serving_weights_loaded", "checkpoint_restored",
               "checkpoint_saved", "checkpoint_snapshot")


def _strip(events):
    out = []
    for e in events:
        drop = {"time", "path", "offsets", "reason", "reasons"}
        if e["event"] in _WALL_TIMED:
            drop.add("duration_s")
        out.append({k: v for k, v in e.items() if k not in drop})
    return out


def _serving_snapshot(P):
    snap = {k: v for k, v in P.obs.snapshot().items()
            if k.startswith("apex_serving_") or k == "apex_events_total"}
    snap.pop("apex_serving_decode_compiles", None)
    hist = snap.pop("apex_serving_reload_duration_seconds", None)
    if hist is not None:
        snap["reload_counts"] = [(s["labels"], s["count"])
                                 for s in hist["series"]]
    return snap


def _tokens(results):
    return {rid: (list(r.tokens), r.finish_reason)
            for rid, r in results.items()}


def _both(pkgs, scenario, tmp_path):
    out = {}
    for name in ("jax", "port"):
        P = pkgs[name]
        P.obs.metrics.reset()
        root = tmp_path / name
        root.mkdir()
        with _Tap(P) as tap:
            got = scenario(P, root)
        got["events"] = _strip(tap.events)
        got["snapshot"] = _serving_snapshot(P)
        out[name] = got
    assert out["port"]["events"] == out["jax"]["events"]
    assert out["port"]["snapshot"] == out["jax"]["snapshot"]
    assert out["port"]["same"] == out["jax"]["same"]
    return out


def _summary(ctl, router, out):
    st = ctl.status
    st["abort_reason"] = (None if ctl.abort_reason is None
                          else ctl.abort_reason.split(": ")[0])
    return {"status": st, "weights_steps": router.weights_steps,
            "verdict": None if ctl.verdict is None else (
                ctl.verdict.passed, ctl.verdict.canary,
                ctl.verdict.baseline, ctl.verdict.window_steps,
                ctl.verdict.duration_s),
            "results": _tokens(out.results), "goodput": out.goodput,
            "rejected": list(out.rejected), "fleet": router.fleet_stats}


# ---------------------------------------------------------------------------
# gate units
# ---------------------------------------------------------------------------


def _slo(completed, offered, *, tpot_p95=0.25, ttft_p95=0.5, goodput=None):
    return SLOReport(offered=offered, completed=completed,
                     incomplete=offered - completed, duration_s=1.0,
                     throughput_rps=None, output_tokens=completed * 5,
                     tokens_per_s=None, ttft={"p95": ttft_p95},
                     tpot={"p95": tpot_p95}, queue_wait={}, total={},
                     goodput=goodput, deadline_misses=0)


class TestCanaryGate:
    def test_validation(self):
        with pytest.raises(ValueError, match="ratios"):
            sv.CanaryGate(tpot_ratio=0.0)
        with pytest.raises(ValueError, match="min_samples"):
            sv.CanaryGate(min_samples=0)

    @pytest.mark.parametrize("case", [
        ("identical", {}, (5, 6), {}, (5, 6), True, None),
        ("empty_canary", {}, (0, 4), {}, (6, 6), False, "fail-closed"),
        ("tpot", {"tpot_ratio": 1.5}, (5, 6), {"tpot_p95": 0.5}, (5, 6),
         False, "tpot"),
        ("ttft", {"ttft_ratio": 1.5}, (5, 6), {"ttft_p95": 2.0}, (5, 6),
         False, "ttft"),
        ("completion", {"completion_margin": 0.1}, (5, 10), {}, (10, 10),
         False, "completion"),
        ("goodput", {"goodput_margin": 0.05}, (5, 5), {"goodput": 0.5},
         (5, 5), False, "goodput"),
        ("thin_baseline", {}, (3, 3), {"tpot_p95": 9.9}, (0, 0), True, None),
        ("non_finite", {}, (5, 6), {"tpot_p95": float("nan")}, (5, 6), True,
         None),
    ], ids=lambda c: c[0])
    def test_verdicts_match_jax(self, case):
        _, gate_kw, c, c_kw, b, passed, word = case
        base_kw = {"goodput": 0.9} if "goodput" in c_kw else {}
        ok, reasons = sv.CanaryGate(**gate_kw).verdict(
            _slo(*c, **c_kw), _slo(*b, **base_kw))
        assert ok is passed
        if word is not None:
            assert any(word in r for r in reasons)
        else:
            assert reasons == []
        from apex_tpu.obs.slo import SLOReport as JSLOReport

        def jslo(completed, offered, *, tpot_p95=0.25, ttft_p95=0.5,
                 goodput=None):
            return JSLOReport(
                offered=offered, completed=completed,
                incomplete=offered - completed, duration_s=1.0,
                throughput_rps=None, output_tokens=completed * 5,
                tokens_per_s=None, ttft={"p95": ttft_p95},
                tpot={"p95": tpot_p95}, queue_wait={}, total={},
                goodput=goodput, deadline_misses=0)

        assert jsv.CanaryGate(**gate_kw).verdict(
            jslo(*c, **c_kw), jslo(*b, **base_kw)) == (ok, reasons)

    def test_rollout_config_validation(self):
        with pytest.raises(ValueError, match="batch_size"):
            sv.RolloutConfig(batch_size=0)
        with pytest.raises(ValueError, match="health_window_steps"):
            sv.RolloutConfig(health_window_steps=-1)
        with pytest.raises(ValueError, match="canary_fraction"):
            sv.RolloutConfig(canary_fraction=0.0)
        with pytest.raises(ValueError, match="canary_fraction"):
            sv.RolloutConfig(canary_fraction=1.5)
        with pytest.raises(ValueError, match="canary_window_steps"):
            sv.RolloutConfig(canary_window_steps=0)


# ---------------------------------------------------------------------------
# controller + pin units
# ---------------------------------------------------------------------------


@pytest.fixture
def unit_fleet(pkgs):
    """Three port engines of their own for the port-only units (the
    shared fleets' weight versions move in step in the two packages)."""
    P = pkgs["port"]
    if not hasattr(P, "unit_engines"):
        model = P.engines[0].model
        P.unit_engines = tuple(sv.DecodeEngine(
            model, device="cpu", slots=2, max_len=MAX, prefill_len=32)
            for _ in range(3))
    for e in P.unit_engines:
        e.reset()
    return P.unit_engines


class TestControllerUnits:
    def test_reloaders_must_cover_fleet(self, pkgs, unit_fleet,
                                        tmp_path):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet, sv.VirtualClock())
        reloaders = _mk_reloaders(P, router, tmp_path)
        del reloaders["r2"]
        with pytest.raises(ValueError, match="cover the fleet"):
            sv.RollingReloadController(router, reloaders,
                                       config=sv.RolloutConfig(gate=None))

    def test_reloader_must_wrap_router_scheduler(self, pkgs, unit_fleet,
                                                 tmp_path):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet, sv.VirtualClock())
        reloaders = _mk_reloaders(P, router, tmp_path)
        reloaders["r0"] = sv.HotReloader(
            router.replica("r1"), str(tmp_path), like={"params": P.params},
            params_key="params", current_step=BOOT_STEP)
        with pytest.raises(ValueError, match="different scheduler"):
            sv.RollingReloadController(router, reloaders,
                                       config=sv.RolloutConfig(gate=None))

    def test_gated_requires_recorder(self, pkgs, unit_fleet, tmp_path):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet, sv.VirtualClock())
        with pytest.raises(ValueError, match="recorder"):
            sv.RollingReloadController(router,
                                       _mk_reloaders(P, router, tmp_path))

    def test_start_twice_refused(self, pkgs, unit_fleet, tmp_path):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet, sv.VirtualClock())
        trz.save_checkpoint(str(tmp_path), TARGET, {"params": P.params})
        ctl = sv.RollingReloadController(
            router, _mk_reloaders(P, router, tmp_path),
            config=sv.RolloutConfig(gate=None))
        assert ctl.start(step=TARGET) == TARGET
        with pytest.raises(RuntimeError, match="one controller"):
            ctl.start(step=TARGET)

    def test_start_without_target_refused(self, pkgs, unit_fleet,
                                          tmp_path):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet, sv.VirtualClock())
        ctl = sv.RollingReloadController(
            router, _mk_reloaders(P, router, tmp_path),
            config=sv.RolloutConfig(gate=None))
        with pytest.raises(ValueError, match="no target step"):
            ctl.start()

    def test_single_replica_fleet_refused(self, pkgs, unit_fleet,
                                          tmp_path):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet[:1], sv.VirtualClock())
        ctl = sv.RollingReloadController(
            router, _mk_reloaders(P, router, tmp_path),
            config=sv.RolloutConfig(gate=None))
        with pytest.raises(ValueError, match="2 replicas"):
            ctl.start(step=TARGET)

    def test_pin_traffic_validation(self, pkgs, unit_fleet):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet, sv.VirtualClock())
        with pytest.raises(KeyError):
            router.pin_traffic("nope", fraction=0.5)
        with pytest.raises(ValueError, match="fraction"):
            router.pin_traffic("r0", fraction=0.0)
        with pytest.raises(ValueError, match="fraction"):
            router.pin_traffic("r0", fraction=1.5)

    def test_pin_traffic_exact_seeded_split_and_log(self, pkgs, tmp_path):
        def scenario(P, root):
            psv = P.sv
            router = _mk_fleet(P, P.fleet(), psv.VirtualClock())
            router.pin_traffic("r0", fraction=0.5, seed=7)
            rids = [f"p{i}" for i in range(10)]
            for i, rid in enumerate(rids):
                router.submit(psv.Request(rid, _prompt(500 + i),
                                          max_new_tokens=1))
            arms = {rid: psv.assign_arm(rid, fraction=0.5, seed=7)
                    for rid in rids}
            assert any(arms.values()) and not all(arms.values())
            for rid in rids:
                assert (router.placement_of(rid) == "r0") == arms[rid]
            log = router.unpin_traffic()
            assert log == {rid: ("r0" if arms[rid] else
                                 router.placement_of(rid)) for rid in rids}
            assert router.unpin_traffic() == {}
            router.run()
            return {"same": log}

        _both(pkgs, scenario, tmp_path)

    def test_pin_never_strands_and_skips_unhealthy_canary(self, pkgs,
                                                          unit_fleet):
        P = pkgs["port"]
        router = _mk_fleet(P, unit_fleet, sv.VirtualClock())
        router.pin_traffic("r0", fraction=1.0, seed=0)
        router.drain("r0")
        router.submit(sv.Request("x", _prompt(510), max_new_tokens=1))
        assert router.placement_of("x") != "r0"
        assert router.unpin_traffic() == {"x": router.placement_of("x")}
        router.rejoin("r0")
        router.run()


# ---------------------------------------------------------------------------
# the acceptance run: rolling upgrade under overload
# ---------------------------------------------------------------------------


class TestRolloutAcceptance:
    def test_health_gated_rolling_upgrade_zero_drop_token_identical(
            self, pkgs, tmp_path):
        def scenario(P, root):
            psv = P.sv
            P.rz.save_checkpoint(str(root), TARGET, {"params": P.params})
            clk = psv.VirtualClock()
            engines = P.fleet()
            router = _mk_fleet(P, engines, clk)
            reloaders = _mk_reloaders(P, router, root, clk)
            wl = _workload(psv)
            with _Tap(P) as tap, P.obs.recording_requests(clock=clk) as rec:
                ctl = psv.RollingReloadController(
                    router, reloaders, config=psv.RolloutConfig(
                        step=TARGET, canary_fraction=0.34,
                        canary_window_steps=10, health_window_steps=1,
                        gate=psv.CanaryGate(ttft_ratio=3.0,
                                            completion_margin=0.5)),
                    recorder=rec)
                assert ctl.start() == TARGET
                out = psv.LoadGenerator(router, wl, step_time_s=STEP_S,
                                        step_hook=ctl).run()
                _drive_to_terminal(router, clk, ctl)
            assert ctl.state == "promoted", ctl.status
            assert ctl.canary == "r0" and ctl.upgraded == ["r0", "r1", "r2"]
            assert ctl.verdict.passed and ctl.verdict.canary["completed"] >= 1
            assert out.rejected == []
            _assert_zero_dropped(P, out, wl)
            for req in wl.requests:
                assert list(out.results[req.rid].tokens) == \
                    P.isolated(req), req.rid
            assert router.weights_steps == {"r0": TARGET, "r1": TARGET,
                                            "r2": TARGET}
            assert set(ctl.swap_pauses) == {"r0", "r1", "r2"}
            ups = tap.of("serving_rollout_replica_upgraded")
            assert [(e["replica"], e["canary"]) for e in ups] == [
                ("r0", True), ("r1", False), ("r2", False)]
            assert all(e["prefetched"] and e["from_step"] == BOOT_STEP
                       and e["step"] == TARGET for e in ups)
            assert [e["verdict"] for e in tap.of(
                "serving_rollout_canary_verdict")] == ["pass"]
            assert len(tap.of("serving_rollout_promoted")) == 1
            assert tap.of("serving_rollout_halted") == []
            snap = P.obs.snapshot()
            assert snap["apex_serving_rollout_promotions_total"][
                "series"][0]["value"] == 1
            assert snap["apex_serving_rollout_active"]["series"][0][
                "value"] == 0
            assert snap["apex_serving_rollout_replicas_upgraded_total"][
                "series"][0]["value"] == 3
            return {"same": _summary(ctl, router, out)}

        _both(pkgs, scenario, tmp_path)

    def test_mixed_version_window_has_no_hybrid_streams(self, pkgs,
                                                        tmp_path):
        def scenario(P, root):
            psv = P.sv
            v2 = P.mutated(0.05)
            P.rz.save_checkpoint(str(root), TARGET, {"params": v2})
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            reloaders = _mk_reloaders(P, router, root, clk)
            wl = _workload(psv, seed_base=340)
            with _Tap(P) as tap:
                ctl = psv.RollingReloadController(
                    router, reloaders, config=psv.RolloutConfig(
                        step=TARGET, health_window_steps=1, gate=None))
                ctl.start()
                out = psv.LoadGenerator(router, wl, step_time_s=STEP_S,
                                        step_hook=ctl).run()
                _drive_to_terminal(router, clk, ctl)
            assert ctl.state == "promoted" and ctl.canary is None
            assert tap.of("serving_rollout_canary_verdict") == []
            assert out.rejected == []
            _assert_zero_dropped(P, out, wl)
            n_old = n_new = 0
            for req in wl.requests:
                got = list(out.results[req.rid].tokens)
                old, new = P.isolated(req), P.isolated(req, params=v2)
                n_old += got == old
                n_new += got == new
                assert got in (old, new), f"{req.rid} is a hybrid"
            assert n_old >= 1 and n_new >= 1
            assert {BOOT_STEP, TARGET} <= {
                e.get("weights_step") for e in tap.of(
                    "serving_fleet_routed")}
            assert router.weights_steps == {"r0": TARGET, "r1": TARGET,
                                            "r2": TARGET}
            return {"same": (_summary(ctl, router, out), n_old, n_new)}

        _both(pkgs, scenario, tmp_path)


# ---------------------------------------------------------------------------
# chaos: the gate earns its keep
# ---------------------------------------------------------------------------


def _run_regressing(P, root, *, gated):
    psv = P.sv
    clk = psv.VirtualClock()
    router = _mk_fleet(P, P.fleet(), clk)
    reloaders = _mk_reloaders(P, router, root, clk)
    wl = _workload(psv, seed_base=360, deadline_s=5.0)
    with _Tap(P) as tap, P.obs.recording_requests(clock=clk) as rec:
        ctl = psv.RollingReloadController(
            router, reloaders, config=psv.RolloutConfig(
                step=TARGET, canary_fraction=0.5, canary_window_steps=12,
                health_window_steps=1,
                gate=(psv.CanaryGate() if gated else None)),
            recorder=(rec if gated else None))
        fault = P.fi.RegressingWeights(ctl, slow_every=2)
        ctl.start()
        out = psv.LoadGenerator(router, wl, step_time_s=STEP_S,
                                step_hook=_chain(ctl, fault)).run()
        _drive_to_terminal(router, clk, ctl, fault)
    return router, ctl, fault, out, wl, tap


class TestRolloutChaos:
    def test_regressing_candidate_gate_halts_and_rolls_back_bit_exact(
            self, pkgs, tmp_path):
        def scenario(P, root):
            bad = P.fi.RegressingWeights.publish(str(root), P.params, TARGET)
            router, ctl, fault, out, wl, tap = _run_regressing(P, root,
                                                               gated=True)
            assert ctl.state == "aborted", ctl.status
            assert ctl.abort_reason.startswith("canary_failed")
            assert not ctl.verdict.passed and fault.stalls > 0
            assert [(e["replicas"], e["names"]) for e in tap.of(
                "serving_rollout_rolled_back")] == [(1, "r0")]
            assert router.weights_steps == {n: BOOT_STEP
                                            for n in ("r0", "r1", "r2")}
            for e in P.engines:
                assert P.equal(e.params, P.params), "rollback not bit-exact"
                assert not P.equal(e.params, bad)
            _assert_zero_dropped(P, out, wl)
            gated = _summary(ctl, router, out)
            router0, ctl0, fault0, out0, wl0, _ = _run_regressing(
                P, root, gated=False)
            assert ctl0.state == "promoted"
            assert router0.weights_steps == {n: TARGET
                                             for n in ("r0", "r1", "r2")}
            for e in P.engines:
                assert P.equal(e.params, bad)
            assert fault0.stalls > fault.stalls
            _assert_zero_dropped(P, out0, wl0)
            assert out.goodput > out0.goodput
            return {"same": (gated, fault.stalls,
                             _summary(ctl0, router0, out0), fault0.stalls,
                             ctl.verdict.reasons)}

        _both(pkgs, scenario, tmp_path)

    def test_corrupt_candidate_mid_rollout_refused_and_rolled_back(
            self, pkgs, tmp_path):
        def scenario(P, root):
            psv = P.sv
            P.rz.save_checkpoint(str(root), TARGET, {"params": P.params})
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            reloaders = _mk_reloaders(P, router, root, clk)
            wl = _workload(psv, seed_base=380)
            fault = P.fi.CorruptCandidateMidRollout(str(root), TARGET,
                                                    at_step=6)
            with _Tap(P) as tap, P.obs.recording_requests(clock=clk) as rec:
                ctl = psv.RollingReloadController(
                    router, reloaders, config=psv.RolloutConfig(
                        step=TARGET, canary_fraction=0.34,
                        canary_window_steps=10, health_window_steps=1,
                        gate=psv.CanaryGate(ttft_ratio=3.0,
                                            completion_margin=0.5)),
                    recorder=rec)
                ctl.start()
                out = psv.LoadGenerator(router, wl, step_time_s=STEP_S,
                                        step_hook=_chain(ctl, fault)).run()
                _drive_to_terminal(router, clk, ctl, fault)
            assert fault.corrupted and ctl.state == "aborted"
            assert "reload_refused:r1" in ctl.abort_reason
            assert ctl.verdict.passed
            assert [(e["replicas"], e["names"]) for e in tap.of(
                "serving_rollout_rolled_back")] == [(1, "r0")]
            assert router.weights_steps == {n: BOOT_STEP
                                            for n in ("r0", "r1", "r2")}
            for e in P.engines:
                assert P.equal(e.params, P.params)
            _assert_zero_dropped(P, out, wl)
            for req in wl.requests:
                if req.rid in out.results:
                    assert list(out.results[req.rid].tokens) == \
                        P.isolated(req)
            return {"same": _summary(ctl, router, out)}

        _both(pkgs, scenario, tmp_path)

    def test_kill_canary_mid_window_aborts_and_replays_losslessly(
            self, pkgs, tmp_path):
        def scenario(P, root):
            psv = P.sv
            P.rz.save_checkpoint(str(root), TARGET, {"params": P.params})
            clk = psv.VirtualClock()
            router = _mk_fleet(P, P.fleet(), clk)
            reloaders = _mk_reloaders(P, router, root, clk)
            wl = _workload(psv, seed_base=400)
            with _Tap(P) as tap, P.obs.recording_requests(clock=clk) as rec:
                ctl = psv.RollingReloadController(
                    router, reloaders, config=psv.RolloutConfig(
                        step=TARGET, canary_fraction=0.5,
                        canary_window_steps=10, health_window_steps=1,
                        gate=psv.CanaryGate(completion_margin=0.5)),
                    recorder=rec)
                fault = P.fi.KillCanary(ctl, after_window_steps=2)
                ctl.start()
                out = psv.LoadGenerator(router, wl, step_time_s=STEP_S,
                                        step_hook=_chain(ctl, fault)).run()
                _drive_to_terminal(router, clk, ctl, fault)
            assert fault.killed and ctl.state == "aborted"
            assert ctl.abort_reason == "replica_died:r0"
            assert router.state_of("r0") is psv.ReplicaState.DEAD
            assert router.replicas_healthy == 2
            assert [e["replicas"] for e in tap.of(
                "serving_rollout_rolled_back")] == [0]
            assert router.weights_steps["r1"] == BOOT_STEP
            assert router.weights_steps["r2"] == BOOT_STEP
            assert router.unpin_traffic() == {}
            _assert_zero_dropped(P, out, wl)
            for req in wl.requests:
                res = out.results.get(req.rid)
                if res is not None and res.finish_reason \
                        in psv.SERVED_REASONS:
                    assert list(res.tokens) == P.isolated(req)
            return {"same": _summary(ctl, router, out)}

        _both(pkgs, scenario, tmp_path)


def test_corrupt_candidate_fault_flips_jaxs_offsets(tmp_path):
    """The port's corruption is the JAX ``FaultInjector``'s: the same
    offsets for the same seed and file size."""
    for name, save in (("j", jrz.save_checkpoint), ("t", trz.save_checkpoint)):
        save(str(tmp_path / name), 1, {"w": np.zeros(4096, np.float32)})
    d = "step_0000000001"
    j = jfi.FaultInjector(jfi.FaultPlan(seed=5)).corrupt_checkpoint(
        os.path.join(str(tmp_path / "j"), d), nbytes=6)
    t = tfi.corrupt_checkpoint(os.path.join(str(tmp_path / "t"), d),
                               seed=5, nbytes=6)
    assert j == t
    data = [open(os.path.join(str(tmp_path / n), d, "data.bin"), "rb").read()
            for n in ("j", "t")]
    assert data[0] == data[1]
