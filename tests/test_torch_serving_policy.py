"""The serving control plane: apex_tpu_torch.serving.policy and the
scheduler's priorities, lossless preemption, cancellation, deadline
shedding and tenant fairness, against the JAX package.

The model is a small JAX ``LlamaForCausalLM`` (2 layers, hidden 64, 4
heads over 2 kv heads, vocab 128, fp32) carried to the port by
``models/convert.py``.  Where a test compares with the JAX scheduler, both
serve the same requests on the same clock (a ``VirtualClock`` advanced a
fixed step a scheduler step, so every decision is a function of the
workload alone), and each result's tokens, finish reason, preemptions and
latencies must be equal, as must ``control_stats``; a stream may part
from JAX's only at a JAX near tie (top-2 margin below 1e-3).  Every
served stream, preempted ones included, equals the request served alone.

The JAX tests of the same classes read the scheduler's events; the port
has none, so its ``control_stats``, ``stats()``, ``spec_stats`` and
results stand in for them.  A dense preemption captures with
``capture_slot`` (host tensors) and resumes with ``restore_prefix``; a
paged one holds block references and resumes with ``alias_prefix``, with
no copy on write and the pool empty after; on an int8 engine the same
preemption gives the int8 streams served alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
MAX = 96
NEAR_TIE = 1e-3
ZERO_CONTROL = {"preempted": 0, "resumed": 0, "cancelled": 0, "shed": 0}


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    return jmodel, params, tmodel


def _engine(tmodel, *, slots=2, paged=False, num_blocks=None):
    return sv.DecodeEngine(
        tmodel, device="cpu", slots=slots, max_len=MAX, prefill_len=32,
        paged=(sv.PagedCacheConfig(block_size=16, num_blocks=num_blocks)
               if paged else None))


def _jax_engine(models, *, slots=2, paged=False):
    jmodel, params, _ = models
    return jsv.DecodeEngine(
        jmodel, params, slots=slots, max_len=MAX, prefill_len=32,
        paged=jsv.PagedCacheConfig(block_size=16) if paged else None)


@pytest.fixture(scope="module")
def _engine_mod(models):
    return _engine(models[2], slots=2)


@pytest.fixture
def engine(_engine_mod):
    """Shared 2-slot dense engine, reset per test."""
    _engine_mod.reset()
    return _engine_mod


@pytest.fixture(scope="module")
def _eng1_mod(models):
    return _engine(models[2], slots=1)


@pytest.fixture
def eng1(_eng1_mod):
    """Shared single-slot dense engine, reset per test."""
    _eng1_mod.reset()
    return _eng1_mod


def _prompt(seed, n=8):
    return [int(x) for x in np.random.default_rng(seed).integers(0, 128, n)]


@pytest.fixture(scope="module")
def isolated_tokens(models):
    """``fn(request) -> tokens``: the request served alone by a FIFO
    scheduler on a single-slot engine of its own."""
    eng = _engine(models[2], slots=1)
    memo = {}

    def run(request):
        key = (tuple(request.prompt), request.max_new_tokens,
               request.eos_id, request.temperature, request.top_k,
               request.seed)
        if key not in memo:
            eng.reset()
            sched = sv.ContinuousBatchingScheduler(eng, max_queue=4)
            sched.submit(sv.Request("ref", request.prompt,
                                    max_new_tokens=request.max_new_tokens,
                                    eos_id=request.eos_id,
                                    temperature=request.temperature,
                                    top_k=request.top_k, seed=request.seed))
            memo[key] = sched.run()["ref"].tokens
        return memo[key]

    return run


def _outcome(results):
    """What a run decided, request by request (not the tokens)."""
    return {rid: (r.finish_reason, r.preemptions, len(r.tokens), r.ttft_s
                  if r.tokens else None, r.total_s)
            for rid, r in results.items()}


def _assert_streams_match_jax(results, jresults, prompts, jeng):
    for rid, res in results.items():
        ours, ref = res.tokens, jresults[rid].tokens
        if ours == ref:
            continue
        p = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_TPU_KERNELS", "interpret")
            jeng.reset()
            jl = np.sort(np.asarray(jeng.prefill(0, list(prompts[rid])
                                                 + ref[:p])))
            jeng.release(0)
        assert jl[-1] - jl[-2] < NEAR_TIE, (rid, p)


# ---------------------------------------------------------------------------
# policy units
# ---------------------------------------------------------------------------


class TestPolicyUnits:
    def test_policy_validation(self):
        for pkg in (sv, jsv):
            with pytest.raises(ValueError, match="weights must be > 0"):
                pkg.SchedulingPolicy(tenant_weights={"a": 0.0})
            with pytest.raises(ValueError, match="default_tenant_weight"):
                pkg.SchedulingPolicy(default_tenant_weight=-1.0)
            with pytest.raises(ValueError, match="max_inflight_per_tenant"):
                pkg.SchedulingPolicy(max_inflight_per_tenant=0)
        pol = sv.SchedulingPolicy(tenant_weights={"paid": 3.0})
        assert pol.weight_of("paid") == 3.0
        assert pol.weight_of("anyone_else") == 1.0

    def test_wrr_smooth_proportions_and_determinism(self):
        pol = sv.SchedulingPolicy(tenant_weights={"a": 3.0, "b": 1.0})

        def picks(n):
            wrr = sv.WeightedRoundRobin(pol)
            return [wrr.pick(["a", "b"]) for _ in range(n)]

        seq = picks(8)
        assert seq == picks(8)
        assert seq.count("a") == 6 and seq.count("b") == 2
        assert "b" in seq[:4] and "b" in seq[4:]

    @pytest.mark.parametrize("seed", range(2))
    def test_wrr_picks_equal_jax_on_random_eligibility(self, seed):
        rng = np.random.default_rng(seed)
        weights = {"a": 3.0, "b": 1.0, "c": 0.5}
        ours = sv.WeightedRoundRobin(sv.SchedulingPolicy(
            tenant_weights=weights, default_tenant_weight=2.0))
        ref = jsv.WeightedRoundRobin(jsv.SchedulingPolicy(
            tenant_weights=weights, default_tenant_weight=2.0))
        for _ in range(300):
            eligible = [t for t in "abcd" if rng.random() < 0.6]
            if rng.random() < 0.1:
                snap, jsnap = ours.snapshot(), ref.snapshot()
                ours.pick(eligible), ref.pick(eligible)
                ours.restore(snap), ref.restore(jsnap)
            assert ours.pick(eligible) == ref.pick(eligible)
            assert ours.snapshot() == ref.snapshot()

    def test_wrr_snapshot_restore_and_starvation_credit(self):
        wrr = sv.WeightedRoundRobin(sv.SchedulingPolicy())
        assert wrr.pick([]) is None
        snap = wrr.snapshot()
        first = wrr.pick(["a", "b"])
        wrr.restore(snap)
        assert wrr.pick(["a", "b"]) == first
        for _ in range(3):
            wrr.pick(["a"])
        wrr._credit["b"] = 5.0
        assert wrr.pick(["a", "b"]) == "b"

    def test_request_control_fields_validated_at_submit(self, engine):
        sched = sv.ContinuousBatchingScheduler(engine, max_queue=4)
        with pytest.raises(ValueError, match="deadline_s"):
            sched.submit(sv.Request("d", [1, 2], max_new_tokens=1,
                                    deadline_s=0.0))
        with pytest.raises(ValueError, match="tenant"):
            sched.submit(sv.Request("t", [1, 2], max_new_tokens=1,
                                    tenant=""))
        assert sched.queue_depth == 0


# ---------------------------------------------------------------------------
# lossless capture / restore
# ---------------------------------------------------------------------------


class TestEngineCapture:
    def test_capture_restore_logits_across_boundary(self, models):
        """Prefill + 3 decodes, capture, release, restore into the other
        slot, 3 more decodes: the tokens and every logits row of the
        uninterrupted run (the rows within 1e-6: the slot's row of a
        decode product sits elsewhere in it)."""
        prompt = _prompt(5, 20)
        eng = _engine(models[2], slots=2)

        def drive(interrupt):
            eng.reset()
            toks = [int(np.argmax(eng.prefill(0, prompt).numpy()))]
            rows, slot = [], 0
            for i in range(6):
                if interrupt and i == 3:
                    k, v, n = eng.capture_slot(slot)
                    assert n == len(prompt) + len(toks) - 1
                    assert k.device.type == "cpu" and k.shape[1] == n
                    eng.release(slot)
                    slot = 1
                    eng.restore_prefix(slot, (k, v), n)
                tok = np.zeros((2,), np.int64)
                act = np.zeros((2,), bool)
                tok[slot], act[slot] = toks[-1], True
                row = eng.decode(tok, act)[slot].numpy()
                rows.append(row)
                toks.append(int(np.argmax(row)))
            return toks, rows

        ref_toks, ref_rows = drive(False)
        got_toks, got_rows = drive(True)
        assert got_toks == ref_toks
        for a, b in zip(ref_rows, got_rows):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)

    def test_capture_guards(self, models):
        eng = _engine(models[2], slots=2)
        with pytest.raises(ValueError, match="empty"):
            eng.capture_slot(0)
        paged = _engine(models[2], paged=True)
        with pytest.raises(ValueError, match="by reference"):
            paged.capture_slot(0)


# ---------------------------------------------------------------------------
# preemption end to end
# ---------------------------------------------------------------------------


def _preempt_run(pkg, eng, clock):
    sched = pkg.ContinuousBatchingScheduler(
        eng, max_queue=8, policy=pkg.SchedulingPolicy(), clock=clock)
    lo = pkg.Request("lo", _prompt(1), max_new_tokens=10, priority=0)
    hi = pkg.Request("hi", _prompt(2), max_new_tokens=4, priority=5)
    sched.submit(lo)
    for _ in range(3):
        sched.step()
        clock.advance(0.25)
    phase = sched.phase_of("lo").value
    sched.submit(hi)
    while sched.queue_depth or sched.active_count or sched.suspended_count:
        sched.step()
        clock.advance(0.25)
    return sched, phase


class TestLosslessPreemption:
    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_preempt_resume_matches_jax_and_alone(self, models, paged,
                                                  isolated_tokens):
        """A priority-5 arrival evicts the lone priority-0 DECODE stream;
        both finish with their streams alone, the victim as
        ``preempted-resumed`` after one preemption; outcomes, latencies
        and counts equal the JAX scheduler's."""
        eng = _engine(models[2], slots=1, paged=paged)
        sched, phase = _preempt_run(sv, eng, sv.VirtualClock())
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_TPU_KERNELS", "interpret")
            jeng = _jax_engine(models, slots=1, paged=paged)
            jsched, jphase = _preempt_run(jsv, jeng, jsv.VirtualClock())
        results = sched.results
        assert phase == jphase == "decode"
        assert results["lo"].finish_reason == "preempted-resumed"
        assert results["lo"].preemptions == 1
        assert results["hi"].finish_reason == "length"
        assert _outcome(results) == _outcome(jsched.results)
        assert sched.control_stats == jsched.control_stats == {
            "preempted": 1, "resumed": 1, "cancelled": 0, "shed": 0}
        _assert_streams_match_jax(results, jsched.results,
                                  {"lo": _prompt(1), "hi": _prompt(2)}, jeng)
        for rid, seed, n in (("lo", 1, 10), ("hi", 2, 4)):
            assert results[rid].tokens == isolated_tokens(
                sv.Request(rid, _prompt(seed), max_new_tokens=n))
        if paged:
            # the suspension hold was dropped after the alias: no copy on
            # write, and the pool drained
            assert eng.cow_copies == 0
            assert eng.block_pool.used_blocks == 0

    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_preempt_resume_on_an_int8_engine(self, models, paged):
        """The same preemption on an int8 engine (weights and KV): the
        capture dequantizes, the restore quantizes again (payload bit for
        bit) or the paged blocks are aliased, and both streams equal the
        requests served alone on an int8 engine."""
        def engine(slots):
            return sv.DecodeEngine(
                models[2], device="cpu", slots=slots, max_len=MAX,
                prefill_len=32, quant=sv.QuantConfig(),
                paged=sv.PagedCacheConfig(block_size=16) if paged else None)

        sched, _ = _preempt_run(sv, engine(1), sv.VirtualClock())
        results = sched.results
        assert results["lo"].finish_reason == "preempted-resumed"
        assert sched.control_stats["resumed"] == 1
        alone = engine(1)
        for rid, seed, n in (("lo", 1, 10), ("hi", 2, 4)):
            alone.reset()
            ref = sv.ContinuousBatchingScheduler(alone)
            ref.submit(sv.Request(rid, _prompt(seed), max_new_tokens=n))
            assert results[rid].tokens == ref.run()[rid].tokens, rid
        if paged:
            assert sched.engine.cow_copies == 0
            assert sched.engine.block_pool.used_blocks == 0

    def test_loadgen_drains_suspended_streams(self, eng1):
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=8, policy=sv.SchedulingPolicy(),
            clock=sv.VirtualClock())
        wl = sv.OpenLoopWorkload(
            requests=(sv.Request("lo", _prompt(1), max_new_tokens=12),
                      sv.Request("hi", _prompt(2), max_new_tokens=2,
                                 priority=5)),
            arrivals=(0.0, 1.0), deadlines=(None, None))
        out = sv.LoadGenerator(sched, wl, step_time_s=0.25).run()
        assert sched.control_stats["preempted"] == 1
        assert sched.suspended_count == 0
        assert out.results["lo"].finish_reason == "preempted-resumed"
        assert out.results["hi"].finish_reason == "length"
        assert out.completed == 2
        sched.close()

    def test_paged_no_preempt_for_infeasible_admission(self, models):
        """The pool (3 allocatable blocks) cannot cover the priority-5
        admission while the victim lives: the victim is not evicted; it
        finishes, frees its blocks, and the admission serves."""
        eng = _engine(models[2], slots=1, paged=True, num_blocks=4)
        sched = sv.ContinuousBatchingScheduler(
            eng, max_queue=8, policy=sv.SchedulingPolicy(),
            clock=sv.VirtualClock())
        sched.submit(sv.Request("lo", _prompt(1), max_new_tokens=10))
        for _ in range(3):
            sched.step()
        sched.submit(sv.Request("hi", _prompt(2), max_new_tokens=24,
                                priority=5))
        results = sched.run()
        assert sched.control_stats["preempted"] == 0
        assert results["lo"].finish_reason == "length"
        assert results["hi"].finish_reason == "length"
        assert eng.block_pool.used_blocks == 0

    def test_equal_priority_never_preempts(self, eng1):
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=8, policy=sv.SchedulingPolicy())
        sched.submit(sv.Request("a", _prompt(1), max_new_tokens=6,
                                priority=3))
        for _ in range(3):
            sched.step()
        sched.submit(sv.Request("b", _prompt(2), max_new_tokens=3,
                                priority=3))
        results = sched.run()
        assert sched.control_stats["preempted"] == 0
        assert results["a"].finish_reason == "length"

    def test_neighbor_stream_untouched_by_preemption(self, engine,
                                                     isolated_tokens):
        sched = sv.ContinuousBatchingScheduler(
            engine, max_queue=8, policy=sv.SchedulingPolicy())
        keep = sv.Request("keep", _prompt(11), max_new_tokens=12, priority=1)
        lo = sv.Request("lo", _prompt(12), max_new_tokens=12, priority=0)
        hi = sv.Request("hi", _prompt(13), max_new_tokens=3, priority=5)
        sched.submit(keep)
        sched.submit(lo)
        for _ in range(3):
            sched.step()
        sched.submit(hi)
        results = sched.run()
        assert sched.control_stats["preempted"] == 1
        assert results["lo"].preemptions == 1
        for req in (keep, lo, hi):
            assert results[req.rid].tokens == isolated_tokens(req), req.rid
        assert results["keep"].finish_reason == "length"


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------


class TestCancel:
    def test_cancel_every_phase_and_unknown(self, eng1):
        sched = sv.ContinuousBatchingScheduler(eng1, max_queue=8)
        sched.submit(sv.Request("a", _prompt(1), max_new_tokens=8))
        sched.submit(sv.Request("b", _prompt(2), max_new_tokens=4))
        sched.step()
        assert sched.queued_rids == ["b"] and sched.active_rids == ["a"]
        assert sched.cancel("b") is True
        for _ in range(2):
            sched.step()
        assert sched.progress_of("a") == 4     # first token + 3 decodes
        assert sched.cancel("a") is True
        assert eng1.free_slots() == [0]
        results = sched.run()
        assert results["a"].finish_reason == "cancelled"
        assert 0 < len(results["a"].tokens) < 8
        assert results["b"].finish_reason == "cancelled"
        assert results["b"].tokens == [] and np.isnan(results["b"].ttft_s)
        assert sched.cancel("a") is False
        with pytest.raises(KeyError, match="unknown rid"):
            sched.cancel("never-submitted")
        assert sched.control_stats == dict(ZERO_CONTROL, cancelled=2)
        assert sched.phase_of("a") is sv.RequestPhase.DONE
        assert sched.phase_of("nobody") is sv.RequestPhase.QUEUED

    def test_cancel_suspended_releases_paged_hold(self, models):
        eng = _engine(models[2], slots=1, paged=True)
        sched = sv.ContinuousBatchingScheduler(
            eng, max_queue=8, policy=sv.SchedulingPolicy())
        sched.submit(sv.Request("lo", _prompt(1), max_new_tokens=10))
        for _ in range(3):
            sched.step()
        sched.submit(sv.Request("hi", _prompt(2), max_new_tokens=4,
                                priority=5))
        sched.step()
        assert sched.suspended_count == 1
        assert sched.phase_of("lo") is sv.RequestPhase.DECODE
        assert sched.progress_of("lo") == 4
        assert eng.block_pool.used_blocks > 0
        assert sched.cancel("lo") is True
        results = sched.run()
        assert results["lo"].finish_reason == "cancelled"
        assert results["lo"].preemptions == 1
        assert results["hi"].finish_reason == "length"
        assert eng.block_pool.used_blocks == 0

    def test_cancel_mid_prefill_releases_prefix_pins(self, eng1):
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=4, prefill_budget=16,
            prefix_caching=sv.PrefixCacheConfig(max_tokens=64))
        sched.submit(sv.Request("long", _prompt(3, 48), max_new_tokens=2))
        sched.step()
        assert sched.phase_of("long") is sv.RequestPhase.PREFILL
        pc = sched.prefix_cache
        assert [e for e in pc._entries.values() if e.refs]
        assert sched.cancel("long") is True
        assert not [e for e in pc._entries.values() if e.refs]
        sched.run()
        sched.close()

    def test_cancel_neighbor_isolation(self, engine, isolated_tokens):
        sched = sv.ContinuousBatchingScheduler(engine, max_queue=8)
        keep = sv.Request("keep", _prompt(21), max_new_tokens=8)
        gone = sv.Request("gone", _prompt(22), max_new_tokens=8)
        sched.submit(keep)
        sched.submit(gone)
        for _ in range(3):
            sched.step()
        sched.cancel("gone")
        results = sched.run()
        assert results["keep"].tokens == isolated_tokens(keep)


# ---------------------------------------------------------------------------
# deadline shedding
# ---------------------------------------------------------------------------


class TestDeadlineShedding:
    def test_shed_at_admission_and_mid_queue(self, eng1):
        """A request expiring behind a long stream is shed without a
        prefill chunk; a deadline-free neighbour is served."""
        clk = sv.VirtualClock()
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=8, policy=sv.SchedulingPolicy(), clock=clk)
        chunks0 = eng1.prefill_chunks
        sched.submit(sv.Request("slow", _prompt(1), max_new_tokens=12))
        sched.step()
        sched.submit(sv.Request("due", _prompt(2), max_new_tokens=2,
                                deadline_s=1.0))
        sched.submit(sv.Request("ok", _prompt(3), max_new_tokens=2))
        clk.advance(0.5)
        assert sched.step() == []
        assert sched.phase_of("due") is sv.RequestPhase.QUEUED
        clk.advance(1.0)
        assert "due" in sched.step()
        results = sched.run()
        assert results["due"].finish_reason == "shed"
        assert results["due"].tokens == []
        assert results["due"].total_s == 1.5
        assert results["ok"].finish_reason == "length"
        assert results["slow"].finish_reason == "length"
        # one chunk each for "slow" and "ok", none for "due"
        assert eng1.prefill_chunks - chunks0 == 2
        assert sched.control_stats == dict(ZERO_CONTROL, shed=1)

    def test_loadgen_charges_policy_sheds_to_goodput(self, eng1):
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=8, policy=sv.SchedulingPolicy(),
            clock=sv.VirtualClock())
        wl = sv.make_workload([_prompt(i) for i in range(4)],
                              sv.uniform_arrivals(4, 100.0),
                              max_new_tokens=8, deadline_s=2.0)
        out = sv.LoadGenerator(sched, wl, step_time_s=0.5).run()
        reasons = {r.rid: r.finish_reason for r in out.results.values()}
        assert "shed" in set(reasons.values())
        served = [rid for rid, why in reasons.items()
                  if why in sv.SERVED_REASONS]
        assert out.completed == len(served) < 4
        for rid, why in reasons.items():
            if why == "shed":
                assert out.met_deadline[rid] is False
        assert out.goodput < 1.0

    def test_shedding_off_keeps_expired_requests(self, eng1):
        clk = sv.VirtualClock()
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=8, clock=clk,
            policy=sv.SchedulingPolicy(deadline_shedding=False))
        sched.submit(sv.Request("x", _prompt(1), max_new_tokens=2,
                                deadline_s=0.5))
        clk.advance(2.0)
        results = sched.run()
        assert results["x"].finish_reason == "length"
        assert sched.control_stats["shed"] == 0


# ---------------------------------------------------------------------------
# tenant fairness
# ---------------------------------------------------------------------------


def _admission_order(sched):
    """Step ``sched`` to the end; the rids in the order they took a
    slot."""
    order = []
    while sched.queue_depth or sched.active_count:
        sched.step()
        order += [r for r in sched.active_rids + list(sched.results)
                  if r not in order]
    return order


class TestTenantFairness:
    def test_inflight_cap_blocks_a_flood(self, engine):
        sched = sv.ContinuousBatchingScheduler(
            engine, max_queue=16,
            policy=sv.SchedulingPolicy(max_inflight_per_tenant=1))
        for i in range(3):
            sched.submit(sv.Request(f"a{i}", _prompt(i), max_new_tokens=4,
                                    tenant="A"))
        for i in range(2):
            sched.submit(sv.Request(f"b{i}", _prompt(10 + i),
                                    max_new_tokens=4, tenant="B"))
        order = []
        while sched.queue_depth or sched.active_count:
            sched.step()
            tenants = [rid[0] for rid in sched.active_rids]
            assert tenants.count("a") <= 1 and tenants.count("b") <= 1
            order += [r for r in sched.active_rids if r not in order]
        assert order.index("b0") < order.index("a2")

    def test_wrr_interleaves_admissions_by_weight(self, eng1):
        """One slot, everything queued first: the admission order is the
        WRR order, 2:1, interleaved (the JAX test's order)."""
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=16,
            policy=sv.SchedulingPolicy(tenant_weights={"A": 2.0, "B": 1.0}))
        for i in range(4):
            sched.submit(sv.Request(f"a{i}", _prompt(i), max_new_tokens=2,
                                    tenant="A"))
        for i in range(2):
            sched.submit(sv.Request(f"b{i}", _prompt(10 + i),
                                    max_new_tokens=2, tenant="B"))
        assert _admission_order(sched) == ["a0", "b0", "a1", "a2", "b1",
                                           "a3"]


# ---------------------------------------------------------------------------
# satellites: rid reuse, the stall bound, close()
# ---------------------------------------------------------------------------


class TestSatellites:
    def test_duplicate_rid_semantics_preserved(self, eng1):
        sched = sv.ContinuousBatchingScheduler(eng1, max_queue=8)
        sched.submit(sv.Request("r", _prompt(1), max_new_tokens=2))
        with pytest.raises(ValueError, match="in flight"):
            sched.submit(sv.Request("r", _prompt(2), max_new_tokens=2))
        sched.run()
        with pytest.raises(ValueError, match="finished"):
            sched.submit(sv.Request("r", _prompt(2), max_new_tokens=2))
        assert sched.pop_result("r").finish_reason == "length"
        assert sched.results == {}
        sched.submit(sv.Request("r", _prompt(2), max_new_tokens=2))
        sched.run()
        assert set(sched.pop_results()) == {"r"}
        sched.submit(sv.Request("r", _prompt(3), max_new_tokens=2))
        sched.run()

    def test_run_raises_scheduler_stalled(self, eng1):
        sched = sv.ContinuousBatchingScheduler(eng1, max_queue=8)
        sched.submit(sv.Request("r", _prompt(1), max_new_tokens=2))
        sched.step = lambda: []
        with pytest.raises(sv.SchedulerStalled) as exc:
            sched.run()
        assert "1 queued" in str(exc.value)
        assert "prefill backlog" in str(exc.value)
        with pytest.raises(sv.SchedulerStalled):
            sched.run(max_steps=3)

    def test_derived_bound_is_generous_for_healthy_drains(self, eng1):
        sched = sv.ContinuousBatchingScheduler(eng1, max_queue=8)
        for i in range(3):
            sched.submit(sv.Request(f"r{i}", _prompt(i), max_new_tokens=4))
        bound = sched._derived_step_bound()
        assert len(sched.run()) == 3
        assert sched.steps_run < bound / 2

    def test_close_twice_and_close_with_work(self, eng1):
        sched = sv.ContinuousBatchingScheduler(
            eng1, max_queue=4,
            prefix_caching=sv.PrefixCacheConfig(max_tokens=64))
        sched.submit(sv.Request("r", _prompt(1), max_new_tokens=8))
        with pytest.raises(RuntimeError, match="queued"):
            sched.close()
        sched.step()
        with pytest.raises(RuntimeError, match="active"):
            sched.close()
        sched.run()
        sched.close()
        sched.close()
        sched2 = sv.ContinuousBatchingScheduler(
            eng1, max_queue=8, policy=sv.SchedulingPolicy(),
            prefix_caching=sv.PrefixCacheConfig(max_tokens=64))
        sched2.submit(sv.Request("lo", _prompt(1), max_new_tokens=10))
        for _ in range(3):
            sched2.step()
        sched2.submit(sv.Request("hi", _prompt(2), max_new_tokens=4,
                                 priority=5))
        sched2.step()
        assert sched2.suspended_count == 1
        with pytest.raises(RuntimeError, match="suspended"):
            sched2.close()
        sched2.run()
        sched2.close()


# ---------------------------------------------------------------------------
# export / adopt
# ---------------------------------------------------------------------------


class TestExportAdopt:
    @pytest.mark.parametrize("capture", [True, False])
    def test_export_mid_decode_adopt_elsewhere(self, models, capture,
                                               isolated_tokens):
        """Two engines over one model: streams exported mid-decode (and a
        queued one) finish on the other scheduler with their streams
        alone; a captured stream resumes mid-stream (one preemption
        counted, no prefill chunk), a bare one is computed again."""
        donor = sv.ContinuousBatchingScheduler(_engine(models[2], slots=1),
                                               max_queue=8)
        reqs = [sv.Request("x", _prompt(31, 20), max_new_tokens=10),
                sv.Request("y", _prompt(32, 12), max_new_tokens=6)]
        for r in reqs:
            donor.submit(r)
        for _ in range(4):
            donor.step()
        assert donor.phase_of("x") is sv.RequestPhase.DECODE
        exports = donor.export_streams(capture=capture)
        assert [e.request.rid for e in exports] == ["x", "y"]
        assert (exports[0].kv is not None) == capture
        assert exports[1].kv is None and exports[0].weights_step is None
        donor.close()
        assert donor.engine.free_slots() == [0] and donor.results == {}
        target_eng = _engine(models[2], slots=1)
        target = sv.ContinuousBatchingScheduler(target_eng, max_queue=8)
        for e in exports:
            assert target.adopt_stream(e) is True
        with pytest.raises(ValueError, match="already live"):
            target.adopt_stream(exports[1])
        results = target.run()
        for r in reqs:
            assert results[r.rid].tokens == isolated_tokens(r), r.rid
        assert results["x"].preemptions == int(capture)
        assert target_eng.prefill_chunks == (1 if capture else 2)


# ---------------------------------------------------------------------------
# default-off identity: no policy is the FIFO scheduler
# ---------------------------------------------------------------------------


class TestDefaultOffIdentity:
    def test_policy_annotations_inert_without_policy(self, engine):
        """The same workload with and without control-plane annotations
        through policy-less schedulers: equal results (tokens, reasons,
        latencies), ``stats()``, ``control_stats`` (all zero),
        ``spec_stats`` and steps."""
        def one_run(annotated):
            engine.reset()
            sched = sv.ContinuousBatchingScheduler(
                engine, max_queue=8, clock=sv.VirtualClock())
            wl = sv.make_workload(
                [_prompt(i) for i in range(5)],
                sv.burst_arrivals(5, burst=2, period_s=1.0),
                max_new_tokens=3,
                deadline_s=0.75 if annotated else None,
                priorities=[5, 0] if annotated else None,
                tenants=["paid", "free"] if annotated else None)
            out = sv.LoadGenerator(sched, wl, step_time_s=0.25).run()
            return ({rid: (r.tokens, r.finish_reason, r.ttft_s, r.total_s,
                           r.preemptions) for rid, r in out.results.items()},
                    sched.stats(), sched.control_stats, sched.spec_stats,
                    sched.steps_run, out.steps)

        plain, annotated = one_run(False), one_run(True)
        assert annotated == plain
        assert plain[2] == ZERO_CONTROL


# ---------------------------------------------------------------------------
# an overloaded open-loop workload: policy against FIFO, port against JAX
# ---------------------------------------------------------------------------


def _overload(pkg):
    """Six priority-0 ``batch`` requests at t 0 fill both slots; at t 1
    two priority-5 ``paid`` requests (deadline 4 s) and two priority-0
    ones whose 0.5 s deadline expires in the queue."""
    reqs, arrivals = [], []
    for i in range(6):
        reqs.append(pkg.Request(f"b{i}", _prompt(100 + i, 8 + 6 * i),
                                max_new_tokens=6, tenant="batch"))
        arrivals.append(0.0)
    for i in range(2):
        reqs.append(pkg.Request(f"p{i}", _prompt(200 + i, 10),
                                max_new_tokens=6, priority=5, tenant="paid",
                                deadline_s=4.0))
        arrivals.append(1.0)
    for i in range(2):
        reqs.append(pkg.Request(f"e{i}", _prompt(300 + i, 10),
                                max_new_tokens=6, deadline_s=0.5))
        arrivals.append(1.0)
    return pkg.OpenLoopWorkload(
        requests=tuple(reqs), arrivals=tuple(arrivals),
        deadlines=tuple(r.deadline_s for r in reqs))


def _overload_run(pkg, eng, policy):
    sched = pkg.ContinuousBatchingScheduler(
        eng, max_queue=16, policy=policy, clock=pkg.VirtualClock())
    out = pkg.LoadGenerator(sched, _overload(pkg), step_time_s=0.25).run()
    return sched, out


@pytest.fixture(scope="module")
def overload_runs(models):
    tmodel = models[2]
    runs = {}
    for name, policy in (("fifo", None), ("policy", "on")):
        for paged in (False, True):
            eng = _engine(tmodel, slots=2, paged=paged)
            runs[name, "paged" if paged else "dense"] = _overload_run(
                sv, eng, None if policy is None else sv.SchedulingPolicy(
                    tenant_weights={"paid": 3.0}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        jeng = _jax_engine(models, slots=2)
        for name, policy in (("fifo", None), ("policy", "on")):
            jeng.reset()
            runs[name, "jax"] = _overload_run(
                jsv, jeng, None if policy is None else jsv.SchedulingPolicy(
                    tenant_weights={"paid": 3.0}))
    runs["jeng"] = jeng
    return runs


class TestOverloadAgainstJax:
    def test_control_plane_exercised(self, overload_runs):
        stats = overload_runs["policy", "dense"][0].control_stats
        assert stats["preempted"] >= 1
        assert stats["resumed"] == stats["preempted"]
        assert stats["shed"] == 2 and stats["cancelled"] == 0
        assert overload_runs["fifo", "dense"][0].control_stats == \
            ZERO_CONTROL

    @pytest.mark.parametrize("name", ["fifo", "policy"])
    def test_decisions_and_latencies_equal_jax(self, overload_runs, name):
        sched, out = overload_runs[name, "dense"]
        jsched, jout = overload_runs[name, "jax"]
        assert _outcome(out.results) == _outcome(jout.results)
        assert sched.control_stats == jsched.control_stats
        assert out.goodput == jout.goodput and out.steps == jout.steps
        assert out.met_deadline == jout.met_deadline
        assert out.fingerprint == _overload(jsv).schedule_fingerprint()
        prompts = {r.rid: r.prompt for r in _overload(sv).requests}
        _assert_streams_match_jax(out.results, jout.results, prompts,
                                  overload_runs["jeng"])

    @pytest.mark.parametrize("name", ["fifo", "policy"])
    def test_paged_decides_as_dense(self, overload_runs, name):
        dense = overload_runs[name, "dense"]
        paged = overload_runs[name, "paged"]
        assert _outcome(paged[1].results) == _outcome(dense[1].results)
        assert {r: x.tokens for r, x in paged[1].results.items()} == \
            {r: x.tokens for r, x in dense[1].results.items()}
        eng = paged[0].engine
        assert eng.block_pool.used_blocks == 0 and eng.cow_copies == 0

    def test_served_streams_equal_alone(self, overload_runs,
                                        isolated_tokens):
        by_rid = {r.rid: r for r in _overload(sv).requests}
        resumed = 0
        for name in ("fifo", "policy"):
            for rid, res in overload_runs[name, "dense"][1].results.items():
                if res.finish_reason not in sv.SERVED_REASONS:
                    continue
                assert res.tokens == isolated_tokens(by_rid[rid]), rid
                resumed += res.finish_reason == "preempted-resumed"
        assert resumed >= 1

    def test_policy_beats_fifo_on_paid_ttft_and_goodput(self, overload_runs):
        def paid_p99(out):
            ttft = sorted(out.results[r].ttft_s for r in ("p0", "p1"))
            return ttft[-1]

        fifo, pol = overload_runs["fifo", "dense"][1], \
            overload_runs["policy", "dense"][1]
        assert paid_p99(pol) < paid_p99(fifo)
        assert pol.goodput > fifo.goodput
        assert {pol.results[r].finish_reason for r in ("e0", "e1")} == {"shed"}
