"""The open-loop load generator: apex_tpu_torch.serving.loadgen against
the JAX package's ``serving/loadgen.py``.

- **Units**: the arrival processes and prompt mixes return the JAX
  functions' tables and prompts for the same arguments and seeds; an
  ``OpenLoopWorkload`` refuses what the JAX one refuses; its fingerprint
  is the JAX fingerprint of the same workload; ``VirtualClock`` and
  ``chain_hooks`` behave as the JAX ones.
- **Runs on a virtual clock** (``step_time_s`` 0.25, so every latency is
  a multiple of the step): the exact latency arithmetic of a one-chunk
  prompt (TTFT 0.0, total 0.25), a prompt cut into two budgeted chunks
  (TTFT 0.25), a request due mid-step (its deadline counts from arrival,
  not submission), and a burst past the queue (the overflow shed and
  charged to goodput): results, goodput, deadlines met, steps and
  duration equal the JAX generator's over the same workload and model;
  streams reproduce by seed and do not move with the step's virtual
  cost.

The model is a small JAX ``LlamaForCausalLM`` (2 layers, hidden 64, vocab
128, fp32) carried to the port by ``models/convert.py``.
"""

import time

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
           max_position_embeddings=96)
ENGINE = dict(slots=4, max_len=96, prefill_len=16)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def engines(models):
    """``pkg -> engine`` for the port and the JAX package, over the same
    weights, shared by the runs (slots are free after each drain)."""
    jmodel, params, tmodel = models
    return {sv: sv.DecodeEngine(tmodel, device="cpu", **ENGINE),
            jsv: jsv.DecodeEngine(jmodel, params, **ENGINE)}


def _run(pkg, engines, workload, *, step_time_s=0.25, **sched_kw):
    eng = engines[pkg]
    eng.reset()
    sched = pkg.ContinuousBatchingScheduler(eng, clock=pkg.VirtualClock(),
                                            **sched_kw)
    return pkg.LoadGenerator(sched, workload(pkg),
                             step_time_s=step_time_s).run()


def _both(engines, workload, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        ref = _run(jsv, engines, workload, **kw)
    return _run(sv, engines, workload, **kw), ref


def _summary(out):
    return (out.offered, out.completed, out.rejected, out.goodput,
            out.met_deadline, out.arrivals, out.deadlines, out.duration_s,
            out.steps,
            {rid: (r.tokens, r.finish_reason, r.ttft_s, r.total_s)
             for rid, r in out.results.items()})


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def test_arrival_processes_equal_jax():
    assert sv.uniform_arrivals(4, 2.0) == (0.0, 0.5, 1.0, 1.5)
    for args in ((4, 2.0), (7, 3.0)):
        assert sv.uniform_arrivals(*args) == jsv.uniform_arrivals(*args)
    for seed in (3, 4):
        a = sv.poisson_arrivals(16, 5.0, seed=seed)
        assert a == jsv.poisson_arrivals(16, 5.0, seed=seed)
        assert a[0] == 0.0 and all(y >= x for x, y in zip(a, a[1:]))
    assert sv.poisson_arrivals(16, 5.0, seed=3) != sv.poisson_arrivals(
        16, 5.0, seed=4)
    assert sv.burst_arrivals(6, burst=2, period_s=1.0) == (
        0.0, 0.0, 1.0, 1.0, 2.0, 2.0)
    kw = dict(burst=2, period_s=1.0, spacing_s=0.25)
    assert sv.burst_arrivals(4, **kw) == jsv.burst_arrivals(4, **kw) == (
        0.0, 0.25, 1.0, 1.25)
    for bad in ((sv.uniform_arrivals, (0, 1.0)),
                (sv.uniform_arrivals, (4, 0.0)),
                (sv.poisson_arrivals, (4, -1.0))):
        with pytest.raises(ValueError):
            bad[0](*bad[1])
    with pytest.raises(ValueError, match="outlasts"):
        sv.burst_arrivals(4, burst=3, period_s=1.0, spacing_s=0.5)


def test_prompt_mixes_equal_jax():
    kw = dict(shared_len=8, suffix_len=3, vocab=128, seed=1)
    sp = sv.shared_prefix_prompts(4, **kw)
    assert sp == jsv.shared_prefix_prompts(4, **kw)
    assert all(p[:8] == sp[0][:8] for p in sp)
    assert len({tuple(p) for p in sp}) == 4
    kw = dict(length=6, vocab=128, seed=2)
    assert sv.zero_overlap_prompts(3, **kw) == jsv.zero_overlap_prompts(
        3, **kw)
    for kw in (dict(prefill_len=64, vocab=128),
               dict(prefill_len=64, vocab=128, seed=5, max_len=20)):
        ml = sv.mixed_length_prompts(8, **kw)
        assert ml == jsv.mixed_length_prompts(8, **kw)
    assert [len(p) for p in sv.mixed_length_prompts(
        8, prefill_len=64, vocab=128)] == [
        max(1, int(64 * f)) for f in sv.loadgen.LENGTH_SKEW_FRACTIONS]


def test_workload_validation():
    reqs = (sv.Request("a", [1], 2), sv.Request("b", [1], 2))
    with pytest.raises(ValueError, match="mismatch"):
        sv.OpenLoopWorkload(reqs, (0.0,), (None, None))
    with pytest.raises(ValueError, match="non-decreasing"):
        sv.OpenLoopWorkload(reqs, (1.0, 0.5), (None, None))
    with pytest.raises(ValueError, match="< 0"):
        sv.OpenLoopWorkload(reqs, (-1.0, 0.5), (None, None))
    with pytest.raises(ValueError, match="positive"):
        sv.OpenLoopWorkload(reqs, (0.0, 1.0), (0.0, None))
    dup = (sv.Request("a", [1], 2), sv.Request("a", [1], 2))
    with pytest.raises(ValueError, match="duplicate"):
        sv.OpenLoopWorkload(dup, (0.0, 1.0), (None, None))
    with pytest.raises(ValueError, match="empty"):
        sv.OpenLoopWorkload((), (), ())
    with pytest.raises(ValueError, match="prompts vs"):
        sv.make_workload([[1], [2]], (0.0,), max_new_tokens=1)


def test_make_workload_and_fingerprint_equal_jax():
    def wl(pkg, prompts=([1, 2], [3, 4]), arrivals=(0.0, 1.0), n=4):
        return pkg.make_workload(list(prompts), arrivals, max_new_tokens=n,
                                 deadline_s=2.0, seed=7, rid_prefix="w",
                                 priorities=[5, 0], tenants=["paid"])
    ours, ref = wl(sv), wl(jsv)
    assert ours.schedule_fingerprint() == ref.schedule_fingerprint()
    for a, b in zip(ours.requests, ref.requests):
        assert _request_fields(a) == _request_fields(b)
    assert ours.deadlines == (2.0, 2.0) and ours.offered == 2
    assert ours.offered_rps == 1.0
    assert wl(sv).schedule_fingerprint() == ours.schedule_fingerprint()
    for other in (wl(sv, prompts=([1, 2], [3, 5])),
                  wl(sv, arrivals=(0.0, 1.5)), wl(sv, n=5)):
        assert other.schedule_fingerprint() != ours.schedule_fingerprint()
    single = sv.make_workload([[1]], (0.0,), max_new_tokens=1)
    assert single.offered_rps == float("inf")
    assert single.requests[0].tenant == "default"


def _request_fields(request):
    return (request.rid, list(request.prompt), request.max_new_tokens,
            request.eos_id, request.temperature, request.top_k, request.seed,
            request.priority, request.deadline_s, request.tenant)


def test_virtual_clock_and_chain_hooks():
    clk = sv.VirtualClock(1.0)
    assert clk() == 1.0 and clk.advance(0.25) == 1.25 and clk() == 1.25
    with pytest.raises(ValueError):
        clk.advance(-0.1)
    assert sv.chain_hooks(None, None) is None
    calls = []
    hook = sv.chain_hooks(lambda s, x: calls.append(("a", s)), None,
                          lambda s, x: calls.append(("b", s)))
    hook(3, None)
    assert calls == [("a", 3), ("b", 3)]


def test_generator_guards(engines):
    def wl(pkg):
        return pkg.make_workload([[1, 2, 3]], (0.0,), max_new_tokens=2)
    eng = engines[sv]
    sched = sv.ContinuousBatchingScheduler(eng, clock=time.monotonic)
    with pytest.raises(ValueError, match="advanceable"):
        sv.LoadGenerator(sched, wl(sv), step_time_s=0.25)
    with pytest.raises(ValueError, match="step_time_s"):
        sv.LoadGenerator(sv.ContinuousBatchingScheduler(
            eng, clock=sv.VirtualClock()), wl(sv), step_time_s=0.0)
    # a clock that never moves and an arrival still to come: refuse
    # instead of spinning
    future = sv.make_workload([[1, 2], [3, 4]], (0.0, 10.0),
                              max_new_tokens=1)
    eng.reset()
    gen = sv.LoadGenerator(sv.ContinuousBatchingScheduler(
        eng, clock=sv.VirtualClock()), future)
    with pytest.raises(RuntimeError, match="did not advance"):
        gen.run()


def test_real_clock_run_serves_everything(engines):
    eng = engines[sv]
    eng.reset()
    sched = sv.ContinuousBatchingScheduler(eng)
    wl = sv.make_workload(sv.zero_overlap_prompts(3, length=5, vocab=128),
                          (0.0, 0.0, 0.0), max_new_tokens=2)
    out = sv.LoadGenerator(sched, wl).run()
    assert out.completed == 3 and out.goodput is None
    assert out.duration_s > 0 and out.fingerprint == \
        wl.schedule_fingerprint()


# ---------------------------------------------------------------------------
# runs on a virtual clock, against the JAX generator
# ---------------------------------------------------------------------------


def test_exact_latency_arithmetic_equals_jax(engines):
    """A one-chunk prompt admits, prefills, samples its first token and
    rides the same step's decode (TTFT 0.0), and its third token comes a
    step later (total 0.25)."""
    def wl(pkg):
        return pkg.make_workload([[5, 6, 7, 8]], (0.0,), max_new_tokens=3,
                                 deadline_s=10.0)
    out, ref = _both(engines, wl)
    res = out.results["lg0"]
    assert res.ttft_s == 0.0 and res.total_s == 0.25
    assert out.goodput == 1.0 and out.duration_s == 0.5
    assert _summary(out) == _summary(ref)


def test_chunked_prompt_ttft_spans_steps_equals_jax(engines):
    def wl(pkg):
        return pkg.make_workload([[1] * 8], (0.0,), max_new_tokens=1)
    out, ref = _both(engines, wl, prefill_budget=4)
    assert out.results["lg0"].ttft_s == 0.25
    assert _summary(out) == _summary(ref)


def test_deadline_counts_from_arrival_equals_jax(engines):
    """Arrival at 0.1, submitted at 0.25, finished at 0.5: 0.25 after
    submission (under the 0.3 deadline) but 0.4 after arrival — a miss."""
    def wl(pkg):
        return pkg.make_workload([[1, 2, 3]], (0.1,), max_new_tokens=3,
                                 deadline_s=0.3)
    out, ref = _both(engines, wl)
    assert out.arrivals["lg0"] == 0.1
    assert out.results["lg0"].total_s == 0.25
    assert out.met_deadline["lg0"] is False and out.goodput == 0.0
    assert _summary(out) == _summary(ref)


def test_queue_full_sheds_and_charges_goodput_equals_jax(engines):
    """Five arrivals before the first step into a 2-deep queue: three are
    shed (never retried), and goodput counts them against the offered."""
    def wl(pkg):
        return pkg.make_workload(
            pkg.zero_overlap_prompts(5, length=4, vocab=128, seed=4),
            (0.0,) * 5, max_new_tokens=2, deadline_s=100.0)
    out, ref = _both(engines, wl, max_queue=2)
    assert out.rejected == ["lg2", "lg3", "lg4"]
    assert out.completed == 2 and out.goodput == 2 / 5
    assert list(out.met_deadline.values()).count(True) == 2
    assert _summary(out) == _summary(ref)


def test_token_streams_reproducible_by_seed(engines):
    """Same seed, same workload, same streams; a different virtual step
    cost reorders nothing in any stream (sampled requests: the draws are
    the port's own, so they are not compared with JAX)."""
    def one_run(step_time):
        def wl(pkg):
            return pkg.make_workload(
                pkg.zero_overlap_prompts(6, length=7, vocab=128, seed=11),
                pkg.poisson_arrivals(6, 4.0, seed=11), max_new_tokens=4,
                temperature=0.8, top_k=8, seed=11)
        out = _run(sv, engines, wl, step_time_s=step_time)
        return out.fingerprint, {r: res.tokens
                                 for r, res in out.results.items()}

    fp_a, tokens_a = one_run(0.25)
    fp_b, tokens_b = one_run(0.25)
    assert fp_a == fp_b and tokens_a == tokens_b
    assert one_run(0.125)[1] == tokens_a
