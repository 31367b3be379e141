"""Speculative decoding: apex_tpu_torch.serving.draft and the engine's and
scheduler's speculative path against the JAX package.

One JAX ``LlamaForCausalLM`` (2 layers, hidden 64, 4 heads over 2 kv
heads, intermediate 128, vocab 128, fp32) is initialised in JAX and its
weights carried to the port through numpy (``models/convert.py``).

- **The drafter** (``propose``, ``adapt_k``, ``SpeculationConfig``) is
  the JAX module's copy: the same outputs and refusals on the same
  inputs.
- **``verify_draft`` against JAX's**: on a dense, a paged and an int8
  engine, the same prompt prefilled and the same drafts verified (the
  true continuation, then one corrupted at position 2): every row's fp32
  logits within ``atol = 1e-4``, ``accepted`` and the argmaxes equal,
  the slot's length ``offset + accepted + 1``.
- **Against the port's plain decode**: a verify row is a product of
  ``bucket + 1`` rows where a decode row is one of ``slots``, so the
  rows round differently (about 2e-7 here; on the card cuBLAS picks its
  algorithm by the row count): each emitted position's verify logits
  within ``atol = 1e-5`` of the plain decode logits at that depth, and
  the stream equal, across a forced rejection and with a neighbour slot
  prefilling between verifies.
- **The scheduler**: speculation on gives the plain streams in fewer
  steps; the streams, ``spec_stats`` and ``steps_run`` equal the JAX
  scheduler's over the same greedy requests (parting only at a JAX near
  tie, top-2 margin below 1e-3); an EOS inside an accepted draft and
  ``max_new_tokens`` end the stream where plain decode does; sampled
  requests never draft (``spec_stats`` zero, no verify); on an int8
  engine, dense and paged, speculation gives the plain int8 streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.serving import draft as jdraft
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.serving.draft import SpeculationConfig, adapt_k, propose

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
VOCAB = CFG["vocab_size"]
MAX = 96
NEAR_TIE = 1e-3
ZERO_SPEC = {"dispatches": 0, "drafted": 0, "accepted": 0, "emitted": 0}


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    return jmodel, params, tmodel


def _rep_prompt(n=30, seed=3):
    """A repetitive prompt: an n-gram-matchable motif repeated."""
    rng = np.random.default_rng(seed)
    motif = [int(x) for x in rng.integers(0, VOCAB, 6)]
    return (motif * ((n + 5) // 6))[:n]


def _rand_prompt(n=8, seed=11):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(0, VOCAB, n)]


def _engine(tmodel, prefill_len=16, slots=2, **kw):
    return sv.DecodeEngine(tmodel, device="cpu", slots=slots, max_len=MAX,
                           prefill_len=prefill_len, **kw)


@pytest.fixture(scope="module")
def eng_pair(models):
    """A (plain, speculative) engine pair shared by the scheduler tests:
    slots are free after each drain."""
    return _engine(models[2]), _engine(models[2])


def _plain_decode(eng, prompt, steps):
    """Greedy stream and per-step logits of ``prompt`` on slot 0, one
    decode a token (``logits[i]`` follows ``stream[i]``)."""
    eng.reset()
    logits = eng.prefill(0, list(prompt))
    stream, rows = [int(torch.argmax(logits))], []
    for _ in range(steps):
        row = eng.decode(np.array([stream[-1], 0]), np.array([True, False]))[0]
        rows.append(row.clone())
        stream.append(int(torch.argmax(row)))
    return stream, rows


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------


def test_prompt_lookup_proposes_continuations():
    assert propose([1, 2, 3, 4, 1, 2, 3], 3) == [4, 1, 2]
    assert propose([1, 2, 3, 4, 1, 2, 3], 1) == [4]
    h = [7, 1, 2, 3, 9, 1, 2, 3, 5, 1, 2, 3]
    assert propose(h, 2)[:1] == [5]
    assert propose([1, 2, 8, 1, 2, 9, 1, 2], 1) == [9]
    assert propose([9] * 10, 2) == [9, 9]
    assert propose([5, 6, 5, 6, 5, 6, 5, 6], 3) == [5, 6, 5]
    assert propose([9, 9, 9, 9], 2) == [9]
    assert propose([1, 2, 3, 4, 5], 3) == []
    assert propose([], 3) == [] and propose([1], 3) == []
    assert propose([1, 2, 3], 0) == []


@pytest.mark.parametrize("seed", range(3))
def test_propose_equals_jax_on_random_histories(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        h = [int(t) for t in rng.integers(0, 4, int(rng.integers(0, 40)))]
        k = int(rng.integers(0, 9))
        lo = int(rng.integers(1, 4))
        kw = dict(ngram_max=lo + int(rng.integers(0, 3)), ngram_min=lo)
        assert propose(h, k, **kw) == jdraft.propose(h, k, **kw), (h, k, kw)


def test_adaptive_k_policy_equals_jax():
    for cfg_kw in (dict(max_draft=8, min_draft=1), dict(max_draft=6,
                                                        min_draft=2),
                   dict(max_draft=6, adaptive=False)):
        ours, ref = SpeculationConfig(**cfg_kw), jdraft.SpeculationConfig(
            **cfg_kw)
        for k in range(1, 9):
            for drafted in range(0, 9):
                for accepted in range(0, drafted + 1):
                    assert adapt_k(k, drafted, accepted, ours) == \
                        jdraft.adapt_k(k, drafted, accepted, ref)
    cfg = SpeculationConfig(max_draft=8, min_draft=1)
    assert adapt_k(4, 4, 4, cfg) == 8 and adapt_k(8, 8, 7, cfg) == 4
    assert adapt_k(1, 1, 0, cfg) == 1 and adapt_k(4, 2, 2, cfg) == 8
    for bad in (dict(max_draft=0), dict(min_draft=4, max_draft=2),
                dict(ngram_min=0), dict(ngram_max=1, ngram_min=2)):
        with pytest.raises(ValueError):
            SpeculationConfig(**bad)
        with pytest.raises(ValueError):
            jdraft.SpeculationConfig(**bad)


# ---------------------------------------------------------------------------
# verify_draft against JAX's, dense, paged and int8
# ---------------------------------------------------------------------------

FORMS = {"dense": dict(), "paged": dict(paged="block16"),
         "int8": dict(quant=True)}


def _form_kw(pkg, form):
    kw = {}
    if "paged" in form:
        kw["paged"] = pkg.PagedCacheConfig(block_size=16)
    if "quant" in form:
        kw["quant"] = pkg.QuantConfig()
    return kw


@pytest.mark.parametrize("name", list(FORMS))
def test_verify_rows_match_jax(models, name):
    """The same prompt prefilled and the same drafts verified on both
    packages: the plain greedy continuation (7 of 7 accepted), then the
    next 5 tokens with the third corrupted (2 accepted)."""
    jmodel, params, tmodel = models
    form = FORMS[name]
    prompt = _rand_prompt(20, seed=5)
    stream, _ = _plain_decode(_engine(tmodel, **_form_kw(sv, form)), prompt,
                              14)
    wrong = list(stream[8:14])
    wrong[3] = (wrong[3] + 1) % VOCAB
    engine = _engine(tmodel, **_form_kw(sv, form))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        jeng = jsv.DecodeEngine(jmodel, params, slots=2, max_len=MAX,
                                prefill_len=16, **_form_kw(jsv, form))
        jeng.prefill(0, prompt)
        engine.prefill(0, prompt)
        for tokens, want in ((stream[:8], 7), (wrong, 2)):
            offset = int(engine.lengths()[0])
            assert offset == int(jeng.lengths()[0])
            ja, jg, jrows = jeng.verify_draft(0, tokens)
            a, g, rows = engine.verify_draft(0, tokens)
            assert a == int(ja) == want, (a, ja)
            assert rows.shape == (engine.draft_bucket_for(len(tokens) - 1)
                                  + 1, VOCAB)
            np.testing.assert_allclose(rows.numpy(), np.asarray(jrows),
                                       atol=1e-4, rtol=0)
            assert g.tolist() == np.asarray(jg).tolist()
            assert engine.lengths()[0] == offset + a + 1
            assert int(engine.cache.lengths[0]) == offset + a + 1
            # the bonus token is the plain stream's next token
            assert int(g[a]) == stream[offset - len(prompt) + a + 1]
    if engine.block_pool is not None:
        assert engine.cow_copies == 0
    assert engine.verify_calls == 2


# ---------------------------------------------------------------------------
# against the port's plain decode
# ---------------------------------------------------------------------------


def test_spec_decode_matches_plain_with_rejection_and_neighbor_prefill(
        models):
    """>= 40 greedy tokens by drafting and verifying: the plain stream,
    and each emitted position's verify row within 1e-5 of the plain
    decode row, across a forced rejection, with slot 1 prefilling a
    40-token prompt in chunks between verifies (its last chunk's logits
    equal its prefill alone, bit for bit)."""
    tmodel = models[2]
    prompt = _rep_prompt()
    n_steps = 44
    ref = _engine(tmodel)
    stream, plain = _plain_decode(ref, prompt, n_steps)
    long_prompt = _rand_prompt(n=40, seed=9)
    ref.reset()
    alone = ref.prefill(1, long_prompt)

    eng = _engine(tmodel)
    first = eng.prefill(0, list(prompt))
    assert int(torch.argmax(first)) == stream[0]
    emitted, checked, verifies, fed = [stream[0]], 0, 0, 0
    forced = False
    neighbour = None
    while len(emitted) - 1 < n_steps:
        if fed < len(long_prompt):
            neighbour = eng.prefill_chunk(1, long_prompt[fed:fed + 16])
            fed += 16
        draft = propose(list(prompt) + emitted, 4) or [emitted[-1]]
        if verifies == 5 and not forced:
            draft = [(stream[len(emitted)] + 1) % VOCAB] + draft[1:]
            forced = True
        accepted, greedy, rows = eng.verify_draft(0, [emitted[-1]] + draft)
        verifies += 1
        for i, tok in enumerate(list(draft[:accepted])
                                + [int(greedy[accepted])]):
            pos = len(emitted) - 1
            if pos >= n_steps:
                break
            torch.testing.assert_close(rows[i], plain[pos], atol=1e-5,
                                       rtol=0)
            checked += 1
            emitted.append(tok)
    assert emitted == stream[:len(emitted)]
    assert len(emitted) - 1 >= 40 and checked >= 40 and forced
    assert eng.decode_steps == 0 and eng.verify_calls == verifies
    assert fed >= len(long_prompt)
    assert torch.equal(neighbour, alone)


def test_verify_rejection_rolls_back_exactly(models):
    tmodel = models[2]
    prompt = _rand_prompt()
    stream, plain = _plain_decode(_engine(tmodel), prompt, 4)
    eng = _engine(tmodel)
    eng.prefill(0, list(prompt))
    wrong = [(stream[1] + 1) % VOCAB, (stream[2] + 1) % VOCAB]
    accepted, greedy, rows = eng.verify_draft(0, [stream[0]] + wrong)
    assert accepted == 0 and int(greedy[0]) == stream[1]
    torch.testing.assert_close(rows[0], plain[0], atol=1e-5, rtol=0)
    assert eng.lengths()[0] == len(prompt) + 1
    assert int(eng.cache.lengths[0]) == len(prompt) + 1
    accepted2, greedy2, rows2 = eng.verify_draft(0, stream[1:4])
    assert accepted2 == 2
    torch.testing.assert_close(rows2[1], plain[2], atol=1e-5, rtol=0)
    assert [int(greedy2[i]) for i in range(3)] == stream[2:5]


def test_verify_draft_guards(models):
    tmodel = models[2]
    eng = _engine(tmodel)
    with pytest.raises(ValueError, match="never prefilled"):
        eng.verify_draft(0, [1, 2])
    eng.prefill(0, [1, 2, 3])
    with pytest.raises(ValueError, match="no draft"):
        eng.verify_draft(0, [1])
    with pytest.raises(ValueError, match="draft length"):
        eng.verify_draft(0, [1] * (eng.max_draft + 2))
    with pytest.raises(ValueError, match="out of range"):
        eng.verify_draft(9, [1, 2])
    small = sv.DecodeEngine(tmodel, device="cpu", slots=1, max_len=8,
                            prefill_len=8, draft_buckets=(1, 4))
    small.prefill(0, [1] * 6)
    with pytest.raises(ValueError, match="overruns"):
        small.verify_draft(0, [1, 2, 3, 4])
    for buckets, match in (((8,), "< max_len"), ((4, 2), "ascending"),
                           ((0, 2), ">= 1")):
        with pytest.raises(ValueError, match=match):
            sv.DecodeEngine(tmodel, device="cpu", slots=1,
                            max_len=8 if buckets == (8,) else MAX,
                            prefill_len=8, draft_buckets=buckets)
    for n in (8, 6, 1):
        assert sv.default_draft_buckets(n) == jsv.default_draft_buckets(n)
    assert sv.default_draft_buckets(8) == (1, 2, 4, 8)
    assert eng.draft_buckets == (1, 2, 4, 8) and eng.max_draft == 8
    assert eng.draft_bucket_for(3) == 4
    with pytest.raises(ValueError):
        eng.draft_bucket_for(0)
    with pytest.raises(ValueError):
        sv.default_draft_buckets(0)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _run_sched(eng, requests, speculation=None, pkg=sv):
    eng.reset()
    sched = pkg.ContinuousBatchingScheduler(eng, speculation=speculation)
    for r in requests:
        sched.submit(r)
    return sched.run(), sched


def _greedy_requests(pkg):
    return [pkg.Request("greedy_rep", _rep_prompt(), max_new_tokens=40),
            pkg.Request("greedy_rand", _rand_prompt(), max_new_tokens=12)]


@pytest.fixture(scope="module")
def jax_spec(models):
    """The JAX scheduler over the greedy requests, with speculation."""
    jmodel, params, _ = models
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        jeng = jsv.DecodeEngine(jmodel, params, slots=2, max_len=MAX,
                                prefill_len=16)
        results, sched = _run_sched(jeng, _greedy_requests(jsv),
                                    jsv.SpeculationConfig(), pkg=jsv)
    return jeng, results, sched


def test_scheduler_spec_matches_jax_and_plain_in_fewer_steps(
        eng_pair, jax_spec):
    jeng, jresults, jsched = jax_spec
    plain, s_plain = _run_sched(eng_pair[0], _greedy_requests(sv))
    before = eng_pair[1].verify_calls
    spec, s_spec = _run_sched(eng_pair[1], _greedy_requests(sv),
                              SpeculationConfig())
    prompts = {r.rid: r.prompt for r in _greedy_requests(sv)}
    for rid in prompts:
        assert spec[rid].tokens == plain[rid].tokens, rid
        assert spec[rid].finish_reason == plain[rid].finish_reason
        ours, ref = spec[rid].tokens, jresults[rid].tokens
        if ours != ref:
            p = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("APEX_TPU_KERNELS", "interpret")
                jeng.reset()
                jl = np.sort(np.asarray(jeng.prefill(
                    0, list(prompts[rid]) + ref[:p])))
                jeng.release(0)
            assert jl[-1] - jl[-2] < NEAR_TIE, (rid, p)
    if all(spec[r].tokens == jresults[r].tokens for r in prompts):
        # the same streams make the same drafts and the same verifies
        assert s_spec.spec_stats == jsched.spec_stats
        assert s_spec.steps_run == jsched.steps_run
    assert s_spec.steps_run < s_plain.steps_run
    stats = s_spec.spec_stats
    assert stats["dispatches"] == eng_pair[1].verify_calls - before > 0
    assert stats["accepted"] <= stats["drafted"]
    # every verify emits its accepted draft and one bonus token, unless
    # the stream ended inside them
    assert stats["dispatches"] <= stats["emitted"] <= (
        stats["accepted"] + stats["dispatches"])
    assert s_plain.spec_stats == ZERO_SPEC


def test_spec_stats_count_every_verify(eng_pair):
    """``spec_stats`` in place of the JAX scheduler's verify events: one
    dispatch a ``verify_draft`` call, the drafted and accepted tokens
    summed over the calls, one emitted token more than accepted a verify
    (the bonus) unless the stream ended inside it, and every draft within
    the engine's buckets."""
    eng = eng_pair[1]
    calls = []
    inner = eng.verify_draft

    def verify(slot, tokens):
        out = inner(slot, tokens)
        calls.append((len(tokens) - 1, out[0]))
        return out

    eng.verify_draft = verify
    decodes0 = eng.decode_steps
    try:
        results, sched = _run_sched(eng, [sv.Request(
            "metrics_r", _rep_prompt(), max_new_tokens=24)],
            SpeculationConfig())
    finally:
        del eng.verify_draft
    stats = sched.spec_stats
    assert stats["dispatches"] == len(calls) > 0
    assert stats["drafted"] == sum(d for d, _ in calls)
    assert stats["accepted"] == sum(a for _, a in calls)
    assert all(0 <= a <= d and eng.draft_bucket_for(d) in eng.draft_buckets
               for d, a in calls)
    emitted = sum(a + 1 for _, a in calls)
    assert emitted - len(calls) < stats["emitted"] <= emitted
    # every token came from the first-token sample, a verify or a decode
    assert len(results["metrics_r"].tokens) == 1 + stats["emitted"] + (
        eng.decode_steps - decodes0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_scheduler_spec_on_an_int8_engine_matches_plain(models, paged):
    """Speculation on an int8 engine (weights and KV), dense and paged:
    the plain int8 streams, with verifies run."""
    def engine():
        return _engine(models[2], quant=sv.QuantConfig(),
                       paged=sv.PagedCacheConfig(block_size=16)
                       if paged else None)
    plain, _ = _run_sched(engine(), _greedy_requests(sv))
    spec, sched = _run_sched(engine(), _greedy_requests(sv),
                             SpeculationConfig())
    assert {r: x.tokens for r, x in spec.items()} == \
        {r: x.tokens for r, x in plain.items()}
    assert sched.spec_stats["dispatches"] > 0


def test_eos_inside_accepted_draft_truncates_like_plain(eng_pair):
    prompt = _rep_prompt()
    probe, _ = _run_sched(eng_pair[0], [sv.Request("probe", prompt,
                                                   max_new_tokens=40)])
    eos = probe["probe"].tokens[6]

    def mk():
        return [sv.Request("r", prompt, max_new_tokens=40, eos_id=eos)]
    a, _ = _run_sched(eng_pair[0], mk())
    b, sched = _run_sched(eng_pair[1], mk(), SpeculationConfig())
    assert a["r"].tokens == b["r"].tokens
    assert a["r"].finish_reason == b["r"].finish_reason == "eos"
    assert len(b["r"].tokens) <= 7
    assert sched.spec_stats["dispatches"] > 0


def test_spec_respects_max_new_tokens_exactly(eng_pair):
    for n in (1, 2, 5, 17):
        plain, _ = _run_sched(eng_pair[0], [sv.Request(
            f"p{n}", _rep_prompt(), max_new_tokens=n)])
        spec, _ = _run_sched(eng_pair[1], [sv.Request(
            f"s{n}", _rep_prompt(), max_new_tokens=n)], SpeculationConfig())
        assert spec[f"s{n}"].tokens == plain[f"p{n}"].tokens
        assert len(spec[f"s{n}"].tokens) == n


def test_temperature_requests_bypass_speculation(models):
    """Sampled requests with speculation on: the streams of speculation
    off, no verify on a fresh engine, ``spec_stats`` all zero, and the
    same number of steps and decode steps."""
    def run(speculation):
        eng = _engine(models[2])
        results, sched = _run_sched(eng, [
            sv.Request("r", _rep_prompt(), max_new_tokens=12,
                       temperature=0.9, top_k=8, seed=21),
            sv.Request("s", _rand_prompt(), max_new_tokens=6,
                       temperature=1.3, seed=4)], speculation)
        return ({rid: r.tokens for rid, r in results.items()},
                sched.spec_stats, sched.steps_run, eng.decode_steps,
                eng.verify_calls)

    off, on = run(None), run(SpeculationConfig())
    assert on == off
    assert on[1] == ZERO_SPEC and on[4] == 0


def test_scheduler_rejects_overwide_speculation_config(models):
    eng = sv.DecodeEngine(models[2], device="cpu", slots=1, max_len=MAX,
                          prefill_len=8, draft_buckets=(1, 2, 4))
    with pytest.raises(ValueError, match="draft bucket table"):
        sv.ContinuousBatchingScheduler(
            eng, speculation=SpeculationConfig(max_draft=8))
    sv.ContinuousBatchingScheduler(eng,
                                   speculation=SpeculationConfig(max_draft=4))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chip_smoke_forced_draft_check_on_the_cpu(models, paged):
    """``chip_smoke.forced_draft_check``, the card's forced-draft gate, on
    the small model: the plain continuation accepted whole (8 of 8) and
    the one corrupted at position 3 accepted to 3, the slot's length and
    the next decode as stated."""
    import chip_smoke

    engine = _engine(models[2], **(dict(paged=sv.PagedCacheConfig(
        block_size=16)) if paged else {}))
    probe = sv.Request("probe", _rand_prompt(20, seed=5) * 2,
                       max_new_tokens=12)
    out = chip_smoke.forced_draft_check(engine, probe, sv)
    assert out["true_continuation"]["accepted"] == 8
    assert out["corrupted_at_3"]["accepted"] == 3
    for row in out.values():
        assert row["bonus_is_plain_token"]
        assert row["verify_rows_tol_ratio"] < 1e-2
        assert row["next_decode_tol_ratio"] < 1e-2
