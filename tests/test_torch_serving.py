"""The serving slice as a whole: apex_tpu_torch.serving against
apex_tpu.serving on the same weights.

One JAX ``LlamaForCausalLM`` (2 layers, hidden 128, 4 heads over 2 kv
heads, intermediate 256, vocab 256, fp32) is initialised in JAX and its
parameters carried to the port through numpy.  Both packages build a
``DecodeEngine(slots=2, max_len=128, prefill_len=32)`` under a FIFO
``ContinuousBatchingScheduler`` and serve the same four greedy requests,
prompts of 5, 17, 40 and 70 tokens: the 70-token prompt is cached in
three chunks, and with two slots two requests wait for one.  The JAX side
runs its Pallas RMSNorm kernel in interpret mode.

The token streams must be identical and the first-token logits agree
within ``atol = 1e-4`` (fp32; sums in another order).  Where a stream
parts on a near-tie (the JAX logits' top-2 margin below 1e-3, where
rounding order may pick either token), the test compares the
teacher-forced logits at that position instead, and says so in its
failure text if the margin is not a tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
ENGINE = dict(slots=2, max_len=128, prefill_len=32)
PROMPT_LENS = (5, 17, 40, 70)
NEW_TOKENS = 6
NEAR_TIE = 1e-3


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, CFG["vocab_size"], n)]
            for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def served():
    """Serve the workload through both packages once; return both
    engines, the streams and the first-token logits of each prompt."""
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    teng = sv.DecodeEngine(tmodel, device="cpu", **ENGINE)
    prompts = _prompts()
    out = {"prompts": prompts, "teng": teng}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        jeng = jsv.DecodeEngine(jmodel, params, **ENGINE)
        sched = jsv.ContinuousBatchingScheduler(jeng)
        for i, p in enumerate(prompts):
            sched.submit(jsv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
        out["jax_streams"] = {r: res.tokens for r, res in sched.run().items()}
        out["jax_first"] = []
        for p in prompts:
            out["jax_first"].append(np.asarray(jeng.prefill(0, p)))
            jeng.release(0)
    out["jeng"] = jeng
    sched = sv.ContinuousBatchingScheduler(teng)
    for i, p in enumerate(prompts):
        sched.submit(sv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
    out["steps"] = []
    while sched.queue_depth or sched.active_count:
        out["steps"].append((sched.queue_depth, sched.active_count))
        sched.step()
    out["torch_streams"] = {r: res.tokens for r, res in sched.results.items()}
    out["chunks"] = teng.prefill_chunks
    out["torch_first"] = []
    for p in prompts:
        out["torch_first"].append(teng.prefill(0, p).numpy())
        teng.release(0)
    return out


def _teacher_forced(eng, tokens, interpret=False):
    """Next-token logits after ``tokens`` on a fresh slot 0."""
    with pytest.MonkeyPatch.context() as mp:
        if interpret:
            mp.setenv("APEX_TPU_KERNELS", "interpret")
        logits = np.asarray(eng.prefill(0, tokens))
        eng.release(0)
    return logits


def test_greedy_streams_match_jax(served):
    assert set(served["torch_streams"]) == set(served["jax_streams"])
    for i, prompt in enumerate(served["prompts"]):
        rid = f"r{i}"
        ours, ref = served["torch_streams"][rid], served["jax_streams"][rid]
        assert len(ours) == len(ref) == NEW_TOKENS
        if ours == ref:
            continue
        # a parting stream is only acceptable on a near-tie: compare the
        # teacher-forced logits at the first differing position instead
        p = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
        context = list(prompt) + ref[:p]
        jl = _teacher_forced(served["jeng"], context, interpret=True)
        tl = _teacher_forced(served["teng"], context).astype(np.float32)
        top2 = np.sort(jl)[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (
            f"{rid} parts from the JAX stream at token {p} on a margin of "
            f"{top2[1] - top2[0]} (not a near-tie)")
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_first_token_logits_match_jax(served):
    for ours, ref in zip(served["torch_first"], served["jax_first"]):
        assert ours.dtype == np.float32 and ours.shape == (CFG["vocab_size"],)
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_workload_exercised_chunking_and_waiting(served):
    """The prompts took more chunks than there are prompts (the 70-token
    one at least three), and a request waited in the queue while both
    slots were busy."""
    assert served["chunks"] >= len(PROMPT_LENS) + 2
    assert any(queued and active == ENGINE["slots"]
               for queued, active in served["steps"])


def test_sampled_stream_repeats_under_fixed_seed(served):
    eng = served["teng"]
    prompt = served["prompts"][1]
    streams = []
    for _ in range(2):
        eng.reset()
        sched = sv.ContinuousBatchingScheduler(eng)
        sched.submit(sv.Request("s", prompt, max_new_tokens=8,
                                temperature=0.9, top_k=20, seed=11))
        streams.append(sched.run()["s"].tokens)
    assert streams[0] == streams[1]
    assert all(0 <= t < CFG["vocab_size"] for t in streams[0])


def test_engine_guards(served):
    eng = served["teng"]
    eng.reset()
    prompt = served["prompts"][0]
    eng.prefill(0, prompt)
    with pytest.raises(ValueError, match="occupied"):
        eng.prefill(0, prompt)
    with pytest.raises(ValueError, match="never prefilled"):
        eng.decode([1, 1], [True, True])
    with pytest.raises(ValueError, match="cache capacity"):
        eng.prefill(1, [1] * (eng.max_len + 1))
    with pytest.raises(ValueError, match="out of range"):
        eng.prefill(2, prompt)
    eng.release(0)
    eng.prefill(0, [3] * eng.max_len)
    with pytest.raises(ValueError, match="at cache capacity"):
        eng.decode([1, 0], [True, False])
    eng.reset()
    assert eng.free_slots() == [0, 1] and eng.cache_utilization() == 0.0


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_buckets=(32, 16)), "ascending"),
    (dict(prefill_buckets=(1, 32)), ">= 2"),
    (dict(prefill_buckets=(16,)), "must equal prefill_len"),
    (dict(prefill_len=1), "prefill_len must be >= 2"),
    (dict(prefill_len=256), "> max_len"),
    (dict(slots=0), "slots must be >= 1"),
])
def test_engine_rejects_bad_construction(served, kw, match):
    args = dict(ENGINE, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        sv.DecodeEngine(served["teng"].model, **args)


@pytest.mark.parametrize("name", ["tp"])
def test_engine_options_of_later_slices_raise(served, name):
    """``tp=TPConfig(2)`` with no process group of that size raises with
    the launch recipe: the engine never serves it as ``tp=None``."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        sv.DecodeEngine(served["teng"].model, device="cpu",
                        **{name: sv.TPConfig(size=2)}, **ENGINE)


@pytest.mark.parametrize("name", ["speculation", "policy"])
def test_scheduler_options_of_later_slices_raise(served, name):
    """The scheduler options the speculative and control-plane slice
    brought refuse what the JAX scheduler refuses: a draft wider than the
    engine's draft bucket table, and a tenant weight that is not
    positive."""
    if name == "speculation":
        with pytest.raises(ValueError, match="draft bucket table"):
            sv.ContinuousBatchingScheduler(
                served["teng"], speculation=sv.SpeculationConfig(
                    max_draft=served["teng"].max_draft + 1))
        with pytest.raises(ValueError, match="draft bucket table"):
            jsv.ContinuousBatchingScheduler(
                served["jeng"], speculation=jsv.SpeculationConfig(
                    max_draft=served["jeng"].max_draft + 1))
    else:
        for pkg in (sv, jsv):
            with pytest.raises(ValueError, match="weights must be > 0"):
                pkg.ContinuousBatchingScheduler(
                    served["teng"] if pkg is sv else served["jeng"],
                    policy=pkg.SchedulingPolicy(tenant_weights={"a": 0.0}))


def test_scheduler_submit_guards(served):
    sched = sv.ContinuousBatchingScheduler(served["teng"], max_queue=1)
    sched.submit(sv.Request("a", [1, 2], max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(sv.Request("a", [1, 2], max_new_tokens=2))
    with pytest.raises(sv.QueueFull):
        sched.submit(sv.Request("b", [1, 2], max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        sv.ContinuousBatchingScheduler(served["teng"]).submit(
            sv.Request("c", [1] * 100, max_new_tokens=40))



def test_engine_leaves_the_callers_model_trainable(served):
    """Building a DecodeEngine puts the model in eval mode only: its
    parameters keep requires_grad (every engine call runs under
    inference_mode, so nothing records a gradient there), the served
    streams are those of the first run, and the model still trains."""
    teng = served["teng"]
    model = teng.model
    assert not model.training
    assert all(p.requires_grad for p in model.parameters())
    sched = sv.ContinuousBatchingScheduler(teng)
    for i, p in enumerate(served["prompts"]):
        sched.submit(sv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
    assert {r: res.tokens for r, res in sched.run().items()} == \
        served["torch_streams"]
    ids = torch.tensor([served["prompts"][1]])
    model(ids, labels=torch.roll(ids, -1, 1)).mean().backward()
    assert all(p.grad is not None for p in model.parameters())
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("flags", [(True, True), (False, True), (True, False)])
def test_no_tf32_restores_both_flags(flags):
    """``no_tf32`` turns both TF32 flags off inside its block and puts
    each back as it was after it, also when the block raises."""
    from apex_tpu_torch.serving.engine import no_tf32

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        with no_tf32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
        with pytest.raises(RuntimeError, match="inside"):
            with no_tf32():
                raise RuntimeError("inside")
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _serve_and_read_flags(model, device):
    eng = sv.DecodeEngine(model, device=device, **ENGINE)
    after_build = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    sched = sv.ContinuousBatchingScheduler(eng)
    sched.submit(sv.Request("a", [1, 2, 3], max_new_tokens=2))
    sched.run()
    return after_build, (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)


def test_engine_leaves_the_process_tf32_flags(served):
    """Building a DecodeEngine and serving through it leaves both TF32
    flags as the process set them (the JAX engine changes no global
    state)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((True, True), (False, False)):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
            assert _serve_and_read_flags(served["teng"].model, "cpu") == (
                flags, flags)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
def test_engine_on_card_leaves_the_process_tf32_flags(served):
    """The same on the card, where the engine's model calls run with TF32
    off and the flags come back after each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = served["teng"].model
    cuda_model = type(model)(model.config, device="cuda")
    cuda_model.load_state_dict(model.state_dict())
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = (True, True)
        assert _serve_and_read_flags(cuda_model, "cuda") == (
            (True, True), (True, True))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
