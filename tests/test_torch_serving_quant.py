"""int8 serving: apex_tpu_torch.amp.quant and apex_tpu_torch.serving.quant
against the JAX package.

- ``quantize_int8`` / ``dequantize_int8``: payloads and scales equal the
  JAX functions' bit for bit on the same fp32 (and bf16) inputs, over
  several shapes and axes, zero groups included.
- ``quantize_params`` quantizes the same leaves as the JAX function (the
  seven projections of every layer, and the LM head when it is untied),
  with the same payloads and scales: a JAX-quantized tree carried over by
  ``llama_params_from_jax`` equals the port's own quantization bit for
  bit; the caller's model is left as it was.
- The int8 engine (``QuantConfig(weights=True, kv=True)``, dense and
  paged) against the JAX int8 engine (``APEX_TPU_KERNELS=interpret``) on
  the workload of ``tests/test_torch_serving.py``: the int8 KV payloads
  at most one code apart (a K or V input on a rounding boundary may go
  to the neighbouring code when the sums run in another order), the
  first-token logits within ``atol = 1e-4`` (fp32; no code differs at
  this size), and the streams equal up to a near tie (top-2 margin of
  the JAX logits below 1e-3).
- An int8 payload survives capture -> restore bit for bit (its scales
  within one ulp), and the byte accounting equals the JAX package's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import serving as jsv
from apex_tpu.amp import quant as jq
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu_torch import serving as sv
from apex_tpu_torch.amp import quant as tq
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
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    return jmodel, params, tmodel


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, CFG["vocab_size"], n)]
            for n in PROMPT_LENS]


# ---------------------------------------------------------------------------
# the int8 primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((8, 16), -1), ((16, 8), 0),
                                        ((3, 5, 2, 64), -1),
                                        ((4, 6, 7), (0, 2)), ((1, 128), 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_equals_jax_bit_for_bit(shape, axis, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[-1:])
         ).astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0            # a zero group somewhere
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        xt = torch.from_numpy(x.copy())
    q, s = tq.quantize_int8(xt, axis=axis)
    jq_, js = jq.quantize_int8(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_int8(q, s, axis=axis).numpy(),
        np.asarray(jq.dequantize_int8(jq_, js, axis=axis)))
    # the round trip reproduces the payload
    q2, _ = tq.quantize_int8(tq.dequantize_int8(q, s, axis=axis), axis=axis)
    assert torch.equal(q2, q)


# ---------------------------------------------------------------------------
# quantize_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [False, True])
def test_quantize_params_selects_the_jax_leaves(tie):
    cfg = dict(CFG, tie_word_embeddings=tie)
    jmodel = JaxLlama(JaxLlamaConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    quant = sv.quantize_params(tmodel)
    assert quant is not tmodel and not sv.is_quantized(tmodel)
    assert all(torch.equal(before[k], v)
               for k, v in tmodel.state_dict().items())
    # the same leaves: the JAX QTensor paths, carried over by name
    jquant = jsv.quantize_params(params)
    leaves = jax.tree_util.tree_leaves_with_path(
        jquant, is_leaf=lambda x: isinstance(x, jsv.QTensor))
    jax_q = {jax.tree_util.keystr(p) for p, leaf in leaves
             if isinstance(leaf, jsv.QTensor)}
    ours = {n for n, m in quant.named_modules() if isinstance(m, sv.QTensor)}
    assert len(jax_q) == len(ours) == (
        7 * CFG["num_hidden_layers"] + (0 if tie else 1))
    assert {n for n in ours if n != "lm_head"} == {
        f"layers.{i}.{'self_attn' if p in PROJ[:4] else 'mlp'}.{p}.weight"
        for i in range(CFG["num_hidden_layers"]) for p in PROJ}
    assert ("lm_head" in ours) == (not tie) == any(
        "lm_head" in p for p in jax_q)
    # and the same payloads and scales, through the converter
    state = llama_params_from_jax(jax.tree.map(np.asarray, jquant),
                                  tmodel.config)
    mine = quant.state_dict()
    assert set(state) == set(mine)
    for k, v in state.items():
        assert torch.equal(v, mine[k]), k
    # the float leaves are the caller's values, and a second call is a no-op
    assert torch.equal(mine["embed_tokens.weight"], before["embed_tokens.weight"])
    assert sv.quantize_params(quant) is quant
    back = sv.dequant_params(quant)
    assert not sv.is_quantized(back)
    assert type(back.layers[0].mlp.down_proj) is type(
        tmodel.layers[0].mlp.down_proj)


# ---------------------------------------------------------------------------
# the int8 engine against the JAX int8 engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_int8(models):
    jmodel, params, _ = models
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        jeng = jsv.DecodeEngine(jmodel, params, quant=jsv.QuantConfig(),
                                **ENGINE)
        sched = jsv.ContinuousBatchingScheduler(jeng)
        for i, p in enumerate(_prompts()):
            sched.submit(jsv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
        streams = {r: res.tokens for r, res in sched.run().items()}
        first, kv = [], []
        for p in _prompts():
            first.append(np.asarray(jeng.prefill(0, p)))
            kv.append((np.asarray(jeng.cache.k[:, 0, :len(p)]),
                       np.asarray(jeng.cache.v[:, 0, :len(p)])))
            jeng.release(0)
    return jeng, streams, first, kv


@pytest.mark.parametrize("paged", [False, True])
def test_int8_engine_matches_jax_int8(models, jax_int8, paged):
    jeng, jstreams, jfirst, jkv = jax_int8
    engine = sv.DecodeEngine(
        models[2], device="cpu", quant=sv.QuantConfig(), **ENGINE,
        paged=sv.PagedCacheConfig(block_size=16) if paged else None)
    assert engine.model is not models[2] and sv.is_quantized(engine.model)
    sched = sv.ContinuousBatchingScheduler(engine)
    for i, p in enumerate(_prompts()):
        sched.submit(sv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
    streams = {r: res.tokens for r, res in sched.run().items()}
    for i, prompt in enumerate(_prompts()):
        logits = engine.prefill(0, prompt).numpy()
        if paged:
            ids = engine.slot_block_ids(0)
            rows = [engine.cache.k[:, ids], engine.cache.v[:, ids]]
            kv = [r.flatten(1, 2)[:, :len(prompt)].numpy() for r in rows]
        else:
            kv = [engine.cache.k[:, 0, :len(prompt)].numpy(),
                  engine.cache.v[:, 0, :len(prompt)].numpy()]
        engine.release(0)
        for got, want in zip(kv, jkv[i]):
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_allclose(logits, jfirst[i], atol=1e-4, rtol=0)
        ours, ref = streams[f"r{i}"], jstreams[f"r{i}"]
        if ours == ref:
            continue
        p = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_TPU_KERNELS", "interpret")
            jl = np.asarray(jeng.prefill(0, list(prompt) + ref[:p]))
            jeng.release(0)
        top2 = np.sort(jl)[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (i, p, top2)


def test_jax_quantized_checkpoint_serves_in_the_port(models, jax_int8):
    """A tree quantized in JAX, carried over, serves with the streams of
    the port's own int8 engine."""
    _, params, tmodel = models
    qmodel = sv.quantize_params(LlamaForCausalLM(LlamaConfig(**CFG),
                                                 device="cpu"))
    qmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jsv.quantize_params(params)), qmodel.config))
    a = sv.DecodeEngine(qmodel, device="cpu", quant=sv.QuantConfig(),
                        **ENGINE)
    assert a.model is qmodel                    # taken as it is
    b = sv.DecodeEngine(tmodel, device="cpu", quant=sv.QuantConfig(),
                        **ENGINE)
    for p in _prompts():
        assert torch.equal(a.prefill(0, p), b.prefill(0, p))
        a.release(0)
        b.release(0)


@pytest.mark.parametrize("weights,kv", [(True, False), (False, True)])
def test_each_lever_alone_serves(models, weights, kv):
    engine = sv.DecodeEngine(models[2], device="cpu", **ENGINE,
                             quant=sv.QuantConfig(weights=weights, kv=kv))
    assert sv.is_quantized(engine.model) == weights
    assert isinstance(engine.cache, sv.QuantKVCache) == kv
    fp = sv.DecodeEngine(models[2], device="cpu", **ENGINE)
    for p in _prompts():
        got, want = engine.prefill(0, p), fp.prefill(0, p)
        engine.release(0)
        fp.release(0)
        assert float((got - want).abs().max()) < 0.5


def test_capture_restore_keeps_the_int8_payload(models):
    engine = sv.DecodeEngine(models[2], device="cpu", quant=sv.QuantConfig(),
                             **ENGINE)
    prompt = _prompts()[3]
    engine.prefill(0, prompt)
    k, v, n = engine.capture_slot(0)
    assert k.dtype == torch.float32 and n == len(prompt)
    engine.restore_prefix(1, (k, v), n)
    c = engine.cache
    for q, s in ((c.k, c.k_scale), (c.v, c.v_scale)):
        assert torch.equal(q[:, 1, :n], q[:, 0, :n])
        torch.testing.assert_close(s[:, 1, :n], s[:, 0, :n], rtol=2 ** -23,
                                   atol=0)
    # the restored slot resumes to the same logits as a cold prefill
    logits = engine.prefill(1, prompt + [7, 9], resume=n)
    engine.release(0)
    torch.testing.assert_close(logits, engine.prefill(0, prompt + [7, 9]),
                               atol=1e-5, rtol=0)


def test_byte_accounting_equals_jax(models):
    jmodel, params, tmodel = models
    cfg, jcfg = LlamaConfig(**CFG), JaxLlamaConfig(**CFG)
    kw = dict(slots=2, max_len=64)
    for ours, ref in (
            (sv.init_cache(cfg, device="cpu", **kw),
             jsv.init_cache(jcfg, **kw)),
            (sv.init_quant_cache(cfg, device="cpu", **kw),
             jsv.init_quant_cache(jcfg, **kw)),
            (sv.init_quant_paged_cache(cfg, block_size=16, num_blocks=9,
                                       device="cpu", **kw),
             jsv.init_quant_paged_cache(jcfg, block_size=16, num_blocks=9,
                                        **kw))):
        assert sv.kv_bytes_per_token(ours) == jsv.kv_bytes_per_token(ref)
    assert sv.bytes_per_block(ours) == jsv.paged_kv_cache.bytes_per_block(ref)
    assert sv.param_bytes(tmodel) == jsv.param_bytes(params)
    assert sv.param_bytes(sv.quantize_params(tmodel)) == jsv.param_bytes(
        jsv.quantize_params(params))
    out = sv.evaluate_quant([1, 2, 3, 4], [1, 2, 0, 4],
                            ref_logits=np.zeros((4, 3)),
                            quant_logits=np.full((4, 3), 0.25),
                            bytes_per_token=136, fp_bytes_per_token=256)
    assert out == dict(agreement=0.75, tokens=4, max_logit_error=0.25,
                       bytes_per_token=136.0, capacity_ratio=256 / 136)


def test_quant_guards(models):
    tmodel = models[2]
    with pytest.raises(ValueError, match="every lever off"):
        sv.QuantConfig(weights=False, kv=False)
    with pytest.raises(ValueError, match="without tp="):
        sv.DecodeEngine(tmodel, device="cpu", **ENGINE,
                        quant=sv.QuantConfig(allreduce=True))
    with pytest.raises(ValueError, match="cache_dtype"):
        sv.DecodeEngine(tmodel, device="cpu", **ENGINE,
                        quant=sv.QuantConfig(), cache_dtype=torch.float32)
