"""Tensor-parallel serving: the port's ``DecodeEngine(tp=)`` in gloo worlds
of spawned ranks against the JAX package's tp engine.

Mirrors ``tests/test_serving_tp.py`` on its configs: ``CFG`` is GQA (4
heads over 2 kv heads, so tp 2 leaves one kv head a rank), ``CFG_MHA``
(4 over 4) runs at tp 4.  The JAX weights are initialised here and each
rank loads its slice (``llama_params_from_jax(tp_rank=, tp_size=)``) into
the model it builds inside its tensor-parallel region; the JAX engines
run here, in ``shard_map`` over the virtual CPU devices.  One world a
config runs every scenario (module-scoped fixtures).

- Greedy streams equal JAX's tp engine's and the port's ``tp=None``
  engine's token for token; logits within ``atol = rtol = 1e-5`` (fp32)
  of JAX's.  Speculation-verify, preempt/resume, prefix-cache hits and
  paged fork + copy-on-write too.
- ``quantized_allreduce`` against JAX's on the same partial sums
  (``atol = 1e-6``), and ``QuantConfig(weights=True, kv=True,
  allreduce=True)`` streams against JAX's.
- Every rank's stream equals rank 0's, at temperature 0 and above.
- ``serving_tp_step`` events feed ``apex_serving_tp_*``; with ``tp``
  unset nothing of it moves.

This module imports JAX only in its fixtures and tests, so the spawned
ranks stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch import _logging
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.obs import bridge as obs_bridge
from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.testing.distributed import run_world

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
CFG_MHA = dict(CFG, num_key_value_heads=4)
MAX = 96
TOL = dict(rtol=1e-5, atol=1e-5)
QUANT = dict(weights=True, kv=True, allreduce=True)


def _prompt(seed=0, n=12):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, CFG["vocab_size"], n)]


def _greedy(eng, prompt, steps, slot=0):
    """Greedy stream: prefill logits + ``steps`` decode argmaxes, and the
    last logits row as numpy."""
    logits = eng.prefill(slot, list(prompt))
    stream = [int(np.argmax(np.asarray(logits)))]
    toks = np.zeros((eng.slots,), np.int64)
    act = np.zeros((eng.slots,), bool)
    act[slot] = True
    for _ in range(steps):
        toks[slot] = stream[-1]
        logits = eng.decode(toks, act)[slot]
        stream.append(int(np.argmax(np.asarray(logits))))
    return stream, np.asarray(logits, np.float32)


class _Tap:
    def __init__(self):
        self.events = []

    def __enter__(self):
        self._sink = lambda e: self.events.append(dict(e))
        _logging.add_event_sink(self._sink)
        return self

    def __exit__(self, *exc):
        _logging.remove_event_sink(self._sink)

    def of(self, kind):
        return [e for e in self.events if e.get("event") == kind]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _models(cfg, tree, rank, world):
    """This rank's tp model (its slice of the JAX weights) and the whole
    model for the tp=None engine."""
    config = LlamaConfig(**cfg)
    group = tps.serving_group(world)
    with ttp.tensor_parallel_region(group):
        shard = LlamaForCausalLM(config, device="cpu")
    shard.load_state_dict(llama_params_from_jax(tree, config, tp_rank=rank,
                                                tp_size=world))
    whole = LlamaForCausalLM(config, device="cpu")
    whole.load_state_dict(llama_params_from_jax(tree, config))
    return shard, whole


def _engine(model, tp, **kw):
    args = dict(slots=1, max_len=MAX, prefill_len=16, device="cpu")
    args.update(kw)
    return sv.DecodeEngine(model, tp=tp, **args)


def _run_sched(eng, prompts, *, prefix_caching=None, tag="r", **req):
    sched = sv.ContinuousBatchingScheduler(
        eng, log_interval=10 ** 9, prefix_caching=prefix_caching)
    for i, p in enumerate(prompts):
        sched.submit(sv.Request(f"{tag}{i}", p, max_new_tokens=6, **req))
    return {r: res.tokens for r, res in sched.run().items()}


def _tp2_world(rank, world, tree, qsums):
    out = {}
    tp = sv.TPConfig(size=world)
    shard, whole = _models(CFG, tree, rank, world)
    # ---- greedy: tp engine, tp=None engine --------------------------------
    eng = _engine(shard, tp, slots=2)
    ref = _engine(whole, None, slots=2)
    assert eng.tp_size == 2 and eng.tp == tp and ref.tp_size == 1
    assert eng.group is tps.get_tensor_model_parallel_group()
    assert tuple(eng.cache.k.shape[3:]) == (1, 16)     # one kv head a rank
    hist0 = obs_bridge.SERVING_COLLECTIVE_SECONDS.count()
    with _Tap() as tap:
        out["greedy"] = _greedy(eng, _prompt(), steps=24)
    out["greedy_ref"] = _greedy(ref, _prompt(), steps=24)
    steps = tap.of("serving_tp_step")
    out["tp_steps"] = [(e["tp"], e["active"], e["duration_s"] > 0)
                       for e in steps]
    out["tp_gauge"] = obs_bridge.SERVING_TP_SIZE.value()
    out["tp_hist"] = obs_bridge.SERVING_COLLECTIVE_SECONDS.count() - hist0
    # ---- speculation verify --------------------------------------------
    s, _ = _greedy(_engine(whole, None), _prompt(seed=7), steps=12)
    v = _engine(shard, tp)
    _greedy(v, _prompt(seed=7), steps=4)
    good = v.verify_draft(0, [s[4]] + s[5:8])
    bad = v.verify_draft(0, [s[8], s[9], (s[10] + 1) % CFG["vocab_size"],
                             s[11]])
    out["verify"] = (s, [(a, g, r.numpy()) for a, g, r in (good, bad)])
    # ---- preempt / resume within the tp engine -------------------------
    p = _engine(shard, tp)
    prompt = _prompt(seed=9)
    out["unint"] = _greedy(p, prompt, steps=10)[0]
    p.release(0)
    partial = _greedy(p, prompt, steps=4)[0]
    k, v_, n = p.capture_slot(0)
    p.release(0)
    p.restore_prefix(0, (k, v_), n)
    logits = p.prefill(0, prompt + partial[:4] + [partial[4]], resume=n)
    resumed = [int(torch.argmax(logits))]
    for _ in range(5):
        resumed.append(int(torch.argmax(p.decode([resumed[-1]], [True])[0])))
    out["preempt"] = (partial, resumed, k.numpy(), v_.numpy(), n)
    # ---- prefix caching through the scheduler ---------------------------
    shared = _prompt(seed=21, n=48)
    pp = [shared + _prompt(seed=22, n=4), shared + _prompt(seed=23, n=4)]
    with _Tap() as tap:
        out["prefix_on"] = _run_sched(_engine(shard, tp), pp,
                                      prefix_caching=sv.PrefixCacheConfig())
    out["prefix_hits"] = [e["saved_tokens"]
                          for e in tap.of("serving_prefix_hit")]
    out["prefix_cold"] = _run_sched(_engine(shard, tp), pp, tag="r")
    # ---- paged fork + copy-on-write ------------------------------------
    pg = _engine(shard, tp, slots=4, paged=sv.PagedCacheConfig(block_size=8))
    s_pg, _ = _greedy(pg, _prompt(seed=5), steps=8)
    pg.fork_slot(0, 1)
    toks, act = np.zeros(4, np.int64), np.zeros(4, bool)
    act[:2] = True
    toks[:2] = s_pg[-1]
    forked = []
    for _ in range(3):
        rows = pg.decode(toks, act)
        nxt = [int(torch.argmax(rows[s])) for s in (0, 1)]
        forked.append(nxt)
        toks[0], toks[1] = nxt[0], nxt[1] + 1 if _ == 0 else nxt[1]
    out["paged"] = (s_pg, forked, pg.cow_copies)
    # ---- quantized all-reduce and the int8 engine -----------------------
    with ttp.tensor_parallel_region(eng.group):
        out["qsum"] = sv.quantized_allreduce(torch.from_numpy(qsums[rank]),
                                             eng.group).numpy()
    q = _engine(shard, tp, quant=sv.QuantConfig(**QUANT))
    out["quant"] = _greedy(q, _prompt(seed=11), steps=8)
    out["quant_sd"] = {k: t.detach().numpy() for k, t in q.params.items()
                       if k.endswith((".q", ".scale"))}
    # ---- sampling: every rank draws what rank 0 draws -------------------
    prompts = [_prompt(seed=30 + i, n=6) for i in range(3)]
    out["sampled"] = _run_sched(_engine(shard, tp, slots=2), prompts,
                                temperature=0.9, top_k=20, seed=7)
    out["greedy_sched"] = _run_sched(_engine(shard, tp, slots=2), prompts)
    # ---- validation -----------------------------------------------------
    with pytest.raises(ValueError, match="kv_heads=2 is not divisible"):
        _engine(shard, sv.TPConfig(size=4))
    with pytest.raises(RuntimeError, match="world"):
        # a group of another size: the world has 2 ranks
        tps.serving_group(4)
    with pytest.raises(ValueError, match="built for tp world"):
        _engine(whole, tp)
    return out


def _tp4_world(rank, world, tree):
    shard, whole = _models(CFG_MHA, tree, rank, world)
    eng = _engine(shard, sv.TPConfig(size=world), max_len=64)
    ref = _engine(whole, None, max_len=64)
    return {"greedy": _greedy(eng, _prompt(seed=4), steps=12),
            "greedy_ref": _greedy(ref, _prompt(seed=4), steps=12)}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from apex_tpu import serving as jsv
    from apex_tpu.models import LlamaConfig as JCfg
    from apex_tpu.models import LlamaForCausalLM as JLlama
    from apex_tpu.serving.engine import TPConfig as JTP

    class NS:
        pass

    ns = NS()
    ns.jax, ns.jnp, ns.sv, ns.TP = jax, jnp, jsv, JTP
    ns.model = JLlama(JCfg(**CFG))
    ns.params = ns.model.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 4), jnp.int32))
    ns.model4 = JLlama(JCfg(**CFG_MHA))
    ns.params4 = ns.model4.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 4), jnp.int32))
    ns.tree = jax.tree.map(np.asarray, ns.params)
    ns.tree4 = jax.tree.map(np.asarray, ns.params4)

    def engine(tp=2, model=None, params=None, **kw):
        args = dict(slots=1, max_len=MAX, prefill_len=16)
        args.update(kw)
        return jsv.DecodeEngine(model or ns.model,
                                ns.params if params is None else params,
                                tp=None if tp is None else JTP(size=tp),
                                **args)

    ns.engine = engine
    return ns


@pytest.fixture(scope="module")
def qsums():
    rng = np.random.default_rng(3)
    return rng.standard_normal((2, 3, 8, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def tp2(jx, qsums):
    return run_world(_tp2_world, 2, args=(jx.tree, qsums), timeout=150)


@pytest.fixture(scope="module")
def tp4(jx):
    return run_world(_tp4_world, 4, args=(jx.tree4,), timeout=120)


def test_tp2_greedy_stream_matches_jax_and_single_card(tp2, jx):
    s_jax, l_jax = _greedy(jx.engine(slots=2), _prompt(), steps=24)
    for r in tp2:
        (s, l), (s_ref, l_ref) = r["greedy"], r["greedy_ref"]
        assert s == s_jax == s_ref
        np.testing.assert_allclose(l, l_jax, **TOL)
        np.testing.assert_allclose(l, l_ref, **TOL)
    np.testing.assert_array_equal(tp2[0]["greedy"][1], tp2[1]["greedy"][1])


def test_tp4_greedy_stream_mha_matches_jax(tp4, jx):
    s_jax, l_jax = _greedy(jx.engine(4, jx.model4, jx.params4, max_len=64),
                           _prompt(seed=4), steps=12)
    for r in tp4:
        (s, l), (s_ref, _) = r["greedy"], r["greedy_ref"]
        assert s == s_jax == s_ref
        np.testing.assert_allclose(l, l_jax, **TOL)


def test_tp_speculation_verify_parity(tp2, jx):
    s, verdicts = tp2[0]["verify"]
    eng = jx.engine()
    _greedy(eng, _prompt(seed=7), steps=4)
    good = eng.verify_draft(0, [s[4]] + s[5:8])
    bad = eng.verify_draft(0, [s[8], s[9], (s[10] + 1) % CFG["vocab_size"],
                               s[11]])
    for r in tp2:
        assert r["verify"][0] == s
        for (a, g, rows), (ja, jg, jrows) in zip(r["verify"][1], (good, bad)):
            assert a == int(ja)
            np.testing.assert_array_equal(g, np.asarray(jg))
            np.testing.assert_allclose(rows, np.asarray(jrows), **TOL)
    assert [v[0] for v in tp2[0]["verify"][1]] == [3, 1]
    assert int(tp2[0]["verify"][1][0][1][3]) == s[8]


def test_tp_preempt_resume(tp2, jx):
    prompt = _prompt(seed=9)
    for r in tp2:
        partial, resumed, k, v, n = r["preempt"]
        assert n == len(prompt) + 4
        assert partial[:5] + resumed == r["unint"]
        # the capture holds every rank's kv heads: JAX's whole rows
        assert k.shape == (2, n, 2, 16)
    eng = jx.engine()
    _greedy(eng, prompt, steps=4)
    jk, jv, jn = eng.capture_slot(0)
    assert jn == tp2[0]["preempt"][4]
    np.testing.assert_allclose(tp2[0]["preempt"][2], np.asarray(jk), **TOL)
    np.testing.assert_allclose(tp2[0]["preempt"][3], np.asarray(jv), **TOL)
    # equal captures on both ranks (gathered heads)
    np.testing.assert_array_equal(tp2[0]["preempt"][2], tp2[1]["preempt"][2])
    s_jax, _ = _greedy(jx.engine(), prompt, steps=10)
    assert tp2[0]["unint"] == s_jax


def test_tp_prefix_cache_hit_stream_parity(tp2, jx):
    shared = _prompt(seed=21, n=48)
    pp = [shared + _prompt(seed=22, n=4), shared + _prompt(seed=23, n=4)]
    sched = jx.sv.ContinuousBatchingScheduler(
        jx.engine(), log_interval=10 ** 9,
        prefix_caching=jx.sv.PrefixCacheConfig())
    for i, p in enumerate(pp):
        sched.submit(jx.sv.Request(f"r{i}", p, max_new_tokens=6))
    want = {r: res.tokens for r, res in sched.run().items()}
    for r in tp2:
        assert r["prefix_hits"] == [48]
        assert r["prefix_on"] == r["prefix_cold"] == want


def test_tp_paged_fork_cow_stream_parity(tp2, jx):
    from apex_tpu.serving.paged_kv_cache import PagedCacheConfig

    eng = jx.engine(slots=4, paged=PagedCacheConfig(block_size=8))
    s, _ = _greedy(eng, _prompt(seed=5), steps=8)
    eng.fork_slot(0, 1)
    toks, act = np.zeros(4, np.int32), np.zeros(4, bool)
    act[:2] = True
    toks[:2] = s[-1]
    forked = []
    for i in range(3):
        rows = eng.decode(toks, act)
        nxt = [int(np.argmax(np.asarray(rows[j]))) for j in (0, 1)]
        forked.append(nxt)
        toks[0], toks[1] = nxt[0], nxt[1] + 1 if i == 0 else nxt[1]
    for r in tp2:
        s_pg, f, cow = r["paged"]
        assert s_pg == s and f == forked
        assert cow >= 1


def test_quantized_allreduce_matches_jax(tp2, jx, qsums):
    from jax.sharding import PartitionSpec as P

    from apex_tpu.serving.quant import quantized_allreduce as jqar
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = jx.jax.sharding.Mesh(np.array(jx.jax.devices()[:2]), ("tp",))
    f = shard_map(lambda x: jqar(x[0], "tp")[None], mesh=mesh,
                  in_specs=(P("tp"),), out_specs=P("tp"), **NO_REP_CHECK)
    want = np.asarray(jx.jax.jit(f)(jx.jnp.asarray(qsums)))
    for rank, r in enumerate(tp2):
        np.testing.assert_allclose(r["qsum"], want[rank], rtol=0, atol=1e-6)
    # within the int8 grid of the exact sum
    exact = qsums.sum(0)
    assert np.abs(tp2[0]["qsum"] - exact).max() < 2 * np.abs(qsums).max() / 127


def test_tp_quant_engine_matches_jax(tp2, jx):
    """Each rank's int8 weights are its slice of JAX's whole-tree
    quantization bit for bit (a row shard's scales all-reduced over the
    group), and the streams equal JAX's.  The logits are held within
    ``atol = 5e-3``: every row-linear partial sum is rounded to int8 on
    the wire, and a value on a rounding boundary may go to the
    neighbouring code when the sums before it ran in another order, which
    moves a logit by up to about one code of that layer's output."""
    from apex_tpu.serving.quant import quantize_params as jquant

    from apex_tpu_torch.models.convert import shard_state_dict

    jq = llama_params_from_jax(jx.jax.tree.map(np.asarray,
                                               jquant(jx.params)),
                               LlamaConfig(**CFG))
    for rank, r in enumerate(tp2):
        want = shard_state_dict(jq, rank, 2)
        assert set(r["quant_sd"]) == {k for k in want
                                      if k.endswith((".q", ".scale"))}
        for k, v in r["quant_sd"].items():
            np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)
    eng = jx.engine(quant=jx.sv.QuantConfig(**QUANT))
    s_jax, l_jax = _greedy(eng, _prompt(seed=11), steps=8)
    for r in tp2:
        s, l = r["quant"]
        assert s == s_jax
        np.testing.assert_allclose(l, l_jax, rtol=0, atol=5e-3)


def test_every_rank_serves_rank_zeros_streams(tp2, jx):
    assert tp2[0]["sampled"] == tp2[1]["sampled"]
    assert tp2[0]["greedy_sched"] == tp2[1]["greedy_sched"]
    assert tp2[0]["sampled"] != tp2[0]["greedy_sched"]
    # greedy through the scheduler equals JAX's tp scheduler
    sched = jx.sv.ContinuousBatchingScheduler(jx.engine(slots=2),
                                              log_interval=10 ** 9)
    for i in range(3):
        sched.submit(jx.sv.Request(f"r{i}", _prompt(seed=30 + i, n=6),
                                   max_new_tokens=6))
    assert tp2[0]["greedy_sched"] == {r: res.tokens
                                      for r, res in sched.run().items()}


def test_tp_step_events_feed_metrics(tp2):
    for r in tp2:
        assert r["tp_steps"] == [(2, 1, True)] * 24
        assert r["tp_gauge"] == 2
        assert r["tp_hist"] == 24


def test_tp_default_off_identity(jx):
    config = LlamaConfig(**CFG)
    model = LlamaForCausalLM(config, device="cpu")
    model.load_state_dict(llama_params_from_jax(jx.tree, config))
    gauge0 = obs_bridge.SERVING_TP_SIZE.value()
    hist0 = obs_bridge.SERVING_COLLECTIVE_SECONDS.count()
    eng = _engine(model, None, max_len=32, prefill_len=8)
    assert eng.tp is None and eng.tp_size == 1 and eng.group is None
    with _Tap() as tap:
        _greedy(eng, _prompt(n=4), steps=3)
    assert tap.of("serving_tp_step") == []
    assert obs_bridge.SERVING_TP_SIZE.value() == gauge0
    assert obs_bridge.SERVING_COLLECTIVE_SECONDS.count() == hist0
    with pytest.raises(ValueError):
        sv.TPConfig(size=0)
    with pytest.raises(ValueError, match="allreduce"):
        _engine(model, None, quant=sv.QuantConfig(**QUANT))
