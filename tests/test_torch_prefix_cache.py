"""Cross-request prefix caching: apex_tpu_torch.serving.prefix_cache and the
scheduler's prefix path against the JAX package.

- **The store**: the port's ``PrefixCache`` and the JAX package's are
  driven through one seeded random sequence of ``put`` / ``put_blocks``
  (dense spans) or ``put_block_ids`` (paged, each over its own block
  manager), ``match``, ``probe``, ``lookup``, ``acquire``, ``release``,
  ``evict_blocks`` and ``bump_version``; after every operation the
  entries in LRU order, their pins and the counters (``stats()``) must be
  equal, and both must refuse at the same points.  The chain hashes are
  the same strings.
- **The scheduler**: two system prompts shared by eight requests under a
  token budget that forces eviction, served by the port's and the JAX
  package's schedulers (``APEX_TPU_KERNELS=interpret``), dense and paged:
  the hits, misses and saved tokens (the JAX events' counts, the port's
  ``stats()``), and the chains evicted, in order, must be equal; the
  streams equal the JAX streams, or part only at a near tie (top-2
  margin of the JAX logits below 1e-3), and the port's own run without
  prefix caching.  A paged pool too small for the cache's blocks evicts
  through the reclaim hook, as the JAX pool does.

The model is the one of ``tests/test_torch_serving.py`` (2 layers, hidden
128, fp32, initialised in JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import _logging
from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.serving import paged_kv_cache as jpkv
from apex_tpu.serving import prefix_cache as jpc
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.serving import paged_kv_cache as pkv
from apex_tpu_torch.serving import prefix_cache as tpc

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
ENGINE = dict(slots=2, max_len=128, prefill_len=32)
NEW_TOKENS = 5
NEAR_TIE = 1e-3


# ---------------------------------------------------------------------------
# the store, op for op
# ---------------------------------------------------------------------------


def _store_state(c):
    return ([(e.chain, e.parent, e.refs, e.block_id, e.lo)
             for e in c._entries.values()],
            {k: sorted(v) for k, v in c._children.items()}, c.stats())


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:      # the exception's type is the result
        return ("raised", type(e).__name__)
    if isinstance(out, tuple):              # match: (covered, entries)
        return ("ok", out[0], [e.chain for e in out[1]])
    if isinstance(out, list):
        return ("ok", [e.chain for e in out])
    return ("ok", getattr(out, "chain", out))


def _span(side, rows):
    span = np.arange(rows * 2, dtype=np.float32).reshape(1, rows, 1, 2)
    return torch.from_numpy(span) if side == "t" else jnp.asarray(span)


def _op(c, side, kind, args, pools):
    """One operation on one side's store; ``args`` are the op's shared
    arguments (tokens, ids), the arrays are made for the side."""
    if kind == "put":
        parent_len, blocks, ids = args
        parent = c.ROOT
        for block in parent_len:
            parent = c.chain_hash(parent, block)
        if pools:
            return c.put_block_ids(parent, blocks, ids)
        span = _span(side, len(blocks) * c.block_size)
        return c.put_blocks(parent, blocks, span, span)
    if kind == "match":
        return c.match(args)
    if kind == "probe":
        return c.probe(args)
    if kind == "lookup":
        return c.lookup(c.chain_hash(c.ROOT, args))
    if kind == "evict":
        return c.evict_blocks(args) if pools else c.evictable_blocks()
    if kind == "evictable":
        return c.evictable_blocks()
    return c.bump_version()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_store_matches_jax_op_for_op(paged, seed):
    rng = np.random.default_rng(seed)
    bs = 4
    kw = dict(block_size=bs, max_tokens=40)
    pools = {}
    if paged:
        mkw = dict(slots=1, max_len=256, block_size=bs, num_blocks=80)
        pools = {"t": pkv.PagedCacheManager(**mkw),
                 "j": jpkv.PagedCacheManager(**mkw)}
        for m in pools.values():
            m.ensure(0, 0, 256)             # 64 live blocks to reference
        caches = {s: cls(pool=pools[s], bytes_per_block=8, **kw)
                  for s, cls in (("t", tpc.PrefixCache),
                                 ("j", jpc.PrefixCache))}
    else:
        caches = {"t": tpc.PrefixCache(**kw), "j": jpc.PrefixCache(**kw)}
    pinned = {"t": [], "j": []}
    for _ in range(250):
        kind = str(rng.choice(["put", "put", "put", "match", "match", "probe",
                               "lookup", "release", "evict", "evictable",
                               "bump"], p=[.2, .1, .1, .15, .1, .05, .05,
                                           .1, .07, .06, .02]))
        # few tokens: prompts share their first blocks often
        prompt = [int(t) for t in rng.integers(0, 2, bs * 4)]
        blocks = [prompt[i:i + bs] for i in range(0, len(prompt), bs)]
        if kind == "put":
            k = int(rng.choice(3, p=[.6, .25, .15]))     # parent blocks
            n = int(rng.integers(1, 5 - k))
            args = (blocks[:k], blocks[k:k + n],
                    [int(b) for b in rng.integers(1, 65, n)])
        elif kind in ("match", "probe"):
            args = prompt[:int(rng.integers(bs // 2, len(prompt) + 1))]
        elif kind == "lookup":
            args = blocks[0]
        elif kind == "evict":
            args = int(rng.integers(1, 3))
        else:
            args = None
        pin = kind == "match" and rng.random() < 0.5
        results = {}
        for side, c in caches.items():
            if kind == "release":
                results[side] = _outcome(lambda: c.release(
                    [pinned[side].pop()] if pinned[side] else []))
                continue
            results[side] = _outcome(lambda: _op(c, side, kind, args, pools))
            if pin and results[side][0] == "ok" and results[side][2]:
                entry = c._entries[results[side][2][-1]]
                c.acquire([entry])
                pinned[side].append(entry)
        assert results["t"] == results["j"], (kind, args)
        assert _store_state(caches["t"]) == _store_state(caches["j"]), kind
        if paged:
            assert pools["t"]._refs.tolist() == pools["j"]._refs.tolist()
    stats = caches["t"].stats()
    assert stats["evicted"] > 0 and stats["hits"] > 0 and stats["refused"] > 0


def test_chain_hash_is_the_jax_hash():
    for parent in (tpc.PrefixCache.ROOT, "0123abcd" * 4):
        for tokens in ([1, 2, 3], list(range(16)), [2 ** 40, 0]):
            assert tpc.PrefixCache.chain_hash(parent, tokens) == \
                jpc.PrefixCache.chain_hash(parent, tokens)


# ---------------------------------------------------------------------------
# the scheduler's prefix path against the JAX scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    return jmodel, params, tmodel


def _prompts():
    """Eight prompts over two 40-token system prompts, tails of 3-20."""
    rng = np.random.default_rng(3)
    systems = [[int(t) for t in rng.integers(0, 256, 40)] for _ in range(2)]
    return [systems[i % 2] + [int(t) for t in rng.integers(0, 256, n)]
            for i, n in enumerate(rng.integers(3, 21, 8))]


def _record_drops(monkeypatch, cls, out):
    inner = cls._drop

    def drop(self, victim):
        out.append(victim.chain)
        return inner(self, victim)
    monkeypatch.setattr(cls, "_drop", drop)


def _count_reclaims(pool) -> list:
    """Wrap a paged pool's reclaim hook; returns the list its calls'
    arguments go to (stays empty on a dense engine)."""
    calls = []
    if pool is not None:
        inner = pool.reclaim
        pool.reclaim = lambda n: calls.append(n) or inner(n)
    return calls


# budget 80 tokens = 5 blocks of 16: the two system prompts (2 blocks
# each) and one tail block; every other tail block is evicted.  The tight
# pool's 6 blocks cannot hold the cache's 5 beside a stream's 4: its
# allocations evict through the reclaim hook
CASES = {"dense": dict(), "paged": dict(block_size=16),
         "paged_tight_pool": dict(block_size=16, num_blocks=7)}


@pytest.fixture(scope="module", params=list(CASES))
def both_runs(request, models):
    jmodel, params, tmodel = models
    name, paged = request.param, CASES[request.param]
    out = {"name": name}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        drops, events = [], []
        _record_drops(mp, jpc.PrefixCache, drops)
        sink = events.append
        _logging.add_event_sink(sink)
        try:
            jeng = jsv.DecodeEngine(
                jmodel, params, **ENGINE,
                paged=jsv.PagedCacheConfig(**paged) if paged else None)
            sched = jsv.ContinuousBatchingScheduler(
                jeng, prefix_caching=jsv.PrefixCacheConfig(max_tokens=80))
            out["jax_reclaims"] = _count_reclaims(jeng.block_pool)
            for i, p in enumerate(_prompts()):
                sched.submit(jsv.Request(f"r{i}", p,
                                         max_new_tokens=NEW_TOKENS))
            out["jax_streams"] = {r: res.tokens
                                  for r, res in sched.run().items()}
        finally:
            _logging.remove_event_sink(sink)
        hits = [e for e in events if e.get("event") == "serving_prefix_hit"]
        out["jax"] = dict(
            prefix_hits=len(hits),
            prefix_misses=sum(e.get("event") == "serving_prefix_miss"
                              for e in events),
            prefix_saved_tokens=sum(e["saved_tokens"] for e in hits))
        out["jax_drops"], out["jeng"] = drops, jeng
    with pytest.MonkeyPatch.context() as mp:
        drops = []
        _record_drops(mp, tpc.PrefixCache, drops)
        engine = sv.DecodeEngine(
            tmodel, device="cpu", **ENGINE,
            paged=sv.PagedCacheConfig(**paged) if paged else None)
        sched = sv.ContinuousBatchingScheduler(
            engine, prefix_caching=sv.PrefixCacheConfig(max_tokens=80))
        out["reclaims"] = _count_reclaims(engine.block_pool)
        for i, p in enumerate(_prompts()):
            sched.submit(sv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
        out["streams"] = {r: res.tokens for r, res in sched.run().items()}
        out["stats"], out["drops"] = sched.stats(), drops
        out["engine"], out["sched"] = engine, sched
    plain = sv.ContinuousBatchingScheduler(sv.DecodeEngine(
        tmodel, device="cpu", **ENGINE))
    for i, p in enumerate(_prompts()):
        plain.submit(sv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
    out["plain_streams"] = {r: res.tokens for r, res in plain.run().items()}
    return out


def test_hits_misses_and_saved_tokens_match_jax(both_runs):
    assert both_runs["stats"] == both_runs["jax"]
    assert both_runs["stats"]["prefix_hits"] >= 4


def test_eviction_order_matches_jax(both_runs):
    assert both_runs["drops"] == both_runs["jax_drops"]
    assert len(both_runs["drops"]) > 0
    # the tight pool evicts through the reclaim hook too, as JAX's does
    assert both_runs["reclaims"] == both_runs["jax_reclaims"]
    assert bool(both_runs["reclaims"]) == (
        both_runs["name"] == "paged_tight_pool")


def test_streams_match_jax_and_the_run_without(both_runs):
    streams, jstreams = both_runs["streams"], both_runs["jax_streams"]
    assert streams == both_runs["plain_streams"]
    for i, prompt in enumerate(_prompts()):
        ours, ref = streams[f"r{i}"], jstreams[f"r{i}"]
        if ours == ref:
            continue
        p = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
        jeng = both_runs["jeng"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_TPU_KERNELS", "interpret")
            jeng.reset()
            jl = np.asarray(jeng.prefill(0, list(prompt) + ref[:p]))
            jeng.release(0)
        top2 = np.sort(jl)[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (i, p, top2)


def test_what_the_cache_holds_after_the_run(both_runs):
    """Paged: the pool holds exactly the cache's blocks, one reference
    each; dense: the cache holds its spans and the engine no pool."""
    engine, cache = both_runs["engine"], both_runs["sched"].prefix_cache
    pool = engine.block_pool
    assert cache.cached_tokens <= 80 and len(cache) > 0
    if both_runs["name"] == "dense":
        assert pool is None and cache.cached_bytes > 0
        return
    assert pool.used_blocks == len(cache)
    assert all(pool.refcount(e.block_id) == 1
               for e in cache._entries.values())
