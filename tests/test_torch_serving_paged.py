"""The paged KV cache: apex_tpu_torch.serving.paged_kv_cache and the paged
engine against apex_tpu.serving on the same weights.

- **The block manager**: the port's ``PagedCacheManager`` and the JAX
  package's are driven through one seeded random sequence of ``ensure``,
  ``alias``, ``fork``, ``ref``, ``deref``, ``release`` and
  ``consume_dirty``; after every operation the tables, refcounts, free
  lists, owned counts and counters must be equal, and both must raise at
  the same points with the same exception type.
- **The device ops**: a prefill write and a decode append through the
  same tables land the same rows in the port's pool as in the JAX pool
  (exactly: they are copies); the rows the JAX pool drops go to the
  port's sink block, and no other block changes.  ``decode_view`` hands
  out the dense cache's layout and strides.
- **The paged engine**: the port's paged engine serves the scheduler
  workload of ``tests/test_torch_serving.py`` with the dense engine's
  chunks, streams and chunk logits bit for bit (block sizes 16, and 5,
  where ``max_len`` 128 is not a block multiple), and its streams match
  the JAX paged engine's (``APEX_TPU_KERNELS=interpret``) with first-token
  logits within ``atol = 1e-4`` (fp32, sums in another order) and the
  near-tie rule of that file (a stream may part only where the JAX
  logits' top-2 margin is below 1e-3).  A fork copies exactly one block
  on the first decode step, and both sharers' logits equal a 2-slot dense
  run's bit for bit.  A tight pool holds admission back and still serves
  the dense streams; an exhausted pool raises.
- **``close()``**: a caching scheduler's close gives its cached blocks back
  to the pool and unhooks only its own reclaim callback, as in the JAX
  test of the same name.

The model is the one of ``tests/test_torch_serving.py``: 2 layers, hidden
128, 4 heads over 2 kv heads, vocab 256, fp32, initialised in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.serving import paged_kv_cache as jpkv
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.serving import kv_cache as kvc
from apex_tpu_torch.serving import paged_kv_cache as pkv

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
ENGINE = dict(slots=2, max_len=128, prefill_len=32)
PROMPT_LENS = (5, 17, 40, 70)
NEW_TOKENS = 6
NEAR_TIE = 1e-3


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


def _serve(engine, prompts):
    """Greedy streams of the FIFO scheduler, and its prefill calls
    (``chip_smoke.ChunkLog``: ``(slot, tokens)`` and each one's logits)."""
    sched = sv.ContinuousBatchingScheduler(engine)
    for i, p in enumerate(prompts):
        sched.submit(sv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
    with chip_smoke.ChunkLog(engine) as log:
        streams = {r: res.tokens for r, res in sched.run().items()}
    return streams, log


# ---------------------------------------------------------------------------
# the host block manager, op for op against the JAX manager
# ---------------------------------------------------------------------------


def _state(m):
    return (m._tables.astype(np.int64).tolist(), m._refs.tolist(),
            list(m._free), m._owned.tolist(), m._dirty, m.allocated_total,
            m.freed_total, m.cow_total, m.aliased_total)


def _apply(m, op, args):
    try:
        return ("ok", getattr(m, op)(*args))
    except Exception as e:          # the exception's type is the result
        return ("raised", type(e).__name__)


@pytest.mark.parametrize("seed", range(4))
def test_manager_matches_jax_op_for_op(seed):
    rng = np.random.default_rng(seed)
    kw = dict(slots=4, max_len=40, block_size=8, num_blocks=14)
    ours, ref = pkv.PagedCacheManager(**kw), jpkv.PagedCacheManager(**kw)
    raised = 0
    for _ in range(300):
        slot = int(rng.integers(kw["slots"]))
        kind = rng.choice(["ensure", "ensure", "ensure", "alias", "fork",
                           "ref", "deref", "release", "dirty", "gap"])
        live = [b for b in range(1, kw["num_blocks"]) if ref._refs[b] > 0]
        if kind == "ensure":        # from within the slot's blocks on
            start = int(rng.integers(0, ours.owned_blocks(slot) * 8 + 1))
            stop = min(kw["max_len"], start + int(rng.integers(1, 12)))
            op, args = "ensure", (slot, start, max(stop, start + 1))
        elif kind == "gap":         # growth past the frontier: refused
            op, args = "ensure", (slot, kw["max_len"] - 1, kw["max_len"])
        elif kind == "alias":
            ids = ([int(b) for b in rng.choice(live, size=min(len(live), 2),
                                               replace=False)]
                   if live else [3])
            if rng.random() < 0.2 and ours._free:
                ids = [int(ours._free[-1])]      # a free block: refused
            op, args = "alias", (slot, ids,
                                 int(rng.integers(1, 8 * len(ids) + 1)))
        elif kind == "fork":
            op, args = "fork", (slot, int(rng.integers(kw["slots"])))
        elif kind in ("ref", "deref"):
            pool = live if live and rng.random() < 0.8 else [1, 2, 13]
            op, args = kind, ([int(rng.choice(pool))],)
        elif kind == "release":
            op, args = "release", (slot,)
        else:
            op, args = "consume_dirty", ()
        got, want = _apply(ours, op, args), _apply(ref, op, args)
        assert got == want, (op, args)
        raised += got[0] == "raised"
        assert _state(ours) == _state(ref), (op, args)
    assert raised > 10              # the sequence reached the refusals


def test_exhaustion_raises_and_reclaim_is_consulted_once():
    m = pkv.PagedCacheManager(slots=2, max_len=32, block_size=8,
                              num_blocks=4)
    m.ensure(0, 0, 24)
    asked = []
    m.reclaim = lambda n: asked.append(n) or 0
    with pytest.raises(pkv.BlockPoolExhausted):
        m.ensure(1, 0, 1)
    assert asked == [1] and m.owned_blocks(1) == 0


# ---------------------------------------------------------------------------
# the device ops against the JAX ops on the same tables
# ---------------------------------------------------------------------------


def _pools(kw, tables, lengths):
    cfg = LlamaConfig(**CFG)
    ours = pkv.init_paged_cache(cfg, device="cpu", **kw)
    ref = jpkv.init_paged_cache(JaxLlamaConfig(**CFG), **kw)
    ours.tables.copy_(torch.as_tensor(tables))
    ours.lengths.copy_(torch.as_tensor(lengths))
    ref = jpkv.PagedKVCache(k=ref.k, v=ref.v, tables=jnp.asarray(
        tables, jnp.int32), lengths=jnp.asarray(lengths, jnp.int32),
                            max_len=ref.max_len)
    return ours, ref


def test_writes_land_as_jax_writes_and_drops_go_to_the_sink():
    kw = dict(slots=2, max_len=20, block_size=8, num_blocks=6)
    # slot 0 owns blocks 3, 1 (rows 0-15), slot 1 owns block 5 only
    tables = np.array([[3, 1, 0], [5, 0, 0]], np.int64)
    ours, ref = _pools(kw, tables, [12, 3])
    rng = np.random.default_rng(1)
    hd = CFG["hidden_size"] // CFG["num_attention_heads"]
    chunk = rng.normal(size=(2, 16, 2, hd)).astype(np.float32)
    # a 16-row chunk at row 4: rows 16-19 fall on slot 0's null entry
    pkv.paged_prefill_write(ours, 1, 0, torch.as_tensor(chunk[0]),
                            torch.as_tensor(chunk[1]), start=4)
    ref = jpkv.paged_prefill_write(ref, 1, 0, jnp.asarray(chunk[0]),
                                   jnp.asarray(chunk[1]), start=4)
    tok = rng.normal(size=(2, 2, 2, hd)).astype(np.float32)
    # slot 1 active at row 3; slot 0 inactive (-1)
    pos = np.array([-1, 3], np.int32)
    pkv.paged_append(ours, 0, torch.as_tensor(tok[0]),
                     torch.as_tensor(tok[1]), torch.as_tensor(pos))
    ref = jpkv.paged_append(ref, 0, jnp.asarray(tok[0]), jnp.asarray(tok[1]),
                            jnp.asarray(pos))
    for a, b in ((ours.k, ref.k), (ours.v, ref.v)):
        np.testing.assert_array_equal(a[:, :-1].numpy(), np.asarray(b))
    # the dropped rows (4 padding rows, the inactive lane) reached the
    # sink, and block 0 stayed zeros
    assert ours.k[1, -1].abs().sum() > 0 and ours.k[0, -1].abs().sum() > 0
    assert not ours.k[:, 0].any() and not ours.v[:, 0].any()
    for layer in range(2):
        got = pkv.decode_view(ours, layer)
        want = jpkv.decode_view(ref, layer)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.shape == (2, 20, 2, hd) and g.is_contiguous()


def test_views_have_the_dense_layout_and_strides():
    cfg = LlamaConfig(**CFG)
    for bs in (16, 5):
        paged = pkv.init_paged_cache(cfg, slots=2, max_len=128, block_size=bs,
                                     num_blocks=60, device="cpu")
        dense = kvc.init_cache(cfg, slots=2, max_len=128, device="cpu")
        for got, want in ((pkv.decode_view(paged, 1), kvc.decode_read(dense, 1)),
                          (pkv.prefill_view(paged, 1, 1),
                           kvc.slot_read(dense, 1, 1))):
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.stride() == w.stride()


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_run(models):
    return _serve(sv.DecodeEngine(models[2], device="cpu", **ENGINE),
                  _prompts())


@pytest.mark.parametrize("block_size", [16, 5])
def test_paged_equals_dense_bit_for_bit(models, dense_run, block_size):
    engine = sv.DecodeEngine(models[2], device="cpu", **ENGINE,
                             paged=sv.PagedCacheConfig(block_size=block_size))
    streams, log = _serve(engine, _prompts())
    assert streams == dense_run[0]
    assert log.calls == dense_run[1].calls
    for got, want in zip(log.logits, dense_run[1].logits):
        assert torch.equal(got, want)
    stats = engine.block_stats()
    assert stats["used_blocks"] == 0 and stats["allocated_total"] > 0
    assert engine.cow_copies == 0


@pytest.fixture(scope="module")
def jax_paged(models):
    jmodel, params, _ = models
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        jeng = jsv.DecodeEngine(jmodel, params, **ENGINE,
                                paged=jsv.PagedCacheConfig(block_size=16))
        sched = jsv.ContinuousBatchingScheduler(jeng)
        for i, p in enumerate(_prompts()):
            sched.submit(jsv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
        streams = {r: res.tokens for r, res in sched.run().items()}
        first = []
        for p in _prompts():
            first.append(np.asarray(jeng.prefill(0, p)))
            jeng.release(0)
    return jeng, streams, first


def test_paged_streams_match_jax_paged(models, jax_paged):
    jeng, jstreams, jfirst = jax_paged
    engine = sv.DecodeEngine(models[2], device="cpu", **ENGINE,
                             paged=sv.PagedCacheConfig(block_size=16))
    streams, _ = _serve(engine, _prompts())
    for i, prompt in enumerate(_prompts()):
        logits = engine.prefill(0, prompt).numpy()
        engine.release(0)
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


def test_fork_copies_one_block_and_both_sharers_stay_isolated(models):
    prompt = _prompts()[2]                      # 40 tokens: a shared tail
    paged = sv.DecodeEngine(models[2], device="cpu", **ENGINE,
                            paged=sv.PagedCacheConfig(block_size=16))
    dense = sv.DecodeEngine(models[2], device="cpu", **ENGINE)
    paged.prefill(0, prompt)
    paged.fork_slot(0, 1)
    assert paged.slot_block_ids(1) == paged.slot_block_ids(0)
    dense.prefill(0, prompt)
    dense.prefill(1, prompt)
    rng = np.random.default_rng(5)
    for step in range(20):
        toks = rng.integers(0, CFG["vocab_size"], 2)
        got = paged.decode(toks, [True, True])
        want = dense.decode(toks, [True, True])
        assert torch.equal(got, want), step
        if step == 0:
            assert paged.cow_copies == 1
    assert paged.cow_copies == 1
    a, b = paged.slot_block_ids(0), paged.slot_block_ids(1)
    assert a[:2] == b[:2] and a[2] != b[2]      # full blocks still shared
    paged.reset()
    assert paged.block_stats()["used_blocks"] == 0


def test_tight_pool_holds_admission_back_and_serves_the_dense_streams(
        models, dense_run):
    # 2 slots; the 70-token prompt's worst case is 5 blocks of 16, the
    # pool has 6: admission waits for blocks, not only for slots
    engine = sv.DecodeEngine(models[2], device="cpu", **ENGINE,
                             paged=sv.PagedCacheConfig(block_size=16,
                                                       num_blocks=7))
    sched = sv.ContinuousBatchingScheduler(engine)
    for i, p in enumerate(_prompts()):
        sched.submit(sv.Request(f"r{i}", p, max_new_tokens=NEW_TOKENS))
    held = 0
    while sched.queue_depth or sched.active_count:
        free = len(set(engine.free_slots()) - set(sched.active_slots))
        queued = sched.queue_depth
        sched.step()
        # admission runs first in a step and only it shortens the queue
        held += bool(queued and free > 0 and sched.queue_depth == queued)
    assert held > 0
    assert {r: res.tokens for r, res in sched.results.items()} == dense_run[0]
    assert engine.block_stats()["high_water"] <= 6
    with pytest.raises(ValueError, match="exceeds the whole pool"):
        sched.submit(sv.Request("big", [1] * 100, max_new_tokens=20))


def test_paged_engine_guards(models):
    engine = sv.DecodeEngine(models[2], device="cpu", **ENGINE,
                             paged=sv.PagedCacheConfig(block_size=16,
                                                       num_blocks=4))
    engine.prefill(0, [1] * 40)                 # 3 blocks: the pool's all
    with pytest.raises(sv.BlockPoolExhausted):
        engine.prefill(1, [1] * 5)
    with pytest.raises(ValueError, match="by-reference"):
        engine.read_region(0, 0, 4)
    with pytest.raises(ValueError, match="zero-copy"):
        engine.restore_prefix(1, (torch.zeros(2, 4, 2, 32),) * 2, 4)
    dense = sv.DecodeEngine(models[2], device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="dense engine"):
        dense.alias_prefix(0, [1], 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        sv.DecodeEngine(models[2], device="cpu", **ENGINE,
                        paged=sv.PagedCacheConfig(block_size=256))


def test_scheduler_close_releases_cache_blocks_and_reclaim_hook(models):
    """``close()`` on a caching paged scheduler drops every cached pool
    block's reference and unhooks the reclaim callback it installed; a
    successor caching scheduler over the same engine starts from an empty
    pool and serves the same stream; ``close()`` with work in flight
    refuses; closing an older scheduler leaves a newer one's hook in
    place.  The JAX test of the same name, step for step."""
    paged = sv.DecodeEngine(models[2], device="cpu", slots=2, max_len=128,
                            prefill_len=32,
                            paged=sv.PagedCacheConfig(block_size=16))
    prompt = [int(t) for t in np.random.default_rng(21).integers(
        0, CFG["vocab_size"], 40)]
    pool = paged.block_pool

    def fleet():
        sched = sv.ContinuousBatchingScheduler(
            paged, prefix_caching=sv.PrefixCacheConfig())
        sched.submit(sv.Request("a", prompt, max_new_tokens=3))
        return sched, sched.run()["a"].tokens

    sched, want = fleet()
    assert len(sched.prefix_cache) == 2          # two whole blocks cached
    assert pool.used_blocks == 2                 # ...holding pool refs
    assert pool.reclaim is not None
    sched.close()
    assert len(sched.prefix_cache) == 0
    assert pool.used_blocks == 0
    assert pool.reclaim is None
    sched.close()                                # idempotent once drained
    sched2, got = fleet()
    assert got == want
    sched2.close()
    assert pool.used_blocks == 0
    sched3 = sv.ContinuousBatchingScheduler(
        paged, prefix_caching=sv.PrefixCacheConfig())
    sched3.submit(sv.Request("q", prompt, max_new_tokens=1))
    with pytest.raises(RuntimeError, match="queued"):
        sched3.close()
    sched3.run()
    sched4 = sv.ContinuousBatchingScheduler(
        paged, prefix_caching=sv.PrefixCacheConfig())
    sched3.close()
    assert pool.reclaim is not None              # sched4's hook survives
    assert pool.reclaim == sched4.prefix_cache.evict_blocks
    sched4.close()
    assert pool.reclaim is None and pool.used_blocks == 0
