"""A request served alone repeats its batched greedy stream by design.

The FIFO scheduler spends one prefill budget a step over all the requests
it has admitted (``serving/scheduler.py``, the JAX package's rule), so a
prompt served beside others is cached in chunks cut at other places than
when it is served alone.  Other chunks mean other bucket shapes, whose
sums may round differently.  Decode does not depend on the batch: a step
computes every slot's row whatever is active.  So a request served alone
in the chunks its batched run used gives that run's stream bit for bit;
``chip_smoke.py`` holds the served Llama-1B to that on the card, with the
helpers tested here (``ChunkLog``, ``serve_in_chunks``).

A small fp32 Llama (2 layers, hidden 128, vocab 256) on the CPU, weights
from a seeded generator: ``DecodeEngine(slots=2, max_len=128,
prefill_len=16)`` serves five greedy requests (prompts of 9-70 tokens)
under the scheduler, the chunks logged.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
ENGINE = dict(slots=2, max_len=128, prefill_len=16)
PROMPT_LENS = (23, 9, 70, 40, 17)
NEW_TOKENS = 8


def _requests():
    rng = np.random.default_rng(7)
    return [sv.Request(f"r{i}", [int(t) for t in rng.integers(0, 256, n)],
                       max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPT_LENS)]


@pytest.fixture(scope="module")
def batched():
    """The engine, the requests, the batched streams and the chunk log."""
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    engine = sv.DecodeEngine(model, device="cpu", **ENGINE)
    requests = _requests()
    sched = sv.ContinuousBatchingScheduler(engine)
    for r in requests:
        sched.submit(r)
    with chip_smoke.ChunkLog(engine) as log:
        results = sched.run()
    return engine, requests, {k: v.tokens for k, v in results.items()}, log


def _own_chunks(n):
    step = ENGINE["prefill_len"]
    return [min(step, n - i) for i in range(0, n, step)]


def test_chunk_log_finds_each_prompts_chunks(batched):
    """Every prompt's chunks are found, in order, and sum to it; the shared
    budget cuts at least one prompt at other places than served alone (or
    the check below would hold trivially)."""
    _, requests, _, log = batched
    cut_elsewhere = 0
    for r in requests:
        slot, chunks = log.chunks_of(r.prompt)
        assert 0 <= slot < ENGINE["slots"] and sum(chunks) == len(r.prompt)
        assert all(1 <= n <= ENGINE["prefill_len"] for n in chunks)
        cut_elsewhere += chunks != _own_chunks(len(r.prompt))
    assert cut_elsewhere >= 1


@pytest.mark.parametrize("rid", [f"r{i}" for i in range(len(PROMPT_LENS))])
def test_alone_in_the_batched_chunks_repeats_the_batched_stream(batched, rid):
    """Each request served alone, in its batched run's chunks and slot,
    gives its batched greedy stream token for token."""
    engine, requests, streams, log = batched
    r = next(q for q in requests if q.rid == rid)
    slot, chunks = log.chunks_of(r.prompt)
    tokens, logits, x = chip_smoke.serve_in_chunks(engine, r, slot, chunks)
    assert tokens == streams[rid]
    assert logits.shape == (NEW_TOKENS, CFG["vocab_size"])
    assert x.shape == (NEW_TOKENS, CFG["hidden_size"])
    # the logits are the head product of the final norm's row
    head = engine.model.embed_tokens.weight if engine.model.config.tie_word_embeddings \
        else engine.model.lm_head
    torch.testing.assert_close(logits, x @ head.float().t(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rid", [f"r{i}" for i in range(len(PROMPT_LENS))])
def test_scheduler_alone_repeats_its_own_chunks_replayed(batched, rid):
    """Each request served alone by the scheduler is cached in its own
    chunks, and its stream is the one ``serve_in_chunks`` gives in those
    chunks and that slot, unforced, token for token."""
    engine, requests, _, _ = batched
    r = next(q for q in requests if q.rid == rid)
    engine.reset()
    with chip_smoke.ChunkLog(engine) as log:
        alone = chip_smoke.serve(engine, [r], sv)[0][rid].tokens
    slot, chunks = log.chunks_of(r.prompt)
    assert chunks == _own_chunks(len(r.prompt))
    assert chip_smoke.serve_in_chunks(engine, r, slot, chunks)[0] == alone


def test_forced_replay_feeds_the_given_stream(batched):
    """Served alone in its own chunks and fed the batched stream, each
    request whose batched chunks were cut elsewhere gives per-step logits
    within fp32 rounding (1e-4) of the batched chunks' and picks the same
    tokens."""
    engine, requests, streams, log = batched
    cut = [(r, *log.chunks_of(r.prompt)) for r in requests]
    cut = [c for c in cut if c[2] != _own_chunks(len(c[0].prompt))]
    assert cut
    for r, slot, chunks in cut:
        ta, la, _ = chip_smoke.serve_in_chunks(engine, r, slot, chunks)
        tb, lb, _ = chip_smoke.serve_in_chunks(engine, r, 0,
                                               _own_chunks(len(r.prompt)), forced=ta)
        torch.testing.assert_close(lb, la, atol=1e-4, rtol=0)
        assert tb == ta == streams[r.rid]


def test_serving_alone_checks_pass_on_the_small_model(batched):
    """chip_smoke.py's two checks, as its serving phase runs them on the
    card, on the longest request here: alone in the batched chunks the same
    stream; alone in its own chunks logits within the stated tolerance and
    tokens equal up to the first near tie."""
    engine, requests, streams, log = batched
    probe = max(requests, key=lambda q: len(q.prompt))
    out = chip_smoke.serving_alone_checks(engine, probe, streams[probe.rid], log, sv)
    assert out["alone_in_batched_chunks_identical"]
    assert 0 <= out["logits_tol_ratio"] <= 1
    assert out["alone_identical"] and out["alone_parts_at"] is None
    assert out["alone_equals_its_chunks_replayed"]
