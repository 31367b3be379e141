"""apex_tpu_torch.ops.multi_tensor: the walker's chunk chosen from the
list, and ``mt_lamb``'s group plan.

- The chunk (``choose_chunk``): 64 K kept at Llama-1B's and GPT-2-large's
  real parameter lists for any plausible count of resident blocks (132
  SMs, 1 to 4 blocks of 512 threads each); at OpenFold's 48 tensors the
  largest power of two down to 2,048 that gives every resident block a
  chunk; the table at the chosen chunk covers every element once.
- The plan (``lamb_plan``): every tensor in exactly one group, in table
  order; no group over the budget unless it is one tensor; the narrow
  groups walked whole by one block, the wide ones split over a team's
  blocks, the teams' bytes balanced; the spans, walked as
  ``csrc/multi_tensor.cu`` ``mt_lamb_kernel`` walks them (each block's
  tensors from its piece word), cover each tensor's elements once, every
  piece starting on a whole 8-element vector (16 bytes in every list); the
  partial slots ``wi Gt + bt + t`` are unique, and the blocks the ratio
  pass reads for a tensor are exactly those that wrote it; the words as
  the kernel reads them.
- ``_plain_lamb`` (the CPU path, and what ``chip_smoke.py`` holds the
  kernel to) against one JAX ``FusedLAMB`` step over a list that
  straddles a small budget, with fp32 and bf16 moments and with ``n_ratio
  < T`` (the tensors past it take ratio 1, as JAX's without NVLAMB and
  weight decay).
- On a card (``cuda`` marker; skipped here): the grouped ``mt_lamb`` over
  a tensor past the budget and many small ones, and ``mt_adam`` on the
  small-list chunking, each against its plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers._common import MasterState
from apex_tpu.optimizers.fused_lamb import LambState
from apex_tpu_torch.examples.gpt_pretrain import LARGE
from apex_tpu_torch.models import LlamaConfig
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._common import bias_corrections

_RESIDENT = [132 * k for k in (1, 2, 3, 4)]


def _llama_1b_sizes():
    c = LlamaConfig.llama_1b()
    h, ffn = c.hidden_size, c.intermediate_size
    kv = c.num_key_value_heads * (h // c.num_attention_heads)
    layer = [h, h * h, kv * h, kv * h, h * h, h, ffn * h, ffn * h, h * ffn]
    return [c.vocab_size * h] + layer * c.num_hidden_layers + [
        h, c.vocab_size * h]


def _gpt2_large_sizes():
    h = LARGE["hidden"]
    layer = [h, h, 3 * h * h, 3 * h, h * h, h, h, h, 4 * h * h, 4 * h,
             4 * h * h, h]
    return ([LARGE["vocab"] * h, LARGE["seq"] * h] + layer * LARGE["layers"]
            + [h, h])


def _openfold_sizes():
    # one MSA row attention block at the Evoformer's widths: c_m 256,
    # c_z 128, 8 heads of 32; four blocks
    c_m, c_z, heads, hd = 256, 128, 8, 8 * 32
    block = [c_m, c_m, c_z, c_z, heads * c_z, hd * c_m, hd * c_m, hd * c_m,
             hd * c_m, hd, c_m * hd, c_m]
    return block * 4


def _count(sizes, chunk):
    return sum(-(-n // chunk) for n in sizes)


# ---------------------------------------------------------------------------
# the chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resident", _RESIDENT)
@pytest.mark.parametrize("sizes", [_llama_1b_sizes, _gpt2_large_sizes],
                         ids=["llama_1b", "gpt2_large"])
def test_large_lists_keep_the_64k_chunk(sizes, resident):
    sizes = sizes()
    assert mt.choose_chunk(sizes, resident) == mt.CHUNK == 1 << 16
    assert _count(sizes, mt.CHUNK) >= resident


@pytest.mark.parametrize("resident", _RESIDENT)
def test_openfold_list_is_cut_for_every_resident_block(resident):
    sizes = _openfold_sizes()
    assert len(sizes) == 48 and max(sizes) == 1 << 16
    assert _count(sizes, mt.CHUNK) < resident      # 64 K leaves blocks idle
    chunk = mt.choose_chunk(sizes, resident)
    assert chunk & (chunk - 1) == 0 and mt.MIN_CHUNK <= chunk < mt.CHUNK
    assert _count(sizes, chunk) >= resident
    # the largest such power of two: twice it gives too few chunks
    assert _count(sizes, 2 * chunk) < resident
    if resident == 528:                   # 4 blocks of 512 on 132 SMs
        assert chunk == 2048 and _count(sizes, chunk) == 668


def test_chunk_stops_at_its_floor():
    assert mt.choose_chunk([5, 7], 10_000) == mt.MIN_CHUNK == 2048
    assert mt.choose_chunk([], 528) == mt.MIN_CHUNK
    assert mt.choose_chunk([1 << 30], 528) == mt.CHUNK


# ---------------------------------------------------------------------------
# the LAMB group plan
# ---------------------------------------------------------------------------


def _walk(plan, sizes, G):
    """The pieces ``mt_lamb_kernel`` walks, ``(group, block) -> [(t, start,
    len)]``: a narrow group whole by one block; each wide group, by each
    block of its team, from that block's piece word, tensors ``[first,
    end)`` clipped to its span; and for each tensor of a wide group, the
    partial slots ``(wide ordinal, team block)`` the ratio pass reads
    (team blocks ``[b_lo, b_end)``)."""
    Gt = G // plan.teams
    pieces, reads = {}, {}
    for q, gi in enumerate(plan.order):
        t0, t1 = plan.groups[gi]
        if q >= plan.wide:
            assert plan.padded[gi] <= mt.LAMB_NARROW
            pieces[(gi, q - plan.wide)] = [(t, 0, sizes[t])
                                          for t in range(t0, t1) if sizes[t]]
            continue
        assert plan.padded[gi] > mt.LAMB_NARROW
        S, E = plan.span[gi], plan.padded[gi]
        for bt in range(Gt):
            lo = min(E, bt * S)
            hi = min(E, lo + S)
            word = int(plan.pieces[q, bt])
            first, end = word & 0xFFFFFFFF, word >> 32
            assert t0 <= first <= t1 and first <= end <= t1
            for t in range(first, end):
                vb, n = int(plan.offsets[t]), sizes[t]
                assert vb < hi
                start, stop = max(lo, vb), min(hi, vb + n)
                if stop > start:
                    pieces.setdefault((gi, bt), []).append(
                        (t, start - vb, stop - start))
            # no tensor past end reaches the span
            assert end == t1 or plan.offsets[end] >= hi
        for t in range(t0, t1):
            word = int(plan.blocks[t])
            reads[t] = [(q, bt) for bt in range(word & 0xFFFFFFFF, word >> 32)]
    return pieces, reads


def _sizes_cases():
    rng = np.random.default_rng(3)
    out = [
        ([1, 7, 1 << 16, (1 << 16) + 1, 4099, 3 * (1 << 16) - 5], 1 << 20, 528),
        ([0, 5, 0, 0, 9, 1000, 0], 64, 16),
        ([3] * 50, 100, 7),
        ([10_000_003] + [1280] * 30 + [5_000_000, 8, 9], 32 << 20, 528),
        ([64 * 1024] * 48, 0, 528),
    ]
    for _ in range(6):
        T = int(rng.integers(1, 40))
        sizes = [int(x) for x in rng.integers(0, 3000, T)]
        out.append((sizes, int(rng.integers(0, 40_000)),
                    int(rng.integers(1, 200))))
    return out


@pytest.mark.parametrize("teams", [1, 2])
@pytest.mark.parametrize("sizes,budget,G", _sizes_cases())
def test_lamb_plan_groups_and_spans_cover_every_element_once(sizes, budget, G,
                                                             teams):
    rng = np.random.default_rng(len(sizes))
    elem = [int(x) for x in rng.choice([8, 10, 12, 16], len(sizes))]
    if G % teams:
        with pytest.raises(ValueError):
            mt.lamb_plan(sizes, elem, budget, G, teams)
        G -= G % teams
    plan = mt.lamb_plan(sizes, elem, budget, G, teams)
    Gt = G // teams
    # every tensor in exactly one group, in table order
    assert [t for t0, t1 in plan.groups for t in range(t0, t1)] == \
        list(range(len(sizes)))
    for t0, t1 in plan.groups:
        held = sum(sizes[t] * elem[t] for t in range(t0, t1))
        assert held <= budget or t1 - t0 == 1
    # the groups are greedy: the next group's first tensor did not fit
    for (a0, a1), (b0, _) in zip(plan.groups, plan.groups[1:]):
        assert sum(sizes[t] * elem[t] for t in range(a0, b0 + 1)) > budget
    pieces, reads = _walk(plan, sizes, G)
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    wide = {gi: q for q, gi in enumerate(plan.order[:plan.wide])}
    slots = set()
    for (gi, b), ps in pieces.items():
        assert plan.span[gi] % 8 == 0
        for t, start, length in ps:
            assert start % 8 == 0          # a whole vector: 16-byte aligned
            seen[t][start:start + length] += 1
            if gi in wide:
                slot = wide[gi] * Gt + b + t
                assert slot not in slots
                slots.add(slot)
    for t, n in enumerate(sizes):
        assert (seen[t] == 1).all(), t
    # the ratio pass reads exactly the slots the blocks wrote, and they fit
    # the scratch of wide Gt + T slots
    assert {q * Gt + b + t for t, qbs in reads.items() for q, b in qbs} == slots
    assert all(s < plan.wide * Gt + len(sizes) for s in slots)
    # every group once in the order, the wide ones then the narrow ones,
    # each in table order; each wide ordinal in one team's list, in order;
    # the teams' bytes balanced (each group went to the team with the
    # fewest bytes so far)
    assert sorted(plan.order) == list(range(len(plan.groups)))
    assert plan.team_first[0] == 0 and plan.team_first[-1] == plan.wide
    assert len(plan.team_first) == teams + 1
    assert plan.order[:plan.wide] == sorted(plan.order[:plan.wide])
    assert sorted(plan.team_groups) == list(range(plan.wide))
    held = []
    for k in range(teams):
        own = plan.team_groups[plan.team_first[k]:plan.team_first[k + 1]]
        assert own == sorted(own)
        held.append(sum(sizes[t] * elem[t] for q in own
                        for t in range(*plan.groups[plan.order[q]])))
    most = max((sum(sizes[t] * elem[t] for t in range(*plan.groups[gi]))
                for gi in plan.order[:plan.wide]), default=0)
    assert max(held) - min(held) <= most
    assert plan.order[plan.wide:] == sorted(plan.order[plan.wide:])
    # the words as the kernel reads them
    ng, T = len(plan.groups), len(sizes)
    desc = plan.words[:4 * ng].reshape(ng, 4)
    for gi, (t0, t1) in enumerate(plan.groups):
        assert int(desc[gi, 0]) == t0 | (t1 << 32)
        assert (int(desc[gi, 1]), int(desc[gi, 2])) == (plan.span[gi],
                                                        plan.padded[gi])
        assert int(desc[gi, 3]) == sum(sizes[t] * elem[t] for t in range(t0, t1))
    rest = plan.words[4 * ng:]
    np.testing.assert_array_equal(rest[:T], plan.offsets)
    np.testing.assert_array_equal(rest[T:2 * T], plan.blocks)
    np.testing.assert_array_equal(rest[2 * T:2 * T + ng], plan.order)
    at = 2 * T + ng
    np.testing.assert_array_equal(rest[at:at + teams + 1], plan.team_first)
    at += teams + 1
    np.testing.assert_array_equal(rest[at:at + plan.wide], plan.team_groups)
    at += plan.wide
    np.testing.assert_array_equal(rest[at:], plan.pieces.reshape(-1))
    assert rest.size == at + plan.wide * Gt


def test_gpt2_large_plan_at_the_budget():
    """GPT-2-large's O2 list (bf16 matrices, fp32 vectors; bf16 moments):
    each tensor past the budget alone, the vectors joining their
    neighbours: 5 to 6 groups a layer."""
    sizes = _gpt2_large_sizes()
    elem = [8 if n > LARGE["hidden"] * 4 else 12 for n in sizes]
    plan = mt.lamb_plan(sizes, elem, mt.LAMB_BUDGET, 528)
    big = [t for t, n in enumerate(sizes) if n * elem[t] > mt.LAMB_BUDGET]
    assert all((t, t + 1) in plan.groups for t in big)
    assert 5 * LARGE["layers"] <= len(plan.groups) <= 6 * LARGE["layers"] + 4
    # the vectors alone between two big tensors (LayerNorm, fc1's bias)
    # are narrow groups: no grid barrier for them
    assert plan.wide <= 4 * LARGE["layers"] + 2


# ---------------------------------------------------------------------------
# the plain version against one JAX step, over a list that straddles a
# small budget
# ---------------------------------------------------------------------------

_STRADDLE = [(33, 40), (700,), (5, 3), (1000,), (2, 2, 2), (17,)]
_TEST_BUDGET = 4096                        # bytes: g, p, m, v of 256 fp32


def _lamb_inputs(seed):
    rng = np.random.default_rng(seed)
    p = [rng.standard_normal(s).astype(np.float32) for s in _STRADDLE]
    g = [(rng.standard_normal(s) * 64).astype(np.float32) for s in _STRADDLE]
    m = [(rng.standard_normal(s) * 0.01).astype(np.float32) for s in _STRADDLE]
    v = [np.abs(rng.standard_normal(s) * 1e-3).astype(np.float32)
         for s in _STRADDLE]
    return p, g, m, v


def _jax_step(p, g, m, v, *, state_dtype, wd, nvlamb):
    jopt = JaxFusedLAMB(lr=1e-2, weight_decay=wd, use_nvlamb=nvlamb,
                        max_grad_norm=1.0, state_dtype=state_dtype)
    state = (LambState(jnp.int32(1), [jnp.asarray(a, state_dtype) for a in m],
                       [jnp.asarray(a, state_dtype) for a in v]),
             MasterState(None))
    jp, (jstate, _) = jopt.step([jnp.asarray(a) for a in g],
                                [jnp.asarray(a) for a in p], state,
                                grad_scale=jnp.float32(64.0))
    return jp, jstate.exp_avg, jstate.exp_avg_sq


def _torch_step(p, g, m, v, *, dtype, wd, n_ratio=None):
    tp = [torch.from_numpy(a.copy()) for a in p]
    tg = [torch.from_numpy(a.copy()) for a in g]
    tm = [torch.from_numpy(a.copy()).to(dtype) for a in m]
    tv = [torch.from_numpy(a.copy()).to(dtype) for a in v]
    inv = torch.reciprocal(torch.tensor(64.0))
    norm = mt.l2norm(tg, inv).total
    bc1, bc2 = bias_corrections(torch.tensor(2, dtype=torch.int32), 0.9, 0.999)
    mt._plain_lamb(tg, tp, tm, tv, None, lr=1e-2, beta1=0.9, beta2=0.999,
                   beta3=0.1, eps=1e-6, weight_decay=wd, adam_w_mode=True,
                   use_ratio=True, inv_scale=inv,
                   clip=torch.clamp(norm, min=1.0), bc1=bc1, bc2=bc2,
                   noop=None, n_ratio=n_ratio)
    return tp, tm, tv


def _close(got, want, dtype):
    # fp32: a few roundings apart (other summation orders); bf16 moments:
    # each side rounds its fp32 moment once, so one bf16 ulp apart at most
    tol = dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=1e-30, rtol=2.0 ** -7)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(jnp.asarray(e, jnp.float32)),
                                   **tol)


def test_the_list_straddles_the_test_budget():
    sizes = [math.prod(s) for s in _STRADDLE]
    plan = mt.lamb_plan(sizes, [16] * len(sizes), _TEST_BUDGET, 7)
    assert len(plan.groups) >= 4
    assert any(t1 - t0 > 1 for t0, t1 in plan.groups)
    assert any(sizes[t0] * 16 > _TEST_BUDGET and t1 - t0 == 1
               for t0, t1 in plan.groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_moments", "bf16_moments"])
def test_plain_lamb_matches_one_jax_step_over_the_straddling_list(dtype):
    p, g, m, v = _lamb_inputs(11)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax_step(p, g, m, v, state_dtype=jdt, wd=0.01, nvlamb=False)
    got = _torch_step(p, g, m, v, dtype=dtype, wd=0.01)
    _close(got[0], want[0], torch.float32)
    _close(got[1], want[1], dtype)
    _close(got[2], want[2], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_moments", "bf16_moments"])
@pytest.mark.parametrize("n_ratio", [0, 2, 5])
def test_plain_lamb_n_ratio_matches_jax_with_and_without_the_ratio(n_ratio,
                                                                   dtype):
    """Without weight decay JAX applies the trust ratio to every tensor
    under NVLAMB and to none without: the tensors before ``n_ratio`` match
    the first step, the rest the second."""
    p, g, m, v = _lamb_inputs(12)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ratio = _jax_step(p, g, m, v, state_dtype=jdt, wd=0.0, nvlamb=True)
    plain = _jax_step(p, g, m, v, state_dtype=jdt, wd=0.0, nvlamb=False)
    got = _torch_step(p, g, m, v, dtype=dtype, wd=0.0, n_ratio=n_ratio)
    _close(got[0][:n_ratio], ratio[0][:n_ratio], torch.float32)
    _close(got[0][n_ratio:], plain[0][n_ratio:], torch.float32)
    for k in (1, 2):
        _close(got[k], ratio[k], dtype)
    # the two JAX steps differ where the ratio is not 1
    assert not np.allclose(np.asarray(ratio[0][0]), np.asarray(plain[0][0]))


# ---------------------------------------------------------------------------
# on a card: the grouped walk and the small-list chunking
# ---------------------------------------------------------------------------


def _card_list(sizes, dtype, seed, scale=1.0, positive=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for n in sizes:
        t = torch.randn(n, generator=gen, device="cuda") * scale
        out.append((t.abs() if positive else t).to(dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [1 << 16, mt.LAMB_BUDGET])
def test_grouped_lamb_kernel_matches_plain_version_on_card(budget,
                                                           monkeypatch):
    """A tensor past the budget among many small ones, bf16 moments,
    n_ratio < T: within 1e-5 (fp32 p; one bf16 ulp for the moments), the
    same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(mt, "LAMB_BUDGET", budget)
    sizes = [1, 4099] * 10 + [5_000_003] + [7, 65537] * 10
    g = _card_list(sizes, torch.bfloat16, 1, 32.0)
    p = _card_list(sizes, torch.float32, 2)
    m = _card_list(sizes, torch.bfloat16, 3, 0.01)
    v = _card_list(sizes, torch.bfloat16, 4, 1e-3, positive=True)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, adam_w_mode=True, use_ratio=True,
              inv_scale=torch.tensor(1 / 64, device="cuda"),
              clip=torch.tensor(1.5, device="cuda"),
              bc1=torch.tensor(0.19, device="cuda"),
              bc2=torch.tensor(0.002, device="cuda"), noop=None, n_ratio=30)
    runs = []
    for fn in (mt._kernel_lamb, mt._kernel_lamb, mt._plain_lamb):
        tensors = [[x.clone() for x in lst] for lst in (p, m, v)]
        fn(g, *tensors, None, **kw)
        runs.append(tensors)
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k, (got, want) in enumerate(zip(runs[0], runs[2])):
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-5 if k == 0
                                       else 2.0 ** -7, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [mt.ADAMW, mt.SWA_APEX_ADAMW])
def test_adam_kernel_on_small_list_chunks_matches_plain_version_on_card(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sizes = _openfold_sizes()
    assert mt.choose_chunk(sizes, mt.resident_blocks()) < mt.CHUNK
    g = _card_list(sizes, torch.bfloat16, 5, 0.01)
    p = _card_list(sizes, torch.float32, 6)
    m = _card_list(sizes, torch.float32, 7, 1e-3)
    v = _card_list(sizes, torch.float32, 8, 1e-5, positive=True)
    swa_mode = mode == mt.SWA_APEX_ADAMW
    kw = dict(mode=mode, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, inv_scale=None,
              bc1=torch.tensor(0.19, device="cuda"),
              bc2=torch.tensor(0.002, device="cuda"), noop=None,
              step=torch.tensor(3, dtype=torch.int32, device="cuda")
              if swa_mode else None,
              n_averaged=torch.tensor(2, dtype=torch.int32, device="cuda")
              if swa_mode else None, swa_weight=0.1, swa_start_step=0)
    runs = []
    for fn in (mt._kernel_adam, mt._plain_adam):
        tensors = [[x.clone() for x in lst] for lst in (p, m, v, p)]
        copy = [x.bfloat16() for x in p]
        fn(g, *tensors[:3], copy, tensors[3] if swa_mode else None, **kw)
        runs.append(tensors + [copy])
    for got, want in zip(*runs):
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                       atol=1e-6 if a.dtype == torch.float32
                                       else 1e-2)
