"""apex_tpu_torch.ops.flash_attention against apex_tpu.ops.flash_attention.

The same numpy inputs (fixed seeds) go through the JAX function, whose
Pallas forward runs in interpret mode (``APEX_TPU_KERNELS=interpret``,
d = 64 and small ``block_q`` / ``block_k`` so that ``_kernel_ok`` holds and
the grid has several blocks), and through the port's plain version on the
CPU.  ``o`` comes from ``flash_attention`` on both sides, ``lse`` from the
JAX ``_pallas_fwd`` and the port's ``flash_attention_fwd``.  Tolerances:
``o`` and ``lse`` at ``atol = rtol = 1e-5`` in fp32 (the two sides sum in
another order); the dropout keep bits are compared for equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jfa
from apex_tpu_torch.ops import flash_attention as tfa

BLOCK = 16

# name: (b, h, hk, sq, sk, causal, segments, dropout_rate, seed)
CASES = {
    "full": (2, 2, 2, 32, 32, False, None, 0.0, None),
    "causal": (2, 2, 2, 32, 32, True, None, 0.0, None),
    "causal_sq_lt_sk": (1, 2, 2, 16, 48, True, None, 0.0, None),
    "causal_sq_gt_sk": (1, 2, 2, 48, 16, True, None, 0.0, None),
    "segments_packed": (2, 2, 2, 32, 32, False, "packed", 0.0, None),
    "segments_dead_rows": (2, 2, 2, 32, 32, True, "pair", 0.0, None),
    "dropout": (2, 2, 2, 32, 32, True, None, 0.25, 7),
    "dropout_negative_seed": (1, 2, 2, 32, 48, False, "packed", 0.1, -123457),
}


def _inputs(b, h, hk, sq, sk, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    return q, k, v


def _segments(kind, b, sq, sk):
    """``packed``: two packed sequences per row (self-attention ids);
    ``pair``: q ids with a value no key carries, so those rows see no key."""
    if kind is None:
        return None, None
    if kind == "packed":
        qs = (np.arange(sq)[None] >= sq // 3).astype(np.int32).repeat(b, 0)
        ks = (np.arange(sk)[None] >= sk // 3).astype(np.int32).repeat(b, 0)
        return qs, ks
    qs = np.ones((b, sq), np.int32)
    qs[:, : sq // 4] = 9                          # no key is in segment 9
    ks = np.ones((b, sk), np.int32)
    ks[:, sk // 2:] = 2
    return qs, ks


def _jax_side(q, k, v, causal, qs, ks, rate, seed, monkeypatch):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    h, hk = q.shape[1], k.shape[1]
    jq = jnp.asarray(q)
    jk = jnp.asarray(np.repeat(k, h // hk, axis=1))
    jv = jnp.asarray(np.repeat(v, h // hk, axis=1))
    if qs is None:
        seg = jqs = jks = None
    else:
        jqs, jks = jnp.asarray(qs), jnp.asarray(ks)
        seg = jqs if _self_attention(qs, ks) else (jqs, jks)
    assert jfa._kernel_ok(jq, jk, BLOCK, BLOCK)
    o = jfa.flash_attention(jq, jk, jv, causal=causal, segment_ids=seg,
                            dropout_rate=rate, dropout_seed=seed,
                            block_q=BLOCK, block_k=BLOCK)
    jseed = jnp.atleast_1d(jnp.asarray(0 if seed is None else seed,
                                       jnp.int32))
    scale = 1.0 / q.shape[-1] ** 0.5
    _, lse = jfa._pallas_fwd(jq, jk, jv, jqs, jks, jseed, causal, scale,
                             BLOCK, BLOCK, rate)
    return np.asarray(o), np.asarray(lse)


def _self_attention(qs, ks) -> bool:
    """One ``[b, s]`` id tensor serves both sides."""
    return qs.shape == ks.shape and bool((qs == ks).all())


def _torch_segments(qs, ks):
    if qs is None:
        return None
    if _self_attention(qs, ks):
        return torch.from_numpy(qs)
    return torch.from_numpy(qs), torch.from_numpy(ks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, monkeypatch):
    b, h, hk, sq, sk, causal, seg, rate, seed = CASES[case]
    q, k, v = _inputs(b, h, hk, sq, sk)
    qs, ks = _segments(seg, b, sq, sk)
    ref_o, ref_lse = _jax_side(q, k, v, causal, qs, ks, rate, seed,
                               monkeypatch)
    o, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, segment_ids=_torch_segments(qs, ks),
        dropout_rate=rate, dropout_seed=seed)
    assert o.dtype == torch.float32 and tuple(o.shape) == ref_o.shape
    assert lse.dtype == torch.float32 and tuple(lse.shape) == ref_lse.shape
    np.testing.assert_allclose(o.numpy(), ref_o, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-5)
    if seg == "pair" or (causal and sq > sk):
        dead = np.isinf(ref_lse)
        assert dead.any()
        assert (lse.numpy()[dead] == np.inf).all()
        assert (o.numpy()[dead] == 0.0).all()


def test_gqa_reads_the_groups_kv_head(monkeypatch):
    """k and v with fewer heads than q equal the JAX call on K/V repeated
    per group (the JAX model's jnp.repeat)."""
    q, k, v = _inputs(2, 4, 2, 32, 32, seed=3)
    ref_o, ref_lse = _jax_side(q, k, v, True, None, None, 0.0, None,
                               monkeypatch)
    o, lse = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(o.numpy(), ref_o, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-5)
    rep = tfa.flash_attention(torch.from_numpy(q),
                              torch.from_numpy(np.repeat(k, 2, axis=1)),
                              torch.from_numpy(np.repeat(v, 2, axis=1)),
                              causal=True)
    np.testing.assert_array_equal(o.numpy(), rep.numpy())


@pytest.mark.parametrize("seed", [-2**31, -123457, -1, 0, 1, 7, 2**31 - 1])
def test_hash_keep_bits_match_jax(seed):
    """The port's _fmix32 / _hash_keep in int64 arithmetic against the JAX
    uint32 ones, over a grid of coordinates (small and large) and rates;
    an int32 seed wraps to uint32 as jnp.asarray(seed, uint32) does."""
    rng = np.random.default_rng(5)
    g = np.arange(6, dtype=np.uint32).reshape(6, 1, 1)
    qpos = np.concatenate([np.arange(20), rng.integers(0, 2**31, 12)]
                          ).astype(np.uint32).reshape(1, -1, 1)
    kpos = np.concatenate([np.arange(20), rng.integers(0, 2**31, 12)]
                          ).astype(np.uint32).reshape(1, 1, -1)
    jseed = jnp.asarray(jnp.asarray(seed, jnp.int32), jnp.uint32)
    t = {n: torch.from_numpy(a.astype(np.int64)) for n, a in
         (("g", g), ("q", qpos), ("k", kpos))}
    mixed = np.asarray(jfa._fmix32(jseed ^ jnp.asarray(qpos)))
    ours = tfa._fmix32(tfa._seed_bits(seed) ^ t["q"])
    np.testing.assert_array_equal(ours.numpy(), mixed.astype(np.int64))
    for rate in (0.1, 0.5, 0.9):
        ref = np.asarray(jfa._hash_keep(jseed, jnp.asarray(g),
                                        jnp.asarray(qpos), jnp.asarray(kpos),
                                        rate))
        keep = tfa._hash_keep(seed, t["g"], t["q"], t["k"], rate)
        np.testing.assert_array_equal(keep.numpy(), ref)


def test_dropout_keeps_the_seeded_bits():
    """The plain version's dropout: dropped entries are exactly those the
    hash drops (V = identity reads P back), kept ones scaled by
    1 / (1 - rate), and a different seed drops others."""
    sq = sk = d = 64
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 1, sq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, sk, d)).astype(np.float32))
    eye = torch.eye(sk, d).view(1, 1, sk, d)
    p = tfa.flash_attention(q, k, eye)
    pd = tfa.flash_attention(q, k, eye, dropout_rate=0.5, dropout_seed=11)
    keep = tfa._hash_keep(11, torch.zeros(1, 1, 1, 1, dtype=torch.int64),
                          torch.arange(sq).view(1, 1, sq, 1),
                          torch.arange(sk).view(1, 1, 1, sk), 0.5)
    assert 0.3 < keep.float().mean() < 0.7
    np.testing.assert_array_equal((pd != 0).numpy(), keep.numpy())
    torch.testing.assert_close(pd[keep], p[keep] / 0.5, atol=1e-6, rtol=1e-6)
    other = tfa.flash_attention(q, k, eye, dropout_rate=0.5, dropout_seed=12)
    assert not torch.equal(other != 0, pd != 0)


def test_argument_checks():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfa.flash_attention(q, q, q, dropout_rate=1.0, dropout_seed=0)


def test_plain_version_is_differentiable_on_cpu():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(1, 2, 1, 16, 16, seed=8))
    o = tfa.flash_attention(q, k, v, causal=True)
    o.square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert k.grad.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_matches_plain_version_on_card(dtype):
    """The CUDA kernel against its plain version on the card (chip_smoke.py
    runs the full grid of variants), fp32 on the CUDA-core kernel and the
    two 16-bit types on the TMA + wgmma one, at chip_smoke.py's
    tolerances: fp32 o at 1e-5 + 1e-5 |ref|; a 16-bit o within half an
    epsilon of sum_j p_ij |v_j| (the kernel rounds p to the operand dtype)
    plus the dtype's least p spacing times sk max|v| and 2 ulp of the
    output; lse at 1e-5 + 1e-5 |ref|.  Skipped on a host without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt)
               for a in _inputs(2, 4, 2, 40, 72))
    with torch.no_grad():
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        ro, rlse = tfa._plain_forward(q, k, v, causal=True)
        if dtype == "float32":
            tol = 1e-5 + 1e-5 * ro.abs()
        else:
            bits = {"bfloat16": 7, "float16": 10}[dtype]
            half_eps = 2.0 ** -(bits + 1)
            floor = max(torch.finfo(dt).tiny * half_eps,
                        torch.finfo(torch.float32).tiny)
            pv_abs, _ = tfa._plain_forward(q.float(), k.float(),
                                           v.float().abs(), causal=True)
            mag = ro.float().abs().clamp_min(torch.finfo(dt).tiny)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
            tol = (half_eps * pv_abs + floor * 72 * float(v.float().abs().max())
                   + 2 * ulp)
    assert ((o.float() - ro.float()).abs() <= tol).all()
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the backward (training slice)
# ---------------------------------------------------------------------------


def _jax_grads(q, k, v, causal, qs, ks, rate, seed, do, monkeypatch):
    """dq and the per-kv-head dk, dv of the JAX ``flash_attention`` (its
    Pallas dq and dk/dv kernels in interpret mode) on K/V repeated per
    group, as the JAX model calls it; the repeated heads' grads are summed
    over each group."""
    import jax

    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    h, hk = q.shape[1], k.shape[1]
    rep = h // hk
    if qs is None:
        seg = None
    else:
        jqs, jks = jnp.asarray(qs), jnp.asarray(ks)
        seg = jqs if _self_attention(qs, ks) else (jqs, jks)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, segment_ids=seg,
                                   dropout_rate=rate, dropout_seed=seed,
                                   block_q=BLOCK, block_k=BLOCK)

    jk = jnp.asarray(np.repeat(k, rep, axis=1))
    jv = jnp.asarray(np.repeat(v, rep, axis=1))
    assert jfa._kernel_ok(jnp.asarray(q), jk, BLOCK, BLOCK)
    _, vjp = jax.vjp(f, jnp.asarray(q), jk, jv)
    dq, dk, dv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    b, _, sk, d = k.shape
    return (dq, dk.reshape(b, hk, rep, sk, d).sum(2),
            dv.reshape(b, hk, rep, sk, d).sum(2))


def _torch_grads(q, k, v, causal, qs, ks, rate, seed, do):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal,
                            segment_ids=_torch_segments(qs, ks),
                            dropout_rate=rate, dropout_seed=seed)
    o.backward(torch.from_numpy(do))
    return tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


# the forward's cases plus grouped-query attention (4 query heads over 2)
_BWD_CASES = dict(CASES, gqa=(2, 4, 2, 32, 32, True, None, 0.0, None),
                  gqa_dropout=(1, 4, 1, 32, 48, True, "packed", 0.2, 5))


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_backward_matches_jax_grad(case, monkeypatch):
    """dq, dk, dv of the port's plain backward (through ``_FlashFunction``
    on the CPU) against ``jax.vjp`` of the JAX ``flash_attention``: causal,
    segment ids with dead rows, dropout with the same seed, sq != sk, and
    GQA, where the port's kv-head grads equal JAX's repeated-head grads
    summed over each group.  fp32; atol = rtol = 1e-5 (sums over 16-48
    keys and rows taken in another order)."""
    b, h, hk, sq, sk, causal, seg, rate, seed = _BWD_CASES[case]
    q, k, v = _inputs(b, h, hk, sq, sk, seed=21)
    do = np.random.default_rng(22).standard_normal(q.shape).astype(np.float32)
    qs, ks = _segments(seg, b, sq, sk)
    ref = _jax_grads(q, k, v, causal, qs, ks, rate, seed, do, monkeypatch)
    ours = _torch_grads(q, k, v, causal, qs, ks, rate, seed, do)
    for name, o, r in zip(("dq", "dk", "dv"), ours, ref):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, atol=1e-5, rtol=1e-5, err_msg=name)


def test_backward_function_equals_direct_call():
    """``flash_attention_bwd`` on the forward's o and lse gives what
    autograd through ``flash_attention`` gives."""
    q, k, v = _inputs(1, 4, 2, 24, 40, seed=23)
    do = np.random.default_rng(24).standard_normal(q.shape).astype(np.float32)
    ours = _torch_grads(q, k, v, True, None, None, 0.1, 3, do)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=True, dropout_rate=0.1,
                                     dropout_seed=3)
    direct = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=True,
                                     dropout_rate=0.1, dropout_seed=3)
    for a, b in zip(ours, direct):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("causal,segments,rate", [
    (True, False, 0.0), (False, True, 0.0), (True, True, 0.3)])
def test_flash_function_gradcheck(causal, segments, rate):
    """``_FlashFunction`` in float64, with GQA and sq != sk, against finite
    differences (dead rows, whose lse is +inf, included by the segments);
    head dim 16, which only the plain version takes."""
    rng = np.random.default_rng(25)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 4, 6, 16), (1, 2, 9, 16), (1, 2, 9, 16)))
    seg = None
    if segments:
        seg = (torch.tensor([[0, 0, 1, 1, 1, 7]]),
               torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1, 1]]))
    fn = lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal,
                                             segment_ids=seg,
                                             dropout_rate=rate,
                                             dropout_seed=9 if rate else None)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_no_graph_without_grad():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, seed=26))
    assert tfa.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    o, lse = tfa.flash_attention_fwd(q, k, v)
    assert o.grad_fn is not None and not lse.requires_grad


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, seed=27))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._BwdLaunch(q, k, v, o, lse, o, None, None, False, 0.125, 0.0, None)


@pytest.mark.cuda
def test_backward_kernels_match_plain_version_on_card():
    """The dq and dk/dv kernels against the plain backward on the card
    (chip_smoke.py runs the full grid); skipped on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.from_numpy(a).cuda() for a in _inputs(2, 4, 2, 40, 72))
    do = torch.randn_like(q)
    with torch.no_grad():
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        ours = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        ref = tfa._plain_backward(q, k, v, o, lse, do, causal=True)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the 16-bit kernels' TMA map geometry (host side, pure Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tma_geometry_of_the_models_layout(d):
    """The model hands the kernels ``[s, b, heads, d]`` viewed as ``[b,
    heads, s, d]``: the map's dims run (d, s, heads, b) and its byte
    strides follow the view, whatever their order; a box row is one
    swizzle span (64 columns, 128 bytes; 32 columns, 64 bytes at d 32)."""
    s, b, h = 40, 3, 4
    x = torch.empty(s, b, h, d, dtype=torch.bfloat16).permute(1, 2, 0, 3)
    geo = tfa._tma_geometry(x.shape, x.stride(), x.dtype, tfa._TILE_ROWS)
    cols = min(d, 64)
    assert geo == (d, s, h, b, 2 * b * h * d, 2 * d, 2 * h * d,
                   cols, tfa._TILE_ROWS, 1, 1, 2 * cols)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tma_geometry_of_a_contiguous_tensor(d, dtype):
    b, h, s = 2, 3, 100
    x = torch.empty(b, h, s, d, dtype=dtype)
    geo = tfa._tma_geometry(x.shape, x.stride(), dtype, tfa._BLOCK_ROWS)
    assert geo[:4] == (d, s, h, b)
    assert geo[4:7] == (2 * d, 2 * s * d, 2 * h * s * d)
    assert geo[7:] == (min(d, 64), tfa._BLOCK_ROWS, 1, 1, 2 * min(d, 64))


def test_tma_geometry_packs_the_stride_of_a_unit_dimension():
    """TMA steps over no dimension of extent 1, so its stride (any value a
    view may carry) becomes the packed one."""
    x = torch.empty(1, 1, 1, 64, dtype=torch.float16)
    x = x.as_strided(x.shape, (7, 5, 3, 1))
    geo = tfa._tma_geometry(x.shape, x.stride(), x.dtype, 64)
    assert geo[4:7] == (128, 128, 128)


@pytest.mark.parametrize("strides", [(4 * 68 * 40, 68 * 40, 68, 1),
                                     (4 * 64 * 40, 64 * 40, 0, 1),
                                     (4 * 64 * 40 + 4, 64 * 40, 64, 1)])
def test_tma_geometry_refuses_strides_off_16_bytes(strides):
    """A stride that is not a positive multiple of 16 bytes (a row of 68
    bf16 values, a broadcast row, a batch stride off by 8 bytes) raises."""
    with pytest.raises(ValueError, match="16"):
        tfa._tma_geometry((2, 4, 40, 64), strides, torch.bfloat16, 64)


def test_tma_geometry_refuses_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        tfa._tma_geometry((1, 1, 8, 64), (512, 512, 64, 1), torch.float32, 64)
    with pytest.raises(ValueError, match="head dim"):
        tfa._tma_geometry((1, 1, 8, 48), (384, 384, 48, 1), torch.bfloat16, 64)
    with pytest.raises(ValueError, match="last stride"):
        tfa._tma_geometry((1, 1, 8, 64), (1024, 1024, 128, 2), torch.bfloat16, 64)


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_tma_maps_are_the_geometries_and_cached(kernel):
    """A kernel's C argument is its operands' geometries in order, 12
    values each (the forward's q, k, v; each backward kernel's four),
    worked out once for each shape and strides."""
    q = torch.empty(64, 2, 4, 64, dtype=torch.bfloat16).permute(1, 2, 0, 3)
    k = torch.empty(2, 2, 64, 64, dtype=torch.bfloat16)
    operands = ((q, 128), (k, 64), (k, 64))
    if kernel == "backward":
        operands = ((q, 128), (q, 128), (k, 64), (k, 64))
    parts = tuple(tfa._tma_part(t, rows) for t, rows in operands)
    maps = tfa._tma_maps(torch.bfloat16, parts)
    expect = [x for shape, strides, rows in parts
              for x in tfa._tma_geometry(shape, strides, torch.bfloat16, rows)]
    assert list(maps) == expect and len(expect) == 12 * len(operands)
    assert tfa._tma_maps(torch.bfloat16, parts) is maps


def _strided(shape, strides, dtype, offset=0):
    """A view of ``shape`` with element ``strides``, ``offset`` elements into
    a buffer that starts on 16 bytes."""
    n = offset + sum((e - 1) * st for e, st in zip(shape, strides)) + 1
    return torch.zeros(n, dtype=dtype)[offset:].as_strided(shape, strides)


# name: (make (q, k, v), error or None): None means the wrapper gets as far
# as the device, which on this host is the CPU and raises "CUDA"
_FWD_LAYOUTS = {
    "row_of_68_bf16": (lambda: (_strided((2, 4, 40, 64), (4 * 68 * 40, 68 * 40, 68, 1),
                                         torch.bfloat16),) * 3, "16 bytes"),
    "batch_stride_off_fp16": (lambda: (_strided((2, 4, 40, 64), (4 * 64 * 40 + 4, 64 * 40, 64, 1),
                                                torch.float16),) * 3, "16 bytes"),
    "q_off_16_bytes": (lambda: (_strided((1, 2, 40, 64), (2 * 40 * 64, 40 * 64, 64, 1),
                                         torch.bfloat16, offset=4),
                                torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16),
                                torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16)), "16 bytes"),
    "models_layout_bf16": (lambda: tuple(torch.zeros(40, 2, 4, 64, dtype=torch.bfloat16)
                                         .permute(1, 2, 0, 3) for _ in range(3)), None),
    "broadcast_kv_head_fp16": (lambda: (torch.zeros(1, 4, 40, 64, dtype=torch.float16),
                                        torch.zeros(1, 1, 40, 64, dtype=torch.float16)
                                        .expand(1, 4, 40, 64),
                                        torch.zeros(1, 4, 40, 64, dtype=torch.float16)), None),
    "fp32_cuda_cores": (lambda: tuple(torch.zeros(1, 2, 40, 32) for _ in range(3)), None),
}


@pytest.mark.parametrize("case", sorted(_FWD_LAYOUTS))
def test_forward_wrapper_refuses_what_the_maps_cannot_read(case):
    """The forward wrapper checks layouts before the device, so a 16-bit
    operand whose start or strides are off 16 bytes raises on any host;
    one the maps can read (the model's permuted layout, a broadcast kv head,
    which is copied first) and fp32 (its CUDA-core kernel takes no maps)
    get as far as the device check."""
    make, match = _FWD_LAYOUTS[case]
    q, k, v = make()
    with pytest.raises(ValueError, match=match or "CUDA"):
        tfa._kernel_forward(q, k, v, None, None, True, 0.125, 0.0, None)
