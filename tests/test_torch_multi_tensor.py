"""apex_tpu_torch.ops.multi_tensor: the walker's table, and the plain
versions of the four multi-tensor kernels against the JAX package.

- The table (``table_words``): decoded as ``csrc/multi_tensor_apply.cuh``
  decodes it, its chunks cover every element of every tensor exactly once,
  each tensor's chunks lie at its row's first chunk, in order, and the
  row's meta word carries each list's dtype code and the alignment bit;
  over tensor counts, sizes (0, 1, 7, a chunk, a chunk + 1, not multiples
  of 8), chunk sizes (the chunk ``choose_chunk`` takes for OpenFold's
  list among them) and empty lists.
- The plain versions (the CPU path) against the JAX functions on the same
  numpy inputs: ``l2norm`` against ``multi_tensor_l2norm`` and
  ``multi_tensor_unscale_l2norm`` (fp32 sums in another order: rtol 1e-6);
  ``scale`` against ``multi_tensor_scale`` (bit for bit where the scale is
  a power of two; within one ulp of the leaf's dtype where JAX rounds the
  scale to a half leaf's dtype first) and its overflow flag; ``adam``
  against one ``FusedAdam`` and one ``FusedAdamSWA`` step, ``lamb``
  against one ``FusedLAMB`` step (fp32 results a few roundings apart:
  atol 1e-6, rtol 1e-5); a set ``noop`` keeps every bit.
- Each kernel against its plain version on a card (``cuda`` marker;
  skipped here, ``chip_smoke.py`` runs the full grid there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.openfold_triton import fused_adam_swa as jswa
from apex_tpu.multi_tensor_apply import (
    multi_tensor_l2norm as jax_l2norm,
    multi_tensor_scale as jax_scale,
    multi_tensor_unscale_l2norm as jax_unscale_l2norm,
)
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers._common import MasterState
from apex_tpu.optimizers.fused_adam import AdamState
from apex_tpu.optimizers.fused_lamb import LambState
from apex_tpu_torch.multi_tensor_apply import (
    _nonfinite,
    multi_tensor_unscale_l2norm,
)
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._common import bias_corrections
from apex_tpu_torch.utils.tree_math import tree_l2norm

_F32 = dict(atol=1e-6, rtol=1e-5)
_SHAPES = [(6, 5), (7,), (3, 4, 2), ()]
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _arrays(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal(s) * scale).astype(np.float32) for s in _SHAPES]
    return [np.abs(a) for a in out] if positive else out


def _torch(arrays, dtypes=None):
    dtypes = dtypes or [torch.float32] * len(arrays)
    return [torch.from_numpy(np.array(a)).to(d) for a, d in zip(arrays, dtypes)]


def _jax(tensors):
    return [jnp.asarray(t.float().numpy(), _JNP[t.dtype]) for t in tensors]


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


def _decode(words, T, L, chunk):
    """The walker's reading of the words: (tensor, start, len) per chunk,
    and each row's (n, meta, first chunk)."""
    rows = words[:T * (L + 3)].reshape(T, L + 3)
    chunks = []
    for w in words[T * (L + 3):]:
        t, k = int(w) >> 32, int(w) & 0xFFFFFFFF
        n = int(rows[t, L])
        start = k * chunk
        chunks.append((t, start, min(chunk, n - start)))
    return rows, chunks


_CASES = [
    ([], 8),
    ([1], 8),
    ([7, 0, 1], 8),
    ([0, 0], 64),
    ([64, 65, 1, 7, 63], 64),
    ([1 << 16, (1 << 16) + 1, 12345], 1 << 16),
    (list(range(0, 300, 7)), 16),
    ([3 * 64 - 5] * 200, 64),
]
# the chunk the table chooses for a short list (OpenFold's 48 tensors of at
# most 64 K elements, four blocks of 512 on each of 132 SMs) and a long one
_OPENFOLD = [256, 256, 128, 128, 1024] + [1 << 16] * 4 + [256, 1 << 16, 256]
_CASES += [(sizes, mt.choose_chunk(sizes, 528))
           for sizes in (_OPENFOLD * 4, [5, 1 << 20, 3 * 2048 + 1] * 3)]


@pytest.mark.parametrize("sizes,chunk", _CASES,
                         ids=[f"T{len(s)}-chunk{c}" for s, c in _CASES])
@pytest.mark.parametrize("L", [1, 2, 6])
def test_chunk_table_covers_every_element_once(sizes, chunk, L):
    T = len(sizes)
    rng = np.random.default_rng(T + L)
    # 16-byte aligned pointers, but for every third tensor one list off by 2
    ptrs = [[0x7F0000000000 + 4096 * (t * L + l) + (2 if t % 3 == 2 and l == L - 1
                                                    else 0)
             for l in range(L)] for t in range(T)]
    codes = [[int(c) for c in rng.integers(0, 3, L)] for _ in range(T)]
    words, C = mt.table_words(ptrs, sizes, codes, chunk)
    assert words.dtype == np.int64
    assert C == sum(-(-n // chunk) for n in sizes)
    assert words.size == T * (L + 3) + C
    # tensor by tensor, each tensor's chunks in order
    assert [(int(w) >> 32, int(w) & 0xFFFFFFFF) for w in words[T * (L + 3):]] \
        == [(t, k) for t, n in enumerate(sizes) for k in range(-(-n // chunk))]
    rows, chunks = _decode(words, T, L, chunk)
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    for t, start, length in chunks:
        assert 0 < length <= chunk
        seen[t][start:start + length] += 1
    for t, n in enumerate(sizes):
        assert (seen[t] == 1).all(), t
        assert list(rows[t, :L]) == ptrs[t]
        assert rows[t, L] == n
        meta = int(rows[t, L + 1])
        assert [(meta >> (4 * l)) & 15 for l in range(L)] == codes[t]
        assert (meta >> 32) & 1 == int(t % 3 != 2)
        # the finish pass reads tensor t's chunks at [first, first + count)
        first, count = int(rows[t, L + 2]), -(-n // chunk)
        assert [c[0] for c in chunks[first:first + count]] == [t] * count
        assert [c[1] for c in chunks[first:first + count]] == \
            [k * chunk for k in range(count)]


def test_table_of_no_list_is_empty():
    words, C = mt.table_words([], [], [])
    assert C == 0 and words.size == 0


def test_empty_trees_come_back_on_the_callers_device():
    """``_nonfinite`` and ``tree_l2norm`` of a tree with no leaves give
    their zero on the device the caller names (the meta device here)."""
    flag = _nonfinite([], device="meta")
    assert flag.device.type == "meta" and flag.dtype == torch.bool
    norm = tree_l2norm([], device="meta")
    assert norm.device.type == "meta" and norm.dtype == torch.float32
    total, per = tree_l2norm({}, per_leaf=True, device="meta")
    assert total.device.type == "meta" and per == []
    assert _nonfinite([]).device.type == "cpu"


# ---------------------------------------------------------------------------
# l2norm and scale against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_l2norm_matches_jax(dtype):
    xs = _torch(_arrays(1), [dtype, torch.float32, dtype, dtype])
    jt, jper = jax_l2norm(_jax(xs), per_tensor=True)
    out = mt.l2norm(xs)
    np.testing.assert_allclose(_np32(out.total), _np32(jt), rtol=1e-6)
    for a, e in zip(out.per_tensor, jper):
        np.testing.assert_allclose(_np32(a), _np32(e), rtol=1e-6)
    np.testing.assert_allclose(_np32(out.per_tensor_sq),
                               _np32(out.per_tensor) ** 2, rtol=1e-6)
    assert int(out.flag) == 0
    xs[1][0] = float("nan")
    assert int(mt.l2norm(xs).flag) == 1


@pytest.mark.parametrize("per_tensor", [False, True])
def test_unscale_l2norm_matches_jax(per_tensor):
    """A power-of-two inverse scale: the products are exact on both sides,
    so the unscaled tree is the same bits and the norms agree to fp32
    rounding."""
    xs = _torch(_arrays(2, 1024.0), [torch.float32, torch.bfloat16,
                                     torch.float32, torch.float16])
    inv = 2.0 ** -10
    out, norm = multi_tensor_unscale_l2norm(xs, inv, per_tensor=per_tensor)
    jout, jnorm = jax_unscale_l2norm(_jax(xs), inv, per_tensor=per_tensor)
    for x, a, e in zip(xs, out, jout):
        assert a.dtype == x.dtype
        np.testing.assert_array_equal(_np32(a), _np32(e))
    if per_tensor:
        np.testing.assert_allclose(_np32(norm[0]), _np32(jnorm[0]), rtol=1e-6)
        for a, e in zip(norm[1], jnorm[1]):
            np.testing.assert_allclose(_np32(a), _np32(e), rtol=1e-6)
    else:
        np.testing.assert_allclose(_np32(norm), _np32(jnorm), rtol=1e-6)


@pytest.mark.parametrize("value", [0.5, 0.3])
def test_scale_matches_jax(value):
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.float32]
    xs = _torch(_arrays(3), dtypes)
    outs = [torch.empty_like(x) for x in xs]
    flag = mt.scale(xs, outs, value)
    jout, jflag = jax_scale(_jax(xs), value)
    assert bool(flag) is bool(jflag) is False
    for x, a, e in zip(xs, outs, jout):
        assert a.dtype == x.dtype
        if x.dtype == torch.float32 or value == 0.5:
            np.testing.assert_array_equal(_np32(a), _np32(e))
        else:
            # JAX rounds the scale to the leaf's dtype before the product
            bits = {torch.bfloat16: 7, torch.float16: 10}[x.dtype]
            mag = np.maximum(np.abs(_np32(a)), np.abs(_np32(e)))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - bits)
            assert (np.abs(_np32(a) - _np32(e)) <= ulp).all()
    # in place, a device scale, and the flag on an inf (checked before the
    # product: the input holds it)
    xs[2][1] = float("inf")
    flag = mt.scale(xs, xs, torch.tensor(value))
    assert bool(flag) and bool(jax_scale(_jax(xs), value)[1])
    assert bool(mt.scale(xs, None, 1.0))
    assert mt.scale(xs, xs, 1.0, check=False) is None


# ---------------------------------------------------------------------------
# adam and lamb against one JAX step
# ---------------------------------------------------------------------------


def _state_arrays():
    p = _arrays(4)
    g = _arrays(5, 64.0)
    m = _arrays(6, 0.01)
    v = _arrays(7, 1e-3, positive=True)
    return p, g, m, v


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("mode", [mt.ADAM_L2, mt.ADAMW], ids=["l2", "adamw"])
def test_adam_matches_one_jax_fused_adam_step(mode, wd):
    p, g, m, v = _state_arrays()
    scale = 64.0
    kw = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
              adam_w_mode=mode == mt.ADAMW, weight_decay=wd)
    jopt = JaxFusedAdam(**kw)
    state = (AdamState(jnp.int32(1), [jnp.asarray(a) for a in m],
                       [jnp.asarray(a) for a in v]), MasterState(None))
    jp, (jstate, _) = jopt.step([jnp.asarray(a) for a in g],
                                [jnp.asarray(a) for a in p], state,
                                grad_scale=jnp.float32(scale))
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    bc1, bc2 = bias_corrections(torch.tensor(2, dtype=torch.int32), 0.9, 0.999)
    mt.adam(_torch(g), tp, tm, tv, mode=mode, lr=1e-2, beta1=0.9, beta2=0.999,
            eps=1e-8, weight_decay=wd,
            inv_scale=torch.reciprocal(torch.tensor(scale)), bc1=bc1, bc2=bc2)
    for got, want in ((tp, jp), (tm, jstate.exp_avg), (tv, jstate.exp_avg_sq)):
        for a, e in zip(got, want):
            np.testing.assert_allclose(_np32(a), _np32(e), **_F32)


@pytest.mark.parametrize("n_averaged", [0, 2])
@pytest.mark.parametrize("mode", ["ApexAdam", "ApexAdamW", "PyTorchAdam"])
def test_adam_swa_matches_one_jax_step(mode, n_averaged):
    p, g, m, v = _state_arrays()
    swa = _arrays(8)
    decay = 0.8
    jopt = jswa.FusedAdamSWA(lr=1e-2, weight_decay=0.01, swa_decay_rate=decay,
                             adam_math_mode=jswa.AdamMathType[mode])
    half = [jnp.asarray(a, jnp.bfloat16) for a in p]
    state = jswa.AdamSWAState(
        jnp.int32(1), jnp.int32(n_averaged), [jnp.asarray(a) for a in m],
        [jnp.asarray(a) for a in v], [jnp.asarray(a) for a in swa],
        [jnp.asarray(a) for a in p])
    jparams, jstate = jopt.step([jnp.asarray(a) for a in g], half, state,
                                grad_scale=jnp.float32(8.0))
    tp, tm, tv, ts = _torch(p), _torch(m), _torch(v), _torch(swa)
    copy = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in half]
    bc1, bc2 = bias_corrections(torch.tensor(2, dtype=torch.int32), 0.9, 0.999)
    mt.adam(_torch(g), tp, tm, tv, copy=copy, swa=ts,
            mode={"ApexAdam": mt.SWA_APEX_ADAM, "ApexAdamW": mt.SWA_APEX_ADAMW,
                  "PyTorchAdam": mt.SWA_PYTORCH_ADAM}[mode],
            lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
            inv_scale=torch.tensor(0.125), bc1=bc1, bc2=bc2,
            step=torch.tensor(2, dtype=torch.int32),
            n_averaged=torch.tensor(n_averaged, dtype=torch.int32),
            swa_weight=float(np.float32(1.0) - np.float32(decay)),
            swa_start_step=0)
    for got, want in ((tp, jstate.state_params), (tm, jstate.exp_avg),
                      (tv, jstate.exp_avg_sq), (ts, jstate.swa_params)):
        for a, e in zip(got, want):
            np.testing.assert_allclose(_np32(a), _np32(e), **_F32)
    for a, e in zip(copy, jparams):
        assert a.dtype == torch.bfloat16
        ulp = 2.0 ** -7 * np.abs(_np32(e)) + 1e-30
        assert (np.abs(_np32(a) - _np32(e)) <= ulp).all()


@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
@pytest.mark.parametrize("wd,nvlamb", [(0.01, False), (0.0, False),
                                       (0.0, True)],
                         ids=["wd", "no_wd", "nvlamb"])
def test_lamb_matches_one_jax_fused_lamb_step(wd, nvlamb, adam_w_mode):
    """One FusedLAMB step with the global-norm clip (the gradients' norm is
    past max_grad_norm) and an inverse loss scale."""
    p, g, m, v = _state_arrays()
    scale = 64.0
    jopt = JaxFusedLAMB(lr=1e-2, weight_decay=wd, use_nvlamb=nvlamb,
                        adam_w_mode=adam_w_mode, max_grad_norm=1.0)
    state = (LambState(jnp.int32(1), [jnp.asarray(a) for a in m],
                       [jnp.asarray(a) for a in v]), MasterState(None))
    jp, (jstate, _) = jopt.step([jnp.asarray(a) for a in g],
                                [jnp.asarray(a) for a in p], state,
                                grad_scale=jnp.float32(scale))
    tg, tp, tm, tv = _torch(g), _torch(p), _torch(m), _torch(v)
    inv = torch.reciprocal(torch.tensor(scale))
    norm = mt.l2norm(tg, inv).total
    assert float(norm) > 1.0
    bc1, bc2 = bias_corrections(torch.tensor(2, dtype=torch.int32), 0.9, 0.999)
    mt.lamb(tg, tp, tm, tv, lr=1e-2, beta1=0.9, beta2=0.999, beta3=0.1,
            eps=1e-6, weight_decay=wd, adam_w_mode=adam_w_mode,
            use_ratio=bool(wd or nvlamb), inv_scale=inv,
            clip=torch.clamp(norm / 1.0, min=1.0), bc1=bc1, bc2=bc2)
    for got, want in ((tp, jp), (tm, jstate.exp_avg), (tv, jstate.exp_avg_sq)):
        for a, e in zip(got, want):
            np.testing.assert_allclose(_np32(a), _np32(e), **_F32)


def test_lamb_apply_scales_each_update_by_its_ratio():
    p, u = _arrays(9), _arrays(10, 1e-2)
    tp, tu = _torch(p), _torch(u)
    n = len(tp) - 1                      # the last tensor takes ratio 1
    norms = mt.l2norm(tp[:n] + tu[:n]).per_tensor
    mt.lamb_apply(tp, tu, lr=0.1, norms=norms, n_ratio=n)
    for i, (a, p0, u0) in enumerate(zip(tp, p, u)):
        ratio = 1.0
        if i < n:
            ratio = np.sqrt(np.sum(p0.astype(np.float64) ** 2)) / \
                np.sqrt(np.sum(u0.astype(np.float64) ** 2))
        np.testing.assert_allclose(_np32(a), p0 - 0.1 * ratio * u0,
                                   atol=1e-6, rtol=1e-6)


def test_a_set_noop_keeps_every_bit():
    p, g, m, v = _state_arrays()
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    copy = [x.bfloat16() for x in tp]
    before = [x.clone() for x in tp + tm + tv + copy]
    skip = torch.tensor(True)
    mt.adam(_torch(g), tp, tm, tv, copy=copy, mode=mt.ADAMW, lr=1e-2,
            beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01, noop=skip)
    mt.lamb(_torch(g), tp, tm, tv, copy=copy, lr=1e-2, beta1=0.9,
            beta2=0.999, beta3=0.1, eps=1e-6, weight_decay=0.01,
            adam_w_mode=True, use_ratio=True, noop=skip)
    for a, b in zip(tp + tm + tv + copy, before):
        assert torch.equal(a, b)


def test_the_plain_versions_raise_nothing_on_empty_lists():
    assert mt.adam([], [], [], [], mode=mt.ADAMW, lr=1.0, beta1=0.9,
                   beta2=0.9, eps=1.0, weight_decay=0.0) is None
    assert mt.lamb([], [], [], [], lr=1.0, beta1=0.9, beta2=0.9, beta3=0.1,
                   eps=1.0, weight_decay=0.0, adam_w_mode=True,
                   use_ratio=True) is None
    with pytest.raises(ValueError):
        mt.l2norm([])
    with pytest.raises(ValueError):
        mt.scale([], None, 1.0)


# ---------------------------------------------------------------------------
# on a card: each kernel against its plain version
# ---------------------------------------------------------------------------


def _card_lists(dtypes, sizes, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(n, generator=gen, device="cuda") * 0.5).to(d)
            for n, d in zip(sizes, dtypes)]


_CARD_SIZES = [1, 7, (1 << 16) + 1, 4099]


_CARD_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.cuda
def test_l2norm_kernel_matches_plain_version_on_card():
    """``mt_l2norm`` against its plain version on the card (chip_smoke.py
    runs the full grid): fp32 sums in another order; the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    xs = _card_lists(_CARD_DTYPES, _CARD_SIZES, 0)
    got = mt._kernel_l2norm(xs, None)
    want = mt._plain_l2norm(xs, None)
    torch.testing.assert_close(got.per_tensor, want.per_tensor, rtol=1e-5,
                               atol=0)
    assert torch.equal(mt._kernel_l2norm(xs, None).total, got.total)


@pytest.mark.cuda
def test_scale_kernel_matches_plain_version_on_card():
    """``mt_scale`` bit for bit against its plain version on the card, and
    its flag on an inf, with and without an output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    xs = _card_lists(_CARD_DTYPES, _CARD_SIZES, 0)
    outs = [torch.empty_like(x) for x in xs]
    flag = mt._kernel_scale(xs, outs, 0.3, True)
    for o, x in zip(outs, xs):
        assert torch.equal(o, (x.float() * 0.3).to(x.dtype))
    assert not bool(flag)
    xs[1][3] = float("inf")
    assert bool(mt._kernel_scale(xs, None, 1.0, True))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [mt.ADAM_L2, mt.ADAMW, mt.SWA_APEX_ADAM,
                                  mt.SWA_APEX_ADAMW, mt.SWA_PYTORCH_ADAM])
def test_adam_kernel_matches_plain_version_on_card(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    swa_mode = mode >= mt.SWA_APEX_ADAM
    n = len(_CARD_SIZES)
    g = _card_lists([torch.bfloat16] * n, _CARD_SIZES, 1)
    p = _card_lists([torch.float32] * n, _CARD_SIZES, 2)
    m = [x * 0.01 for x in _card_lists([torch.float32] * n, _CARD_SIZES, 3)]
    v = [x.abs() * 1e-3 for x in _card_lists([torch.float32] * n, _CARD_SIZES, 4)]
    extra = dict(step=torch.tensor(2, dtype=torch.int32, device="cuda"),
                 n_averaged=torch.tensor(1, dtype=torch.int32, device="cuda"),
                 swa_weight=0.1, swa_start_step=0) if swa_mode else {}
    kw = dict(mode=mode, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, inv_scale=torch.tensor(0.5, device="cuda"),
              bc1=torch.tensor(0.19, device="cuda"),
              bc2=torch.tensor(0.002, device="cuda"), noop=None, **extra)
    kw.setdefault("step", None)
    kw.setdefault("n_averaged", None)
    kw.setdefault("swa_weight", 0.0)
    kw.setdefault("swa_start_step", 0)
    runs = []
    for fn in (mt._kernel_adam, mt._plain_adam):
        tensors = [[x.clone() for x in lst] for lst in (p, m, v, p, p)]
        copy = [x.bfloat16() for x in tensors[3]]
        swa = tensors[4] if swa_mode else None
        fn(g, tensors[0], tensors[1], tensors[2], copy, swa, **kw)
        runs.append(tensors[:3] + [copy] + ([swa] if swa_mode else []))
    for got, want in zip(*runs):
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                       atol=1e-6 if a.dtype == torch.float32
                                       else 1e-2)


@pytest.mark.cuda
def test_lamb_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = len(_CARD_SIZES)
    g = _card_lists([torch.bfloat16] * n, _CARD_SIZES, 5)
    p = _card_lists([torch.float32] * n, _CARD_SIZES, 6)
    m = [x * 0.01 for x in _card_lists([torch.float32] * n, _CARD_SIZES, 7)]
    v = [x.abs() * 1e-3 for x in _card_lists([torch.float32] * n, _CARD_SIZES, 8)]
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, adam_w_mode=True, use_ratio=True,
              inv_scale=None, clip=torch.tensor(1.5, device="cuda"),
              bc1=torch.tensor(0.19, device="cuda"),
              bc2=torch.tensor(0.002, device="cuda"), noop=None)
    runs = []
    for fn in (mt._kernel_lamb, mt._plain_lamb):
        tensors = [[x.clone() for x in lst] for lst in (p, m, v)]
        fn(g, *tensors, None, **kw)
        runs.append(tensors)
    for got, want in zip(*runs):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
