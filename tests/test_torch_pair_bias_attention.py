"""apex_tpu_torch.ops.pair_bias_attention against
apex_tpu.ops.pair_bias_attention.

The same numpy inputs (fixed seeds) go through the JAX
``pair_bias_flash_attention``, whose Pallas forward and dq, dk/dv and
dbias kernels run in interpret mode (``APEX_TPU_KERNELS=interpret``, s =
128, d a multiple of 8, ``block_q = block_k = 64`` so the grid has several
blocks), and through the port's plain version on the CPU.  ``lse`` comes
from the JAX ``_pallas_fwd`` and the port's
``pair_bias_flash_attention_fwd``; the gradients from ``jax.vjp`` and
autograd.  Tolerances, fp32, the JAX test's own figures: o and lse at
``atol = rtol = 2e-5``, dq, dk, dv and dbias at ``2e-4`` (the two sides
sum in another order, dbias over 3 rows of up to 128 keys).  Where the JAX
function takes its jnp reference instead (s not a multiple of 128), the
port's plain version is held against ``pair_bias_reference`` at the same
figures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import pair_bias_attention as jpb
from apex_tpu_torch.ops import pair_bias_attention as tpb

BLOCK = 64

# name: (b, r, h, s, d, mask, scale)
CASES = {
    "b1": (1, 3, 2, 128, 32, False, None),
    "b1_mask": (1, 3, 2, 128, 32, True, None),
    "b2": (2, 3, 2, 128, 32, False, None),
    "b2_mask": (2, 3, 2, 128, 32, True, None),
    "b2_mask_scale": (2, 3, 2, 128, 32, True, 0.7),
    "b2_mask_d8": (2, 3, 2, 128, 8, True, None),
}


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    yield


def _inputs(b, r, h, s, d, with_mask, seed=0):
    """q, k, v ``[r*b, h, s, d]``, bias ``[b, h, s, s]`` (all 0.5 N(0, 1),
    as the JAX test), a kv mask with one fully masked row (R index 1), and
    an upstream gradient."""
    rng = np.random.default_rng(seed)
    R = r * b
    q, k, v = (rng.standard_normal((R, h, s, d)).astype(np.float32) * 0.5
               for _ in range(3))
    bias = rng.standard_normal((b, h, s, s)).astype(np.float32) * 0.5
    mask = None
    if with_mask:
        mask = rng.random((R, s)) > 0.2
        mask[1, :] = False
    do = rng.standard_normal((R, h, s, d)).astype(np.float32)
    return q, k, v, bias, mask, do


def _jax_fn(mask, scale, kernel=True):
    jm = None if mask is None else jnp.asarray(mask)
    if kernel:
        return lambda q, k, v, b: jpb.pair_bias_flash_attention(
            q, k, v, b, jm, scale=scale, block_q=BLOCK, block_k=BLOCK)
    return lambda q, k, v, b: jpb.pair_bias_reference(q, k, v, b, jm,
                                                      scale=scale)


def _jax_grads(q, k, v, bias, mask, do, scale, kernel=True):
    out, vjp = jax.vjp(_jax_fn(mask, scale, kernel),
                       *(jnp.asarray(a) for a in (q, k, v, bias)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_grads(q, k, v, bias, mask, do, scale):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    tm = None if mask is None else torch.from_numpy(mask)
    out = tpb.pair_bias_flash_attention(*ts, tm, scale=scale)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    b, r, h, s, d, with_mask, scale = CASES[case]
    q, k, v, bias, mask, _ = _inputs(b, r, h, s, d, with_mask)
    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, bias))
    jm = None if mask is None else jnp.asarray(mask)
    ref_o = np.asarray(_jax_fn(mask, scale)(jq, jk, jv, jb))
    _, ref_lse = jpb._pallas_fwd(jq, jk, jv, jb, jm,
                                 1.0 if scale is None else scale, BLOCK, BLOCK)
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = tpb.pair_bias_flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), tm, scale=scale)
    assert o.dtype == torch.float32 and tuple(o.shape) == ref_o.shape
    np.testing.assert_allclose(o.numpy(), ref_o, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5,
                               rtol=2e-5)
    if with_mask:
        # the fully masked row: zeros and lse = +inf on both sides
        np.testing.assert_array_equal(o.numpy()[1], 0.0)
        assert (lse.numpy()[1] == np.inf).all()
        assert (np.asarray(ref_lse)[1] == np.inf).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_grad(case):
    """dq, dk, dv and dbias of the port's plain backward (through
    ``_PairBiasFunction`` on the CPU) against ``jax.vjp`` of the JAX
    function (its Pallas dq, dk/dv and dbias kernels); dbias sums over the
    r = 3 rows of each batch element, b = 1 and 2."""
    b, r, h, s, d, with_mask, scale = CASES[case]
    q, k, v, bias, mask, do = _inputs(b, r, h, s, d, with_mask, seed=1)
    ref_o, ref = _jax_grads(q, k, v, bias, mask, do, scale)
    out, ours = _torch_grads(q, k, v, bias, mask, do, scale)
    np.testing.assert_allclose(out, ref_o, atol=2e-5, rtol=2e-5)
    for name, o, r_ in zip(("dq", "dk", "dv", "dbias"), ours, ref):
        assert o.shape == r_.shape, name
        np.testing.assert_allclose(o, r_, atol=2e-4, rtol=2e-4, err_msg=name)
    if with_mask:
        for g in ours[:3]:
            np.testing.assert_array_equal(g[1], 0.0)


@pytest.mark.parametrize("s,d", [(100, 32), (200, 8), (128, 12)])
def test_plain_version_off_the_tpu_gate_matches_reference(s, d):
    """At s not a multiple of 128 (and d not a multiple of 8) the JAX
    function computes its jnp ``pair_bias_reference``; the port's plain
    version (the CUDA kernels' yardstick at those shapes) matches it and
    its ``jax.vjp``."""
    q, k, v, bias, mask, do = _inputs(2, 2, 2, s, d, True, seed=2)
    ref_o, ref = _jax_grads(q, k, v, bias, mask, do, 0.5, kernel=False)
    out, ours = _torch_grads(q, k, v, bias, mask, do, 0.5)
    # the reference's fully masked row is zeros too
    np.testing.assert_array_equal(ref_o[1], 0.0)
    np.testing.assert_allclose(out, ref_o, atol=2e-5, rtol=2e-5)
    for name, o, r_ in zip(("dq", "dk", "dv", "dbias"), ours, ref):
        np.testing.assert_allclose(o, r_, atol=2e-4, rtol=2e-4, err_msg=name)


def test_reference_is_the_plain_forward():
    q, k, v, bias, mask, _ = _inputs(2, 3, 2, 64, 16, True, seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    tm = torch.from_numpy(mask)
    ref = tpb.pair_bias_reference(*t, tm, scale=0.3)
    o, _ = tpb.pair_bias_flash_attention_fwd(*t, tm, scale=0.3)
    np.testing.assert_array_equal(ref.numpy(), o.numpy())
    jref = jpb.pair_bias_reference(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                   jnp.asarray(mask), scale=0.3)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=2e-5,
                               rtol=2e-5)


def test_bias_tiles_over_rows_major_R():
    """R index t * b + bi reads bias[bi]: with b = 2 and r = 3, a bias
    that is zero for batch element 0 and large for 1 changes only the odd
    R rows."""
    q, k, v, bias, _, _ = _inputs(2, 3, 1, 16, 8, False, seed=4)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    zero = torch.zeros(2, 1, 16, 16)
    bumped = zero.clone()
    bumped[1] = torch.from_numpy(bias[1]) * 10
    a = tpb.pair_bias_flash_attention(*t, zero)
    b_ = tpb.pair_bias_flash_attention(*t, bumped)
    changed = (a - b_).abs().amax(dim=(1, 2, 3)) > 1e-3
    assert changed.tolist() == [False, True, False, True, False, True]


def test_pair_bias_function_gradcheck():
    """``_PairBiasFunction`` in float64 against finite differences, b = 2,
    r = 2, with a fully masked row (whose lse is +inf) and scale != 1;
    only the plain version takes float64."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 2, 6, 4)))
               .requires_grad_() for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((2, 2, 6, 6))).requires_grad_()
    mask = torch.from_numpy(rng.random((4, 6)) > 0.3)
    mask[2] = False
    mask[0, 0] = True
    fn = lambda q, k, v, b: tpb.pair_bias_flash_attention(q, k, v, b, mask,
                                                          scale=0.8)
    assert torch.autograd.gradcheck(fn, (q, k, v, bias))


def test_shape_checks():
    q = torch.zeros(6, 2, 8, 8)
    with pytest.raises(ValueError, match="b dividing R"):
        tpb.pair_bias_flash_attention(q, q, q, torch.zeros(4, 2, 8, 8))
    with pytest.raises(ValueError, match="mask"):
        tpb.pair_bias_flash_attention(q, q, q, torch.zeros(2, 2, 8, 8),
                                      torch.ones(6, 7, dtype=torch.bool))


def test_no_graph_without_grad():
    q, k, v, bias, _, _ = _inputs(1, 2, 1, 8, 8, False, seed=6)
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    assert tpb.pair_bias_flash_attention(*t).grad_fn is None
    t[3].requires_grad_()
    assert tpb.pair_bias_flash_attention(*t).grad_fn is not None
    with torch.no_grad():
        assert tpb.pair_bias_flash_attention(*t).grad_fn is None


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, bias, _, _ = _inputs(1, 2, 1, 8, 8, False, seed=7)
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    with pytest.raises(ValueError, match="CUDA"):
        tpb._Launch(*t, None, 1.0)


@pytest.mark.cuda
def test_kernels_match_plain_version_on_card():
    """The four CUDA kernels against the plain versions on the card, fp32,
    b = 2, r = 3, a fully masked row, s off the tile and d = 8 (chip_smoke.py
    runs the full grid); dbias the same bits on two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, bias, mask, do = (None if a is None else torch.from_numpy(a).cuda()
                               for a in _inputs(2, 3, 2, 100, 8, True, seed=8))
    with torch.no_grad():
        o, lse = tpb.pair_bias_flash_attention_fwd(q, k, v, bias, mask, 0.7)
        ro, rlse = tpb._plain_forward(q, k, v, bias, mask, 0.7)
        grads = tpb.pair_bias_flash_attention_bwd(q, k, v, bias, o, lse, do,
                                                  mask, 0.7)
        again = tpb.pair_bias_flash_attention_bwd(q, k, v, bias, o, lse, do,
                                                  mask, 0.7)
        ref = tpb._plain_backward(q, k, v, bias, mask, o, lse, do, 0.7)
    torch.testing.assert_close(o, ro, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=2e-5)
    for a, r_ in zip(grads, ref):
        torch.testing.assert_close(a, r_, atol=2e-4, rtol=2e-4)
    assert torch.equal(grads[3], again[3])


# ---------------------------------------------------------------------------
# the 16-bit forward's TMA maps (worked out on the host, so held here)
# ---------------------------------------------------------------------------


def test_tma_geometry_of_openfold_strided_layout():
    """OpenFold's q, k, v are ``[R, s, h, d]`` viewed as ``[R, h, s, d]``:
    the map steps rows by ``h d``, heads by ``d`` and R by ``s h d``
    elements, in bytes; boxes of 32 columns (64 bytes, the 64-byte
    swizzle) by 64 rows at d 32."""
    R, s, h, d = 128, 1024, 8, 32
    q = torch.zeros(R, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
    assert tpb._tma_geometry(tuple(q.shape), q.stride(), q.dtype) == (
        d, s, h, R, 2 * h * d, 2 * d, 2 * s * h * d, 32, 64, 1, 1, 64)


@pytest.mark.parametrize("d,cols,span", [(8, 32, 64), (24, 32, 64), (32, 32, 64),
                                         (40, 64, 128), (64, 64, 128),
                                         (72, 64, 128), (128, 64, 128)])
def test_tma_geometry_of_contiguous_layout(d, cols, span):
    """A contiguous ``[R, h, s, d]``: dims (d, s, h, R), packed byte
    strides; the box is as wide as the padded head dim's swizzle span (32
    columns up to d 32, else 64), its columns past d read as zeros."""
    R, h, s = 6, 2, 100
    q = torch.zeros(R, h, s, d, dtype=torch.float16)
    assert tpb._tma_geometry(tuple(q.shape), q.stride(), q.dtype) == (
        d, s, h, R, 2 * d, 2 * s * d, 2 * h * s * d, cols, 64, 1, 1, span)


def test_tma_geometry_takes_the_packed_stride_of_a_unit_axis():
    """An axis of extent 1 steps over nothing: its stride may be anything
    (here 0) and the map takes the packed one."""
    g = tpb._tma_geometry((1, 2, 64, 16), (0, 1024, 16, 1), torch.bfloat16)
    assert g[4:7] == (32, 2048, 4096)


@pytest.mark.parametrize("strides,axis", [((2048, 1024, 12, 1), "row"),
                                          ((2048, 4, 16, 1), "head"),
                                          ((0, 1024, 16, 1), "R")])
def test_tma_geometry_raises_on_a_stride_off_16_bytes(strides, axis):
    """TMA steps in whole 16-byte chunks: a stride that is not a positive
    multiple of 16 bytes (or a broadcast's 0) raises, naming it."""
    with pytest.raises(ValueError, match=f"the {axis} stride is"):
        tpb._tma_geometry((2, 2, 128, 8), strides, torch.bfloat16)


def test_tma_geometry_refuses_fp32_and_wide_heads():
    with pytest.raises(TypeError, match="bf16 and fp16"):
        tpb._tma_geometry((2, 2, 64, 32), (4096, 2048, 32, 1), torch.float32)
    with pytest.raises(ValueError, match="head dim 136"):
        tpb._tma_geometry((2, 2, 64, 136), (17408, 8704, 136, 1), torch.bfloat16)


@pytest.mark.parametrize("s,dtype,staged", [(1024, torch.bfloat16, True),
                                            (128, torch.float16, True),
                                            (1000, torch.float32, True),
                                            (100, torch.bfloat16, False),
                                            (1001, torch.float32, False),
                                            (1001, torch.bfloat16, False),
                                            (100, torch.float32, True)])
def test_unstaged_bias_rows_take_the_lane_read_path(s, dtype, staged):
    """A bias row of whole 16-byte chunks rides in the ring by TMA (its map:
    dims (s, s, h, b), boxes of 64 rows by 128 bytes); any other row is
    read by each lane from device memory: the maps carry zeros in its place
    and no map of it can be made."""
    assert tpb._bias_staged(s, dtype) is staged
    part = ((6, 2, s, 32), (2 * s * 32, s * 32, 32, 1))
    maps = list(tpb._tma_maps(torch.bfloat16, (part,) * 3, (3, 2, s, s), dtype))
    assert len(maps) == 60 and maps[:36] == list(
        tpb._tma_geometry(*part, torch.bfloat16)) * 3
    assert tuple(maps[48:]) == tpb._mask_geometry(6, s)
    if staged:
        es = dtype.itemsize
        assert tuple(maps[36:48]) == (s, s, 2, 3, s * es, s * s * es,
                                      2 * s * s * es, 128 // es, 64, 1, 1, 128)
    else:
        assert maps[36:48] == [0] * 12
        with pytest.raises(ValueError, match="16-byte chunks"):
            tpb._bias_geometry((3, 2, s, s), dtype)


@pytest.mark.parametrize("s,row", [(1024, 1024), (100, 112), (1001, 1008),
                                   (16, 16), (1, 16)])
def test_mask_geometry_steps_rows_of_whole_16_bytes(s, row):
    """The mask bytes' map: dims (s, R, 1, 1), rows ``s`` rounded up to 16
    bytes (TMA's stride unit), boxes of one row of 64 bytes, no swizzle."""
    assert tpb._mask_row_bytes(s) == row
    assert tpb._mask_geometry(6, s) == (s, 6, 1, 1, row, 6 * row, 6 * row,
                                        64, 1, 1, 1, 0)


@pytest.mark.parametrize("s", [1024, 100, 1001])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "none"])
def test_mask_bytes_are_the_mask_in_whole_16_byte_rows(s, with_mask):
    """The forward's mask bytes: the mask itself where its rows are whole
    16-byte chunks, a zero-padded copy where not (the padding reads as
    masked, as keys past s), all ones where there is no mask."""
    R = 3
    mask = None
    if with_mask:
        mask = (torch.rand(R, s, generator=torch.Generator().manual_seed(s))
                > 0.2).view(torch.uint8)
    got = tpb._mask_bytes(mask, R, s, torch.device("cpu"))
    row = tpb._mask_row_bytes(s)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (R, row)
    assert got.is_contiguous()
    if mask is not None and row == s and mask.data_ptr() % 16 == 0:
        assert got is mask
    want = torch.ones(R, s, dtype=torch.uint8) if mask is None else mask
    assert torch.equal(got[:, :s], want)
    assert not got[:, s:].any()


def test_tma_readable_copies_only_a_broadcast():
    """The 16-bit forward copies an operand with a zero stride over more
    than one element (TMA steps over none); a strided view, or a zero
    stride on an axis of extent 1, goes through as it is."""
    view = torch.zeros(4, 64, 2, 16, dtype=torch.bfloat16).transpose(1, 2)
    assert tpb._tma_readable(view) is view
    unit = torch.zeros(1, 2, 64, 16, dtype=torch.bfloat16).expand(1, 2, 64, 16)
    assert tpb._tma_readable(unit) is unit
    one = torch.zeros(4, 1, 64, 16, dtype=torch.bfloat16).as_strided(
        (4, 1, 64, 16), (1024, 0, 16, 1))
    assert tpb._tma_readable(one) is one
    wide = torch.randn(4, 1, 64, 16).to(torch.bfloat16).expand(4, 2, 64, 16)
    got = tpb._tma_readable(wide)
    assert got.is_contiguous() and torch.equal(got, wide)
    assert tpb._tma_geometry(tuple(got.shape), got.stride(), got.dtype)[4:7] == (
        32, 2048, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("s,d,bias_dtype", [(100, 8, None), (128, 24, None),
                                            (200, 64, None),
                                            (1000, 128, "float32")])
def test_16bit_forward_matches_plain_version_on_card(dtype, s, d, bias_dtype):
    """The TMA + wgmma forward in 16 bits against the plain version on the
    card, in OpenFold's strided layout: d 8 and 24 (TMA's boxes read zeros
    past d), s 100 (bias rows read by each lane) and 128, 200 (staged, a
    ragged tile), d 128 with an fp32 bias (the largest ring), a fully
    masked row.  o_ij within eps/2 sum_j p_ij |v_j| + floor s max|v| + 2
    ulp(ref), chip_smoke.py's bound (p and v round to the 16-bit dtype
    before p v: eps/2 half the dtype's epsilon, floor half its least
    subnormal spacing, fp32's least normal for bf16); lse within 1e-5 +
    1e-5 |ref|, +inf on the masked row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, bias, mask, _ = _inputs(2, 3, 2, s, d, True, seed=9)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(dt).cuda().transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in (q, k, v))
    tb = torch.from_numpy(bias).to(getattr(torch, bias_dtype or dtype)).cuda()
    tm = torch.from_numpy(mask).cuda()
    with torch.no_grad():
        o, lse = tpb.pair_bias_flash_attention_fwd(tq, tk, tv, tb, tm, 0.7)
        ro, rlse = tpb._plain_forward(tq, tk, tv, tb, tm, 0.7)
        pv_abs, _ = tpb._plain_forward(tq.float(), tk.float(), tv.float().abs(),
                                       tb.float(), tm, 0.7)
    fi = torch.finfo(dt)
    half_eps = fi.eps / 2
    floor = max(fi.tiny * half_eps, torch.finfo(torch.float32).tiny)
    ref = ro.float()
    mantissa = int(round(-np.log2(fi.eps)))
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(fi.tiny))) - mantissa)
    tol = half_eps * pv_abs + floor * s * float(tv.float().abs().max()) + 2 * ulp
    assert bool(((o.float() - ref).abs() <= tol).all())
    assert torch.equal(torch.isinf(lse), torch.isinf(rlse))
    assert bool(torch.isinf(lse[1]).all()) and bool((o[1] == 0).all())
    fin = ~torch.isinf(rlse)
    torch.testing.assert_close(lse[fin], rlse[fin], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the 16-bit backward's maps and operands (worked out on the host)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["openfold", "contiguous"])
def test_backward_maps_add_do_to_the_forward_maps(layout):
    """The backward's 72 map values: q, k, v and do through maps of their
    own strides (do's from do, which may be laid out unlike q), then the
    bias and the mask bytes, as the forward's 60 lay them out."""
    R, h, s, d = 6, 2, 1024, 32
    if layout == "openfold":
        q = torch.zeros(R, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
    else:
        q = torch.zeros(R, h, s, d, dtype=torch.bfloat16)
    do = torch.zeros(R, h, s, d, dtype=torch.bfloat16)
    part = lambda t: (tuple(t.shape), t.stride())
    fwd = list(tpb._tma_maps(torch.bfloat16, (part(q),) * 3, (3, h, s, s),
                             torch.bfloat16))
    bwd = list(tpb._tma_maps(torch.bfloat16, (part(q),) * 3 + (part(do),),
                             (3, h, s, s), torch.bfloat16))
    assert len(fwd) == 60 and len(bwd) == 72
    assert bwd[:36] == fwd[:36] and bwd[48:] == fwd[36:]
    assert tuple(bwd[36:48]) == (d, s, h, R, 2 * d, 2 * s * d, 2 * h * s * d,
                                 32, 64, 1, 1, 64)
    if layout == "openfold":
        assert tuple(bwd[:12]) == (d, s, h, R, 2 * h * d, 2 * d, 2 * s * h * d,
                                   32, 64, 1, 1, 64)


def test_map_ready_copies_do_and_o_only_where_no_map_steps_over_them():
    """The backward reads do (any strides, as autograd hands it over) and o
    through maps and 16-byte row loads: a view a map can step over goes
    through as it is (contiguous, OpenFold's strided view, a zero stride on
    an axis of extent 1); rows off 16 bytes, a broadcast, a last stride
    other than 1 and a start off 16 bytes take a contiguous copy."""
    base = torch.randn(4, 2, 64, 16).to(torch.bfloat16)
    as_is = {
        "contiguous": base,
        "openfold": torch.randn(4, 64, 2, 16).to(torch.bfloat16).transpose(1, 2),
        "unit_axis_zero_stride": torch.randn(1, 2, 64, 16).to(torch.bfloat16)
        .as_strided((1, 2, 64, 16), (0, 1024, 16, 1)),
        "fp32_rows_of_16_bytes": torch.randn(4, 2, 64, 8)[..., :4],
    }
    copied = {
        "rows_off_16_bytes": torch.randn(4, 2, 64, 20).to(torch.bfloat16)[..., :16],
        "broadcast_heads": base[:, :1].expand(4, 2, 64, 16),
        "last_stride_not_1": torch.randn(4, 2, 16, 64).to(torch.bfloat16)
        .transpose(-1, -2),
        "start_off_16_bytes": torch.randn(4 * 2 * 64 * 16 + 1).to(torch.bfloat16)[1:]
        .view(4, 2, 64, 16),
    }
    for name, t in as_is.items():
        assert tpb._map_ready(t) is t, name
    for name, t in copied.items():
        got = tpb._map_ready(t)
        assert got is not t and got.is_contiguous(), name
        assert got.data_ptr() % 16 == 0 and torch.equal(got, t), name
        assert tpb._map_ready(got) is got, name


def _swizzled_box(rows, row_bytes=128):
    """A [64 rows x 128 bytes] box as TMA's 128-byte swizzle lays it out in
    shared memory: the 16-byte chunk c of row r at chunk c ^ (r % 8)."""
    out = np.zeros(64 * 128, np.uint8)
    for r in range(64):
        for c in range(8):
            dst = r * 128 + ((c ^ (r % 8)) << 4)
            out[dst:dst + 16] = rows[r, 16 * c:16 * c + 16]
    return out


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32], ids=["16bit", "fp32"])
def test_transposed_bias_reads_of_the_dkv_kernel(dtype):
    """The dk/dv kernel's bias tile arrives as the forward's boxes, [64
    queries x 128 bytes of keys], 128-byte swizzled, while its accumulator
    rows are keys: each lane reads its entries transposed
    (``bias_words_smem_t`` in ``csrc/pair_bias_attention_bwd.cu``, whose
    addressing this mirrors).  Lane (g, tig) of warp w needs bias[query 8 n
    + 2 tig + e][key 16 w + g + 8 half] at word 4 n + 2 half (+ e in fp32;
    16 bits: e = 0 low, e = 1 high).  16 bits: ldmatrix.x4.trans, lane L
    giving the row address of 8 x 8 matrix L / 8's row L % 8; each 8-lane
    phase must touch 8 distinct 16-byte bank groups.  fp32: one 32-bit load
    a value, the warp's 32 lanes on 32 banks or one word."""
    rng = np.random.default_rng(3)
    per_box = 128 // np.dtype(dtype).itemsize          # keys a box
    boxes = 64 // per_box                               # a warpgroup's 64 keys
    bias = rng.integers(0, 2 ** 16, (64, 64)).astype(dtype)   # [query, key]
    smem = np.concatenate([_swizzled_box(
        bias[:, b * per_box:(b + 1) * per_box].copy().view(np.uint8).reshape(64, 128))
        for b in range(boxes)])

    def word(addr):
        return int(smem[addr:addr + 4].view(np.uint32)[0])

    for warp in range(4):
        got = np.zeros((32, 32), np.uint64)
        if dtype == np.uint16:
            for m in range(4):
                addrs = []
                for lane in range(32):
                    mi, rr = lane >> 3, lane & 7
                    n, half = 2 * m + (mi >> 1), mi & 1
                    addrs.append((8 * n + rr) * 128 + (((2 * warp + half) ^ rr) << 4))
                for ph in range(4):
                    groups = {(a // 16) % 8 for a in addrs[8 * ph:8 * ph + 8]}
                    assert len(groups) == 8, (warp, m, ph)
                for lane in range(32):
                    g, tig = lane >> 2, lane & 3
                    for j in range(4):
                        lo = smem[addrs[8 * j + 2 * tig] + 2 * g:][:2].view(np.uint16)[0]
                        hi = smem[addrs[8 * j + 2 * tig + 1] + 2 * g:][:2].view(np.uint16)[0]
                        got[lane, 4 * (2 * m + (j >> 1)) + 2 * (j & 1)] = \
                            int(lo) | int(hi) << 16
        else:
            for n in range(8):
                for half in range(2):
                    for e in range(2):
                        addrs = []
                        for lane in range(32):
                            g, tig = lane >> 2, lane & 3
                            chunk = (warp & 1) * 4 + 2 * half + (g >> 2)
                            row = 8 * n + 2 * tig + e
                            addrs.append((warp >> 1) * 64 * 128 + row * 128
                                         + ((chunk ^ (row & 7)) << 4) + 4 * (g & 3))
                            got[lane, 4 * n + 2 * half + e] = word(addrs[-1])
                        banks = {}
                        for a in addrs:
                            banks.setdefault((a // 4) % 32, set()).add(a)
                        assert all(len(v) == 1 for v in banks.values()), (warp, n, half, e)
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            for n in range(8):
                for half in range(2):
                    key = 16 * warp + g + 8 * half
                    q0 = 8 * n + 2 * tig
                    if dtype == np.uint16:
                        want = int(bias[q0, key]) | int(bias[q0 + 1, key]) << 16
                        assert got[lane, 4 * n + 2 * half] == want
                    else:
                        assert got[lane, 4 * n + 2 * half] == bias[q0, key]
                        assert got[lane, 4 * n + 2 * half + 1] == bias[q0 + 1, key]
