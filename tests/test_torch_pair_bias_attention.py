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
