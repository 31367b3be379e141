"""apex_tpu_torch.ops.softmax against apex_tpu.ops.softmax.

The port's plain versions (what a CPU tensor runs) are held against the
JAX package's Pallas ``_fwd_kernel`` and ``_bwd_kernel`` run in interpret
mode (``APEX_TPU_KERNELS=interpret``, as tests/test_softmax.py runs them),
forward and ``jax.vjp`` backward, at shapes the JAX kernel gate takes
(``sk % 128 == 0``, ``sq`` a multiple of ``min(128, sq)``): the kernel is
what the port follows where the JAX package disagrees with itself (a
causal row with no valid key is zeros, not the jnp fallback's uniform
row).  Inputs come from numpy with a fixed seed.  Tolerance: fp32 at
``atol = rtol = 1e-6`` (the same fp32 arithmetic, sums taken in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import softmax as jsm
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JaxFusedScaleMaskSoftmax,
)
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
from apex_tpu_torch.transformer.functional import fused_softmax as tfs

_TOL = dict(atol=1e-6, rtol=1e-6)
_SCALE = 0.125


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")


def _inputs(shape, seed=0, mask="none"):
    """x, dy and a [b, 1, sq, sk] bool mask (None for "none"): "pad" masks
    each batch element's trailing keys; "rows" also masks whole rows."""
    rng = np.random.default_rng(seed)
    b, _, sq, sk = shape
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    m = None
    if mask != "none":
        m = np.zeros((b, 1, sq, sk), bool)
        for i in range(b):
            m[i, :, :, sk - (i + 1) * sk // 8:] = True
        if mask == "rows":
            m[:, :, ::5, :] = True          # fully masked rows
    return x, dy, m


def _jax_fwd_bwd(fn, x, dy, m):
    args = (jnp.asarray(x),) if m is None else (jnp.asarray(x), jnp.asarray(m))
    y, vjp = jax.vjp(lambda a: fn(a, *args[1:]), args[0])
    (dx,) = vjp(jnp.asarray(dy))
    return np.asarray(y), np.asarray(dx)


def _torch_fwd_bwd(fn, x, dy, m):
    xt = torch.from_numpy(x).requires_grad_(True)
    args = () if m is None else (torch.from_numpy(m),)
    y = fn(xt, *args)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy()


_PAIRS = {
    "scaled_softmax": (lambda a: jsm.scaled_softmax(a, _SCALE),
                       lambda a: tsm.scaled_softmax(a, _SCALE), "none"),
    "scaled_masked_softmax": (
        lambda a, m: jsm.scaled_masked_softmax(a, m, _SCALE),
        lambda a, m: tsm.scaled_masked_softmax(a, m, _SCALE), "rows"),
    "scaled_upper_triang_masked_softmax": (
        lambda a: jsm.scaled_upper_triang_masked_softmax(a, _SCALE),
        lambda a: tsm.scaled_upper_triang_masked_softmax(a, _SCALE), "none"),
    "scaled_causal_masked_softmax": (
        lambda a, m: jsm.scaled_causal_masked_softmax(a, m, _SCALE),
        lambda a, m: tsm.scaled_causal_masked_softmax(a, m, _SCALE), "pad"),
    "generic_scaled_masked_softmax": (
        lambda a, m: jsm.generic_scaled_masked_softmax(a, m, _SCALE),
        lambda a, m: tsm.generic_scaled_masked_softmax(a, m, _SCALE), "rows"),
}


@pytest.mark.parametrize("shape", [(2, 2, 128, 128), (1, 2, 64, 256)],
                         ids=["128x128", "64x256"])
@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_public_function_matches_jax(interpret, name, shape):
    jfn, tfn, mask = _PAIRS[name]
    x, dy, m = _inputs(shape, seed=1, mask=mask)
    y_ref, dx_ref = _jax_fwd_bwd(jfn, x, dy, m)
    y, dx = _torch_fwd_bwd(tfn, x, dy, m)
    np.testing.assert_allclose(y, y_ref, **_TOL)
    np.testing.assert_allclose(dx, dx_ref, **_TOL)


@pytest.mark.parametrize("sq,sk", [(128, 256), (256, 128)],
                         ids=["sq<sk", "sq>sk"])
def test_causal_rows_follow_the_pallas_kernel(interpret, sq, sk):
    """Causal alignment to the last query; with sq > sk the first sq - sk
    rows see no key and are zeros, as the Pallas kernel writes them (the
    jnp fallback would give a uniform row)."""
    x, dy, _ = _inputs((1, 2, sq, sk), seed=2)
    y_ref, dx_ref = _jax_fwd_bwd(
        lambda a: jsm.scaled_upper_triang_masked_softmax(a, _SCALE), x, dy,
        None)
    y, dx = _torch_fwd_bwd(
        lambda a: tsm.scaled_upper_triang_masked_softmax(a, _SCALE), x, dy,
        None)
    np.testing.assert_allclose(y, y_ref, **_TOL)
    np.testing.assert_allclose(dx, dx_ref, **_TOL)
    dead = max(0, sq - sk)
    assert (y[:, :, :dead] == 0).all() and (dx[:, :, :dead] == 0).all()
    assert np.allclose(y[:, :, dead:].sum(-1), 1.0, atol=1e-5)
    if dead:
        # the JAX package's jnp fallback disagrees: a uniform row there
        jnp_y = np.asarray(jsm._jnp_softmax(jnp.asarray(x), _SCALE,
                                            causal=True))
        np.testing.assert_allclose(jnp_y[:, :, 0], 1.0 / sk, rtol=1e-6)


def test_fully_masked_rows_are_zero(interpret):
    x, dy, m = _inputs((2, 2, 128, 128), seed=3, mask="rows")
    y, dx = _torch_fwd_bwd(lambda a, mm: tsm.scaled_masked_softmax(a, mm, 1.0),
                           x, dy, m)
    dead = m.all(-1)[:, 0]                              # [b, sq]
    assert dead.any()
    assert (y.transpose(0, 2, 1, 3)[dead.nonzero()] == 0).all()
    assert (dx.transpose(0, 2, 1, 3)[dead.nonzero()] == 0).all()


def test_causal_and_padding_mask_compose(interpret):
    """The combined path masks the union; a row whose unmasked keys all lie
    past the diagonal is zeros."""
    x, dy, m = _inputs((2, 2, 128, 128), seed=4, mask="pad")
    m[:, :, :, :16] = True            # the first rows lose every causal key
    y_ref, dx_ref = _jax_fwd_bwd(
        lambda a, mm: jsm.scaled_causal_masked_softmax(a, mm, _SCALE), x, dy, m)
    y, dx = _torch_fwd_bwd(
        lambda a, mm: tsm.scaled_causal_masked_softmax(a, mm, _SCALE), x, dy, m)
    np.testing.assert_allclose(y, y_ref, **_TOL)
    np.testing.assert_allclose(dx, dx_ref, **_TOL)
    assert (y[:, :, :16] == 0).all()
    tri = np.triu(np.ones((128, 128), bool), 1)
    assert (y[:, :, tri] == 0).all() and (y[np.broadcast_to(m, y.shape)] == 0).all()


def test_mask_broadcasts_like_jax(interpret):
    """A [1, 1, sq, sk] (or [sq, sk]) mask broadcasts over batch and heads."""
    x, dy, m = _inputs((2, 2, 128, 128), seed=5, mask="rows")
    m1 = m[:1]
    for mask in (m1, m1[0, 0]):
        y_ref = np.asarray(jsm.scaled_masked_softmax(jnp.asarray(x),
                                                     jnp.asarray(mask), 0.5))
        y = tsm.scaled_masked_softmax(torch.from_numpy(x),
                                      torch.from_numpy(mask), 0.5)
        np.testing.assert_allclose(y.numpy(), y_ref, **_TOL)


def test_bf16_rounds_once_like_jax(interpret):
    """bf16 in, bf16 out: both sides compute in fp32 and round y once, so
    they agree within one bf16 ulp."""
    x, dy, _ = _inputs((1, 2, 128, 128), seed=6)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_ref = np.asarray(jsm.scaled_upper_triang_masked_softmax(xb, _SCALE)
                       .astype(jnp.float32))
    y = tsm.scaled_upper_triang_masked_softmax(
        torch.from_numpy(x).to(torch.bfloat16), _SCALE)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), y_ref, atol=2 ** -9, rtol=2 ** -7)


def test_gradcheck_fp64():
    torch.manual_seed(0)
    x = torch.randn(1, 2, 5, 7, dtype=torch.float64, requires_grad=True)
    mask = torch.zeros(1, 1, 5, 7, dtype=torch.bool)
    mask[..., 3, :] = True
    mask[..., 0, 5:] = True
    assert torch.autograd.gradcheck(
        lambda a: tsm.scaled_causal_masked_softmax(a, mask, 0.7), (x,))
    assert torch.autograd.gradcheck(lambda a: tsm.scaled_softmax(a, 1.3), (x,))


def test_kernel_wrappers_take_only_cuda_tensors():
    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="lies on cpu"):
        tsm.softmax_fwd(x, 1.0, None, False)
    with pytest.raises(ValueError, match="lies on cpu"):
        tsm.softmax_bwd(x, x, 1.0)
    with pytest.raises(ValueError, match=r"\[b, np, sq, sk\]"):
        tsm.scaled_softmax(torch.zeros(4, 8))


@pytest.mark.parametrize("name,causal", [
    ("scaled_softmax", False), ("scaled_masked_softmax", False),
    ("scaled_upper_triang_masked_softmax", True),
    ("scaled_causal_masked_softmax", True),
    ("generic_scaled_masked_softmax", False)])
def test_backward_kernel_is_told_the_forward_was_causal(monkeypatch, name,
                                                        causal):
    """On the card the backward kernel skips y and dy past the causal edge,
    so the autograd function hands it the forward's ``causal``.  The kernel
    wrappers are stood in for by the plain versions here."""
    seen = []
    monkeypatch.setattr(tsm, "kernel_path", lambda *a: True)
    monkeypatch.setattr(tsm, "softmax_fwd",
                        lambda x, s, m, c: seen.append(("fwd", c))
                        or tsm._plain_forward(x, s, m, c))
    monkeypatch.setattr(tsm, "softmax_bwd",
                        lambda y, dy, s, c: seen.append(("bwd", c))
                        or tsm._plain_backward(y, dy, s))
    unmasked = name in ("scaled_softmax", "scaled_upper_triang_masked_softmax")
    x, dy, m = _inputs((1, 2, 8, 16), seed=10,
                       mask="none" if unmasked else "pad")
    _torch_fwd_bwd(lambda a, *mm: getattr(tsm, name)(a, *mm, _SCALE), x, dy, m)
    assert seen == [("fwd", causal), ("bwd", causal)]


def _routes(module, x, mask, monkeypatch):
    seen = []
    for name in ("scaled_softmax", "scaled_masked_softmax",
                 "scaled_upper_triang_masked_softmax",
                 "scaled_causal_masked_softmax",
                 "generic_scaled_masked_softmax"):
        fn = getattr(tfs, name)
        monkeypatch.setattr(tfs, name,
                            lambda *a, _f=fn, _n=name: seen.append(_n) or _f(*a))
    return module(x, mask), seen


@pytest.mark.parametrize("mask_type,with_mask,fusion,route", [
    (AttnMaskType.causal, False, True, "scaled_upper_triang_masked_softmax"),
    (AttnMaskType.causal, True, True, "scaled_causal_masked_softmax"),
    (AttnMaskType.padding, True, True, "scaled_masked_softmax"),
    (AttnMaskType.padding, True, False, "generic_scaled_masked_softmax"),
    (AttnMaskType.padding, False, True, "scaled_softmax"),
])
def test_fused_scale_mask_softmax_routing(interpret, monkeypatch, mask_type,
                                          with_mask, fusion, route):
    x, _, m = _inputs((2, 2, 128, 128), seed=7,
                      mask="pad" if with_mask else "none")
    jmod = JaxFusedScaleMaskSoftmax(attn_mask_type=JaxMaskType[mask_type.name],
                                    scaled_masked_softmax_fusion=fusion,
                                    scale=_SCALE)
    y_ref = np.asarray(jmod(jnp.asarray(x), None if m is None else jnp.asarray(m)))
    tmod = FusedScaleMaskSoftmax(attn_mask_type=mask_type,
                                 scaled_masked_softmax_fusion=fusion,
                                 scale=_SCALE)
    y, seen = _routes(tmod, torch.from_numpy(x),
                      None if m is None else torch.from_numpy(m), monkeypatch)
    assert seen == [route]
    np.testing.assert_allclose(y.numpy(), y_ref, **_TOL)


def test_kernel_gate_is_the_ports_own():
    mod = FusedScaleMaskSoftmax(scale=1.0)
    # the TPU gate refuses sk = 100 (not a multiple of 128); the card's
    # kernel takes any sk up to its maximum
    assert mod.is_kernel_available(None, 2, 2, 7, 100)
    assert mod.is_kernel_available(None, 2, 2, 7, tsm.MAX_SK)
    assert not mod.is_kernel_available(None, 2, 2, 7, tsm.MAX_SK + 1)
    assert not FusedScaleMaskSoftmax(scaled_masked_softmax_fusion=False
                                     ).is_kernel_available(None, 1, 1, 8, 128)
    with pytest.raises(RuntimeError):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)


def test_forward_torch_softmax_matches_jax():
    x, _, m = _inputs((1, 2, 8, 16), seed=8, mask="pad")
    mask_func = lambda s, mm: s.masked_fill(mm, -10000.0)  # noqa: E731
    jmask_func = lambda s, mm: jnp.where(mm, -10000.0, s)  # noqa: E731
    jmod = JaxFusedScaleMaskSoftmax(input_in_bf16=True, mask_func=jmask_func,
                                    scale=0.5)
    tmod = FusedScaleMaskSoftmax(input_in_bf16=True, mask_func=mask_func,
                                 scale=0.5)
    y_ref = np.asarray(jmod.forward_torch_softmax(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(m)).astype(jnp.float32))
    y = tmod.forward_torch_softmax(torch.from_numpy(x).to(torch.bfloat16),
                                   torch.from_numpy(m))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), y_ref, atol=2 ** -9, rtol=2 ** -7)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """The CUDA forward and backward against their plain versions, on the
    card (chip_smoke.py runs the full grid); skipped on a host without
    one.  fp32: y within 2^-16 |ref| (fast exp, sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, dy, m = _inputs((2, 2, 100, 260), seed=9, mask="rows")
    tx, tdy, tm = (torch.from_numpy(a).cuda() for a in (x, dy, m))
    launches = (tsm.SCALED_SOFTMAX_FWD.launches, tsm.SCALED_SOFTMAX_BWD.launches)
    with torch.no_grad():
        y = tsm.softmax_fwd(tx, _SCALE, tm, True)
        ry = tsm._plain_forward(tx, _SCALE, tm, True)
        dx = tsm.softmax_bwd(y, tdy, _SCALE, True)
        rdx = tsm._plain_backward(y, tdy, _SCALE)
    torch.testing.assert_close(y, ry, atol=1e-7, rtol=2 ** -16)
    torch.testing.assert_close(dx, rdx, atol=1e-6, rtol=1e-5)
    assert (tsm.SCALED_SOFTMAX_FWD.launches, tsm.SCALED_SOFTMAX_BWD.launches) \
        == (launches[0] + 1, launches[1] + 1)
    with pytest.raises(ValueError, match="maximum"):
        tsm.softmax_fwd(torch.zeros(1, 1, 1, tsm.MAX_SK + 1, device="cuda"),
                        1.0, None, False)
