"""apex_tpu_torch.ops.layer_norm against apex_tpu.ops.layer_norm.

The port's plain forward (what a CPU tensor runs) is held against the JAX
package's Pallas ``_fwd_kernel`` run in interpret mode
(``APEX_TPU_KERNELS=interpret``, as tests/test_layer_norm.py runs it), and
against its jnp path where the Pallas kernel does not take the shape
(``h = 200``, not a multiple of 128).  Inputs come from numpy with a fixed
seed.  Tolerances: fp32 outputs and all fp32 statistics at
``atol = rtol = 1e-5``; a bf16 ``y`` within one bf16 ulp or 1e-5, the
larger, compared in fp32 (the two sides may round the same fp32 value to
neighbouring bf16 values when it lies near a rounding boundary).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu.normalization import FusedRMSNorm as JaxFusedRMSNorm
from apex_tpu.normalization import MixedFusedLayerNorm as JaxMixedFusedLayerNorm
from apex_tpu.normalization import MixedFusedRMSNorm as JaxMixedFusedRMSNorm
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.normalization import (FusedLayerNorm, FusedRMSNorm,
                                          MixedFusedLayerNorm, MixedFusedRMSNorm)
from apex_tpu_torch.ops import _build, _dispatch
from apex_tpu_torch.ops import layer_norm as tln

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(_TORCH[dtype])


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def assert_ulp_close(actual, expected, dtype: str):
    """fp32: atol = rtol = 1e-5.  bf16: within one bf16 ulp of the larger
    magnitude (7 explicit mantissa bits) or 1e-5, the larger: near zero,
    LayerNorm's ``x - mean`` cancels, and the two sides' fp32 means
    (summed in another order) differ by ~1e-7, many ulps of a tiny y."""
    a, e = _np32(actual), _np32(expected)
    if dtype == "float32":
        np.testing.assert_allclose(a, e, atol=1e-5, rtol=1e-5)
        return
    mag = np.maximum(np.maximum(np.abs(a), np.abs(e)),
                     np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(a - e) > np.maximum(ulp, 1e-5)
    assert not bad.any(), (
        f"{bad.sum()} of {bad.size} values differ by more than one bf16 "
        f"ulp; worst {np.abs(a - e)[bad].max()}")


def _inputs(n, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32) * 2.0 + 0.5
    w = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, w, b


def _both(x, w, b, *, rms, xdt, wdt, eps=1e-5):
    """(port (y, mean, rstd), JAX (y, mean, rstd)) on the same inputs."""
    tx = _to_torch(x, xdt)
    tw = None if w is None else _to_torch(w, wdt)
    tb = None if b is None else _to_torch(b, wdt)
    ours = tln._norm_forward(tx, tw, tb, eps, rms)
    jx = jnp.asarray(x, _JNP[xdt])
    jw = None if w is None else jnp.asarray(w, _JNP[wdt])
    jb = None if b is None else jnp.asarray(b, _JNP[wdt])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        y, (_, mean, rstd, _, _) = jln._norm_fwd(jx, jw, jb, eps, rms, False)
        ref = (y, mean, rstd)
    return ours, ref


def _check(ours, ref, xdt):
    assert ours[0].dtype == _TORCH[xdt]
    assert ours[0].shape == tuple(ref[0].shape)
    assert_ulp_close(ours[0], ref[0], xdt)
    np.testing.assert_allclose(_np32(ours[1]), _np32(ref[1]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np32(ours[2]), _np32(ref[2]),
                               atol=1e-5, rtol=1e-5)


# (weight?, bias?, weight dtype): no weight, then weight and weight+bias
# in each weight dtype
_AFFINE = [pytest.param(False, False, "float32", id="plain")] + [
    pytest.param(True, bias, wdt, id=f"{'w+b' if bias else 'w'}-{wdt}")
    for bias in (False, True) for wdt in ("float32", "bfloat16")]


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("has_w,has_b,wdt", _AFFINE)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_kernel(rms, has_w, has_b, wdt, xdt):
    """The full dtype/variant grid at a lane-aligned h and a ragged 3-row
    n (the Pallas kernel pads rows to its 128-row block)."""
    x, w, b = _inputs(3, 128)
    ours, ref = _both(x, w if has_w else None, b if has_b else None,
                      rms=rms, xdt=xdt, wdt=wdt)
    _check(ours, ref, xdt)


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", [(16, 256), (3, 200), (16, 200)])
def test_plain_forward_other_shapes(rms, xdt, n, h):
    """h = 256 through the Pallas kernel; the unaligned h = 200 against
    the JAX package's jnp path (its kernel takes only h % 128 == 0)."""
    x, w, b = _inputs(n, h, seed=1)
    ours, ref = _both(x, w, b, rms=rms, xdt=xdt, wdt="float32")
    _check(ours, ref, xdt)


@pytest.mark.parametrize("name", ["fused_layer_norm", "fused_layer_norm_affine",
                                  "fused_rms_norm", "fused_rms_norm_affine"])
def test_public_functions(name):
    """The functional forms keep their names and arguments, on a
    [b, s, h] input normalized over its last dim."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    args = {"fused_layer_norm": (), "fused_layer_norm_affine": (w, b),
            "fused_rms_norm": (), "fused_rms_norm_affine": (w,)}[name]
    ours = getattr(tln, name)(torch.from_numpy(x),
                              *(torch.from_numpy(a) for a in args), (128,))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        ref = getattr(jln, name)(jnp.asarray(x),
                                 *(jnp.asarray(a) for a in args), (128,))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_check_shape_rejects_wrong_trailing_shape():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="normalized_shape"):
        tln.fused_rms_norm(x, (4,))
    with pytest.raises(ValueError, match="normalized_shape"):
        jln.fused_rms_norm(jnp.zeros((2, 4, 8)), (4,))
    tln._check_shape(x, (4, 8))          # a two-dim normalized shape is fine


def test_modules_match_flax_modules():
    """FusedLayerNorm / FusedRMSNorm with the flax modules' parameters
    (named ``scale`` and ``bias`` in both)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 128)).astype(np.float32)
    for jmod, tmod in ((JaxFusedLayerNorm((128,)), FusedLayerNorm(
            128, device="cpu")), (JaxFusedRMSNorm((128,)), FusedRMSNorm(
            128, device="cpu"))):
        params = {"scale": (1 + 0.1 * rng.standard_normal(128)).astype(
            np.float32)}
        if hasattr(tmod, "bias"):
            params["bias"] = (0.1 * rng.standard_normal(128)).astype(
                np.float32)
        assert set(dict(tmod.named_parameters())) == set(params)
        tmod.load_state_dict({k: torch.from_numpy(v)
                              for k, v in params.items()})
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_TPU_KERNELS", "interpret")
            ref = jmod.apply({"params": {k: jnp.asarray(v)
                                         for k, v in params.items()}},
                             jnp.asarray(x))
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mixed", ["layer_norm", "rms_norm"])
def test_mixed_modules_match_flax_modules(mixed):
    """MixedFusedLayerNorm / MixedFusedRMSNorm: fp32 parameters beside a
    bf16 input, against the flax modules with the same parameters (their
    Pallas kernels in interpret mode), forward and backward.  y and dx in
    bf16 within one bf16 ulp (the two sides round the same fp32 value);
    the parameters' gradients in fp32 at 1e-5."""
    import jax

    rng = np.random.default_rng(20)
    x = (rng.standard_normal((2, 8, 128)) * 2 + 0.5).astype(np.float32)
    cot = rng.standard_normal((2, 8, 128)).astype(np.float32)
    jmod, tmod = ((JaxMixedFusedLayerNorm((128,)), MixedFusedLayerNorm(128, device="cpu"))
                  if mixed == "layer_norm" else
                  (JaxMixedFusedRMSNorm((128,)), MixedFusedRMSNorm(128, device="cpu")))
    params = {"scale": (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)}
    if mixed == "layer_norm":
        params["bias"] = (0.1 * rng.standard_normal(128)).astype(np.float32)
    assert {k: v.dtype for k, v in tmod.named_parameters()} == {
        k: torch.float32 for k in params}
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    tx = _to_torch(x, "bfloat16").requires_grad_()
    y = tmod(tx)
    y.backward(_to_torch(cot, "bfloat16"))

    def f(p, xj):
        return jmod.apply({"params": p}, xj)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        ref, vjp = jax.vjp(f, jp, jnp.asarray(x, jnp.bfloat16))
        gp, gx = vjp(jnp.asarray(cot, jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert_ulp_close(y.detach(), ref, "bfloat16")
    assert_ulp_close(tx.grad, gx, "bfloat16")
    for k, v in tmod.named_parameters():
        assert v.grad.dtype == torch.float32
        np.testing.assert_allclose(v.grad.numpy(), _np32(gp[k]),
                                   atol=1e-5, rtol=1e-5)


def test_cpu_autograd_through_plain_version():
    """On the CPU, autograd through the plain forward gives the JAX
    package's gradients (its custom-vjp backward, jnp path)."""
    import jax

    x, w, _ = _inputs(3, 128, seed=4)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    torch.sin(tln.fused_rms_norm_affine(tx, tw, (128,))).sum().backward()
    gx, gw = jax.grad(lambda x, w: jnp.sum(jnp.sin(
        jln.fused_rms_norm_affine(x, w, (128,)))), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw),
                               atol=1e-4, rtol=1e-4)


def test_kernel_path_never_falls_back_on_this_host():
    """A CUDA-only call path raises here instead of running the plain
    version: the kernel wrapper refuses CPU tensors, the build needs
    nvcc, and a module asked for the default device needs a card."""
    x = torch.randn(3, 128)
    launches = tln.LAYER_NORM_FWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_fwd(x, None, None, 1e-5, True)
    assert tln.LAYER_NORM_FWD.launches == launches
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FusedRMSNorm(128)
    with pytest.raises(ValueError, match="lie on"):
        _dispatch.kernel_path(x, torch.empty(0, device="meta"))


def test_kernel_registry():
    assert tln.LAYER_NORM_FWD in _dispatch.KERNELS
    assert (_build.CSRC / tln.LAYER_NORM_FWD.source).is_file()
    assert tln.LAYER_NORM_FWD.replaces.startswith("apex_tpu/ops/layer_norm.py")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version, on the card (chip_smoke.py
    runs the full grid); skipped on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for xdt in ("float32", "bfloat16"):
        x, w, b = _inputs(37, 200)
        args = [_to_torch(a, xdt).cuda() for a in (x, w, b)]
        with torch.no_grad():
            ours = tln._norm_forward(*args, 1e-5, False)
            ref = tln._plain_forward(*args, 1e-5, False)
        _check(tuple(t.cpu() for t in ours), tuple(t.cpu() for t in ref), xdt)


# ---------------------------------------------------------------------------
# the backward (training slice)
# ---------------------------------------------------------------------------


def _grads_both(x, w, b, dy, *, rms, mem_eff, xdt="float32", wdt="float32"):
    """(port (dx, dw, db), JAX (dx, dw, db)) for the same inputs and
    cotangent: the port through ``_NormFunction`` on the CPU (its plain
    backward), JAX through ``jax.vjp`` of its custom-vjp ``_norm`` with the
    Pallas kernels in interpret mode."""
    import jax

    tx = _to_torch(x, xdt).requires_grad_()
    tw = None if w is None else _to_torch(w, wdt).requires_grad_()
    tb = None if b is None else _to_torch(b, wdt).requires_grad_()
    y = tln._norm(tx, tw, tb, 1e-5, rms, mem_eff)
    y.backward(_to_torch(dy, xdt))
    ours = (tx.grad, None if tw is None else tw.grad,
            None if tb is None else tb.grad)

    args = [jnp.asarray(x, _JNP[xdt])] + [
        jnp.asarray(a, _JNP[wdt]) for a in (w, b) if a is not None]

    def f(*a):
        return jln._norm(a[0], a[1] if w is not None else None,
                         a[2] if b is not None else None, 1e-5, rms, mem_eff)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        _, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(dy, _JNP[xdt]))
    ref = (grads[0], grads[1] if w is not None else None,
           grads[2] if b is not None else None)
    return ours, ref


# (rms, weight?, bias?): RMSNorm takes no bias
_BWD_AFFINE = [pytest.param(rms, w, b, id=f"{'rms' if rms else 'ln'}-{name}")
               for rms in (False, True)
               for w, b, name in ((False, False, "plain"), (True, False, "w"),
                                  (True, True, "w+b"))
               if not (rms and b)]


@pytest.mark.parametrize("mem_eff", [False, True], ids=["x", "memeff"])
@pytest.mark.parametrize("rms,has_w,has_b", _BWD_AFFINE)
def test_plain_backward_matches_jax_grad(rms, has_w, has_b, mem_eff):
    """dx, dγ, dβ of the port's plain backward against ``jax.vjp`` of the
    JAX ``_norm`` (its Pallas ``_bwd_kernel`` in interpret mode), over
    LN/RMS, affine/bias and ``memory_efficient`` (the saved ``y`` and
    ``xhat = (y - b) / w``), at a ragged 5-row n; fp32 at 1e-5."""
    x, w, b = _inputs(5, 128, seed=11)
    dy = np.random.default_rng(12).standard_normal((5, 128)).astype(np.float32)
    ours, ref = _grads_both(x, w if has_w else None, b if has_b else None, dy,
                            rms=rms, mem_eff=mem_eff)
    for o, r in zip(ours, ref):
        if r is None:
            assert o is None
            continue
        np.testing.assert_allclose(_np32(o), _np32(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_mixed_dtype_backward_matches_jax_grad(rms):
    """The O2 case: x bf16 with an fp32 scale (and bias).  dx in bf16
    within one bf16 ulp (the two sides round the same fp32 value), dγ and
    dβ in the weight's fp32 at 1e-5."""
    x, w, b = _inputs(16, 256, seed=13)
    dy = np.random.default_rng(14).standard_normal((16, 256)).astype(np.float32)
    ours, ref = _grads_both(x, w, None if rms else b, dy, rms=rms,
                            mem_eff=False, xdt="bfloat16", wdt="float32")
    assert ours[0].dtype == torch.bfloat16 and ours[1].dtype == torch.float32
    assert_ulp_close(ours[0], ref[0], "bfloat16")
    for o, r in zip(ours[1:], ref[1:]):
        if r is not None:
            np.testing.assert_allclose(_np32(o), _np32(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mem_eff", [False, True], ids=["x", "memeff"])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_norm_function_gradcheck(rms, mem_eff):
    """``_NormFunction`` in float64 (its plain forward and backward on the
    CPU) against finite differences."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((4, 12))).requires_grad_()
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(12)).requires_grad_()
    b = (None if rms
         else torch.from_numpy(0.1 * rng.standard_normal(12)).requires_grad_())
    args = (x, w) if rms else (x, w, b)
    fn = lambda *a: tln._NormFunction.apply(
        a[0], a[1], None if rms else a[2], 1e-5, rms, mem_eff)
    assert torch.autograd.gradcheck(fn, args)


def test_memory_efficient_saves_the_output():
    """With ``memory_efficient`` the graph keeps ``y``, not ``x``."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(3, 128, seed=16))
    x.requires_grad_()
    for mem_eff in (False, True):
        y = tln._norm(x, w, b, 1e-5, False, mem_eff)
        saved = y.grad_fn.saved_tensors[0]
        assert saved.data_ptr() == (y if mem_eff else x).data_ptr()


def test_no_graph_without_grad():
    """Under ``no_grad`` (and on tensors that need no gradient) the
    forward runs alone: no autograd node, nothing saved."""
    x, w, _ = (torch.from_numpy(a) for a in _inputs(3, 128, seed=17))
    with torch.no_grad():
        assert tln._norm(x.requires_grad_(), w, None, 1e-5, True, False).grad_fn is None
    assert tln._norm(x.detach(), w, None, 1e-5, True, False).grad_fn is None


@pytest.mark.parametrize("n,h,affine", [(8192, 2048, True), (8, 2048, True),
                                        (5, 5000, True), (100, 13000, True),
                                        (8192, 2048, False)])
def test_bwd_grid_fits_shared_memory(n, h, affine):
    """The backward's grid fits the card.  The register form (bf16 rows of
    2048, the paths' width): its shared memory, rows in flight and then
    the block's column sums, fits a block and leaves room for the blocks
    an SM it launches, no more blocks than those, and every row has a row
    group.  The streaming form (h 5000 and 13000: not whole 16-byte
    vectors in bf16): the per-warp column sums fit with three blocks an SM
    (one warp at the least) and three blocks an SM; without a weight, a
    warp a row."""
    lanes, wn, vecs, warps, blocks = tln.bwd_grid(
        n, h, torch.bfloat16, affine, True, False, True, sms=132)
    assert 1 <= warps <= 8 and blocks >= 1
    if vecs:
        per_warp = 32 // lanes
        rows = warps // wn * per_warp
        smem = tln._bwd_smem(h, 32 * warps, vecs, rows, affine, True, False)
        per_block = smem + tln._BWD_STATIC_SMEM + tln._SMEM_BLOCK_RESERVED
        assert smem <= tln._SMEM_MAX
        assert blocks <= 132 * min(tln._bwd_blocks_per_sm(vecs),
                                   tln._SMEM_SM // per_block)
        assert blocks * rows >= min(n, 132 * rows)
        assert math.ceil(n / rows) >= blocks
    elif affine:
        assert warps * 2 * h * 4 <= tln._SMEM_MAX // 3 or warps == 1
        assert blocks <= 3 * 132
    else:
        assert blocks * warps >= n


def test_bwd_grid_rejects_rows_too_long():
    """A row whose column sums do not fit one warp's shared memory in the
    streaming form raises: with a bias (two sums a column) past h 29056,
    without one past h 58112."""
    with pytest.raises(ValueError, match="shared memory"):
        tln.bwd_grid(4, 40000, torch.bfloat16, True, True, False, True, sms=132)
    with pytest.raises(ValueError, match="shared memory"):
        tln.bwd_grid(4, 60000, torch.bfloat16, True, False, False, True, sms=132)
    assert tln.bwd_grid(4, 40000, torch.bfloat16, True, False, False, True,
                        sms=132)[2] == 0


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    x = torch.randn(3, 128)
    launches = tln.LAYER_NORM_BWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_bwd(x, x, torch.zeros(3), torch.ones(3), None, None,
                           True, False)
    assert tln.LAYER_NORM_BWD.launches == launches


@pytest.mark.cuda
def test_backward_kernel_matches_plain_version_on_card():
    """The CUDA backward against its plain version, on the card
    (chip_smoke.py runs the full grid); skipped on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, b = _inputs(37, 200)
    dy = np.random.default_rng(18).standard_normal((37, 200)).astype(np.float32)
    tx, tw, tb, tdy = (torch.from_numpy(a).cuda() for a in (x, w, b, dy))
    with torch.no_grad():
        _, mean, rstd = tln._plain_forward(tx, tw, tb, 1e-5, False)
        ours = tln.layer_norm_bwd(tdy, tx, mean, rstd, tw, tb, False, False)
        ref = tln._plain_backward(tdy, tx, mean, rstd, tw, tb, False, False)
    for o, r in zip(ours, ref):
        torch.testing.assert_close(o, r, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the backward kernel's grid (chosen on the host, so it is held here)
# ---------------------------------------------------------------------------

# every (n, h) the card-side checks and timings run the backward at
# (chip_smoke.py), the paths' shapes first (BERT-large's and ViT-L/16's
# h 1024; GPT-1.3B's is Llama's 8192 x 2048)
_BWD_SHAPES = [(8192, 2048), (8192, 1280), (131072, 256), (1048576, 128),
               (8192, 1024), (12608, 1024), (512, 2048), (3, 128), (16, 256), (3, 200), (16, 200),
               (5, 5000), (7, 256), (600, 256), (1000, 128), (1, 128),
               (5000, 128), (1001, 256), (999, 512), (77, 64), (1003, 32),
               (333, 1280),
               (100, 2048), (1, 2048), (3, 1280), (5, 8192), (2, 8256),
               (1, 8192), (5, 4096), (2, 4128), (1, 4096)]


def _bwd_threads(lanes, wn, warps):
    """Each thread's (row slot, place in its row) as the register form
    computes them: slot = (warp / wn) (32 / lanes) + lane / lanes, sub =
    (warp % wn) lanes + lane % lanes."""
    per_warp = 32 // lanes
    return [((warp // wn) * per_warp + lane // lanes,
             (warp % wn) * lanes + lane % lanes)
            for warp in range(warps) for lane in range(32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,h", _BWD_SHAPES)
def test_bwd_grid_covers_every_row_once(n, h, dtype):
    """The register form's threads, as the kernel maps them: each (row
    slot, place in the row) once in a block; each 16-byte chunk of a row
    once among a row's threads (chunk sub + lanes wn k, k < vecs); each
    row once among the blocks' strides (block b's iteration i takes rows
    (b + i blocks) rows_a_block + slot), and no block more strides than
    the others but one, in as few blocks as that takes.  The streaming form
    (vecs 0) takes rows that are too long, not whole vectors, and nothing
    else."""
    lanes, wn, vecs, warps, blocks = tln.bwd_grid(n, h, dtype, True, True,
                                                  False, True, sms=132)
    per_vec = 16 // dtype.itemsize
    nvec = h // per_vec
    if not vecs:
        assert (lanes, wn) == (32, 1)
        assert h % per_vec or nvec > tln._BWD_THREADS * tln._BWD_VECS[-1]
        return
    assert lanes in (8, 16, 32) and wn in (1, 2, 4, 8) and vecs in tln._BWD_VECS
    assert wn == 1 or lanes == 32
    assert warps % wn == 0 and 1 <= warps <= 8
    rows = warps // wn * (32 // lanes)
    pairs = _bwd_threads(lanes, wn, warps)
    assert sorted(pairs) == [(r, t) for r in range(rows)
                             for t in range(lanes * wn)]
    chunks = sorted(sub + lanes * wn * k for sub in range(lanes * wn)
                    for k in range(vecs) if sub + lanes * wn * k < nvec)
    assert chunks == list(range(nvec))
    iters = math.ceil(n / (blocks * rows))
    seen = ((np.arange(blocks)[:, None, None]
             + np.arange(iters)[None, :, None] * blocks) * rows
            + np.arange(rows)[None, None, :]).ravel()
    seen = seen[seen < n]
    assert np.array_equal(np.bincount(seen, minlength=n), np.ones(n, np.int64))
    # no block is left without a row, and the strides are balanced
    strides = math.ceil(n / rows)
    rounds = math.ceil(strides / blocks)
    assert blocks <= strides and blocks == math.ceil(strides / rounds)


@pytest.mark.parametrize("n,h,rms,grid", [
    (8192, 2048, True, (32, 2, 4, 8, 256)),     # Llama-1B, bf16, scale fp32
    (8192, 1280, False, (32, 2, 3, 8, 256)),    # GPT-2-large
    (131072, 256, False, (16, 1, 2, 8, 391)),   # OpenFold m
    (1048576, 128, False, (16, 1, 1, 8, 395))])  # OpenFold z
def test_bwd_grid_at_the_paths_shapes(n, h, rms, grid):
    """The form at each main path's shape (x bf16): rows of 2048 and 1280
    over two warps of 32 lanes, 4 and 3 vectors a thread, two blocks an SM;
    OpenFold's rows of 256 and 128 to 16 lanes (two rows a warp), 2 and 1
    vectors a thread, three blocks an SM; on 132 SMs, as few blocks as walk
    the rows in the same number of strides."""
    assert tln.bwd_grid(n, h, torch.bfloat16, True, not rms, False, True,
                        sms=132) == grid


def test_bwd_grid_takes_the_streaming_form_from_the_shape():
    """The register form ends at 256 threads x 4 vectors (bf16 h 8192,
    fp32 h 4096); past it, at an h that is not whole vectors, or for an
    input off 16 bytes, the streaming form.  Small n keeps the register
    form, with fewer warps, so each row has an SM of its own."""
    grid = lambda n, h, dt, aligned=True: tln.bwd_grid(
        n, h, dt, True, True, False, aligned, sms=132)
    assert grid(5, 8192, torch.bfloat16)[:3] == (32, 8, 4)
    assert grid(5, 8256, torch.bfloat16)[2] == 0
    assert grid(5, 4096, torch.float32)[:3] == (32, 8, 4)
    assert grid(5, 4128, torch.float32)[2] == 0
    assert grid(5, 200, torch.bfloat16)[:3] == (16, 1, 2)
    assert grid(5, 202, torch.bfloat16)[2] == 0
    assert grid(7, 256, torch.bfloat16, aligned=False)[2] == 0
    assert grid(1, 128, torch.bfloat16) == (16, 1, 1, 1, 1)
    assert grid(3, 64, torch.bfloat16)[:3] == (8, 1, 1)
    assert grid(1, 2048, torch.bfloat16) == (32, 2, 4, 2, 1)


@pytest.mark.parametrize("n,h", _BWD_SHAPES)
def test_bwd_grid_fits_the_registers_the_kernel_declares(n, h):
    """The register form declares ``__launch_bounds__(256,
    bwd_blocks_per_sm(NV))``: the grid launches no more blocks than those
    (and its shared memory) let be resident at once, and a thread's column
    sums (2 vecs VEC fp32, with a bias) take at most half of the registers
    that bound leaves it."""
    for dtype in (torch.float32, torch.bfloat16):
        lanes, wn, vecs, warps, blocks = tln.bwd_grid(
            n, h, dtype, True, True, True, True, sms=132)
        if not vecs:
            continue
        per_sm = tln._bwd_blocks_per_sm(vecs)
        assert blocks <= per_sm * 132
        budget = tln._REGS_PER_SM // (tln._BWD_THREADS * per_sm)
        assert 2 * vecs * (16 // dtype.itemsize) <= budget // 2
        rows = warps // wn * (32 // lanes)
        smem = tln._bwd_smem(h, 32 * warps, vecs, rows, True, True, True)
        assert blocks <= 132 * (tln._SMEM_SM // (
            smem + tln._BWD_STATIC_SMEM + tln._SMEM_BLOCK_RESERVED))


def test_bwd_grid_tables_match_the_kernel_source():
    """The host's copy of the backward's constants is the source's: threads
    a block, the vector counts ``launch_rows_b`` instantiates, the stages
    ``bwd_stages`` and the register table ``bwd_blocks_per_sm`` (its
    ``__launch_bounds__``) of each, the per-thread bytes of a stage and the
    static shared memory."""
    import re
    from pathlib import Path

    src = (Path(tln.__file__).resolve().parents[1] / "csrc"
           / "layer_norm_bwd.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kThreads") == tln._BWD_THREADS
    assert const("kMaxVecs") == tln._BWD_VECS[-1]
    counts = {int(v) for v in re.findall(
        r"return launch_rows_nv<TX, HAS_B, (\d+)>", src)}
    assert sorted(counts) == list(tln._BWD_VECS)
    stages = re.search(r"int bwd_stages\(int nv\) \{ return nv >= (\d+) \? (\d+) : "
                       r"(\d+); \}", src).groups()
    body = re.search(r"int bwd_blocks_per_sm\(int nv\) \{ return (.*?); \}",
                     src).group(1)
    steps = [(int(a), int(b)) for a, b in re.findall(r"nv <= (\d+) \? (\d+) :", body)]
    default = int(body.rsplit(":", 1)[1])
    assert steps
    for nv in tln._BWD_VECS:
        want = next((b for a, b in steps if nv <= a), default)
        assert tln._bwd_blocks_per_sm(nv) == want, nv
        assert tln._bwd_stages(nv) == int(stages[1] if nv >= int(stages[0])
                                          else stages[2]), nv
    assert "(size_t)threads * (32 * nv + 8)" in src
    assert "__shared__ float red[2][kMaxWarps][2];" in src
    assert tln._BWD_STATIC_SMEM == 2 * const("kMaxWarps") * 2 * 4


# ---------------------------------------------------------------------------
# the forward kernel's grid (chosen on the host, so it is held here)
# ---------------------------------------------------------------------------

# every (n, h) the card-side checks and timings run (chip_smoke.py), the
# paths' shapes first: Llama's RMSNorm, GPT-2-large's, OpenFold's,
# BERT-large's and ViT-L/16's LayerNorms (GPT-1.3B's is 8192 x 2048)
_FWD_SHAPES = [(8, 2048), (512, 2048), (8192, 2048), (8192, 1280),
               (131072, 256), (1048576, 128), (8192, 1024), (12608, 1024), (3, 128), (16, 256), (3, 200),
               (16, 200), (5, 5000), (7, 256), (1, 1), (37, 200), (3, 5)]


def _rows_visited(n, lanes, warps, blocks):
    """The rows the kernel's warps visit, as it strides: warp w's group g
    takes rows (w * per_warp + g) + k * step."""
    per_warp = 32 // lanes
    step = blocks * warps * per_warp
    return [r0 + grp for w in range(blocks * warps)
            for r0 in range(w * per_warp, n, step) for grp in range(per_warp)
            if r0 + grp < n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,h", _FWD_SHAPES)
def test_fwd_grid_covers_every_row_once(n, h, dtype):
    """Every row is visited by exactly one lane group; the vectors a lane
    keeps cover the row (or the streaming kernel takes it); warps and
    blocks within the kernel's limits."""
    lanes, vecs, warps, blocks = tln.fwd_grid(n, h, dtype, sms=132)
    assert lanes in (8, 16, 32) and 1 <= warps <= 8 and blocks >= 1
    per_vec = 16 // dtype.itemsize
    if vecs:
        assert vecs in tln._FWD_VECS and h % per_vec == 0
        assert lanes * vecs >= h // per_vec
        assert vecs * per_vec <= tln._FWD_MAX_VALUES
    else:
        assert lanes == 32
        assert h % per_vec or h // per_vec > 32 * tln._FWD_MAX_VALUES // per_vec
    if n <= 200000:
        assert sorted(_rows_visited(n, lanes, warps, blocks)) == list(range(n))
    else:
        # the warps' first rows tile one step of rows: each row once
        assert blocks * warps * (32 // lanes) <= n


@pytest.mark.parametrize("n,h,lanes", [(1048576, 128, 8), (131072, 256, 8),
                                       (64, 512, 16), (8192, 1280, 32),
                                       (8192, 2048, 32)])
def test_fwd_grid_gives_short_rows_several_a_warp(n, h, lanes):
    """OpenFold's bf16 rows (h 128, 256) take 8 lanes each, four rows a
    warp; longer rows more lanes, up to the whole warp."""
    assert tln.fwd_grid(n, h, torch.bfloat16, sms=132)[0] == lanes


@pytest.mark.parametrize("n,h", _FWD_SHAPES)
def test_fwd_grid_fits_the_registers_the_kernel_declares(n, h):
    """The kernel declares ``__launch_bounds__(256, fwd_blocks_per_sm(NV))``:
    the grid launches no more blocks than those can be resident at once
    (one wave, each warp striding), and a lane's two rows of NV vectors (8
    registers a vector) take at most half of the registers that bound
    leaves a thread."""
    for dtype in (torch.float32, torch.bfloat16):
        lanes, vecs, warps, blocks = tln.fwd_grid(n, h, dtype, sms=132)
        per_sm = tln._fwd_blocks_per_sm(vecs) if vecs else 2
        assert blocks <= per_sm * 132
        if vecs:
            budget = tln._REGS_PER_SM // (32 * tln._FWD_WARPS * per_sm)
            assert 8 * vecs <= budget // 2


def test_fwd_grid_spreads_a_decode_step_over_the_sms():
    """n 8 rows of 2048 (a decode step over 8 slots): one warp a block,
    eight blocks, so each row's loads start on an SM of their own."""
    assert tln.fwd_grid(8, 2048, torch.bfloat16, sms=132) == (32, 8, 1, 8)


def test_forward_kernel_wrapper_refuses_cpu_tensors():
    x = torch.randn(3, 128)
    w = torch.ones(128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_fwd(x, w, torch.zeros(128), 1e-5, False)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h", [(1048576, 128), (131072, 256), (8192, 1280)])
def test_kernel_matches_plain_version_on_card_layer_norm_regimes(n, h):
    """The forward kernel at OpenFold's pair and MSA rows (several rows a
    warp) and GPT-2-large's h 1280 (LayerNorm, bf16, bf16 weight and
    bias), against its plain version; skipped on a host without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, b = _inputs(n, h, seed=19)
    args = [_to_torch(a, "bfloat16").cuda() for a in (x, w, b)]
    with torch.no_grad():
        ours = tln.layer_norm_fwd(*args, 1e-5, False)
        ref = tln._plain_forward(*args, 1e-5, False)
    _check(tuple(t.cpu() for t in ours), tuple(t.cpu() for t in ref), "bfloat16")


def test_fwd_grid_tables_match_the_kernel_source():
    """The host's copy of the forward kernel's occupancy table and its
    instantiated vector counts are the source's: ``fwd_blocks_per_sm``
    (the kernel's ``__launch_bounds__``) and the ``launch_rows<TX, TW, NV>``
    that ``launch`` dispatches to."""
    import re
    from pathlib import Path

    src = (Path(tln.__file__).resolve().parents[1] / "csrc"
           / "layer_norm_fwd.cu").read_text()
    body = re.search(r"int fwd_blocks_per_sm\(int nv\) \{ return (.*?); \}",
                     src).group(1)
    steps = [(int(a), int(b)) for a, b in re.findall(r"nv <= (\d+) \? (\d+) :", body)]
    default = int(body.rsplit(":", 1)[1])
    assert steps
    for nv in range(1, 17):
        want = next((b for a, b in steps if nv <= a), default)
        assert tln._fwd_blocks_per_sm(nv) == want, nv
    counts = {int(v) for v in re.findall(r"return launch_rows<TX, TW, (\d+)>", src)}
    assert sorted(counts) == sorted(tln._FWD_VECS)
