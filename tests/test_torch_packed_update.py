"""apex_tpu_torch's packed LAMB, packing, tree norms and FusedLAMB against
apex_tpu's.

The same numpy parameters, gradients and moments (fixed seeds) go through
the JAX functions and the port's.  The JAX ``packed_lamb_update`` runs its
Pallas ``_lamb_phase1_kernel`` in interpret mode
(``APEX_TPU_KERNELS=interpret``); the port's CPU path is the kernel's plain
version.  Tolerances: the flat buffers and tree norms at ``atol = rtol =
1e-6`` (fp32, the norms' sums taken in another order); FusedLAMB
trajectories over 4 steps at ``atol = 1e-6, rtol = 1e-5`` for fp32 values
(the trust ratio divides two norms whose fp32 sums differ in order, and
the fused in-place ops regroup roundings), and one bf16 ulp of the larger
magnitude for bf16 parameters and moments (a few fp32 roundings apart can
put a value on either side of a bf16 rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import (
    multi_tensor_axpby as jax_axpby,
    multi_tensor_l2norm as jax_l2norm,
    multi_tensor_scale as jax_scale,
)
from apex_tpu.ops import packed_update as jpu
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.utils import packing as jpk
from apex_tpu_torch.multi_tensor_apply import (
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
)
from apex_tpu_torch.ops import packed_update as tpu
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.utils import packing as tpk

_TOL = dict(atol=1e-6, rtol=1e-6)
# leaf name -> (shape, dtype); sorted-key order is the packed order
_LEAVES = {"a_w": ((6, 5), "float32"), "b_emb": ((9, 4), "bfloat16"),
           "c_bias": ((7,), "float32"), "d_k": ((3, 2, 5), "bfloat16"),
           "e_s": ((), "float32")}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _values(seed, scale=1.0, leaves=_LEAVES):
    """{name: fp32 numpy array}, each exactly representable in its dtype."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dt) in leaves.items():
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        out[name] = _np32(jnp.asarray(a, _JNP[dt]))
    return out


def _jax_tree(values, leaves=_LEAVES):
    return {k: jnp.asarray(v, _JNP[leaves[k][1]]) for k, v in values.items()}


def _torch_tree(values, leaves=_LEAVES):
    return {k: torch.from_numpy(np.array(v)).to(_TORCH[leaves[k][1]])
            for k, v in values.items()}


def _assert_close(actual, expected, dtype: str):
    a, e = _np32(actual), _np32(expected)
    if dtype == "float32":
        np.testing.assert_allclose(a, e, atol=1e-6, rtol=1e-5)
        return
    mag = np.maximum(np.maximum(np.abs(a), np.abs(e)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(a - e) <= ulp).all(), np.abs(a - e).max()


# ---------------------------------------------------------------------------
# packing and tree math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_to", [1024, 8, 1])
def test_pack_matches_jax_and_round_trips(pad_to):
    values = _values(0)
    jflat = jpk.pack_pytree(_jax_tree(values), dtype=jnp.float32, pad_to=pad_to)
    tbuf = tpk.pack_pytree(_torch_tree(values), dtype=torch.float32,
                           pad_to=pad_to)
    spec = tbuf.spec
    assert (spec.offsets, spec.total, spec.padded_total, spec.sizes) == (
        jflat.spec.offsets, jflat.spec.total, jflat.spec.padded_total,
        jflat.spec.sizes)
    assert tbuf.flat.dtype == torch.float32
    np.testing.assert_array_equal(tbuf.flat.numpy(), _np32(jflat.flat))
    back = tbuf.unpack()
    for k, v in _torch_tree(values).items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k], v)


def test_pack_nested_lists_dicts_and_promotion():
    tree = [torch.ones(2, 3, dtype=torch.bfloat16),
            {"z": torch.arange(3.0), "y": (torch.zeros(1, dtype=torch.float16),)}]
    buf = tpk.pack_pytree(tree, pad_to=16)
    assert buf.flat.dtype == torch.float32 and buf.flat.numel() == 16
    # the list's tensor, then "y" (sorted before "z"), then "z", then zeros
    assert buf.flat.tolist() == [1.0] * 6 + [0.0] + [0.0, 1.0, 2.0] + [0.0] * 6
    back = tpk.unpack_pytree(buf.flat, buf.spec)
    assert isinstance(back, list) and isinstance(back[1]["y"], tuple)
    assert back[1]["y"][0].dtype == torch.float16
    assert torch.equal(back[0], tree[0])
    assert tpk.make_packed_spec([]).padded_total == 1024


def test_tree_norms_scale_and_axpby_match_jax():
    x, y = _values(1), _values(2)
    jx, jy, tx, ty = _jax_tree(x), _jax_tree(y), _torch_tree(x), _torch_tree(y)
    total, per = multi_tensor_l2norm(tx, per_tensor=True)
    jtotal, jper = jax_l2norm(jx, per_tensor=True)
    np.testing.assert_allclose(_np32(total), _np32(jtotal), **_TOL)
    for a, e in zip(per, jper):
        np.testing.assert_allclose(_np32(a), _np32(e), **_TOL)
    out, inf = multi_tensor_scale(tx, 0.5)
    jout, jinf = jax_scale(jx, 0.5)
    assert bool(inf) == bool(jinf) is False
    for k in x:
        np.testing.assert_array_equal(_np32(out[k]), _np32(jout[k]))
    out, inf = multi_tensor_axpby(2.0, tx, -0.25, ty)
    jout, jinf = jax_axpby(2.0, jx, -0.25, jy)
    for k in x:
        _assert_close(out[k], jout[k], _LEAVES[k][1])
    tx["a_w"][0, 0] = float("inf")
    assert bool(multi_tensor_scale(tx, 1.0)[1])
    assert bool(multi_tensor_axpby(1.0, ty, 1.0, tx)[1])
    assert not bool(multi_tensor_scale(tx, 1.0, check_overflow=False)[1])


def test_tree_add_cast_and_zeros_match_jax():
    """``tree_add``, ``tree_cast`` and ``tree_zeros_like`` (the JAX
    ``utils/tree_math.py`` helpers ``fp16_utils`` uses) on the same tree."""
    from apex_tpu.utils import tree_math as jtm
    from apex_tpu_torch.utils import tree_math as ttm

    x, y = _values(1), _values(2)
    jx, jy, tx, ty = _jax_tree(x), _jax_tree(y), _torch_tree(x), _torch_tree(y)
    out, jout = ttm.tree_add(tx, ty), jtm.tree_add(jx, jy)
    for k in x:
        assert out[k].dtype == tx[k].dtype
        np.testing.assert_array_equal(_np32(out[k]), _np32(jout[k]))
    out = ttm.tree_cast(tx, torch.float16)
    jout = jtm.tree_cast(jx, jnp.float16)
    for k in x:
        assert out[k].dtype == torch.float16
        np.testing.assert_array_equal(_np32(out[k]), _np32(jout[k]))
    for dtype in (None, torch.bfloat16):
        zeros = ttm.tree_zeros_like(tx, dtype)
        for k in x:
            assert zeros[k].dtype == (dtype or tx[k].dtype)
            assert zeros[k].shape == tx[k].shape and not zeros[k].any()


# ---------------------------------------------------------------------------
# packed_lamb_update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("wd,nvlamb", [(0.01, False), (0.0, False), (0.0, True)],
                         ids=["wd", "no-wd", "nvlamb"])
def test_packed_lamb_update_matches_jax(interpret, adam_w_mode, wd, nvlamb):
    p, g = _values(3), _values(4, scale=0.1)
    m = np.random.default_rng(5).standard_normal(1024).astype(np.float32) * 0.01
    v = np.abs(np.random.default_rng(6).standard_normal(1024)).astype(np.float32) * 1e-3
    jspec = jpk.make_packed_spec(_jax_tree(p))
    jg = jpk.pack_pytree(_jax_tree(g), dtype=jnp.float32).flat
    jp = jpk.pack_pytree(_jax_tree(p), dtype=jnp.float32).flat
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=wd, bias_correction1=0.19, bias_correction2=0.002,
              global_clip=1.7, adam_w_mode=adam_w_mode, use_nvlamb=nvlamb)
    jnew_p, jnew_m, jnew_v = jpu.packed_lamb_update(
        jg, jp, jnp.asarray(m), jnp.asarray(v), jpu.segment_ids_for_spec(jspec),
        num_leaves=jspec.num_leaves, spec=jspec, **kw)
    tspec = tpk.make_packed_spec(_torch_tree(p))
    tg = tpk.pack_pytree(_torch_tree(g), dtype=torch.float32).flat
    tp = tpk.pack_pytree(_torch_tree(p), dtype=torch.float32).flat
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    out = tpu.packed_lamb_update(tg, tp, tm, tv, spec=tspec, **kw)
    assert out[0] is tp and out[1] is tm and out[2] is tv     # in place
    np.testing.assert_allclose(tm.numpy(), _np32(jnew_m), **_TOL)
    np.testing.assert_allclose(tv.numpy(), _np32(jnew_v), **_TOL)
    np.testing.assert_allclose(tp.numpy(), _np32(jnew_p), **_TOL)


def test_lamb_scalars_and_tensor_clip(interpret):
    """The bias corrections and the clip factor may be 0-d tensors (the
    clip comes from the global norm on the device)."""
    s = tpu.lamb_scalars(0.9, 0.1, 0.999, 1e-6, 0.01, torch.tensor(0.19),
                         0.002, torch.tensor([1.7]), "cpu")
    assert s.dtype == torch.float32 and s.shape == (8,)
    np.testing.assert_array_equal(
        s.numpy(), np.float32([0.9, 0.1, 0.999, 1e-6, 0.01, 0.19, 0.002, 1.7]))
    g = torch.randn(1000)
    p, m, v = torch.randn(1000), torch.zeros(1000), torch.zeros(1000)
    u = tpu.lamb_phase1(g, p, m, v, s, adam_w_mode=True)
    m_ref, v_ref, u_ref = tpu._plain_phase1(g, p, torch.zeros(1000),
                                            torch.zeros(1000), s, True)
    assert torch.equal(m, m_ref) and torch.equal(v, v_ref) and torch.equal(u, u_ref)
    with pytest.raises(ValueError, match="lies on cpu"):
        tpu._kernel_phase1(g, p, m, v, s, True)


# ---------------------------------------------------------------------------
# FusedLAMB
# ---------------------------------------------------------------------------

_STEPS = 4


@pytest.mark.parametrize("packed,state_dtype,wd,adam_w_mode", [
    (True, "float32", 0.01, True),
    (True, "float32", 0.01, False),
    (False, "float32", 0.01, True),
    (False, "bfloat16", 0.01, True),
    (False, "float32", 0.0, False),
], ids=["packed", "packed-l2", "unpacked", "unpacked-bf16-state",
        "unpacked-no-wd"])
def test_fused_lamb_matches_jax(interpret, packed, state_dtype, wd,
                                adam_w_mode):
    p0 = _values(7)
    grads = [_values(10 + i, scale=0.3 if i % 2 else 3.0) for i in range(_STEPS)]
    kw = dict(lr=1e-2, weight_decay=wd, adam_w_mode=adam_w_mode,
              max_grad_norm=1.0, packed=packed)
    jopt = JaxFusedLAMB(state_dtype=_JNP[state_dtype], **kw)
    jparams = _jax_tree(p0)
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(t) for k, t in _torch_tree(p0).items()}
    topt = FusedLAMB([tparams[k] for k in sorted(tparams)],
                     state_dtype=_TORCH[state_dtype], **kw)
    for g in grads:
        jparams, jstate = jopt.step(_jax_tree(g), jparams, jstate)
        for k, t in _torch_tree(g).items():
            tparams[k].grad = t
        topt.step()
    for k, (_, dt) in _LEAVES.items():
        assert tparams[k].dtype == _TORCH[dt]
        _assert_close(tparams[k], jparams[k], dt)
    inner = jstate[0]
    if packed:
        state = topt.state[tparams[sorted(tparams)[0]]]
        assert state["step"] == _STEPS
        np.testing.assert_allclose(state["exp_avg"].numpy(),
                                   _np32(inner.exp_avg), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(),
                                   _np32(inner.exp_avg_sq), atol=1e-6, rtol=1e-5)
    else:
        for k in _LEAVES:
            state = topt.state[tparams[k]]
            assert state["exp_avg"].dtype == _TORCH[state_dtype]
            _assert_close(state["exp_avg"], inner.exp_avg[k], state_dtype)
            _assert_close(state["exp_avg_sq"], inner.exp_avg_sq[k], state_dtype)


def test_fused_lamb_unsupported_options_raise():
    p = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(p, amsgrad=True)
    with pytest.raises(ValueError, match="packed=True keeps fp32"):
        FusedLAMB(p, packed=True, state_dtype=torch.bfloat16)
    opt = FusedLAMB(p + [torch.nn.Parameter(torch.ones(3))], packed=True)
    p[0].grad = torch.ones(2)
    with pytest.raises(ValueError, match="each needs a gradient"):
        opt.step()


@pytest.mark.cuda
def test_phase1_kernel_matches_plain_version_on_card():
    """The CUDA phase 1 against its plain version, on the card (chip_smoke.py
    runs the full grid); skipped on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 4099                        # not a multiple of the vector width
    g, p = (torch.randn(n, generator=gen, device="cuda") for _ in range(2))
    m = torch.randn(n, generator=gen, device="cuda") * 0.01
    v = torch.rand(n, generator=gen, device="cuda") * 1e-3
    s = tpu.lamb_scalars(0.9, 0.1, 0.999, 1e-6, 0.01, 0.19, 0.002,
                         torch.tensor(1.7, device="cuda"), "cuda")
    rm, rv, ru = tpu._plain_phase1(g, p, m, v, s, True)
    u = tpu.lamb_phase1(g, p, m, v, s, True)
    for a, e in ((m, rm), (v, rv), (u, ru)):
        torch.testing.assert_close(a, e, atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# packed_adam_update and packed_adagrad_update (rows 14 and 16)
# ---------------------------------------------------------------------------

_HALF = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16),
         "float16": (jnp.float16, torch.float16)}


@pytest.fixture
def pallas_calls(monkeypatch):
    """Counts the JAX module's ``pallas_call``s: 1 where the JAX function
    ran its Pallas kernel (in interpret mode), 0 where it took its jnp
    fallback (n not a multiple of 1024)."""
    calls = []
    real = jpu.pl.pallas_call

    def spy(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(jpu.pl, "pallas_call", spy)
    return calls


def _flat_inputs(n, p_dtype, g_dtype, seed, state):
    """fp32 numpy g, p and fp32 state buffers, g and p exactly
    representable in their dtypes."""
    rng = np.random.default_rng(seed)
    g = _np32(jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.1,
                          _HALF[g_dtype][0]))
    p = _np32(jnp.asarray(rng.standard_normal(n).astype(np.float32),
                          _HALF[p_dtype][0]))
    out = dict(g=g, p=p)
    for name in state:
        out[name] = np.abs(rng.standard_normal(n)).astype(np.float32) * 1e-2
    return out


def _close_in(actual, expected, dtype: str, terms=0.0):
    """fp32 within 2^-21 of |expected| plus the magnitude of the terms it
    sums (the same expressions in fp32, but XLA may contract a multiply
    and an add that PyTorch rounds apart, a rounding or two of the terms,
    which a moment near 0 makes large against itself); bf16/fp16 within
    one ulp of their own at the larger magnitude (an fp32 difference that
    small can cross a rounding boundary of the narrower type)."""
    a, e = _np32(actual), _np32(expected)
    if dtype == "float32":
        tol = 2.0 ** -21 * (np.abs(e) + terms) + 1e-30
        assert (np.abs(a - e) <= tol).all(), np.max(np.abs(a - e) / tol)
        return
    bits = {"bfloat16": 7, "float16": 10}[dtype]
    mag = np.maximum(np.maximum(np.abs(a), np.abs(e)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - bits)
    assert (np.abs(a - e) <= ulp).all(), np.abs(a - e).max()


@pytest.mark.parametrize("n", [2048, 1000], ids=["pallas", "jnp-fallback"])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
@pytest.mark.parametrize("noop", [0, 1])
@pytest.mark.parametrize("p_dtype,g_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float16", "float32")])
def test_packed_adam_update_matches_jax(interpret, pallas_calls, n,
                                        adam_w_mode, noop, p_dtype, g_dtype):
    """``packed_adam_update`` (the plain version on the CPU) against the
    JAX function: its Pallas ``_adam_kernel`` in interpret mode for n a
    multiple of 1024, its jnp fallback otherwise (the spy shows which).
    Weight decay 0.01, bias corrections of step 2 (the second a 0-d
    tensor), ``noop_flag`` a bool tensor: 1 must leave every buffer's
    bits as they were."""
    x = _flat_inputs(n, p_dtype, g_dtype, seed=40 + noop, state=("m", "v"))
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=0.19, adam_w_mode=adam_w_mode)
    jdt, tdt = _HALF[p_dtype]
    jp, jm, jv = jpu.packed_adam_update(
        jnp.asarray(x["g"], _HALF[g_dtype][0]), jnp.asarray(x["p"], jdt),
        jnp.asarray(x["m"]), jnp.asarray(x["v"]),
        bias_correction2=0.001999, noop_flag=jnp.asarray(bool(noop)), **kw)
    assert len(pallas_calls) == (1 if n % 1024 == 0 else 0)
    tg = torch.from_numpy(x["g"].copy()).to(_HALF[g_dtype][1])
    tp = torch.from_numpy(x["p"].copy()).to(tdt)
    tm, tv = torch.from_numpy(x["m"].copy()), torch.from_numpy(x["v"].copy())
    p0, m0, v0 = tp.clone(), tm.clone(), tv.clone()
    out = tpu.packed_adam_update(
        tg, tp, tm, tv, bias_correction2=torch.tensor(0.001999),
        noop_flag=torch.tensor(bool(noop)), **kw)
    assert out[0] is tp and out[1] is tm and out[2] is tv     # in place
    assert tp.dtype == tdt
    if noop:
        assert torch.equal(tp, p0) and torch.equal(tm, m0) and torch.equal(tv, v0)
    ga = np.abs(x["g"]) + 0.01 * np.abs(x["p"])
    _close_in(tp, jp, p_dtype)
    _close_in(tm, jm, "float32", 0.9 * np.abs(x["m"]) + 0.1 * ga)
    _close_in(tv, jv, "float32", 0.999 * x["v"] + 0.001 * ga * ga)


@pytest.mark.parametrize("n", [2048, 1000], ids=["pallas", "jnp-fallback"])
@pytest.mark.parametrize("adagrad_w_mode", [False, True], ids=["l2", "w"])
@pytest.mark.parametrize("noop", [0, 1])
@pytest.mark.parametrize("p_dtype,g_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float16", "float32")])
def test_packed_adagrad_update_matches_jax(interpret, pallas_calls, n,
                                           adagrad_w_mode, noop, p_dtype,
                                           g_dtype):
    """``packed_adagrad_update`` against the JAX function (its Pallas
    ``_adagrad_kernel`` in interpret mode for n a multiple of 1024, its
    jnp fallback otherwise), weight decay 0.01, both modes; ``noop`` 1
    leaves p and h as they were."""
    x = _flat_inputs(n, p_dtype, g_dtype, seed=50 + noop, state=("h",))
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.01,
              adagrad_w_mode=adagrad_w_mode)
    jdt, tdt = _HALF[p_dtype]
    jp, jh = jpu.packed_adagrad_update(
        jnp.asarray(x["g"], _HALF[g_dtype][0]), jnp.asarray(x["p"], jdt),
        jnp.asarray(x["h"]), noop_flag=jnp.asarray(float(noop)), **kw)
    assert len(pallas_calls) == (1 if n % 1024 == 0 else 0)
    tp = torch.from_numpy(x["p"].copy()).to(tdt)
    th = torch.from_numpy(x["h"].copy())
    p0, h0 = tp.clone(), th.clone()
    out = tpu.packed_adagrad_update(
        torch.from_numpy(x["g"].copy()).to(_HALF[g_dtype][1]), tp, th,
        noop_flag=float(noop), **kw)
    assert out[0] is tp and out[1] is th
    if noop:
        assert torch.equal(tp, p0) and torch.equal(th, h0)
    ga = np.abs(x["g"]) + 0.01 * np.abs(x["p"])
    _close_in(tp, jp, p_dtype)
    _close_in(th, jh, "float32", x["h"] + ga * ga)


def test_packed_scalars_on_the_device():
    """The step scalars are built on the buffers' device: numbers filled
    in, 0-d tensors copied (a bool ``found_inf`` becomes 1.0), None as 0;
    a scalar on another device raises."""
    s = tpu.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 0.0, torch.tensor(0.19),
                         0.002, torch.tensor(True), "cpu")
    assert s.dtype == torch.float32 and s.shape == (8,)
    assert s[5] == torch.tensor(0.19) and s[7] == 1.0
    s = tpu.adagrad_scalars(1e-2, 1e-10, 0.01, None, "cpu")
    assert s.tolist()[3] == 0.0 and s[0] == torch.tensor(1e-2)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lies on"):
            tpu.adagrad_scalars(1e-2, 1e-10, 0.0, torch.tensor(1.0), "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_packed_kernels_match_plain_versions_on_card(kind):
    """The CUDA packed Adam and Adagrad against their plain versions on the
    card (chip_smoke.py runs the full grid); a set noop leaves the bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 4099
    g = torch.randn(n, generator=gen, device="cuda") * 0.1
    p = torch.randn(n, generator=gen, device="cuda").bfloat16()
    st = [torch.rand(n, generator=gen, device="cuda") * 1e-2
          for _ in range(2 if kind == "adam" else 1)]
    for noop in (False, True):
        ours = [p.clone()] + [t.clone() for t in st]
        if kind == "adam":
            s = tpu.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 0.01, 0.19, 0.002,
                                 torch.tensor(noop, device="cuda"), "cuda")
            ref = tpu._plain_adam(g, p, *st, s, True)
            tpu._kernel_adam(g, *ours, s, True)
        else:
            s = tpu.adagrad_scalars(1e-2, 1e-10, 0.01,
                                    torch.tensor(noop, device="cuda"), "cuda")
            ref = tpu._plain_adagrad(g, p, *st, s, False)
            tpu._kernel_adagrad(g, *ours, s, False)
        torch.cuda.synchronize()
        for a, e in zip(ours, ref):
            if noop:
                assert torch.equal(a, e)
            else:
                torch.testing.assert_close(a.float(), e.float(), atol=1e-6,
                                           rtol=1e-2 if a.dtype != torch.float32
                                           else 1e-5)


def test_packed_adam_matches_treewise(interpret):
    """``packed_adam_update`` over a packed tree equals the per-leaf Adam
    step, as ``tests/test_dense_mlp.py`` holds the JAX function (the same
    tree, formula and tolerance: rtol 1e-5, atol 1e-6), and the JAX
    packed result (its Pallas kernel, the packed length a multiple of
    1024) at fp32 rounding."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((33, 7)).astype(np.float32),
              "b": rng.standard_normal(11).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=0.1, bias_correction2=0.001)
    tbuf = tpk.pack_pytree({k: torch.from_numpy(v) for k, v in params.items()},
                           dtype=torch.float32)
    gbuf = tpk.pack_pytree({k: torch.from_numpy(v) for k, v in grads.items()},
                           dtype=torch.float32)
    m, v = torch.zeros_like(tbuf.flat), torch.zeros_like(tbuf.flat)
    tpu.packed_adam_update(gbuf.flat, tbuf.flat, m, v, **kw)
    got = tpk.unpack_pytree(tbuf.flat, tbuf.spec)
    jbuf = jpk.pack_pytree({k: jnp.asarray(v) for k, v in params.items()},
                           dtype=jnp.float32)
    jg = jpk.pack_pytree({k: jnp.asarray(v) for k, v in grads.items()},
                         dtype=jnp.float32)
    jp, _, _ = jpu.packed_adam_update(jg.flat, jbuf.flat,
                                      jnp.zeros_like(jbuf.flat),
                                      jnp.zeros_like(jbuf.flat), **kw)
    np.testing.assert_allclose(tbuf.flat.numpy(), _np32(jp), rtol=2.0 ** -21,
                               atol=1e-30)
    for k, p in params.items():
        g = grads[k]
        mm, vv = 0.1 * g, 0.001 * g * g
        ref = p - 1e-2 * ((mm / 0.1) / (np.sqrt(vv / 0.001) + 1e-8) + 0.01 * p)
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-5, atol=1e-6)


def test_segment_ids_for_spec_defaults_to_the_card():
    """Like every entry point, ``segment_ids_for_spec`` makes its ids on
    CUDA unless asked for the CPU: without a card the default raises, and
    ``device="cpu"`` gives JAX's ids."""
    leaves = [np.zeros(s, np.float32) for s in ((3, 5), (7,), (2, 2, 2))]
    jspec = jpk.make_packed_spec([jnp.asarray(a) for a in leaves], pad_to=64)
    spec = tpk.make_packed_spec([torch.from_numpy(a) for a in leaves],
                                pad_to=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpu.segment_ids_for_spec(spec)
    got = tpu.segment_ids_for_spec(spec, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpu.segment_ids_for_spec(jspec)))
