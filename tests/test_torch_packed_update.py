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
    with pytest.raises(NotImplementedError, match=r"mixed-precision \(amp\)"):
        FusedLAMB(p, master_weights=True)
    opt = FusedLAMB(p)
    with pytest.raises(NotImplementedError, match=r"mixed-precision \(amp\)"):
        opt.step(grad_scale=torch.tensor(2.0))
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
