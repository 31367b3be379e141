"""apex_tpu_torch's FusedSGD, FusedNovoGrad, FusedMixedPrecisionLamb and
clip_grad_norm_ against apex_tpu's.

The same numpy parameters and per-step gradients (fixed seeds) go through
the JAX optimizer (``init``, then ``step`` four times, new arrays each
step) and the port's (``torch.optim.Optimizer``, updated in place), the
gradients scaled by 64 and unscaled by ``grad_scale``.  Both compute in
fp32; the port's plain versions keep the JAX expressions except where
in-place ops regroup a rounding, so fp32 values compare at ``atol = 1e-6,
rtol = 1e-5`` (LAMB's trust ratio divides two norms whose sums run in
another order), and bf16 parameters within one bf16 ulp of the larger
magnitude (a few fp32 roundings apart can put a value on either side of a
bf16 rounding boundary).  ``clip_grad_norm_`` against the JAX
``clip_grad_norm`` at ``rtol = 1e-6`` (fp32 norms summed in another
order).  Each new JAX state is loaded by ``load_jax_optimizer_state`` and
the next step compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.clip_grad import clip_grad_norm as jax_clip_grad_norm
from apex_tpu.optimizers import FusedMixedPrecisionLamb as JaxMPLamb
from apex_tpu.optimizers import FusedNovoGrad as JaxNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm, clip_grad_norm_
from apex_tpu_torch.models.convert import load_jax_optimizer_state
from apex_tpu_torch.optimizers import (
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedSGD,
)

_SHAPES = {"a_w": (6, 5), "b_bias": (7,), "c_k": (3, 4, 2)}
_STEPS = 4
_SCALE = 64.0
_F32 = dict(atol=1e-6, rtol=1e-5)


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(actual, expected, dtype=torch.float32):
    a, e = _np32(actual), _np32(expected)
    if dtype == torch.float32:
        np.testing.assert_allclose(a, e, **_F32)
        return
    mag = np.maximum(np.maximum(np.abs(a), np.abs(e)), np.finfo(np.float32).tiny)
    assert (np.abs(a - e) <= np.exp2(np.floor(np.log2(mag)) - 7)).all()


def _data(seed=0, steps=_STEPS):
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in _SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * _SCALE).astype(np.float32)
              for k, s in _SHAPES.items()} for _ in range(steps)]
    return init, grads


def _jax_run(jopt, init, grads, dtype=jnp.float32, state=None, params=None):
    params = params if params is not None else \
        {k: jnp.asarray(v, dtype) for k, v in init.items()}
    state = state if state is not None else jopt.init(params)
    for g in grads:
        # the gradients in the parameters' dtype, as the port's arrive
        params, state = jopt.step({k: jnp.asarray(v, dtype)
                                   for k, v in g.items()},
                                  params, state,
                                  grad_scale=jnp.float32(_SCALE))
    return params, state


def _torch_params(init, dtype=torch.float32):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
            for k, v in init.items()}


def _torch_run(opt, params, grads):
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy()).to(p.dtype)
        opt.step(grad_scale=torch.tensor(_SCALE))


# ---------------------------------------------------------------------------
# FusedSGD
# ---------------------------------------------------------------------------

_SGD = {"momentum": dict(momentum=0.9),
        "dampening_wd": dict(momentum=0.9, dampening=0.1, weight_decay=0.01),
        "nesterov_wd_after": dict(momentum=0.9, nesterov=True,
                                  weight_decay=0.01, wd_after_momentum=True),
        "no_momentum_wd": dict(weight_decay=0.01)}


@pytest.mark.parametrize("case", list(_SGD))
def test_fused_sgd_matches_jax(case):
    init, grads = _data(1)
    kw = dict(lr=0.05, **_SGD[case])
    jp, jstate = _jax_run(JaxSGD(**kw), init, grads)
    params = _torch_params(init)
    opt = FusedSGD(list(params.values()), **kw)
    _torch_run(opt, params, grads)
    for k, p in params.items():
        _close(p, jp[k])
        _close(opt.state[p]["momentum_buffer"], jstate[0].momentum_buffer[k])
        assert int(opt.state[p]["step"]) == int(jstate[0].step) == _STEPS


def test_fused_sgd_nesterov_needs_momentum_and_no_dampening():
    p = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(ValueError):
        FusedSGD(p, lr=0.1, nesterov=True)
    with pytest.raises(ValueError):
        FusedSGD(p, lr=0.1, momentum=0.9, dampening=0.1, nesterov=True)


def test_fused_sgd_masters_and_skipped_step():
    """bf16 parameters on fp32 masters; a true ``found_inf`` keeps every
    value and the step counter."""
    init, grads = _data(2)
    kw = dict(lr=0.05, momentum=0.9, weight_decay=0.01)
    jp, jstate = _jax_run(JaxSGD(master_weights=True, **kw), init, grads,
                          dtype=jnp.bfloat16)
    params = _torch_params(init, torch.bfloat16)
    opt = FusedSGD(list(params.values()), master_weights=True, **kw)
    _torch_run(opt, params, grads)
    for k, p in params.items():
        _close(p, jp[k], torch.bfloat16)
        _close(opt.state[p]["master_param"], jstate[1].master_params[k])

    def everything():
        return [t.clone() for p in params.values()
                for t in [p.detach(), *opt.state[p].values()]]

    before = everything()
    for p in params.values():
        p.grad = torch.full_like(p, float("inf"))
    opt.step(found_inf=torch.tensor(True))
    assert all(torch.equal(a, b) for a, b in zip(everything(), before))
    assert int(opt.state[params["a_w"]]["step"]) == _STEPS


# ---------------------------------------------------------------------------
# FusedNovoGrad
# ---------------------------------------------------------------------------

_NOVO = {"default": dict(),
         "init_zero": dict(init_zero=True, weight_decay=0.01),
         "reg_inside_avg": dict(reg_inside_moment=True, grad_averaging=True,
                                weight_decay=0.01),
         "wd_no_bc": dict(weight_decay=0.01, bias_correction=False)}


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("case", list(_NOVO))
def test_fused_novograd_matches_jax(case, packed):
    init, grads = _data(3)
    kw = dict(lr=0.01, **_NOVO[case])
    jp, jstate = _jax_run(JaxNovoGrad(packed=packed, **kw), init, grads)
    params = _torch_params(init)
    opt = FusedNovoGrad(list(params.values()), packed=packed, **kw)
    _torch_run(opt, params, grads)
    for k, p in params.items():
        _close(p, jp[k])
    inner = jstate[0]
    if packed:
        st = opt.state[params["a_w"]]
        _close(st["exp_avg"], inner.exp_avg)
        _close(st["exp_avg_sq"], inner.exp_avg_sq)
    else:
        for k, p in params.items():
            _close(opt.state[p]["exp_avg"], inner.exp_avg[k])
            assert opt.state[p]["exp_avg_sq"].dim() == 0
            _close(opt.state[p]["exp_avg_sq"], inner.exp_avg_sq[k])


def test_fused_novograd_takes_only_the_l2_norm():
    with pytest.raises(RuntimeError):
        FusedNovoGrad([torch.nn.Parameter(torch.ones(2))], norm_type=1)


# ---------------------------------------------------------------------------
# FusedMixedPrecisionLamb
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wd,nvlamb", [(0.01, False), (0.0, True),
                                       (0.0, False)],
                         ids=["wd", "nvlamb", "no_ratio"])
def test_fused_mixed_precision_lamb_matches_jax(wd, nvlamb):
    """bf16 parameters on fp32 masters (the default), the clip before the
    stages (the gradients' norm is past max_grad_norm), the learning rate on
    the device, set anew after two steps, and an initial step of 3."""
    init, grads = _data(4)
    kw = dict(lr=1e-2, step=3, weight_decay=wd, use_nvlamb=nvlamb,
              max_grad_norm=1.0)
    jopt = JaxMPLamb(**kw)
    jp, jstate = _jax_run(jopt, init, grads[:2], dtype=jnp.bfloat16)
    jstate = jopt.set_lr(jstate, 5e-3)
    jp, jstate = _jax_run(jopt, init, grads[2:], dtype=jnp.bfloat16,
                          state=jstate, params=jp)
    params = _torch_params(init, torch.bfloat16)
    opt = FusedMixedPrecisionLamb(list(params.values()), **kw)
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
    _torch_run(opt, params, grads[:2])
    opt.set_lr(5e-3)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == np.float32(5e-3)
    _torch_run(opt, params, grads[2:])
    for k, p in params.items():
        assert p.dtype == torch.bfloat16
        _close(p, jp[k], torch.bfloat16)
        st = opt.state[p]
        _close(st["master_param"], jstate[1].master_params[k])
        _close(st["exp_avg"], jstate[0].exp_avg[k])
        _close(st["exp_avg_sq"], jstate[0].exp_avg_sq[k])
        assert int(st["step"]) == int(jstate[0].step) == 3 + _STEPS


def test_fused_mixed_precision_lamb_skipped_step_keeps_every_bit():
    init, grads = _data(5, 1)
    params = _torch_params(init, torch.bfloat16)
    opt = FusedMixedPrecisionLamb(list(params.values()), lr=1e-2)
    _torch_run(opt, params, grads)
    before = [t.clone() for p in params.values()
              for t in [p.detach(), *opt.state[p].values()]]
    for p in params.values():
        p.grad = torch.full_like(p, float("nan"))
    opt.step(grad_scale=torch.tensor(_SCALE), found_inf=torch.tensor(True))
    after = [t for p in params.values()
             for t in [p.detach(), *opt.state[p].values()]]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# clip_grad_norm_
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 3.0],
                         ids=["l2", "inf", "p3"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    _, grads = _data(6, 1)
    g = grads[0]
    jclipped, jtotal = jax_clip_grad_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm, norm_type)
    params = _torch_params(g)
    for k, p in params.items():
        p.grad = torch.from_numpy(g[k].copy())
    total = clip_grad_norm_(params.values(), max_norm, norm_type)
    np.testing.assert_allclose(_np32(total), _np32(jtotal), rtol=1e-6)
    for k, p in params.items():
        np.testing.assert_allclose(_np32(p.grad), _np32(jclipped[k]),
                                   rtol=2e-6, atol=1e-7)
    # the functional form leaves its input alone
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    clipped, total2 = clip_grad_norm(tg, max_norm, norm_type)
    assert torch.equal(total2, total)
    for k in g:
        assert torch.equal(tg[k], torch.from_numpy(g[k]))
        assert torch.equal(clipped[k], params[k].grad)


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_clip_grad_norm_of_a_nonfinite_gradient_matches_jax(bad):
    """The JAX rule: a non-finite total gives a coefficient of 0 (inf) or
    1 (NaN), never a raise and never a host read."""
    _, grads = _data(7, 1)
    g = grads[0]
    g["b_bias"][2] = bad
    jclipped, jtotal = jax_clip_grad_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    tg = [torch.from_numpy(g[k].copy()) for k in sorted(g)]
    clipped, total = clip_grad_norm(tg, 1.0, error_if_nonfinite=True)
    np.testing.assert_array_equal(_np32(total), _np32(jtotal))
    for k, c in zip(sorted(g), clipped):
        np.testing.assert_allclose(_np32(c), _np32(jclipped[k]), rtol=2e-6,
                                   atol=1e-7, equal_nan=True)


def test_clip_grad_norm_of_nothing():
    p = torch.nn.Parameter(torch.ones(3))
    assert float(clip_grad_norm_(p, 1.0)) == 0.0
    assert clip_grad_norm([], 1.0)[0] == []


# ---------------------------------------------------------------------------
# the JAX states loaded into the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sgd", "novograd", "novograd_packed",
                                  "mp_lamb"])
def test_jax_state_loads_and_the_next_step_matches(kind):
    init, grads = _data(8)
    params = _torch_params(init)
    plist = list(params.values())
    if kind == "sgd":
        kw = dict(lr=0.05, momentum=0.9)
        jopt, opt = JaxSGD(**kw), FusedSGD(plist, **kw)
    elif kind.startswith("novograd"):
        packed = kind.endswith("packed")
        jopt = JaxNovoGrad(lr=0.01, packed=packed)
        opt = FusedNovoGrad(plist, lr=0.01, packed=packed)
    else:
        kw = dict(lr=1e-2, master_weights=False)
        jopt = JaxMPLamb(**kw)
        opt = FusedMixedPrecisionLamb(plist, lr=0.5, master_weights=False)
        jopt_lr = 3e-3
    jp, jstate = _jax_run(jopt, init, grads[:2])
    if kind == "mp_lamb":
        jstate = jopt.set_lr(jstate, jopt_lr)
    host = jax.tree.map(np.asarray, jstate)
    for k, p in params.items():
        p.data.copy_(torch.from_numpy(np.array(jp[k], np.float32)))
    load_jax_optimizer_state(opt, params, host)
    if kind == "mp_lamb":
        assert float(opt.param_groups[0]["lr"]) == np.float32(jopt_lr)
    steps = {int(opt.state[p]["step"]) for p in plist}
    assert steps == {2}
    assert len({id(opt.state[p]["step"]) for p in plist}) == 1
    jp, jstate = _jax_run(jopt, init, grads[2:3], state=jstate, params=jp)
    _torch_run(opt, params, grads[2:3])
    for k, p in params.items():
        _close(p, jp[k])
