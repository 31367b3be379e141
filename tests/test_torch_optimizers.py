"""apex_tpu_torch.optimizers.FusedAdam against apex_tpu.optimizers.FusedAdam.

The same numpy parameters and per-step gradients (fixed seeds) go through
the JAX optimizer (``init`` then ``step`` five times, new arrays each
step) and the port's (``torch.optim.Optimizer``, updated in place).  Both
compute the update in fp32, the port with fused in-place ops that regroup
the roundings: fp32 values compare at atol = rtol = 1e-6, and bf16 state
or parameters within one bf16 ulp of the larger magnitude, since a few
fp32 roundings apart can put a value on either side of a bf16 rounding
boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers._common import bias_corrections

_SHAPES = {"w": (4, 3), "b": (7,), "k": (2, 5, 3)}
_STEPS = 5


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(actual, expected, low_precision: bool):
    a = actual.float().numpy() if isinstance(actual, torch.Tensor) else actual
    e = _np(expected)
    if not low_precision:
        np.testing.assert_allclose(a, e, atol=1e-6, rtol=1e-6)
        return
    mag = np.maximum(np.maximum(np.abs(a), np.abs(e)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(a - e) <= ulp).all(), np.abs(a - e).max()


def _run_both(*, state_dtype, param_dtype, adam_w_mode, weight_decay,
              bias_correction):
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in _SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in _SHAPES.items()} for _ in range(_STEPS)]
    kw = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, adam_w_mode=adam_w_mode,
              weight_decay=weight_decay, bias_correction=bias_correction)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jopt = JaxFusedAdam(state_dtype=jdt[state_dtype], **kw)
    jparams = {k: jnp.asarray(v, jdt[param_dtype]) for k, v in init.items()}
    jstate = jopt.init(jparams)
    for g in grads:
        jparams, jstate = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                                    jparams, jstate)

    params = {k: torch.nn.Parameter(torch.from_numpy(v).to(param_dtype))
              for k, v in init.items()}
    opt = FusedAdam(list(params.values()), state_dtype=state_dtype, **kw)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k]).to(param_dtype)
        opt.step()
    return params, opt, jparams, jstate


@pytest.mark.parametrize("bias_correction", [True, False],
                         ids=["bc", "no_bc"])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_state", "bf16_state"])
def test_five_steps_match_jax(state_dtype, adam_w_mode, bias_correction):
    """Parameters and both moments after 5 steps, with weight decay in
    AdamW (decoupled) and L2 (into the gradient) modes, with and without
    bias correction, fp32 and bf16 moments."""
    params, opt, jparams, jstate = _run_both(
        state_dtype=state_dtype, param_dtype=torch.float32,
        adam_w_mode=adam_w_mode, weight_decay=0.01,
        bias_correction=bias_correction)
    low = state_dtype == torch.bfloat16
    inner = jstate[0]
    assert int(inner.step) == _STEPS
    for k, p in params.items():
        st = opt.state[p]
        assert st["step"] == _STEPS
        assert st["exp_avg"].dtype == state_dtype
        _close(st["exp_avg"], inner.exp_avg[k], low)
        _close(st["exp_avg_sq"], inner.exp_avg_sq[k], low)
        _close(p.detach(), jparams[k], False)


def test_bf16_parameters_and_moments_match_jax():
    """The O2 case of bench.py's llama-1b card: bf16 parameters, bf16
    moments, the update in fp32 and stored back in bf16."""
    params, opt, jparams, jstate = _run_both(
        state_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        adam_w_mode=True, weight_decay=0.0, bias_correction=True)
    for k, p in params.items():
        assert p.dtype == torch.bfloat16
        _close(p.detach(), jparams[k], True)


def test_bias_corrections_in_fp32():
    """From the int32 step tensor the optimizers keep on the device, as
    the JAX function computes them from its int32 step."""
    for step in (1, 2, 10, 1000):
        bc1, bc2 = bias_corrections(torch.tensor(step, dtype=torch.int32),
                                    0.9, 0.999)
        assert bc1.dtype == bc2.dtype == torch.float32
        t = np.float32(step)
        assert float(bc1) == float(np.float32(1) - np.float32(0.9) ** t)
        assert float(bc2) == float(np.float32(1) - np.float32(0.999) ** t)


def test_state_is_updated_in_place_and_gradless_parameters_skipped():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2))
    opt = FusedAdam([p, q], lr=0.1)
    p.grad = torch.ones(3)
    data = p.data_ptr()
    opt.step()
    m = opt.state[p]["exp_avg"]
    opt.step()
    assert p.data_ptr() == data and opt.state[p]["exp_avg"] is m
    assert opt.state[p]["step"] == 2
    assert q not in opt.state and torch.equal(q.detach(), torch.ones(2))


def test_closure_returns_its_loss():
    p = torch.nn.Parameter(torch.tensor([2.0]))
    opt = FusedAdam([p], lr=0.1)

    def closure():
        opt.zero_grad()
        loss = (p * p).sum()
        loss.backward()
        return loss

    assert float(opt.step(closure).detach()) == 4.0
    assert float(p.detach()) < 2.0


def test_unsupported_options_raise():
    """AMSGrad raises, as in the JAX class; master weights and the step's
    grad_scale / found_inf are taken (the parity tests of the amp slice
    hold them against JAX)."""
    p = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)


# ---------------------------------------------------------------------------
# master weights and the capturable step (the amp slice)
# ---------------------------------------------------------------------------

_HALF = {torch.bfloat16: (jnp.bfloat16, 7), torch.float16: (jnp.float16, 10)}
_SCALE = 1024.0          # the loss scale the gradients carry
_SKIP = 2                # the step whose gradients hold an inf


def _close_half(actual, expected, dtype):
    """Within one ulp of ``dtype`` at the larger magnitude: the masters
    agree to fp32 rounding, which can put a cast on either side of a
    rounding boundary."""
    a = actual.float().numpy()
    e = _np(expected)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(e)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - _HALF[dtype][1])
    assert (np.abs(a - e) <= ulp).all(), np.abs(a - e).max()


def _amp_inputs(p_dtype):
    """Initial parameters and 5 steps of gradients scaled by _SCALE, each
    exactly representable in ``p_dtype``; step _SKIP's hold an inf."""
    jdt = _HALF[p_dtype][0]
    rng = np.random.default_rng(3)
    rep = lambda a: _np(jnp.asarray(a, jdt)).copy()
    init = {k: rep(rng.standard_normal(s).astype(np.float32))
            for k, s in sorted(_SHAPES.items())}
    grads = [{k: rep(rng.standard_normal(s).astype(np.float32) * 0.1 * _SCALE)
              for k, s in sorted(_SHAPES.items())} for _ in range(_STEPS)]
    grads[_SKIP]["w"][1, 2] = np.inf
    return init, grads


def _run_amp(p_dtype, jopt, opt_cls, **kw):
    """The JAX optimizer and the port's over the same half parameters,
    each step given the scaled gradients, ``grad_scale`` and
    ``found_inf``.  The port's skipped step must leave every parameter,
    master, state tensor and the step counter bit for bit."""
    init, grads = _amp_inputs(p_dtype)
    jdt = _HALF[p_dtype][0]
    jparams = {k: jnp.asarray(v, jdt) for k, v in init.items()}
    jstate = jopt.init(jparams)
    for i, g in enumerate(grads):
        jparams, jstate = jopt.step(
            {k: jnp.asarray(v, jdt) for k, v in g.items()}, jparams, jstate,
            grad_scale=jnp.float32(_SCALE), found_inf=jnp.asarray(i == _SKIP))

    params = {k: torch.nn.Parameter(torch.from_numpy(v).to(p_dtype))
              for k, v in init.items()}
    opt = opt_cls(list(params.values()), master_weights=True, **kw)
    for i, g in enumerate(grads):
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k]).to(p_dtype)
        before = [t.clone() for t in _all_tensors(opt, params)]
        opt.step(grad_scale=torch.tensor(_SCALE),
                 found_inf=torch.tensor(i == _SKIP))
        if i == _SKIP:
            after = _all_tensors(opt, params)
            assert all(torch.equal(a, b) for a, b in zip(after, before))
    return params, opt, jparams, jstate


def _all_tensors(opt, params):
    out = list(params.values())
    for p in params.values():
        out += [v for v in opt.state[p].values() if isinstance(v, torch.Tensor)]
    return out


def _check_masters_and_params(params, opt, jparams, jstate, p_dtype,
                              rtol=1e-6):
    masters = jstate[1].master_params
    for k, p in params.items():
        assert p.dtype == p_dtype
        st = opt.state[p]
        assert st["master_param"].dtype == torch.float32
        np.testing.assert_allclose(st["master_param"].numpy(), _np(masters[k]),
                                   atol=1e-6, rtol=rtol)
        # the parameter is its master cast, in both packages
        assert torch.equal(p.detach(), st["master_param"].to(p_dtype))
        _close_half(p.detach(), jparams[k], p_dtype)
    step = opt.state[next(iter(params.values()))]["step"]
    assert int(step) == int(jstate[0].step) == _STEPS - 1


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
def test_master_weights_and_skipped_step_match_jax(p_dtype, adam_w_mode):
    """FusedAdam(master_weights=True) over bf16 and fp16 parameters, five
    steps of scaled gradients with ``grad_scale`` and ``found_inf`` (the
    third holds an inf and is skipped), against the JAX step: fp32
    masters and moments at atol = rtol = 1e-6 (the port regroups the fp32
    roundings), the parameters within one ulp of their dtype, the step
    counter at 4 in both."""
    kw = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, adam_w_mode=adam_w_mode,
              weight_decay=0.01)
    params, opt, jparams, jstate = _run_amp(
        p_dtype, JaxFusedAdam(master_weights=True, **kw), FusedAdam, **kw)
    _check_masters_and_params(params, opt, jparams, jstate, p_dtype)
    for k, p in params.items():
        _close(opt.state[p]["exp_avg"], jstate[0].exp_avg[k], False)
        _close(opt.state[p]["exp_avg_sq"], jstate[0].exp_avg_sq[k], False)


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_fused_lamb_master_weights_and_skipped_step_match_jax(p_dtype, packed,
                                                              monkeypatch):
    """FusedLAMB(master_weights=True), unpacked and packed (the JAX packed
    path's Pallas phase 1 in interpret mode), as above: the clip factor
    and trust ratios of the skipped step are computed and not applied.
    Masters and moments at atol 1e-6, rtol 1e-5 (the trust ratio divides
    two norms summed in another order)."""
    from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
    from apex_tpu_torch.optimizers import FusedLAMB

    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    kw = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
              max_grad_norm=1.0, packed=packed)
    params, opt, jparams, jstate = _run_amp(
        p_dtype, JaxFusedLAMB(master_weights=True, **kw), FusedLAMB, **kw)
    _check_masters_and_params(params, opt, jparams, jstate, p_dtype,
                              rtol=1e-5)
    first = opt.state[next(iter(params.values()))]
    for name in ("exp_avg", "exp_avg_sq"):
        if packed:
            np.testing.assert_allclose(first[name].numpy(),
                                       _np(getattr(jstate[0], name)),
                                       atol=1e-6, rtol=1e-5)
        else:
            for k, p in params.items():
                np.testing.assert_allclose(
                    opt.state[p][name].numpy(),
                    _np(getattr(jstate[0], name)[k]), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("adagrad_w_mode", [False, True], ids=["l2", "w"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_fused_adagrad_matches_jax(p_dtype, adagrad_w_mode, packed,
                                   monkeypatch):
    """FusedAdagrad(master_weights=True), unpacked and packed (the JAX
    packed path's Pallas ``_adagrad_kernel`` in interpret mode), both
    modes, weight decay 0.01, as above.  The JAX class applies
    ``found_inf`` after its update (``apply_if_finite``); the port's packed
    path hands it to the kernel as ``noop``: the skipped step's bits and
    the trajectory show the two agree.  h and the masters at atol = rtol =
    1e-6 (the same expressions in fp32)."""
    from apex_tpu.optimizers import FusedAdagrad as JaxFusedAdagrad
    from apex_tpu_torch.optimizers import FusedAdagrad

    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.01,
              adagrad_w_mode=adagrad_w_mode, packed=packed)
    params, opt, jparams, jstate = _run_amp(
        p_dtype, JaxFusedAdagrad(master_weights=True, **kw), FusedAdagrad, **kw)
    _check_masters_and_params(params, opt, jparams, jstate, p_dtype)
    if packed:
        np.testing.assert_allclose(
            opt.state[next(iter(params.values()))]["sum_sq"].numpy(),
            _np(jstate[0].sum_sq), atol=1e-6, rtol=1e-6)
    else:
        for k, p in params.items():
            np.testing.assert_allclose(opt.state[p]["sum_sq"].numpy(),
                                       _np(jstate[0].sum_sq[k]), atol=1e-6,
                                       rtol=1e-6)


def test_fused_adagrad_without_masters_matches_jax():
    """FusedAdagrad over fp32 parameters with no scale and no flag (the
    plain JAX step), 5 steps, unpacked: the same expressions in fp32."""
    from apex_tpu.optimizers import FusedAdagrad as JaxFusedAdagrad
    from apex_tpu_torch.optimizers import FusedAdagrad

    rng = np.random.default_rng(4)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(_SHAPES.items())}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in sorted(_SHAPES.items())} for _ in range(_STEPS)]
    jopt = JaxFusedAdagrad(lr=0.1, weight_decay=0.01)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = FusedAdagrad(list(params.values()), lr=0.1, weight_decay=0.01)
    for g in grads:
        jparams, jstate = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                                    jparams, jstate)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), _np(jparams[k]),
                                   atol=1e-6, rtol=1e-6)
        assert "master_param" not in opt.state[p]


def test_jax_state_loads_and_the_next_step_matches():
    """The JAX FusedAdam state after two master-weight steps (moments,
    step, masters) carried into the port by
    ``models.convert.load_jax_optimizer_state``; one more step on each
    side agrees as the five-step trajectories do."""
    from apex_tpu_torch.models.convert import load_jax_optimizer_state

    init, grads = _amp_inputs(torch.bfloat16)
    kw = dict(lr=1e-2, weight_decay=0.01)
    jopt = JaxFusedAdam(master_weights=True, **kw)
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in init.items()}
    jstate = jopt.init(jparams)
    for g in grads[:2]:
        jparams, jstate = jopt.step(
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, jparams,
            jstate, grad_scale=jnp.float32(_SCALE))
    params = {k: torch.nn.Parameter(_np_to_torch(jparams[k]))
              for k in init}
    opt = FusedAdam(list(params.values()), master_weights=True, **kw)
    load_jax_optimizer_state(opt, params, jax.tree.map(np.asarray, jstate))
    st = opt.state[params["w"]]
    assert int(st["step"]) == 2 and st["step"] is opt.state[params["b"]]["step"]
    g = grads[3]
    jparams, jstate = jopt.step(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, jparams,
        jstate, grad_scale=jnp.float32(_SCALE))
    for k, p in params.items():
        p.grad = torch.from_numpy(g[k]).to(torch.bfloat16)
    opt.step(grad_scale=torch.tensor(_SCALE))
    for k, p in params.items():
        np.testing.assert_allclose(opt.state[p]["master_param"].numpy(),
                                   _np(jstate[1].master_params[k]),
                                   atol=1e-6, rtol=1e-6)
        _close(opt.state[p]["exp_avg"], jstate[0].exp_avg[k], False)
        _close_half(p.detach(), jparams[k], torch.bfloat16)


def _np_to_torch(a):
    from apex_tpu_torch.models.convert import _tensor

    return _tensor(np.asarray(a))


def test_state_dict_round_trip_keeps_fp32_state_and_one_step():
    """``load_state_dict`` keeps the fp32 masters and moments beside bf16
    parameters (torch alone would cast them to the parameters' dtype) and
    makes the group's step one shared tensor again."""
    init, grads = _amp_inputs(torch.bfloat16)
    make = lambda: {k: torch.nn.Parameter(torch.from_numpy(v).bfloat16())
                    for k, v in init.items()}
    params = make()
    opt = FusedAdam(list(params.values()), master_weights=True)
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[0][k]).bfloat16()
    opt.step(grad_scale=torch.tensor(_SCALE))
    params2 = make()
    opt2 = FusedAdam(list(params2.values()), master_weights=True)
    opt2.load_state_dict(opt.state_dict())
    steps = {id(opt2.state[p]["step"]) for p in params2.values()}
    assert len(steps) == 1
    for (k, p), p2 in zip(params.items(), params2.values()):
        for key in ("master_param", "exp_avg", "exp_avg_sq", "step"):
            a, b = opt.state[p][key], opt2.state[p2][key]
            assert a.dtype == b.dtype and torch.equal(a, b), (k, key)


def test_host_found_inf_flag():
    """A Python ``found_inf`` works as a host-side flag: True changes
    nothing, False is an ordinary step."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = FusedAdam([p], lr=0.1)
    p.grad = torch.ones(3)
    opt.step(found_inf=True)
    assert torch.equal(p.detach(), torch.ones(3)) and not opt.state[p]
    opt.step(found_inf=False)
    assert (p.detach() < 1).all() and int(opt.state[p]["step"]) == 1


def test_is_half_and_master_copy_like_jax():
    """``is_half`` names the two half types, as the JAX helper does, and
    ``master_copy`` gives an fp32 copy that never aliases an fp32
    parameter (the JAX ``jnp.copy`` before the cast)."""
    from apex_tpu.optimizers._common import is_half as jax_is_half
    from apex_tpu_torch.optimizers._common import is_half, master_copy

    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16)):
        assert is_half(torch.zeros(1, dtype=tdt)) == jax_is_half(
            jnp.zeros(1, jdt))
    p = torch.nn.Parameter(torch.ones(3))
    m = master_copy(p)
    assert m.dtype == torch.float32 and m.data_ptr() != p.data_ptr()
    assert not m.requires_grad and torch.equal(m, p.detach())
