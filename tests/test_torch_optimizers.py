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
    for step in (1, 2, 10, 1000):
        bc1, bc2 = bias_corrections(step, 0.9, 0.999)
        t = np.float32(step)
        assert bc1 == float(np.float32(1) - np.float32(0.9) ** t)
        assert bc2 == float(np.float32(1) - np.float32(0.999) ** t)


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
    p = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)
    with pytest.raises(NotImplementedError, match=r"mixed-precision \(amp\) slice"):
        FusedAdam(p, master_weights=True)
    opt = FusedAdam(p)
    with pytest.raises(NotImplementedError, match=r"mixed-precision \(amp\) slice"):
        opt.step(grad_scale=torch.tensor(2.0))
    with pytest.raises(NotImplementedError, match=r"mixed-precision \(amp\) slice"):
        opt.step(found_inf=torch.tensor(False))
