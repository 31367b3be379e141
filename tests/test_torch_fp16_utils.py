"""apex_tpu_torch.fp16_utils against apex_tpu.fp16_utils.

``FP16Optimizer`` around ``FusedAdam`` takes 4 steps in both packages from
the same fp16 parameters and gradients, the second step's gradients
holding an inf: the skipped step, the scaler's backoff and the masters,
moments and parameters after the steps are held against the JAX wrapper
(fp32 values at atol = rtol = 1e-6, as the FusedAdam parity tests: the
port's Adam regroups the fp32 roundings; fp16 parameters within one fp16
ulp).  The helpers are compared on the same trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu import fp16_utils as jfp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import fp16_utils as tfp
from apex_tpu_torch.optimizers import FusedAdam

_SHAPES = {"b": (7,), "k": (2, 5, 3), "w": (4, 3)}


def _inputs(steps=4, bad_step=1):
    rng = np.random.default_rng(11)
    half = lambda a: np.asarray(jnp.asarray(a, jnp.float16), np.float32).copy()
    init = {k: half(rng.standard_normal(s)) for k, s in _SHAPES.items()}
    grads = [{k: half(rng.standard_normal(s) * 100.0)
              for k, s in _SHAPES.items()} for _ in range(steps)]
    grads[bad_step]["k"][0, 1, 2] = np.inf
    return init, grads


def _close_fp16(actual, expected):
    a = actual.float().numpy()
    e = np.asarray(expected, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(e)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 10)
    assert (np.abs(a - e) <= ulp).all(), np.abs(a - e).max()


def _port(init):
    params = {k: torch.nn.Parameter(torch.from_numpy(v).half())
              for k, v in init.items()}
    return params, tfp.FP16Optimizer(
        FusedAdam(list(params.values()), lr=1e-2, weight_decay=0.01))


def _port_step(params, opt, g):
    opt.zero_grad()
    for k, p in params.items():
        p.grad = torch.from_numpy(g[k]).half()
    return opt.step()


def test_fp16_optimizer_matches_jax_over_an_overflow():
    init, grads = _inputs()
    jopt = jfp.FP16Optimizer(JaxFusedAdam(lr=1e-2, weight_decay=0.01))
    jparams = {k: jnp.asarray(v, jnp.float16) for k, v in init.items()}
    jst = jopt.init(jparams)
    for g in grads:
        jparams, jst = jopt.step({k: jnp.asarray(v, jnp.float16)
                                  for k, v in g.items()}, jparams, jst)

    params, opt = _port(init)
    for i, g in enumerate(grads):
        before = [m.clone() for m in opt.master_params]
        found = _port_step(params, opt, g)
        assert bool(found) == (i == 1)
        if i == 1:     # the skipped step left every master as it was
            assert all(torch.equal(a, b)
                       for a, b in zip(before, opt.master_params))
    sst = opt.scaler_state
    assert float(sst.scale) == float(jst.scaler_state.scale) == 2.0 ** 15
    assert int(sst.unskipped) == int(jst.scaler_state.unskipped) == 3
    for k, m, p in zip(_SHAPES, opt.master_params, params.values()):
        np.testing.assert_allclose(m.detach().numpy(),
                                   np.asarray(jst.master_params[k]),
                                   atol=1e-6, rtol=1e-6)
        st = opt.optimizer.state[m]
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(jst.inner_state[0].exp_avg[k]),
                                   atol=1e-6, rtol=1e-6)
        assert int(st["step"]) == int(jst.inner_state[0].step) == 3
        assert p.dtype == torch.float16
        _close_fp16(p.detach(), jparams[k])


def test_fp16_optimizer_state_dict_resumes_the_same_trajectory():
    """``state_dict`` (masters, inner state, scaler) into a fresh wrapper
    over other parameters; one more step on each gives the same bits."""
    init, grads = _inputs()
    params, opt = _port(init)
    for g in grads[:3]:
        _port_step(params, opt, g)
    d = opt.state_dict()
    assert set(d) == {"master_params", "optimizer_state_dict", "scaler"}
    params2, opt2 = _port({k: np.zeros_like(v) for k, v in init.items()})
    opt2.load_state_dict(d)
    for p, q in zip(params.values(), params2.values()):
        assert torch.equal(p, q)
    _port_step(params, opt, grads[3])
    _port_step(params2, opt2, grads[3])
    for a, b in zip(opt.master_params, opt2.master_params):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in
               zip(opt.scaler_state, opt2.scaler_state))


def test_helpers_match_jax():
    init, grads = _inputs()
    tree = {k: jnp.asarray(v) for k, v in init.items()}

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in init.items():
                setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    model = tfp.network_to_half(M(), torch.float16)
    jhalf = jfp.network_to_half(tree, jnp.float16)
    for k, p in model.named_parameters():
        assert p.dtype == torch.float16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(jhalf[k], np.float32))
    model_params, masters = tfp.prep_param_lists(model)
    assert len(model_params) == len(masters) == len(init)
    for p, m in zip(model_params, masters):
        assert m.dtype == torch.float32 and m.requires_grad and m.is_leaf
        assert m.data_ptr() != p.data_ptr()
        assert torch.equal(m, p.detach().float())
    # an fp32 parameter's master is a copy too, never the parameter itself
    p32 = torch.nn.Parameter(torch.ones(2))
    (_, (m32,)) = tfp.prep_param_lists([p32])
    assert m32.data_ptr() != p32.data_ptr()

    jmasters = {k: jnp.asarray(v) * 1.5 for k, v in init.items()}
    back = tfp.master_params_to_model_params(
        {k: torch.from_numpy(v * 1.5) for k, v in init.items()},
        dict(model.named_parameters()))
    jback = jfp.master_params_to_model_params(jmasters, jhalf)
    for k in init:
        assert back[k].dtype == torch.float16
        np.testing.assert_array_equal(back[k].float().numpy(),
                                      np.asarray(jback[k], np.float32))
    g32 = tfp.model_grads_to_master_grads(
        {k: torch.from_numpy(v).half() for k, v in grads[0].items()})
    jg32 = jfp.model_grads_to_master_grads(
        {k: jnp.asarray(v, jnp.float16) for k, v in grads[0].items()})
    for k in init:
        assert g32[k].dtype == torch.float32
        np.testing.assert_array_equal(g32[k].numpy(), np.asarray(jg32[k]))
    jax.block_until_ready(jg32)


def test_static_scale_wrapper():
    params, _ = _port(_inputs()[0])
    opt = tfp.FP16Optimizer(FusedAdam(list(params.values())),
                            static_loss_scale=128.0, dynamic_loss_scale=False)
    assert float(opt.scale_loss(torch.tensor(1.0))) == 128.0
    assert not opt.scaler.dynamic
