"""apex_tpu_torch.amp against apex_tpu.amp.

The loss scaler's trajectory over a seeded sequence of overflow flags
(hysteresis 1 and 3, growth interval 3, the clamps, a ``min_scale=``
floor) is compared with the JAX scaler's field by field, exactly: both
take the same fp32 and int32 steps.  The policies' fields, the O2 cast of
carried-over Llama and GPT weights (the same set of parameters kept fp32),
``amp.initialize`` and the checkpoints are held against the JAX package on
the same inputs; the JAX ``test_scaler.py`` and ``test_amp.py`` cases that
carry over are repeated on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu_torch import amp
from apex_tpu_torch.amp import LossScaler, static_loss_scaler

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}
_FIELDS = ("scale", "growth_tracker", "hysteresis_tracker", "unskipped")


def _same_state(port, jax_state):
    for f in _FIELDS:
        a, e = getattr(port, f), np.asarray(getattr(jax_state, f))
        assert a.dtype == (torch.float32 if f == "scale" else torch.int32), f
        assert a.item() == e.item(), (f, a.item(), e.item())


# ---------------------------------------------------------------------------
# the loss scaler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(init_scale=2.0 ** 16),
    dict(init_scale=2.0 ** 12, hysteresis=3),
    dict(init_scale=4.0, growth_interval=3),
    dict(init_scale=2.0, growth_interval=3, hysteresis=3, min_loss_scale=1.0,
         max_loss_scale=16.0),
    dict(init_scale=3.0, min_loss_scale=2.0, growth_interval=2),
    dict(init_scale=2.0 ** 23, growth_interval=1),
    dict(init_scale=8.0, dynamic=False),
], ids=["default", "hysteresis3", "growth3", "clamps", "floor", "max",
        "static"])
@pytest.mark.parametrize("min_scale", [None, 0.5, "tensor"])
def test_scaler_trajectory_matches_jax(cfg, min_scale):
    """60 updates over a seeded overflow sequence (runs of overflows and
    of clean steps) give the JAX scaler's state after every step, every
    field exactly; ``min_scale`` as a number or a 0-d tensor overrides the
    floor of a backoff."""
    rng = np.random.default_rng(7)
    flags = []
    while len(flags) < 60:
        flags += [bool(rng.random() < 0.4)] * int(rng.integers(1, 5))
    js, ts = JaxLossScaler(**cfg), LossScaler(**cfg)
    jst, tst = js.init(), ts.init("cpu")
    _same_state(tst, jst)
    for f in flags[:60]:
        if min_scale == "tensor":
            jkw, tkw = dict(min_scale=jnp.float32(0.25)), dict(
                min_scale=torch.tensor(0.25))
        elif min_scale is None:
            jkw = tkw = {}
        else:
            jkw = tkw = dict(min_scale=min_scale)
        jst = js.update(jst, jnp.asarray(f), **jkw)
        tst = ts.update(tst, torch.tensor(f), **tkw)
        _same_state(tst, jst)


def test_scaler_defaults_scale_and_unscale():
    s = LossScaler()
    st = s.init("cpu")
    assert float(st.scale) == 2.0 ** 16 and s.growth_interval == 2000
    assert s.backoff_factor == 0.5 and s.max_loss_scale == 2.0 ** 24
    s = LossScaler(init_scale=8.0)
    st = s.init("cpu")
    assert float(s.scale_loss(torch.tensor(2.0, dtype=torch.float16), st)) == 16.0
    assert s.scale_loss(torch.tensor(2.0, dtype=torch.float16), st).dtype == \
        torch.float32
    unscaled, found = s.unscale({"w": torch.full((4,), 8.0)}, st)
    assert torch.equal(unscaled["w"], torch.ones(4)) and not bool(found)


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_unscale_flags_inf_and_nan_like_jax(bad):
    """An inf or a NaN anywhere in the tree sets ``found_inf``; unscaling
    is in fp32 (a half gradient divided by 2**16 in its own precision
    would flush), the values as JAX's."""
    g = np.full((4,), 2e-3, np.float32)
    g2 = np.array([1.0, bad, 3.0], np.float32)
    js, ts = JaxLossScaler(), LossScaler()
    jtree = {"a": jnp.asarray(g, jnp.float16), "b": [jnp.asarray(g2)]}
    ttree = {"a": torch.from_numpy(g).half(), "b": [torch.from_numpy(g2)]}
    (ju, jf), (tu, tf) = js.unscale(jtree, js.init()), ts.unscale(
        ttree, ts.init("cpu"))
    assert bool(tf) and bool(jf)
    assert tu["a"].dtype == torch.float32 and float(tu["a"][0]) > 0.0
    np.testing.assert_array_equal(tu["a"].numpy(), np.asarray(ju["a"]))
    np.testing.assert_array_equal(tu["b"][0].numpy(), np.asarray(ju["b"][0]))
    clean = {"a": ttree["a"]}
    assert not bool(ts.has_overflow(clean))


def test_static_scaler_counts_unskipped_only():
    s = static_loss_scaler(128.0)
    st = s.init("cpu")
    st = s.update(st, torch.tensor(True))
    st = s.update(st, torch.tensor(False))
    assert float(st.scale) == 128.0 and int(st.unskipped) == 1
    assert not s.dynamic


def test_jax_state_dict_loads_into_the_port():
    """A state dict saved by the JAX scaler (numpy values, the same keys)
    loads into the port's, and the port's loads into the JAX one."""
    js = JaxLossScaler(hysteresis=2)
    jst = js.update(js.update(js.init(), jnp.asarray(True)), jnp.asarray(True))
    d = js.state_dict(jst)
    ts = LossScaler(hysteresis=2)
    tst = ts.load_state_dict(d, "cpu")
    _same_state(tst, jst)
    back = js.load_state_dict(ts.state_dict(tst))
    _same_state(tst, back)
    assert set(ts.state_dict(tst)) == set(d)


# ---------------------------------------------------------------------------
# policies and initialize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_policy_fields_match_jax(level, half):
    ours = amp.get_policy(level, half_dtype=half)
    ref = jamp.get_policy(level, half_dtype=_JNP[half])
    for f in ("opt_level", "keep_norm_fp32", "master_weights", "loss_scale"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("param_dtype", "compute_dtype", "output_dtype"):
        assert _JNP[getattr(ours, f)] == getattr(ref, f), f
    assert ours.make_scaler() == LossScaler(**{
        k: getattr(ref.make_scaler(), k) for k in (
            "init_scale", "growth_factor", "backoff_factor",
            "growth_interval", "hysteresis", "min_loss_scale",
            "max_loss_scale", "dynamic")})


def test_policy_overrides_and_bad_level():
    pol = amp.get_policy("O2", half_dtype=torch.float16, loss_scale=128.0,
                         master_weights=False)
    assert pol.loss_scale == 128.0 and not pol.master_weights
    assert pol.make_scaler() == static_loss_scaler(128.0)
    with pytest.raises(ValueError, match="O4"):
        amp.get_policy("O4")


def _dtypes_of(state_dict):
    return {k: v.dtype for k, v in state_dict.items()}


@pytest.mark.parametrize("level", ["O2", "O3"])
@pytest.mark.parametrize("half", [torch.float16, torch.bfloat16])
def test_cast_params_keeps_the_jax_fp32_set_on_llama(level, half):
    """The O2 cast by parameter name keeps in fp32 exactly the parameters
    the JAX cast keeps by tree path (the norm scales), on carried-over
    Llama weights; O3 halves them all."""
    from apex_tpu.models import LlamaConfig as JaxLlamaConfig
    from apex_tpu.models import LlamaForCausalLM as JaxLlama
    from apex_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                       llama_params_from_jax)

    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, max_position_embeddings=32)
    params = JaxLlama(JaxLlamaConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    jcast = jamp.get_policy(level, half_dtype=_JNP[half]).cast_params(params)
    model = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    model.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), model.config))
    amp.get_policy(level, half_dtype=half).cast_params(model)
    ref = _dtypes_of(llama_params_from_jax(jax.tree.map(np.asarray, jcast),
                                           model.config))
    assert {n: p.dtype for n, p in model.named_parameters()} == ref
    kept = {n for n, d in ref.items() if d == torch.float32}
    assert kept == ({n for n in ref if n.endswith("scale")}
                    if level == "O2" else set())


def test_cast_params_keeps_the_jax_fp32_set_on_gpt():
    """The same on carried-over GPT weights, which have biases: both casts
    halve the linear layers' biases and the position table and keep the
    LayerNorms' scales and biases fp32 (JAX's ``cast_params`` halves every
    floating leaf but the norm-like names, where ``bench.py``'s O2 cast
    halves only 2-d parameters)."""
    from apex_tpu.transformer.testing import GPTModel as JaxGPT
    from apex_tpu_torch.models import gpt_params_from_jax
    from apex_tpu_torch.transformer.testing import GPTModel

    cfg = dict(num_layers=2, hidden_size=64, num_attention_heads=2,
               vocab_size=128, max_sequence_length=16)
    params = JaxGPT(**cfg).init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 8), jnp.int32))
    jcast = jamp.O2(jnp.float16).cast_params(params)
    model = GPTModel(**cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray, params),
                                              cfg["num_layers"]))
    amp.O2(torch.float16).cast_params(model)
    ref = _dtypes_of(gpt_params_from_jax(jax.tree.map(np.asarray, jcast),
                                         cfg["num_layers"]))
    ours = {n: p.dtype for n, p in model.named_parameters()}
    assert ours == ref
    kept = {n for n, d in ours.items() if d == torch.float32}
    assert kept and all("layernorm" in n for n in kept)
    assert ours["language_model.transformer.layers.0.mlp.dense_h_to_4h.bias"] \
        == torch.float16


class _Affine(torch.nn.Module):
    """The JAX test_amp.py model: ``x @ w + b`` beside a norm-like scale."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, 3))
        self.b = torch.nn.Parameter(torch.zeros(3))
        self.norm_scale = torch.nn.Parameter(torch.ones(3))

    def forward(self, x, extra=None):
        out = x @ self.w + self.b
        return (out, {"n": extra}) if extra is not None else out


def test_initialize_levels_like_jax():
    """The JAX test_amp.py cases on the port: O0 leaves fp32, O2 halves
    all but the norm-like parameter and returns half outputs, O3 halves
    everything, fp16 gets the dynamic scaler at 2**16, bf16 the unit
    static one, ``loss_scale=`` overrides, O1 keeps the parameters fp32
    and installs its policy for ``amp.functional``."""
    x = torch.ones(2, 4)
    amped = amp.initialize(_Affine(), opt_level="O0")
    assert amped.model.module.w.dtype == torch.float32
    assert amped.model(x).dtype == torch.float32
    amped = amp.initialize(_Affine(), opt_level="O2")
    m = amped.model.module
    assert m.w.dtype == m.b.dtype == torch.bfloat16
    assert m.norm_scale.dtype == torch.float32 and amped.policy.master_weights
    assert amped.model(x).dtype == torch.bfloat16
    # floating inputs cast in (trees too), integer ones left, outputs out
    out, aux = amped.model(x, extra=[torch.ones(2), torch.arange(3)])
    assert out.dtype == aux["n"][0].dtype == torch.bfloat16
    assert aux["n"][1].dtype == torch.int64
    amped = amp.initialize(_Affine(), opt_level="O3")
    assert amped.model.module.norm_scale.dtype == torch.bfloat16
    amped = amp.initialize(_Affine(), opt_level="O2", half_dtype=torch.float16)
    assert amped.scaler.dynamic and float(amped.scaler_state.scale) == 2.0 ** 16
    assert amped.scaler_state.scale.device.type == "cpu"
    amped = amp.initialize(_Affine(), opt_level="O2")
    assert not amped.scaler.dynamic and float(amped.scaler_state.scale) == 1.0
    amped = amp.initialize(_Affine(), opt_level="O2", loss_scale=128.0)
    assert float(amped.scaler_state.scale) == 128.0
    # O1: fp32 parameters, half compute, and the policy installed for
    # amp.functional (removed again: it is process-wide)
    try:
        amped = amp.initialize(_Affine(), opt_level="O1")
        assert amped.model.module.w.dtype == torch.float32
        assert amped.policy.compute_dtype == torch.bfloat16
        assert amp.functional._current() is amped.policy
    finally:
        amp.set_active_policy(None)
    with pytest.raises(ValueError):
        amp.initialize(_Affine(), opt_level="O4")


def test_policy_casts_inputs_and_outputs():
    pol = amp.O2(torch.float16)
    a, b = pol.cast_inputs(torch.ones(2), torch.arange(2))
    assert a.dtype == torch.float16 and b.dtype == torch.int64
    assert pol.cast_inputs(torch.ones(2)).dtype == torch.float16
    out = pol.cast_output({"loss": torch.ones(2), "ids": torch.arange(2)})
    assert out["loss"].dtype == torch.float16 and out["ids"].dtype == torch.int64


def test_num_losses_and_state_dict_round_trip():
    """``num_losses=3`` gives three scaler states; ``amp.state_dict`` has
    the JAX package's keys and values, and a JAX one loads into the port."""
    amped = amp.initialize(_Affine(), opt_level="O2", half_dtype=torch.float16,
                           num_losses=3)
    assert len(amped.scaler_states) == 3
    states = list(amped.scaler_states)
    states[1] = amped.scaler.update(states[1], torch.tensor(True))
    amped.scaler_states = states
    d = amp.state_dict(amped)
    assert set(d) == {"loss_scaler0", "loss_scaler1", "loss_scaler2"}
    back = amp.load_state_dict(amp.initialize(
        _Affine(), opt_level="O2", half_dtype=torch.float16, num_losses=3), d)
    for a, b in zip(back.scaler_states, amped.scaler_states):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    jamped = jamp.initialize(lambda p, x: x, {"w": jnp.ones(2)},
                             opt_level="O2", half_dtype=jnp.float16,
                             num_losses=3)
    jamped = jamp.load_state_dict(jamped, d)
    jd = jamp.state_dict(jamped)
    assert set(jd) == set(d)
    back = amp.load_state_dict(amped, jd)
    for a, b in zip(back.scaler_states, jamped.scaler_states):
        _same_state(a, b)


def test_o2_fp16_step_with_the_scaler_matches_jax():
    """One amp O2 fp16 step of the JAX test_amp.py model under the dynamic
    scaler and ``FusedAdam(master_weights=True)``: the output cast to half
    before the loss, the loss scaled in fp32, the gradients unscaled by
    the optimizer; the parameters within one fp16 ulp, the masters at
    1e-6, the scaler states equal."""
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
    from apex_tpu_torch.optimizers import FusedAdam

    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)

    jparams = {"w": jnp.asarray(w), "b": jnp.zeros(3),
               "norm_scale": jnp.ones(3)}
    jamped = jamp.initialize(lambda p, a: a @ p["w"] * p["norm_scale"] + p["b"],
                             jparams, opt_level="O2", half_dtype=jnp.float16)
    jopt = JaxFusedAdam(lr=1e-2, master_weights=True)
    jst = jopt.init(jamped.params)
    sst = jamped.scaler_state

    def scaled(p):
        pred = jamped.apply(p, jnp.asarray(x))
        return jamped.scaler.scale_loss(
            jnp.mean((pred.astype(jnp.float32) - y) ** 2), sst)

    grads = jax.grad(scaled)(jamped.params)
    grads, jfound = jamped.scaler.unscale(grads, sst)
    jnew, jst = jopt.step(grads, jamped.params, jst, found_inf=jfound)
    sst = jamped.scaler.update(sst, jfound)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
            self.b = torch.nn.Parameter(torch.zeros(3))
            self.norm_scale = torch.nn.Parameter(torch.ones(3))

        def forward(self, a):
            return a @ self.w * self.norm_scale + self.b

    amped = amp.initialize(Model(), opt_level="O2", half_dtype=torch.float16)
    params = dict(amped.model.module.named_parameters())
    opt = FusedAdam(list(params.values()), lr=1e-2, master_weights=True)
    state = amped.scaler_state
    pred = amped.model(torch.from_numpy(x))
    loss = torch.mean((pred.float() - torch.from_numpy(y)) ** 2)
    amped.scaler.scale_loss(loss, state).backward()
    found = amped.scaler.has_overflow([p.grad for p in params.values()])
    opt.step(grad_scale=state.scale, found_inf=found)
    state = amped.scaler.update(state, found)
    _same_state(state, sst)
    for k, p in params.items():
        assert p.dtype == (torch.float32 if k == "norm_scale" else torch.float16)
        np.testing.assert_allclose(opt.state[p]["master_param"].numpy(),
                                   np.asarray(jst[1].master_params[k]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(jnew[k], np.float32),
                                   rtol=2.0 ** -10, atol=0)
