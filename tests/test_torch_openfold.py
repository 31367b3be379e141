"""apex_tpu_torch.contrib.openfold_triton against
apex_tpu.contrib.openfold_triton.

The same numpy inputs and weights (fixed seeds) go through the JAX
functions and the port's on the CPU.  Where the JAX ``attention_core``
routes to its Pallas pair-bias kernels (the 5-D MSA-row layout at s >=
1024), they run in interpret mode (``APEX_TPU_KERNELS=interpret``).
Tolerances, fp32: the materialized route at ``atol = rtol = 1e-5`` (one
softmax over 128 keys on both sides, summed in another order); the routed
one at ``2e-5`` (forward) and ``2e-4`` (gradients), the JAX pair-bias
test's figures; the MSA-row block's loss at ``rtol 1e-5`` and each
gradient within ``2e-4`` of its largest entry (a LayerNorm, five linears
and the attention between loss and weight; the pair LayerNorm's bias,
whose gradient is zero in exact arithmetic, below ``1e-5`` of the pair
linear's); ``FusedAdamSWA``'s fp32 state
at ``rtol 1e-6, atol 1e-7`` (the same expressions in the same order; pow,
sqrt and division may round one ulp apart) and its bf16 parameters within
one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu.contrib import openfold_triton as jof
from apex_tpu_torch.contrib import openfold_triton as tof


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    yield


def _attn_inputs(shape, bias_shape, mask_shape, seed, dead=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * 0.3
               for _ in range(3))
    bias = rng.standard_normal(bias_shape).astype(np.float32) * 0.3
    mask = rng.random(mask_shape) > 0.1
    if dead is not None:
        mask[dead] = False
    do = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, bias, mask, do


def _graph_names(t, depth=6):
    """The autograd node names within ``depth`` steps of ``t``."""
    names, frontier = set(), [t.grad_fn]
    for _ in range(depth):
        names |= {type(f).__name__ for f in frontier}
        frontier = [n for f in frontier for n, _ in f.next_functions
                    if n is not None]
    return names


def _both(q, k, v, bias, mask, do):
    """``attention_core`` output and grads (q, k, v, bias) on both sides."""
    jm = jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q, k, v, b: jof.attention_core(q, k, v, jm, b),
                       *(jnp.asarray(a) for a in (q, k, v, bias)))
    jg = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    o = tof.attention_core(*ts[:3], torch.from_numpy(mask), ts[3])
    o.backward(torch.from_numpy(do))
    return (np.asarray(out), jg), (o.detach().numpy(),
                                   [t.grad.numpy() for t in ts]), o


@pytest.mark.parametrize("layout", ["4d", "5d"])
def test_attention_core_materialized_route_matches_jax(layout):
    """4-D and 5-D inputs at s = 128 take the materialized route on both
    sides; in the 5-D case MSA row 1 is fully masked, and both give it
    the uniform average of v (softmax over a -inf fill)."""
    if layout == "4d":
        args = _attn_inputs((2, 4, 128, 16), (2, 4, 128, 128), (2, 1, 1, 128),
                            seed=0)
    else:
        args = _attn_inputs((1, 3, 2, 128, 8), (1, 1, 2, 128, 128),
                            (1, 3, 1, 1, 128), seed=1, dead=(0, 1))
    (jo, jg), (to, tg), o = _both(*args)
    assert not any("PairBias" in n for n in _graph_names(o))
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)
    if layout == "5d":
        v = args[2]
        uniform = np.broadcast_to(v[0, 1].mean(axis=-2, keepdims=True),
                                  v[0, 1].shape)
        np.testing.assert_allclose(to[0, 1], uniform, atol=1e-6)


def test_attention_core_routed_matches_jax():
    """The 5-D MSA-row layout at s = 1024 (r 2, h 1, d 8) goes to the
    pair-bias kernel on both sides (the JAX one in interpret mode, the
    port's plain version here): forward and the gradients of q, k, v and
    the bias.  The kernel's own semantics show on a fully masked MSA row:
    zeros, with zero gradients."""
    args = _attn_inputs((1, 2, 1, 1024, 8), (1, 1, 1, 1024, 1024),
                        (1, 2, 1, 1, 1024), seed=2, dead=(0, 1))
    (jo, jg), (to, tg), o = _both(*args)
    assert any("PairBias" in n for n in _graph_names(o))
    np.testing.assert_allclose(to, jo, atol=2e-5, rtol=2e-5)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=name)
    np.testing.assert_array_equal(to[0, 1], 0.0)
    np.testing.assert_array_equal(tg[0][0, 1], 0.0)


def test_routing_condition_is_the_jax_one():
    """``_route_pair_bias`` takes exactly what the JAX one takes."""
    def routes(shape, bias_shape, mask_shape):
        q = torch.zeros(shape)
        bias = torch.zeros(bias_shape)
        mask = None if mask_shape is None else torch.ones(mask_shape)
        return tof._route_pair_bias(q, q, q, mask, bias) is not None

    s = 1024
    assert routes((1, 2, 1, s, 8), (1, 1, 1, s, s), (1, 2, 1, 1, s))
    assert routes((1, 2, 1, s, 8), (1, 1, 1, s, s), None)
    assert not routes((1, 2, 1, 512, 8), (1, 1, 1, 512, 512), None)
    assert not routes((1, 2, 1, s, 12), (1, 1, 1, s, s), None)
    assert not routes((1, 2, 1, 1152 + 8, 8), (1, 1, 1, 1160, 1160), None)
    assert not routes((1, 2, 1, s, 8), (1, 2, 1, s, s), None)
    assert not routes((1, 2, 1, s, 8), (1, 1, 1, s, s), (1, 2, 1, s, s))
    assert not routes((2, 1, s, 8), (2, 1, s, s), None)


def test_layer_norm_small_shape_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 3, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    ref = jof.LayerNormSmallShapeOptImpl.apply(
        jnp.asarray(x), (32,), jnp.asarray(w), jnp.asarray(b))
    y = tof.LayerNormSmallShapeOptImpl.apply(
        torch.from_numpy(x), (32,), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_small_names():
    assert tof.CanSchTriMHA([1, 256, 4, 256, 16])
    assert tof.CanSchTriMHA([1, 128, 8, 1024, 32], has_bias=False)
    assert tof.AttnBiasJIT is tof.attention_core
    assert tof.AttnNoBiasJIT is tof.attention_core
    assert tof.sync_triton_auto_tune_cache_across_gpus() is None
    assert [m.value for m in tof.AdamMathType] == \
        [m.value for m in jof.AdamMathType]


# ---------------------------------------------------------------------------
# FusedAdamSWA
# ---------------------------------------------------------------------------


def _swa_run_jax(mode, params, grads, scale, skip, **kw):
    opt = jof.FusedAdamSWA(adam_math_mode=jof.AdamMathType[mode], **kw)
    ps = [jnp.asarray(p) for p in params]
    state = opt.init(ps)
    for g, sk in zip(grads, skip):
        ps, state = opt.step([jnp.asarray(x) for x in g], ps, state,
                             grad_scale=jnp.float32(scale),
                             found_inf=jnp.asarray(sk))
    return ps, state, opt.swa_state_dict(state)


def _swa_run_torch(mode, params, grads, scale, skip, **kw):
    ps = [torch.from_numpy(p.astype(np.float32)).to(dt) for p, dt in params]
    opt = tof.FusedAdamSWA(ps, adam_math_mode=tof.AdamMathType[mode], **kw)
    for g, sk in zip(grads, skip):
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x).to(p.dtype)
        opt.step(grad_scale=torch.tensor(scale), found_inf=torch.tensor(sk))
    return ps, opt, opt.swa_state_dict()


@pytest.mark.parametrize("mode", ["ApexAdam", "ApexAdamW", "PyTorchAdam"])
def test_fused_adam_swa_matches_jax(mode):
    """Five steps of each math mode, a bf16 weight (updated through its
    fp32 master) and an fp32 bias, gradients scaled by 1024 and unscaled
    by ``grad_scale``, the third step skipped by ``found_inf``, the average
    starting after step 1: parameters, moments, masters, the SWA average,
    ``step`` and ``n_averaged`` against the JAX ``FusedAdamSWA``."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    w_bf16 = np.asarray(jnp.asarray(w, jnp.bfloat16))
    scale = 1024.0
    grads = [[(rng.standard_normal((6, 5)) * scale).astype(np.float32),
              (rng.standard_normal(5) * scale).astype(np.float32)]
             for _ in range(5)]
    # the bf16 weight's gradient arrives in bf16 on both sides
    grads = [[np.asarray(jnp.asarray(g[0], jnp.bfloat16)).astype(np.float32),
              g[1]] for g in grads]
    skip = [False, False, True, False, False]
    kw = dict(lr=1e-2, weight_decay=0.01, swa_decay_rate=0.8,
              swa_start_step=1)
    jps, jstate, jswa = _swa_run_jax(
        mode, [w_bf16, b], [[jnp.asarray(g[0], jnp.bfloat16), g[1]]
                            for g in grads], scale, skip, **kw)
    tps, opt, tswa = _swa_run_torch(
        mode, [(w_bf16.astype(np.float32), torch.bfloat16),
               (b, torch.float32)], grads, scale, skip, **kw)
    assert tps[0].dtype == torch.bfloat16
    f32 = dict(rtol=1e-6, atol=1e-7)
    for i, p in enumerate(tps):
        st = opt.state[p]
        assert int(st["step"]) == int(jstate.step) == 4
        assert int(st["n_averaged"]) == int(jstate.n_averaged) == 3
        for key, ref in (("exp_avg", jstate.exp_avg[i]),
                         ("exp_avg_sq", jstate.exp_avg_sq[i]),
                         ("state_params", jstate.state_params[i]),
                         ("swa_params", jstate.swa_params[i])):
            np.testing.assert_allclose(st[key].numpy(), np.asarray(ref),
                                       err_msg=key, **f32)
        np.testing.assert_allclose(tswa[i].numpy(), np.asarray(jswa[i]), **f32)
    ulp = 2.0 ** -7 * np.abs(np.asarray(jps[0], np.float32))
    assert (np.abs(tps[0].float().numpy() - np.asarray(jps[0], np.float32))
            <= ulp).all()
    np.testing.assert_allclose(tps[1].numpy(), np.asarray(jps[1]), **f32)


def test_fused_adam_swa_skip_leaves_everything():
    """A step under a true ``found_inf`` changes nothing, the step count
    included, and reads no flag on the host."""
    p = torch.nn.Parameter(torch.randn(4, 3))
    opt = tof.FusedAdamSWA([p], lr=0.1)
    p.grad = torch.randn(4, 3)
    opt.step()
    before = {k: v.clone() for k, v in opt.state[p].items()}
    value = p.detach().clone()
    p.grad = torch.full((4, 3), float("inf"))
    opt.step(found_inf=torch.tensor(True))
    assert torch.equal(p.detach(), value)
    for k, v in opt.state[p].items():
        assert torch.equal(v, before[k]), k
    assert opt.swa_state_dict()[0].dtype == torch.float32


def test_fused_adam_swa_one_counter_per_group_with_a_late_gradient():
    """``step`` and ``n_averaged`` are one tensor a group, shared by its
    parameters' states, as the JAX state holds one for the tree.  A bias
    whose first gradient comes at step 3 takes the group's counters: on the
    JAX side the tree grows from ``[w]`` to ``[w, b]`` after two steps, the
    bias's moments zero and its master and average its fp32 copy.  3 steps
    of ApexAdamW against the JAX class."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    gw = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(3)]
    gb = rng.standard_normal(5).astype(np.float32)
    kw = dict(lr=1e-2, weight_decay=0.01, swa_decay_rate=0.8,
              adam_math_mode=jof.AdamMathType.ApexAdamW)
    jopt = jof.FusedAdamSWA(**kw)
    ps = [jnp.asarray(w)]
    state = jopt.init(ps)
    for g in gw[:2]:
        ps, state = jopt.step([jnp.asarray(g)], ps, state)
    jb = jnp.asarray(b)
    zeros = jnp.zeros_like(jb)
    state = type(state)(state.step, state.n_averaged,
                             state.exp_avg + [zeros], state.exp_avg_sq + [zeros],
                             state.swa_params + [jb], state.state_params + [jb])
    ps, state = jopt.step([jnp.asarray(gw[2]), jnp.asarray(gb)], ps + [jb],
                          state)

    tw, tb = (torch.nn.Parameter(torch.from_numpy(a.copy())) for a in (w, b))
    opt = tof.FusedAdamSWA([tw, tb], **dict(kw, adam_math_mode=
                                            tof.AdamMathType.ApexAdamW))
    for i, g in enumerate(gw):
        tw.grad = torch.from_numpy(g.copy())
        tb.grad = torch.from_numpy(gb.copy()) if i == 2 else None
        opt.step()
    sw, sb = opt.state[tw], opt.state[tb]
    assert sw["step"] is sb["step"] and sw["n_averaged"] is sb["n_averaged"]
    assert int(sw["step"]) == int(state.step) == 3
    assert int(sw["n_averaged"]) == int(state.n_averaged) == 3
    f32 = dict(rtol=1e-6, atol=1e-7)
    for i, (p, st) in enumerate(((tw, sw), (tb, sb))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ps[i]), **f32)
        for key in ("exp_avg", "exp_avg_sq", "state_params", "swa_params"):
            np.testing.assert_allclose(st[key].numpy(),
                                       np.asarray(getattr(state, key)[i]),
                                       err_msg=key, **f32)


# ---------------------------------------------------------------------------
# the MSA row attention with pair bias, composed from the public functions
# ---------------------------------------------------------------------------


def _weights(c_m, c_z, h, d, seed):
    """One block's weights (OpenFold's MSARowAttentionWithPairBias: the two
    LayerNorms, the pair-bias linear z -> h, q/k/v without bias, the gate
    and output linears with bias), as numpy."""
    rng = np.random.default_rng(seed)
    lin = lambda o, i: (rng.standard_normal((o, i)) * i ** -0.5).astype(np.float32)
    vec = lambda n, s: (s * rng.standard_normal(n)).astype(np.float32)
    return {"ln_m_w": 1 + vec(c_m, 0.1), "ln_m_b": vec(c_m, 0.1),
            "ln_z_w": 1 + vec(c_z, 0.1), "ln_z_b": vec(c_z, 0.1),
            "w_z": lin(h, c_z), "w_q": lin(h * d, c_m), "w_k": lin(h * d, c_m),
            "w_v": lin(h * d, c_m), "w_g": lin(h * d, c_m),
            "b_g": vec(h * d, 0.1), "w_o": lin(c_m, h * d), "b_o": vec(c_m, 0.1)}


def torch_block(m, z, w, mask, h):
    """The port's block: m ``[b, r, s, c_m]``, z ``[b, s, s, c_z]``, mask
    ``[b, r, 1, 1, s]``; returns the new m."""
    c_m, c_z = m.shape[-1], z.shape[-1]
    d = w["w_q"].shape[0] // h
    mn = tof.LayerNormSmallShapeOptImpl.apply(m, (c_m,), w["ln_m_w"], w["ln_m_b"])
    zn = tof.LayerNormSmallShapeOptImpl.apply(z, (c_z,), w["ln_z_w"], w["ln_z_b"])
    bias = F.linear(zn, w["w_z"]).permute(0, 3, 1, 2).unsqueeze(1)
    heads = lambda x: x.view(*x.shape[:-1], h, d).transpose(-2, -3)
    q = heads(F.linear(mn, w["w_q"])) * d ** -0.5
    k, v = heads(F.linear(mn, w["w_k"])), heads(F.linear(mn, w["w_v"]))
    o = tof.attention_core(q, k, v, mask, bias).transpose(-2, -3)
    gate = torch.sigmoid(F.linear(mn, w["w_g"], w["b_g"])).view(o.shape)
    return m + F.linear((o * gate).flatten(-2), w["w_o"], w["b_o"])


def jax_block(m, z, w, mask, h):
    """The same block from the JAX package's public functions."""
    c_m, c_z = m.shape[-1], z.shape[-1]
    d = w["w_q"].shape[0] // h
    mn = jof.LayerNormSmallShapeOptImpl.apply(m, (c_m,), w["ln_m_w"], w["ln_m_b"])
    zn = jof.LayerNormSmallShapeOptImpl.apply(z, (c_z,), w["ln_z_w"], w["ln_z_b"])
    bias = jnp.transpose(zn @ w["w_z"].T, (0, 3, 1, 2))[:, None]
    heads = lambda x: jnp.swapaxes(x.reshape(*x.shape[:-1], h, d), -2, -3)
    q = heads(mn @ w["w_q"].T) * d ** -0.5
    k, v = heads(mn @ w["w_k"].T), heads(mn @ w["w_v"].T)
    o = jnp.swapaxes(jof.attention_core(q, k, v, mask, bias), -2, -3)
    gate = jax.nn.sigmoid(mn @ w["w_g"].T + w["b_g"]).reshape(o.shape)
    return m + (o * gate).reshape(*o.shape[:-2], h * d) @ w["w_o"].T + w["b_o"]


# name: (b, r, s, c_m, c_z, h, d, blocks)
BLOCKS = {"materialized": (1, 3, 128, 16, 8, 2, 8, 2),
          "routed": (1, 2, 1024, 8, 4, 1, 8, 1)}


def _block_inputs(b, r, s, c_m, c_z, h, d, blocks):
    rng = np.random.default_rng(6)
    m = rng.standard_normal((b, r, s, c_m)).astype(np.float32)
    z = rng.standard_normal((b, s, s, c_z)).astype(np.float32)
    mask = rng.random((b, r, 1, 1, s)) > 0.1
    target = rng.standard_normal((b, r, s, c_m)).astype(np.float32)
    ws = [_weights(c_m, c_z, h, d, seed=10 + i) for i in range(blocks)]
    return m, z, mask, target, ws


@pytest.mark.parametrize("route", sorted(BLOCKS))
def test_msa_row_block_matches_jax(route):
    """The block (stacked, all sharing z) from one numpy weight dict: the
    MSE loss against a fixed target, and the gradient of every weight and
    of z (which reaches the loss only through the pair bias), on the
    materialized route (s = 128, 2 blocks) and the routed one (s = 1024,
    the pair-bias kernel)."""
    b, r, s, c_m, c_z, h, d, blocks = BLOCKS[route]
    m, z, mask, target, ws = _block_inputs(*BLOCKS[route])

    def jloss(ws, z):
        x = jnp.asarray(m)
        for w in ws:
            x = jax_block(x, z, w, jnp.asarray(mask), h)
        return jnp.mean((x - target) ** 2)

    jl, (jgw, jgz) = jax.value_and_grad(jloss, argnums=(0, 1))(
        [{k: jnp.asarray(a) for k, a in w.items()} for w in ws],
        jnp.asarray(z))
    tws = [{k: torch.from_numpy(a).requires_grad_() for k, a in w.items()}
           for w in ws]
    tz = torch.from_numpy(z).requires_grad_()
    x = torch.from_numpy(m)
    for w in tws:
        x = torch_block(x, tz, w, torch.from_numpy(mask), h)
    loss = torch.mean((x - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    pairs = [(f"block{i}.{k}", tw[k].grad.numpy(), np.asarray(jw[k]))
             for i, (tw, jw) in enumerate(zip(tws, jgw)) for k in tw]
    pairs.append(("z", tz.grad.numpy(), np.asarray(jgz)))
    for name, a, e in pairs:
        if name.endswith("ln_z_b"):
            # it shifts all the scores of a query row alike, which the
            # softmax does not see: zero in exact arithmetic, rounding
            # noise on both sides
            scale = np.abs(np.asarray(jgw[0]["w_z"])).max()
            assert max(np.abs(a).max(), np.abs(e).max()) <= 1e-5 * scale
            continue
        tol = 2e-4 * np.abs(e).max()
        assert np.abs(e).max() > 0, name
        np.testing.assert_allclose(a, e, atol=tol, rtol=0, err_msg=name)


@pytest.mark.cuda
def test_msa_row_block_on_card_matches_cpu():
    """The routed block on the card (the four pair-bias kernels and the
    norm kernels, fp32) against the same block on the CPU (chip_smoke.py
    runs this with 3 FusedAdamSWA steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, r, s, c_m, c_z, h, d, _ = BLOCKS["routed"]
    m, z, mask, target, ws = _block_inputs(*BLOCKS["routed"])
    out = {}
    for dev in ("cpu", "cuda"):
        w = {k: torch.from_numpy(a).to(dev).requires_grad_()
             for k, a in ws[0].items()}
        tz = torch.from_numpy(z).to(dev).requires_grad_()
        x = torch_block(torch.from_numpy(m).to(dev), tz, w,
                        torch.from_numpy(mask).to(dev), h)
        loss = torch.mean((x - torch.from_numpy(target).to(dev)) ** 2)
        loss.backward()
        out[dev] = (float(loss), {k: t.grad.cpu() for k, t in w.items()},
                    tz.grad.cpu())
    assert abs(out["cpu"][0] - out["cuda"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], g, rtol=0,
                                   atol=2e-4 * float(g.abs().max()))
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=0,
                               atol=2e-4 * float(out["cpu"][2].abs().max()))
