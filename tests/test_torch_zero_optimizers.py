"""ZeRO-2 optimizers: ``apex_tpu_torch.contrib.optimizers`` in gloo worlds
of 2 and 4 spawned ranks against ``apex_tpu.contrib.optimizers`` under
``shard_map`` over meshes of 2 and 4 virtual CPU devices: the nine cases
of ``tests/test_zero_optimizers.py``, each at both sizes.

Every rank steps the same parameters three times with its own gradients
``base * (rank + 1)`` (the optimizer averages them over the group); the
parameters after the steps are held to JAX's at 1e-6 relative (Adam,
LAMB, the fp16 scaled state), and to one bf16 ulp (2**-8 relative) where
the parameters are bf16 (the remainders, whose fp32 masters may differ in
their last bit from a sum taken in another order, and the bf16 gradient
sync).  Also: the bf16 split of an fp32 word and its merge bit for bit
against JAX's; the refusal of fp32 parameters under remainders; a
``found_inf`` step that keeps every parameter and the step count; and the
state's shard, ``padded / world`` elements on every rank.

JAX is imported inside the fixtures and tests only, so the spawned ranks
stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer.testing.distributed import run_world

N_STEPS = 3
KEYS = ("b", "ln/scale", "w")       # the JAX tree's leaf order
SHAPES = {"b": (9,), "ln/scale": (33,), "w": (17, 9)}

CASES = {
    "adam_w": dict(cls="adam", kw=dict(lr=1e-2, weight_decay=0.02,
                                       adam_w_mode=True)),
    "adam_l2": dict(cls="adam", kw=dict(lr=1e-2, weight_decay=0.02,
                                        adam_w_mode=False)),
    "lamb": dict(cls="lamb", kw=dict(lr=1e-2, weight_decay=0.01,
                                     max_grad_norm=1.0)),
    "remainders": dict(cls="adam", kw=dict(lr=1e-2,
                                           store_param_remainders=True),
                       bf16=True),
    "scaled": dict(cls="adam", kw=dict(lr=1e-3, with_scaled_states=True),
                   grad_scale=1e-6),
    "bf16_sync": dict(cls="adam", kw=dict(lr=1e-2), grad_sync="bf16"),
}


def _data():
    rng = np.random.default_rng(1234)
    params = {"w": rng.normal(size=(17, 9)), "b": rng.normal(size=(9,)),
              "ln/scale": 1.0 + 0.1 * rng.normal(size=(33,))}
    grads = {k: rng.normal(size=SHAPES[k]) for k in KEYS}
    return ({k: params[k].astype(np.float32) for k in KEYS},
            {k: grads[k].astype(np.float32) for k in KEYS})


def _opt(cls, params, **kw):
    from apex_tpu_torch.contrib.optimizers import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
    )

    return (DistributedFusedAdam if cls == "adam"
            else DistributedFusedLAMB)(params, **kw)


def _params(params, dtype):
    return [torch.nn.Parameter(torch.tensor(params[k]).to(dtype))
            for k in KEYS]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _world(rank, world):
    params, base = _data()
    out = {}
    for name, case in CASES.items():
        dtype = torch.bfloat16 if case.get("bf16") else torch.float32
        kw = dict(case["kw"])
        if case.get("grad_sync") == "bf16":
            kw["grad_sync_dtype"] = torch.bfloat16
        ps = _params(params, dtype)
        opt = _opt(case["cls"], ps, **kw)
        scale = case.get("grad_scale", 1.0) * (rank + 1)
        for _ in range(N_STEPS):
            for p, k in zip(ps, KEYS):
                p.grad = (torch.tensor(base[k]) * scale).to(dtype)
            opt.step()
        out[name] = dict(params=[p.detach().float().numpy() for p in ps],
                         dtypes=[str(p.dtype) for p in ps],
                         state_dtype=str(opt.zero_state.exp_avg.dtype))
    # remainders need bf16 parameters
    try:
        ps = _params(params, torch.float32)
        opt = _opt("adam", ps, store_param_remainders=True)
        for p, k in zip(ps, KEYS):
            p.grad = torch.tensor(base[k])
        opt.step()
        out["requires_bf16"] = None
    except ValueError as e:
        out["requires_bf16"] = str(e)
    # a skipped step
    ps = _params(params, torch.float32)
    opt = _opt("adam", ps, lr=1e-2)
    for p, k in zip(ps, KEYS):
        p.grad = torch.tensor(base[k])
    opt.step(found_inf=torch.tensor(True))
    out["found_inf"] = dict(params=[p.detach().numpy() for p in ps],
                            step=int(opt.zero_state.step))
    # the shards
    st = _opt("adam", _params(params, torch.float32), lr=1e-2).init()
    out["shard"] = dict(exp_avg=st.exp_avg.numel(),
                        exp_avg_sq=st.exp_avg_sq.numel(),
                        param_shard=st.param_shard.numel())
    return out


@pytest.fixture(scope="module")
def worlds():
    return {n: run_world(_world, n, timeout=150) for n in (2, 4)}


def _jax_run(name, n):
    """JAX's ZeRO run of case ``name`` on a mesh of ``n`` devices, by the
    JAX test's own ``run_distributed`` (rank r's gradient base * (r+1))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from apex_tpu.contrib.optimizers import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
    )

    import test_zero_optimizers as jt

    case = CASES[name]
    params, base = _data()
    dt = jnp.bfloat16 if case.get("bf16") else jnp.float32
    tree = {"b": jnp.asarray(params["b"], dt), "w": jnp.asarray(params["w"], dt),
            "ln": {"scale": jnp.asarray(params["ln/scale"], dt)}}
    g = case.get("grad_scale", 1.0)
    gtree = {"b": jnp.asarray(base["b"]) * g, "w": jnp.asarray(base["w"]) * g,
             "ln": {"scale": jnp.asarray(base["ln/scale"]) * g}}
    kw = dict(case["kw"])
    if case.get("grad_sync") == "bf16":
        kw["grad_sync_dtype"] = jnp.bfloat16
    opt = (DistributedFusedAdam if case["cls"] == "adam"
           else DistributedFusedLAMB)(**kw)
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    out = jt.run_distributed(opt, tree, gtree, mesh)
    return [np.asarray(out["b"], np.float32),
            np.asarray(out["ln"]["scale"], np.float32),
            np.asarray(out["w"], np.float32)]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_split_merge_bf16_roundtrip_matches_jax(n):
    import jax.numpy as jnp

    from apex_tpu.contrib.optimizers._zero_base import _split_bf16 as jsplit
    from apex_tpu_torch.contrib.optimizers._zero_base import (
        _merge_bf16,
        _split_bf16,
    )

    rng = np.random.default_rng(n)
    x = (rng.normal(size=(257 * n,)) * 1e3).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    hi, lo = _split_bf16(torch.from_numpy(x))
    assert hi.dtype == torch.bfloat16 and lo.dtype == torch.int16
    assert torch.equal(_merge_bf16(hi, lo).view(torch.int32),
                       torch.from_numpy(x).view(torch.int32))
    jhi, jlo = jsplit(jnp.asarray(x))
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).view(np.int16))


def _check(worlds, name, n, bf16_ulp=False):
    want = _jax_run(name, n)
    for r in range(n):
        for got, ref, k in zip(worlds[n][r][name]["params"], want, KEYS):
            if bf16_ulp:
                np.testing.assert_allclose(
                    got, ref, rtol=0, atol=float(np.abs(ref).max()) * 2.0 ** -8,
                    err_msg=k)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7,
                                           err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["adam_w", "adam_l2"])
def test_distributed_adam_matches_jax(worlds, name, n):
    _check(worlds, name, n)


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_lamb_matches_jax(worlds, n):
    _check(worlds, "lamb", n)


@pytest.mark.parametrize("n", [2, 4])
def test_store_param_remainders_matches_jax(worlds, n):
    for r in range(n):
        assert set(worlds[n][r]["remainders"]["dtypes"]) == {"torch.bfloat16"}
    _check(worlds, "remainders", n, bf16_ulp=True)


@pytest.mark.parametrize("n", [2, 4])
def test_store_param_remainders_requires_bf16(worlds, n):
    for r in range(n):
        assert "bf16" in worlds[n][r]["requires_bf16"]


@pytest.mark.parametrize("n", [2, 4])
def test_scaled_states_fp16_matches_jax(worlds, n):
    for r in range(n):
        assert worlds[n][r]["scaled"]["state_dtype"] == "torch.float16"
    _check(worlds, "scaled", n)


@pytest.mark.parametrize("n", [2, 4])
def test_found_inf_skips_update(worlds, n):
    params, _ = _data()
    for r in range(n):
        got = worlds[n][r]["found_inf"]
        assert got["step"] == 0
        for g, k in zip(got["params"], KEYS):
            np.testing.assert_array_equal(g, params[k])


@pytest.mark.parametrize("n", [2, 4])
def test_state_is_sharded_over_dp(worlds, n):
    total = sum(int(np.prod(s)) for s in SHAPES.values())
    padded = -(-total // (1024 * n)) * 1024 * n
    for r in range(n):
        shard = worlds[n][r]["shard"]
        assert shard == dict(exp_avg=padded // n, exp_avg_sq=padded // n,
                             param_shard=padded // n)


@pytest.mark.parametrize("n", [2, 4])
def test_grad_sync_dtype_bf16_matches_jax(worlds, n):
    _check(worlds, "bf16_sync", n, bf16_ulp=True)


def test_contrib_exports_and_legacy_names():
    import apex_tpu.contrib.optimizers as jo
    import apex_tpu_torch.contrib.optimizers as to
    from apex_tpu_torch.optimizers import FusedAdam

    assert sorted(to.__all__) == sorted(jo.__all__)
    with pytest.warns(DeprecationWarning):
        assert to.FusedAdam is FusedAdam
