"""apex_tpu_torch.contrib.group_norm, .groupbn, .cudnn_gbn, .conv_bias_relu
and .index_mul_2d against their JAX twins (the cases of
``tests/test_group_norm.py`` and ``tests/test_contrib_kernels.py``, then
each against JAX).

The same seeded numpy inputs go through the JAX module and the port on the
CPU, weights carried over by ``group_norm_params_from_jax``,
``groupbn_params_from_jax`` and ``conv_params_from_jax``.  Layouts: the
group norm and both batch norms take channels last, as in JAX; the
convolutions take NCHW / OIHW where JAX takes NHWC / HWIO, so inputs and
results are transposed between them.

The subgroup statistics run in one gloo world of 4 ranks (one sample
each, ``bn_group`` 2) against JAX's ``shard_map`` over 4 virtual devices
with ``bn_group_index_groups(4, 2)``.  This module imports JAX only inside
its fixtures and tests, so the spawned ranks stay JAX-free.

Tolerances, fp32: the group norm ``rtol = atol = 2e-5`` (JAX's against
``F.group_norm``), its gradients ``atol 1e-5``; the batch norms ``1e-5``
(``2e-3`` against the numpy oracle, JAX's; ``1e-4`` in the world of 4,
whose first subgroup's +10 shift leaves the variance as the difference of
two sums of ~3.2e3); convolutions ``rtol 1e-4,
atol 1e-5`` (JAX's against torch), their gradients ``atol 1e-4``;
``index_mul_2d`` ``rtol 1e-6`` forward and ``atol 1e-6`` backward.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.conv_bias_relu import (
    ConvBias,
    ConvBiasMaskReLU,
    ConvBiasReLU,
    ConvFrozenScaleBiasReLU,
)
from apex_tpu_torch.contrib.cudnn_gbn import (
    GroupBatchNorm2d,
    bn_group_index_groups,
)
from apex_tpu_torch.contrib.group_norm import GroupNorm, group_norm_nhwc
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d
from apex_tpu_torch.models.convert import (
    conv_params_from_jax,
    group_norm_params_from_jax,
    groupbn_params_from_jax,
)
from apex_tpu_torch.transformer.testing.distributed import run_world

W = 4           # ranks of the subgroup world
BN_GROUP = 2
BN_C = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _torch_gn(x_nhwc, G, weight, bias, eps, act):
    x = _t(np.moveaxis(x_nhwc, -1, 1))
    y = torch.nn.functional.group_norm(x, G, _t(weight), _t(bias), eps)
    if act:
        y = y * torch.sigmoid(y)
    return np.moveaxis(y.numpy(), 1, -1)


# ---------------------------------------------------------------------------
# group_norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", [None, "swish"])
@pytest.mark.parametrize("G,C", [(16, 128), (32, 320), (4, 20)])
def test_group_norm_matches_jax_and_torch(G, C, act):
    import jax.numpy as jnp

    from apex_tpu.contrib.group_norm import group_norm_nhwc as jgn

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 7, C)).astype(np.float32)
    w = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    got = group_norm_nhwc(_t(x), G, _t(w), _t(b), 1e-5, act).numpy()
    want = np.asarray(jgn(jnp.asarray(x), G, jnp.asarray(w), jnp.asarray(b),
                          1e-5, act))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _torch_gn(x, G, w, b, 1e-5, act),
                               rtol=2e-5, atol=2e-5)


def test_group_norm_bf16_input_fp32_statistics_like_jax():
    import jax.numpy as jnp

    from apex_tpu.contrib.group_norm import group_norm_nhwc as jgn

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 4, 4, 64)) + 100.0).astype(np.float32)
    w, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jgn(xb, 8, jnp.asarray(w), jnp.asarray(b), 1e-5, "silu")
    xt = _t(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = group_norm_nhwc(xt, 8, _t(w), _t(b), 1e-5, "silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert abs(float(got.float().mean())) < 0.3


def test_group_norm_module_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.group_norm import GroupNorm as J

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 3, 32)).astype(np.float32)
    jm = J(num_groups=8, num_channels=32, act="silu")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape), a.dtype) * 0.1, params)

    def loss(p, xx):
        return jnp.sum(jm.apply(p, xx) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    m = GroupNorm(8, 32, act="SiLU", device="cpu")
    m.load_state_dict(group_norm_params_from_jax(jax.tree.map(np.asarray,
                                                              params)))
    xt = _t(x).requires_grad_()
    (m(xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5,
                               rtol=0)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(m, name).grad.numpy(),
                                   np.asarray(gp["params"][name]), atol=1e-5,
                                   rtol=0)


def test_group_norm_validation():
    with pytest.raises(ValueError):
        group_norm_nhwc(torch.zeros(1, 2, 2, 10), 3)
    with pytest.raises(ValueError):
        group_norm_nhwc(torch.zeros(1, 2, 2, 8), 2, act="relu")
    with pytest.raises(ValueError):
        GroupNorm(3, 10, device="cpu")
    with pytest.raises(ValueError, match="channels-last"):
        GroupNorm(2, 8, device="cpu")(torch.zeros(1, 8, 2, 2))


# ---------------------------------------------------------------------------
# batch norms: local
# ---------------------------------------------------------------------------


def _bn_oracle(x, eps=1e-5):
    return (x - x.mean(axis=(0, 1, 2))) / np.sqrt(x.var(axis=(0, 1, 2)) + eps)


@pytest.mark.parametrize("fuse_relu", [True, False])
def test_batchnorm_nhwc_addrelu_matches_jax(fuse_relu):
    """``forward(x, z)`` is ``relu(BN(x) + z)`` whatever ``fuse_relu``
    says (the reference's bn_addrelu); without z the ReLU follows
    ``fuse_relu``.  Output, running statistics and the gradients of x, z
    and the scale against JAX's; eval mode (JAX's
    ``use_running_average``) after."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as J

    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, 5, BN_C)).astype(np.float32) * 2 + 1
    z = rng.standard_normal((4, 5, 5, BN_C)).astype(np.float32)
    ct = rng.standard_normal((4, 5, 5, BN_C)).astype(np.float32)
    jm = J(num_features=BN_C, fuse_relu=fuse_relu)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": jax.tree.map(lambda a: a + 0.3, v["params"]),
         "batch_stats": v["batch_stats"]}

    def f(p, xx, zz):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                        zz, mutable=["batch_stats"])

    y, upd = f(v["params"], jnp.asarray(x), jnp.asarray(z))
    _, vjp = jax.vjp(lambda p, xx, zz: f(p, xx, zz)[0], v["params"],
                     jnp.asarray(x), jnp.asarray(z))
    dp, dx, dz = vjp(jnp.asarray(ct))
    y_noz = np.asarray(f(v["params"], jnp.asarray(x), None)[0])
    m = BatchNorm2d_NHWC(BN_C, fuse_relu=fuse_relu)
    m.load_state_dict(groupbn_params_from_jax(jax.tree.map(np.asarray, v)))
    xt, zt = _t(x).requires_grad_(), _t(z).requires_grad_()
    out = m(xt, zt)
    (out * _t(ct)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.maximum(_bn_oracle(x) * 1.3 + 0.3 + z, 0.0), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **tol)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(dz), **tol)
    np.testing.assert_allclose(m.weight.grad.numpy(),
                               np.asarray(dp["SyncBatchNorm_0"]["scale"]),
                               **tol)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["SyncBatchNorm_0"]
                                          ["mean"]), **tol)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["SyncBatchNorm_0"]
                                          ["var"]), **tol)
    with torch.no_grad():
        m.eval()
        want_eval = jm.apply({"params": v["params"],
                              "batch_stats": upd["batch_stats"]},
                             jnp.asarray(x), use_running_average=True)
        np.testing.assert_allclose(m(_t(x)).numpy(), np.asarray(want_eval),
                                   **tol)
        m.train()
        np.testing.assert_allclose(m(_t(x)).numpy(), y_noz, **tol)


def test_bn_group_index_groups_and_local_fallbacks():
    assert bn_group_index_groups(8, 1) is None
    assert bn_group_index_groups(8, 4) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError):
        bn_group_index_groups(6, 4)
    # no process group: local statistics, whatever the groups say
    x = torch.randn(4, 3, 3, BN_C, generator=torch.Generator().manual_seed(0))
    gbn = GroupBatchNorm2d(BN_C, axis_index_groups=[[0, 1]])
    assert gbn.process_group is None and gbn.channel_axis == -1
    np.testing.assert_allclose(gbn(x).detach().numpy(),
                               _bn_oracle(x.numpy()), rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="process_group"):
        BatchNorm2d_NHWC(BN_C, bn_group=2)


# ---------------------------------------------------------------------------
# batch norms: subgroups of a world of 4
# ---------------------------------------------------------------------------


def _gbn_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((W, 4, 4, BN_C)).astype(np.float32)
    x[:W // 2] += 10.0                      # the first subgroup is shifted
    return dict(x=x, z=rng.standard_normal(x.shape).astype(np.float32),
                ct=rng.standard_normal(x.shape).astype(np.float32))


def _bn_run(bn, inp, rank, with_z):
    x = _t(inp["x"][rank:rank + 1]).requires_grad_()
    z = _t(inp["z"][rank:rank + 1]) if with_z else None
    y = bn(x) if z is None else bn(x, z)
    (y * _t(inp["ct"][rank:rank + 1])).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy().copy(),
                dscale=bn.weight.grad.numpy().copy(),
                mean=bn.running_mean.numpy().copy(),
                var=bn.running_var.numpy().copy())


def _gbn_world(rank, world, inp):
    import torch.distributed as dist

    from apex_tpu_torch.contrib.cudnn_gbn import (
        GroupBatchNorm2d,
        bn_group_index_groups,
    )
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

    wg = dist.group.WORLD
    gbn = GroupBatchNorm2d(
        BN_C, momentum=0.1, process_group=wg,
        axis_index_groups=bn_group_index_groups(world, BN_GROUP))
    nhwc = BatchNorm2d_NHWC(BN_C, fuse_relu=True, bn_group=BN_GROUP,
                            process_group=wg, world_size=world)
    whole = BatchNorm2d_NHWC(BN_C, bn_group=1, process_group=wg)
    return dict(gbn=_bn_run(gbn, inp, rank, False),
                nhwc=_bn_run(nhwc, inp, rank, True),
                whole=_bn_run(whole, inp, rank, False),
                group_size=dist.get_world_size(gbn.process_group))


@pytest.fixture(scope="module")
def gbn_world():
    inp = _gbn_inputs()
    return inp, run_world(_gbn_world, W, args=(inp,), timeout=150)


def _jax_grouped(kind, inp):
    """The JAX module under ``shard_map`` over 4 devices, one sample each:
    output, the vjp of the cotangent (x, scale) and the running
    statistics of each device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from apex_tpu.contrib.cudnn_gbn import GroupBatchNorm2d as JG
    from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JN
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = Mesh(np.array(jax.devices()[:W]), ("dp",))
    if kind == "gbn":
        bn = JG(num_features=BN_C, axis_name="dp", momentum=0.1,
                axis_index_groups=bn_group_index_groups(W, BN_GROUP))
    else:
        bn = JN(num_features=BN_C, fuse_relu=kind == "nhwc", axis_name="dp",
                world_size=W, bn_group=BN_GROUP if kind == "nhwc" else 1)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(inp["x"][:1]))
    zs = kind == "nhwc"

    def fn(x, z, ct):
        def f(p, xx):
            args = (xx, z) if zs else (xx,)
            return bn.apply({"params": p, "batch_stats": v["batch_stats"]},
                            *args, mutable=["batch_stats"])
        y, upd = f(v["params"], x)
        _, vjp = jax.vjp(lambda p, xx: f(p, xx)[0], v["params"], x)
        dp, dx = vjp(ct)
        stats = jax.tree.leaves(upd["batch_stats"])
        leaves = jax.tree.leaves(dp)
        return y, dx, leaves[1][None], stats[0][None], stats[1][None]

    with mesh:
        out = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(P("dp"),) * 3, out_specs=(P("dp"),) * 5,
            **NO_REP_CHECK))(jnp.asarray(inp["x"]), jnp.asarray(inp["z"]),
                             jnp.asarray(inp["ct"]))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("kind", ["gbn", "nhwc", "whole"])
def test_subgroup_statistics_match_jax_shard_map(gbn_world, kind):
    """Each rank's output, input gradient, scale gradient and running
    statistics against the JAX device's: ``gbn`` and ``nhwc`` (with z)
    reduce over ranks {0, 1} and {2, 3}, ``whole`` (bn_group 1) over all
    four."""
    inp, ranks = gbn_world
    y, dx, dscale, mean, var = _jax_grouped(kind, inp)
    # the +10 shift: both merges take n * var as M2 + sum(n mean^2) - n
    # mean^2, two terms of ~3.2e3 whose fp32 roundings differ by ~1e-4
    tol = dict(rtol=1e-4, atol=1e-4)
    for r, res in enumerate(ranks):
        got = res[kind]
        np.testing.assert_allclose(got["y"], y[r:r + 1], **tol)
        np.testing.assert_allclose(got["dx"], dx[r:r + 1], **tol)
        np.testing.assert_allclose(got["dscale"], dscale[r], **tol)
        np.testing.assert_allclose(got["mean"], mean[r], **tol)
        np.testing.assert_allclose(got["var"], var[r], **tol)
        assert res["group_size"] == BN_GROUP
    if kind == "gbn":
        # each half normalized by its own statistics, as JAX's test checks
        ys = np.concatenate([res["gbn"]["y"] for res in ranks])
        np.testing.assert_allclose(ys[:2], _bn_oracle(inp["x"][:2]),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(ys[2:], _bn_oracle(inp["x"][2:]),
                                   rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# conv_bias_relu
# ---------------------------------------------------------------------------


def _nchw(a):
    return _t(np.moveaxis(a, -1, 1))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.mark.parametrize("padding,stride", [(0, 1), (1, 2),
                                            (((0, 1), (1, 2)), 1)])
def test_conv_bias_relu_matches_jax(padding, stride):
    """NCHW / OIHW in the port, NHWC / HWIO in JAX; an asymmetric padding
    goes through ``F.pad``.  Output and the gradients of x and the
    weight."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.conv_bias_relu import ConvBiasReLU as J

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want, vjp = jax.vjp(lambda xx, ww: J(xx, ww, jnp.asarray(b), padding,
                                         stride), jnp.asarray(x),
                        jnp.asarray(w))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(ct))
    xt = _nchw(x).requires_grad_()
    wt = conv_params_from_jax(w).requires_grad_()
    got = ConvBiasReLU(xt, wt, _t(b), padding, stride)
    (got * _nchw(ct)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(dw).transpose(3, 2, 0, 1),
                               atol=1e-4, rtol=0)


def test_conv_bias_mask_relu_and_frozen_scale_match_jax():
    import jax.numpy as jnp

    from apex_tpu.contrib.conv_bias_relu import (
        ConvBias as JB,
        ConvBiasMaskReLU as JM,
        ConvFrozenScaleBiasReLU as JF,
    )

    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    mask = rng.integers(0, 2, (1, 6, 6, 8)).astype(np.float32)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    wt = conv_params_from_jax(w)
    for got, want in (
            (ConvBias(_nchw(x), wt, _t(b), 1, 1), JB(jx, jw, jb, 1, 1)),
            (ConvBiasMaskReLU(_nchw(x), wt, _t(b), _nchw(mask), 1, 1),
             JM(jx, jw, jb, jnp.asarray(mask), 1, 1)),
            (ConvFrozenScaleBiasReLU(_nchw(x), wt, _t(scale), _t(b), 1, 1),
             JF(jx, jw, jnp.asarray(scale), jb, 1, 1))):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    y = ConvBiasMaskReLU(_nchw(x), wt, _t(b), _nchw(mask), 1, 1)
    assert float(y.min()) >= 0.0 and torch.all(y[_nchw(mask) == 0] == 0)
    # frozen scale and bias get no gradient; the weight does
    st, bt = _t(scale).requires_grad_(), _t(b).requires_grad_()
    wg = wt.clone().requires_grad_()
    ConvFrozenScaleBiasReLU(_nchw(x), wg, st, bt, 1, 1).sum().backward()
    assert st.grad is None and bt.grad is None
    assert wg.grad.abs().max() > 0


def test_conv_bias_promotes_like_jax():
    """A bf16 convolution plus an fp32 bias is fp32, as in JAX."""
    x = torch.randn(1, 4, 5, 5).to(torch.bfloat16)
    w = torch.randn(8, 4, 3, 3).to(torch.bfloat16)
    assert ConvBias(x, w, torch.zeros(8), 1).dtype == torch.float32
    assert ConvBiasReLU(x, w, torch.zeros(8, dtype=torch.bfloat16),
                        1).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# index_mul_2d
# ---------------------------------------------------------------------------


def test_index_mul_2d_forward_backward_match_jax():
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.index_mul_2d import index_mul_2d as jim

    rng = np.random.default_rng(0)
    S, N, H = 10, 32, 16
    in1 = rng.standard_normal((S, H)).astype(np.float32)
    in2 = rng.standard_normal((N, H)).astype(np.float32)
    idx = rng.integers(0, S, N)
    a, b = _t(in1).requires_grad_(), _t(in2).requires_grad_()
    out = index_mul_2d(a, b, _t(idx))
    np.testing.assert_allclose(out.detach().numpy(), in1[idx] * in2,
                               rtol=1e-6)
    (out ** 2).sum().backward()
    ga, gb = jax.grad(lambda x, y: (jim(x, y, jnp.asarray(idx)) ** 2).sum(),
                      argnums=(0, 1))(jnp.asarray(in1), jnp.asarray(in2))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), atol=1e-6,
                               rtol=1e-6)


def test_index_mul_2d_half_precision():
    rng = np.random.default_rng(1)
    in1 = _t(rng.standard_normal((6, 8)).astype(np.float16))
    in2 = _t(rng.standard_normal((12, 8)).astype(np.float16))
    idx = _t(rng.integers(0, 6, 12))
    out = index_mul_2d(in1, in2, idx)
    assert out.dtype == torch.float16
    torch.testing.assert_close(out, in1[idx] * in2)


@pytest.mark.parametrize("shapes", [
    ((2, 3, 4), (2, 3), (2,), "2-D"),
    ((2, 3), (4, 3), (2,), "len"),
    ((2, 3), (2, 3), (2, 1), "len"),
])
def test_index_mul_2d_validation(shapes):
    s1, s2, si, match = shapes
    with pytest.raises(ValueError, match=match):
        index_mul_2d(torch.zeros(s1), torch.zeros(s2),
                     torch.zeros(si, dtype=torch.int64))
    with pytest.raises(ValueError, match="dtype"):
        index_mul_2d(torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.float64),
                     torch.zeros(2, dtype=torch.int64))
