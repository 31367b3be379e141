"""apex_tpu_torch.contrib.halo against apex_tpu.contrib.halo at spatial 4
(the cases of ``tests/test_halo.py``).

One gloo world of 4 ranks splits H into four blocks; JAX runs the same
inputs under ``shard_map`` over 4 virtual devices.  The port is NCHW /
OIHW where JAX is NHWC / HWIO, so inputs and results are transposed
between them (the halo rides dim 2 here, dim 1 there).  Weights are
JAX's, carried over by ``bottleneck_params_from_jax``.

- the neighbor rows a rank receives (zeros past the line's ends), and the
  object form along H and W;
- ``spatial_conv2d`` against JAX's split run and the unsplit ``SAME``
  convolution, with the gradients of the input (each rank's rows) and of
  the weight (each rank's share; their sum is the unsplit gradient);
- ``SpatialBottleneck``'s output against JAX's spatial run and the dense
  block, and each rank's gradients of the input and the convolutions;
- no world: no gradient to the frozen batch norm, and the validation
  errors.

Tolerances: fp32 ``rtol 1e-4, atol 1e-5`` (JAX's for the halo tests),
the weight gradients summed over a whole block ``atol 1e-4``.  This
module imports JAX only inside its fixtures and tests, so the spawned
ranks stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer.testing.distributed import run_world

SP = 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _rows(a, r, dim=2):
    n = a.shape[dim] // SP
    return np.take(a, np.arange(r * n, (r + 1) * n), axis=dim)


def _inputs():
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.halo import SpatialBottleneck

    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = {"rows": np.arange(8 * 3, dtype=np.float32).reshape(1, 8, 1, 3),
           "x": f(2, 16, 8, 4), "w": f(3, 3, 4, 6), "ct": f(2, 16, 8, 6),
           "bx": f(2, 16, 8, 8), "bct": f(2, 16, 8, 8)}
    block = SpatialBottleneck(in_channels=8, bottleneck_channels=4,
                              out_channels=8, spatial_axis=None)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(inp["bx"]))
    inp["block"] = jax.tree.map(np.asarray, params)["params"]
    return inp


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _bottleneck(params, group):
    from apex_tpu_torch.contrib.halo import SpatialBottleneck
    from apex_tpu_torch.models.convert import bottleneck_params_from_jax

    m = SpatialBottleneck(8, 4, 8, spatial_axis=group, device="cpu")
    m.load_state_dict(bottleneck_params_from_jax(params))
    return m


def _halo_world(rank, world, inp):
    import torch.distributed as dist

    from apex_tpu_torch.contrib.halo import (
        Bottleneck,
        HaloExchanger1d,
        halo_exchange_1d,
        spatial_conv2d,
    )

    group = dist.group.WORLD
    out = {}
    rows = torch.tensor(_rows(_nchw(inp["rows"]), rank))
    out["rows"] = halo_exchange_1d(rows, 1, group).numpy()
    ones = torch.ones(1, 2, 8 // SP, 8)
    ex = HaloExchanger1d(group, half_halo=2)
    out["object_h"] = ex(ones * (rank + 1)).numpy()
    out["object_w"] = ex(ones * (rank + 1), H_split=False).numpy()
    # the convolution: output and both gradients
    x = torch.tensor(_rows(_nchw(inp["x"]), rank)).requires_grad_()
    w = torch.tensor(inp["w"].transpose(3, 2, 0, 1)).requires_grad_()
    y = spatial_conv2d(x, w, group)
    (y * torch.tensor(_rows(_nchw(inp["ct"]), rank))).sum().backward()
    out["conv"] = dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                       dw=w.grad.numpy())
    # the bottleneck
    m = _bottleneck(inp["block"], group)
    x = torch.tensor(_rows(_nchw(inp["bx"]), rank)).requires_grad_()
    y = m(x)
    (y * torch.tensor(_rows(_nchw(inp["bct"]), rank))).sum().backward()
    out["block"] = dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                        **{n: p.grad.numpy() for n, p in m.named_parameters()
                           if p.grad is not None})
    # a strided block cannot split H
    strided = Bottleneck(8, 4, 16, stride=2, spatial_axis=group, device="cpu")
    try:
        strided(torch.zeros(1, 8, 4, 4))
        out["strided"] = "no raise"
    except NotImplementedError as e:
        out["strided"] = str(e)
    return out


@pytest.fixture(scope="module")
def halo_world():
    inp = _inputs()
    return inp, run_world(_halo_world, SP, args=(inp,), timeout=150)


def _sp_map(fn, out_specs):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = Mesh(np.array(jax.devices()[:SP]), ("spatial",))
    return mesh, jax.jit(shard_map(fn, mesh=mesh,
                                   in_specs=(P(None, "spatial"),) * 2,
                                   out_specs=out_specs, **NO_REP_CHECK))


def _gather(ranks, key, sub=None):
    parts = [ranks[r][key] if sub is None else ranks[r][key][sub]
             for r in range(SP)]
    return np.concatenate(parts, axis=2)


# ---------------------------------------------------------------------------
# the world's cases
# ---------------------------------------------------------------------------


def test_halo_exchange_attaches_neighbor_rows(halo_world):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.contrib.halo import halo_exchange_1d

    inp, ranks = halo_world
    x = jnp.asarray(inp["rows"])
    mesh, f = _sp_map(lambda s, _: halo_exchange_1d(s, 1, "spatial"),
                      P(None, "spatial"))
    with mesh:
        want = _nchw(f(x, x))                       # [1, 3, 4 ranks * 4, 1]
    np.testing.assert_array_equal(_gather(ranks, "rows"), want)
    x_np = _nchw(inp["rows"])
    rank1 = ranks[1]["rows"]          # global rows 2:4, with halo rows 1:5
    np.testing.assert_array_equal(rank1[:, :, 1:3], x_np[:, :, 2:4])
    np.testing.assert_array_equal(rank1[:, :, 0], x_np[:, :, 1])
    np.testing.assert_array_equal(rank1[:, :, 3], x_np[:, :, 4])
    np.testing.assert_array_equal(ranks[0]["rows"][:, :, 0], 0)
    np.testing.assert_array_equal(ranks[SP - 1]["rows"][:, :, -1], 0)


def test_halo_exchanger_object_form(halo_world):
    _, ranks = halo_world
    for r in range(SP):
        h, w = ranks[r]["object_h"], ranks[r]["object_w"]
        assert h.shape == (1, 2, 2 + 2 * 2, 8)
        assert w.shape == (1, 2, 2, 8 + 2 * 2)
        # rows from the neighbors (each rank holds rank + 1), zeros past
        # the ends of the line
        np.testing.assert_array_equal(h[:, :, :2], r if r > 0 else 0)
        np.testing.assert_array_equal(h[:, :, 2:4], r + 1)
        np.testing.assert_array_equal(h[:, :, 4:], r + 2 if r < SP - 1 else 0)
        np.testing.assert_array_equal(w[..., :2], r if r > 0 else 0)


def test_spatial_conv_matches_jax_and_the_unsplit_conv(halo_world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.contrib.halo import spatial_conv2d

    inp, ranks = halo_world
    x, w, ct = (jnp.asarray(inp[k]) for k in ("x", "w", "ct"))

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def fn(xs, cts):
        def loss(xs, w):
            y = spatial_conv2d(xs, w, "spatial")
            return jnp.sum(y * cts), y

        (_, y), (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(xs, w)
        return y, dx, dw[None]

    mesh, f = _sp_map(fn, (P(None, "spatial"), P(None, "spatial"),
                           P("spatial")))
    with mesh:
        y, dx, dw = f(x, ct)
    dx_full, dw_full = jax.grad(lambda x, w: jnp.sum(conv(x, w) * ct),
                                argnums=(0, 1))(x, w)
    got = _gather(ranks, "conv", "y")
    np.testing.assert_allclose(got, _nchw(y), **TOL)
    np.testing.assert_allclose(got, _nchw(conv(x, w)), **TOL)
    np.testing.assert_allclose(_gather(ranks, "conv", "dx"), _nchw(dx), **TOL)
    np.testing.assert_allclose(_gather(ranks, "conv", "dx"), _nchw(dx_full),
                               **TOL)
    for r in range(SP):
        np.testing.assert_allclose(ranks[r]["conv"]["dw"],
                                   np.asarray(dw[r]).transpose(3, 2, 0, 1),
                                   **TOL)
    dw_sum = sum(ranks[r]["conv"]["dw"] for r in range(SP))
    np.testing.assert_allclose(dw_sum, np.asarray(dw_full).transpose(3, 2, 0, 1),
                               rtol=1e-4, atol=1e-4)


def test_spatial_bottleneck_matches_jax(halo_world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.contrib.halo import SpatialBottleneck as JaxBlock
    from apex_tpu_torch.models.convert import bottleneck_params_from_jax

    inp, ranks = halo_world
    x, ct = jnp.asarray(inp["bx"]), jnp.asarray(inp["bct"])
    params = inp["block"]
    spatial = JaxBlock(in_channels=8, bottleneck_channels=4, out_channels=8)
    dense = JaxBlock(in_channels=8, bottleneck_channels=4, out_channels=8,
                     spatial_axis=None)

    def fn(xs, cts):
        def loss(p, xs):
            y = spatial.apply({"params": p}, xs)
            return jnp.sum(y * cts), y

        (_, y), (gp, dx) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(params, xs)
        return y, dx, jax.tree.map(lambda a: a[None], gp)

    mesh, f = _sp_map(fn, (P(None, "spatial"), P(None, "spatial"),
                           P("spatial")))
    with mesh:
        y, dx, gp = f(x, ct)
    got = _gather(ranks, "block", "y")
    np.testing.assert_allclose(got, _nchw(y), **TOL)
    np.testing.assert_allclose(got, _nchw(dense.apply({"params": params}, x)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_gather(ranks, "block", "dx"), _nchw(dx),
                               **TOL)
    gp = jax.tree.map(np.asarray, gp)
    for r in range(SP):
        want = bottleneck_params_from_jax(jax.tree.map(lambda a: a[r], gp))
        for name in ("conv1", "conv2", "conv3"):
            np.testing.assert_allclose(ranks[r]["block"][name],
                                       want[name].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=f"rank {r} {name}")
        # the frozen pairs took no gradient on any rank (JAX: zeros)
        assert not any(k.startswith("bn") for k in ranks[r]["block"])
        assert all(np.all(want[k].numpy() == 0) for k in want
                   if k.startswith("bn"))


def test_strided_spatial_bottleneck_raises(halo_world):
    _, ranks = halo_world
    for r in range(SP):
        assert "resharding" in ranks[r]["strided"]


# ---------------------------------------------------------------------------
# no world
# ---------------------------------------------------------------------------


def test_frozen_bn_takes_no_gradient_and_convs_do():
    import jax

    from apex_tpu.contrib.halo import SpatialBottleneck as JaxBlock
    from apex_tpu_torch.contrib.halo import SpatialBottleneck
    from apex_tpu_torch.models.convert import bottleneck_params_from_jax

    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 4, 8)).astype(np.float32)    # NHWC
    jb = JaxBlock(in_channels=8, bottleneck_channels=4, out_channels=16,
                  stride=2, spatial_axis=None)
    params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0), x))
    m = SpatialBottleneck(8, 4, 16, stride=2, spatial_axis=None, device="cpu")
    m.load_state_dict(bottleneck_params_from_jax(params))
    xt = torch.tensor(_nchw(x))
    y = m(xt)
    np.testing.assert_allclose(y.detach().numpy(),
                               _nchw(jb.apply(params, x)), **TOL)
    (y ** 2).sum().backward()
    for name, p in m.named_parameters():
        if name.startswith("bn"):
            assert p.requires_grad and p.grad is None, name
        else:
            assert float(p.grad.abs().max()) > 0, name
    assert {n for n, _ in m.named_parameters() if n.startswith("bn")} == {
        f"{b}_{k}" for b in ("bn1", "bn2", "bn3", "bn_down")
        for k in ("scale", "bias")}


def test_halo_validation():
    from apex_tpu_torch.contrib.halo import (
        HaloExchanger1d,
        halo_exchange_1d,
        spatial_conv2d,
    )

    with pytest.raises(ValueError, match="odd"):
        spatial_conv2d(torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 2, 2), None)
    with pytest.raises(NotImplementedError, match="stride"):
        spatial_conv2d(torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3), None,
                       stride=2)
    with pytest.raises(ValueError, match="half_halo"):
        halo_exchange_1d(torch.zeros(1, 2, 1, 4), 2, None)
    with pytest.raises(ValueError, match="spatial_dim"):
        halo_exchange_1d(torch.zeros(1, 2, 4, 4), 1, None, spatial_dim=1)
    with pytest.raises(ValueError, match="ProcessGroup"):
        HaloExchanger1d("spatial", half_halo=1)
    # one rank: the unsplit SAME convolution (zero halos)
    x, w = torch.randn(1, 2, 6, 5), torch.randn(3, 2, 3, 3)
    torch.testing.assert_close(spatial_conv2d(x, w, None),
                               torch.nn.functional.conv2d(x, w, padding=1))
    torch.testing.assert_close(spatial_conv2d(x, w, None, spatial_dim=3),
                               torch.nn.functional.conv2d(x, w, padding=1))
