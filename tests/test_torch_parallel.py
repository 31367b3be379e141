"""Data parallelism: ``apex_tpu_torch.parallel`` in gloo worlds of spawned
ranks against ``apex_tpu.parallel`` under ``shard_map`` over virtual CPU
devices (and, for batch norm, against the JAX module's global batch
statistics on the whole batch, ``tests/test_parallel.py``'s reference).

- **world 4**: ``allreduce_grads`` over the predivide / fp32 / average
  combinations in fp32 and bf16 (fp32 to 1e-6 relative; bf16 to one bf16
  ulp of the largest value, as the two sum four values in different
  orders), ``broadcast_params`` from roots 0 and 3 (bit for bit) and its
  refusal of roots outside the group, ``Reducer``, and
  ``DistributedDataParallel``: the construction broadcast, the reduction
  after each backward with and without predivide, ``delay_allreduce``
  with two accumulated backwards and one ``sync``, ``shard_batch``,
  against JAX's gradients of the whole batch (1e-5).
- **world 2**: ``SyncBatchNorm``'s output, running statistics, input
  gradient (each rank's rows) and weight and bias gradients (summed over
  the ranks) against JAX's batch norm over the whole batch, in both
  channel layouts, with and without the fused ReLU (1e-5); the same
  backward with the all-reduce of its two sums removed (a forward-only
  sync) misses JAX's input gradient by far more than that.
- no world: the one-pass statistics against the Welford form and the
  clamp, channels-first statistics, the evaluation path, the conversion
  of ``nn.BatchNorm*d``, and ``LARC`` around ``FusedSGD`` against the JAX
  ``LARC`` (1e-6).

This module imports JAX only inside its fixtures and tests, so the
spawned ranks stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer.testing.distributed import run_world

W4, W2 = 4, 2
COMBOS = [dict(allreduce_always_fp32=False, gradient_predivide_factor=1.0,
               gradient_average=True),
          dict(allreduce_always_fp32=True, gradient_predivide_factor=4.0,
               gradient_average=True),
          dict(allreduce_always_fp32=False, gradient_predivide_factor=2.0,
               gradient_average=False),
          dict(allreduce_always_fp32=True, gradient_predivide_factor=1.0,
               gradient_average=False)]
BN_CASES = [dict(channel_axis=1, fuse_relu=False),
            dict(channel_axis=-1, fuse_relu=True)]
BN_N, BN_C, BN_L = 8, 6, 5


def _inputs():
    rng = np.random.default_rng(7)
    return dict(
        grads=rng.standard_normal((W4, 8, 3)).astype(np.float32),
        w=rng.standard_normal((3, 4)).astype(np.float32),
        b=rng.standard_normal((3,)).astype(np.float32),
        x=rng.standard_normal((2, 16, 4)).astype(np.float32),
        y=rng.standard_normal((2, 16, 3)).astype(np.float32))


def _bn_inputs(case):
    rng = np.random.default_rng(11)
    shape = ((BN_N, BN_C, BN_L) if case["channel_axis"] == 1
             else (BN_N, BN_L, BN_C))
    return dict(x=(2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32),
                ct=rng.standard_normal(shape).astype(np.float32),
                scale=(1.0 + 0.1 * rng.standard_normal(BN_C)).astype(np.float32),
                bias=(0.1 * rng.standard_normal(BN_C)).astype(np.float32))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _linear(w, b):
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    return lin


def _world4(rank, world, inp):
    import torch.distributed as dist

    from apex_tpu_torch.parallel import (
        DistributedDataParallel,
        Reducer,
        allreduce_grads,
        broadcast_params,
    )

    out = {"allreduce": []}
    for dtype in (torch.float32, torch.bfloat16):
        for kw in COMBOS:
            g = torch.tensor(inp["grads"][rank], dtype=dtype)
            allreduce_grads([g], **kw)
            out["allreduce"].append(g.float().numpy().copy())
    for root in (0, 3):
        t = torch.full((2, 2), float(rank)), torch.arange(3) * rank
        broadcast_params(t, root=root)
        out[f"bcast_{root}"] = [x.numpy() for x in t]
    out["bad_roots"] = []
    for root in (4, -1):
        try:
            broadcast_params([torch.zeros(1)], root=root)
        except ValueError as e:
            out["bad_roots"].append(str(e))
    t = torch.arange(4, dtype=torch.float32) + 10.0 * rank
    Reducer().reduce([t])
    out["reducer"] = t.numpy()
    red = Reducer(_linear(inp["w"] + rank, inp["b"]))
    out["reducer_broadcast"] = red.module.weight.detach().numpy()

    # DDP: rank-dependent weights broadcast from rank 0, each rank its rows
    x = torch.from_numpy(inp["x"])
    y = torch.from_numpy(inp["y"])
    rows = slice(rank * 4, rank * 4 + 4)
    for name, kw in (("ddp", {}),
                     ("ddp_predivide", dict(gradient_predivide_factor=2.0,
                                            allreduce_always_fp32=True))):
        ddp = DistributedDataParallel(_linear(inp["w"] + rank, inp["b"]), **kw)
        out[f"{name}_weight"] = ddp.module.weight.detach().numpy().copy()
        loss = ((ddp(x[0, rows]) - y[0, rows]) ** 2).mean()
        loss.backward()
        out[f"{name}_grads"] = [p.grad.numpy().copy()
                                for p in ddp.module.parameters()]
    ddp = DistributedDataParallel(_linear(inp["w"], inp["b"]),
                                  delay_allreduce=True)
    for k in range(2):
        ((ddp(x[k, rows]) - y[k, rows]) ** 2).mean().backward()
    out["delay_local"] = [p.grad.numpy().copy() for p in ddp.module.parameters()]
    ddp.sync()
    out["delay_synced"] = [p.grad.numpy().copy()
                           for p in ddp.module.parameters()]
    out["shard"] = ddp.shard_batch((x[0], y[0]))[0].numpy()
    rep = [torch.full((3,), float(rank))]
    ddp.replicate(rep)
    out["replicate"] = rep[0].numpy()
    out["world"] = dist.get_world_size()
    return out


def _bn_rank(rank, inp, case, group):
    from apex_tpu_torch.parallel import SyncBatchNorm

    ca = case["channel_axis"]
    rows = slice(rank * BN_N // W2, (rank + 1) * BN_N // W2)
    bn = SyncBatchNorm(BN_C, momentum=0.1, process_group=group,
                       channel_axis=ca, fuse_relu=case["fuse_relu"])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    x = torch.from_numpy(inp["x"][rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inp["ct"][rows])).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                dscale=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


def _world2(rank, world, cases):
    import torch.distributed as dist

    from apex_tpu_torch.parallel import sync_batchnorm

    out = []
    for case in cases:
        inp = _bn_inputs(case)
        res = _bn_rank(rank, inp, case, dist.group.WORLD)
        saved = sync_batchnorm._backward_all_reduce
        sync_batchnorm._backward_all_reduce = lambda t, group: t
        try:
            res["dx_forward_only_sync"] = _bn_rank(
                rank, inp, case, dist.group.WORLD)["dx"]
        finally:
            sync_batchnorm._backward_all_reduce = saved
        out.append(res)
    return out


@pytest.fixture(scope="module")
def world4():
    return _inputs(), run_world(_world4, W4, args=(_inputs(),), timeout=150)


@pytest.fixture(scope="module")
def world2():
    return run_world(_world2, W2, args=(BN_CASES,), timeout=150)


def _mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("dp",))


def _shard_map(fn, n):
    import jax
    from jax.sharding import PartitionSpec as P

    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    # without the replication check: a gradient taken inside the map stays
    # the device's own (with it, JAX sums gradients of replicated inputs)
    return jax.jit(shard_map(fn, mesh=_mesh(n), in_specs=(P("dp"),),
                             out_specs=P("dp"), **NO_REP_CHECK))


# ---------------------------------------------------------------------------
# world 4: the reductions and the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combo", range(len(COMBOS)))
def test_allreduce_grads_matches_jax(world4, dtype, combo):
    import jax.numpy as jnp

    from apex_tpu.parallel import allreduce_grads

    inp, ranks = world4
    kw = COMBOS[combo]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    g = jnp.asarray(inp["grads"].reshape(W4 * 8, 3), jdt)
    want = np.asarray(_shard_map(lambda t: allreduce_grads(t, "dp", **kw),
                                 W4)(g), np.float32).reshape(W4, 8, 3)
    idx = (0 if dtype == "float32" else len(COMBOS)) + combo
    for r in range(W4):
        got = ranks[r]["allreduce"][idx]
        if dtype == "float32":
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6)
        else:
            ulp = float(np.abs(want[r]).max()) * 2.0 ** -7
            np.testing.assert_allclose(got, want[r], rtol=0, atol=ulp)


@pytest.mark.parametrize("root", [0, 3])
def test_broadcast_params_matches_jax(world4, root):
    import jax.numpy as jnp

    from apex_tpu.parallel import broadcast_params

    _, ranks = world4
    x = jnp.repeat(jnp.arange(W4, dtype=jnp.float32), 4).reshape(W4 * 2, 2)
    want = np.asarray(_shard_map(
        lambda t: broadcast_params(t, "dp", root=root), W4)(x))
    for r in range(W4):
        np.testing.assert_array_equal(ranks[r][f"bcast_{root}"][0],
                                      want[2 * r:2 * r + 2])
        np.testing.assert_array_equal(ranks[r][f"bcast_{root}"][1],
                                      np.arange(3) * root)


def test_broadcast_params_refuses_roots_outside_the_group(world4):
    _, ranks = world4
    for r in range(W4):
        assert len(ranks[r]["bad_roots"]) == 2
        for msg, root in zip(ranks[r]["bad_roots"], (4, -1)):
            assert f"root {root} is outside the group of size 4" in msg


def test_reducer_matches_jax(world4):
    import jax.numpy as jnp

    from apex_tpu.parallel import Reducer

    _, ranks = world4
    x = (jnp.arange(4, dtype=jnp.float32)[None]
         + 10.0 * jnp.arange(W4, dtype=jnp.float32)[:, None])
    want = np.asarray(_shard_map(lambda t: Reducer("dp").reduce(t), W4)(x))
    for r in range(W4):
        np.testing.assert_allclose(ranks[r]["reducer"], want[r], rtol=1e-6)
        # the module form broadcast rank 0's weights at construction
        np.testing.assert_array_equal(ranks[r]["reducer_broadcast"],
                                      ranks[0]["reducer_broadcast"])


def _jax_linear_grads(inp, batches):
    """JAX's gradients of the mean squared error of the whole batch of
    each of ``batches`` (summed), for W, b (rank 0's weights)."""
    import jax
    import jax.numpy as jnp

    def loss(w, b, x, y):
        return jnp.mean((x @ w.T + b - y) ** 2)

    gw = gb = 0.0
    for k in batches:
        dw, db = jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(inp["w"]), jnp.asarray(inp["b"]),
            jnp.asarray(inp["x"][k]), jnp.asarray(inp["y"][k]))
        gw, gb = gw + np.asarray(dw), gb + np.asarray(db)
    return [gw, gb]


@pytest.mark.parametrize("name", ["ddp", "ddp_predivide"])
def test_ddp_averages_after_backward_like_the_whole_batch(world4, name):
    inp, ranks = world4
    want = _jax_linear_grads(inp, [0])
    for r in range(W4):
        np.testing.assert_array_equal(ranks[r][f"{name}_weight"], inp["w"])
        for got, ref in zip(ranks[r][f"{name}_grads"], want):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_ddp_delay_allreduce_then_sync_matches_jax(world4):
    import jax
    import jax.numpy as jnp

    from apex_tpu.parallel import DistributedDataParallel

    inp, ranks = world4
    ddp = DistributedDataParallel(axis_name="dp", delay_allreduce=True)

    def local(w, b, x, y):
        return jnp.mean((x @ w.T + b - y) ** 2)

    # device r holds rows 4r..4r+4 of both micro-batches, x and y side by side
    xy = np.concatenate([inp["x"], inp["y"]], -1).reshape(2, W4, 4, 7)
    xy = jnp.asarray(xy.transpose(1, 0, 2, 3).reshape(W4 * 8, 7))

    def step(rows):
        rows = rows.reshape(2, 4, 7)
        g = [0.0, 0.0]
        for k in range(2):
            dw, db = jax.grad(local, argnums=(0, 1))(
                jnp.asarray(inp["w"]), jnp.asarray(inp["b"]),
                rows[k, :, :4], rows[k, :, 4:])
            g = [g[0] + dw, g[1] + db]
        unsynced = ddp.allreduce(g)
        synced = ddp.sync(unsynced)
        return jnp.concatenate([unsynced[0].ravel(), unsynced[1],
                                synced[0].ravel(), synced[1]])[None]

    out = np.asarray(_shard_map(step, W4)(xy))
    for r in range(W4):
        local_w, local_b, sync_w, sync_b = np.split(out[r], [12, 15, 27])
        got = ranks[r]
        np.testing.assert_allclose(got["delay_local"][0].ravel(), local_w,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["delay_local"][1], local_b,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["delay_synced"][0].ravel(), sync_w,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["delay_synced"][1], sync_b,
                                   rtol=1e-5, atol=1e-6)
    # the synced gradient is the whole batch's, both micro-batches summed
    want = _jax_linear_grads(inp, [0, 1])
    np.testing.assert_allclose(ranks[0]["delay_synced"][0], want[0],
                               rtol=1e-5, atol=1e-6)


def test_ddp_shard_batch_and_replicate_over_the_group(world4):
    inp, ranks = world4
    for r in range(W4):
        np.testing.assert_array_equal(ranks[r]["shard"],
                                      inp["x"][0, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(ranks[r]["replicate"], np.zeros(3))
        assert ranks[r]["world"] == W4


# ---------------------------------------------------------------------------
# world 2: SyncBatchNorm against JAX's global batch norm
# ---------------------------------------------------------------------------


def _jax_global_bn(case):
    """JAX's batch norm over the whole batch: output, running statistics
    and the vjp of the cotangent (input, scale and bias gradients)."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.parallel import SyncBatchNorm

    inp = _bn_inputs(case)
    bn = SyncBatchNorm(momentum=0.1, channel_axis=case["channel_axis"],
                       fuse_relu=case["fuse_relu"])
    x = jnp.asarray(inp["x"])
    v = bn.init(jax.random.PRNGKey(0), x)
    params = {"scale": jnp.asarray(inp["scale"]),
              "bias": jnp.asarray(inp["bias"])}

    def f(p, x):
        y, upd = bn.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return y, upd

    y, upd = f(params, x)
    _, vjp = jax.vjp(lambda p, x: f(p, x)[0], params, x)
    dp, dx = vjp(jnp.asarray(inp["ct"]))
    return dict(y=np.asarray(y), dx=np.asarray(dx),
                dscale=np.asarray(dp["scale"]), dbias=np.asarray(dp["bias"]),
                mean=np.asarray(upd["batch_stats"]["mean"]),
                var=np.asarray(upd["batch_stats"]["var"]))


@pytest.mark.parametrize("case", range(len(BN_CASES)),
                         ids=["channels_first", "channels_last_relu"])
def test_syncbn_world2_matches_jax_global_bn(world2, case):
    want = _jax_global_bn(BN_CASES[case])
    ranks = [world2[r][case] for r in range(W2)]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                               want["y"], **tol)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]),
                               want["dx"], **tol)
    # each rank's weight and bias gradients are its own rows' sums: the
    # data-parallel reduction adds them up to the global batch's
    np.testing.assert_allclose(sum(r["dscale"] for r in ranks),
                               want["dscale"], **tol)
    np.testing.assert_allclose(sum(r["dbias"] for r in ranks),
                               want["dbias"], **tol)
    for r in ranks:   # the running variance is unbiased over the global count
        np.testing.assert_allclose(r["mean"], want["mean"], **tol)
        np.testing.assert_allclose(r["var"], want["var"], **tol)


@pytest.mark.parametrize("case", range(len(BN_CASES)),
                         ids=["channels_first", "channels_last_relu"])
def test_syncbn_forward_only_sync_misses_the_input_gradient(world2, case):
    """Without the backward's all-reduce each rank normalizes its gradient
    by its own rows' sums: far outside the tolerance the real backward
    meets."""
    want = _jax_global_bn(BN_CASES[case])["dx"]
    got = np.concatenate([world2[r][case]["dx_forward_only_sync"]
                          for r in range(W2)])
    assert np.abs(got - want).max() > 100 * (1e-5 + 1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# no world
# ---------------------------------------------------------------------------


def test_fast_variance_matches_welford_and_clamps():
    import jax.numpy as jnp

    from apex_tpu.parallel import sync_batch_stats as jstats
    from apex_tpu_torch.parallel import sync_batch_stats

    rng = np.random.default_rng(1234)
    x = rng.normal(2.0, 3.0, (8, 16, 16, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    m_fast, v_fast, n_fast = sync_batch_stats(xt, -1, use_fast_variance=True)
    m_ref, v_ref, n_ref = sync_batch_stats(xt, -1, use_fast_variance=False)
    np.testing.assert_allclose(m_fast, m_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v_fast, v_ref, rtol=1e-4, atol=1e-5)
    assert float(n_fast) == float(n_ref) == 8 * 16 * 16
    for fast in (True, False):
        jm, jv, _ = jstats(jnp.asarray(x), use_fast_variance=fast)
        pm, pv, _ = sync_batch_stats(xt, -1, use_fast_variance=fast)
        np.testing.assert_allclose(pm, np.asarray(jm), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pv, np.asarray(jv), rtol=1e-5, atol=1e-5)
    bad = torch.from_numpy((1e4 + rng.normal(0.0, 1e-2, (4, 8, 8, 4))
                            ).astype(np.float32))
    _, v_bad, _ = sync_batch_stats(bad, -1, use_fast_variance=True)
    assert bool(torch.all(v_bad >= 0.0))
    assert bool(torch.all(torch.isfinite(torch.rsqrt(v_bad + 1e-5))))


def test_sync_batch_stats_channels_first_matches_jax():
    import jax.numpy as jnp

    from apex_tpu.parallel import sync_batch_stats as jstats
    from apex_tpu_torch.parallel import sync_batch_stats

    x = np.random.default_rng(1234).standard_normal((4, 7, 5)).astype(np.float32)
    mean, var, n = sync_batch_stats(torch.from_numpy(x))   # channel dim 1
    jm, jv, jn = jstats(jnp.asarray(x), channel_axis=1)
    np.testing.assert_allclose(mean, np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, np.asarray(jv), rtol=1e-5, atol=1e-6)
    assert float(n) == float(jn) == 20


def test_syncbn_eval_and_relu_match_jax():
    import jax
    import jax.numpy as jnp

    from apex_tpu.parallel import SyncBatchNorm as JBN
    from apex_tpu_torch.parallel import SyncBatchNorm

    x = np.random.default_rng(1234).standard_normal((4, 3)).astype(np.float32)
    jbn = JBN(fuse_relu=True)
    want = jbn.apply(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                     jnp.asarray(x), use_running_average=True)
    bn = SyncBatchNorm(3, fuse_relu=True).eval()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert float(got.detach().min()) >= 0.0


def test_syncbn_half_input_keeps_fp32_parameters():
    from apex_tpu_torch.parallel import SyncBatchNorm

    bn = SyncBatchNorm(4)
    assert bn.channel_axis == 1      # PyTorch's layout; the JAX module's is -1
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    y = bn(x.to(torch.bfloat16).requires_grad_())
    assert y.dtype == torch.bfloat16 and bn.weight.dtype == torch.float32
    y.float().sum().backward()
    assert bn.weight.grad.dtype == torch.float32


def test_convert_syncbn_model_carries_weights_and_buffers():
    from apex_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              torch.nn.BatchNorm2d(4, momentum=0.2),
                              torch.nn.Sequential(torch.nn.BatchNorm2d(4)))
    x = torch.randn(2, 3, 6, 6)
    net(x)                          # running statistics off their init
    with torch.no_grad():
        net[1].weight.mul_(1.5)
    ref = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    states = [{k: v.clone() for k, v in m.state_dict().items()} for m in ref]
    net.eval()
    want = net(x)
    converted = convert_syncbn_model(net, process_group=None)
    bns = [m for m in converted.modules() if isinstance(m, SyncBatchNorm)]
    assert len(bns) == 2 and converted is net
    assert not any(type(m) is torch.nn.BatchNorm2d for m in converted.modules())
    assert abs(bns[0].momentum - 0.2) < 1e-9 and bns[0].process_group is None
    for bn, st in zip(bns, states):
        for k, v in st.items():
            torch.testing.assert_close(bn.state_dict()[k], v, rtol=0, atol=0)
    torch.testing.assert_close(converted(x), want, rtol=1e-5, atol=1e-5)
    lone = convert_syncbn_model(torch.nn.BatchNorm1d(3))
    assert isinstance(lone, SyncBatchNorm)


def _larc_case(kind, rng):
    if kind == "big_params":
        return dict(p=rng.standard_normal((8, 8)) * 10,
                    g=rng.standard_normal((8, 8)) * 1e-3, wd=0.0, clip=True)
    if kind == "tiny_params":
        return dict(p=rng.standard_normal((8, 8)) * 1e-3,
                    g=rng.standard_normal((8, 8)), wd=0.0, clip=True)
    if kind == "no_clip_wd":
        return dict(p=rng.standard_normal((8, 8)),
                    g=rng.standard_normal((8, 8)) * 0.1, wd=1e-2, clip=False)
    return None


@pytest.mark.parametrize("kind", ["big_params", "tiny_params", "no_clip_wd",
                                  "zero_norms"])
def test_larc_matches_jax(kind):
    import jax.numpy as jnp

    from apex_tpu.optimizers import FusedSGD as JSGD
    from apex_tpu.parallel import LARC as JLARC
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import LARC

    rng = np.random.default_rng(1234)
    if kind == "zero_norms":
        # a zero parameter and a zero gradient: no fold, no scaling
        params = {"v": rng.standard_normal((4, 4)), "w": np.zeros((4, 4))}
        grads = {"v": np.zeros((4, 4)), "w": rng.standard_normal((4, 4))}
        wd, clip = 0.5, True
    else:
        c = _larc_case(kind, rng)
        params, grads, wd, clip = {"w": c["p"]}, {"w": c["g"]}, c["wd"], c["clip"]
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = {k: v.astype(np.float32) for k, v in grads.items()}
    jopt = JLARC(JSGD(lr=0.1, weight_decay=wd), trust_coefficient=0.02,
                 clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, _ = jopt.step({k: jnp.asarray(v) for k, v in grads.items()}, jp,
                        jopt.init(jp))
    keys = sorted(params)
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in keys]
    for p, k in zip(ps, keys):
        p.grad = torch.from_numpy(grads[k].copy())
    opt = LARC(FusedSGD(ps, lr=0.1, weight_decay=wd), trust_coefficient=0.02,
               clip=clip)
    opt.step()
    assert opt.param_groups[0]["weight_decay"] == wd   # restored
    for p, k in zip(ps, keys):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_larc_refuses_a_grad_scale():
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import LARC

    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.ones(3)
    with pytest.raises(ValueError, match="unscale"):
        LARC(FusedSGD([p], lr=0.1)).step(grad_scale=2.0)


def test_parallel_exports_the_jax_names():
    import apex_tpu.parallel as jp
    import apex_tpu_torch.parallel as tp

    assert sorted(tp.__all__) == sorted(jp.__all__)
    for name in tp.__all__:
        assert hasattr(tp, name)
