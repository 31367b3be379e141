"""The port's tensor-parallel primitives at tp 4 against the JAX package's.

Mirrors ``tests/test_tensor_parallel.py``: parallel state, each mapping's
forward and gradient, the gather / scatter and sequence-parallel round
trips, the column / row / vocab layers against the dense product, and the
vocab-parallel cross-entropy with smoothing and its gradient.  The port's
four ranks run in one gloo world of spawned processes (one module-scoped
world runs every scenario); the JAX functions run here, in ``shard_map``
over four of the eight virtual CPU devices, on the same numpy inputs and
the same weights (each rank holds its slice of one numpy weight).
Tolerances: fp32, ``rtol = atol = 1e-5`` unless a test says tighter;
collectives that move bytes without arithmetic are held bit for bit.

This module imports JAX only inside its fixtures and tests: the spawned
ranks import it to find :func:`_tp4_world`, and stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.testing.distributed import run_world

TP = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(1234)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "x48": f(4, 8), "full816": f(8, 16), "seq84": f(8, 4),
        # column: x [6, 16] -> 32 (torch weight [32, 16]); target t
        "col_x": f(6, 16), "col_w": f(32, 16) * 0.25, "col_b": f(32),
        "col_t": f(6, 32),
        # row: x [6, 16] -> 8 (torch weight [8, 16])
        "row_x": f(6, 16), "row_w": f(8, 16) * 0.25, "row_b": f(8),
        # sequence-parallel pair: [s 8, b 2, h 16] -> ffn 32 -> 16
        "sp_x": f(8, 2, 16), "sp_wc": f(32, 16) * 0.25, "sp_bc": f(32),
        "sp_wr": f(16, 32) * 0.2, "sp_br": f(16),
        "emb_ids": rng.integers(0, 32, (3, 5)).astype(np.int64),
        "emb_w": f(32, 8),
        "ce_logits": f(2, 6, 32), "ce_target":
            rng.integers(0, 32, (2, 6)).astype(np.int64),
        "ceg_logits": f(4, 32), "ceg_target":
            rng.integers(0, 32, (4,)).astype(np.int64),
    }


def _chunk(a, dim, rank, n=TP):
    c = a.shape[dim] // n
    return np.take(a, np.arange(rank * c, (rank + 1) * c), axis=dim)


def _set(layer, **tensors):
    with torch.no_grad():
        for name, arr in tensors.items():
            getattr(layer, name).copy_(torch.from_numpy(np.ascontiguousarray(
                arr)))


def _tp4_world(rank, world, inp):
    """Every scenario on one rank of the tp 4 gloo world."""
    import torch.distributed as dist

    out = {}
    T = {k: torch.from_numpy(v) for k, v in inp.items()}
    # ---- parallel state ------------------------------------------------
    with pytest.raises(RuntimeError, match="not divisible"):
        tps.initialize_model_parallel(3)
    with pytest.raises(RuntimeError, match="greater than 1"):
        tps.initialize_model_parallel(2, 1, 2)
    # pp 2 x tp 2: the JAX mesh's rank order, pipeline stage rank // 2
    out["pp2"] = (tps.initialize_model_parallel(2, 2),
                  tps.get_pipeline_model_parallel_rank(),
                  tps.get_tensor_model_parallel_rank(),
                  tps.is_pipeline_first_stage(), tps.is_pipeline_last_stage())
    tps.destroy_model_parallel()
    assert not tps.model_parallel_is_initialized()
    out["sizes"] = tps.initialize_model_parallel(TP)
    out["state"] = (tps.get_tensor_model_parallel_world_size(),
                    tps.get_pipeline_model_parallel_world_size(),
                    tps.get_data_parallel_world_size(),
                    tps.get_model_parallel_world_size(),
                    tps.get_tensor_model_parallel_rank(),
                    tps.get_data_parallel_rank(),
                    tps.get_pipeline_model_parallel_rank(),
                    tps.model_parallel_is_initialized(),
                    tps.get_rank_info(), tps.mesh_axis_sizes())
    with pytest.raises(RuntimeError, match="already initialized"):
        tps.initialize_model_parallel(TP)
    group = tps.get_tensor_model_parallel_group()
    assert tps.serving_group(TP) is group
    with pytest.raises(RuntimeError, match="world"):
        tps.serving_group(2)
    r1 = float(rank + 1)
    with ttp.tensor_parallel_region() as g:
        assert g is group and ttp.tp_world_size() == TP
        # copy: identity forward, all-reduce backward (sum r+1 = 10)
        x = T["x48"].clone().requires_grad_()
        y = ttp.copy_to_tensor_model_parallel_region(x)
        (y.sum() * r1).backward()
        out["copy"] = (y.detach().numpy(), x.grad.numpy())
        # reduce: all-reduce forward, identity backward
        x = T["x48"].clone().requires_grad_()
        y = ttp.reduce_from_tensor_model_parallel_region(x * r1)
        (y.sum() * r1).backward()
        out["reduce"] = (y.detach().numpy(), x.grad.numpy())
        # scatter the last dim / all-gather backward
        x = T["full816"].clone().requires_grad_()
        y = ttp.scatter_to_tensor_model_parallel_region(x)
        (y * r1).sum().backward()
        out["scatter"] = (y.detach().numpy(), x.grad.numpy())
        # gather the last dim / split backward
        x = torch.from_numpy(_chunk(inp["full816"], 1, rank)).requires_grad_()
        y = ttp.gather_from_tensor_model_parallel_region(x)
        (y * torch.arange(16.0)).sum().backward()
        out["gather"] = (y.detach().numpy(), x.grad.numpy())
        # sequence parallel: scatter dim 0 then gather it back
        x = T["seq84"].clone().requires_grad_()
        mine = ttp.scatter_to_sequence_parallel_region(x)
        back = ttp.gather_from_sequence_parallel_region(mine, None, True)
        (back * r1).sum().backward()
        out["sp_roundtrip"] = (mine.detach().numpy(), back.detach().numpy(),
                               x.grad.numpy())
        # gather with a plain-split backward
        x = torch.from_numpy(_chunk(inp["seq84"], 0, rank)).requires_grad_()
        y = ttp.gather_from_sequence_parallel_region(x, None, False)
        (y * r1).sum().backward()
        out["sp_gather_split"] = x.grad.numpy()
        # reduce-scatter of ones: 4s; backward all-gathers
        x = torch.ones(8, 2, requires_grad=True)
        y = ttp.reduce_scatter_to_sequence_parallel_region(x)
        (y * r1).sum().backward()
        out["rs"] = (y.detach().numpy(), x.grad.numpy())

        # ---- layers ----------------------------------------------------
        col = ttp.ColumnParallelLinear(16, 32, gather_output=True,
                                       device="cpu")
        assert tuple(col.weight.shape) == (8, 16) and col.world == TP
        _set(col, weight=_chunk(inp["col_w"], 0, rank),
             bias=_chunk(inp["col_b"], 0, rank))
        x = T["col_x"].clone().requires_grad_()
        y = col(x)
        loss = torch.mean((y - T["col_t"]) ** 2)
        loss.backward()
        out["col"] = (y.detach().numpy(), col.weight.grad.numpy(),
                      col.bias.grad.numpy(), x.grad.numpy())

        row = ttp.RowParallelLinear(16, 8, input_is_parallel=False,
                                    device="cpu")
        assert tuple(row.weight.shape) == (8, 4)
        _set(row, weight=_chunk(inp["row_w"], 1, rank), bias=inp["row_b"])
        x = T["row_x"].clone().requires_grad_()
        y = row(x)
        (y ** 2).mean().backward()
        out["row"] = (y.detach().numpy(), row.weight.grad.numpy(),
                      x.grad.numpy())

        c = ttp.ColumnParallelLinear(16, 32, gather_output=False,
                                     sequence_parallel_enabled=True,
                                     device="cpu")
        r = ttp.RowParallelLinear(32, 16, input_is_parallel=True,
                                  sequence_parallel_enabled=True,
                                  device="cpu")
        _set(c, weight=_chunk(inp["sp_wc"], 0, rank),
             bias=_chunk(inp["sp_bc"], 0, rank))
        _set(r, weight=_chunk(inp["sp_wr"], 1, rank), bias=inp["sp_br"])
        x = torch.from_numpy(_chunk(inp["sp_x"], 0, rank)).requires_grad_()
        y = r(c(x))
        (y ** 2).sum().backward()
        out["sp_pair"] = (y.detach().numpy(), x.grad.numpy(),
                          c.weight.grad.numpy(), r.weight.grad.numpy())

        emb = ttp.VocabParallelEmbedding(32, 8, device="cpu")
        assert tuple(emb.weight.shape) == (8, 8)
        _set(emb, weight=_chunk(inp["emb_w"], 0, rank))
        y = emb(T["emb_ids"])
        y.sum().backward()
        out["emb"] = (y.detach().numpy(), emb.weight.grad.numpy())

        for sm in (0.0, 0.1):
            lg = torch.from_numpy(_chunk(inp["ce_logits"], 2, rank))
            out[f"ce_{sm}"] = ttp.vocab_parallel_cross_entropy(
                lg, T["ce_target"], sm).numpy()
        lg = torch.from_numpy(_chunk(inp["ceg_logits"], 1, rank)
                              ).requires_grad_()
        ttp.vocab_parallel_cross_entropy(lg, T["ceg_target"]).mean(
        ).backward()
        out["ce_grad"] = lg.grad.numpy()

        # shards drawn inside the region differ by rank, and the same
        # seed draws the same shards again
        gen = torch.Generator().manual_seed(5)
        a = ttp.ColumnParallelLinear(16, 32, device="cpu", generator=gen)
        gen = torch.Generator().manual_seed(5)
        b = ttp.ColumnParallelLinear(16, 32, device="cpu", generator=gen)
        out["init"] = (a.weight.detach().numpy(), b.weight.detach().numpy())
    # a sharded layer outside its region refuses to run
    with pytest.raises(RuntimeError, match="built for tp world 4"):
        col(T["col_x"])
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def inp():
    return _inputs()


@pytest.fixture(scope="module")
def port(inp):
    return run_world(_tp4_world, TP, args=(inp,), timeout=120)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer import tensor_parallel as jtp
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:TP]), ("tp",))

    def smap(f, in_specs, out_specs):
        return jax.jit(shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, **NO_REP_CHECK))

    class NS:
        pass

    ns = NS()
    ns.jax, ns.jnp, ns.P, ns.tp, ns.smap = jax, jnp, P, jtp, smap
    return ns


def _ranks(port, key, i=None):
    vals = [r[key] if i is None else r[key][i] for r in port]
    return vals


def test_parallel_state(port):
    for rank, r in enumerate(port):
        assert r["pp2"] == ({"dp": 1, "pp": 2, "tp": 2}, rank // 2,
                            rank % 2, rank < 2, rank >= 2)
        assert r["sizes"] == {"dp": 1, "pp": 1, "tp": TP}
        st = r["state"]
        assert st[:8] == (TP, 1, 1, TP, rank, 0, 0, True)
        assert st[8] == f"mesh(dp=1, pp=1, tp={TP}), process={rank}"
        assert st[9] == {"dp": 1, "pp": 1, "tp": TP}


def test_parallel_state_outside_a_world():
    assert not tps.model_parallel_is_initialized()
    assert tps.mesh_axis_sizes() is None
    assert tps.get_rank_info() == "uninitialized"
    with pytest.raises(RuntimeError, match="init_process_group"):
        tps.serving_group(2)
    with pytest.raises(AssertionError):
        tps.get_tensor_model_parallel_group()


def test_copy_and_reduce_match_jax(port, inp, jx):
    P = jx.P
    x = jx.jnp.asarray(inp["x48"])

    def copy_grad(x):
        def loss(x):
            y = jx.tp.copy_to_tensor_model_parallel_region(x)
            r = jx.jax.lax.axis_index("tp").astype(jx.jnp.float32)
            return jx.jnp.sum(y) * (r + 1.0)
        return jx.jax.grad(loss)(x)

    g = np.asarray(jx.smap(copy_grad, (P(),), P(None))(x))
    for y, gx in _ranks(port, "copy"):
        np.testing.assert_array_equal(y, inp["x48"])
        np.testing.assert_array_equal(gx, g)          # 10 everywhere

    def reduce_fwd(x):
        r = jx.jax.lax.axis_index("tp").astype(jx.jnp.float32)
        return jx.tp.reduce_from_tensor_model_parallel_region(x * (r + 1.0))

    want = np.asarray(jx.smap(reduce_fwd, (P(),), P(None))(x))
    for rank, (y, gx) in enumerate(_ranks(port, "reduce")):
        np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)
        # identity backward: d(sum(y) (r+1))/dx = (r+1)^2
        np.testing.assert_array_equal(gx, float(rank + 1) ** 2)


def test_gather_scatter_match_jax(port, inp, jx):
    P = jx.P
    full = jx.jnp.asarray(inp["full816"])
    gathered = np.asarray(jx.smap(
        jx.tp.gather_from_tensor_model_parallel_region,
        (P(None, "tp"),), P(None, None))(full))
    np.testing.assert_array_equal(gathered, inp["full816"])

    def scatter_grad(x):
        def loss(x):
            y = jx.tp.scatter_to_tensor_model_parallel_region(x)
            r = jx.jax.lax.axis_index("tp").astype(jx.jnp.float32)
            return jx.jnp.sum(y * (r + 1.0))
        y = jx.tp.scatter_to_tensor_model_parallel_region(x)
        return y, jx.jax.grad(loss)(x)

    ys, g = jx.smap(scatter_grad, (P(),), (P(None, "tp"), P(None)))(full)
    for rank, (y, gx) in enumerate(_ranks(port, "scatter")):
        np.testing.assert_array_equal(y, _chunk(np.asarray(ys), 1, rank))
        np.testing.assert_array_equal(gx, np.asarray(g))
    for rank, (y, gx) in enumerate(_ranks(port, "gather")):
        np.testing.assert_array_equal(y, inp["full816"])
        np.testing.assert_array_equal(gx, np.arange(16.0, dtype=np.float32)[
            rank * 4:(rank + 1) * 4][None].repeat(8, 0))


def test_sequence_parallel_round_trips_match_jax(port, inp, jx):
    P = jx.P
    full = jx.jnp.asarray(inp["seq84"])

    def sp(x):
        def loss(x):
            mine = jx.tp.scatter_to_sequence_parallel_region(x)
            back = jx.tp.gather_from_sequence_parallel_region(mine, None,
                                                              True)
            r = jx.jax.lax.axis_index("tp").astype(jx.jnp.float32)
            return jx.jnp.sum(back * (r + 1.0))
        mine = jx.tp.scatter_to_sequence_parallel_region(x)
        return mine, jx.jax.grad(loss)(x)

    mines, g = jx.smap(sp, (P(),), (P("tp"), P(None)))(full)
    for rank, (mine, back, gx) in enumerate(_ranks(port, "sp_roundtrip")):
        np.testing.assert_array_equal(mine, _chunk(np.asarray(mines), 0,
                                                   rank))
        np.testing.assert_array_equal(back, inp["seq84"])
        np.testing.assert_allclose(gx, np.asarray(g), rtol=1e-6)

    def split_grad(x):
        def loss(x):
            y = jx.tp.gather_from_sequence_parallel_region(x, None, False)
            r = jx.jax.lax.axis_index("tp").astype(jx.jnp.float32)
            return jx.jnp.sum(y * (r + 1.0))
        return jx.jax.grad(loss)(x)

    g = np.asarray(jx.smap(split_grad, (P("tp"),), P("tp"))(full))
    for rank, gx in enumerate(_ranks(port, "sp_gather_split")):
        np.testing.assert_array_equal(gx, _chunk(g, 0, rank))

    def rs(x):
        def loss(x):
            y = jx.tp.reduce_scatter_to_sequence_parallel_region(x)
            r = jx.jax.lax.axis_index("tp").astype(jx.jnp.float32)
            return jx.jnp.sum(y * (r + 1.0))
        return (jx.tp.reduce_scatter_to_sequence_parallel_region(x),
                jx.jax.grad(loss)(x))

    ys, g = jx.smap(rs, (P(),), (P("tp"), P(None)))(jx.jnp.ones((8, 2)))
    for rank, (y, gx) in enumerate(_ranks(port, "rs")):
        np.testing.assert_array_equal(y, 4.0)
        np.testing.assert_array_equal(y, _chunk(np.asarray(ys), 0, rank))
        np.testing.assert_array_equal(gx, np.asarray(g))


def test_column_parallel_linear_matches_jax_and_dense(port, inp, jx):
    P, jnp = jx.P, jx.jnp
    col = jx.tp.ColumnParallelLinear(16, 32, gather_output=True)
    kfull, bfull = inp["col_w"].T, inp["col_b"]

    def run(x, k, b, t):
        def loss(p, x):
            y = col.apply({"params": p}, x)
            return jnp.mean((y - t) ** 2)
        p = {"kernel": k, "bias": b}
        y = col.apply({"params": p}, x)
        gp, gx = jx.jax.grad(loss, argnums=(0, 1))(p, x)
        return y, gp["kernel"], gp["bias"], gx

    y, gk, gb, gx = jx.smap(
        run, (P(), P(None, "tp"), P("tp"), P()),
        (P(None), P(None, "tp"), P("tp"), P(None)))(
        jnp.asarray(inp["col_x"]), jnp.asarray(kfull), jnp.asarray(bfull),
        jnp.asarray(inp["col_t"]))
    dense = inp["col_x"] @ kfull + bfull
    np.testing.assert_allclose(np.asarray(y), dense, **TOL)
    for rank, (py, pgw, pgb, pgx) in enumerate(_ranks(port, "col")):
        np.testing.assert_allclose(py, np.asarray(y), **TOL)
        np.testing.assert_allclose(pgw, _chunk(np.asarray(gk).T, 0, rank),
                                   **TOL)
        np.testing.assert_allclose(pgb, _chunk(np.asarray(gb), 0, rank),
                                   **TOL)
        np.testing.assert_allclose(pgx, np.asarray(gx), **TOL)


def test_row_parallel_linear_matches_jax_and_dense(port, inp, jx):
    P, jnp = jx.P, jx.jnp
    row = jx.tp.RowParallelLinear(16, 8, input_is_parallel=False)
    kfull = inp["row_w"].T

    def run(x, k, b):
        def loss(p, x):
            return jnp.mean(row.apply({"params": p}, x) ** 2)
        p = {"kernel": k, "bias": b}
        y = row.apply({"params": p}, x)
        gp, gx = jx.jax.grad(loss, argnums=(0, 1))(p, x)
        return y, gp["kernel"], gx

    y, gk, gx = jx.smap(run, (P(), P("tp", None), P()),
                        (P(None), P("tp", None), P(None)))(
        jnp.asarray(inp["row_x"]), jnp.asarray(kfull),
        jnp.asarray(inp["row_b"]))
    dense = inp["row_x"] @ kfull + inp["row_b"]
    np.testing.assert_allclose(np.asarray(y), dense, **TOL)
    for rank, (py, pgw, pgx) in enumerate(_ranks(port, "row")):
        np.testing.assert_allclose(py, np.asarray(y), **TOL)
        np.testing.assert_allclose(pgw, _chunk(np.asarray(gk).T, 1, rank),
                                   **TOL)
        np.testing.assert_allclose(pgx, np.asarray(gx), **TOL)


def test_column_row_pair_sequence_parallel_matches_jax(port, inp, jx):
    P, jnp = jx.P, jx.jnp
    col = jx.tp.ColumnParallelLinear(16, 32, gather_output=False,
                                     sequence_parallel_enabled=True)
    row = jx.tp.RowParallelLinear(32, 16, input_is_parallel=True,
                                  sequence_parallel_enabled=True)

    def run(x, kc, bc, kr, br):
        def loss(x, kc, kr):
            mid = col.apply({"params": {"kernel": kc, "bias": bc}}, x)
            y = row.apply({"params": {"kernel": kr, "bias": br}}, mid)
            return jnp.sum(y ** 2)
        mid = col.apply({"params": {"kernel": kc, "bias": bc}}, x)
        y = row.apply({"params": {"kernel": kr, "bias": br}}, mid)
        gx, gkc, gkr = jx.jax.grad(loss, argnums=(0, 1, 2))(x, kc, kr)
        return y, gx, gkc, gkr

    y, gx, gkc, gkr = jx.smap(
        run, (P("tp"), P(None, "tp"), P("tp"), P("tp", None), P()),
        (P("tp"), P("tp"), P(None, "tp"), P("tp", None)))(
        jnp.asarray(inp["sp_x"]), jnp.asarray(inp["sp_wc"].T),
        jnp.asarray(inp["sp_bc"]), jnp.asarray(inp["sp_wr"].T),
        jnp.asarray(inp["sp_br"]))
    hid = inp["sp_x"] @ inp["sp_wc"].T + inp["sp_bc"]
    np.testing.assert_allclose(np.asarray(y),
                               hid @ inp["sp_wr"].T + inp["sp_br"],
                               rtol=1e-4, atol=1e-4)
    for rank, (py, pgx, pgc, pgr) in enumerate(_ranks(port, "sp_pair")):
        np.testing.assert_allclose(py, _chunk(np.asarray(y), 0, rank), **TOL)
        np.testing.assert_allclose(pgx, _chunk(np.asarray(gx), 0, rank),
                                   **TOL)
        np.testing.assert_allclose(pgc, _chunk(np.asarray(gkc).T, 0, rank),
                                   **TOL)
        np.testing.assert_allclose(pgr, _chunk(np.asarray(gkr).T, 1, rank),
                                   **TOL)


def test_vocab_parallel_embedding_matches_jax(port, inp, jx):
    P, jnp = jx.P, jx.jnp
    emb = jx.tp.VocabParallelEmbedding(32, 8)

    def run(ids, w):
        return emb.apply({"params": {"embedding": w}}, ids)

    y = np.asarray(jx.smap(run, (P(), P("tp", None)), P(None))(
        jnp.asarray(inp["emb_ids"], jnp.int32), jnp.asarray(inp["emb_w"])))
    np.testing.assert_array_equal(y, inp["emb_w"][inp["emb_ids"]])
    counts = np.bincount(inp["emb_ids"].ravel(), minlength=32)
    for rank, (py, gw) in enumerate(_ranks(port, "emb")):
        np.testing.assert_array_equal(py, y)
        np.testing.assert_array_equal(
            gw, _chunk(np.repeat(counts[:, None], 8, 1).astype(np.float32),
                       0, rank))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(port, inp, jx, smoothing):
    P, jnp = jx.P, jx.jnp

    def run(lg, t):
        return jx.tp.vocab_parallel_cross_entropy(lg, t, smoothing)

    want = np.asarray(jx.smap(run, (P(None, None, "tp"), P()), P(None))(
        jnp.asarray(inp["ce_logits"]),
        jnp.asarray(inp["ce_target"], jnp.int32)))
    for loss in _ranks(port, f"ce_{smoothing}"):
        np.testing.assert_allclose(loss, want, **TOL)
    # and the single-shard loss of the port, outside any region
    one = ttp.vocab_parallel_cross_entropy(
        torch.from_numpy(inp["ce_logits"]),
        torch.from_numpy(inp["ce_target"]), smoothing).numpy()
    np.testing.assert_allclose(one, want, **TOL)


def test_vocab_parallel_cross_entropy_grad_matches_jax(port, inp, jx):
    P, jnp = jx.P, jx.jnp
    target = jnp.asarray(inp["ceg_target"], jnp.int32)

    def run(lg, t):
        return jx.jax.grad(lambda lg: jnp.mean(
            jx.tp.vocab_parallel_cross_entropy(lg, t)))(lg)

    g = np.asarray(jx.smap(run, (P(None, "tp"), P()), P(None, "tp"))(
        jnp.asarray(inp["ceg_logits"]), target))
    for rank, pg in enumerate(_ranks(port, "ce_grad")):
        np.testing.assert_allclose(pg, _chunk(g, 1, rank), **TOL)


def test_shard_init_draws_per_rank(port):
    shards = [r["init"] for r in port]
    for a, b in shards:
        np.testing.assert_array_equal(a, b)       # same seed, same shard
    firsts = [a for a, _ in shards]
    for i in range(1, TP):
        assert not np.array_equal(firsts[0], firsts[i])


def test_vocab_utility_and_split_match_jax(jx):
    from apex_tpu.transformer.tensor_parallel import utils as ju
    from apex_tpu_torch.transformer.tensor_parallel import utils as tu

    for rank in range(4):
        assert (tu.VocabUtility.vocab_range_from_global_vocab_size(
            128, rank, 4) == ju.VocabUtility.vocab_range_from_global_vocab_size(
            128, rank, 4))
        assert (tu.VocabUtility.vocab_range_from_per_partition_vocab_size(
            32, rank, 4) == tuple(
            ju.VocabUtility.vocab_range_from_per_partition_vocab_size(
                32, rank, 4)))
    with pytest.raises(AssertionError):
        tu.VocabUtility.vocab_range_from_global_vocab_size(30, 0, 4)
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    want = ju.split_tensor_along_last_dim(jx.jnp.asarray(x), 3)
    got = tu.split_tensor_along_last_dim(torch.from_numpy(x), 3)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(g.is_contiguous() for g in tu.split_tensor_along_last_dim(
        torch.from_numpy(x), 3, contiguous_split_chunks=True))


def test_override_forward_allreduce_is_read_at_call_time():
    from apex_tpu_torch.transformer.tensor_parallel import mappings

    calls = []

    def fn(x, group):
        calls.append(group)
        return x * 2

    sentinel = object()
    with mappings.tensor_parallel_region(sentinel):
        x = torch.ones(3)
        with ttp.override_forward_allreduce(fn):
            assert torch.equal(ttp.reduce_from_tensor_model_parallel_region(
                x, kind="row_linear"), x * 2)
            with pytest.raises(RuntimeError, match="nested"):
                with ttp.override_forward_allreduce(lambda x, g: x):
                    pass
        assert calls == [sentinel]
    # outside a region every mapping is the identity
    y = torch.ones(2)
    assert ttp.reduce_from_tensor_model_parallel_region(y) is y
    assert ttp.gather_from_tensor_model_parallel_region(y) is y
