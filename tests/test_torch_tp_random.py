"""The tensor-parallel training primitives: ``tensor_parallel.random``
(the RNG tracker, ``model_parallel_seed``, ``checkpoint``), ``.memory``,
``.data`` and the ``transformer.amp`` ``GradScaler``.

The tracker and the buffers run here beside the JAX package's on the same
calls (their semantics, not their bits: the port's streams are
``torch.Generator`` s, JAX's are keys).  The streams across ranks,
``broadcast_data`` and ``GradScaler`` run in one dp 2 x tp 2 gloo world
of spawned ranks; ``broadcast_data`` is held bit for bit against JAX's
under ``shard_map``.  ``checkpoint``'s gradients equal the plain call's
bit for bit, dropout-like draws from a caller's generator and from a
tracker fork included.

This module imports JAX only in its fixtures and tests, so the spawned
ranks stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.tensor_parallel import random as trandom
from apex_tpu_torch.transformer.testing.distributed import run_world


def _draws(stream, n=6):
    with trandom.get_rng_state_tracker().fork(stream) as g:
        return torch.rand(n, generator=g).numpy()


def _world(rank, world, payload):
    """dp 2 x tp 2: the two streams, broadcast_data, GradScaler."""
    from apex_tpu_torch.optimizers import FusedAdam

    tps.initialize_model_parallel(2)
    out = {"tp_rank": tps.get_tensor_model_parallel_rank(),
           "dp_rank": tps.get_data_parallel_rank()}
    ttp.model_parallel_seed(1234, device="cpu")
    out["mp"] = _draws("model-parallel-rng")
    out["dp"] = _draws("data-parallel-rng")
    # broadcast_data: each rank offers its own values; all get tp rank 0's
    mine = {"ids": payload["ids"][rank], "mask": payload["mask"][rank]}
    got = ttp.broadcast_data(["ids", "mask"], mine, torch.int64)
    out["bcast"] = {k: v.numpy() for k, v in got.items()}
    out["rows"] = ttp.tp_replicated_rows(torch.arange(8)).numpy()
    # GradScaler: an inf in rank 1's shard only (tp group {0, 1})
    scaler = GradScaler()
    w = torch.nn.Parameter(torch.ones(4))
    opt = FusedAdam([w], lr=0.1)
    state = scaler.init("cpu")
    w.grad = torch.full((4,), 2.0 ** 16)
    if rank == 1:
        w.grad[2] = float("inf")
    local = bool(LossScaler.has_overflow(scaler, [w.grad]))
    found = scaler.has_overflow([w.grad])
    opt.step(grad_scale=state.scale, found_inf=found)
    state = scaler.update(state, found)
    out["scaler"] = dict(local=local, found=bool(found),
                         scale=float(state.scale),
                         unskipped=int(state.unskipped),
                         w=w.detach().numpy().copy(),
                         step=int(opt.state[w]["step"]))
    return out


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(5)
    return {"ids": rng.integers(0, 1000, (4, 3, 5)).astype(np.int64),
            "mask": rng.integers(0, 2, (4, 3, 5)).astype(np.int64)}


@pytest.fixture(scope="module")
def ranks(payload):
    return run_world(_world, 4, args=(payload,), timeout=120)


# ---------------------------------------------------------------------------
# the tracker, beside the JAX one
# ---------------------------------------------------------------------------


def test_rng_tracker_like_jax():
    """``tests/test_tensor_parallel.py::test_rng_tracker`` on the port:
    two forks differ; ``set_states`` of a snapshot replays the next fork;
    a duplicate name and a missing one raise the JAX tracker's errors;
    ``reset`` drops every stream."""
    from apex_tpu.transformer.tensor_parallel import random as jrandom

    trandom.model_parallel_seed(1234, device="cpu")
    tracker = trandom.get_rng_state_tracker()
    k1, k2 = _draws("model-parallel-rng"), _draws("model-parallel-rng")
    assert not np.array_equal(k1, k2)
    state = tracker.get_states()
    k3 = _draws("model-parallel-rng")
    tracker.set_states(state)
    assert np.array_equal(_draws("model-parallel-rng"), k3)
    # the data-parallel stream is another stream
    assert not np.array_equal(_draws("data-parallel-rng"), k1)

    jt, pt = jrandom.RNGStatesTracker(), trandom.RNGStatesTracker("cpu")
    for t in (jt, pt):
        t.add("a", 3)
    for t in (jt, pt):
        with pytest.raises(Exception, match="cuda rng state a already exists"):
            t.add("a", 4)
        with pytest.raises(Exception, match="cuda rng state b is not added"):
            with t.fork("b"):
                pass
        t.reset()
        with pytest.raises(Exception, match="is not added"):
            with t.fork("a"):
                pass
    assert trandom.CudaRNGStatesTracker is trandom.RNGStatesTracker
    assert (trandom.model_parallel_cuda_manual_seed
            is trandom.model_parallel_seed)


def test_fork_is_a_generator_on_the_trackers_device():
    """A fork yields a ``torch.Generator`` on the tracker's device and
    leaves the global RNG alone; the same seed and counter give the same
    draws in a fresh tracker."""
    t = trandom.RNGStatesTracker("cpu")
    t.add("s", 7)
    before = torch.get_rng_state()
    with t.fork("s") as g:
        assert isinstance(g, torch.Generator) and g.device.type == "cpu"
        a = torch.rand(4, generator=g)
    assert torch.equal(torch.get_rng_state(), before)
    u = trandom.RNGStatesTracker("cpu")
    u.add("s", 7)
    with u.fork("s") as g:
        assert torch.equal(torch.rand(4, generator=g), a)


def test_streams_per_tp_rank_and_across_dp(ranks):
    """``model_parallel_seed`` in a dp 2 x tp 2 world: the model-parallel
    stream differs between the tp ranks and agrees across the dp
    replicas; the data-parallel stream agrees everywhere."""
    by = {(r["dp_rank"], r["tp_rank"]): r for r in ranks}
    assert np.array_equal(by[0, 0]["mp"], by[1, 0]["mp"])
    assert np.array_equal(by[0, 1]["mp"], by[1, 1]["mp"])
    assert not np.array_equal(by[0, 0]["mp"], by[0, 1]["mp"])
    for r in ranks:
        assert np.array_equal(r["dp"], ranks[0]["dp"])
        assert not np.array_equal(r["dp"], r["mp"])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _block(x, w1, w2, gen):
    """A layer with a dropout-like draw from ``gen`` and from a tracker
    fork: the recompute must draw the same masks."""
    h = torch.tanh(x @ w1)
    h = h * (torch.rand(h.shape, generator=gen) > 0.3)
    with trandom.get_rng_state_tracker().fork() as g:
        h = h * (torch.rand(h.shape, generator=g) > 0.2)
    return h @ w2


@pytest.mark.parametrize("distribute", [False, True])
def test_checkpoint_grads_equal_the_plain_call(distribute):
    """``checkpoint(fn, distribute_saved_activations, *args)`` gives the
    plain call's output and gradients bit for bit, the recompute drawing
    the masks the forward drew (from the caller's generator and the
    tracker); after it the generator and the tracker stand where the
    forward left them."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))

    def run(ckpt):
        trandom.model_parallel_seed(99, device="cpu")
        gen = torch.Generator().manual_seed(3)
        a, b = w1.clone().requires_grad_(), w2.clone().requires_grad_()
        xi = x.clone().requires_grad_()
        y = (ttp.checkpoint(_block, distribute, xi, a, b, gen) if ckpt
             else _block(xi, a, b, gen))
        after = (gen.get_state(), trandom.get_rng_state_tracker().get_states())
        (y * torch.arange(4.0)).sum().backward()
        assert torch.equal(gen.get_state(), after[0])
        assert trandom.get_rng_state_tracker().get_states() == after[1]
        return y.detach(), xi.grad, a.grad, b.grad

    for got, want in zip(run(True), run(False)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# memory buffers, beside the JAX ones
# ---------------------------------------------------------------------------


def test_memory_buffers_like_jax():
    """The same calls on the port's and JAX's buffers: the same shapes,
    zeros, the out-of-space ``AssertionError`` at the same call, ``reset``
    rewinding, the ring's names and round-robin order.  The port hands out
    views of one tensor (a write shows in the buffer)."""
    from apex_tpu.transformer.tensor_parallel.memory import (
        MemoryBuffer as JBuf,
        RingMemBuffer as JRing,
    )

    ours = ttp.MemoryBuffer("b", 24, torch.float32, device="cpu")
    ref = JBuf("b", 24, np.float32)
    for shape in ((2, 3), (4,), (2, 2, 3)):
        a, r = ours.get(shape), ref.get(shape)
        assert tuple(a.shape) == tuple(r.shape) == shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    for buf in (ours, ref):
        with pytest.raises(AssertionError, match="out of space"):
            buf.get((3,))
        buf.reset()
    v = ours.get((24,))
    assert tuple(ref.get((24,)).shape) == (24,)
    v.fill_(2.0)
    assert float(ours.data.sum()) == 48.0
    assert v.data_ptr() == ours.data.data_ptr()

    ring = ttp.RingMemBuffer("r", 3, 8, torch.float16, device="cpu")
    jring = JRing("r", 3, 8, np.float16)
    for _ in range(5):
        a, r = ring.get_next_buffer(), jring.get_next_buffer()
        assert a.name == r.name and a.data.dtype == torch.float16
        a.get((8,))
    assert ring.get_next_buffer() is ring.buffers[2]
    assert ring.buffers[2].get((8,)).shape == (8,)     # reset when handed out


# ---------------------------------------------------------------------------
# broadcast_data and the dp rows
# ---------------------------------------------------------------------------


def test_broadcast_data_matches_jax(ranks, payload):
    """Each rank offers its own batch; every rank ends with its tp group's
    first rank's, bit for bit JAX's ``broadcast_data`` under ``shard_map``
    over a 2 x 2 mesh.  ``tp_replicated_rows`` hands dp rank r rows [4r,
    4r + 4) of an 8-row batch on both of its tp ranks (the rows JAX's
    ``P('dp')`` sharding puts there)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from apex_tpu.transformer.tensor_parallel.data import (
        broadcast_data as jbroadcast,
    )
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))

    def run(ids, mask):
        d = jbroadcast(["ids", "mask"], {"ids": ids[0, 0], "mask": mask[0, 0]},
                       jnp.int32)
        return d["ids"][None, None], d["mask"][None, None]

    grid = {k: jnp.asarray(v.reshape(2, 2, 3, 5), jnp.int32)
            for k, v in payload.items()}
    ids, mask = jax.jit(shard_map(
        run, mesh=mesh, in_specs=(P("dp", "tp"), P("dp", "tp")),
        out_specs=(P("dp", "tp"), P("dp", "tp")), **NO_REP_CHECK))(
        grid["ids"], grid["mask"])
    ref = {"ids": np.asarray(ids).reshape(4, 3, 5),
           "mask": np.asarray(mask).reshape(4, 3, 5)}
    for rank, r in enumerate(ranks):
        for k in ("ids", "mask"):
            assert r["bcast"][k].dtype == np.int64
            np.testing.assert_array_equal(r["bcast"][k], ref[k][rank])
            np.testing.assert_array_equal(
                r["bcast"][k], payload[k][2 * r["dp_rank"]])
        np.testing.assert_array_equal(r["rows"],
                                      np.arange(4 * r["dp_rank"],
                                                4 * r["dp_rank"] + 4))


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------


def test_grad_scaler_overflow_on_one_shard_skips_the_tp_group(ranks):
    """An inf in rank 1's gradient only: rank 0's local check finds none,
    yet both ranks of tp group {0, 1} skip (the parameter and the step
    counter as they were) and halve the scale alike; tp group {2, 3}, a
    replica of its own, steps."""
    by = {r: ranks[r]["scaler"] for r in range(4)}
    assert by[1]["local"] and not by[0]["local"]
    for r in (0, 1):
        assert by[r]["found"]
        assert by[r]["scale"] == 2.0 ** 15 and by[r]["unskipped"] == 0
        np.testing.assert_array_equal(by[r]["w"], np.ones(4, np.float32))
        assert by[r]["step"] == 0
    for r in (2, 3):
        assert not by[r]["found"]
        assert by[r]["scale"] == 2.0 ** 16 and by[r]["unskipped"] == 1
        assert (by[r]["w"] < 1).all() and by[r]["step"] == 1


def test_grad_scaler_alone_is_the_loss_scaler():
    """Outside any group a GradScaler is the plain scaler: the same flag
    and the same settings as the scaler it was made from."""
    base = LossScaler(init_scale=2.0 ** 10, hysteresis=2)
    s = GradScaler.from_scaler(base)
    assert (s.init_scale, s.hysteresis) == (2.0 ** 10, 2)
    g = [torch.ones(3), torch.tensor([1.0, float("nan")])]
    assert bool(s.has_overflow(g)) and bool(base.has_overflow(g))
    assert not bool(s.has_overflow([torch.ones(3)]))
    unscaled, found = s.unscale(g, s.init("cpu"))
    assert bool(found) and torch.equal(unscaled[0], torch.ones(3) / 2 ** 10)
