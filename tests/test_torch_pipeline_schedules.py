"""Pipeline schedules: the port's five schedules and its point-to-point
layer in a gloo world of pp 4 against the JAX package's under
``shard_map`` over the ``pp`` axis of four virtual CPU devices.

The stage is the toy of ``tests/test_pipeline_parallel.py:38-60`` (a
linear layer and a tanh-approximated GELU a stage, the first stage's
input the microbatch's ``x``, the last stage's loss the mean squared
error against its ``y``), with the same numpy weights in both packages.
Each schedule's mean loss, and every stage's gradients, agree with JAX's
within 1e-5 relative (of the gradient's largest magnitude): the
non-interleaved ones at pp 4 over 7 microbatches, the interleaved ones
at pp 4 x vpp 2 (8 global stages) over 7 (a partial last group), with
``forward_only`` beside each.  The 1F1B bank holds at most ``2 pp - 1``
stage inputs at 4 and at 8 microbatches, where the two-sweep schedule
keeps one a microbatch.

This module imports JAX only in its fixtures and tests, so the spawned
ranks stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer.pipeline_parallel import (
    PipelineStageSpec,
    build_model,
    forward_backward_no_pipelining,
    forward_backward_pipelining_1f1b,
    forward_backward_pipelining_1f1b_interleaved,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel import (
    p2p_communication as p2p,
)
from apex_tpu_torch.transformer.testing.distributed import run_world

HID, PP, VPP, N_MICRO = 8, 4, 2, 7
SCHEDULES = {
    "without_interleaving": forward_backward_pipelining_without_interleaving,
    "1f1b": forward_backward_pipelining_1f1b,
    "with_interleaving": forward_backward_pipelining_with_interleaving,
    "1f1b_interleaved": forward_backward_pipelining_1f1b_interleaved,
}
INTERLEAVED = ("with_interleaving", "1f1b_interleaved")


def _data(seed, n_stages, n_micro):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        w=(rng.standard_normal((n_stages, HID, HID)) * 0.3).astype(f32),
        b=(rng.standard_normal((n_stages, HID)) * 0.1).astype(f32),
        x=rng.standard_normal((n_micro, 2, HID)).astype(f32),
        y=rng.standard_normal((n_micro, 2, HID)).astype(f32))


class _Stage(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))
        self.b = torch.nn.Parameter(torch.tensor(b))

    def forward(self, x):
        return torch.nn.functional.gelu(x @ self.w + self.b,
                                        approximate="tanh")


def _first(mb):
    return mb["x"]


def _last(y, mb):
    return ((y - mb["y"]) ** 2).mean()


def _np(grads):
    if isinstance(grads, list):
        return [_np(g) for g in grads]
    return {k.split(".")[-1]: v.detach().numpy().copy()
            for k, v in grads.items()}


def _provider(d):
    """build_model's provider: the chunk of global stage ``v * pp + r``."""

    def make(pre_process, post_process):
        v = tps.get_virtual_pipeline_model_parallel_rank() or 0
        s = v * PP + tps.get_pipeline_model_parallel_rank()
        return PipelineStageSpec(_Stage(d["w"][s], d["b"][s]),
                                 _first if pre_process else None,
                                 _last if post_process else None)

    return make


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _pp4_world(rank, world, plain, inter, mem):
    tps.initialize_model_parallel(1, PP, VPP)
    r = tps.get_pipeline_model_parallel_rank()
    out = {"first": tps.is_pipeline_first_stage(ignore_virtual=True),
           "last": tps.is_pipeline_last_stage(ignore_virtual=True)}
    wire = dict(tensor_shape=(2, HID))
    for name, fn in SCHEDULES.items():
        d = inter if name in INTERLEAVED else plain
        batches = {"x": torch.tensor(d["x"]), "y": torch.tensor(d["y"])}
        if name in INTERLEAVED:
            spec = build_model(_provider(d),
                               virtual_pipeline_model_parallel_size=VPP)
            kw = dict(num_model_chunks=VPP, **wire)
        else:
            spec = PipelineStageSpec(_Stage(d["w"][r], d["b"][r]), _first,
                                     _last)
            kw = wire
        stats = {}
        loss, grads = fn(spec, batches, stats=stats, **kw)
        fwd, none = fn(spec, batches, forward_only=True, **kw)
        out[name] = dict(loss=float(loss), grads=_np(grads),
                         forward_only=float(fwd), grads_forward_only=none,
                         stats=stats)
    # the bank's high water at two microbatch counts
    for n in (4, 8):
        batches = {"x": torch.tensor(mem["x"][:n]),
                   "y": torch.tensor(mem["y"][:n])}
        spec = PipelineStageSpec(_Stage(mem["w"][r], mem["b"][r]), _first,
                                 _last)
        for name in ("1f1b", "without_interleaving"):
            stats = {}
            SCHEDULES[name](spec, batches, checkpoint_stages=False,
                            stats=stats, **wire)
            out[f"bank_{name}_{n}"] = stats
    # the point-to-point layer: every combinator on a rank-valued tensor
    x = torch.full((3,), float(rank))
    g = torch.full((3,), 10.0 + rank)
    out["p2p"] = {
        "fwd": p2p.shift_forward(x).tolist(),
        "bwd": p2p.shift_backward(x).tolist(),
        "fwd_wrap": p2p.shift_forward(x, wrap=True).tolist(),
        "bwd_wrap": p2p.shift_backward(x, wrap=True).tolist(),
        "send_forward_recv_forward": p2p.send_forward_recv_forward(x).tolist(),
        "send_backward_recv_backward":
            p2p.send_backward_recv_backward(x).tolist(),
        "send_forward": p2p.send_forward(x).tolist(),
        "recv_forward": p2p.recv_forward(x).tolist(),
        "send_backward": p2p.send_backward(x).tolist(),
        "recv_backward": p2p.recv_backward(x).tolist(),
        "send_forward_recv_backward": [
            t.tolist() for t in p2p.send_forward_recv_backward(x, g)],
        "send_backward_recv_forward": [
            t.tolist() for t in p2p.send_backward_recv_forward(g, x)],
    }
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    return dict(plain=_data(0, PP, N_MICRO), inter=_data(1, PP * VPP, N_MICRO),
                mem=_data(2, PP, 8))


@pytest.fixture(scope="module")
def world(data):
    return run_world(_pp4_world, PP, args=(data["plain"], data["inter"],
                                           data["mem"]), timeout=120)


@pytest.fixture(scope="module")
def jax_runs(data, devices):
    """Each JAX schedule's loss, stage gradients (``[n_stages, ...]`` in
    global stage order) and forward-only loss, on the toy spec of
    ``tests/test_pipeline_parallel.py``, and the JAX shifts."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer import parallel_state
    from apex_tpu.transformer import pipeline_parallel as jpp
    from apex_tpu.transformer.pipeline_parallel import p2p_communication
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    def stage_fn(params, x):
        h = jnp.dot(x, params["w"], precision="highest") + params["b"]
        return jax.nn.gelu(h)

    spec = jpp.PipelineStageSpec(
        stage_fn=stage_fn, first_fn=lambda params, mb: mb["x"],
        last_fn=lambda params, y, mb: jnp.mean((y - mb["y"]) ** 2))
    fns = {
        "without_interleaving":
            jpp.forward_backward_pipelining_without_interleaving,
        "1f1b": jpp.forward_backward_pipelining_1f1b,
        "with_interleaving": jpp.forward_backward_pipelining_with_interleaving,
        "1f1b_interleaved": jpp.forward_backward_pipelining_1f1b_interleaved,
    }
    mesh = parallel_state.initialize_model_parallel(1, PP,
                                                    devices=devices[:PP])
    out = {}
    try:
        for name, fn in fns.items():
            d = data["inter" if name in INTERLEAVED else "plain"]
            batches = {"x": jnp.asarray(d["x"]), "y": jnp.asarray(d["y"])}
            if name in INTERLEAVED:
                stacked = {"w": d["w"].reshape(VPP, PP, HID, HID),
                           "b": d["b"].reshape(VPP, PP, HID)}
                pspec = {"w": P(None, "pp"), "b": P(None, "pp")}
                kw = dict(num_model_chunks=VPP)
                into = lambda p: jax.tree.map(lambda l: l.squeeze(1), p)  # noqa: E731
                back = lambda g: jax.tree.map(lambda l: l[:, None], g)  # noqa: E731
            else:
                stacked = {"w": d["w"], "b": d["b"]}
                pspec = {"w": P("pp"), "b": P("pp")}
                kw = {}
                into = lambda p: jax.tree.map(lambda l: l[0], p)  # noqa: E731
                back = lambda g: jax.tree.map(lambda l: l[None], g)  # noqa: E731

            def run(params, batches, fn=fn, kw=kw, into=into, back=back):
                loss, grads = fn(spec, into(params), batches, **kw)
                floss, _ = fn(spec, into(params), batches, forward_only=True,
                              **kw)
                return loss, floss, back(grads)

            loss, floss, grads = jax.jit(shard_map(
                run, mesh=mesh, in_specs=(pspec, P()),
                out_specs=(P(), P(), pspec), **NO_REP_CHECK))(stacked, batches)
            n_stages = PP * (VPP if name in INTERLEAVED else 1)
            out[name] = dict(
                loss=float(loss), forward_only=float(floss),
                grads={k: np.asarray(v).reshape((n_stages,) + v.shape[-(
                    2 if k == "w" else 1):]) for k, v in grads.items()})

        def shifts(x):
            f, b = p2p_communication.send_forward_recv_backward(x, x + 10.0)
            return (p2p_communication.shift_forward(x),
                    p2p_communication.shift_backward(x),
                    p2p_communication.shift_forward(x, wrap=True),
                    p2p_communication.shift_backward(x, wrap=True), f, b)

        x = jnp.repeat(jnp.arange(PP, dtype=jnp.float32)[:, None], 3, axis=1)
        res = shard_map(shifts, mesh=mesh, in_specs=(P("pp"),),
                        out_specs=(P("pp"),) * 6, **NO_REP_CHECK)(x)
        out["p2p"] = [np.asarray(a) for a in res]
    finally:
        parallel_state.destroy_model_parallel()
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_loss_and_every_stage_grad_match_jax(world, jax_runs, name):
    """Each schedule on every rank: the mean loss (the same on every
    stage) and the forward-only loss at 1e-5 relative; each stage's
    gradients against JAX's stage of the same global index."""
    ref = jax_runs[name]
    for r, res in enumerate(world):
        got = res[name]
        _close(got["loss"], ref["loss"], f"{name} loss rank {r}")
        _close(got["forward_only"], ref["forward_only"],
               f"{name} forward_only rank {r}")
        assert got["grads_forward_only"] is None
        chunks = got["grads"] if name in INTERLEAVED else [got["grads"]]
        for v, g in enumerate(chunks):
            s = v * PP + r
            for k in ("w", "b"):
                _close(g[k], ref["grads"][k][s], f"{name} d{k} stage {s}")


def test_no_pipelining_matches_jax_and_sums_in_fp32(jax_runs):
    """``forward_backward_no_pipelining`` over a callable loss (JAX's
    form: gradients summed over the microbatches, the loss their mean)
    against JAX's on the same weights; its forward-only loss; and over a
    spec, the gradients of the mean (a pipelined schedule's) with
    ``with_found_inf`` False."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.transformer import pipeline_parallel as jpp

    d = _data(3, 1, 4)
    w = torch.nn.Parameter(torch.tensor(d["w"][0]))
    batches = {"x": torch.tensor(d["x"]), "y": torch.tensor(d["y"])}

    def loss_fn(mb):
        return ((torch.tanh(mb["x"] @ w) - mb["y"]) ** 2).mean()

    loss, grads = forward_backward_no_pipelining(loss_fn, batches, model=[w])
    jloss, jgrads = jpp.forward_backward_no_pipelining(
        lambda p, mb: jnp.mean((jnp.tanh(jnp.dot(
            mb["x"], p["w"], precision="highest")) - mb["y"]) ** 2),
        {"w": jnp.asarray(d["w"][0])},
        {"x": jnp.asarray(d["x"]), "y": jnp.asarray(d["y"])})
    _close(float(loss), float(jloss), "loss")
    _close(grads["0"].numpy(), np.asarray(jgrads["w"]), "summed grads")
    fwd, none = forward_backward_no_pipelining(loss_fn, batches, model=[w],
                                               forward_only=True)
    assert none is None and abs(float(fwd) - float(loss)) < 1e-7
    spec = PipelineStageSpec(_Stage(d["w"][0], d["b"][0]), _first, _last)
    sloss, sgrads, found = forward_backward_no_pipelining(
        spec, batches, with_found_inf=True)
    ref = torch.nn.Parameter(torch.tensor(d["w"][0]))
    mean = sum(((torch.nn.functional.gelu(
        batches["x"][i] @ ref + torch.tensor(d["b"][0]), approximate="tanh")
        - batches["y"][i]) ** 2).mean() for i in range(4)) / 4
    mean.backward()
    _close(float(sloss), float(mean.detach()), "spec loss")
    _close(sgrads["stage.w"].numpy(), ref.grad.numpy(), "spec grads")
    assert not bool(found)
    del jax


def test_1f1b_bank_holds_at_most_2pp_minus_1_inputs(world):
    """The 1F1B memory bound, JAX's "memory flat in num_microbatches"
    (``tests/test_pipeline_parallel.py:139``) read off the bank: at 4 and
    at 8 microbatches no rank holds more than ``2 pp - 1`` banked stage
    inputs, the first stage exactly that at both; the two-sweep schedule
    without recompute keeps one graph a microbatch on every stage."""
    for r, res in enumerate(world):
        for n in (4, 8):
            st = res[f"bank_1f1b_{n}"]
            assert st["bank_slots"] == 2 * PP - 1
            assert st["bank_high_water"] <= 2 * PP - 1
            assert res[f"bank_without_interleaving_{n}"][
                "bank_high_water"] == n
        assert (res["bank_1f1b_4"]["bank_high_water"]
                == min(4, 2 * (PP - 1 - r) + 1))
        assert (res["bank_1f1b_8"]["bank_high_water"]
                == 2 * (PP - 1 - r) + 1)
    inter = world[0]["1f1b_interleaved"]["stats"]
    assert inter["bank_slots"] == 2 * PP * VPP - 1
    assert inter["bank_high_water"] <= 2 * PP * VPP - 1


def _traffic_ticks(r, n, p):
    """The ticks of the 1F1B timetable (JAX's, ``n + 2 (p - 1)`` of them
    with ``n`` rounded up to a multiple of ``p``) in which rank ``r``
    sends or receives: its own active forward and backward microbatch
    and its neighbours' for the next tick."""
    ticks = -(-n // p) * p + 2 * (p - 1)
    active = range(n).__contains__
    busy = 0
    for t in range(ticks):
        b = t - 2 * (p - 1) + r
        nxt = t + 1 < ticks
        busy += any((active(t - r) and r < p - 1, active(b) and r > 0,
                     nxt and r > 0 and active(t + 1 - r),
                     nxt and r < p - 1 and active(b + 1)))
    return busy


def test_p2p_calls_skip_inactive_ticks(world):
    """Point-to-point batches the 1F1B schedule posted at pp 4 over 7
    microbatches: one a tick in which the rank sends or receives, none
    in a tick without traffic (JAX permutes every tick)."""
    for r, res in enumerate(world):
        st = res["1f1b"]["stats"]
        assert st["ticks"] == 8 + 2 * (PP - 1)
        assert st["p2p_calls"] == _traffic_ticks(r, N_MICRO, PP), r
        assert st["p2p_calls"] < st["ticks"]


def test_p2p_shifts_and_combinators_match_jax(world, jax_runs):
    """``shift_forward`` / ``shift_backward`` (zeros at the open end, the
    ring with ``wrap``) and ``send_forward_recv_backward`` against JAX's
    ``ppermute``s over pp 4; the other combinators map to the shifts as
    in JAX."""
    fwd, bwd, fwd_w, bwd_w, sfrb_f, sfrb_b = jax_runs["p2p"]
    for r, res in enumerate(world):
        got = res["p2p"]
        assert got["fwd"] == fwd[r].tolist()
        assert got["bwd"] == bwd[r].tolist()
        assert got["fwd_wrap"] == fwd_w[r].tolist()
        assert got["bwd_wrap"] == bwd_w[r].tolist()
        assert got["send_forward_recv_backward"] == [sfrb_f[r].tolist(),
                                                     sfrb_b[r].tolist()]
        assert got["send_backward_recv_forward"] == [sfrb_b[r].tolist(),
                                                     sfrb_f[r].tolist()]
        for name in ("send_forward_recv_forward", "send_forward",
                     "recv_forward"):
            assert got[name] == got["fwd"], name
        for name in ("send_backward_recv_backward", "send_backward",
                     "recv_backward"):
            assert got[name] == got["bwd"], name
        assert (res["first"], res["last"]) == (r == 0, r == PP - 1)


def test_get_forward_backward_func_picks_jax_schedules():
    assert get_forward_backward_func(None, 1) is forward_backward_no_pipelining
    assert get_forward_backward_func(None, 4) is forward_backward_pipelining_1f1b
    assert (get_forward_backward_func(2, 4)
            is forward_backward_pipelining_1f1b_interleaved)


def test_no_pipelining_fp16_sums_past_the_half_range_stay_finite():
    """Two fp16 microbatches whose gradient parts (40000 each, under
    ``LossScaler(init_scale=40000)``, loss ``(w * mb).sum()``) are in the
    fp16 range and whose sum (80000) is not: ``found_inf`` is False and
    the returned sums are JAX's fp32 ``[80000., ...]``; ``.grad`` keeps
    the parameter's dtype (the cast, which overflows, is what a caller
    must not step from)."""
    import jax.numpy as jnp

    from apex_tpu.amp.scaler import LossScaler as JScaler
    from apex_tpu.transformer import pipeline_parallel as jpp
    from apex_tpu_torch.amp import LossScaler

    mb = np.ones((2, 4), np.float16)
    w = torch.nn.Parameter(torch.ones(4, dtype=torch.float16))
    scaler = LossScaler(init_scale=40000.0)
    _, grads, found = forward_backward_no_pipelining(
        lambda m: (w * m).sum(), torch.from_numpy(mb), model=[w],
        grad_scaler=scaler, scaler_state=scaler.init("cpu"),
        with_found_inf=True)
    jscaler = JScaler(init_scale=40000.0)
    _, jgrads, jfound = jpp.forward_backward_no_pipelining(
        lambda p, m: jnp.sum(p["w"] * m),
        {"w": jnp.ones(4, jnp.float16)}, jnp.asarray(mb),
        grad_scaler=jscaler, scaler_state=jscaler.init(),
        with_found_inf=True)
    assert not bool(found) and not bool(jfound)
    assert grads["0"].dtype == torch.float32
    np.testing.assert_array_equal(grads["0"].numpy(),
                                  np.asarray(jgrads["w"]))
    np.testing.assert_array_equal(grads["0"].numpy(), np.full(4, 80000.0))
    assert w.grad.dtype == torch.float16


def test_llama_pp1_fp16_step_takes_the_step_jax_takes(devices):
    """The 3-d step at pp 1 (``get_forward_backward_func(None, 1)``) in
    fp16 O2 under ``GradScaler``, at the largest scale of a grid (2**20
    down to 2**19 in 32 steps) where JAX's ``no_pipelining`` finds no
    overflow while a sum passes 65504 (so the sums' fp16 cast
    overflows): the port's schedule returns fp32
    sums within 1e-2 of their largest magnitude of JAX's, ``found_inf``
    False on both, and the step from them is JAX's
    ``FusedAdam(master_weights=True)`` step: the same scaler state, every
    parameter moved, and the master update within 1e-2 of the learning
    rate of JAX's wherever the sum is a tenth of its leaf's largest or
    more.  Before the repair the port found an overflow and
    skipped the step."""
    import torch_pipeline_helpers as h

    batches = h.batches_of(1)
    ref = h.jax_pp1_fp16(devices, batches, [
        2.0 ** 20 * (1 - j / 64) for j in range(33)])
    assert not ref["found"] and not ref["found_step"]
    assert ref["peak"] > 65504.0
    [got] = run_world(h.pp1_fp16_world, 1,
                      args=(ref["params0"], batches, ref["scale"]),
                      timeout=150)
    assert not got["found_alone"] and not got["found"]
    assert set(got["sum_dtypes"].values()) == {"torch.float32"}
    assert got["grad_nonfinite"] > 0          # the cast overflows ...
    assert "torch.float16" in got["grad_dtypes"].values()
    want = h.stage1_of(ref["sums"])           # ... the sums do not
    for name, r in want.items():
        np.testing.assert_allclose(got["sums"][name], r, rtol=0,
                                   atol=1e-2 * np.abs(r).max(),
                                   err_msg=name)
    assert got["scaler"] == ref["scaler"]
    p0 = h.stage1_of(ref["params0"])
    jm = h.stage1_of(ref["masters"])
    for name, r in want.items():
        d_port = got["masters"][name] - p0[name]
        d_jax = jm[name] - p0[name]
        assert np.abs(d_port).max() > 0, name
        # Adam's first update is -lr g / (|g| + eps): where the sum is a
        # tenth of its leaf's largest or more, the 1e-2 agreement above
        # fixes its sign, and the update agrees to 1e-2 of lr
        held = np.abs(r) >= 0.1 * np.abs(r).max()
        np.testing.assert_allclose(d_port[held], d_jax[held], rtol=0,
                                   atol=1e-2 * h.AMP_LR, err_msg=name)
