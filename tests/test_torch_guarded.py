"""The guarded step (``apex_tpu_torch.resilience.guarded``) against
``apex_tpu.resilience.guarded`` on the CPU.

- ``guarded_update`` over the same ``found_inf`` sequences (a patience
  trip with the floor clamped at ``min_floor``, a clean step resetting
  the run, hysteresis, a static scaler): every scaler and guard state
  field equal to JAX's after every step.
- ``nonfinite_counts`` / ``nonfinite_report`` over the same seeded tree
  with planted NaN and Inf: the same ``{keystr: count}``.
- ``make_guarded_step`` on the quadratic problem of
  ``tests/test_resilience.py``, the same weights in both packages: a
  clean step's parameters within 1e-6 of JAX's, an overflow step keeping
  every parameter and moment bit for bit, the census naming the leaf.
- The pinned difference: JAX emits ``loss_scale_floor_halved`` from
  inside the step; the port's step reads nothing on the device, carries
  the trip in ``metrics["floor_tripped"]``, and ``fetch_metrics`` emits
  the event, with JAX's fields.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import resilience as jrz
from apex_tpu.amp.scaler import LossScaler as JScaler
from apex_tpu.amp.scaler import static_loss_scaler as jstatic
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch import resilience as rz
from apex_tpu_torch._logging import add_event_sink, remove_event_sink
from apex_tpu_torch.amp.scaler import LossScaler, static_loss_scaler
from apex_tpu_torch.optimizers import FusedAdam

FLAGS = {
    "trip_then_clamp": [1, 1, 1, 1, 1, 1, 1, 1],
    "reset_between": [1, 1, 0, 1, 1, 1, 0, 0, 1],
    "mixed": [0, 1, 0, 0, 1, 1, 1, 1, 1, 0, 1],
}


def _fields(sstate, gstate):
    return ([float(np.asarray(v)) for v in sstate]
            + [float(np.asarray(v)) for v in gstate])


@pytest.mark.parametrize("scaler_kw", [
    dict(init_scale=4.0, min_loss_scale=1.0),
    dict(init_scale=2.0 ** 16, hysteresis=2),
    dict(init_scale=8.0, growth_interval=2),
], ids=["floor", "hysteresis", "growth"])
@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_guarded_update_states_match_jax(scaler_kw, flags):
    cfg_kw = dict(patience=2, min_floor=2.0 ** -3)
    scaler, jscaler = LossScaler(**scaler_kw), JScaler(**scaler_kw)
    s, g = scaler.init("cpu"), rz.init_guard_state(scaler, "cpu")
    js, jg = jscaler.init(), jrz.init_guard_state(jscaler)
    for i, f in enumerate(FLAGS[flags]):
        s, g = rz.guarded_update(scaler, s, g, torch.tensor(bool(f)),
                                 rz.GuardConfig(**cfg_kw))
        js, jg = jrz.guarded_update(jscaler, js, jg, jnp.asarray(bool(f)),
                                    jrz.GuardConfig(**cfg_kw))
        assert _fields(s, g) == _fields(js, jg), (flags, i)
        assert [t.dtype for t in g] == [torch.int32, torch.int32,
                                        torch.float32]


def test_static_scaler_under_the_guard_matches_jax():
    scaler, jscaler = static_loss_scaler(128.0), jstatic(128.0)
    s, g = scaler.init("cpu"), rz.init_guard_state(scaler, "cpu")
    js, jg = jscaler.init(), jrz.init_guard_state(jscaler)
    for f in [1, 1, 1, 0, 1, 1, 1]:
        s, g = rz.guarded_update(scaler, s, g, torch.tensor(bool(f)),
                                 rz.GuardConfig(patience=2))
        js, jg = jrz.guarded_update(jscaler, js, jg, jnp.asarray(bool(f)),
                                    jrz.GuardConfig(patience=2))
        assert _fields(s, g) == _fields(js, jg)
    assert float(s.scale) == 128.0 and int(g.total_skips) == 6


def test_guard_config_rejects_what_jax_rejects():
    for kw, match in ((dict(patience=0), "patience"),
                      (dict(floor_backoff=0.0), "floor_backoff"),
                      (dict(min_floor=0.0), "min_floor")):
        with pytest.raises(ValueError, match=match):
            rz.GuardConfig(**kw)
        with pytest.raises(ValueError, match=match):
            jrz.GuardConfig(**kw)


def _planted_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "h": {"x": rng.standard_normal((3, 3)).astype(np.float16),
                  "clean": np.ones(5, np.float32)},
            "list": [rng.standard_normal(6).astype(np.float32)]}
    tree["w"][1, 2] = np.nan
    tree["w"][3, 0] = np.inf
    tree["h"]["x"][0, 1] = -np.inf
    tree["list"][0][5] = np.nan
    return tree


@pytest.mark.parametrize("seed", [0, 1])
def test_nonfinite_report_matches_jax(seed):
    tree = _planted_tree(seed)
    port = rz.nonfinite_report(rz.nonfinite_counts(
        {"w": torch.from_numpy(tree["w"]), "b": torch.from_numpy(tree["b"]),
         "h": {k: torch.from_numpy(v) for k, v in tree["h"].items()},
         "list": [torch.from_numpy(tree["list"][0])]}))
    ref = jrz.nonfinite_report(jrz.nonfinite_counts(
        {"w": jnp.asarray(tree["w"]), "b": jnp.asarray(tree["b"]),
         "h": {k: jnp.asarray(v) for k, v in tree["h"].items()},
         "list": [jnp.asarray(tree["list"][0])]}))
    assert port == ref
    assert list(port) == list(ref)
    assert port == {"['h']['x']": 1, "['list'][0]": 1, "['w']": 2}


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 4)).astype(np.float32) * 0.5,
            "b": rng.standard_normal(4).astype(np.float32) * 0.1}


class _Quad(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(p["w"]))
        self.b = torch.nn.Parameter(torch.tensor(p["b"]))


def _port_loss(model, batch):
    return ((batch @ model.w + model.b) ** 2).mean()


def _jax_loss(p, batch):
    return jnp.mean((jnp.dot(batch, p["w"], precision="highest")
                     + p["b"]) ** 2)


def _runs(batches, scale=2.0 ** 8):
    p0 = _quadratic()
    model = _Quad(p0)
    opt = FusedAdam(model.parameters(), lr=1e-2)
    scaler = LossScaler(init_scale=scale)
    step = rz.make_guarded_step(_port_loss, opt, scaler)
    s, g = scaler.init("cpu"), rz.init_guard_state(scaler, "cpu")
    jopt, jscaler = JAdam(lr=1e-2), JScaler(init_scale=scale)
    jstep = jrz.make_guarded_step(_jax_loss, jopt, jscaler)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jo, js, jg = jopt.init(jp), jscaler.init(), jrz.init_guard_state(jscaler)
    out = []
    for batch in batches:
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        moments = {(n, k): t.clone() for n, p in model.named_parameters()
                   for k, t in opt.state[p].items()} if opt.state else {}
        s, g, m = step(model, None, s, g, torch.tensor(batch))
        jp, jo, js, jg, jm = jstep(jp, jo, js, jg, jnp.asarray(batch))
        after = {k: v.detach().clone() for k, v in model.named_parameters()}
        out.append(dict(before=before, moments=moments, after=after,
                        m=rz.fetch_metrics(m), jm=jm, jp=jp,
                        fields=(_fields(s, g), _fields(js, jg))))
    return out


def test_guarded_steps_match_jax_clean_and_overflow():
    """Two clean steps, an overflow (an inf in the batch), a clean one:
    parameters within 1e-6 of JAX's after each applied step, the overflow
    keeping every parameter and moment bit for bit, every scaler and
    guard field JAX's, the census naming both leaves as JAX's does."""
    ok = np.ones((2, 4), np.float32)
    bad = np.full((2, 4), np.inf, np.float32)
    runs = _runs([ok, ok * 0.5, bad, ok])
    for i, r in enumerate(runs):
        assert r["fields"][0] == r["fields"][1], i
        assert r["m"]["found_inf"] == bool(r["jm"]["found_inf"])
        assert r["m"]["nonfinite"] == jrz.nonfinite_report(
            r["jm"]["nonfinite"])
        for name, p in r["after"].items():
            np.testing.assert_allclose(p.numpy(), np.asarray(r["jp"][name]),
                                       rtol=0, atol=1e-6)
    skipped = runs[2]
    assert skipped["m"]["skipped"] and skipped["m"]["total_skips"] == 1
    assert set(skipped["m"]["nonfinite"]) == {"['b']", "['w']"}
    # the state after the overflow step is read back by run 3's "before"
    after = runs[3]
    for name in skipped["before"]:
        assert torch.equal(after["before"][name], skipped["before"][name])
    for key, t in after["moments"].items():
        assert torch.equal(t, skipped["moments"][key]), key
    assert not runs[0]["m"]["nonfinite"] and runs[3]["m"]["total_skips"] == 1


def test_grad_hook_plants_the_fault_the_census_names():
    """``grad_hook`` (a ``FaultInjector.inject_grads``) is what the step
    checks and steps from: an inf planted in one element of the leaf the
    seed picks is the census's one entry, count 1, and the step skips."""
    p0 = _quadratic()
    model = _Quad(p0)
    opt = FusedAdam(model.parameters(), lr=1e-2)
    scaler = LossScaler(init_scale=2.0 ** 8)
    inj = rz.FaultInjector(rz.FaultPlan(seed=3, inf_grad_steps=(1,)))
    calls = iter(range(10))
    step = rz.make_guarded_step(
        _port_loss, opt, scaler,
        grad_hook=lambda grads: inj.inject_grads(grads, next(calls)))
    s, g = scaler.init("cpu"), rz.init_guard_state(scaler, "cpu")
    batch = torch.ones(2, 4)
    s, g, m0 = step(model, None, s, g, batch)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    s, g, m1 = step(model, None, s, g, batch)
    m0, m1 = rz.fetch_metrics(m0), rz.fetch_metrics(m1)
    jinj = jrz.FaultInjector(jrz.FaultPlan(seed=3, inf_grad_steps=(1,)))
    planted = jrz.nonfinite_report(jrz.nonfinite_counts(jinj.inject_grads(
        {"b": jnp.ones(4), "w": jnp.ones((4, 4))}, jnp.int32(1))))
    assert not m0["found_inf"] and m0["nonfinite"] == {}
    assert m1["found_inf"] and m1["nonfinite"] == planted
    assert list(planted.values()) == [1]
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), before[name])


def test_floor_event_fires_at_fetch_not_in_the_step():
    """The pinned difference: the step emits nothing (it reads nothing on
    the device); ``fetch_metrics`` emits ``loss_scale_floor_halved`` once
    for the tripping step, with JAX's fields and values."""
    events = []
    add_event_sink(events.append)
    try:
        model = _Quad(_quadratic())
        opt = FusedAdam(model.parameters(), lr=1e-2)
        scaler = LossScaler(init_scale=4.0)
        step = rz.make_guarded_step(_port_loss, opt, scaler,
                                    rz.GuardConfig(patience=1))
        s, g = scaler.init("cpu"), rz.init_guard_state(scaler, "cpu")
        s, g, m = step(model, None, s, g, torch.full((2, 4), np.inf))
        assert not [e for e in events
                    if e["event"] == "loss_scale_floor_halved"]
        got = rz.fetch_metrics(m)
    finally:
        remove_event_sink(events.append)
    [ev] = [e for e in events if e["event"] == "loss_scale_floor_halved"]
    assert got["floor_tripped"] and got["skip_run"] == 1
    assert (ev["consecutive_skips"], ev["total_skips"], ev["scale"],
            ev["new_floor"]) == (1, 1, 2.0, 0.5)


def test_guard_state_checkpoints_beside_jax(tmp_path):
    """A guard state saved by the port restores into JAX's template (and
    back): the same three leaves, names and dtypes."""
    scaler = LossScaler()
    g = rz.init_guard_state(scaler, "cpu")._replace(
        total_skips=torch.tensor(7, dtype=torch.int32),
        scale_floor=torch.tensor(0.25))
    rz.CheckpointManager(str(tmp_path)).save(0, g)
    restored, _ = jrz.CheckpointManager(str(tmp_path)).restore(
        like=jrz.init_guard_state(JScaler()))
    assert _fields(scaler.init("cpu"), g)[4:] == [
        float(np.asarray(v)) for v in restored]
