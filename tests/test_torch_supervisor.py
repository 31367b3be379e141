"""The training supervisor (``apex_tpu_torch.resilience.supervisor``)
against ``apex_tpu.resilience.supervisor`` on the CPU, with the fake
clock of ``tests/test_supervisor.py``: the same scenario through both
packages (the state a torch tree in the port, a JAX tree in the
reference, the same numpy batches), compared by their event streams,
their abort and checkpoint steps, and the states they end with.

- The watchdog: fast and slow steps, the stall dump (the port reports
  ``cuda_allocated_bytes`` where JAX counts live arrays: a pinned
  difference), the monitor thread mid-stall, the step context, the
  heartbeat pointer; ``apex_step_duration_seconds``,
  ``apex_supervisor_steps_total`` and ``apex_heartbeat_age_seconds``.
- Escalation: below the threshold, at it (a validated emergency
  checkpoint, restored), an unwritable root, fetch failures labelled
  with the completed step, the manager's retry not nested.
- The acceptance run of ``tests/test_supervisor.py``: a flaky fetch, a
  corrupt batch and a slow step under a deadline; the same events as
  JAX's, the abort at the slow step, and a restart that ends bit for bit
  where an uninterrupted run ends.
- ``async_save``: the same bytes on disk as a sync run, the escalation
  joining the in-flight write, and a failed consistency pass vetoing the
  commit in flight, each as JAX's.
"""

import json
import logging
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import resilience as jrz
from apex_tpu_torch import resilience as rz
from apex_tpu_torch._logging import add_event_sink, remove_event_sink
from apex_tpu_torch.obs import REGISTRY


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Events:
    """The events both packages emit while it is open: the port's through
    a sink, JAX's through its ``apex_tpu.events`` logger."""

    def __enter__(self):
        self.port, self._jax = [], []
        add_event_sink(self.port.append)
        self._handler = logging.Handler()
        self._handler.emit = lambda r: self._jax.append(r.getMessage())
        self._logger = logging.getLogger("apex_tpu.events")
        self._logger.addHandler(self._handler)
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        remove_event_sink(self.port.append)
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)

    @property
    def jax(self):
        return [json.loads(r) for r in self._jax]

    def kinds(self, which, keep=None):
        evs = self.port if which == "port" else self.jax
        return [e["event"] for e in evs
                if keep is None or e["event"] in keep]


def _cfg(pkg, **kw):
    kw.setdefault("retry", pkg.RetryPolicy(max_attempts=3, base_delay_s=0.0))
    return pkg.SupervisorConfig(**kw)


# -- the watchdog ------------------------------------------------------------

def test_slow_step_raises_with_the_stall_dump():
    clock = FakeClock()
    wd = rz.StepWatchdog(1.0, clock=clock)
    wd.beat(4)
    clock.advance(0.5)
    wd.arm(5)
    clock.advance(2.5)
    with Events() as ev:
        with pytest.raises(rz.StepDeadlineExceeded) as ei:
            wd.disarm()
    e = ei.value
    assert e.step == 5 and e.elapsed_s == pytest.approx(2.5)
    assert e.diagnostics["heartbeat_age_s"] == pytest.approx(3.0)
    assert e.diagnostics["cuda_allocated_bytes"] == 0     # no card here
    assert "live_arrays" not in e.diagnostics
    [stall] = [x for x in ev.port if x["event"] == "watchdog_stall"]
    assert stall["step"] == 5
    fast = rz.StepWatchdog(1.0, clock=FakeClock())
    fast.arm(0)
    fast.disarm()
    with pytest.raises(RuntimeError, match="without a matching arm"):
        rz.StepWatchdog(1.0).disarm()
    with pytest.raises(ValueError):
        rz.StepWatchdog(0.0)


def test_monitor_thread_reports_mid_stall(tmp_path):
    """The monitor (real 10 ms polls) sees the fake clock pass the
    deadline while the step is armed: one ``watchdog_stall`` and the
    heartbeat's stall mark before the step ends, none more at disarm."""
    hb = str(tmp_path / "heartbeat.json")
    clock = FakeClock()
    wd = rz.StepWatchdog(0.05, heartbeat_path=hb, poll_interval_s=0.01,
                         clock=clock)
    with Events() as ev:
        with wd:
            wd.arm(7)
            clock.advance(1.0)
            deadline = time.monotonic() + 5.0
            while not ev.kinds("port", {"watchdog_stall"}) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ev.kinds("port", {"watchdog_stall"}) == ["watchdog_stall"]
            assert rz.read_heartbeat(hb)["stalled"] is True
            with pytest.raises(rz.StepDeadlineExceeded):
                wd.disarm()
        assert ev.kinds("port", {"watchdog_stall"}) == ["watchdog_stall"]


def test_step_context_and_sticky_heartbeat_pointer(tmp_path):
    clock = FakeClock()
    wd = rz.StepWatchdog(0.1, clock=clock,
                         heartbeat_path=str(tmp_path / "hb.json"))
    with pytest.raises(ValueError, match="body bug"):
        with wd.step(0):
            clock.advance(99.0)
            raise ValueError("body bug")
    wd.arm(1)
    wd.disarm()
    wd.beat(1, ckpt_path="/ckpt/step_1")
    wd.beat(2)
    beat = rz.read_heartbeat(str(tmp_path / "hb.json"))
    assert beat["step"] == 2 and beat["ckpt_path"] == "/ckpt/step_1"
    assert set(beat) == {"step", "time", "monotonic", "pid", "ckpt_path",
                         "stalled"}


def test_supervisor_instruments_count_steps_and_read_the_beat_age():
    hist = REGISTRY.get("apex_step_duration_seconds")
    steps = REGISTRY.get("apex_supervisor_steps_total")
    age = REGISTRY.get("apex_heartbeat_age_seconds")
    n0, c0 = steps.value(), hist.count()
    clock = FakeClock()
    sup = rz.TrainingSupervisor(None, _cfg(rz), clock=clock)
    seen = []

    def step(state, batch, i):
        clock.advance(0.25)
        seen.append(age.value())
        return state + batch

    state, last = sup.run(step, 0, iter(range(4)), num_steps=4)
    assert (state, last) == (6, 3)
    assert steps.value() - n0 == 4
    assert hist.count() - c0 == 4
    # the gauge is the watchdog's beat age while it runs (-1 before the
    # first beat), and the sentinel once it stopped
    assert seen[0] == -1.0 and seen[1:] == [0.25, 0.25, 0.25]
    assert age.value() == -1.0


# -- escalation ---------------------------------------------------------------

def test_failures_below_the_threshold_do_not_abort():
    for pkg in (rz, jrz):
        sup = pkg.TrainingSupervisor(None, _cfg(pkg,
                                                max_consecutive_failures=3))
        sup.record_failure(0, {}, OSError("x"))
        sup.record_failure(1, {}, OSError("x"))
        assert sup.consecutive_failures == 2
        sup.record_success()
        assert sup.consecutive_failures == 0
    for kw in (dict(max_consecutive_failures=0), dict(checkpoint_every=0),
               dict(step_deadline_s=-1.0), dict(consistency_check_interval=-1),
               dict(async_join_timeout_s=0.0)):
        with pytest.raises(ValueError):
            rz.SupervisorConfig(**kw)


def test_threshold_escalates_with_a_validated_checkpoint(tmp_path):
    mgr = rz.CheckpointManager(str(tmp_path))
    sup = rz.TrainingSupervisor(mgr, _cfg(rz, max_consecutive_failures=1))
    with Events() as ev:
        with pytest.raises(rz.TrainingAborted) as ei:
            sup.record_failure(9, {"w": torch.arange(4.0)},
                               rz.StepDeadlineExceeded(9, 1.0, 2.0))
    ab = ei.value
    assert ab.step == 9 and ab.checkpoint_path is not None
    rz.validate_checkpoint(ab.checkpoint_path)
    restored, step = mgr.restore(like={"w": torch.zeros(4)})
    assert step == 9 and torch.equal(restored["w"], torch.arange(4.0))
    [abort] = [e for e in ev.port if e["event"] == "supervisor_abort"]
    assert abort["checkpoint"] == ab.checkpoint_path
    assert abort["checkpoint_error"] is None
    # JAX's checkpoint of the same values restores into the port's form
    jmgr = jrz.CheckpointManager(str(tmp_path / "jax"))
    with pytest.raises(jrz.TrainingAborted) as jei:
        jrz.TrainingSupervisor(jmgr, _cfg(jrz, max_consecutive_failures=1)
                               ).record_failure(
            9, {"w": jnp.arange(4.0)}, jrz.StepDeadlineExceeded(9, 1.0, 2.0))
    back, jstep = rz.CheckpointManager(str(tmp_path / "jax")).restore(
        like={"w": torch.zeros(4)})
    assert jstep == 9 == jei.value.step and torch.equal(back["w"],
                                                        restored["w"])


def test_abort_survives_an_unwritable_checkpoint(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = rz.CheckpointManager(str(blocker / "ckpts"))
    sup = rz.TrainingSupervisor(mgr, _cfg(rz, max_consecutive_failures=1),
                                sleep=lambda s: None)
    with Events() as ev:
        with pytest.raises(rz.TrainingAborted) as ei:
            sup.record_failure(3, {"w": torch.ones(2)}, OSError("x"))
    assert ei.value.checkpoint_path is None
    [abort] = [e for e in ev.port if e["event"] == "supervisor_abort"]
    assert abort["checkpoint_error"] is not None


class _OneGoodThenBroken:
    def __init__(self, good=1):
        self.n, self.good = 0, good

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n <= self.good:
            return 1.0
        raise OSError("producer gone")


@pytest.mark.parametrize("good", [1, 0])
def test_fetch_failure_checkpoints_the_completed_step(tmp_path, good):
    """As JAX's: a step whose fetch fails escalates with the PREVIOUS
    step's label (-1 before any step), so a resume at label + 1 re-runs
    the step that never ran."""
    got = {}
    for pkg, make in ((rz, lambda: {"w": torch.zeros(2)}),
                      (jrz, lambda: {"w": jnp.zeros(2)})):
        root = str(tmp_path / pkg.__name__)
        mgr = pkg.CheckpointManager(root)
        sup = pkg.TrainingSupervisor(
            mgr, _cfg(pkg, max_consecutive_failures=1, checkpoint_every=5),
            sleep=lambda s: None)
        with pytest.raises(pkg.TrainingAborted) as ei:
            sup.run(lambda s, b, i: {"w": s["w"] + b}, make(),
                    _OneGoodThenBroken(good), num_steps=5)
        restored, step = mgr.restore(like=make())
        got[pkg.__name__] = (ei.value.step, step,
                             np.asarray(restored["w"]).tolist())
    assert got["apex_tpu_torch.resilience"] == got["apex_tpu.resilience"]
    assert got["apex_tpu.resilience"] == (good, good - 1, [float(good)] * 2)


def test_manager_retry_policy_is_not_nested(tmp_path, monkeypatch):
    from apex_tpu_torch.resilience import checkpoint as ckpt

    calls = []

    def failing_save(*a, **kw):
        calls.append(1)
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt, "save_checkpoint", failing_save)
    mgr = rz.CheckpointManager(
        str(tmp_path), retry=rz.RetryPolicy(max_attempts=2,
                                            base_delay_s=0.0))
    sup = rz.TrainingSupervisor(mgr, _cfg(rz, max_consecutive_failures=1),
                                sleep=lambda s: None)
    with pytest.raises(rz.TrainingAborted):
        sup.run(lambda s, b, i: s, {"x": torch.ones(2)}, iter(range(3)),
                num_steps=3)
    assert len(calls) == 4      # 2 for the periodic save + 2 emergency


def test_flaky_fetch_recovers_and_unrelated_errors_propagate():
    sup = rz.TrainingSupervisor(None, _cfg(rz), sleep=lambda s: None)
    src = rz.FlakyIterator(iter(range(4)), fail_at=(1,), failures=2)
    seen = []
    state, last = sup.run(lambda s, b, i: seen.append((i, b)) or s,
                          None, src, num_steps=4)
    assert seen == [(0, 0), (1, 1), (2, 2), (3, 3)]
    assert last == 3 and sup.consecutive_failures == 0
    assert rz.TrainingSupervisor(None, _cfg(rz)).run(
        lambda s, b, i: s, {"x": 0}, iter([]), num_steps=5) == ({"x": 0}, -1)

    def bad_step(state, batch, step):
        raise ZeroDivisionError("model bug, not infrastructure")

    with pytest.raises(ZeroDivisionError):
        rz.TrainingSupervisor(None, _cfg(rz)).run(bad_step, None,
                                                  iter(range(3)), num_steps=3)


# -- the acceptance run, in both packages -------------------------------------

N_STEPS, FLAKY_AT, CORRUPT_AT, SLOW_AT = 10, 2, 4, 6
DEADLINE_S, SLOW_S = 0.2, 0.6
_KINDS = {"retry_attempt", "retry_recovered", "batch_skipped",
          "watchdog_stall", "supervisor_failure", "supervisor_abort",
          "fault_injected", "checkpoint_saved"}


def _batches():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((4, 6)).astype(np.float32)
            for _ in range(N_STEPS)]


def _update(pkg):
    """``w <- w + 0.1 * tanh(batch).mean(0)``, a counter, in each package's
    arrays; the same values bit for bit, the same on every run."""
    if pkg is rz:
        def step(state, batch):
            return {"n": state["n"] + 1,
                    "w": state["w"] + 0.1 * torch.tanh(
                        torch.as_tensor(batch)).mean(0)}
        return {"n": torch.tensor(0, dtype=torch.int32),
                "w": torch.zeros(6)}, step

    def jstep(state, batch):
        return {"n": state["n"] + 1,
                "w": state["w"] + 0.1 * jnp.tanh(jnp.asarray(batch)).mean(0)}
    return {"n": jnp.int32(0), "w": jnp.zeros(6, jnp.float32)}, jstep


def _acceptance(pkg, tmp_path, to=lambda b: b):
    batches = [to(b) for b in _batches()]
    clock = FakeClock()
    init, update = _update(pkg)

    def step_fn(state, batch, step):
        slow(step)
        return update(state, batch)

    slow = pkg.SlowStep((SLOW_AT,), SLOW_S, sleep=clock.advance)
    hb = str(tmp_path / f"{pkg.__name__}.hb.json")
    stream = pkg.GuardedIterator(
        pkg.CorruptBatch(
            pkg.FlakyIterator(iter(batches), fail_at=(FLAKY_AT,),
                              failures=2),
            at=(CORRUPT_AT,), mode="nan", seed=7),
        spec=pkg.spec_of(batches[0]), skip_budget=2)
    cfg = pkg.SupervisorConfig(
        step_deadline_s=DEADLINE_S, poll_interval_s=0.02,
        max_consecutive_failures=1, checkpoint_every=1, heartbeat_path=hb,
        retry=pkg.RetryPolicy(max_attempts=4, base_delay_s=0.0))
    mgr = pkg.CheckpointManager(str(tmp_path / pkg.__name__), keep=3)
    sup = pkg.TrainingSupervisor(mgr, cfg, clock=clock, sleep=lambda s: None)
    with pytest.raises(pkg.TrainingAborted) as ei:
        sup.run(step_fn, init, stream, num_steps=N_STEPS)
    aborted = ei.value
    pkg.validate_checkpoint(aborted.checkpoint_path)
    beat = pkg.read_heartbeat(hb)
    resumed, at = mgr.restore(like=_update(pkg)[0])
    final, last = pkg.TrainingSupervisor(mgr, _cfg(pkg)).run(
        lambda s, b, i: update(s, b), resumed, iter(batches[at + 1:]),
        num_steps=N_STEPS, start_step=at + 1)
    ref, _ = pkg.TrainingSupervisor(None, _cfg(pkg)).run(
        lambda s, b, i: update(s, b), _update(pkg)[0], iter(batches),
        num_steps=N_STEPS)
    return dict(step=aborted.step, resumed_at=at, last=last,
                skipped=stream.skipped, beat=(beat["step"], beat["ckpt_path"]
                                              == aborted.checkpoint_path),
                final={k: np.asarray(v).tolist() for k, v in final.items()},
                ref={k: np.asarray(v).tolist() for k, v in ref.items()})


def test_acceptance_run_degrades_and_resumes_as_jax_does(tmp_path):
    with Events() as ev:
        got = _acceptance(rz, tmp_path, torch.from_numpy)
    port_kinds = ev.kinds("port", _KINDS)
    with Events() as ev:
        want = _acceptance(jrz, tmp_path)
    jax_kinds = ev.kinds("jax", _KINDS)
    assert port_kinds == jax_kinds
    assert port_kinds.count("retry_attempt") == 2
    assert port_kinds.count("batch_skipped") == 1
    assert port_kinds.count("watchdog_stall") == 1
    assert port_kinds.count("supervisor_abort") == 1
    assert {k: v for k, v in got.items() if k not in ("final", "ref")} == \
        {k: v for k, v in want.items() if k not in ("final", "ref")}
    assert got["step"] == SLOW_AT == got["resumed_at"]
    assert got["last"] == N_STEPS - 1 and got["beat"] == (SLOW_AT, True)
    # the restart ends bit for bit where the uninterrupted run ends
    assert got["final"] == got["ref"]
    assert got["final"]["n"] == N_STEPS


# -- async_save -------------------------------------------------------------

def _accum_step(state, batch, step):
    return {"n": state["n"] + 1, "w": state["w"] + batch}


def _accum_state():
    return {"n": torch.tensor(0, dtype=torch.int32),
            "w": torch.zeros(4, 4)}


def _accum_batches(n):
    return [torch.full((4, 4), float(i + 1)) for i in range(n)]


def _step_dirs(root):
    return sorted(d for d in os.listdir(root) if d.startswith("step_"))


def _dir_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))
            if name != "manifest.json"}


def test_async_run_writes_the_sync_run_s_bytes(tmp_path):
    roots = {m: str(tmp_path / m) for m in ("sync", "async")}
    finals = {}
    for mode, root in roots.items():
        sup = rz.TrainingSupervisor(
            rz.CheckpointManager(root, keep=10),
            _cfg(rz, checkpoint_every=2, async_save=(mode == "async"),
                 heartbeat_path=str(tmp_path / f"{mode}.hb")))
        finals[mode], last = sup.run(_accum_step, _accum_state(),
                                     _accum_batches(6), num_steps=6)
        assert last == 5
    assert all(torch.equal(finals["sync"][k], finals["async"][k])
               for k in ("n", "w"))
    assert _step_dirs(roots["sync"]) == _step_dirs(roots["async"]) == [
        "step_0000000001", "step_0000000003", "step_0000000005"]
    for d in _step_dirs(roots["sync"]):
        assert _dir_bytes(os.path.join(roots["sync"], d)) == \
            _dir_bytes(os.path.join(roots["async"], d)), d
    beat = rz.read_heartbeat(str(tmp_path / "async.hb"))
    assert beat["ckpt_path"].endswith("step_0000000005")


def test_escalation_joins_the_inflight_write_then_checkpoints(tmp_path):
    sup = rz.TrainingSupervisor(
        rz.CheckpointManager(str(tmp_path), keep=10),
        _cfg(rz, checkpoint_every=1, async_save=True,
             max_consecutive_failures=1))
    sup._async.progress_hook = lambda p: time.sleep(0.05)  # a slow writer
    fut = sup._async.save(0, {"w": torch.arange(4.0)})
    with pytest.raises(rz.TrainingAborted) as ei:
        sup.record_failure(1, {"w": torch.ones(4)},
                           rz.StepDeadlineExceeded(1, 1.0, 2.0))
    assert fut.done() and fut.error is None
    assert _step_dirs(str(tmp_path)) == ["step_0000000000",
                                         "step_0000000001"]
    rz.validate_checkpoint(ei.value.checkpoint_path)


def test_consistency_failure_vetoes_the_inflight_commit(tmp_path):
    class FlakyConsistency:
        calls = 0

        def check(self, state, step):
            type(self).calls += 1
            if type(self).calls == 1:
                raise rz.ReplicaDesyncError(step, [])
            return state

    sup = rz.TrainingSupervisor(
        rz.CheckpointManager(str(tmp_path), keep=10),
        _cfg(rz, checkpoint_every=1, async_save=True,
             consistency_check_interval=2, max_consecutive_failures=50),
        consistency=FlakyConsistency())
    sup._async.progress_hook = lambda p: time.sleep(0.1)  # in flight
    with Events() as ev:
        state, last = sup.run(_accum_step, _accum_state(),
                              _accum_batches(6), num_steps=6)
    assert last == 5
    dirs = _step_dirs(str(tmp_path))
    assert not {"step_0000000000", "step_0000000001",
                "step_0000000002"} & set(dirs)
    assert {"step_0000000003", "step_0000000004",
            "step_0000000005"} <= set(dirs)
    assert ev.kinds("port", {"checkpoint_commit_vetoed"})
    assert rz.latest_valid_step(str(tmp_path)) == 5


def test_consistency_pass_under_the_supervisor_repairs_one_replica(tmp_path):
    """A ``ReplicaConsistency`` pass at world one (no group) finds
    nothing and commits every step; the same pass with resync off on a
    state that always fails escalates through the ladder."""
    sup = rz.TrainingSupervisor(
        rz.CheckpointManager(str(tmp_path), keep=10),
        _cfg(rz, consistency_check_interval=1),
        consistency=rz.ReplicaConsistency())
    state, last = sup.run(_accum_step, _accum_state(), _accum_batches(3),
                          num_steps=3)
    assert last == 2 and rz.latest_valid_step(str(tmp_path)) == 2
