"""The training faults of ``apex_tpu_torch.resilience.fault_injection``
against ``apex_tpu.resilience.fault_injection`` on the CPU: each fault
lands where JAX's lands for the same seed, over the same leaf order.

- ``FaultInjector.inject_grads``: the same leaf and element over seeded
  trees of mixed dtypes (int leaves and empty leaves never chosen), at a
  host step and at a 0-d tensor step; off-step calls give the same
  tensors back; an all-empty tree is a no-op.
- ``check_preemption``, ``corrupt_checkpoint`` (the same offsets),
  ``truncate_checkpoint``.
- ``SlowStep``, ``FlakyIterator``: the same sleeps, failures and stream.
- ``CorruptBatch``: the same NaN elements, the clean stream kept; the
  shape and dtype modes caught by the guard; the same refusals.
- ``DesyncReplica`` at one rank: the same leaf and element as JAX's on
  the stacked form, the same perturbed bits, the low-bit flip when the
  delta rounds away in bf16.
- ``tests/test_resilience.py::TestMicrobatchSkipConsistency``: one bad
  microbatch poisons the whole accumulated step, and the flag on the
  sums is the OR over the microbatches.
"""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import resilience as jrz
from apex_tpu_torch import resilience as rz
from apex_tpu_torch._logging import add_event_sink, remove_event_sink


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "count": np.arange(4, dtype=np.int32),
            "empty": np.zeros((0,), np.float32),
            "h": {"z": rng.standard_normal(9).astype(np.float16),
                  "y": rng.standard_normal((2, 2)).astype(np.float32)},
            "list": [rng.standard_normal(7).astype(np.float32),
                     rng.standard_normal(3).astype(np.float32)]}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree, dtype=np.float32) if not np.issubdtype(
        np.asarray(tree).dtype, np.integer) else np.asarray(tree)]


def _nonfinite_cells(tree):
    return [(i, tuple(np.argwhere(~np.isfinite(leaf)).ravel().tolist()))
            for i, leaf in enumerate(_flat(tree))
            if leaf.dtype.kind == "f" and (~np.isfinite(leaf)).any()]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tensor_step", [False, True], ids=["int", "tensor"])
def test_inject_grads_plants_jax_s_leaf_and_element(seed, tensor_step):
    plan = dict(seed=seed, nan_grad_steps=(2,), inf_grad_steps=(2, 5))
    tree = _tree(seed)
    port = _map(tree, torch.from_numpy)
    jtree = _map(tree, jnp.asarray)
    inj, jinj = rz.FaultInjector(rz.FaultPlan(**plan)), \
        jrz.FaultInjector(jrz.FaultPlan(**plan))
    for step in (0, 2, 5):
        s = torch.tensor(step, dtype=torch.int32) if tensor_step else step
        got = inj.inject_grads(port, s)
        want = jinj.inject_grads(jtree, jnp.int32(step))
        got_np = _map(got, lambda t: t.numpy())
        assert _nonfinite_cells(got_np) == _nonfinite_cells(want), step
        for g, w in zip(_flat(got_np), _flat(want)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got["count"].numpy(), tree["count"])
        if step == 0 and not tensor_step:
            assert all(a is b for a, b in zip(
                [got["a"], got["h"]["z"]], [port["a"], port["h"]["z"]]))
    # the source tree is never written
    np.testing.assert_array_equal(port["a"].numpy(), tree["a"])


def test_inject_grads_without_candidates_or_plan_is_a_no_op():
    only_empty = {"e": torch.zeros(0)}
    inj = rz.FaultInjector(rz.FaultPlan(seed=3, nan_grad_steps=(5,)))
    assert inj.inject_grads(only_empty, 5) is only_empty
    ints = {"i": torch.arange(3)}
    assert inj.inject_grads(ints, 5) is ints
    plain = {"a": torch.ones(2)}
    assert rz.FaultInjector(rz.FaultPlan()).inject_grads(plain, 0) is plain


def test_preemption_and_checkpoint_storage_faults_match_jax(tmp_path):
    inj = rz.FaultInjector(rz.FaultPlan(seed=9, preempt_steps=(4,)))
    inj.check_preemption(3)
    with pytest.raises(rz.SimulatedPreemption) as ei:
        inj.check_preemption(4)
    assert ei.value.step == 4
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    p1 = rz.save_checkpoint(str(tmp_path / "a"), 0, tree)
    p2 = rz.save_checkpoint(str(tmp_path / "b"), 0, tree)
    assert inj.corrupt_checkpoint(p1) == jrz.FaultInjector(
        jrz.FaultPlan(seed=9)).corrupt_checkpoint(p2)
    with pytest.raises(rz.CheckpointError):
        rz.validate_checkpoint(p1)
    p3 = rz.save_checkpoint(str(tmp_path / "c"), 0, tree)
    data = os.path.join(p3, "data.bin")
    size = os.path.getsize(data)
    inj.truncate_checkpoint(p3, drop_bytes=3)
    assert os.path.getsize(data) == size - 3
    with pytest.raises(rz.CheckpointError):
        rz.validate_checkpoint(p3)


def _events():
    seen = []
    add_event_sink(seen.append)
    return seen


def test_slow_step_and_flaky_iterator_match_jax():
    slept, jslept = [], []
    slow = rz.SlowStep((3, 5), 0.7, sleep=slept.append)
    jslow = jrz.SlowStep((3, 5), 0.7, sleep=jslept.append)
    for i in range(7):
        slow(i)
        jslow(i)
    assert slept == jslept == [0.7, 0.7]

    def drain(it):
        out = []
        while True:
            try:
                out.append(next(it))
            except ConnectionError as e:
                out.append(str(e))
            except StopIteration:
                return out

    kw = dict(fail_at=(0, 2), failures=2, exc_type=ConnectionError)
    assert drain(rz.FlakyIterator(iter(range(4)), **kw)) == drain(
        jrz.FlakyIterator(iter(range(4)), **kw))
    with pytest.raises(ValueError):
        rz.FlakyIterator(iter([]), failures=0)


@pytest.mark.parametrize("seed", [0, 5, 7])
def test_corrupt_batch_nans_land_where_jax_s_land(seed):
    clean = [{"i": np.arange(3, dtype=np.int32),
              "x": np.full((3, 4), float(k), np.float32)} for k in range(4)]
    got = list(rz.CorruptBatch(iter([{k: torch.from_numpy(v.copy())
                                      for k, v in b.items()} for b in clean]),
                               at=(1, 3), mode="nan", seed=seed,
                               n_elements=4))
    want = list(jrz.CorruptBatch(iter(clean), at=(1, 3), mode="nan",
                                 seed=seed, n_elements=4))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))
        assert isinstance(g["x"], torch.Tensor)
    for k, b in zip((0, 1, 2, 3), (got[0], got[2], got[3], got[5])):
        np.testing.assert_array_equal(b["x"].numpy(), clean[k]["x"])


def test_corrupt_batch_modes_and_refusals():
    spec = rz.spec_of({"x": torch.zeros(3, 2)})
    for mode in ("nan", "shape", "dtype"):
        cb = rz.CorruptBatch(iter([{"x": torch.zeros(3, 2)}]), at=(0,),
                             mode=mode)
        assert rz.validate_batch(next(cb), spec), mode
    with pytest.raises(ValueError, match="mode"):
        rz.CorruptBatch(iter([]), mode="gamma-ray")
    cb = rz.CorruptBatch(iter([{"y": torch.zeros(2, dtype=torch.int32)}]),
                         at=(0,), mode="nan")
    with pytest.raises(ValueError, match="no floating-point"):
        next(cb)


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32)},
            "opt": {"m": rng.standard_normal(6).astype(np.float32),
                    "h": (rng.standard_normal(8) * 300).astype(
                        ml_dtypes.bfloat16)}}


def _port_leaf(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes()
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


@pytest.mark.parametrize("seed,leaf,delta", [
    (0, None, 1e-3), (1, None, 1e-3), (4, "params", 0.5),
    (2, "h", 1e-3),                # bf16 at |x| ~ 300: the delta rounds away
])
def test_desync_replica_perturbs_jax_s_element(seed, leaf, delta):
    state = _state(seed)
    port = _map(state, _port_leaf)
    stacked = _map(state, lambda a: a[None])
    seen = _events()
    try:
        out = rz.DesyncReplica((3,), rank=0, leaf=leaf, seed=seed,
                               delta=delta)(port, 3)
    finally:
        remove_event_sink(seen.append)
    want = jrz.DesyncReplica((3,), rank=0, leaf=leaf, seed=seed,
                             delta=delta)(stacked, 3)
    assert out is port
    changed = []
    for path, g, w, s in zip(range(4), _flat_any(out), _flat_any(want),
                             _flat_any(stacked)):
        assert _bits(g) == _bits(np.asarray(w)[0]), path
        if _bits(g) != _bits(np.asarray(s)[0]):
            changed.append(path)
    assert len(changed) == 1
    [ev] = [e for e in seen if e["event"] == "fault_injected"]
    assert ev["fault"] == "desync_replica" and ev["rank"] == 0
    off = rz.DesyncReplica((3,), rank=0, seed=seed)(port, 4)
    assert off is port


def _flat_any(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_any(tree[k])]
    return [tree]


def test_desync_replica_off_its_rank_and_without_candidates():
    port = {"w": torch.ones(3)}
    before = port["w"].clone()
    assert rz.DesyncReplica((0,), rank=1)(port, 0) is port
    assert torch.equal(port["w"], before)
    with pytest.raises(ValueError, match="no non-empty floating"):
        rz.DesyncReplica((0,), rank=0, leaf="nope")(port, 0)


class TestMicrobatchSkipConsistency:
    """``tests/test_resilience.py::TestMicrobatchSkipConsistency`` on the
    port, beside JAX's."""

    def test_one_bad_microbatch_poisons_the_step(self):
        import jax

        from apex_tpu.amp.scaler import LossScaler as JScaler
        from apex_tpu.transformer.pipeline_parallel import (
            forward_backward_no_pipelining as jnopipe,
        )
        from apex_tpu_torch.amp import LossScaler
        from apex_tpu_torch.optimizers import FusedAdam
        from apex_tpu_torch.transformer.pipeline_parallel import (
            forward_backward_no_pipelining,
        )

        w = torch.nn.Parameter(torch.ones(4))
        scaler = LossScaler(init_scale=2.0 ** 4)
        sstate = scaler.init("cpu")
        clean = np.ones((3, 4), np.float32)
        dirty = clean.copy()
        dirty[1, 2] = np.inf               # ONE bad microbatch of three
        jscaler = JScaler(init_scale=2.0 ** 4)
        for mbs, bad in ((clean, False), (dirty, True)):
            _, grads, found = forward_backward_no_pipelining(
                lambda mb: (w * mb).sum(), torch.from_numpy(mbs), model=[w],
                grad_scaler=scaler, scaler_state=sstate, with_found_inf=True)
            _, jgrads, jfound = jnopipe(
                lambda p, mb: jnp.sum(p["w"] * mb), {"w": jnp.ones(4)},
                jnp.asarray(mbs), grad_scaler=jscaler,
                scaler_state=jscaler.init(), with_found_inf=True)
            assert bool(found) == bool(jfound) == bad
            np.testing.assert_array_equal(grads["0"].numpy(),
                                          np.asarray(jgrads["w"]))
        # all or nothing: the whole accumulated update is skipped
        opt = FusedAdam([w], lr=1e-2)
        opt.step(grad_scale=sstate.scale, found_inf=found,
                 grads={w: grads["0"]})
        assert torch.equal(w.detach(), torch.ones(4))
        assert int(opt.state[w]["step"]) == 0
        del jax

    def test_accumulated_flag_matches_per_microbatch_or(self):
        from apex_tpu_torch.transformer.pipeline_parallel import (
            accumulated_found_inf,
        )

        per_mb = [torch.ones(4), torch.tensor([1.0, np.inf, -np.inf, 0.0]),
                  torch.tensor([1.0, -np.inf, np.inf, 0.0])]  # sums to nan
        assert bool(accumulated_found_inf([sum(per_mb)]))
        assert not bool(accumulated_found_inf([per_mb[0] + per_mb[0]]))
