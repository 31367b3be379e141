"""The data guard (``apex_tpu_torch.resilience.data_guard``) against
``apex_tpu.resilience.data_guard`` on the CPU, the same numpy batches
through both, each package's torch / JAX form where it takes one:

- ``validate_batch``'s reasons, word for word, for clean, non-finite,
  shape, dtype and structure defects, over dicts (keys sorted),
  namedtuples and nested lists, numpy and tensor leaves;
- ``GuardedIterator``'s skips, budget, ``batch_skipped`` events, stall
  (a fake clock) and redelivery of the stalled batch, as JAX's.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import resilience as jrz
from apex_tpu_torch import resilience as rz
from apex_tpu_torch._logging import add_event_sink, remove_event_sink
from apex_tpu_torch.resilience.data_guard import BatchLeafSpec

Pair = collections.namedtuple("Pair", "x y")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _clean(i=0):
    return {"x": np.full((2, 3), float(i), np.float32),
            "y": np.arange(2, dtype=np.int32),
            "z": [np.ones(4, np.float16), Pair(np.zeros(2, np.float32),
                                               np.ones(1, np.int32))]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_to_torch(v) for v in tree))
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_to_jax(v) for v in tree))
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree)


def _nan(b):
    b = {**b, "x": b["x"].copy()}
    b["x"][1, 2] = np.nan
    b["x"][0, 0] = np.inf
    return b


MUTATIONS = {
    "clean": lambda b: b,
    "nonfinite": _nan,
    "nonfinite_deep": lambda b: {**b, "z": [np.full(4, np.nan, np.float16),
                                            b["z"][1]]},
    "shape": lambda b: {**b, "x": b["x"][1:]},
    "dtype": lambda b: {**b, "x": b["x"].astype(np.float16)},
    "two_defects": lambda b: {**_nan(b), "y": b["y"][:1]},
    "structure_key": lambda b: {"x": b["x"], "w": b["y"], "z": b["z"]},
    "structure_len": lambda b: {**b, "z": b["z"][:1]},
}


@pytest.mark.parametrize("form", ["numpy", "torch"])
@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_validate_batch_reasons_are_jax_reasons(mutation, form):
    spec_src = _clean()
    batch = MUTATIONS[mutation](_clean(1))
    port_batch = batch if form == "numpy" else _to_torch(batch)
    port_spec = rz.spec_of(spec_src if form == "numpy"
                           else _to_torch(spec_src))
    got = rz.validate_batch(port_batch, port_spec)
    want = jrz.validate_batch(_to_jax(batch), jrz.spec_of(_to_jax(spec_src)))
    assert got == want
    assert bool(got) == (mutation != "clean")
    assert rz.validate_batch(port_batch, port_spec, check_finite=False) == \
        jrz.validate_batch(_to_jax(batch), jrz.spec_of(_to_jax(spec_src)),
                           check_finite=False)


def test_spec_of_reads_shapes_and_dtype_names():
    spec = rz.spec_of(_to_torch(_clean()))
    assert spec["x"] == BatchLeafSpec((2, 3), "float32")
    assert spec["z"][1].y == BatchLeafSpec((1,), "int32")
    bf = rz.spec_of({"h": torch.zeros(3, dtype=torch.bfloat16)})
    assert bf["h"].dtype == "bfloat16"


def _events(kind):
    seen = []
    sink = seen.append
    add_event_sink(sink)
    return seen, sink


def _drive(make, n_calls):
    """Call ``next`` ``n_calls`` times on the iterator ``make()``; the
    outcome of each (``"ok i"``, an exception name, or ``"stop"``), with
    ``skipped`` and ``delivered`` at the end."""
    it = make()
    out = []
    for _ in range(n_calls):
        try:
            b = next(it)
            x = b["x"]
            out.append(f"ok {float(np.asarray(x).reshape(-1)[0])}")
        except StopIteration:
            out.append("stop")
            break
        except Exception as e:
            out.append(type(e).__name__)
    return out, it.skipped, it.delivered


@pytest.mark.parametrize("budget", [0, 1, 2])
def test_guarded_iterator_skips_and_budget_match_jax(budget):
    stream = [_clean(0), _nan(_clean(1)), _clean(2),
              MUTATIONS["shape"](_clean(3)), _clean(4),
              MUTATIONS["dtype"](_clean(5)), _clean(6)]
    seen, sink = _events("batch_skipped")
    try:
        got = _drive(lambda: rz.GuardedIterator(
            iter([_to_torch(b) for b in stream]),
            spec=rz.spec_of(_to_torch(_clean())), skip_budget=budget), 10)
    finally:
        remove_event_sink(sink)
    want = _drive(lambda: jrz.GuardedIterator(
        iter(stream), spec=jrz.spec_of(_clean()), skip_budget=budget), 10)
    assert got == want
    skips = [e for e in seen if e["event"] == "batch_skipped"]
    assert [e["skipped"] for e in skips] == list(range(1, len(skips) + 1))
    # the driver pulls on past each SkipBudgetExceeded: all three skip
    assert len(skips) == 3
    assert got[0].count("SkipBudgetExceeded") == max(0, 3 - budget)


def test_guarded_iterator_stall_and_redelivery_match_jax():
    def run(pkg, to):
        clock = FakeClock()

        def source():
            for i in range(4):
                clock.advance(5.0 if i in (1, 2) else 0.1)
                yield to(_clean(i))

        g = pkg.GuardedIterator(source(), stall_timeout_s=1.0, clock=clock)
        return _drive(lambda: g, 8)

    assert run(rz, _to_torch) == run(jrz, lambda b: b)
    assert run(rz, _to_torch)[0] == [
        "ok 0.0", "DataStallError", "ok 1.0", "DataStallError", "ok 2.0",
        "ok 3.0", "stop"]


def test_spec_locks_to_the_first_batch_and_degenerate_arguments():
    stream = [_clean(0), _clean(1), MUTATIONS["shape"](_clean(2))]
    assert _drive(lambda: rz.GuardedIterator(iter(stream)), 5) == _drive(
        lambda: jrz.GuardedIterator(iter(stream)), 5)
    for kw in (dict(skip_budget=-1), dict(stall_timeout_s=0.0)):
        with pytest.raises(ValueError):
            rz.GuardedIterator(iter([]), **kw)
    assert rz.DataStallError.transient is False
    assert issubclass(rz.DataStallError, TimeoutError)
