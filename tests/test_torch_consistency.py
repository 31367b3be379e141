"""Replica consistency (``apex_tpu_torch.resilience.consistency``) against
``apex_tpu.resilience.consistency`` on the CPU.

- ``_shard_hash`` equal to JAX's u32, bit for bit, over fp32, bf16, fp16,
  int32 and bool leaves, odd byte counts (a zero-padded tail) and empty
  leaves included, a leaf long enough to wrap the sum many times, and in
  chunks (the chunk size cut to a few words).
- A gloo world of dp 2 x tp 2 (one process a replica shard) against
  JAX's ``(dp 2, tp 2)`` mesh of four virtual CPU devices, the same
  weights (two tp-sharded leaves, one replicated), after the same
  ``DesyncReplica`` on dp rank 1: ``replica_hashes`` equal for every
  leaf, ``verify_replicas`` naming the same leaf and ranks with the same
  hashes and delta, the same events, ``resync_replicas`` from the same
  ``majority_root`` leaving both clean, and ``ReplicaConsistency`` doing
  the same in one pass.
- ``majority_root`` on the same reports; the world-of-one form (no group:
  one replica) hashes each leaf locally.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from apex_tpu import resilience as jrz
from apex_tpu.resilience.consistency import _shard_hash as jhash
from apex_tpu_torch.resilience import consistency as tc
from apex_tpu_torch.transformer.testing.distributed import run_world
from torch_consistency_helpers import DP, TP, _summary, _weights, _world


def _leaves():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16_odd": rng.standard_normal(3).astype(ml_dtypes.bfloat16),
        "f16_odd": rng.standard_normal(5).astype(np.float16),
        "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, 9).astype(np.int32),
        "bool_odd": rng.random(7) > 0.5,
        "empty": np.zeros((0, 3), np.float32),
        "wrap": rng.integers(0, 2 ** 32, 100_003).astype(np.uint32).view(
            np.float32),
    }


def _torch(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("name", list(_leaves()))
def test_shard_hash_is_jax_s_bit_for_bit(name, monkeypatch):
    arr = _leaves()[name]
    want = int(np.asarray(jhash(jnp.asarray(arr))))
    got = tc._shard_hash(_torch(arr))
    assert got.dtype == torch.int64 and 0 <= int(got) < 2 ** 32
    assert int(got) == want
    monkeypatch.setattr(tc, "_HASH_CHUNK_WORDS", 5)
    assert int(tc._shard_hash(_torch(arr))) == want


def test_world_of_one_hashes_each_leaf_locally():
    tree = {k: _torch(v) for k, v in _leaves().items()}
    rec = tc.replica_hashes(tree)
    assert list(rec) == sorted(f"['{k}']" for k in tree)
    for key, r in rec.items():
        assert r["hashes"].dtype == np.uint32 and r["hashes"].shape == (1,)
        assert int(r["hashes"][0]) == int(tc._shard_hash(tree[key[2:-2]]))
        assert r["max_abs_delta"].tolist() == [0.0]
    assert tc.verify_replicas(tree) == []
    assert tc.resync_replicas(tree) is tree
    assert tc.collapse_replicas(tree) is tree
    with pytest.raises(ValueError, match="ProcessGroup"):
        tc.replica_hashes(tree, axis_name="dp")


def _jax_state(mesh, weights):
    p = weights["params"]
    logical = {"params": {
        "w": jax.device_put(jnp.asarray(p["w"]),
                            NamedSharding(mesh, P(None, "tp"))),
        "b": jax.device_put(jnp.asarray(p["b"]), NamedSharding(mesh, P("tp"))),
        "r": jax.device_put(jnp.asarray(p["r"]), NamedSharding(mesh, P()))}}
    return jrz.expand_replicas(logical, mesh)


@pytest.fixture(scope="module")
def runs(devices):
    from apex_tpu.transformer import parallel_state as jps

    weights = _weights()
    desync_kw = dict(rank=1, leaf="['r']", seed=3, delta=0.25)
    mesh = jps.initialize_model_parallel(TP, 1, devices=devices[:DP * TP])
    try:
        state = _jax_state(mesh, weights)
        ref = {"clean": {k: v["hashes"].tolist() for k, v in
                         jrz.replica_hashes(state, mesh=mesh).items()}}
        bad = jrz.DesyncReplica((2,), **desync_kw)(state, 2)
        rec = jrz.replica_hashes(bad, mesh=mesh)
        ref["hashes"] = {k: v["hashes"].tolist() for k, v in rec.items()}
        ref["deltas"] = {k: v["max_abs_delta"].tolist()
                         for k, v in rec.items()}
        report = jrz.verify_replicas(bad, mesh=mesh, step=2)
        ref["report"] = _summary(report)
        ref["root"] = jrz.majority_root(report)
        fixed = jrz.resync_replicas(bad, mesh=mesh, root=ref["root"])
        ref["after_resync"] = _summary(jrz.verify_replicas(fixed, mesh=mesh))
        ref["state"] = {k: np.asarray(v)
                        for k, v in jrz.collapse_replicas(fixed)[
                            "params"].items()}
    finally:
        jps.destroy_model_parallel()
    got = run_world(_world, DP * TP, args=(weights, desync_kw),
                    timeout=120)
    return ref, got


def test_hashes_match_jax_clean_and_desynced(runs):
    ref, got = runs
    assert [(r["dp"], r["tp"]) for r in got] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    for r in got:
        assert r["clean"] == ref["clean"]
        assert r["hashes"] == ref["hashes"]
        np.testing.assert_allclose(r["deltas"]["['params']['r']"],
                                   ref["deltas"]["['params']['r']"],
                                   rtol=1e-6)
    assert len(set(ref["hashes"]["['params']['r']"])) == 2


def test_verify_names_the_same_leaf_ranks_hashes_and_delta(runs):
    ref, got = runs
    [(path, ranks, hashes, delta)] = ref["report"]
    assert path == "['params']['r']" and ranks == (1,)
    for r in got:
        [(gpath, granks, ghashes, gdelta)] = r["report"]
        assert (gpath, granks, ghashes) == (path, ranks, hashes)
        assert gdelta == pytest.approx(delta, rel=1e-6)
        assert r["root"] == ref["root"] == 0      # 50/50 at dp 2: root 0


def test_resync_repairs_as_jax_does(runs):
    ref, got = runs
    assert ref["after_resync"] == []
    for r in got:
        assert r["after_resync"] == []
        n = 8 // TP
        np.testing.assert_array_equal(r["state"]["r"], ref["state"]["r"])
        np.testing.assert_array_equal(
            r["state"]["w"], ref["state"]["w"][:, r["tp"] * n:
                                               (r["tp"] + 1) * n])


def test_policy_object_repairs_then_refuses_without_resync(runs):
    _, got = runs
    for r in got:
        assert r["policy_resyncs"] == 1 and r["after_policy"] == []
        assert r["refused"] == ["['params']['r']"]
        assert r["events"] == [
            "replica_desync", "replica_verify_failed",      # verify, step 2
            "replica_desync", "replica_verify_failed",      # check, step 3
            "replica_resync",
            "replica_desync", "replica_verify_failed"]      # step 4


@pytest.mark.parametrize("hashes", [
    [(5, 5, 9, 5)], [(5, 9, 9, 9)], [(5, 9, 5, 9)],
    [(1, 1, 2, 1), (7, 7, 7, 3)], [(1, 2, 2, 2), (4, 4, 4, 6)]])
def test_majority_root_matches_jax(hashes):
    def report(pkg):
        return [pkg.DivergedLeaf(path=f"['l{i}']", ranks=(1,),
                                 max_abs_delta=0.0, hashes=h)
                for i, h in enumerate(hashes)]

    from apex_tpu_torch import resilience as rz

    assert rz.majority_root(report(rz), default=2) == jrz.majority_root(
        report(jrz), default=2)
