"""The ranks of ``tests/test_torch_consistency.py``'s gloo world and the
weights both packages load.  Importing this module imports no JAX: the
spawned ranks import it to find their function."""

import numpy as np
import torch

DP, TP = 2, 2


def _weights():
    rng = np.random.default_rng(5)
    return {"params": {"w": rng.standard_normal((8, 8)).astype(np.float32),
                       "b": rng.standard_normal(8).astype(np.float32),
                       "r": rng.standard_normal((3, 4)).astype(np.float32)}}


def _local(weights, t):
    """tp rank ``t``'s copy: ``w`` split on its columns, ``b`` on its
    rows, ``r`` whole."""
    p = weights["params"]
    n = 8 // TP
    return {"params": {
        "w": torch.from_numpy(np.ascontiguousarray(p["w"][:, t * n:(t + 1) * n])),
        "b": torch.from_numpy(p["b"][t * n:(t + 1) * n].copy()),
        "r": torch.from_numpy(p["r"].copy())}}


def _summary(report):
    return [(d.path, d.ranks, d.hashes, d.max_abs_delta) for d in report]


def _world(rank, world, weights, desync_kw):
    from apex_tpu_torch import resilience as rz
    from apex_tpu_torch._logging import add_event_sink
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.initialize_model_parallel(TP, 1)
    seen = []
    add_event_sink(seen.append)
    state = _local(weights, ps.get_tensor_model_parallel_rank())
    out = {"dp": ps.get_data_parallel_rank(),
           "tp": ps.get_tensor_model_parallel_rank()}
    out["clean"] = {k: v["hashes"].tolist()
                    for k, v in rz.replica_hashes(state).items()}
    rz.DesyncReplica((2,), **desync_kw)(state, 2)
    rec = rz.replica_hashes(state)
    out["hashes"] = {k: v["hashes"].tolist() for k, v in rec.items()}
    out["deltas"] = {k: v["max_abs_delta"].tolist() for k, v in rec.items()}
    report = rz.verify_replicas(state, step=2)
    out["report"] = _summary(report)
    out["root"] = rz.majority_root(report)
    rz.resync_replicas(state, root=out["root"])
    out["after_resync"] = _summary(rz.verify_replicas(state))
    out["state"] = {k: v.numpy().copy() for k, v in state["params"].items()}
    # the policy object: desync again, one check repairs it
    rz.DesyncReplica((3,), **desync_kw)(state, 3)
    checker = rz.ReplicaConsistency()
    checker.check(state, step=3)
    out["policy_resyncs"] = checker.resyncs
    out["after_policy"] = _summary(rz.verify_replicas(state))
    rz.DesyncReplica((4,), **desync_kw)(state, 4)
    try:
        rz.ReplicaConsistency(resync=False).check(state, step=4)
        out["refused"] = None
    except rz.ReplicaDesyncError as e:
        out["refused"] = [d.path for d in e.report]
    out["events"] = [e["event"] for e in seen
                     if e["event"].startswith("replica_")]
    return out
