"""The port's checkpoint layer against the JAX package's.

``apex_tpu_torch.utils.serialization``'s leaf helpers,
``resilience.checkpoint`` (v1), ``retry``, ``async_checkpoint``, the
heartbeat file of ``supervisor`` and the writer-crash fault, held to
``apex_tpu.resilience`` on the same inputs:

- **One format.** The same numpy tree (fp32, bf16, int32 and a 0-d step)
  saved by each package gives equal manifest records and equal
  ``data.bin`` bytes, and each package restores the other's bit for bit;
  a torch ``state_dict`` of bf16 tensors writes the bytes JAX writes for
  the same values.  Leaf paths are JAX's ``keystr`` paths.
- **Corruption.** Truncated and byte-flipped ``data.bin``\\ s are
  rejected and the walk falls back to the previous step, as JAX's does,
  with the same ``checkpoint_rejected`` events.
- **Disk handling.** Rotation keeps K; the live-writer registry hides a
  step in flight.  A v2 (sharded) step raises ``NotImplementedError``.
- **bf16 without ml_dtypes**, in a subprocess that cannot import it.
- **Async writer.** The snapshot survives an in-place optimizer step
  between ``save`` and ``wait``; the veto path; the metrics.
- **Retry.** Delays and events equal JAX's.
- **Writer crash** leaves a partial temp dir no walk selects.
- **Heartbeat.** Each package reads the other's file.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
from collections import OrderedDict
from typing import NamedTuple

import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import _logging as jlog
from apex_tpu import resilience as jrz
from apex_tpu.resilience import checkpoint as jck
from apex_tpu.resilience import fault_injection as jfi
from apex_tpu.utils import serialization as jser
from apex_tpu_torch import _logging as tlog
from apex_tpu_torch import resilience as trz
from apex_tpu_torch.obs import metrics as tmetrics
from apex_tpu_torch.resilience import checkpoint as tck
from apex_tpu_torch.resilience import fault_injection as tfi
from apex_tpu_torch.utils import serialization as tser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = "step_{:010d}"


def _numpy_tree(seed=0):
    """fp32, bf16 (ml_dtypes), int32 and a 0-d int64 step."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(ml_dtypes.bfloat16)},
            "ids": np.arange(6, dtype=np.int32),
            "step": np.int64(7)}


def _torch_like(tree):
    """The torch template of :func:`_numpy_tree`'s layout."""
    return {"params": {"w": torch.zeros(3, 4),
                       "b": torch.zeros(5, dtype=torch.bfloat16)},
            "ids": torch.zeros(6, dtype=torch.int32), "step": np.int64(0)}


def _files(root, step):
    d = os.path.join(root, STEP.format(step))
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "data.bin"), "rb") as f:
        return manifest, f.read()


def _bits(x):
    """A leaf's raw bytes, whichever package made it."""
    if isinstance(x, torch.Tensor):
        return tser.leaf_to_numpy(x).tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _leaves_equal(a, b):
    """Leaf for leaf the same bytes.  A JAX restore (``a``) holds a 0-d
    int64 leaf as int32 (x64 is off), so JAX arrays are read back in the
    reference leaf's dtype first."""
    pa = tser.tree_flatten_with_path(a)
    pb = tser.tree_flatten_with_path(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        if type(x).__module__.startswith("jax"):
            x = np.asarray(x).astype(np.asarray(y).dtype)
        assert _bits(x) == _bits(y), p


class _Tap:
    """Capture one package's events."""

    def __init__(self, logging_mod):
        self.mod, self.events = logging_mod, []

    def __enter__(self):
        self.mod.add_event_sink(self.events.append)
        return self

    def __exit__(self, *exc):
        self.mod.remove_event_sink(self.events.append)

    def of(self, kind):
        return [e for e in self.events if e.get("event") == kind]


# ---------------------------------------------------------------------------
# the leaf layer
# ---------------------------------------------------------------------------


class _NT(NamedTuple):
    a: object
    b: object


def test_tree_paths_and_order_are_jax_keystr():
    tree = {"z": 1, "a": [np.zeros(2), (3, None)],
            "o": OrderedDict([("y", 1), ("b", 2)]), "n": _NT(5, 6),
            "sd": OrderedDict([("layers.0.w", np.ones(2)),
                               ("embed.weight", np.ones(3))])}
    assert tser.tree_paths(tree) == jser.tree_paths(tree)
    host = tser.tree_to_host_dict(tree)
    assert list(host) == list(jser.tree_to_host_dict(tree))
    back = tser.tree_from_host_dict(host, tree)
    assert isinstance(back["o"], OrderedDict) and list(back["o"]) == ["y", "b"]
    assert isinstance(back["n"], _NT) and back["a"][1][1] is None
    with pytest.raises(KeyError):
        tser.tree_from_host_dict({}, tree)
    with pytest.raises(ValueError):
        tser.tree_from_host_dict({**host, "['a'][0]": np.zeros(3)}, tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.int64,
                                   torch.bool])
def test_leaf_crc_spec_and_roundtrip_match_jax(dtype):
    g = torch.Generator().manual_seed(1)
    t = (torch.randn(4, 3, generator=g) * 10).to(dtype)
    ref = t.float().numpy()
    if dtype == torch.bfloat16:
        ref = ref.astype(ml_dtypes.bfloat16)
    else:
        ref = t.numpy()
    assert tser.leaf_crc32(t) == jser.leaf_crc32(ref)
    shape, name = tser.leaf_spec(t)
    jshape, jdtype = jser.leaf_spec(ref)
    assert (shape, name) == (jshape, jdtype.name)
    back = tser.leaf_from_numpy(tser.leaf_to_numpy(t), t)
    assert back.dtype == dtype and torch.equal(back, t)
    # a host dict holding the ml_dtypes array restores into the tensor too
    assert torch.equal(tser.tree_from_host_dict({"": ref}, t), t)


# ---------------------------------------------------------------------------
# one format for both packages
# ---------------------------------------------------------------------------


def test_same_tree_same_files_both_packages(tmp_path):
    tree = _numpy_tree()
    jck.save_checkpoint(str(tmp_path / "j"), 10, tree)
    tck.save_checkpoint(str(tmp_path / "t"), 10, tree)
    jm, jd = _files(str(tmp_path / "j"), 10)
    tm, td = _files(str(tmp_path / "t"), 10)
    assert jd == td
    assert jm["leaves"] == tm["leaves"]
    assert {k: v for k, v in jm.items() if k != "leaves"} == \
        {k: v for k, v in tm.items() if k != "leaves"}
    assert [r["path"] for r in tm["leaves"]] == jser.tree_paths(tree)


def test_torch_state_dict_writes_jax_bytes(tmp_path):
    """A bf16 / fp32 torch tree writes what JAX writes for the same
    values: its bits through the 16-bit integer view."""
    tree = _numpy_tree()
    ttree = {"params": {"w": torch.from_numpy(tree["params"]["w"].copy()),
                        "b": torch.from_numpy(np.asarray(
                            tree["params"]["b"], np.float32)).bfloat16()},
             "ids": torch.from_numpy(tree["ids"].copy()),
             "step": np.int64(7)}
    jck.save_checkpoint(str(tmp_path / "j"), 3, tree)
    tck.save_checkpoint(str(tmp_path / "t"), 3, ttree)
    jm, jd = _files(str(tmp_path / "j"), 3)
    tm, td = _files(str(tmp_path / "t"), 3)
    assert jd == td and jm["leaves"] == tm["leaves"]
    got, step = tck.restore_checkpoint(str(tmp_path / "j"), _torch_like(tree))
    assert step == 3
    _leaves_equal(got, ttree)
    assert got["params"]["b"].dtype == torch.bfloat16
    assert type(got["step"]) is np.int64 and got["step"] == 7


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_restores_the_others(tmp_path, writer):
    tree = _numpy_tree(seed=2)
    (jck if writer == "jax" else tck).save_checkpoint(str(tmp_path), 5, tree)
    # the JAX restore, the port's into numpy, the port's into torch
    j, js = jck.restore_checkpoint(str(tmp_path), _numpy_tree(seed=9))
    t, ts = tck.restore_checkpoint(str(tmp_path), _numpy_tree(seed=9))
    tt, _ = tck.restore_checkpoint(str(tmp_path), _torch_like(tree))
    assert js == ts == 5
    _leaves_equal(j, tree)
    _leaves_equal(t, tree)
    _leaves_equal(tt, tree)
    assert t["params"]["b"].dtype == ml_dtypes.bfloat16


def test_restore_is_strict_both_ways(tmp_path):
    tree = _numpy_tree()
    tck.save_checkpoint(str(tmp_path), 1, tree)
    extra = {**_torch_like(tree), "more": torch.zeros(2)}
    with pytest.raises(trz.CheckpointError, match="no leaf"):
        tck.restore_checkpoint(str(tmp_path), extra, step=1)
    fewer = _torch_like(tree)
    del fewer["ids"]
    with pytest.raises(trz.CheckpointError, match="does not"):
        tck.restore_checkpoint(str(tmp_path), fewer, step=1)
    wrong = _torch_like(tree)
    wrong["params"]["w"] = torch.zeros(3, 4, dtype=torch.float16)
    with pytest.raises(trz.CheckpointError, match="template wants"):
        tck.restore_checkpoint(str(tmp_path), wrong, step=1)


def test_prng_key_record_is_a_clear_error(tmp_path):
    import jax

    jck.save_checkpoint(str(tmp_path), 1, {"rng": jax.random.key(0)})
    with pytest.raises(trz.CheckpointError, match="PRNG key"):
        tck.restore_checkpoint(str(tmp_path),
                               {"rng": torch.zeros(2, dtype=torch.int32)})


def test_restored_cuda_less_leaves_follow_the_template_device(tmp_path):
    """Each leaf lands where its template leaf is (here the CPU) and owns
    its memory: a later in-place update of the restored tensor does not
    reach the file or another restore."""
    tree = _numpy_tree()
    tck.save_checkpoint(str(tmp_path), 2, tree)
    a, _ = tck.restore_checkpoint(str(tmp_path), _torch_like(tree))
    b, _ = tck.restore_checkpoint(str(tmp_path), _torch_like(tree))
    assert a["params"]["w"].device.type == "cpu"
    a["params"]["w"].add_(1.0)
    assert not torch.equal(a["params"]["w"], b["params"]["w"])


# ---------------------------------------------------------------------------
# corruption and the newest-valid walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_newest_falls_back_like_jax(tmp_path, damage):
    tree = _numpy_tree()
    roots = {}
    for name, pkg in (("jax", jck), ("port", tck)):
        root = str(tmp_path / name)
        for s in (1, 2):
            pkg.save_checkpoint(root, s, _numpy_tree(seed=s))
        d = os.path.join(root, STEP.format(2))
        if damage == "flip":
            if name == "jax":
                jfi.FaultInjector(jfi.FaultPlan(seed=0)).corrupt_checkpoint(d)
            else:
                tfi.corrupt_checkpoint(d, seed=0)
        else:
            with open(os.path.join(d, "data.bin"), "r+b") as f:
                f.truncate(os.path.getsize(os.path.join(d, "data.bin")) - 1)
        roots[name] = root
    assert _files(roots["jax"], 2)[1] == _files(roots["port"], 2)[1]
    with _Tap(jlog) as jt:
        j, js = jck.restore_checkpoint(roots["jax"], tree)
    with _Tap(tlog) as tt:
        t, ts = tck.restore_checkpoint(roots["port"], _torch_like(tree))
    assert js == ts == 1
    _leaves_equal(t, _numpy_tree(seed=1))
    _leaves_equal(j, _numpy_tree(seed=1))
    for tap in (jt, tt):
        (rej,) = tap.of("checkpoint_rejected")
        assert rej["step"] == 2
        (res,) = tap.of("checkpoint_restored")
        assert res["step"] == 1 and res["fallback"] is True
    assert [(e["event"], e["step"]) for e in jt.events
            if e["event"].startswith("checkpoint_")] == \
        [(e["event"], e["step"]) for e in tt.events
         if e["event"].startswith("checkpoint_")]
    assert tck.latest_valid_step(roots["jax"]) == \
        jck.latest_valid_step(roots["port"]) == 1
    with pytest.raises(trz.CheckpointError):
        tck.validate_checkpoint(os.path.join(roots["port"], STEP.format(2)))
    with pytest.raises(trz.CheckpointError):
        tck.restore_checkpoint(roots["port"], _torch_like(tree), step=2)


def test_nothing_valid_raises(tmp_path):
    with pytest.raises(trz.CheckpointError, match="empty"):
        tck.restore_checkpoint(str(tmp_path), _torch_like(_numpy_tree()))


# ---------------------------------------------------------------------------
# disk handling
# ---------------------------------------------------------------------------


def test_rotation_keeps_k_and_the_manager_surface(tmp_path):
    mgr = trz.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _numpy_tree(seed=s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_valid_step() == 4
    got, step = mgr.restore(_torch_like(_numpy_tree()))
    assert step == 4
    _leaves_equal(got, _numpy_tree(seed=4))
    assert mgr.checkpoint_path(4).endswith(STEP.format(4))
    # re-saving a committed step swaps it aside and lands the new one
    mgr.save(4, _numpy_tree(seed=40))
    _leaves_equal(mgr.restore(_torch_like(_numpy_tree()))[0],
                  _numpy_tree(seed=40))


def test_live_writer_registry_hides_a_step_in_flight(tmp_path):
    root = str(tmp_path)
    for s in (1, 4):
        tck.save_checkpoint(root, s, _numpy_tree(seed=s))
    with tck._live_writer(root, 4):
        assert tck.in_flight_steps(root) == {4}
        assert tck.latest_valid_step(root) == 1
        tck.save_checkpoint(root, 5, _numpy_tree(seed=5), keep=1)
        assert set(tck._list_steps(root)) == {4, 5}   # 4 is protected
    assert tck.in_flight_steps(root) == set()


def test_v2_sharded_step_raises_not_implemented(tmp_path):
    """A v2 (sharded) step written by the JAX package validates and
    restores through the same four calls that once refused it, and the
    v1 step beside it still restores."""
    from apex_tpu.resilience.elastic import save_sharded_checkpoint

    root = str(tmp_path)
    tck.save_checkpoint(root, 1, {"w": np.ones((4, 4), np.float32)})
    w2 = np.arange(16, dtype=np.float32).reshape(4, 4)
    save_sharded_checkpoint(root, 2, {"w": w2})
    like = {"w": torch.zeros(4, 4)}
    d2 = os.path.join(root, STEP.format(2))
    tck.validate_checkpoint(d2)
    for got, step in (tck.restore_checkpoint(root, like),
                      tck.restore_checkpoint(root, like, step=2)):
        assert step == 2 and torch.equal(got["w"], torch.from_numpy(w2))
    assert tck.latest_valid_step(root) == 2
    assert tck.restore_checkpoint(root, like, step=1)[1] == 1


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` (and JAX) cannot be imported, a
    bf16 tensor saves under dtype ``bfloat16`` and restores bit for bit,
    with the CRC over the raw little-endian bytes."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None
        sys.modules["jax"] = None
        import json, zlib, torch
        from apex_tpu_torch.resilience import checkpoint as ck
        g = torch.Generator().manual_seed(0)
        tree = {{"w": torch.randn(7, 5, generator=g).bfloat16(),
                 "s": torch.tensor(3)}}
        ck.save_checkpoint({str(tmp_path)!r}, 1, tree)
        got, _ = ck.restore_checkpoint(
            {str(tmp_path)!r}, {{"w": torch.zeros(7, 5, dtype=torch.bfloat16),
                                "s": torch.tensor(0)}})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16),
                           tree["w"].view(torch.int16))
        m = json.load(open({str(tmp_path)!r} + "/step_0000000001/manifest.json"))
        rec = m["leaves"][1]
        assert rec["path"] == "['w']" and rec["dtype"] == "bfloat16"
        raw = tree["w"].view(torch.int16).numpy().tobytes()
        assert rec["crc32"] == zlib.crc32(raw) & 0xFFFFFFFF
        assert "ml_dtypes" not in [m for m in sys.modules
                                   if sys.modules[m] is not None]
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    # and the JAX package reads what that process wrote
    got, _ = jck.restore_checkpoint(
        str(tmp_path), {"w": np.zeros((7, 5), ml_dtypes.bfloat16),
                        "s": np.int64(0)})
    g = torch.Generator().manual_seed(0)
    want = torch.randn(7, 5, generator=g).bfloat16()
    assert np.asarray(got["w"]).view(np.int16).tobytes() == \
        want.view(torch.int16).numpy().tobytes()


# ---------------------------------------------------------------------------
# the async writer
# ---------------------------------------------------------------------------


def test_snapshot_survives_an_in_place_optimizer_step(tmp_path):
    """The training loop updates parameters in place right after
    ``save()`` returns; the background writer still commits the
    pre-step bytes."""
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    gate = threading.Event()
    ac = trz.AsyncCheckpointer(trz.CheckpointManager(str(tmp_path)),
                               progress_hook=lambda p: gate.wait(10.0))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fut = ac.save(1, {"params": model.state_dict()})
    assert fut.snapshot_s is not None and not fut.done()
    model(torch.randn(2, 8)).sum().backward()
    opt.step()                                   # in place, mid-write
    assert not torch.equal(model.weight, before["weight"])
    gate.set()
    done = ac.wait()
    assert done is fut and fut.error is None
    assert ac.last_committed == (1, fut.path) and ac.committed_step == 1
    like = {"params": {k: torch.zeros_like(v)
                       for k, v in model.state_dict().items()}}
    got, _ = tck.restore_checkpoint(str(tmp_path), like)
    for k, v in before.items():
        assert torch.equal(got["params"][k], v), k


def test_async_bytes_equal_sync_bytes(tmp_path):
    tree = _numpy_tree()
    tck.save_checkpoint(str(tmp_path / "sync"), 3, tree)
    ac = trz.AsyncCheckpointer(trz.CheckpointManager(str(tmp_path / "bg")))
    ac.save(3, tree).result()
    assert _files(str(tmp_path / "sync"), 3)[1] == \
        _files(str(tmp_path / "bg"), 3)[1]


def test_veto_aborts_commit_and_metrics(tmp_path):
    tmetrics.reset()
    tree = {"w": torch.arange(4.0)}
    gate = threading.Event()
    ac = trz.AsyncCheckpointer(trz.CheckpointManager(str(tmp_path)),
                               progress_hook=lambda p: gate.wait(10.0))
    with _Tap(tlog) as tap:
        fut = ac.save(3, tree)
        assert tmetrics.REGISTRY.get("apex_checkpoint_inflight").value() == 1
        assert ac.veto("consistency failed") is True
        gate.set()
        fut.join()
    assert isinstance(fut.error, trz.SaveVetoed) and fut.path is None
    assert tck.latest_valid_step(str(tmp_path)) is None
    assert not [n for n in os.listdir(str(tmp_path)) if n.startswith("tmp_")]
    (v,) = tap.of("checkpoint_commit_vetoed")
    assert v["step"] == 3
    ac.save(4, tree).result()                   # a veto is not a failure
    assert tck.latest_valid_step(str(tmp_path)) == 4
    assert ac.veto("nothing in flight") is False
    # backpressure: a save while the previous write runs joins it first
    gate.clear()
    slow = trz.AsyncCheckpointer(trz.CheckpointManager(str(tmp_path)),
                                 progress_hook=lambda p: gate.wait(0.2))
    slow.save(5, tree)
    slow.save(6, tree)
    slow.wait()
    reg = tmetrics.REGISTRY
    assert reg.get("apex_checkpoint_backpressure_total").value() == 1
    assert reg.get("apex_checkpoint_inflight").value() == 0
    secs = reg.get("apex_checkpoint_duration_seconds")
    assert secs.count(op="snapshot") == 4 and secs.count(op="write") == 3


def test_unharvested_failure_surfaces_on_next_save(tmp_path):
    crash = tfi.CrashCheckpointWriter(after_records=1)
    ac = trz.AsyncCheckpointer(trz.CheckpointManager(str(tmp_path)),
                               progress_hook=crash)
    ac.save(1, {"w": torch.ones(2)}).join()
    with pytest.raises(trz.SimulatedWriterCrash):
        ac.save(2, {"w": torch.ones(2)})


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_delays_equal_jax(seed):
    kw = dict(max_attempts=6, base_delay_s=0.01, max_delay_s=0.5,
              backoff=3.0, jitter=0.5, seed=seed)
    t, j = trz.RetryPolicy(**kw), jrz.RetryPolicy(**kw)
    for what in ("checkpoint_save", "serving_reload", "x"):
        for attempt in range(1, 7):
            assert t.delay_s(what, attempt) == j.delay_s(what, attempt)


def _flaky(n_fail, err):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= n_fail:
            raise err
        return len(calls)
    return fn


@pytest.mark.parametrize("n_fail", [0, 2, 5])
def test_retry_transient_events_equal_jax(n_fail):
    policy = dict(max_attempts=4, seed=3)
    outs = []
    for rz, log in ((jrz, jlog), (trz, tlog)):
        slept = []
        with _Tap(log) as tap:
            try:
                got = rz.retry_transient(
                    _flaky(n_fail, OSError("UNAVAILABLE: blip")),
                    policy=rz.RetryPolicy(**policy), what="io",
                    sleep=slept.append)
            except rz.RetryExhausted as e:
                got = ("exhausted", e.attempts)
        outs.append((got, slept, [
            {k: v for k, v in e.items() if k not in ("time", "duration_s")}
            for e in tap.events]))
    assert outs[0] == outs[1]
    # deterministic errors propagate at once, on both
    for rz in (jrz, trz):
        with pytest.raises(rz.CheckpointError):
            rz.retry_transient(_flaky(1, rz.CheckpointError("bad")),
                               policy=rz.RetryPolicy(), sleep=lambda s: None)
        assert rz.is_transient(rz.TransientError("x"), rz.RetryPolicy())
        assert not rz.is_transient(rz.RetryExhausted("w", 2, OSError()),
                                   rz.RetryPolicy())


def test_manager_retry_wraps_transient_io(tmp_path, monkeypatch):
    mgr = trz.CheckpointManager(str(tmp_path),
                                retry=trz.RetryPolicy(base_delay_s=0.0))
    real = tck._write_checkpoint
    fails = [1]

    def flaky(*a, **k):
        if fails:
            fails.pop()
            raise OSError("disk blip")
        return real(*a, **k)

    monkeypatch.setattr(tck, "_write_checkpoint", flaky)
    monkeypatch.setattr(tck, "save_checkpoint",
                        lambda root, step, tree, keep=3: flaky(
                            root, step, tck._leaf_snapshots(tree, copy=False),
                            keep=keep, mesh_meta=None))
    with _Tap(tlog) as tap:
        mgr.save(1, {"w": torch.ones(3)})
    assert [e["event"] for e in tap.events
            if e["event"].startswith("retry_")] == ["retry_attempt",
                                                    "retry_recovered"]
    assert mgr.latest_valid_step() == 1


# ---------------------------------------------------------------------------
# the writer crash and the heartbeat file
# ---------------------------------------------------------------------------


def test_writer_crash_leaves_partial_temp_no_walk_selects(tmp_path):
    root = str(tmp_path)
    tck.save_checkpoint(root, 2, _numpy_tree(seed=2))
    crash = tfi.CrashCheckpointWriter(after_records=2)
    ac = trz.AsyncCheckpointer(trz.CheckpointManager(root),
                               progress_hook=crash)
    with _Tap(tlog) as tap:
        fut = ac.save(6, _numpy_tree(seed=6))
        fut.join()
    assert isinstance(fut.error, trz.SimulatedWriterCrash)
    assert crash.fired and fut.error.record == 1
    (ev,) = tap.of("fault_injected")
    assert ev["fault"] == "writer_crash" and ev["step"] == 6
    partial = [n for n in os.listdir(root) if n.startswith("tmp_")]
    assert len(partial) == 1                     # a hard kill's litter
    assert tck.latest_valid_step(root) == jck.latest_valid_step(root) == 2
    assert tck.restore_checkpoint(root, _torch_like(_numpy_tree()))[1] == 2
    ac2 = trz.AsyncCheckpointer(trz.CheckpointManager(root))
    ac2.save(6, _numpy_tree(seed=6)).result()   # the next save sweeps it
    assert not [n for n in os.listdir(root) if n.startswith("tmp_")]
    assert tck.latest_valid_step(root) == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_heartbeat_files_cross(tmp_path, writer):
    from apex_tpu.resilience import supervisor as jsup
    from apex_tpu_torch.resilience import supervisor as tsup

    path = str(tmp_path / "hb.json")
    w, r = (jsup, tsup) if writer == "jax" else (tsup, jsup)
    payload = w.write_heartbeat(path, 12, ckpt_path="/c/step_0000000012",
                                stalled=True)
    got = r.read_heartbeat(path)
    assert got == payload
    assert set(got) == {"step", "time", "monotonic", "pid", "ckpt_path",
                        "stalled"}
