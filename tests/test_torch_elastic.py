"""Sharded (v2) checkpoints: apex_tpu_torch.resilience.elastic against
apex_tpu.resilience.elastic.

Mirrors ``tests/test_elastic.py``'s sharded-checkpoint part: the shard
geometry, a round trip on one mesh, resharding (``dp 4 x tp 2 -> dp 2 x
tp 4 -> dp 8`` as axis sizes) bit for bit, the manifest v2 schema, the
tiling and overlap rejections, the mixed v1/v2 fallback walk, and
``CorruptShardFile`` localized to one shard.  Files both ways: a tree JAX
saved as v2 restores in the port, the port's single-process save (form
(a)) writes JAX's files byte for byte for the same tree, specs and mesh
shape, and the per-rank save of a gloo world (form (b)) writes form
(a)'s files.  Then ``load_serving_params(shardings=)`` from v1 and v2
onto a tp 2 engine (``tests/test_serving_tp.py:326-375``) and
``HotReloader(shardings=)``.

The port's mesh is its axis sizes; a spec is a ``PartitionSpec`` of the
port's own.  This module imports JAX only in its fixtures and tests, so
the spawned ranks stay JAX-free.
"""

import json
import os

import numpy as np
import pytest
import torch

from apex_tpu_torch import resilience as trz
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.models.convert import shard_state_dict
from apex_tpu_torch.models.llama import tp_param_spec
from apex_tpu_torch.resilience import elastic as tel
from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.testing.distributed import run_world

P = tel.PartitionSpec
M42, M24, M81 = {"dp": 4, "tp": 2}, {"dp": 2, "tp": 4}, {"dp": 8, "tp": 1}
STEP = "step_{:010d}"
SPECS = {"w": P(None, "tp"), "m": P("dp", "tp"), "b": P(), "step": None}
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)


def _tree():
    """tp-sharded fp32 matrix, dp x tp sharded bf16 matrix, replicated
    vector, int32 scalar (the JAX test's tree without its PRNG key)."""
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "m": torch.arange(32, dtype=torch.float32).reshape(8, 4).to(
                torch.bfloat16),
            "b": torch.ones(6),
            "step": torch.tensor(7, dtype=torch.int32)}


def _like():
    return {k: torch.zeros_like(v) for k, v in _tree().items()}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def _files(path):
    with open(os.path.join(path, "manifest.json"), "rb") as f:
        man = f.read()
    with open(os.path.join(path, "data.bin"), "rb") as f:
        return man, f.read()


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from apex_tpu import resilience as jrz
    from apex_tpu.resilience import elastic as jel

    class NS:
        pass

    ns = NS()
    ns.jax, ns.jnp, ns.rz, ns.el, ns.P = jax, jnp, jrz, jel, JP

    def mesh(dp, tp):
        return Mesh(np.array(jax.devices()[:8]).reshape(dp, tp), ("dp", "tp"))

    def tree(m):
        t = _tree()
        return {
            "w": jax.device_put(jnp.asarray(t["w"].numpy()),
                                NamedSharding(m, JP(None, "tp"))),
            "m": jax.device_put(
                jnp.arange(32, dtype=jnp.bfloat16).reshape(8, 4),
                NamedSharding(m, JP("dp", "tp"))),
            "b": jax.device_put(jnp.ones((6,), jnp.float32),
                                NamedSharding(m, JP())),
            "step": jnp.int32(7)}

    ns.mesh, ns.tree = mesh, tree
    return ns


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec,ndim", [
    (None, 2), (("tp",), 2), ((None, ("dp", "tp")), 2), (("dp", None), 3)])
def test_spec_entries_match_jax(jx, spec, ndim):
    jspec = None if spec is None else jx.P(*spec)
    assert tel._spec_entries(None if spec is None else P(*spec), ndim) == \
        jx.el._spec_entries(jspec, ndim)


@pytest.mark.parametrize("entries,shape,sizes", [
    ([("tp",), ()], (8, 3), {"dp": 4, "tp": 2}),
    ([("dp", "tp")], (8,), {"dp": 2, "tp": 2}),
    ([(), ()], (4, 4), {"dp": 8}),
    ([("dp",), ("tp",)], (8, 4), {"dp": 4, "tp": 2})])
def test_shard_grid_matches_jax(jx, entries, shape, sizes):
    assert list(tel._shard_grid(entries, shape, sizes, "x")) == list(
        jx.el._shard_grid(entries, shape, sizes, "x"))


@pytest.mark.parametrize("entries,shape,sizes,match", [
    ([("tp",)], (7,), {"tp": 2}, "not divisible"),
    ([("zz",)], (8,), {"tp": 2}, "not a mesh axis"),
    ([("tp",), ("tp",)], (8, 8), {"tp": 2}, "more than once")])
def test_bad_grids_raise(entries, shape, sizes, match):
    with pytest.raises(trz.CheckpointError, match=match):
        list(tel._shard_grid(entries, shape, sizes, "x"))


# --------------------------------------------------------------------------
# save / validate / restore / reshard
# --------------------------------------------------------------------------


def test_roundtrip_same_mesh_bit_identical(tmp_path):
    path = trz.save_sharded_checkpoint(str(tmp_path), 5, _tree(), mesh=M42,
                                       specs=SPECS)
    trz.validate_sharded_checkpoint(path)
    restored, step = trz.restore_sharded_checkpoint(str(tmp_path), _like())
    assert step == 5
    _equal(_tree(), restored)


def test_reshard_across_meshes_bit_identical(tmp_path):
    """dp 4 x tp 2 -> dp 2 x tp 4 -> dp 8: each save restores whole, and
    each rank's block of the next grid reads only its overlapping
    records."""
    tree = _tree()
    for i, (mesh, nxt) in enumerate(((M42, M24), (M24, M81), (M81, M42))):
        root = str(tmp_path / str(i))
        trz.save_sharded_checkpoint(root, i, tree, mesh=mesh, specs=SPECS)
        tree, _ = trz.restore_sharded_checkpoint(root, _like())
        _equal(_tree(), tree)
        for r in range(nxt["tp"]):
            sl = sv.ShardSlice(1, r, nxt["tp"])
            like = {"w": torch.zeros(8, 8 // nxt["tp"])}
            other = {k: v for k, v in _like().items() if k != "w"}
            got, _ = trz.restore_sharded_checkpoint(
                root, {**like, **other}, shardings={"['w']": sl})
            assert torch.equal(got["w"], sl.take(_tree()["w"]))


def test_block_restore_reads_only_its_records(tmp_path):
    w = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    trz.save_sharded_checkpoint(str(tmp_path), 0, {"w": w},
                                mesh={"tp": 4}, specs={"w": P("tp", None)})
    before = tel.shard_bytes_read()
    sl = sv.ShardSlice(0, 2, 4)
    got, _ = trz.restore_sharded_checkpoint(
        str(tmp_path), {"w": torch.zeros(16, 64)}, shardings={"['w']": sl})
    assert torch.equal(got["w"], w[32:48])
    assert tel.shard_bytes_read() - before == w.nbytes // 4


def test_manifest_v2_schema(tmp_path):
    path = trz.save_sharded_checkpoint(str(tmp_path), 0, _tree(), mesh=M42,
                                       specs=SPECS)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["format_version"] == 2 and man["sharded"] is True
    assert man["mesh"]["axes"] == {"dp": 4, "tp": 2}
    assert (man["mesh"]["dp"], man["mesh"]["tp"], man["mesh"]["world"]) == (
        4, 2, 8)
    by_path = {r["path"]: r for r in man["leaves"]}
    w = by_path["['w']"]
    assert w["shape"] == [8, 8] and w["spec"] == [None, ["tp"]]
    assert [s["coords"] for s in w["shards"]] == [{"tp": 0}, {"tp": 1}]
    assert len(by_path["['m']"]["shards"]) == 8
    assert by_path["['m']"]["dtype"] == "bfloat16"
    assert by_path["['b']"]["shards"][0]["coords"] == {}


def test_specs_as_a_tree_or_paths(tmp_path):
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    a = trz.save_sharded_checkpoint(str(tmp_path / "a"), 0, tree, mesh=M42,
                                    specs={"w": P(None, "tp")})
    b = trz.save_sharded_checkpoint(str(tmp_path / "b"), 0, tree, mesh=M42,
                                    specs={"['w']": P(None, "tp")})
    assert _files(a) == _files(b)
    with pytest.raises(ValueError, match="specs has"):
        trz.save_sharded_checkpoint(str(tmp_path / "c"), 0, tree, mesh=M42,
                                    specs={"v": P()})


def test_validate_dispatch_and_corrupt_shard_localized(tmp_path):
    path = trz.save_sharded_checkpoint(str(tmp_path), 3, _tree(), mesh=M42,
                                       specs=SPECS)
    trz.save_checkpoint(str(tmp_path / "v1"), 0, {"x": torch.ones(3)})
    with pytest.raises(trz.CheckpointError, match="not a sharded"):
        trz.validate_sharded_checkpoint(
            os.path.join(str(tmp_path / "v1"), STEP.format(0)))
    trz.validate_checkpoint(path)          # the v1 entry point, a v2 dir
    assert trz.latest_valid_step(str(tmp_path)) == 3
    dmg = trz.CorruptShardFile(leaf="w", shard=1, seed=0)(path)
    assert dmg["leaf"] == "['w']" and dmg["coords"] == {"tp": 1}
    with pytest.raises(trz.CheckpointError,
                       match=r"CRC mismatch on shard \{'tp': 1\} of leaf "
                             r"\"\['w'\]\""):
        trz.validate_checkpoint(path)
    assert trz.latest_valid_step(str(tmp_path)) is None
    # the other shard of the leaf is intact: its block restores
    got, _ = trz.restore_sharded_checkpoint(
        str(tmp_path), {**_like(), "w": torch.zeros(8, 4)}, step=3,
        shardings={"['w']": sv.ShardSlice(1, 0, 2)})
    assert torch.equal(got["w"], _tree()["w"][:, :4])


def test_v1_restore_walk_takes_v2_steps(tmp_path):
    """The port's ``restore_checkpoint`` restores a v2 step (JAX's refuses
    it and leaves it to its elastic module): a difference kept on
    purpose, so one walk covers a mixed root."""
    trz.save_sharded_checkpoint(str(tmp_path), 0, _tree(), mesh=M42,
                                specs=SPECS)
    got, step = trz.restore_checkpoint(str(tmp_path), _like())
    assert step == 0
    _equal(_tree(), got)


def test_template_mismatches_name_keystr(tmp_path):
    trz.save_sharded_checkpoint(str(tmp_path), 0, {"w": torch.ones(4, 4)},
                                mesh=M42, specs={"w": P(None, "tp")})
    for like, match in (({"w": torch.ones(4, 2)}, r"\['w'\]"),
                        ({"w": torch.ones(4, 4, dtype=torch.bfloat16)},
                         r"\['w'\]"),
                        ({"v": torch.ones(4, 4)}, r"no leaf \"\['v'\]\""),
                        ({"w": torch.ones(4, 4), "x": torch.ones(2)},
                         r"no leaf \"\['x'\]\"")):
        with pytest.raises(trz.CheckpointError, match=match):
            trz.restore_sharded_checkpoint(str(tmp_path), like, step=0)
    trz.save_sharded_checkpoint(str(tmp_path), 1, {"w": torch.ones(4, 4),
                                                   "legacy": torch.ones(2)},
                                mesh=M42)
    with pytest.raises(trz.CheckpointError,
                       match=r"template does not.*\['legacy'\]"):
        trz.restore_sharded_checkpoint(str(tmp_path),
                                       {"w": torch.ones(4, 4)}, step=1)


@pytest.mark.parametrize("walk", ["elastic", "checkpoint"])
def test_mixed_root_falls_back_across_formats(tmp_path, walk):
    host = {"w": torch.arange(16.0).reshape(4, 4)}
    trz.save_checkpoint(str(tmp_path), 0, host)
    trz.save_sharded_checkpoint(str(tmp_path), 1, host, mesh=M42,
                                specs={"w": P(None, "tp")})
    dmg = trz.CorruptShardFile(seed=2)(
        os.path.join(str(tmp_path), STEP.format(1)))
    assert dmg["leaf"] == "['w']"
    events = []
    from apex_tpu_torch import _logging

    sink = events.append
    _logging.add_event_sink(sink)
    try:
        fn = (trz.restore_sharded_checkpoint if walk == "elastic"
              else trz.restore_checkpoint)
        got, step = fn(str(tmp_path), {"w": torch.zeros(4, 4)})
    finally:
        _logging.remove_event_sink(sink)
    assert step == 0
    assert torch.equal(got["w"], host["w"])
    assert [e["step"] for e in events
            if e["event"] == "checkpoint_rejected"] == [1]
    assert trz.latest_valid_step(str(tmp_path)) == 0


def test_rotation_and_manager_surface(tmp_path):
    mgr = trz.ShardedCheckpointManager(str(tmp_path), keep=2, mesh=M42)
    tree = {"w": torch.ones(4, 4)}
    for s in range(4):
        mgr.save(s, tree, specs={"w": P(None, "tp")})
    snap = mgr.snapshot(tree, specs={"w": P(None, "tp")})
    mgr.write_snapshot(4, snap)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_valid_step() == 4
    restored, step = mgr.restore(like={"w": torch.zeros(4, 4)})
    assert step == 4 and torch.equal(restored["w"], tree["w"])


def test_overlap_gap_and_damaged_shape_rejected(tmp_path):
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    path = trz.save_sharded_checkpoint(str(tmp_path), 0, tree, mesh=M42,
                                       specs={"w": P(None, "tp")})
    mp = os.path.join(path, "manifest.json")
    with open(mp) as f:
        man = json.load(f)
    like = {"w": torch.zeros(4, 4)}
    shards = man["leaves"][0]["shards"]
    shards[1]["index"] = shards[0]["index"]
    with open(mp, "w") as f:
        json.dump(man, f)
    with pytest.raises(trz.CheckpointError, match="duplicate shard"):
        trz.validate_sharded_checkpoint(path)
    with pytest.raises(trz.CheckpointError, match="duplicate shard"):
        trz.restore_sharded_checkpoint(str(tmp_path), like, step=0)
    shards[1]["index"] = [[0, 4], [1, 3]]
    with open(mp, "w") as f:
        json.dump(man, f)
    with pytest.raises(trz.CheckpointError, match="do not tile"):
        trz.restore_sharded_checkpoint(str(tmp_path), like, step=0)
    man["leaves"][0]["shape"] = 16
    with open(mp, "w") as f:
        json.dump(man, f)
    with pytest.raises(trz.CheckpointError, match="unusable shape"):
        trz.validate_sharded_checkpoint(path)
    assert trz.latest_valid_step(str(tmp_path)) is None


def test_bad_specs_refused_at_save(tmp_path):
    with pytest.raises(trz.CheckpointError, match="more than once"):
        trz.save_sharded_checkpoint(str(tmp_path), 0, {"w": torch.ones(8, 8)},
                                    mesh=M42, specs={"w": P("tp", "tp")})
    with pytest.raises(trz.CheckpointError, match="not divisible"):
        trz.save_sharded_checkpoint(str(tmp_path), 0, {"w": torch.ones(7, 4)},
                                    mesh=M42, specs={"w": P("dp", None)})
    assert not any(n.startswith("step_") for n in os.listdir(tmp_path))


# --------------------------------------------------------------------------
# files both ways
# --------------------------------------------------------------------------


def test_jax_v2_restores_in_the_port(tmp_path, jx):
    jx.rz.save_sharded_checkpoint(str(tmp_path), 4, jx.tree(jx.mesh(4, 2)),
                                  mesh=jx.mesh(4, 2))
    got, step = trz.restore_sharded_checkpoint(str(tmp_path), _like())
    assert step == 4
    _equal(_tree(), got)
    # and a block of it, for a tp 4 rank
    got, _ = trz.restore_checkpoint(
        str(tmp_path), {**_like(), "w": torch.zeros(8, 2)},
        shardings={"['w']": sv.ShardSlice(1, 3, 4)})
    assert torch.equal(got["w"], _tree()["w"][:, 6:])


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)])
def test_port_v2_files_equal_jax_and_restore_there(tmp_path, jx, shape):
    jmesh = jx.mesh(*shape)
    a = jx.rz.save_sharded_checkpoint(str(tmp_path / "jax"), 2,
                                      jx.tree(jmesh), mesh=jmesh)
    b = trz.save_sharded_checkpoint(str(tmp_path / "port"), 2, _tree(),
                                    mesh=dict(zip(("dp", "tp"), shape)),
                                    specs=SPECS)
    assert _files(a) == _files(b)
    got, _ = jx.rz.restore_sharded_checkpoint(str(tmp_path / "port"),
                                              jx.tree(jx.mesh(8, 1)))
    for k, v in _tree().items():
        want = v.view(torch.int16).numpy() if k == "m" else v.numpy()
        have = np.asarray(got[k])
        have = have.view(np.int16) if k == "m" else have
        np.testing.assert_array_equal(have, want)


def _local_save_world(rank, world, root, step):
    tps.initialize_model_parallel(2)
    tp, dp = tps.get_tensor_model_parallel_rank(), tps.get_data_parallel_rank()
    t = _tree()
    local = {"w": t["w"][:, tp * 4:(tp + 1) * 4],
             "m": t["m"][dp * 4:(dp + 1) * 4, tp * 2:(tp + 1) * 2],
             "b": t["b"], "step": t["step"]}
    path = trz.save_sharded_checkpoint(root, step, local, specs=SPECS,
                                       local=True)
    return path, tps.mesh_axis_sizes()


def test_per_rank_save_equals_single_process_save(tmp_path):
    out = run_world(_local_save_world, 4, args=(str(tmp_path / "b"), 6),
                    timeout=120)
    paths = {p for p, _ in out}
    assert len(paths) == 1 and out[0][1] == {"dp": 2, "pp": 1, "tp": 2}
    a = trz.save_sharded_checkpoint(str(tmp_path / "a"), 6, _tree(),
                                    mesh={"dp": 2, "pp": 1, "tp": 2},
                                    specs=SPECS)
    assert _files(a) == _files(paths.pop())


# --------------------------------------------------------------------------
# serving weights onto a tp 2 engine
# --------------------------------------------------------------------------


def _tp_load_world(rank, world, roots, tree):
    config = LlamaConfig(**CFG)
    group = tps.serving_group(world)
    with ttp.tensor_parallel_region(group):
        shard = LlamaForCausalLM(config, device="cpu")
    whole = llama_params_from_jax(tree, config)
    want = shard_state_dict(whole, rank, world)
    like = {"params": shard.state_dict(), "step": torch.tensor(0)}
    sh = sv.tp_param_shardings(like["params"], rank, world)
    out = {}
    for name, root in roots.items():
        got, step = sv.load_serving_params(root, like, params_key="params",
                                           shardings=sh)
        assert all(torch.equal(got[k], want[k]) for k in want), name
        shard.load_state_dict(got)
        eng = sv.DecodeEngine(shard, slots=1, max_len=64, prefill_len=16,
                              device="cpu", tp=sv.TPConfig(size=world))
        logits = eng.prefill(0, list(range(1, 13)))
        stream = [int(torch.argmax(logits))]
        for _ in range(4):
            stream.append(int(torch.argmax(eng.decode([stream[-1]],
                                                       [True])[0])))
        out[name] = (step, stream)
    # a hot reload of a rank's slice: boot on zeros, reload the step
    with torch.no_grad():
        for p in shard.parameters():
            p.zero_()
    eng = sv.DecodeEngine(shard, slots=1, max_len=64, prefill_len=16,
                          device="cpu", tp=sv.TPConfig(size=world))
    sched = sv.ContinuousBatchingScheduler(eng, log_interval=10 ** 9)
    rel = sv.HotReloader(sched, roots["v2"], like=like, params_key="params",
                         shardings=sh)
    outcome = rel.reload()
    assert outcome.ok, outcome
    assert all(torch.equal(eng.params[k], want[k]) for k in want)
    return out


def test_load_serving_params_shardings_onto_tp2_engine(tmp_path, jx):
    from apex_tpu.models import LlamaConfig as JCfg
    from apex_tpu.models import LlamaForCausalLM as JLlama
    from apex_tpu.serving.engine import TPConfig as JTP

    jmodel = JLlama(JCfg(**CFG))
    params = jmodel.init(jx.jax.random.PRNGKey(0),
                         jx.jnp.zeros((1, 4), jx.jnp.int32))
    tree = jx.jax.tree.map(np.asarray, params)
    whole = llama_params_from_jax(tree, LlamaConfig(**CFG))
    state = {"params": whole, "step": torch.tensor(0)}
    trz.save_checkpoint(str(tmp_path / "v1"), 7, state)
    # v2 on a tp 4 grid: each tp 2 rank reads two records a weight
    specs = {"params": {k: P(*tp_param_spec(k)) for k in whole},
             "step": None}
    trz.save_sharded_checkpoint(str(tmp_path / "v2"), 3, state,
                                mesh={"tp": 4}, specs=specs)
    roots = {"v1": str(tmp_path / "v1"), "v2": str(tmp_path / "v2")}
    out = run_world(_tp_load_world, 2, args=(roots, tree), timeout=120)
    from apex_tpu import serving as jsv

    eng = jsv.DecodeEngine(jmodel, params, slots=1, max_len=64,
                           prefill_len=16, tp=JTP(size=2))
    logits = eng.prefill(0, list(range(1, 13)))
    stream = [int(np.argmax(np.asarray(logits)))]
    toks = np.zeros((1,), np.int32)
    for _ in range(4):
        toks[0] = stream[-1]
        stream.append(int(np.argmax(np.asarray(
            eng.decode(toks, np.ones(1, bool))[0]))))
    for r in out:
        assert r == {"v1": (7, stream), "v2": (3, stream)}
