"""Sequence parallelism under the pipeline, and the overflow step: the
port's pp 2 x tp 2 ranks in a gloo world of 4 against JAX's ``shard_map``
runs on virtual CPU devices.

- The first step's raw per-rank gradients against JAX's pp 2 x tp 2 ones
  on the same weights (the pp 2 x tp 1 init, each rank's tp slice): the
  RMSNorm scales, tagged ``sequence_parallel``, hold per-rank partial
  sums in both packages (``ROADMAP.md`` Queue C item 1).
- After ``allreduce_sequence_parallel_grads`` every rank holds the pp 2
  x tp 1 run's gradient (no partial one there), and three steps of the
  3-d step (which makes that call) follow the pp 2 x tp 1 trajectory:
  losses within 1e-5, every parameter within 1e-4 of its largest
  magnitude, sliced by ``shard_state_dict``; the norm scales end bit for
  bit equal on the two tp ranks of a stage.  The JAX step at tp 2 would
  step them apart across tp ranks: a deliberate difference.
- Under ``GradScaler`` an inf written into one gradient on stage 0 only
  makes every rank skip the step, bit for bit, and halve the scale.

The shared pieces are in ``tests/torch_pipeline_helpers.py``.  This
module imports JAX only in its fixtures and tests.
"""

import numpy as np
import pytest

import torch_pipeline_helpers as h
from apex_tpu_torch.transformer.testing.distributed import run_world


@pytest.fixture(scope="module")
def jx_tp1(devices):
    return h.jax_3d(devices[:2], 1, h.PP, h.batches_of(1))


@pytest.fixture(scope="module")
def jx_tp2(devices, jx_tp1):
    sliced = {2 * p + t: h.slice_flax(jx_tp1["params0"][p], t, 2)
              for p in range(h.PP) for t in range(2)}
    return h.jax_3d(devices[:4], 2, h.PP, h.batches_of(1), params=sliced,
                    steps=0, sp=True)


@pytest.fixture(scope="module")
def world(jx_tp1):
    return run_world(h.sp_world, 4, args=(jx_tp1["params0"], h.batches_of(1)),
                     timeout=150)


def test_sp_raw_grads_match_jax_pp2_tp2(jx_tp2, world):
    """Each rank's raw gradients (before the repair) against JAX's rank
    of the same (pp, tp), rank ``2 p + t``; the tagged parameters are the
    stage's RMSNorm scales."""
    for rank, res in enumerate(world):
        sp = res["sp"]
        p, t = sp["pp_rank"], sp["tp_rank"]
        assert rank == 2 * p + t
        ref = h.stage_of(jx_tp2["raw"][rank], p)
        h.assert_grads(sp["raw"], ref, f"SP raw rank {rank}")
        norms = [n for n in ref if n.endswith("layernorm.scale")
                 or n == "last.norm.scale"]
        assert sp["tagged"] == sorted(norms)


def test_sp_repair_gives_every_rank_the_whole_grad(jx_tp1, world):
    """After ``allreduce_sequence_parallel_grads`` each rank holds the pp 2
    x tp 1 run's gradient of every parameter, sliced to its tp shard;
    before it, no rank held a norm scale's whole gradient."""
    for rank, res in enumerate(world):
        sp = res["sp"]
        p, t = sp["pp_rank"], sp["tp_rank"]
        ref = h.tp_shard(h.stage_of(jx_tp1["g1"][p], p), t)
        h.assert_grads(sp["reduced"], ref, f"SP reduced rank {rank}")
        for n in sp["tagged"]:
            assert not np.allclose(sp["raw"][n], ref[n], rtol=1e-2,
                                   atol=0), n


def test_sp_three_steps_follow_the_tp1_trajectory(jx_tp1, world):
    """Three 3-d steps at pp 2 x tp 2 under sequence parallelism: JAX's pp
    2 x tp 1 losses within 1e-5, its parameters, sliced, within 1e-4 of
    each one's largest magnitude."""
    for rank, res in enumerate(world):
        sp = res["sp"]
        p, t = sp["pp_rank"], sp["tp_rank"]
        np.testing.assert_allclose(sp["losses"], jx_tp1["losses"], rtol=0,
                                   atol=1e-5)
        ref = h.tp_shard(h.stage_of(jx_tp1["params"][p], p), t)
        h.assert_params(sp["params"], ref, f"SP rank {rank}")


def test_sp_steps_keep_tagged_params_equal_across_tp(world):
    """After the three 3-d steps every ``sequence_parallel`` parameter is
    bit for bit the same on the two tp ranks of a stage: their gradients
    were summed over tp inside ``train_step`` (partial gradients differ
    by rank, and Adam would step the copies apart)."""
    by_rank = [res["sp"] for res in world]
    for p in range(h.PP):
        a, b = by_rank[2 * p], by_rank[2 * p + 1]
        assert a["tagged"] == b["tagged"] and a["tagged"]
        for n in a["tagged"]:
            assert np.array_equal(a["params"][n], b["params"][n]), n


def test_overflow_on_stage_0_skips_every_rank(world):
    """An inf in one gradient of stage 0: every rank's ``found_inf`` is
    true (``GradScaler``'s MAX over tp x pp), every parameter keeps its
    bits, the scale halves; the next, clean step applies everywhere."""
    for res in world:
        o = res["overflow"]
        assert o["found"] and not o["found_clean"]
        assert o["kept_bits"] and o["moved_after"]
        assert o["scales"] == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15]
