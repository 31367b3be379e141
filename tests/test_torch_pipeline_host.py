"""The pipeline slice's host code against the JAX package's: microbatch
calculators, the batch samplers, the left-to-right masks, the rank grid
of ``parallel_state``, the timers' metrics, and the public names.

- The constant and ramp-up microbatch calculators (and the
  ``setup_microbatch_calculator`` singleton) give JAX's batch sizes and
  microbatch counts over a run of consumed samples, and raise where JAX
  raises.
- Both samplers yield JAX's index lists, the random one from the same
  ``np.random.default_rng(epoch)`` permutation.
- ``get_ltor_masks_and_position_ids`` gives JAX's masks and position ids
  with and without the per-document resets.
- ``rank_grid(8, tp=2, pp=2)``: every group is the set of JAX devices
  that share the other mesh coordinates of
  ``initialize_model_parallel(2, 2)`` (port rank ``r`` is JAX device
  ``r``).
- ``Timers.publish_metrics`` sets the bridge's ``apex_timer_seconds``
  series, region by region, as JAX's does.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer import microbatches as tmb
from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer._data import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)
from apex_tpu_torch.transformer.pipeline_parallel import utils as tutils
from apex_tpu_torch.transformer.pipeline_parallel._timers import Timers

RAMPS = [None, [4, 4, 48], [8, 8, 100], [16, 16, 0]]


@pytest.mark.parametrize("ramp", RAMPS, ids=str)
def test_microbatch_calculators_follow_jax(ramp):
    from apex_tpu.transformer import microbatches as jmb

    def trace(mod):
        calc = mod.build_num_microbatches_calculator(0, ramp, 32, 2, 2)
        out = []
        for consumed in range(0, 160, 12):
            calc.update(consumed, consistency_check=True)
            out.append((calc.get(), calc.get_current_global_batch_size()))
        return out

    assert trace(tmb) == trace(jmb)


@pytest.mark.parametrize("args", [(30, 4, 2), (32, 2, 3), (20, [4, 5, 8], 2),
                                  (32, [4, 2, 3, 9], 2)], ids=str)
def test_microbatch_calculator_errors_match_jax(args):
    from apex_tpu.transformer import microbatches as jmb

    gbs, ramp, mbs = args
    ramp = None if isinstance(ramp, int) else ramp

    def err(mod):
        try:
            mod.build_num_microbatches_calculator(0, ramp, gbs, mbs, 2)
        except (ValueError, RuntimeError) as e:
            return type(e).__name__, str(e)
        return None

    got = err(tmb)
    assert got is not None and got == err(jmb)


def test_microbatch_singleton_matches_jax():
    from apex_tpu.transformer.pipeline_parallel import utils as jutils

    seen = []
    for mod in (tutils, jutils):
        mod.destroy_microbatch_calculator()
        mod.setup_microbatch_calculator(0, [4, 4, 24], 16, 2, 2)
        try:
            with pytest.raises(AssertionError):
                mod.setup_microbatch_calculator(0, None, 16, 2, 2)
            row = []
            for consumed in (0, 8, 16, 40):
                mod.update_num_microbatches(consumed)
                row.append((mod.get_num_microbatches(),
                            mod.get_current_global_batch_size(),
                            mod.get_micro_batch_size()))
            seen.append(row)
        finally:
            mod.destroy_microbatch_calculator()
    assert seen[0] == seen[1]


@pytest.mark.parametrize("cfg", [(32, 0, 2, 0, 2), (32, 0, 2, 1, 2),
                                 (37, 8, 4, 1, 2), (30, 12, 3, 0, 1),
                                 (64, 48, 4, 3, 4)], ids=str)
def test_samplers_yield_jax_index_lists(cfg):
    from apex_tpu.transformer._data import _batchsampler as jbs

    for drop_last in (True, False):
        assert (list(MegatronPretrainingSampler(*cfg, drop_last=drop_last))
                == list(jbs.MegatronPretrainingSampler(
                    *cfg, drop_last=drop_last)))
    ours = MegatronPretrainingRandomSampler(*cfg)
    ref = jbs.MegatronPretrainingRandomSampler(*cfg)
    assert list(ours) == list(ref)
    assert ours.consumed_samples == ref.consumed_samples


def test_sampler_errors_match_jax():
    from apex_tpu.transformer._data import _batchsampler as jbs

    for bad in ((0, 0, 2, 0, 1), (8, 0, 0, 0, 1), (8, 0, 2, 0, 0),
                (8, 0, 2, 2, 2)):
        msgs = []
        for cls in (MegatronPretrainingSampler, jbs.MegatronPretrainingSampler):
            with pytest.raises(RuntimeError) as e:
                cls(*bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True),
                                   (True, False, True)], ids=str)
def test_ltor_masks_and_position_ids_match_jax(flags):
    import jax.numpy as jnp

    from apex_tpu.transformer.pipeline_parallel import utils as jutils

    rng = np.random.default_rng(0)
    data = rng.integers(0, 6, (3, 17))
    reset_pos, reset_att, eod_loss = flags
    kw = dict(eod_token=0, reset_position_ids=reset_pos,
              reset_attention_mask=reset_att, eod_mask_loss=eod_loss)
    ours = tutils.get_ltor_masks_and_position_ids(torch.from_numpy(data), **kw)
    ref = jutils.get_ltor_masks_and_position_ids(jnp.asarray(data), **kw)
    for a, b, what in zip(ours, ref, ("attention", "loss mask", "positions")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)


def test_rank_grid_is_jax_mesh_order(devices):
    """(tp, pp, dp) = (2, 2, 2): the JAX mesh's device at ``[d, p, t]`` is
    port rank ``p * 4 + d * 2 + t``, and each port group holds the
    devices that share the other coordinates."""
    from apex_tpu.transformer import parallel_state as jps

    mesh = jps.initialize_model_parallel(2, 2, devices=devices[:8])
    try:
        ids = np.vectorize(lambda d: d.id)(mesh.devices)     # [dp, pp, tp]
        axis = {n: i for i, n in enumerate(mesh.axis_names)}
    finally:
        jps.destroy_model_parallel()
    grid = tps.rank_grid(8, tp=2, pp=2)
    dp, pp, tp = ids.shape
    for d in range(dp):
        for p in range(pp):
            for t in range(tp):
                assert ids[d, p, t] == p * dp * tp + d * tp + t

    def groups(along):
        moved = np.moveaxis(ids, axis[along], -1)
        return sorted(sorted(int(x) for x in row)
                      for row in moved.reshape(-1, moved.shape[-1]))

    for kind in ("tp", "pp", "dp"):
        assert sorted(map(sorted, grid[kind])) == groups(kind), kind
    assert sorted(map(sorted, grid["model"])) == sorted(
        sorted(int(x) for x in ids[d].ravel()) for d in range(dp))
    assert grid["embedding"] == [sorted({g[0], g[-1]}) for g in grid["pp"]]
    with pytest.raises(RuntimeError, match="not divisible"):
        tps.rank_grid(6, tp=2, pp=2)


def test_timers_publish_apex_timer_seconds_like_jax():
    from apex_tpu.obs import REGISTRY as JREG
    from apex_tpu.transformer.pipeline_parallel._timers import Timers as JT
    from apex_tpu_torch.obs import REGISTRY as TREG

    series = []
    for timers, reg in ((Timers("cpu"), TREG), (JT(), JREG)):
        with timers("forward").timing(barrier=True):
            sum(range(1000))
        timers("backward").start()
        snap = timers.publish_metrics()
        timers("backward").stop(barrier=True)
        assert snap["backward"]["running"] and not snap["forward"]["running"]
        metric = reg.get("apex_timer_seconds")
        got = {r: metric.value(region=r) for r in ("forward", "backward")}
        assert got["forward"] == snap["forward"]["total_s"] > 0
        series.append(sorted(got))
        assert got["backward"] == snap["backward"]["total_s"] > 0
        line = timers.log(["forward", "backward"])
        assert line.startswith("time (ms) | forward: ")
    assert series[0] == series[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Timers()


def test_utils_norm_and_memory_report():
    from apex_tpu.transformer.pipeline_parallel import utils as jutils
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((3, 4), (7,), (2, 2, 2))]
    ours = tutils.calc_params_l2_norm([torch.from_numpy(a) for a in arrs])
    ref = jutils.calc_params_l2_norm([jnp.asarray(a) for a in arrs])
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    msg = tutils.report_memory("probe", device="cpu")
    assert msg == ("[probe] memory (GiB) | in use: 0.00 | peak: 0.00 | "
                   "limit: 0.00")
    assert tutils.unwrap_model([torch.nn.Linear(1, 1)])[0].in_features == 1


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and callable(getattr(mod, n))
            and getattr(getattr(mod, n), "__module__", "") == mod.__name__}


def test_every_jax_pipeline_name_exists_in_the_port():
    """The exported names of ``apex_tpu.transformer.pipeline_parallel``
    (and its schedules, point-to-point layer, utils and timers),
    ``microbatches``, ``_data``, ``models.llama_pipeline`` and the
    public functions of ``parallel_state`` (but the JAX mesh set-up,
    ``get_mesh`` and ``initialize_distributed``) exist in the port."""
    import importlib

    pairs = ["transformer.pipeline_parallel",
             "transformer.pipeline_parallel.schedules",
             "transformer.pipeline_parallel.p2p_communication",
             "transformer.pipeline_parallel.utils",
             "transformer.pipeline_parallel._timers",
             "transformer.microbatches", "transformer._data",
             "models.llama_pipeline", "transformer.parallel_state"]
    for name in pairs:
        jmod = importlib.import_module(f"apex_tpu.{name}")
        tmod = importlib.import_module(f"apex_tpu_torch.{name}")
        names = set(getattr(jmod, "__all__", ())) | _public(jmod)
        if name == "transformer.parallel_state":
            names -= {"get_mesh", "initialize_distributed"}
        missing = sorted(n for n in names if not hasattr(tmod, n))
        assert not missing, (name, missing)
