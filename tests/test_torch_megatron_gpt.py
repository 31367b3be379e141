"""The port's Megatron GPT driver (``examples/megatron_gpt_pretrain.py``)
against the JAX driver (``examples/gpt/pretrain.py::main``) on virtual CPU
devices, from the JAX driver's own initial weights carried over by
``gpt_pipeline_params_from_jax``; 2 layers, hidden 64, 4 heads, s 32,
vocab 128, micro-batch 2, 2 microbatches, FusedAdam(lr 1e-3), 3
iterations of the JAX driver's numpy batch stream.

- dp 1 x pp 1 x tp 1, one process: the JAX driver does not run at pp 1
  (its ``forward_backward_no_pipelining`` calls the stage spec, which is
  not callable: ``ROADMAP.md``, the reference's own faults), so the port
  at pp 1 is held to the JAX driver at pp 2 of the same two layers (its
  two stages' weights as one stage): both train the mean microbatch loss.
- dp 2 x pp 2 in a gloo world of 4 against the JAX driver at dp 2 x pp 2,
  rank by rank.
- pp 2 x tp 2 with sequence parallelism, in the same world, against the
  JAX driver's pp 2 x tp 1 run, each rank's parameters against JAX's
  sliced to its tp shard (the JAX step at tp 2 would leave the
  sequence-parallel gradients partial: ``ROADMAP.md`` Queue C).
- pp 2 x tp 2 with 2 virtual chunks a rank (the interleaved 1F1B; the
  JAX driver stops there: it passes one stage spec and no chunk count),
  in the same world from the seeded init, against the driver at pp 1 from
  the same seed.
- ``--bf16`` (bf16 parameters, fp32 LayerNorm scale and bias, the fp32
  head, FusedAdam over the bf16 parameters with fp32 moments) at pp 1
  against the JAX driver's ``--bf16`` run at pp 2, as above.
- The two copies of the tied word embeddings (first and last stage) are
  equal bit for bit after every iteration.

Tolerances: each iteration's loss within 1e-5 of JAX's; every parameter
after the 3 iterations within 1e-4 of its largest magnitude, but the key
biases (whose true gradient is zero, so that Adam steps them on fp32
rounding noise in both packages) within 6e-3, twice 3 steps of lr; the
virtual pipeline's parameters against the one-stage run within ``1e-5 +
2 x 3 lr ng / (|g| + ng)`` (``ng`` 1e-4 of the tensor's largest first
gradient plus 1e-6 of the model's), ``chip_smoke.py``'s card-against-CPU
limit: an element whose gradient is within its noise steps by up to lr
either way.  Under ``--bf16`` each loss within 1e-3 of JAX's (about 5 x
the largest reading, 1.8e-4) and the parameters within
``torch_megatron_helpers.assert_params_bf16``'s limit (3 ulps of their
dtype, one a store, plus the same noise term with ``ng`` 2**-7 of the
model's largest gradient).  This module
imports JAX only in its fixtures and tests.
"""

import numpy as np
import pytest
import torch

import torch_megatron_helpers as h
from apex_tpu_torch.examples import megatron_gpt_pretrain as mgp
from apex_tpu_torch.transformer.testing.distributed import run_world

LOSS_TOL = 1e-5
LOSS_TOL_BF16 = 1e-3


@pytest.fixture(scope="module")
def mpatch():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def jx_pp2(mpatch):
    with mpatch.context() as m:
        return h.jax_main(m, 1, 2, 1)


@pytest.fixture(scope="module")
def jx_dp2(mpatch):
    with mpatch.context() as m:
        return h.jax_main(m, 2, 2, 1)


@pytest.fixture(scope="module")
def jx_pp2_bf16(mpatch):
    with mpatch.context() as m:
        return h.jax_main(m, 1, 2, 1, extra=["--bf16"])


@pytest.fixture(scope="module")
def world(jx_pp2, jx_dp2):
    states_dp2 = h.port_states(jx_dp2, 2, 2, 1)
    states_tp2 = h.port_states(jx_pp2, 1, 2, 2, slice_tp=2)
    return run_world(h.world4, 4, args=(states_dp2, states_tp2), timeout=200)


def test_jax_driver_fails_at_pp1(mpatch):
    """The reference's fault the pp-1 comparison goes round."""
    with mpatch.context() as m:
        with pytest.raises(TypeError, match="not callable"):
            h.jax_main(m, 1, 1, 1)


def test_pp1_matches_the_jax_driver_at_pp2(jx_pp2):
    whole = h.whole_tree({p: jx_pp2["params0"][(p, 0, 0)] for p in range(2)})
    state = h.gpt_pipeline_params_from_jax(whole, h.cfg_of(1), pp_rank=0,
                                           pp_size=1)
    out = h.run(["--device", "cpu"] + h.flags(1, 1, 1), state)
    np.testing.assert_allclose(out["losses"], jx_pp2["losses"], rtol=0,
                               atol=LOSS_TOL)
    assert out["losses"][-1] == pytest.approx(jx_pp2["final"], abs=LOSS_TOL)
    ref = h.port_named(h.whole_tree(
        {p: jx_pp2["params"][(p, 0, 0)] for p in range(2)}), 0, 1, 1)
    h.assert_params(out["params"], ref, "pp 1")
    # one parameter for the tied embedding, used twice
    assert not any(n.startswith("last.word") for n in out["names"])


def test_bf16_pp1_matches_the_jax_driver_at_pp2(jx_pp2_bf16):
    """``--bf16``: the parameters' dtypes JAX's, the losses and the
    parameters after 3 iterations within the bf16 limits."""
    jx = jx_pp2_bf16
    whole = h.whole_tree({p: jx["params0"][(p, 0, 0)] for p in range(2)})
    state = h.gpt_pipeline_params_from_jax(whole, h.cfg_of(1), pp_rank=0,
                                           pp_size=1)
    out = h.run(["--device", "cpu", "--bf16"] + h.flags(1, 1, 1), state)
    assert out["dtypes"] == {k: v.dtype for k, v in state.items()}
    assert {str(v) for v in out["dtypes"].values()} == {"torch.bfloat16",
                                                        "torch.float32"}
    assert all(v == torch.float32 for k, v in out["dtypes"].items()
               if "layernorm" in k)
    np.testing.assert_allclose(out["losses"], jx["losses"], rtol=0,
                               atol=LOSS_TOL_BF16)
    ref = h.port_named(h.whole_tree(
        {p: jx["params"][(p, 0, 0)] for p in range(2)}), 0, 1, 1)
    h.assert_params_bf16(out["params"], ref, out["grads"], out["dtypes"],
                         "bf16 pp 1")


def test_dp2_pp2_matches_the_jax_driver(jx_dp2, world):
    for rank, res in enumerate(world):
        p, d, t = h.coords(rank, 2, 2, 1)
        got = res["dp2"]
        np.testing.assert_allclose(got["losses"], jx_dp2["losses"], rtol=0,
                                   atol=LOSS_TOL, err_msg=f"rank {rank}")
        ref = h.port_named(jx_dp2["params"][(p, d, t)], p, 2)
        h.assert_params(got["params"], ref, f"dp2 x pp2 rank {rank}")


def test_pp2_tp2_sequence_parallel_follows_the_tp1_trajectory(jx_pp2,
                                                              world):
    for rank, res in enumerate(world):
        p, d, t = h.coords(rank, 1, 2, 2)
        got = res["tp2"]
        np.testing.assert_allclose(got["losses"], jx_pp2["losses"], rtol=0,
                                   atol=LOSS_TOL, err_msg=f"rank {rank}")
        ref = h.port_named(jx_pp2["params"][(p, 0, 0)], p, 2)
        h.assert_params(got["params"], ref, f"pp2 x tp2 rank {rank}", tp=2,
                        t=t)


def test_virtual_pipeline_pp2_tp2_matches_one_stage(world):
    """pp 2 x tp 2 with 2 virtual chunks a rank (4 layers, one a chunk;
    the interleaved 1F1B) from the seeded init against the driver at pp 1
    from the same seed: the losses, and each chunk's parameters against
    its global stage of the one-stage run, sliced to its tp shard, within
    the gradient-scaled limit of ``assert_params_by_grads``."""
    out = h.run(["--device", "cpu"] + h.vpp_flags(1, 1, 1)[:-2], None)
    for rank, res in enumerate(world):
        p, _, t = h.coords(rank, 1, 2, 2)
        got = res["vpp"]
        np.testing.assert_allclose(got["losses"], out["losses"], rtol=0,
                                   atol=LOSS_TOL, err_msg=f"rank {rank}")
        assert len(got["params"]) == 2
        for v, chunk in enumerate(got["params"]):
            g = v * 2 + p
            h.assert_params_by_grads(
                chunk, h.chunk_of(out["params"], g, 4),
                h.chunk_of(out["grads"], g, 4), f"vpp rank {rank} chunk {v}",
                tp=2, t=t)


@pytest.mark.parametrize("form,dp,tp", [("dp2", 2, 1), ("tp2", 1, 2),
                                        ("vpp", 1, 2)])
def test_tied_embedding_copies_equal_after_every_iteration(world, form, dp,
                                                           tp):
    for rank, res in enumerate(world):
        p, d, t = h.coords(rank, dp, 2, tp)
        if p:
            continue
        other = world[h.coords_to_rank(1, d, t, dp, tp)][form]["tied"]
        mine = res[form]["tied"]
        assert len(mine) == len(other) == h.ITERS
        for it, (a, b) in enumerate(zip(mine, other)):
            assert np.array_equal(a, b), (form, rank, it)


def test_driver_refuses_missing_lr_and_a_virtual_pipeline_at_pp1():
    base = ["--device", "cpu"] + h.flags(1, 1, 1)
    with pytest.raises(ValueError, match="--lr is required"):
        mgp.main([a for i, a in enumerate(base)
                  if a != "--lr" and base[i - 1] != "--lr"])
    with pytest.raises(RuntimeError, match="greater than 1 with interleaved"):
        mgp.main(base + ["--num-layers-per-virtual-pipeline-stage", "1"])
