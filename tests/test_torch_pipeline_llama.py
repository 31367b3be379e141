"""The Llama 3-d step (``make_llama_3d_train_step`` over the 1F1B
schedule) in gloo worlds of spawned ranks against the JAX package's under
``shard_map`` over ``initialize_model_parallel(1, 2)`` meshes of virtual
CPU devices, from JAX's own init (``examples/llama/pretrain.py``'s
``main_3d``), every rank's weights read from its own device buffer.

- **dp 1 x pp 2 x tp 1** (world 2) and **dp 2 x pp 2 x tp 1** (world 4):
  three steps' losses within 1e-5 and every parameter of every stage
  within 1e-4 of its largest magnitude; at dp 1 the first step's
  gradients too, the embedding's and the head's against JAX's pp-summed
  ones (each lives on its one stage in the port; off it JAX's are
  zeros).
- ``llama_pretrain.main(["--pp", "2", ...])`` trains in a world of 2,
  fp32 and ``--amp``.

Sequence parallelism and the overflow step are in
``tests/test_torch_pipeline_sp.py``; the shared pieces in
``tests/torch_pipeline_helpers.py``.  This module imports JAX only in its
fixtures and tests, so the spawned ranks stay JAX-free.
"""

import numpy as np
import pytest

import torch_pipeline_helpers as h
from apex_tpu_torch.transformer.testing.distributed import run_world


@pytest.fixture(scope="module")
def jx_dp1(devices):
    return h.jax_3d(devices[:2], 1, h.PP, h.batches_of(1))


@pytest.fixture(scope="module")
def jx_dp2(devices):
    return h.jax_3d(devices[:4], 1, h.PP, h.batches_of(2), grads=False)


@pytest.fixture(scope="module")
def pp2(jx_dp1):
    return run_world(h.pp2_world, 2, args=(jx_dp1["params0"],
                                           h.batches_of(1)), timeout=150)


@pytest.fixture(scope="module")
def dp2(jx_dp1):
    # the dp 2 JAX init draws the same stage weights as the dp 1 one
    return run_world(h.dp2_world, 4, args=(jx_dp1["params0"],
                                           h.batches_of(2)), timeout=150)


def test_jax_dp_replicas_start_from_the_dp1_weights(jx_dp1, jx_dp2):
    """JAX's init at dp 2 puts stage ``p``'s dp-1 weights on both of its
    replicas (devices ``2 p`` and ``2 p + 1``), so both port worlds start
    from ``jx_dp1``'s."""
    for dev, tree in jx_dp2["params0"].items():
        ref = jx_dp1["params0"][dev // 2]
        for a, b in zip(h.leaves(tree), h.leaves(ref)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["dp1", "dp2"])
def test_3d_step_three_steps_match_jax(jx_dp1, jx_dp2, pp2, dp2, form):
    """Losses at 1e-5 and every parameter of every stage within 1e-4 of
    its largest magnitude after three steps (port rank ``p * dp + d`` is
    JAX device ``p * dp + d``)."""
    ref, ranks, dp = ((jx_dp1, pp2, 1) if form == "dp1"
                      else (jx_dp2, dp2, 2))
    for rank, res in enumerate(ranks):
        p = rank // dp
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=0,
                                   atol=1e-5)
        assert res["losses"][-1] < res["losses"][0]
        h.assert_params(res["params"], h.stage_of(ref["params"][rank], p),
                        f"{form} rank {rank}")
    if form == "dp2":
        assert [r["dp_rank"] for r in ranks] == [0, 1, 0, 1]
        # the dp group of rank p * 2 + d is {2 p, 2 p + 1}
        assert [r["loss_avg"] for r in ranks] == [
            [0.5, 1.0], [0.5, 1.0], [2.5, 1.0], [2.5, 1.0]]


def test_first_step_grads_match_jax_embed_and_head_pp_summed(jx_dp1, pp2):
    """The first step's gradients on each stage at 1e-4 (JAX's embedding
    and head gradients psum'd over pp); JAX's raw embedding gradient is
    zero off stage 0 and its head's off the last stage, so the owner's is
    the sum, and the port's stages hold only their own."""
    for p, res in enumerate(pp2):
        h.assert_grads(res["grads"], h.stage_of(jx_dp1["g1"][p], p),
                       f"stage {p} grads")
    for key, owner in (("embed", 0), ("head", h.PP - 1)):
        for p in range(h.PP):
            peak = max(np.abs(x).max()
                       for x in h.leaves(jx_dp1["raw"][p][key]))
            assert (peak == 0) == (p != owner), (key, p)
    assert "first.embed_tokens.weight" in pp2[0]["params"]
    assert not any(k.startswith("first.") for k in pp2[1]["params"])
    assert "last.lm_head" in pp2[1]["params"]
    assert not any(k.startswith("last.") for k in pp2[0]["params"])


def test_pretrain_driver_pp2_loss_falls(pp2):
    """``llama_pretrain.main(["--pp", "2", ...])`` in a world of 2, fp32
    and ``--amp`` (fp16 under ``GradScaler``): a finite, falling loss
    (main raises otherwise), the same on both stages."""
    for key in ("driver", "driver_amp"):
        vals = [r[key] for r in pp2]
        assert all(np.isfinite(vals)) and len(set(vals)) == 1, (key, vals)


def test_pretrain_pp_refuses_batch_and_uneven_layers():
    from apex_tpu_torch.examples import llama_pretrain

    with pytest.raises(ValueError, match="--batch applies to the 2-d path"):
        llama_pretrain.main(["--device", "cpu", "--pp", "2", "--batch", "4"])
    with pytest.raises(ValueError, match="must divide by --pp"):
        llama_pretrain.main(["--device", "cpu", "--pp", "2", "--layers", "3"])
