"""apex_tpu_torch.contrib.sparsity against apex_tpu.contrib.sparsity (the
cases of ``tests/test_sparsity.py``, then each against JAX).

Layouts: JAX groups a flax ``[in, out]`` kernel along axis -2 and an HWIO
one along I; the port groups a torch ``[out, in]`` weight along dimension
1 and an OIHW one along I.  For the same weight the port's mask is the
transpose of JAX's, exactly (the scores are the same fp32 sums and ties
go to the first pattern on both sides).  The permutation search is numpy
on both sides and must give the same permutation.  The ASP flow over an
``nn.Module`` is held to JAX's flow over the same weights with FusedAdam:
masks, pruned weights and three masked steps (``atol 1e-6``).
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.sparsity import (
    ASP,
    accelerated_search_for_good_permutation,
    apply_permutation,
    create_mask,
    invert_permutation,
    sum_after_2_to_4,
)
from apex_tpu_torch.contrib.sparsity.sparse_masklib import (
    compute_valid_1d_patterns,
    mn_1d_best,
)


@pytest.fixture(autouse=True)
def _reset_asp():
    from apex_tpu.contrib.sparsity import ASP as JASP

    ASP.reset()
    JASP.reset()
    yield
    ASP.reset()
    JASP.reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if ties:   # equal magnitudes: the first best pattern must win
        w = np.round(w) + 0.0
    return w


def test_valid_patterns_enumeration():
    pats = compute_valid_1d_patterns(4, 2)
    assert pats.shape == (6, 4)
    assert np.all(pats.sum(1) == 2)
    assert len({tuple(p) for p in pats}) == 6


def test_mn_1d_best_keeps_two_largest_of_four():
    w = _weights(0, (8, 16))
    mask = mn_1d_best(_t(w), 4, 2).numpy()
    assert mask.dtype == np.bool_
    for g, k in zip(np.abs(w).reshape(-1, 4), mask.reshape(-1, 4)):
        assert set(np.nonzero(k)[0]) == set(np.argsort(g)[-2:])


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("pattern", ["m4n2_1d", "m8n4_1d"])
def test_mn_1d_best_equals_jax(pattern, ties):
    import jax.numpy as jnp

    from apex_tpu.contrib.sparsity.sparse_masklib import mn_1d_best as jmn

    m, n = int(pattern[1]), int(pattern[3])
    w = _weights(1, (16, 32), ties)
    np.testing.assert_array_equal(mn_1d_best(_t(w), m, n).numpy(),
                                  np.asarray(jmn(jnp.asarray(w), m, n)))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_mask_is_the_transpose_of_jax_mask(ties):
    """A torch ``[out, in]`` weight's mask equals the transpose of JAX's
    mask of the flax kernel ``w.T``; an OIHW weight's mask equals JAX's of
    the HWIO kernel, transposed back."""
    import jax.numpy as jnp

    from apex_tpu.contrib.sparsity import create_mask as jcm

    w = _weights(2, (24, 64), ties)                       # [out, in]
    got = create_mask(_t(w)).numpy()
    assert np.all(got.reshape(24, 16, 4).sum(-1) == 2)
    np.testing.assert_array_equal(got, np.asarray(jcm(jnp.asarray(w.T))).T)
    conv = _weights(3, (16, 32, 3, 3), ties)              # OIHW
    got4 = create_mask(_t(conv)).numpy()
    assert np.all(got4.sum(1) * 2 == got4.shape[1])
    want4 = np.asarray(jcm(jnp.asarray(conv.transpose(2, 3, 1, 0))))
    np.testing.assert_array_equal(got4, want4.transpose(3, 2, 0, 1))


def test_create_mask_validation_and_1d():
    with pytest.raises(ValueError, match="pattern"):
        create_mask(torch.ones(8, 16), "2:4")
    with pytest.raises(ValueError, match="multiple"):
        create_mask(torch.ones(8, 10))
    assert create_mask(torch.arange(8.0)).tolist() == [False, False, True,
                                                       True] * 2


def _model(w, bias=True):
    m = torch.nn.Linear(w.shape[1], w.shape[0], bias=bias)
    with torch.no_grad():
        m.weight.copy_(_t(w))
        if bias:
            m.bias.zero_()
    return m


def test_asp_flow_matches_jax_through_three_steps():
    """``prune_trained_model`` then three FusedAdam steps with all-ones
    gradients: the masks are JAX's transposed, the pruned weights JAX's,
    and after each step the pruned positions stay 0 and the rest equal
    JAX's (JAX zeroes the gradients of pruned weights going in and masks
    the weights coming out; so does the wrapped step)."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.sparsity import ASP as JASP
    from apex_tpu.optimizers import FusedAdam as JAdam
    from apex_tpu_torch.optimizers import FusedAdam

    w = _weights(2, (16, 32))
    params = {"dense": {"kernel": jnp.asarray(w.T),
                        "bias": jnp.zeros((16,), jnp.float32)}}
    jpruned, jopt = JASP.prune_trained_model(params, JAdam(lr=1e-2))
    state = jopt.init(jpruned)
    p = jpruned
    m = _model(w)
    model, opt = ASP.prune_trained_model(m, FusedAdam(m.parameters(), lr=1e-2))
    assert model is m
    mask = ASP.masks()["weight"]
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(JASP.masks()["dense/kernel"]).T)
    assert set(ASP.masks()) == {"weight"}
    np.testing.assert_array_equal(m.weight.detach().numpy(),
                                  np.asarray(jpruned["dense"]["kernel"]).T)
    assert (m.weight == 0).float().mean() == 0.5
    for _ in range(3):
        p, state = jopt.step(jax.tree.map(jnp.ones_like, p), p, state)
        for q in m.parameters():
            q.grad = torch.ones_like(q)
        opt.step()
        assert torch.all(m.weight[~mask] == 0)
        np.testing.assert_allclose(m.weight.detach().numpy(),
                                   np.asarray(p["dense"]["kernel"]).T,
                                   atol=1e-6, rtol=0)
    assert not torch.allclose(m.weight[mask], _t(w)[mask])


def test_asp_recompute_restores_dense_weights():
    w = _weights(3, (8, 16))
    m = _model(w, bias=False)
    ASP.init_model_for_pruning(m, allow_recompute_mask=True, verbosity=0)
    ASP.compute_sparse_masks()
    assert (m.weight == 0).float().mean() == 0.5
    ASP.restore_pruned()
    np.testing.assert_array_equal(m.weight.detach().numpy(), w)


def test_asp_checkpoint_roundtrip():
    m = _model(_weights(4, (8, 16)), bias=False)
    ASP.init_model_for_pruning(m, verbosity=0)
    masks = {k: v.clone() for k, v in ASP.compute_sparse_masks().items()}
    saved = ASP.state_dict()
    ASP.reset()
    m2 = _model(_weights(5, (8, 16)), bias=False)
    ASP.load_state_dict(saved, model=m2)
    assert torch.equal(ASP.masks()["weight"], masks["weight"])
    ASP.compute_sparse_masks()
    assert (m2.weight == 0).float().mean() == 0.5


def test_asp_name_filters_whitelist_and_double_init():
    m = torch.nn.ModuleDict({"encoder": torch.nn.Linear(16, 8),
                             "head": torch.nn.Linear(16, 8),
                             "odd": torch.nn.Linear(12, 8)})
    masks = ASP.init_model_for_pruning(m, verbosity=0,
                                       disallowed_layer_names=["head"])
    # the shape gate: [out, in] with out % 8 and in % 16
    assert set(masks) == {"encoder.weight"}
    with pytest.raises(RuntimeError):
        ASP.init_model_for_pruning(m, verbosity=0)
    ASP.reset()
    masks = ASP.init_model_for_pruning(
        m, verbosity=0, whitelist=lambda name, p: name.startswith("head."))
    assert set(masks) == {"head.weight", "head.bias"}


def test_asp_needs_init_first():
    with pytest.raises(RuntimeError):
        ASP.compute_sparse_masks(torch.nn.Linear(16, 8))
    with pytest.raises(RuntimeError):
        ASP.restore_pruned(torch.nn.Linear(16, 8))


@pytest.mark.parametrize("case", range(4))
def test_permutation_search_equals_jax(case):
    """The port's copy of the search gives JAX's permutation on the same
    matrix: conv-net-shaped, heavy-tailed weights, and the adversarial
    layout of JAX's test."""
    from apex_tpu.contrib.sparsity import (
        accelerated_search_for_good_permutation as jsearch,
    )

    rng = np.random.default_rng(case)
    if case == 3:
        w = np.concatenate([np.abs(rng.standard_normal((16, 4))) + 10.0,
                            np.abs(rng.standard_normal((16, 4))) * 0.1], 1)
    else:
        r, c = [(32, 16), (16, 32), (24, 16)][case]
        w = rng.standard_normal((r, c)) * (rng.random((1, c)) ** 2 * 3 + 0.05)
    options = {"max_rounds": 50}
    perm = accelerated_search_for_good_permutation(w, options)
    np.testing.assert_array_equal(perm, jsearch(w, options))
    assert sorted(perm) == list(range(w.shape[1]))
    assert sum_after_2_to_4(apply_permutation(w, perm)) >= sum_after_2_to_4(w)
    np.testing.assert_array_equal(
        apply_permutation(apply_permutation(w, perm), invert_permutation(perm)),
        w)


def test_permutation_search_identity_when_nothing_helps():
    perm = accelerated_search_for_good_permutation(np.ones((8, 8), np.float32))
    np.testing.assert_array_equal(perm, np.arange(8))
