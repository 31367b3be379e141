"""apex_tpu_torch.contrib.xentropy, .focal_loss and .transducer against
their JAX twins (the cases of ``tests/test_contrib_losses.py``, whose
numpy oracles this file reuses, then each against JAX).

The same seeded numpy inputs go through the JAX function and the port on
the CPU.  Tolerances, fp32: the cross-entropy's losses and gradients
``atol 1e-5``; the focal loss ``rtol 1e-5``, its gradient ``atol 1e-6``;
the transducer loss ``rtol 1e-5`` against JAX and ``rtol 1e-4, atol 1e-5``
against the float64 oracle (JAX's), its gradient ``atol 2e-5`` against
JAX and ``rtol 1e-3, atol 1e-5`` against the oracle (JAX's), alpha and
beta ``atol 1e-4`` inside the lattice; the joint bit for bit.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.focal_loss import FocalLoss, focal_loss
from apex_tpu_torch.contrib.transducer import (
    TransducerJoint,
    TransducerLoss,
    transducer_joint,
    transducer_loss,
)
from apex_tpu_torch.contrib.transducer.transducer import pack_joint_output
from apex_tpu_torch.contrib.xentropy import (
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)


def _jt():
    import test_contrib_losses as jt

    return jt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# xentropy
# ---------------------------------------------------------------------------


def _xent_inputs(seed=0, N=64, V=317, pad=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, V)).astype(np.float32) * 2
    t = rng.integers(0, V, N)
    t[rng.choice(N, N // 6, replace=False)] = pad
    return x, t


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xentropy_forward_matches_jax_and_oracle(smoothing):
    import jax.numpy as jnp

    from apex_tpu.contrib.xentropy import SoftmaxCrossEntropyLoss as J

    x, t = _xent_inputs()
    got = SoftmaxCrossEntropyLoss.apply(_t(x), _t(t), smoothing, 0)
    assert got.dtype == torch.float32
    want = np.asarray(J.apply(jnp.asarray(x), jnp.asarray(t), smoothing, 0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               _jt().xent_oracle(x, t, 0, smoothing),
                               rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[t == 0] == 0.0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xentropy_gradient_matches_jax(smoothing):
    """The backward (softmax recomputed from the saved log-sum-exp)
    against JAX's custom_vjp, with padding rows (zero gradient) and an
    uneven upstream gradient."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as jf

    x, t = _xent_inputs(1, N=32, V=129)
    w = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    want = jax.grad(lambda xx: jnp.sum(
        jf(xx, jnp.asarray(t), smoothing, 0) * jnp.asarray(w)))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (softmax_cross_entropy_loss(xt, _t(t), smoothing, 0) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert np.all(xt.grad.numpy()[t == 0] == 0.0)


def test_xentropy_half_inputs_give_fp32_loss_and_half_gradient():
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as jf

    rng = np.random.default_rng(2)
    xb = jnp.asarray(rng.standard_normal((16, 64)), jnp.bfloat16)
    t = rng.integers(1, 64, 16)
    want = np.asarray(jf(xb, jnp.asarray(t), 0.1, 0))
    want_g = jax.grad(lambda xx: jf(xx, jnp.asarray(t), 0.1, 0).sum())(xb)
    x = _t(np.array(xb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    loss = softmax_cross_entropy_loss(x, _t(t), 0.1, 0)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), want, atol=1e-5, rtol=0)
    loss.sum().backward()
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(want_g.astype(jnp.float32)),
                               atol=2 ** -8, rtol=0)


def test_xentropy_saves_no_vocab_sized_fp32_tensor():
    """What autograd keeps between forward and backward: the logits, one
    fp32 value a row and the labels, never an ``[N, V]`` fp32 tensor."""
    x, t = _xent_inputs(3, N=16, V=64)
    saved = []
    xt = _t(x).to(torch.bfloat16).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda s: saved.append((tuple(s.shape), s.dtype)) or s,
            lambda s: s):
        loss = softmax_cross_entropy_loss(xt, _t(t), 0.1, 0)
    assert sorted(saved, key=str) == sorted(
        [((16, 64), torch.bfloat16), ((16,), torch.float32),
         ((16,), torch.int64)], key=str)
    loss.sum().backward()


def test_xentropy_negative_padding_idx():
    x, t = _xent_inputs(4, N=8, V=16)
    t[:2] = -100
    got = softmax_cross_entropy_loss(_t(x), _t(t), 0.1, -100)
    assert np.all(got.numpy()[:2] == 0.0)
    np.testing.assert_allclose(got.numpy()[2:],
                               _jt().xent_oracle(x[2:], t[2:], -100, 0.1),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# focal loss
# ---------------------------------------------------------------------------


def test_focal_loss_matches_torchvision_formula():
    rng = np.random.default_rng(3)
    N, C, alpha, gamma = 12, 8, 0.24, 2.0
    x = rng.standard_normal((N, C)).astype(np.float32)
    cls = rng.integers(0, C, N)
    got = FocalLoss.apply(_t(x), _t(cls), 1.0, C, alpha, gamma, 0.0)
    np.testing.assert_allclose(
        float(got), _jt().sigmoid_focal_oracle(x, np.eye(C)[cls], alpha, gamma),
        rtol=1e-5)


def test_focal_loss_negative_targets_and_normalizer():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((10, 5)).astype(np.float32)
    got = focal_loss(_t(x), _t(np.full(10, -1)), 2.0, 5, 0.25, 2.0)
    want = _jt().sigmoid_focal_oracle(x, np.zeros((10, 5)), 0.25, 2.0) / 2.0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_focal_loss_padded_classes_get_no_gradient():
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((6, 16)).astype(np.float32)).requires_grad_()
    focal_loss(x, _t(rng.integers(0, 7, 6)), 1.0, 7, 0.25, 2.0).backward()
    assert x.grad[:, 7:].abs().max() == 0.0
    assert x.grad[:, :7].abs().max() > 0.0


def test_focal_loss_label_smoothing_changes_targets():
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((4, 6)).astype(np.float32))
    cls = _t(rng.integers(0, 6, 4))
    assert float(focal_loss(x, cls, 1.0, 6, 0.25, 2.0, 0.0)) != float(
        focal_loss(x, cls, 1.0, 6, 0.25, 2.0, 0.1))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_focal_loss_and_gradient_match_jax(smoothing):
    """A detection level's shape ``[2, 4, 4, 9 x 16]`` with 13 real
    classes, negative ids (-1 background, -2 ignore) among the targets,
    against JAX's loss and gradient."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.focal_loss import focal_loss as jf

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 4, 9, 16)).astype(np.float32) * 2
    cls = rng.integers(-2, 13, (2, 4, 4, 9))
    args = (jnp.asarray(cls), 37.0, 13, 0.25, 2.0, smoothing)
    want, want_g = jax.value_and_grad(lambda xx: jf(xx, *args))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = focal_loss(xt, _t(cls), 37.0, 13, 0.25, 2.0, smoothing)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# transducer
# ---------------------------------------------------------------------------


def _transducer_inputs(seed, **kw):
    x, label, f_len, y_len = _jt()._rand_transducer(
        np.random.default_rng(seed), **kw)
    return x, label, f_len, y_len


def _torch_args(label, f_len, y_len):
    return _t(label), _t(f_len), _t(y_len)


@pytest.mark.parametrize("seed,shape", [
    (7, dict()), (9, dict(B=5, T=9, Umax=5, V=8))])
def test_transducer_loss_matches_oracle_and_jax(seed, shape):
    import jax.numpy as jnp

    from apex_tpu.contrib.transducer import TransducerLoss as J

    x, label, f_len, y_len = _transducer_inputs(seed, **shape)
    want, _ = _jt().transducer_oracle(x, label, f_len, y_len, blank=0)
    jax_loss = np.asarray(J()(jnp.asarray(x), jnp.asarray(label),
                              jnp.asarray(f_len), jnp.asarray(y_len), 0))
    got = TransducerLoss()(_t(x), *_torch_args(label, f_len, y_len), 0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jax_loss, rtol=1e-5, atol=0)


@pytest.mark.parametrize("blank", [0, 5])
def test_transducer_gradient_matches_oracle_and_jax(blank):
    """d(sum(w * loss))/dx against JAX's custom_vjp (an uneven upstream
    gradient) and, for w = 1, the oracle's."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.transducer import transducer_loss as jf

    x, label, f_len, y_len = _transducer_inputs(8)
    label = np.where(label == blank, (blank + 1) % x.shape[-1], label)
    _, want = _jt().transducer_oracle(x, label, f_len, y_len, blank=blank)
    w = np.asarray([1.0, 0.5, 2.0], np.float32)
    jargs = (jnp.asarray(label), jnp.asarray(f_len), jnp.asarray(y_len), blank)
    jax_g = jax.grad(lambda xx: jnp.sum(jf(xx, *jargs) * jnp.asarray(w)))(
        jnp.asarray(x))
    targs = _torch_args(label, f_len, y_len)
    xt = _t(x).requires_grad_()
    transducer_loss(xt, *targs, blank).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-3, atol=1e-5)
    xt.grad = None
    (transducer_loss(xt, *targs, blank) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax_g), atol=2e-5,
                               rtol=0)


def test_transducer_alpha_beta_match_jax_inside_the_lattice():
    """``debug_list`` alpha and beta against JAX's on every node with t <
    f_len and u <= y_len; outside it both hold the -1e30 sentinel (or
    sums of it)."""
    import jax.numpy as jnp

    from apex_tpu.contrib.transducer import TransducerLoss as J

    x, label, f_len, y_len = _transducer_inputs(10, B=4, T=8, Umax=5, V=7)
    jdbg, dbg = [], []
    J()(jnp.asarray(x), jnp.asarray(label), jnp.asarray(f_len),
        jnp.asarray(y_len), 0, debug_list=jdbg)
    TransducerLoss()(_t(x), *_torch_args(label, f_len, y_len), 0,
                     debug_list=dbg)
    T, U = x.shape[1], x.shape[2]
    inside = ((np.arange(T)[None, :, None] < f_len[:, None, None])
              & (np.arange(U)[None, None, :] <= y_len[:, None, None]))
    for got, want in zip(dbg, jdbg):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[inside], want[inside], atol=1e-4,
                                   rtol=0)
        assert np.all(got[~inside & (want < -1e29)] < -1e29)


def test_transducer_loss_packed_input_is_refused():
    with pytest.raises(NotImplementedError):
        TransducerLoss(packed_input=True)


def test_transducer_joint_matches_jax():
    import jax.numpy as jnp

    from apex_tpu.contrib.transducer import TransducerJoint as J

    rng = np.random.default_rng(10)
    B, T, U, H = 3, 6, 4, 8
    f = rng.standard_normal((B, T, H)).astype(np.float32)
    g = rng.standard_normal((B, U, H)).astype(np.float32)
    f_len, g_len = np.array([6, 4, 5]), np.array([4, 2, 3])
    h = TransducerJoint(relu=True)(_t(f), _t(g), _t(f_len), _t(g_len))
    want = np.maximum(f[:, :, None] + g[:, None], 0.0)
    for b in range(B):
        want[b, f_len[b]:] = 0.0
        want[b, :, g_len[b]:] = 0.0
    np.testing.assert_array_equal(h.numpy(), want)
    jh = J(relu=True)(jnp.asarray(f), jnp.asarray(g), jnp.asarray(f_len),
                      jnp.asarray(g_len))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_transducer_joint_packed_matches_jax():
    import jax.numpy as jnp

    from apex_tpu.contrib.transducer import TransducerJoint as J

    rng = np.random.default_rng(11)
    B, T, U, H = 3, 5, 4, 8
    f = rng.standard_normal((B, T, H)).astype(np.float32)
    g = rng.standard_normal((B, U, H)).astype(np.float32)
    f_len, g_len = np.array([5, 3, 4]), np.array([4, 2, 3])
    batch_offset = np.cumsum(f_len * g_len)
    packed = int(batch_offset[-1])
    got = TransducerJoint(pack_output=True)(
        _t(f), _t(g), _t(f_len), _t(g_len), batch_offset=_t(batch_offset),
        packed_batch=packed)
    assert got.shape == (packed, H)
    rows = [f[b, t] + g[b, u] for b in range(B) for t in range(f_len[b])
            for u in range(g_len[b])]
    np.testing.assert_array_equal(got.numpy(), np.stack(rows))
    want = J(pack_output=True)(
        jnp.asarray(f), jnp.asarray(g), jnp.asarray(f_len),
        jnp.asarray(g_len), batch_offset=jnp.asarray(batch_offset),
        packed_batch=packed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a buffer shorter than the rows drops the overflow, as JAX's scatter
    short = pack_joint_output(
        transducer_joint(_t(f), _t(g), _t(f_len), _t(g_len)), _t(f_len),
        _t(g_len), _t(batch_offset), packed - 5)
    np.testing.assert_array_equal(short.numpy(), np.stack(rows)[:-5])
    with pytest.raises(ValueError, match="pack_output"):
        TransducerJoint(pack_output=True)(_t(f), _t(g), _t(f_len), _t(g_len))


def test_transducer_joint_dropout_draws_from_the_generator():
    f = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(0))
    g = torch.randn(2, 30, 16, generator=torch.Generator().manual_seed(1))
    joint = TransducerJoint(dropout=True, dropout_prob=0.3)
    a = joint(f, g, torch.tensor([40, 40]), torch.tensor([30, 30]),
              generator=torch.Generator().manual_seed(2))
    b = joint(f, g, torch.tensor([40, 40]), torch.tensor([30, 30]),
              generator=torch.Generator().manual_seed(2))
    plain = transducer_joint(f, g)
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], plain[kept] / 0.7)
    n = a.numel()
    assert abs(float((~kept).float().mean()) - 0.3) < 6 * (0.3 * 0.7 / n) ** 0.5
    with pytest.raises(ValueError, match="generator"):
        joint(f, g, torch.tensor([40, 40]), torch.tensor([30, 30]))
