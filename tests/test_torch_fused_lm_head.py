"""apex_tpu_torch.ops.fused_lm_head against apex_tpu.ops.fused_lm_head.

The same numpy inputs (fixed seeds) go through the JAX function, whose
Pallas forward runs in interpret mode (``APEX_TPU_KERNELS=interpret``, 512
tokens and hidden 128 so that ``_kernel_ok`` holds), and through the port's
plain version on the CPU.  The loss comes from ``fused_lm_head_loss`` on
both sides, ``lse`` from the JAX ``_pallas_fused_fwd`` and the port's
``fused_lm_head_fwd``.  The vocabularies are not multiples of either side's
tile, and the labels include ``-100`` and ``vocab``.  Tolerance: loss and
lse at ``atol = rtol = 1e-5`` in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import fused_lm_head as jlh
from apex_tpu_torch.ops import fused_lm_head as tlh

T, HID = 512, 128


def _inputs(vocab, lead=(T,), seed=0):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((*lead, HID)) * 0.5).astype(np.float32)
    e = (rng.standard_normal((vocab, HID)) * 0.5).astype(np.float32)
    lab = rng.integers(0, vocab, lead).astype(np.int32)
    flat = lab.reshape(-1)
    flat[::7] = -100                  # an ignore id
    flat[3::11] = vocab               # one past the vocab (its padded tail)
    flat[5::13] = vocab - 1           # the last real column
    return h, e, lab


@pytest.mark.parametrize("vocab", [1000, 1537])
def test_forward_matches_jax(vocab, monkeypatch):
    h, e, lab = _inputs(vocab)
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    assert jlh._kernel_ok(T, HID, 512)
    ref_loss = np.asarray(jlh.fused_lm_head_loss(
        jnp.asarray(h), jnp.asarray(e), jnp.asarray(lab)))
    _, ref_lse = jlh._pallas_fused_fwd(jnp.asarray(h), jnp.asarray(e),
                                       jnp.asarray(lab), 512, 1536)
    loss, lse = tlh.fused_lm_head_fwd(torch.from_numpy(h), torch.from_numpy(e),
                                      torch.from_numpy(lab))
    assert loss.dtype == torch.float32 and tuple(loss.shape) == (T,)
    np.testing.assert_allclose(loss.numpy(), ref_loss, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5,
                               rtol=1e-5)
    # an out-of-range label's loss is exactly its lse (target logit 0)
    out = (lab < 0) | (lab >= vocab)
    assert out.sum() > 0
    np.testing.assert_array_equal(loss.numpy()[out], lse.numpy()[out])


def test_leading_shape_and_reference(monkeypatch):
    """A [s, b] leading shape (the model's labels.T) against the JAX
    materialized reference, and the port's reference function."""
    h, e, lab = _inputs(700, lead=(16, 4), seed=1)
    ref = np.asarray(jlh.lm_head_loss_reference(
        jnp.asarray(h), jnp.asarray(e), jnp.asarray(lab)))
    th, te, tl = (torch.from_numpy(a) for a in (h, e, lab))
    loss = tlh.fused_lm_head_loss(th, te, tl)
    assert tuple(loss.shape) == (16, 4)
    np.testing.assert_allclose(loss.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        tlh.lm_head_loss_reference(th, te, tl).numpy(), loss.numpy())


def test_bf16_operands_accumulate_in_fp32():
    """bf16 hidden and table: the products are exact in fp32, as the JAX
    reference's preferred_element_type=float32 computes them."""
    h, e, lab = _inputs(300, seed=2)
    hb, eb = (jnp.asarray(a, jnp.bfloat16) for a in (h, e))
    ref = np.asarray(jlh.lm_head_loss_reference(hb, eb, jnp.asarray(lab)))
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    loss = tlh.fused_lm_head_loss(to_t(hb), to_t(eb), torch.from_numpy(lab))
    np.testing.assert_allclose(loss.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_label_shape_must_match():
    h, e, lab = _inputs(64, lead=(8,))
    with pytest.raises(ValueError, match="labels shape"):
        tlh.fused_lm_head_loss(torch.from_numpy(h), torch.from_numpy(e),
                               torch.from_numpy(lab[:4]))


def test_plain_version_is_differentiable_on_cpu():
    h, e, lab = _inputs(96, lead=(32,), seed=3)
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    tlh.fused_lm_head_loss(th, te, torch.from_numpy(lab)).mean().backward()
    assert torch.isfinite(th.grad).all() and th.grad.abs().sum() > 0
    assert torch.isfinite(te.grad).all() and te.grad.abs().sum() > 0


@pytest.mark.parametrize("tokens,vocab", [(1, 1), (512, 32000), (8192, 32000),
                                          (8192, 128256), (37, 1000)])
def test_vocab_split_covers_the_vocab_once(tokens, vocab):
    """The kernel's chunks: multiples of the 128-column tile, none empty,
    together covering the vocab."""
    chunk, nsplit = tlh.vocab_split(tokens, vocab, sms=132)
    assert chunk % 128 == 0 and nsplit >= 1
    assert chunk * (nsplit - 1) < vocab <= chunk * nsplit


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version on the card (chip_smoke.py
    runs the full grid of variants); skipped on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, e, lab = (torch.from_numpy(a).cuda() for a in _inputs(1000))
    with torch.no_grad():
        loss, lse = tlh.fused_lm_head_fwd(h, e, lab)
        rloss, rlse = tlh._plain_forward(h, e, lab)
    torch.testing.assert_close(loss, rloss, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-5)
