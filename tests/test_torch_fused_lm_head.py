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
                                          (8192, 128256), (37, 1000), (1, 64),
                                          (129, 50257), (8192, 50257)])
def test_vocab_tiles_cover_the_vocab_once(tokens, vocab):
    """The forward kernels' workspace: one (max, sum, target) triple per
    token and 256-column vocab tile, the tiles none empty and together
    covering the vocab; and the backward's dlog width Vp: the vocab rounded
    up to 64, so every row is a whole number of the tensor maps' 128-byte
    boxes of 16-bit values."""
    tiles = tlh.vocab_tiles(vocab)
    assert 256 * (tiles - 1) < vocab <= 256 * tiles
    ws = tlh._workspace(tokens, vocab, torch.device("meta"))
    assert ws.shape == (3, tiles, tokens) and ws.dtype == torch.float32
    vp = tlh.padded_vocab(vocab)
    assert (vp * 2) % 128 == 0 and vocab <= vp < vocab + 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_matches_plain_version_on_card(dtype):
    """The CUDA kernel against its plain version on the card (chip_smoke.py
    runs the full grid of variants): fp32 on the CUDA-core kernel at 1e-5
    + 1e-5 |ref|, the two 16-bit types on the TMA + wgmma logits at
    chip_smoke.py's 1e-4 + 1e-5 |ref| (fp32 sums of exponentials in another
    order, on the hardware exp2); an out-of-range label's loss is its lse
    exactly.  Skipped on a host without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    h, e, lab = (torch.from_numpy(a).cuda() for a in _inputs(1000))
    h, e = h.to(dt), e.to(dt)
    with torch.no_grad():
        loss, lse = tlh.fused_lm_head_fwd(h, e, lab)
        rloss, rlse = tlh._plain_forward(h, e, lab)
    atol = 1e-5 if dtype == "float32" else 1e-4
    torch.testing.assert_close(loss, rloss, atol=atol, rtol=1e-5)
    torch.testing.assert_close(lse, rlse, atol=atol, rtol=1e-5)
    out = (lab < 0) | (lab >= 1000)
    assert torch.equal(loss[out], lse[out])


# ---------------------------------------------------------------------------
# the backward (training slice)
# ---------------------------------------------------------------------------


def _cotangent(lead=(T,), seed=30):
    """A non-uniform per-token cotangent of both signs."""
    return (np.random.default_rng(seed).standard_normal(lead) / 64).astype(
        np.float32)


@pytest.mark.parametrize("vocab", [1000, 1537])
def test_backward_matches_jax_grad(vocab, monkeypatch):
    """dH and dE of the port's plain backward (through ``_HeadFunction``
    on the CPU) against ``jax.vjp`` of the JAX ``fused_lm_head_loss`` (its
    Pallas dH and dE kernels in interpret mode) under a non-uniform
    cotangent, with labels -100 and vocab and a vocabulary off the tile.
    fp32 at atol = rtol = 1e-5."""
    import jax

    h, e, lab = _inputs(vocab, seed=31)
    g = _cotangent()
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    assert jlh._kernel_ok(T, HID, 512)
    _, vjp = jax.vjp(lambda h, e: jlh.fused_lm_head_loss(h, e, jnp.asarray(lab)),
                     jnp.asarray(h), jnp.asarray(e))
    ref_dh, ref_de = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    tlh.fused_lm_head_loss(th, te, torch.from_numpy(lab)).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(th.grad.numpy(), ref_dh, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), ref_de, atol=1e-5, rtol=1e-5)


def test_out_of_range_labels_put_no_minus_one():
    """A label outside [0, vocab) matches no column: its token's dlog is
    the softmax times g alone, so the gradient equals a materialised
    computation whose one-hot ignores those labels."""
    vocab = 300
    h, e, lab = _inputs(vocab, lead=(64,), seed=32)
    g = _cotangent((64,), seed=33)
    th, te, tl, tg = (torch.from_numpy(a) for a in (h, e, lab, g))
    _, lse = tlh.fused_lm_head_fwd(th, te, tl)
    dh, de = tlh.fused_lm_head_bwd(th, te, tl, lse, tg)
    logits = h.astype(np.float64) @ e.astype(np.float64).T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    onehot = np.zeros_like(p)
    ok = (lab >= 0) & (lab < vocab)
    onehot[np.arange(64)[ok], lab[ok]] = 1.0
    dlog = (p - onehot) * g[:, None]
    assert (~ok).sum() > 0
    np.testing.assert_allclose(dh.numpy(), dlog @ e, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(de.numpy(), dlog.T @ h, atol=1e-5, rtol=1e-5)


def test_head_function_gradcheck():
    """``_HeadFunction`` in float64 against finite differences, labels
    -100 and vocab included, under a non-uniform cotangent."""
    rng = np.random.default_rng(34)
    h = torch.from_numpy(rng.standard_normal((7, 16))).requires_grad_()
    e = torch.from_numpy(rng.standard_normal((11, 16))).requires_grad_()
    lab = torch.tensor([0, 3, -100, 11, 10, 5, 2])
    w = torch.from_numpy(rng.standard_normal(7))
    assert torch.autograd.gradcheck(
        lambda h, e: tlh.fused_lm_head_loss(h, e, lab) * w, (h, e))


def test_tied_table_gradient_sums_both_uses():
    """A table used as the embedding and as the head gets both gradients
    (the tied Llama head)."""
    h, e, lab = _inputs(50, lead=(8,), seed=35)
    te = torch.from_numpy(e).requires_grad_()
    ids = torch.from_numpy(lab.clip(0, 49)).long()
    x = torch.nn.functional.embedding(ids, te) + torch.from_numpy(h)
    tlh.fused_lm_head_loss(x, te, torch.from_numpy(lab)).sum().backward()
    te2 = torch.from_numpy(e).requires_grad_()
    x2 = torch.nn.functional.embedding(ids, te2) + torch.from_numpy(h)
    logits = x2 @ te2.t()
    lse = torch.logsumexp(logits, -1)
    tl = torch.from_numpy(lab).long()
    ok = (tl >= 0) & (tl < 50)
    tgt = torch.where(ok, logits.gather(1, tl.clamp(0, 49)[:, None])[:, 0], 0.0)
    (lse - tgt).sum().backward()
    np.testing.assert_allclose(te.grad.numpy(), te2.grad.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    h, e, lab = (torch.from_numpy(a) for a in _inputs(64, lead=(8,)))
    with pytest.raises(ValueError, match="CUDA"):
        tlh._BwdLaunch(h, e, lab, torch.zeros(8), torch.ones(8))


# ---------------------------------------------------------------------------
# the backward kernels' host side: operand checks, library names
# ---------------------------------------------------------------------------


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


_BAD_OPERANDS = {
    "hidden_not_multiple_of_8": (
        lambda: (torch.zeros(8, 12, dtype=torch.bfloat16),
                 torch.zeros(64, 12, dtype=torch.bfloat16)),
        ValueError, "multiple of 8"),
    "embedding_off_16_bytes": (
        lambda: (torch.zeros(8, 128, dtype=torch.bfloat16),
                 _misaligned((64, 128), torch.bfloat16)),
        ValueError, "16 bytes"),
    "hidden_off_16_bytes": (
        lambda: (_misaligned((8, 128), torch.float16),
                 torch.zeros(64, 128, dtype=torch.float16)),
        ValueError, "16 bytes"),
    "hidden_not_contiguous": (
        lambda: (torch.zeros(128, 8, dtype=torch.bfloat16).t(),
                 torch.zeros(64, 128, dtype=torch.bfloat16)),
        ValueError, "contiguous"),
    "hidden_sizes_differ": (
        lambda: (torch.zeros(8, 128, dtype=torch.bfloat16),
                 torch.zeros(64, 136, dtype=torch.bfloat16)),
        ValueError, "one hidden size"),
    "empty_vocab": (
        lambda: (torch.zeros(8, 128, dtype=torch.float16),
                 torch.zeros(0, 128, dtype=torch.float16)),
        ValueError, "V >= 1"),
    "mixed_dtypes": (
        lambda: (torch.zeros(8, 128, dtype=torch.bfloat16),
                 torch.zeros(64, 128, dtype=torch.float16)),
        TypeError, "dtype"),
    "float64": (
        lambda: (torch.zeros(8, 128, dtype=torch.float64),
                 torch.zeros(64, 128, dtype=torch.float64)),
        TypeError, "fp32, bf16 or fp16"),
}


@pytest.mark.parametrize("op", ["forward", "backward"])
@pytest.mark.parametrize("case", sorted(_BAD_OPERANDS))
def test_kernel_wrappers_refuse_what_the_tensor_maps_cannot_read(case, op):
    """The wrappers check dtype, shape and layout before the device, so a
    hidden size off 8 or differing between the operands, an empty vocab,
    an operand off 16 bytes or not contiguous, or mixed dtypes raise on
    any host, before anything is built or launched."""
    make, err, match = _BAD_OPERANDS[case]
    h, e = make()
    lab = torch.zeros(h.shape[0], dtype=torch.int32)
    with pytest.raises(err, match=match):
        if op == "forward":
            tlh._kernel_forward(h, e, lab)
        else:
            tlh._BwdLaunch(h, e, lab, torch.zeros(h.shape[0]),
                           torch.ones(h.shape[0]))


@pytest.mark.parametrize("source", ["fused_lm_head_bwd.cu",
                                    "fused_lm_head_fwd.cu",
                                    "layer_norm_fwd.cu"])
def test_a_header_edit_renames_every_library(source, tmp_path, monkeypatch):
    """Every csrc/*.cuh enters each library's name: editing the new
    mainloop header builds every source anew, not only the one that
    includes it."""
    import shutil

    from apex_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._target(source)
    with open(csrc / "wgmma_sm90.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _build._target(source)
    assert before != after and before.parent == after.parent


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("tokens,vocab,hid", [(T, 1000, HID), (129, 1537, 136)])
def test_backward_kernels_match_plain_version_on_card(dtype, tokens, vocab,
                                                      hid):
    """The dH and dE kernels against the plain backward on the card, fp32
    and the two 16-bit types, T and V off every tile edge (chip_smoke.py
    runs the full grid); two calls give the same bits.  fp32 at atol =
    rtol = 1e-5; bf16/fp16 at 4 units of the dtype times max|ref| absolute
    and 2 units relative (the kernels round dlog to the dtype); skipped on
    a host without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(36)
    dt = getattr(torch, dtype)
    h = torch.from_numpy(rng.standard_normal((tokens, hid)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((vocab, hid)) * hid ** -0.5
                          ).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, vocab, tokens).astype(np.int32))
    lab[::7] = -100
    h, e, lab = h.to(dt).cuda(), e.to(dt).cuda(), lab.cuda()
    g = torch.from_numpy(_cotangent((tokens,))).cuda()
    if dtype == "float16":
        # the fp16 amp path's cotangent, randn times its loss scale 2^15
        # over the tokens, which keeps dlog in fp16's normal range
        g = g * (64 * 2.0 ** 15 / tokens)
    with torch.no_grad():
        _, lse = tlh.fused_lm_head_fwd(h, e, lab)
        ours = tlh.fused_lm_head_bwd(h, e, lab, lse, g)
        again = tlh.fused_lm_head_bwd(h, e, lab, lse, g)
        ref = tlh._plain_backward(h, e, lab, lse, g)
    unit = {"float32": 0.0, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}[dtype]
    for a, b, c in zip(ours, ref, again):
        assert torch.equal(a, c)
        if dtype == "float32":
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        else:
            torch.testing.assert_close(
                a.float(), b.float(), rtol=2 * unit,
                atol=4 * unit * float(b.float().abs().max()))
