"""The cached, thd (packed, ``cu_seqlens``) and 2-d rope forms of
``apex_tpu_torch.ops.rope`` against ``apex_tpu.ops.rope`` on the same
numpy inputs: outputs within 1e-6 (fp32; 2**-7 relative in bf16), and the
gradient of a random projection of the output against ``jax.grad``'s
within 1e-6.  Each form rotates only the first ``d2`` channels where
``d2 < d``."""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import rope

TOL = dict(rtol=0, atol=1e-6)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _check(port_fn, jax_fn, t, rest, dtype=torch.float32):
    """Output and d<out, ct>/dt of both packages; ``rest`` the other
    arguments, numpy (ints as they are)."""
    import jax
    import jax.numpy as jnp

    ct = _np(t.shape, 99)
    tt = torch.from_numpy(t).to(dtype).requires_grad_()
    out = port_fn(tt, *[torch.from_numpy(r) for r in rest])
    (out.float() * torch.from_numpy(ct)).sum().backward()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt = jnp.asarray(t).astype(jdt)
    jrest = [jnp.asarray(r) for r in rest]
    ref = jax_fn(jt, *jrest)
    g = jax.grad(lambda a: (jax_fn(a, *jrest).astype(jnp.float32)
                            * ct).sum())(jt)
    assert out.dtype == dtype and tuple(out.shape) == t.shape
    tol = TOL if dtype == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-2)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(tt.grad.float().numpy(),
                               np.asarray(g.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("d2", [16, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cached_matches_jax(d2, dtype):
    from apex_tpu.ops import rope as jrope

    s, b, h, d = 12, 2, 3, 16
    freqs = _np((s, 1, 1, d2), 1, 3.0)
    _check(rope.fused_apply_rotary_pos_emb_cached,
           jrope.fused_apply_rotary_pos_emb_cached, _np((s, b, h, d), 2),
           [np.cos(freqs), np.sin(freqs)], dtype)
    # the cached form of a table is the freqs form
    t = torch.from_numpy(_np((s, b, h, d), 3))
    f = torch.from_numpy(freqs)
    torch.testing.assert_close(
        rope.fused_apply_rotary_pos_emb_cached(t, f.cos(), f.sin()),
        rope.fused_apply_rotary_pos_emb(t, f), rtol=0, atol=0)


@pytest.mark.parametrize("d2", [16, 8])
def test_thd_matches_jax(d2):
    from apex_tpu.ops import rope as jrope

    cu = np.array([0, 5, 6, 13, 20], np.int32)     # lengths 5, 1, 7, 7
    freqs = _np((8, 1, 1, d2), 4, 3.0)
    _check(rope.fused_apply_rotary_pos_emb_thd,
           jrope.fused_apply_rotary_pos_emb_thd, _np((20, 3, 16), 5),
           [cu, freqs])


def test_thd_restarts_each_sequence_at_position_0():
    """Each packed sequence alone through the sbhd form gives its rows."""
    cu = torch.tensor([0, 5, 6, 13])
    t = torch.from_numpy(_np((13, 2, 8), 6))
    f = torch.from_numpy(_np((7, 1, 1, 8), 7))
    out = rope.fused_apply_rotary_pos_emb_thd(t, cu, f)
    for a, b in zip(cu[:-1].tolist(), cu[1:].tolist()):
        alone = rope.fused_apply_rotary_pos_emb(t[a:b, None], f[:b - a])
        torch.testing.assert_close(out[a:b], alone[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("img", [(3, 4), (4, 4)])
def test_2d_matches_jax(img):
    from apex_tpu.ops import rope as jrope

    ih, iw = img
    b, h, d = 2, 3, 16
    fh, fw = _np((1, 5, 1, d // 2), 8, 3.0), _np((1, 6, 1, d // 2), 9, 3.0)
    _check(lambda t, *r: rope.fused_apply_rotary_pos_emb_2d(t, ih, iw, *r),
           lambda t, *r: jrope.fused_apply_rotary_pos_emb_2d(t, ih, iw, *r),
           _np((b, ih * iw, h, d), 10),
           [np.cos(fh), np.sin(fh), np.cos(fw), np.sin(fw)])


def test_2d_refuses_a_wrong_sequence_length():
    t = torch.zeros(1, 11, 1, 8)
    c = torch.ones(1, 4, 1, 4)
    with pytest.raises(ValueError, match="img_h\\*img_w"):
        rope.fused_apply_rotary_pos_emb_2d(t, 3, 4, c, c, c, c)
