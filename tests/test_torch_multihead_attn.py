"""apex_tpu_torch.contrib.multihead_attn and .fmha against their JAX twins
(the cases of ``tests/test_multihead_attn.py``, then each against JAX).

The same seeded numpy inputs go through the JAX module, whose flash and
softmax routes run their Pallas kernels in interpret mode
(``APEX_TPU_KERNELS=interpret``; d = 64, s a multiple of 8 for the flash
kernels, sk = 128 for the softmax kernel, so JAX's gates hold), and
through the port's plain versions on the CPU, with the JAX weights carried
over by ``multihead_attn_params_from_jax``.

Tolerances, fp32: outputs ``atol 1e-5`` (JAX's own fast-vs-default limit;
measured 6e-7), gradients ``atol 1e-5`` over values of order 1, the
softmax ``atol 1e-6``; the fp32-promoted bf16 norm-add ``atol 1e-5``;
``fmha_varlen`` against per-sequence attention ``atol 2e-5`` (JAX's).
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.fmha import (
    FMHA,
    fmha_varlen,
    segment_ids_from_cu_seqlens,
)
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    fast_mask_softmax_dropout_func,
)
from apex_tpu_torch.models.convert import multihead_attn_params_from_jax
from apex_tpu_torch.ops.flash_attention import mha_reference

S, B, E, H = 32, 2, 128, 2          # d = 64: the JAX flash kernel's gate
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")


def _x(seed=0, s=S, b=B, e=E):
    return np.random.default_rng(seed).standard_normal((s, b, e)).astype(
        np.float32)


def _pad(b=B, s=S, lengths=(24, 0)):
    """1 = padded key; a length of 0 pads a whole batch row."""
    pad = np.ones((b, s), np.int32)
    for i, n in enumerate(lengths):
        pad[i, :n] = 0
    return pad


def _jax_self(x, seed=0, **kw):
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as J

    m = J(E, H, **kw)
    params = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return m, params, jax.tree.map(np.asarray, params)


def _port(cls, tree, *args, **kw):
    m = cls(*args, device="cpu", **kw)
    m.load_state_dict(multihead_attn_params_from_jax(tree))
    return m


def _assert_flash_kernel_runs(sq, sk):
    """JAX's flash call at these lengths takes its Pallas kernel, not the
    jnp reference."""
    import jax.numpy as jnp

    from apex_tpu.ops import flash_attention as jfa

    q = jnp.zeros((1, H, sq, E // H))
    k = jnp.zeros((1, H, sk, E // H))
    assert jfa._kernel_ok(q, k, jfa._DEFAULT_BLOCK_Q, jfa._DEFAULT_BLOCK)


CONFIGS = {
    "packed": dict(),
    "bias_norm_add": dict(bias=True, include_norm_add=True),
    "separate_qkv_bias": dict(separate_qkv_params=True, bias=True),
}


@pytest.mark.parametrize("impl", ["fast", "default"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_self_attn_matches_jax(impl, config):
    """Each configuration on both routes, with a key-padding mask whose
    second batch row is all padding: the flash route gives that row the
    output of a zero context, the materialized route the mean of v; the
    port gives what JAX gives on each."""
    import jax.numpy as jnp

    _assert_flash_kernel_runs(S, S)
    x, pad = _x(), _pad()
    jm, params, tree = _jax_self(x, impl=impl, **CONFIGS[config])
    want = np.asarray(jm.apply(params, jnp.asarray(x),
                               key_padding_mask=jnp.asarray(pad),
                               is_training=False))
    m = _port(SelfMultiheadAttn, tree, E, H, impl=impl, **CONFIGS[config])
    with torch.no_grad():
        got = m(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad),
                is_training=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fully_padded_row_differs_between_routes():
    """Pinned: on a batch row with every key padded, ``impl="fast"`` (flash,
    no visible key) gives the output projection of a zero context, and
    ``impl="default"`` the projection of the mean of v (a uniform softmax
    over the -10000 fill); both equal JAX's (above)."""
    x = torch.from_numpy(_x())
    pad = torch.from_numpy(_pad())
    _, _, tree = _jax_self(x.numpy())
    fast = _port(SelfMultiheadAttn, tree, E, H, impl="fast")
    default = _port(SelfMultiheadAttn, tree, E, H, impl="default")
    with torch.no_grad():
        f = fast(x, key_padding_mask=pad, is_training=False)
        d = default(x, key_padding_mask=pad, is_training=False)
        v = torch.nn.functional.linear(x, fast.in_proj_weight)[..., 2 * E:]
        mean_v = v[:, 1].mean(0)
        want_d = torch.nn.functional.linear(mean_v, fast.out_proj_weight)
    assert torch.equal(f[:, 1], torch.zeros_like(f[:, 1]))
    np.testing.assert_allclose(d[:, 1].numpy(),
                               want_d.expand(S, E).numpy(), **TOL)
    np.testing.assert_allclose(f[:, 0].numpy(), d[:, 0].numpy(), **TOL)


def test_fast_matches_default_and_manual_reference():
    """JAX's tests: fast == default, both == the dense attention computed
    the long way, unmasked."""
    x = torch.from_numpy(_x())
    _, _, tree = _jax_self(x.numpy())
    fast = _port(SelfMultiheadAttn, tree, E, H, impl="fast")
    default = _port(SelfMultiheadAttn, tree, E, H, impl="default")
    with torch.no_grad():
        out_f = fast(x, is_training=False)
        out_d = default(x, is_training=False)
        y = x @ fast.in_proj_weight.T
        q, k, v = (t.reshape(S, B, H, E // H).permute(1, 2, 0, 3)
                   for t in y.chunk(3, -1))
        ctx = mha_reference(q, k, v).permute(2, 0, 1, 3).reshape(S, B, E)
        ref = ctx @ fast.out_proj_weight.T
    np.testing.assert_allclose(out_f.numpy(), out_d.numpy(), **TOL)
    np.testing.assert_allclose(out_f.numpy(), ref.numpy(), **TOL)


def test_padded_keys_do_not_reach_the_output():
    x = _x()
    pad = _pad(lengths=(24, 24))
    _, _, tree = _jax_self(x)
    m = _port(SelfMultiheadAttn, tree, E, H)
    x2 = x.copy()
    x2[28] += 3.0
    with torch.no_grad():
        a = m(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad),
              is_training=False)
        b = m(torch.from_numpy(x2), key_padding_mask=torch.from_numpy(pad),
              is_training=False)
    np.testing.assert_allclose(a[:24].numpy(), b[:24].numpy(), **TOL)


def test_additive_mask_matches_binary_and_jax():
    """``mask_additive`` (default route, -10000 where padded) against the
    binary mask, and against JAX's additive module."""
    import jax.numpy as jnp

    x = _x()
    binary = _pad(lengths=(20, 28))
    additive = np.where(binary == 1, -10000.0, 0.0).astype(np.float32)
    _, _, tree = _jax_self(x, impl="default")
    jm, params, tree_add = _jax_self(x, impl="default", mask_additive=True,
                                     bias=True)
    params = {"params": dict(params["params"])}
    for name in ("in_proj_weight", "out_proj_weight"):
        params["params"][name] = jnp.asarray(tree["params"][name])
        tree_add["params"][name] = tree["params"][name]
    want = np.asarray(jm.apply(params, jnp.asarray(x),
                               key_padding_mask=jnp.asarray(additive),
                               is_training=False))
    m_bin = _port(SelfMultiheadAttn, tree, E, H, impl="default")
    m_add = _port(SelfMultiheadAttn, tree_add, E, H, impl="default",
                  mask_additive=True, bias=True)
    with torch.no_grad():
        out_bin = m_bin(torch.from_numpy(x),
                        key_padding_mask=torch.from_numpy(binary),
                        is_training=False)
        out_add = m_add(torch.from_numpy(x),
                        key_padding_mask=torch.from_numpy(additive),
                        is_training=False)
    np.testing.assert_allclose(out_add.numpy(), out_bin.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out_add.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="additive"):
        SelfMultiheadAttn(E, H, mask_additive=True, include_norm_add=True,
                          device="cpu")


def test_norm_add_is_a_residual_around_the_attention():
    x = torch.from_numpy(_x(s=8, b=1))
    _, _, tree = _jax_self(x.numpy(), include_norm_add=True)
    m = _port(SelfMultiheadAttn, tree, E, H, include_norm_add=True)
    with torch.no_grad():
        out = m(x, is_training=False)
        m.out_proj_weight.zero_()
        res = m(x, is_training=False)
    assert torch.equal(res, x)
    assert not torch.allclose(out, x)


def test_separate_qkv_parameter_names():
    m = SelfMultiheadAttn(E, H, separate_qkv_params=True, bias=True,
                          device="cpu")
    names = set(dict(m.named_parameters()))
    assert {"q_weight", "k_weight", "v_weight", "q_bias", "k_bias", "v_bias",
            "out_proj_weight", "out_proj_bias"} == names
    packed = SelfMultiheadAttn(E, H, include_norm_add=True, device="cpu")
    assert set(dict(packed.named_parameters())) == {
        "in_proj_weight", "out_proj_weight", "lyr_nrm_gamma_weights",
        "lyr_nrm_beta_weights"}
    assert packed.in_proj_weight.shape == (3 * E, E)


def test_bf16_input_norm_add_promotes_like_jax():
    """bf16 input, fp32 parameters, ``include_norm_add``: the normalized
    stream times the fp32 gamma is fp32, so the projections, the flash
    call (q, k, v fp32) and the output are fp32, as in JAX."""
    import jax.numpy as jnp

    x = _x()
    jm, params, tree = _jax_self(x, include_norm_add=True, bias=True)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jm.apply(params, xb, is_training=False)
    assert want.dtype == jnp.float32
    m = _port(SelfMultiheadAttn, tree, E, H, include_norm_add=True, bias=True)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    with torch.no_grad():
        got = m(xt, is_training=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_gradients_match_jax(impl):
    """The input's and every parameter's gradient of ``sum(out * ct)``,
    with padding, against JAX's (its flash backward in interpret mode on
    the fast route)."""
    import jax
    import jax.numpy as jnp

    x, pad = _x(), _pad(lengths=(24, 30))
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jm, params, tree = _jax_self(x, impl=impl, bias=True,
                                 include_norm_add=True)

    def loss(p, xx):
        out = jm.apply(p, xx, key_padding_mask=jnp.asarray(pad),
                       is_training=False)
        return jnp.sum(out * jnp.asarray(ct))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    m = _port(SelfMultiheadAttn, tree, E, H, impl=impl, bias=True,
              include_norm_add=True)
    xt = torch.from_numpy(x).requires_grad_()
    (m(xt, key_padding_mask=torch.from_numpy(pad), is_training=False)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(gp["params"][name]),
                                   atol=1e-5 * max(1.0, float(
                                       np.abs(gp["params"][name]).max())),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_encdec_matches_jax(impl):
    """sq 32 against sk 48 (the flash kernels' sq != sk non-causal case),
    with key padding and a bias."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.multihead_attn import EncdecMultiheadAttn as J

    _assert_flash_kernel_runs(S, 48)
    q, kv = _x(1), _x(2, s=48)
    pad = _pad(s=48, lengths=(40, 48))
    jm = J(E, H, impl=impl, bias=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv))
    want = np.asarray(jm.apply(params, jnp.asarray(q), jnp.asarray(kv),
                               key_padding_mask=jnp.asarray(pad),
                               is_training=False))
    m = _port(EncdecMultiheadAttn, jax.tree.map(np.asarray, params), E, H,
              impl=impl, bias=True)
    with torch.no_grad():
        got = m(torch.from_numpy(q), torch.from_numpy(kv),
                key_padding_mask=torch.from_numpy(pad), is_training=False)
    assert got.shape == (S, B, E)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("form", ["none", "binary", "additive"])
def test_mask_softmax_dropout_func_matches_jax(form):
    """The three forms on ``[b * h, 16, 128]`` scores (JAX's Pallas
    softmax in interpret mode); padded keys get 0, rows sum to 1."""
    import jax.numpy as jnp

    from apex_tpu.contrib.multihead_attn import (
        fast_mask_softmax_dropout_func as jf,
    )

    b, h, sq, sk = 2, 2, 16, 128
    scores = np.random.default_rng(4).standard_normal(
        (b * h, sq, sk)).astype(np.float32)
    pad = np.zeros((b, sk), np.int32)
    pad[:, 100:] = 1
    mask = {"none": None, "binary": pad,
            "additive": np.where(pad == 1, -10000.0, 0.0).astype(np.float32)
            }[form]
    additive = form == "additive"
    want = np.asarray(jf(False, h, jnp.asarray(scores),
                         None if mask is None else jnp.asarray(mask),
                         additive, 0.0))
    got = fast_mask_softmax_dropout_func(
        False, h, torch.from_numpy(scores),
        None if mask is None else torch.from_numpy(mask), additive, 0.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    if mask is not None:
        assert torch.all(got.reshape(b, h, sq, sk)[..., 100:] == 0)


def test_mask_softmax_dropout_keeps_the_expected_share():
    """Training with dropout 0.25: kept probabilities scaled by 4/3, the
    dropped share within 6 binomial deviations; the same generator state
    gives the same draw; no generator raises."""
    scores = torch.randn(8, 32, 128, generator=torch.Generator().manual_seed(5))
    probs = fast_mask_softmax_dropout_func(False, 4, scores, None, False, 0.0)
    a = fast_mask_softmax_dropout_func(
        True, 4, scores, None, False, 0.25,
        generator=torch.Generator().manual_seed(1))
    b = fast_mask_softmax_dropout_func(
        True, 4, scores, None, False, 0.25,
        generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], probs[kept] / 0.75)
    n = a.numel()
    assert abs(float((~kept).float().mean()) - 0.25) < 6 * (
        0.25 * 0.75 / n) ** 0.5
    with pytest.raises(ValueError, match="generator"):
        fast_mask_softmax_dropout_func(True, 4, scores, None, False, 0.25)


def test_flash_dropout_keep_bits_equal_jax(monkeypatch):
    """Attention dropout on the flash route: the seed drawn from the
    module's generator, handed to JAX in place of its ``randint``, gives
    JAX's output (its in-kernel counter-hash dropout): the same keep
    bits."""
    import jax
    import jax.numpy as jnp

    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        dropout_seed,
    )

    x, pad = _x(), _pad(lengths=(24, 32))
    jm, params, tree = _jax_self(x, dropout=0.2)
    seed = dropout_seed(torch.Generator().manual_seed(5))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(seed, jnp.int32))
    want = np.asarray(jm.apply(params, jnp.asarray(x),
                               key_padding_mask=jnp.asarray(pad),
                               is_training=True,
                               rngs={"dropout": jax.random.PRNGKey(1)}))
    m = _port(SelfMultiheadAttn, tree, E, H, dropout=0.2)
    m.generator = torch.Generator().manual_seed(5)
    with torch.no_grad():
        got = m(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad))
        det = m(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad),
                is_training=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(got.numpy() - det.numpy()).max() > 1e-2
    m.generator = None
    with pytest.raises(ValueError, match="generator"):
        m(torch.from_numpy(x))


# ---------------------------------------------------------------------------
# fmha
# ---------------------------------------------------------------------------


def test_segment_ids_from_cu_seqlens():
    seg = segment_ids_from_cu_seqlens(torch.tensor([0, 3, 7], dtype=torch.int32),
                                      8)
    assert seg.dtype == torch.int32
    assert seg.tolist() == [1, 1, 1, 2, 2, 2, 2, 0]


@pytest.mark.parametrize("causal", [True, False])
def test_fmha_varlen_matches_per_sequence_and_jax(causal):
    """Packed ``[total, 3, h, d]`` attention against dense attention per
    sequence (JAX's test) and against JAX's ``fmha_varlen`` (its flash
    kernel in interpret mode), with a padded tail past ``cu[-1]``."""
    import jax.numpy as jnp

    from apex_tpu.contrib.fmha import fmha_varlen as jax_varlen

    h, d = 2, 64
    lens = [48, 80]
    total = sum(lens) + 16
    qkv = np.random.default_rng(6).standard_normal(
        (total, 3, h, d)).astype(np.float32)
    cu = np.cumsum([0] + lens).astype(np.int32)
    _assert_flash_kernel_runs(total, total)
    want = np.asarray(jax_varlen(jnp.asarray(qkv), jnp.asarray(cu),
                                 causal=causal))
    t = torch.from_numpy(qkv)
    out = fmha_varlen(t, torch.from_numpy(cu), causal=causal)
    assert out.shape == (total, h, d)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    start = 0
    for n in lens:
        q, k, v = (t[start:start + n, i].transpose(0, 1)[None]
                   for i in range(3))
        ref = mha_reference(q, k, v, causal=causal)[0].transpose(0, 1)
        np.testing.assert_allclose(out[start:start + n].numpy(), ref.numpy(),
                                   rtol=2e-5, atol=2e-5)
        start += n
    mod = FMHA(h, causal=causal)
    assert torch.equal(mod(t, torch.from_numpy(cu), max_s=80), out)


def test_fmha_varlen_gradient_matches_per_sequence():
    """The packed call's qkv gradient equals the per-sequence calls'."""
    h, d = 2, 64
    lens = [24, 40]
    qkv = torch.randn(sum(lens), 3, h, d,
                      generator=torch.Generator().manual_seed(7))
    ct = torch.randn(sum(lens), h, d, generator=torch.Generator().manual_seed(8))
    cu = torch.tensor([0, 24, 64])
    packed = qkv.clone().requires_grad_()
    (fmha_varlen(packed, cu) * ct).sum().backward()
    loop = qkv.clone().requires_grad_()
    outs = []
    for a, n in ((0, 24), (24, 40)):
        q, k, v = (loop[a:a + n, i].transpose(0, 1)[None] for i in range(3))
        outs.append(mha_reference(q, k, v)[0].transpose(0, 1))
    (torch.cat(outs) * ct).sum().backward()
    np.testing.assert_allclose(packed.grad.numpy(), loop.grad.numpy(),
                               atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="packed"):
        fmha_varlen(qkv[:, :2], cu)


@pytest.mark.parametrize("causal", [True, False])
def test_fmha_varlen_gradient_matches_jax(causal):
    """The packed call's qkv gradient against ``jax.grad`` of JAX's
    ``fmha_varlen`` (its flash forward and backward kernels in interpret
    mode) on the same qkv, ``cu_seqlens`` (with a padded tail past
    ``cu[-1]``) and cotangent, ``atol 2e-5`` over values of order 1."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.contrib.fmha import fmha_varlen as jax_varlen

    h, d = 2, 64
    lens = [48, 80]
    total = sum(lens) + 16
    rng = np.random.default_rng(9)
    qkv = rng.standard_normal((total, 3, h, d)).astype(np.float32)
    ct = rng.standard_normal((total, h, d)).astype(np.float32)
    cu = np.cumsum([0] + lens).astype(np.int32)
    _assert_flash_kernel_runs(total, total)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_varlen(t, jnp.asarray(cu), causal=causal) * ct))(
            jnp.asarray(qkv)))
    packed = torch.from_numpy(qkv).requires_grad_()
    (fmha_varlen(packed, torch.from_numpy(cu), causal=causal)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(packed.grad.numpy(), want, atol=2e-5, rtol=0)
