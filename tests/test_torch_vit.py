"""apex_tpu_torch's ViT (models/vit.py) against apex_tpu's on carried-over
weights.

One JAX ``ViTForImageClassification`` (image 32, patch 8, 2 layers of 64,
4 heads of 16, MLP 128, 10 labels, fp32) is initialised in JAX; its
parameters go to the port through numpy and ``vit_params_from_jax``.  NHWC
images and labels come from numpy with fixed seeds.  The JAX LayerNorm
runs its Pallas kernels in interpret mode.  Tolerances: logits at ``atol =
1e-5``; each gradient of the cross entropy within ``1e-4 max|g| + 1e-4
|g| + 1e-6 G`` of JAX's (G the largest gradient of the model: a key
bias's gradient is zero in exact arithmetic, as the softmax drops a shift
shared by a row's scores, and is fp32 noise on both sides); two
``FusedAdam(lr 3e-4, wd 0.05)`` steps' losses at ``1e-5`` and each
parameter within ``1e-5 + 2 x 2 lr ng / (|g| + ng)``, ``ng`` its
gradient's tolerance (Adam divides each gradient by its own size, so
noise on a gradient that is zero in exact arithmetic moves its element
by up to ``lr`` a step, either way on each side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.vit import ViTConfig as JaxViTConfig
from apex_tpu.models.vit import ViTForImageClassification as JaxViT
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.models import (
    ViTConfig,
    ViTForImageClassification,
    vit_params_from_jax,
)
from apex_tpu_torch.optimizers import FusedAdam

JCFG = JaxViTConfig(image_size=32, patch_size=8, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128, num_labels=10)
CFG = ViTConfig(**dataclasses.asdict(JCFG))
B = 4


@pytest.fixture(scope="module")
def jax_params():
    params = JaxViT(JCFG).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3), jnp.float32))
    return jax.tree.map(np.asarray, params)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, B).astype(np.int32))


def _torch_model(params) -> ViTForImageClassification:
    model = ViTForImageClassification(CFG, device="cpu")
    model.load_state_dict(vit_params_from_jax(params, CFG.num_hidden_layers))
    return model


def _jax_loss_fn(pixels, labels):
    model = JaxViT(JCFG)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(pixels))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], axis=1))

    return loss_fn


def _torch_loss(model, pixels, labels):
    logits = model(torch.from_numpy(pixels)).float()
    return torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels).long())


def test_config_and_vit_l16_widths():
    cfg = ViTConfig.vit_l16()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.layer_norm_eps) == (1024, 24, 16, 4096,
                                                           1e-12)
    assert cfg.num_patches == 196
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxViTConfig.vit_l16())


def test_logits_match_jax(monkeypatch, jax_params):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    pixels, _ = _data(1)
    ref = np.asarray(JaxViT(JCFG).apply(jax_params, jnp.asarray(pixels)))
    with torch.no_grad():
        out = _torch_model(jax_params)(torch.from_numpy(pixels))
    assert tuple(out.shape) == (B, 10)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_patch_order_is_nhwc_channel_fastest(jax_params):
    """A patch's pixel (i, j, c) meets ``patch_kernel`` row (i p + j) C +
    c: an image with one lit pixel gives that row of the kernel."""
    model = _torch_model(jax_params)
    p, C = CFG.patch_size, CFG.num_channels
    img = torch.zeros(1, 32, 32, 3)
    img[0, 8 + 3, 16 + 5, 2] = 1.0       # patch (1, 2), pixel (3, 5), channel 2
    seen = {}
    orig = torch.matmul

    def spy(a, b):
        if b is model.patch_kernel or (b.data_ptr() ==
                                       model.patch_kernel.data_ptr()):
            seen["x"] = a
        return orig(a, b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "matmul", spy)
        with torch.no_grad():
            model(img)
    x = seen["x"][0]
    row = 1 * 4 + 2
    lit = torch.nonzero(x[row]).flatten().tolist()
    assert lit == [(3 * p + 5) * C + 2]
    assert int(torch.count_nonzero(x)) == 1


def test_every_gradient_matches_jax(monkeypatch, jax_params):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    pixels, labels = _data(2)
    ref_loss, ref_grads = jax.value_and_grad(_jax_loss_fn(pixels, labels))(
        jax.tree.map(jnp.asarray, jax_params))
    ref = vit_params_from_jax(jax.tree.map(np.asarray, ref_grads),
                              CFG.num_hidden_layers)
    model = _torch_model(jax_params)
    loss = _torch_loss(model, pixels, labels)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    floor = 1e-6 * max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for name, p in named.items():
        g, r = p.grad.numpy(), ref[name].numpy()
        tol = 1e-4 * np.abs(r).max() + 1e-4 * np.abs(r) + floor
        assert (np.abs(g - r) <= tol).all(), (name, np.abs(g - r).max())


def test_two_fused_adam_steps_match_jax(monkeypatch, jax_params):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    pixels, labels = _data(3)
    loss_fn = _jax_loss_fn(pixels, labels)
    jopt = JaxFusedAdam(lr=3e-4, weight_decay=0.05)
    p = jax.tree.map(jnp.asarray, jax_params)
    state = jopt.init(p)
    ref_losses = []
    for i in range(2):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        if i == 0:
            g0 = vit_params_from_jax(jax.tree.map(np.asarray, grads),
                                     CFG.num_hidden_layers)
        p, state = jopt.step(grads, p, state)
        ref_losses.append(float(loss))
    model = _torch_model(jax_params)
    opt = FusedAdam(model.parameters(), lr=3e-4, weight_decay=0.05)
    losses = []
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        loss = _torch_loss(model, pixels, labels)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref_losses, atol=1e-5, rtol=0)
    ref = vit_params_from_jax(jax.tree.map(np.asarray, p),
                              CFG.num_hidden_layers)
    floor = 1e-6 * max(float(np.abs(g.numpy()).max()) for g in g0.values())
    for name, q in model.named_parameters():
        g = np.abs(g0[name].numpy())
        ng = 1e-4 * g.max() + 1e-4 * g + floor
        tol = 1e-5 + 2 * 2 * 3e-4 * ng / (g + ng)
        err = np.abs(q.detach().numpy() - ref[name].numpy())
        assert (err <= tol).all(), (name, float((err / tol).max()))


def test_bf16_o2_forward_is_finite_and_close_to_fp32(jax_params):
    """The bench's O2 cast (every parameter of two or more dims bf16) on
    bf16 pixels: the attention still runs in fp32 and the logits stay
    within bf16's reach of the fp32 model's."""
    from apex_tpu_torch.examples.llama_pretrain import o2_cast

    pixels, _ = _data(4)
    model = _torch_model(jax_params)
    with torch.no_grad():
        ref = model(torch.from_numpy(pixels))
        o2_cast(model)
        assert model.cls_token.dtype == torch.bfloat16
        assert model.layers[0].layernorm_before.scale.dtype == torch.float32
        out = model(torch.from_numpy(pixels).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=0.1)


def test_converter_rejects_missing_and_extra_keys(jax_params):
    tree = dict(jax_params["params"])
    tree.pop("layer_1")
    with pytest.raises(ValueError, match="missing.*layer_1"):
        vit_params_from_jax(tree, 2)
    with pytest.raises(ValueError, match="unconsumed.*layer_1"):
        vit_params_from_jax(jax_params, 1)
    sd = vit_params_from_jax(jax_params, 2)
    k = jax_params["params"]["layer_0"]["attention"]["query"]["kernel"]
    np.testing.assert_array_equal(
        sd["layers.0.attention.query.weight"].numpy(), np.asarray(k).T)
    np.testing.assert_array_equal(sd["patch_kernel"].numpy(),
                                  jax_params["params"]["patch_kernel"])
