"""apex_tpu_torch's GPT (standalone_transformer_lm + standalone_gpt) against
apex_tpu's on carried-over weights.

One JAX ``GPTModel`` (2 layers, hidden 128, 2 heads of 64, vocab 512,
sequence 128, fp32) is initialised in JAX; its parameters go to the port
through numpy and ``gpt_params_from_jax``.  The JAX side runs its Pallas
kernels (LayerNorm, flash attention or the fused softmax, the fused LM
head) in interpret mode; batch 4 x 128 tokens (T 512) meets the head
kernel's gate.  Token ids come from numpy with a fixed seed.  Tolerances:
logits and per-token losses at ``atol = 1e-4`` (fp32 through two layers,
sums taken in another order); each gradient within ``1e-4 max|g| +
1e-4 |g|`` of the JAX one; a 3-step ``FusedLAMB(packed=True)`` trajectory's
losses at ``1e-4`` and its parameters at ``atol = 1e-5`` (lr 1e-3: the
steps move each parameter by ~lr, and the trust ratios divide norms whose
fp32 sums differ in order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.transformer.testing import GPTModel as JaxGPT
from apex_tpu_torch.examples import gpt_pretrain
from apex_tpu_torch.models import gpt_params_from_jax
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.transformer import testing as ttesting
from apex_tpu_torch.transformer.testing import GPTModel
from apex_tpu_torch.transformer.testing import standalone_transformer_lm as tlm

CFG = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
           vocab_size=512, max_sequence_length=128)
B, S = 4, 128


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT(**CFG)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _torch_model(params, flash: bool) -> GPTModel:
    model = GPTModel(**CFG, use_flash_attention=flash, device="cpu")
    model.load_state_dict(gpt_params_from_jax(params, CFG["num_layers"]))
    return model


def _jax_loss_fn(flash: bool, ids, labels):
    model = JaxGPT(**CFG, use_flash_attention=flash)
    return lambda p: model.apply(p, jnp.asarray(ids),
                                 labels=jnp.asarray(labels)).mean()


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "fused-softmax"])
def test_logits_and_loss_match_jax(monkeypatch, jax_params, flash):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    ids, labels = _ids(1)
    jmodel = JaxGPT(**CFG, use_flash_attention=flash)
    ref_logits = np.asarray(jmodel.apply(jax_params, jnp.asarray(ids)))
    ref_loss = np.asarray(jmodel.apply(jax_params, jnp.asarray(ids),
                                       labels=jnp.asarray(labels)))
    model = _torch_model(jax_params, flash)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long())
        loss = model(torch.from_numpy(ids).long(),
                     labels=torch.from_numpy(labels).long())
    assert tuple(logits.shape) == (S, B, CFG["vocab_size"])
    assert logits.dtype == torch.float32 and tuple(loss.shape) == (B, S)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.numpy(), ref_loss, atol=1e-4, rtol=0)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "fused-softmax"])
def test_every_gradient_matches_jax(monkeypatch, jax_params, flash):
    """Every parameter's gradient, the tied word embedding's (lookup plus
    head) included."""
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    ids, labels = _ids(2)
    ref_loss, ref_grads = jax.value_and_grad(
        _jax_loss_fn(flash, ids, labels))(jax.tree.map(jnp.asarray, jax_params))
    ref = gpt_params_from_jax(jax.tree.map(np.asarray, ref_grads),
                              CFG["num_layers"])
    model = _torch_model(jax_params, flash)
    loss = model(torch.from_numpy(ids).long(),
                 labels=torch.from_numpy(labels).long()).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), atol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        g, r = p.grad.numpy(), ref[name].numpy()
        tol = 1e-4 * np.abs(r).max() + 1e-4 * np.abs(r)
        assert (np.abs(g - r) <= tol).all(), (name, np.abs(g - r).max())
    emb = named["language_model.embedding.word_embeddings.weight"].grad
    assert emb.abs().sum(dim=1).gt(0).sum() > len(np.unique(ids))  # head rows


def test_packed_lamb_trajectory_matches_jax(monkeypatch, jax_params):
    """Three steps of the fused-softmax model under FusedLAMB(packed=True)
    against the JAX model under the JAX packed FusedLAMB."""
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    ids, labels = _ids(3)
    loss_fn = _jax_loss_fn(False, ids, labels)
    jopt = JaxFusedLAMB(lr=1e-3, packed=True)
    jparams = jax.tree.map(jnp.asarray, jax_params)
    jstate = jopt.init(jparams)
    ref_losses = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(loss_fn)(jparams)
        jparams, jstate = jopt.step(grads, jparams, jstate)
        ref_losses.append(float(loss))
    model = _torch_model(jax_params, False)
    opt = FusedLAMB(model.parameters(), lr=1e-3, packed=True)
    losses = [float(gpt_pretrain.train_step(model, opt,
                                            torch.from_numpy(ids).long()))
              for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4)
    assert losses[-1] < losses[0]
    ref = gpt_params_from_jax(jax.tree.map(np.asarray, jparams),
                              CFG["num_layers"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_qkv_split_keeps_each_heads_q_k_v_adjacent():
    """The fused QKV output [s, b, np, 3 hd] splits per head, as the JAX
    model's reshape and split on the last axis."""
    attn = tlm.ParallelAttention(8, 2, device="cpu")
    seen = {}
    orig = tlm.FusedScaleMaskSoftmax.forward

    def spy(self, scores, mask=None):
        seen["scores"] = scores
        return orig(self, scores, mask)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlm.FusedScaleMaskSoftmax, "forward", spy)
        attn.use_flash_attention = False
        x = torch.randn(3, 1, 8)
        attn(x)
    qkv = attn.query_key_value(x).view(3, 1, 2, 12)
    q, k = qkv[..., 0:4], qkv[..., 4:8]
    want = torch.einsum("sbnd,tbnd->bnst", q, k)
    torch.testing.assert_close(seen["scores"], want)


def test_unported_options_raise(tmp_path):
    # context parallelism and MoE are ported (tests/test_torch_ring_attention.py
    # and tests/test_torch_moe.py): over a group of one rank both build and
    # run; a mesh-axis name in place of a process group raises
    import torch.distributed as dist

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                                rank=0, world_size=1)
    try:
        one = dist.group.WORLD
        layer = tlm.ParallelTransformerLayer(
            8, 2, apply_rope=True, context_parallel_axis=one,
            moe_num_experts=4, expert_parallel_axis=one, device="cpu")
        assert layer(torch.randn(4, 2, 8)).shape == (4, 2, 8)
        assert layer.mlp.aux_loss is not None
    finally:
        if own:
            dist.destroy_process_group()
    for kw in (dict(context_parallel_axis="cp"),
               dict(moe_num_experts=4, expert_parallel_axis="ep")):
        with pytest.raises(ValueError, match="ProcessGroup"):
            tlm.ParallelTransformerLayer(8, 2, device="cpu", **kw)
    # dropout and activation recompute are ported (tests/test_torch_remat.py
    # and the dropout tests below); out-of-range rates and unknown policies
    # raise
    assert tlm.ParallelAttention(8, 2, attention_dropout=0.1,
                                 device="cpu").attention_dropout == 0.1
    assert tlm.ParallelTransformerLayer(8, 2, hidden_dropout=0.1,
                                        device="cpu").hidden_dropout == 0.1
    assert GPTModel(activations_checkpoint=True, device="cpu")
    assert GPTModel(activations_checkpoint_policy="dots", device="cpu")
    with pytest.raises(ValueError, match="hidden_dropout"):
        tlm.ParallelTransformerLayer(8, 2, hidden_dropout=1.0, device="cpu")
    with pytest.raises(ValueError, match="activations_checkpoint_policy"):
        GPTModel(activations_checkpoint_policy="nothing", device="cpu")
    # sequence parallelism is ported: at world 1 (outside a tp region) it
    # is the model without it, the logits bit for bit and the loss (the
    # vocab-parallel cross entropy in place of the fused head) at 1e-5;
    # tests/test_torch_tp_training.py holds it at tp 2 against JAX
    cfg = dict(num_layers=1, hidden_size=16, num_attention_heads=2,
               vocab_size=32, max_sequence_length=8, device="cpu")
    base = GPTModel(**cfg, generator=torch.Generator().manual_seed(0))
    sp = GPTModel(**cfg, sequence_parallel_enabled=True)
    sp.load_state_dict(base.state_dict())
    ids = torch.randint(0, 32, (2, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(sp(ids), base(ids))
        torch.testing.assert_close(sp(ids, labels=ids), base(ids, labels=ids),
                                   rtol=0, atol=1e-5)
    from apex_tpu_torch.transformer.layers import FusedLayerNorm
    ln = FusedLayerNorm(8, device="cpu")
    ln_sp = FusedLayerNorm(8, sequence_parallel_enabled=True, device="cpu")
    with torch.no_grad():
        ln.scale.uniform_(0.5, 1.5)
        ln_sp.scale.copy_(ln.scale)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(2))
    ln(x).square().sum().backward()
    ln_sp(x).square().sum().backward()
    assert torch.equal(ln.scale.grad, ln_sp.scale.grad)
    assert torch.equal(ln.bias.grad, ln_sp.bias.grad)


def test_rope_model_matches_jax(monkeypatch):
    """apply_rope=True: no position table, rotary q and k (the module's own
    base-10000 frequencies) through the flash core."""
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    cfg = dict(CFG, num_layers=1)
    jmodel = JaxGPT(**cfg, apply_rope=True)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)))
    ids, _ = _ids(4)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    model = GPTModel(**cfg, apply_rope=True, device="cpu")
    model.load_state_dict(gpt_params_from_jax(params, 1, apply_rope=True))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_converter_rejects_missing_and_extra_keys(jax_params):
    tree = jax.tree.map(lambda a: a, jax_params)["params"]
    lm = dict(tree["language_model"])
    tr = dict(lm["transformer"])
    tr.pop("layer_1")
    with pytest.raises(ValueError, match="missing.*layer_1"):
        gpt_params_from_jax({"language_model": dict(lm, transformer=tr)}, 2)
    with pytest.raises(ValueError, match="unconsumed.*position_embeddings"):
        gpt_params_from_jax(tree, 2, apply_rope=True)
    # a flax kernel [in, out] arrives as a torch weight [out, in]
    sd = gpt_params_from_jax(tree, 2)
    k = tree["language_model"]["transformer"]["layer_0"]["self_attention"][
        "query_key_value"]["kernel"]
    w = sd["language_model.transformer.layers.0.self_attention."
           "query_key_value.weight"]
    np.testing.assert_array_equal(w.numpy(), np.asarray(k).T)


def test_gpt_pretrain_main_on_the_cpu():
    for argv in ([], ["--no-flash", "--packed-lamb"]):
        last = gpt_pretrain.main(["--device", "cpu", "--steps", "3",
                                  "--seq", "64", "--batch", "2", *argv])
        assert np.isfinite(last)
    assert ttesting.gpt_model_provider(device="cpu", num_layers=1).num_layers == 1


def _attention_params(jparams):
    """The JAX ``ParallelAttention``'s tree as the port module's
    ``state_dict``."""
    p = jparams["params"]
    return {f"{m}.{k}": torch.from_numpy(
                np.array(np.asarray(p[m][leaf]).T if k == "weight"
                         else p[m][leaf]))
            for m in ("query_key_value", "dense")
            for k, leaf in (("weight", "kernel"), ("bias", "bias"))}


def test_attention_dropout_keep_pattern_equals_jax_flash_dropout(monkeypatch):
    """``ParallelAttention(attention_dropout=0.1)`` on the flash path with
    ``deterministic=False``: the seed drawn from the port's generator,
    given to the JAX module in place of its ``randint`` of the flax rng,
    gives JAX's output (its in-kernel counter-hash dropout, interpret
    mode) at ``atol = 1e-5``: the same keep bits."""
    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        ParallelAttention as JaxAttention,
    )

    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    s, b, h = 128, 2, 128
    x = np.random.default_rng(11).standard_normal((s, b, h)).astype(np.float32)
    jattn = JaxAttention(h, 2, attention_dropout=0.1)
    jparams = jax.tree.map(np.asarray, jattn.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    seed = tlm.dropout_seed(torch.Generator().manual_seed(5))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(seed, jnp.int32))
    ref = np.asarray(jattn.apply(jparams, jnp.asarray(x), deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(1)}))
    ref_det = np.asarray(jattn.apply(jparams, jnp.asarray(x)))
    attn = tlm.ParallelAttention(h, 2, attention_dropout=0.1, device="cpu")
    attn.load_state_dict(_attention_params(jparams))
    with torch.no_grad():
        out = attn(torch.from_numpy(x), deterministic=False,
                   dropout_generator=torch.Generator().manual_seed(5))
        det = attn(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(det.numpy(), ref_det, atol=1e-5, rtol=0)
    assert np.abs(ref - ref_det).max() > 1e-2      # the dropout did act


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "fused-softmax"])
def test_deterministic_layers_are_exact_and_dropout_needs_a_generator(flash):
    """``deterministic=True`` (the default) is the layer without dropout,
    bit for bit; ``deterministic=False`` draws from the caller's generator
    (the same state, the same output) and zeroes about ``rate`` of the
    hidden activations; without a generator it raises."""
    kw = dict(use_flash_attention=flash, device="cpu")
    drop = tlm.ParallelTransformerLayer(64, 2, hidden_dropout=0.25,
                                        attention_dropout=0.25, **kw)
    plain = tlm.ParallelTransformerLayer(64, 2, **kw)
    plain.load_state_dict(drop.state_dict())
    x = torch.randn(64, 4, 64, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        assert torch.equal(drop(x), plain(x))
        assert torch.equal(drop(x, deterministic=True,
                                dropout_generator=torch.Generator()), plain(x))
        a = drop(x, deterministic=False,
                 dropout_generator=torch.Generator().manual_seed(1))
        b = drop(x, deterministic=False,
                 dropout_generator=torch.Generator().manual_seed(1))
        c = drop(x, deterministic=False,
                 dropout_generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="dropout_generator"):
        drop(x, deterministic=False)
    y = tlm.dropout(torch.ones(100_000), 0.25, torch.Generator().manual_seed(3))
    share = float((y == 0).float().mean())
    assert abs(share - 0.25) < 6 * (0.25 * 0.75 / 100_000) ** 0.5
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
