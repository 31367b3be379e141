"""apex_tpu_torch.models against apex_tpu.models on carried-over weights.

One JAX ``LlamaForCausalLM`` (2 layers, hidden 128, 4 heads over 2 kv
heads, intermediate 256, vocab 256, fp32) is initialised in JAX; its
parameters go to the port through numpy and ``llama_params_from_jax``.
The JAX side runs its Pallas RMSNorm kernel in interpret mode.  Inputs
come from numpy with a fixed seed.  Tolerances: logits at ``atol =
1e-4`` (fp32 through two layers, sums taken in another order);
elementwise pieces (rope, cached attention) at ``atol = rtol = 1e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.models import llama as jllama
from apex_tpu.ops.rope import fused_apply_rotary_pos_emb as jax_rope
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.models import llama as tllama
from apex_tpu_torch.models.convert import _tensor
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = JaxLlama(JaxLlamaConfig(**CFG))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def torch_model(jax_model_and_params):
    _, params = jax_model_and_params
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    model.load_state_dict(llama_params_from_jax(params, model.config))
    return model.eval()


def test_config_cards():
    for name in ("llama2_7b", "llama3_8b"):
        assert (dataclasses.asdict(getattr(LlamaConfig, name)())
                == dataclasses.asdict(getattr(JaxLlamaConfig, name)()))
    c = LlamaConfig.llama_1b()
    assert (c.num_hidden_layers, c.hidden_size, c.num_attention_heads,
            c.kv_heads, c.intermediate_size, c.vocab_size) == (
        22, 2048, 32, 8, 5632, 32000)


def test_uncached_logits_match_jax(jax_model_and_params, torch_model):
    model, params = jax_model_and_params
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG["vocab_size"], (2, 12)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        ref = np.asarray(model.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        ours = torch_model(torch.from_numpy(ids).long())
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)


def test_state_dict_keys_are_the_converters(torch_model, jax_model_and_params):
    sd = llama_params_from_jax(jax_model_and_params[1], torch_model.config)
    assert set(sd) == set(torch_model.state_dict())
    # a flax kernel [in, out] arrives as a torch weight [out, in]
    q = jax_model_and_params[1]["params"]["layers_0"]["self_attn"]["q_proj"]
    np.testing.assert_array_equal(sd["layers.0.self_attn.q_proj.weight"].numpy(),
                                  q["kernel"].T)


def test_converter_rejects_missing_and_extra_keys(jax_model_and_params):
    _, params = jax_model_and_params
    config = LlamaConfig(**CFG)
    tree = jax.tree.map(lambda a: a, params)          # a fresh nested dict
    del tree["params"]["layers_1"]["mlp"]["up_proj"]
    with pytest.raises(ValueError, match="missing.*layers_1/mlp/up_proj"):
        llama_params_from_jax(tree, config)
    tree = jax.tree.map(lambda a: a, params)
    tree["params"]["layers_0"]["self_attn"]["q_proj"]["bias"] = np.zeros(128)
    with pytest.raises(ValueError, match="unconsumed.*q_proj/bias"):
        llama_params_from_jax(tree, config)


def test_converter_carries_bf16():
    t = _tensor(np.asarray(jnp.asarray([1.5, -2.0, 3.25], jnp.bfloat16)))
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.5, -2.0, 3.25]


@pytest.mark.parametrize("form", ["scalar", "vector"])
def test_rope_matches_jax(form):
    """``_rope_freqs`` in its scalar-offset ([s, 1, 1, d]) and [b]-vector
    offset ([s, b, 1, d]) forms, then the rotation, against apex_tpu."""
    rng = np.random.default_rng(1)
    s, b, h, d = (5, 3, 4, 32) if form == "scalar" else (1, 3, 4, 32)
    t = rng.standard_normal((s, b, h, d)).astype(np.float32)
    if form == "scalar":
        off_j, off_t = jnp.asarray(7, jnp.int32), 7
    else:
        lens = np.asarray([0, 9, 130], np.int32)
        off_j, off_t = jnp.asarray(lens), torch.from_numpy(lens)
    fj = jllama._rope_freqs(s, d, 10000.0, offset=off_j)
    ft = tllama._rope_freqs(s, d, 10000.0, offset=off_t)
    assert tuple(ft.shape) == fj.shape
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(
        fused_apply_rotary_pos_emb(torch.from_numpy(t), ft).numpy(),
        np.asarray(jax_rope(jnp.asarray(t), fj)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 6])
def test_cached_attention_matches_jax(m):
    """Decode (m = 1) and a prefill chunk (m = 6) over a 16-row cache with
    per-row bounds, on GQA-expanded K/V as the JAX function takes them
    (and on the unexpanded K/V the port's model passes)."""
    rng = np.random.default_rng(2)
    b, h, nkv, max_len, hd = 2, 4, 2, 16, 8
    q = rng.standard_normal((b, h, m, hd)).astype(np.float32)
    k = rng.standard_normal((b, nkv, max_len, hd)).astype(np.float32)
    v = rng.standard_normal((b, nkv, max_len, hd)).astype(np.float32)
    start = np.asarray([3, 9], np.int32)
    bounds = (start[:, None] + np.arange(m, dtype=np.int32)[None]).astype(
        np.int32)
    kx, vx = np.repeat(k, h // nkv, axis=1), np.repeat(v, h // nkv, axis=1)
    ref = np.asarray(jllama._cached_attention(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), jnp.asarray(bounds)))
    tb = torch.from_numpy(bounds)
    for kk, vv in ((kx, vx), (k, v)):
        ours = tllama._cached_attention(torch.from_numpy(q),
                                        torch.from_numpy(kk),
                                        torch.from_numpy(vv), tb)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)


# head dim 64 and 512 tokens: the JAX model runs its Pallas flash forward
# and fused LM-head forward (interpret mode), not their jnp fallbacks
FLASH_CFG = dict(vocab_size=320, hidden_size=128, intermediate_size=256,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1, max_position_embeddings=512)


@pytest.fixture(scope="module", params=[False, True], ids=["lm_head", "tied"])
def flash_pair(request):
    """(JAX model, numpy params, port model) on the same weights, with a
    separate ``lm_head`` or the tied embedding as the head."""
    cfg = dict(FLASH_CFG, tie_word_embeddings=request.param)
    model = JaxLlama(JaxLlamaConfig(**cfg))
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32)))
    ours = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    ours.load_state_dict(llama_params_from_jax(params, ours.config))
    return model, params, ours.eval()


def _ids_and_labels(seed=4, b=2, s=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, FLASH_CFG["vocab_size"], (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)     # next-token targets


def test_uncached_logits_match_jax_flash(flash_pair):
    """b * s = 512 at head dim 64: the JAX side's attention is its Pallas
    flash forward (interpret mode), the port's the flash plain version."""
    model, params, ours = flash_pair
    ids, _ = _ids_and_labels()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        ref = np.asarray(model.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = ours(torch.from_numpy(ids).long())
    assert tuple(got.shape) == ref.shape == (256, 2, FLASH_CFG["vocab_size"])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_labels_loss_matches_jax(flash_pair):
    """``model(ids, labels=labels)`` returns the [b, s] fp32 per-token loss
    of the JAX model's fused LM-head path (tp 1), within 1e-4."""
    model, params, ours = flash_pair
    ids, labels = _ids_and_labels(seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        ref = np.asarray(model.apply(params, jnp.asarray(ids),
                                     labels=jnp.asarray(labels)))
    with torch.no_grad():
        got = ours(torch.from_numpy(ids).long(),
                   labels=torch.from_numpy(labels).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)
    # the loss is the cross-entropy of the model's own logits
    with torch.no_grad():
        logits = ours(torch.from_numpy(ids).long())
    ce = torch.nn.functional.cross_entropy(
        logits.permute(1, 2, 0), torch.from_numpy(labels).long(),
        reduction="none")
    np.testing.assert_allclose(got.numpy(), ce.numpy(), atol=1e-4, rtol=1e-5)


def test_labels_with_kv_cache_raises(torch_model):
    from apex_tpu_torch.serving import init_cache

    cache = init_cache(torch_model.config, slots=1, max_len=8, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="labels"):
        torch_model(ids, labels=ids, kv_cache=cache, slot=0, position=0)


# ---------------------------------------------------------------------------
# training (the third slice): gradients, FusedAdam steps, the driver
# ---------------------------------------------------------------------------


def _jax_loss_and_grads(model, params, ids, labels):
    """``jax.value_and_grad`` of the mean ``labels=`` loss, as
    examples/llama/pretrain.py's ``loss_fn`` (Pallas kernels in interpret
    mode), with the grads as a port ``state_dict``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        loss, grads = jax.value_and_grad(
            lambda p: model.apply(p, jnp.asarray(ids),
                                  labels=jnp.asarray(labels)).mean())(params)
    return float(loss), grads


def test_loss_and_every_grad_match_jax(flash_pair):
    """The mean ``labels=`` loss and the gradient of every parameter
    (projections, norm scales, embedding, and the separate head or the
    tied table, whose gradient sums the lookup's and the head's) against
    ``jax.value_and_grad`` on the same weights, b * s = 512 at head dim 64
    so that JAX runs its Pallas forward and backward kernels.  fp32: loss
    at 1e-5, each gradient within 1e-4 of its largest entry plus 1e-4 of
    itself (sums over 512 tokens taken in another order)."""
    model, params, ours = flash_pair
    ids, labels = _ids_and_labels(seed=6)
    ref_loss, jgrads = _jax_loss_and_grads(model, params, ids, labels)
    ref = llama_params_from_jax(jax.tree.map(np.asarray, jgrads), ours.config)
    ours.zero_grad(set_to_none=True)
    loss = ours(torch.from_numpy(ids).long(),
                labels=torch.from_numpy(labels).long()).mean()
    loss.backward()
    assert abs(float(loss.detach()) - ref_loss) < 1e-5
    grads = {n: p.grad for n, p in ours.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
    ours.zero_grad(set_to_none=True)


def test_three_step_trajectory_matches_jax():
    """Three steps of ``train_step`` with FusedAdam against the JAX step of
    examples/llama/pretrain.py:126-136 at dp = tp = 1 (value_and_grad of
    the mean loss, then ``FusedAdam.step``), from the same weights on one
    fixed batch: the losses at 1e-5, and the parameters and both moments
    (carried over by the same converter) after the steps.  An element's
    Adam step is g / (|g| + eps)-like, so a gradient near the noise of its
    fp32 sums moves its element by a larger share of lr: each element is
    held to 1e-6 + 3 lr ng / (|g1| + ng), ng = 1e-4 max|g1| the gradient
    tolerance above and g1 the first step's gradient."""
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
    from apex_tpu_torch.examples.llama_pretrain import train_step
    from apex_tpu_torch.optimizers import FusedAdam

    lr, steps = 1e-3, 3
    cfg = dict(FLASH_CFG)
    model = JaxLlama(JaxLlamaConfig(**cfg))
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))
    ids, labels = _ids_and_labels(seed=7)
    jopt = JaxFusedAdam(lr=lr)
    jstate = jopt.init(params)
    jlosses, g1 = [], None
    for _ in range(steps):
        loss, grads = _jax_loss_and_grads(model, params, ids, labels)
        g1 = grads if g1 is None else g1
        params, jstate = jopt.step(grads, params, jstate)
        jlosses.append(loss)

    ours = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    init = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))
    ours.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, init),
                                               ours.config))
    opt = FusedAdam(ours.parameters(), lr=lr)
    tids = torch.from_numpy(ids).long()
    losses = [float(train_step(ours, opt, tids)) for _ in range(steps)]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    assert losses[-1] < losses[0]

    conv = lambda tree: llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                              ours.config)
    ref_p, ref_m, ref_v = conv(params), conv(jstate[0].exp_avg), conv(
        jstate[0].exp_avg_sq)
    grad1 = conv(g1)
    for name, p in ours.named_parameters():
        g = np.abs(grad1[name].numpy())
        ng = 1e-4 * g.max()
        tol = 1e-6 + steps * lr * ng / (g + ng + 1e-30)
        assert (np.abs(p.detach().numpy() - ref_p[name].numpy()) <= tol).all(), name
        st = opt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), ref_m[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * g.max(), err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   ref_v[name].numpy(), rtol=1e-3,
                                   atol=1e-4 * g.max() ** 2, err_msg=name)


def test_o2_cast_keeps_norm_scales_fp32():
    from apex_tpu_torch.examples.llama_pretrain import o2_cast

    model = o2_cast(LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    for name, p in model.named_parameters():
        want = torch.bfloat16 if p.dim() >= 2 else torch.float32
        assert p.dtype == want, name
    # the O2 model trains: bf16 activations, fp32 norm-scale gradients
    ids = torch.randint(0, CFG["vocab_size"], (2, 8))
    model(ids, labels=torch.roll(ids, -1, 1)).mean().backward()
    assert model.norm.scale.grad.dtype == torch.float32
    assert model.embed_tokens.weight.grad.dtype == torch.bfloat16


def test_pretrain_driver_on_cpu_loss_falls(capsys):
    """``llama_pretrain.main`` on ``--device cpu`` at a tiny size: the
    loss falls (it raises otherwise), with the bf16 O2 precision too."""
    from apex_tpu_torch.examples import llama_pretrain

    argv = ["--device", "cpu", "--layers", "2", "--steps", "3", "--seq", "32",
            "--batch", "2", "--vocab", "128"]
    last = llama_pretrain.main(argv)
    assert np.isfinite(last)
    last_o2 = llama_pretrain.main(argv + ["--o2", "--lr", "1e-2"])
    assert np.isfinite(last_o2)
    assert "llama pretrain OK" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--tp", "--pp"])
def test_pretrain_driver_refuses_model_parallelism(flag, monkeypatch):
    """``--tp`` or ``--pp`` with no ``torch.distributed`` world (none
    started, no torchrun environment) raises with the torchrun recipe: it
    never falls back to one process (``tests/test_torch_tp_training.py``
    and ``tests/test_torch_pipeline_llama.py`` train them in worlds)."""
    from apex_tpu_torch.examples import llama_pretrain

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        llama_pretrain.main(["--device", "cpu", flag, "2"])


# ---------------------------------------------------------------------------
# mixed precision (the amp slice): fp16 O2 under the dynamic loss scaler
# ---------------------------------------------------------------------------


def test_amp_o2_fp16_steps_match_jax():
    """Four steps of the amp O2 flow in fp16 with the dynamic scaler and
    ``FusedAdam(master_weights=True)``, port against JAX from the same
    weights, b * s = 512 at head dim 64 (the JAX Pallas kernels in
    interpret mode): the per-token loss comes out of the model in fp16
    (O2's output cast) before its mean is scaled in fp32.  Step 0
    overflows on its own (the mean's cotangent, 2**16, is past fp16's
    largest value), step 2 by an inf written into one gradient; both are
    skipped and halve the scale.  The losses equal and the overflow flags
    and every scaler field the same at every step; the fp32 masters after
    the two applied steps within 1e-6 + 4 lr ng / (|g1| + ng) and the
    moments within ng (m) and 2 ng max|g1| (v), ng = 2^-8 max|g1| a few
    fp16 roundings of the gradient (measured: 2.1e-3 max|g1|): an element
    whose gradient lies within ng of 0 may take each side's Adam step in
    its own direction.  Each fp16 parameter is its master cast."""
    from apex_tpu import amp as jamp
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam

    lr, steps, force = 1e-3, 4, 2
    cfg = dict(FLASH_CFG)
    model = JaxLlama(JaxLlamaConfig(**cfg))
    init = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))
    ids, labels = _ids_and_labels(seed=7)

    jamped = jamp.initialize(model.apply, init, opt_level="O2",
                             half_dtype=jnp.float16)
    scaler, sst, params = jamped.scaler, jamped.scaler_state, jamped.params
    jopt = JaxFusedAdam(lr=lr, master_weights=True)
    jstate = jopt.init(params)
    jlog, g1 = [], None
    for i in range(steps):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_TPU_KERNELS", "interpret")
            scaled, grads = jax.value_and_grad(lambda p: scaler.scale_loss(
                jamped.apply(p, jnp.asarray(ids),
                             labels=jnp.asarray(labels)).mean(), sst))(params)
        loss = scaled / sst.scale          # the scale is a power of 2: exact
        if i == force:
            grads = jax.tree.map(lambda g: g, grads)
            head = grads["params"]["lm_head"]
            grads["params"]["lm_head"] = head.at[0, 0].set(jnp.inf)
        grads, found = scaler.unscale(grads, sst)
        if g1 is None and not bool(found):
            g1 = grads
        params, jstate = jopt.step(grads, params, jstate, found_inf=found)
        sst = scaler.update(sst, found)
        jlog.append((float(loss), bool(found), sst))

    ours = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    ours.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, init),
                                               ours.config))
    amped = amp.initialize(ours, "O2", half_dtype=torch.float16)
    opt = FusedAdam(ours.parameters(), lr=lr, master_weights=True)
    state = amped.scaler_state
    tids, tlab = torch.from_numpy(ids).long(), torch.from_numpy(labels).long()
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = amped.model(tids, labels=tlab).mean()
        assert loss.dtype == torch.float16
        amped.scaler.scale_loss(loss, state).backward()
        if i == force:
            ours.lm_head.grad[0, 0] = float("inf")
        found = amped.scaler.has_overflow([p.grad for p in ours.parameters()])
        opt.step(grad_scale=state.scale, found_inf=found)
        state = amped.scaler.update(state, found)
        jloss, jfound, jsst = jlog[i]
        assert float(loss.detach()) == jloss and bool(found) == jfound
        for f in ("scale", "growth_tracker", "hysteresis_tracker",
                  "unskipped"):
            assert getattr(state, f).item() == np.asarray(
                getattr(jsst, f)).item(), (i, f)
    assert [f for _, f, _ in jlog] == [True, False, True, False]
    assert float(state.scale) == 2.0 ** 14 and int(state.unskipped) == 2

    conv = lambda tree: llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                              ours.config)
    ref_master, ref_m, ref_v = (conv(jstate[1].master_params),
                                conv(jstate[0].exp_avg),
                                conv(jstate[0].exp_avg_sq))
    grad1 = conv(g1)
    for name, p in ours.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == 2
        assert torch.equal(p.detach(), st["master_param"].to(p.dtype)), name
        g = grad1[name].float().abs().numpy()
        ng = 2.0 ** -8 * g.max()
        tol = 1e-6 + 4 * lr * ng / (g + ng)
        diff = np.abs(st["master_param"].numpy() - ref_master[name].numpy())
        assert (diff <= tol).all(), (name, (diff / tol).max())
        np.testing.assert_allclose(st["exp_avg"].numpy(), ref_m[name].numpy(),
                                   rtol=0, atol=ng, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   ref_v[name].numpy(), rtol=0,
                                   atol=2 * ng * g.max(), err_msg=name)
