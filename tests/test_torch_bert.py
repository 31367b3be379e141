"""apex_tpu_torch's BERT (standalone_bert) and its pretraining example
against apex_tpu's on carried-over weights.

One JAX ``BertModel`` (2 layers, hidden 64, 4 heads of 16, vocab 128,
s 64, fp32) is initialised in JAX; its parameters go to the port through
numpy and ``bert_params_from_jax``.  The inputs come from numpy with fixed
seeds: ids, a ``[b, s]`` padding mask (1 keep, 0 pad) with a pad tail in
each row, and the example's masked-LM / NSP labels.  The JAX side runs its
Pallas kernels in interpret mode.  Tolerances: logits, per-token losses
and NSP logits at ``atol = 1e-4`` (fp32 through two layers, sums in
another order); each gradient of the MLM + NSP loss within ``1e-4
max|g| + 1e-4 |g|`` of JAX's; three ``bert_pretrain`` steps'
losses at ``1e-4`` of the JAX example's step (``FusedLAMB(lr=1e-3)``).
DDP: a gloo world of 2 trains each rank on its half of the batch and
averages the gradients; its losses and parameters equal, at ``1e-6``, one
process that averages the two halves' gradients itself.

This module imports JAX only inside its fixtures and tests: a rank of a
spawned world imports it to find its function.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.examples import bert_pretrain as bp
from apex_tpu_torch.models import bert_params_from_jax
from apex_tpu_torch.transformer import testing as ttesting
from apex_tpu_torch.transformer.testing import BertModel
from apex_tpu_torch.transformer.testing.distributed import run_world

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_sequence_length=64)
B, S = 4, 64
ARGV = ["--device", "cpu", "--layers", "2", "--hidden", "64", "--heads",
        "4", "--vocab", "128", "--seq", "64", "--batch", "4", "--seed", "3"]


@pytest.fixture(scope="module")
def jax_params():
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.testing import BertModel as JaxBert

    params = JaxBert(**CFG).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def _batch(seed=0):
    return bp.synth_batch(np.random.default_rng(seed), B, S,
                          CFG["vocab_size"])


def _torch_model(params, flash: bool) -> BertModel:
    model = BertModel(**CFG, use_flash_attention=flash, device="cpu")
    model.load_state_dict(bert_params_from_jax(params, CFG["num_layers"]))
    return model


def _jax_loss_fn(flash, batch):
    """The JAX example's loss (examples/bert/pretrain.py) at dp 1."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.testing import BertModel as JaxBert

    model = JaxBert(**CFG, use_flash_attention=flash)
    ids, attn, labels, masked, nsp = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        per_tok, binary = model.apply(p, ids.astype(jnp.int32),
                                      attention_mask=attn.astype(jnp.int32),
                                      lm_labels=labels.astype(jnp.int32))
        mlm = jnp.sum(per_tok * masked) / jnp.maximum(jnp.sum(masked), 1)
        lse = jax.nn.logsumexp(binary.astype(jnp.float32), axis=-1)
        tgt = jnp.take_along_axis(binary.astype(jnp.float32),
                                  nsp[:, None].astype(jnp.int32), -1)[:, 0]
        return mlm + jnp.mean(lse - tgt)

    return loss_fn


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "fused-softmax"])
def test_logits_loss_and_nsp_match_jax(monkeypatch, jax_params, flash):
    import jax.numpy as jnp
    from apex_tpu.transformer.testing import BertModel as JaxBert

    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    ids, attn, labels, _, _ = _batch(1)
    assert (attn == 0).any() and (attn == 1).any()
    jmodel = JaxBert(**CFG, use_flash_attention=flash)
    args = (jnp.asarray(ids, jnp.int32),)
    kw = dict(attention_mask=jnp.asarray(attn, jnp.int32))
    ref_logits, ref_nsp = jmodel.apply(jax_params, *args, **kw)
    ref_loss, _ = jmodel.apply(jax_params, *args, **kw,
                               lm_labels=jnp.asarray(labels, jnp.int32))
    model = _torch_model(jax_params, flash)
    t_ids = torch.from_numpy(ids).long()
    t_attn = torch.from_numpy(attn).int()
    with torch.no_grad():
        logits, nsp = model(t_ids, t_attn)
        loss, nsp2 = model(t_ids, t_attn,
                           lm_labels=torch.from_numpy(labels).long())
    assert tuple(logits.shape) == (S, B, CFG["vocab_size"])
    assert tuple(loss.shape) == (B, S) and tuple(nsp.shape) == (B, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(ref_nsp), atol=1e-4,
                               rtol=0)
    assert torch.equal(nsp, nsp2)


def test_flash_and_materialized_agree_on_kept_tokens(jax_params):
    """The two forms of the padding mask give the same kept-token losses
    (pad positions are don't-cares on the flash path)."""
    ids, attn, labels, _, _ = _batch(2)
    out = []
    for flash in (True, False):
        with torch.no_grad():
            loss, nsp = _torch_model(jax_params, flash)(
                torch.from_numpy(ids).long(), torch.from_numpy(attn).int(),
                lm_labels=torch.from_numpy(labels).long())
        out.append((loss, nsp))
    keep = torch.from_numpy(attn).bool()
    torch.testing.assert_close(out[0][0][keep], out[1][0][keep], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "fused-softmax"])
def test_every_gradient_of_the_pretraining_loss_matches_jax(
        monkeypatch, jax_params, flash):
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    batch = _batch(3)
    ref_loss, ref_grads = jax.value_and_grad(_jax_loss_fn(flash, batch))(
        jax.tree.map(jnp.asarray, jax_params))
    ref = bert_params_from_jax(jax.tree.map(np.asarray, ref_grads),
                               CFG["num_layers"])
    model = _torch_model(jax_params, flash)
    loss = bp.loss_fn(model, *bp.to_device(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        g, r = p.grad.numpy(), ref[name].numpy()
        tol = 1e-4 * np.abs(r).max() + 1e-4 * np.abs(r)
        assert (np.abs(g - r) <= tol).all(), (name, np.abs(g - r).max())


def test_three_pretrain_steps_match_the_jax_step(monkeypatch, jax_params):
    """``bert_pretrain.main`` (a world of 1 over gloo) from the JAX init
    against the JAX example's step at dp 1, on the example's batch."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB

    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    batch = bp.synth_batch(np.random.default_rng(3), B, S, CFG["vocab_size"])
    loss_fn = _jax_loss_fn(True, batch)
    jopt = JaxFusedLAMB(lr=1e-3)
    p = jax.tree.map(jnp.asarray, jax_params)
    state = jopt.init(p)
    ref = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p, state = jopt.step(grads, p, state)
        ref.append(float(loss))
    losses = bp.main(ARGV + ["--steps", "3"], state_dict=bert_params_from_jax(
        jax_params, CFG["num_layers"]))
    np.testing.assert_allclose(losses, ref, atol=1e-4, rtol=0)
    assert losses[-1] < losses[0]


def _ddp_rank(rank, world, state):
    """A rank of the DDP world: ``bert_pretrain.main`` over the existing
    group, then this rank's parameters."""
    import apex_tpu_torch.examples.bert_pretrain as bpm

    captured = {}
    orig = bpm.build

    def build(*a, **k):
        model, opt = orig(*a, **k)
        captured["model"] = model
        return model, opt

    bpm.build = build
    losses = bpm.main(ARGV + ["--steps", "3"], state_dict=state)
    return losses, {n: p.detach().numpy().copy()
                    for n, p in captured["model"].named_parameters()}


@pytest.fixture(scope="module")
def ddp_world(jax_params):
    state = bert_params_from_jax(jax_params, CFG["num_layers"])
    return state, run_world(_ddp_rank, 2, args=(state,), timeout=150)


def test_ddp_world_of_two_averages_the_halves(ddp_world):
    state, ranks = ddp_world
    (l0, p0), (l1, p1) = ranks
    assert l0 == l1
    for n in p0:
        np.testing.assert_array_equal(p0[n], p1[n], err_msg=n)
    # one process: the example's batch cut in two, each half's gradient,
    # their mean, one LAMB step; the losses the mean of the halves'
    model, opt = bp.build(2, 64, 4, 128, 64, seed=3, state_dict=state,
                          device="cpu")
    whole = bp.to_device(bp.synth_batch(np.random.default_rng(3), B, S,
                                        CFG["vocab_size"]), "cpu")
    halves = [tuple(t[i * 2:(i + 1) * 2] for t in whole) for i in range(2)]
    ref = []
    for _ in range(3):
        grads, losses = [], []
        for half in halves:
            opt.zero_grad(set_to_none=True)
            loss = bp.loss_fn(model, *half)
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append([p.grad.clone() for p in model.parameters()])
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
        ref.append(sum(losses) / 2)
    np.testing.assert_allclose(l0, ref, atol=1e-6, rtol=0)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p0[n], p.detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


def test_bench_batch_is_the_model_bench_batch():
    """``tools/model_bench.py``'s draws: 15% masked with id 103, lengths in
    [0.9 s, s], no loss on padding; the large card's widths."""
    ids, attn, labels, masked, nsp = bp.bench_batch(
        np.random.default_rng(0), 16, 512, 30592)
    rng = np.random.default_rng(0)
    orig = rng.integers(0, 30592, (16, 512))
    mlm = rng.random((16, 512)) < 0.15
    np.testing.assert_array_equal(labels, orig)
    np.testing.assert_array_equal(ids, np.where(mlm, 103, orig))
    lengths = attn.sum(1)
    assert lengths.min() >= int(512 * 0.9) and lengths.max() <= 512
    assert not (masked & (attn == 0)).any()
    assert set(np.unique(nsp)) <= {0, 1}
    assert bp.LARGE == dict(layers=24, hidden=1024, heads=16, vocab=30592,
                            seq=512, batch=16)
    assert ttesting.bert_model_provider(device="cpu",
                                        num_layers=1).num_layers == 1


def test_converter_rejects_missing_and_extra_keys(jax_params):
    tree = dict(jax_params["params"])
    tree.pop("pooler")
    with pytest.raises(ValueError, match="missing.*pooler"):
        bert_params_from_jax(tree, 2)
    with pytest.raises(ValueError, match="unconsumed.*pooler"):
        bert_params_from_jax(jax_params, 2, add_binary_head=False)
    sd = bert_params_from_jax(jax_params, 2)
    k = jax_params["params"]["lm_head"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(sd["lm_head.dense.weight"].numpy(),
                                  np.asarray(k).T)
