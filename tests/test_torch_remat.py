"""Activation recompute in the port's transformer stack and Llama.

A small GPT (2 layers, hidden 64, 2 heads of 32, vocab 128, b 2 x s 32,
fp32; seeded weights) under each policy of
``ParallelTransformer(activations_checkpoint_policy=)`` against the same
weights without recompute: loss at ``rtol 1e-6`` and every gradient at
``rtol 1e-5, atol 1e-6``, as ``tests/test_transformer_models.py`` holds
the JAX policies; and against JAX's ``GPTModel`` with the same policy
(its Pallas kernels in interpret mode) on carried-over weights, at
``test_torch_gpt.py``'s tolerances (loss ``1e-5``, each gradient within
``1e-4 max|g| + 1e-4 |g|``).  What each policy recomputes is counted in
the backward alone, by counting calls of the plain norm, attention and
softmax functions and the ``aten.mm`` / ``aten.bmm`` ops: per layer
``None`` re-runs both norms, the attention and three of the four linear
products (the fourth's output is no saved tensor of the backward);
``"dots"`` the norms and the flash forward (on the materialized path the
softmax) and no product; ``"dots_no_batch"`` as ``"dots"``, plus the two
batched attention products on the materialized path;
``"except_activations"`` only the two norm outputs (and the gelu).
Under dropout every policy gives the gradients of the forward's masks,
bit for bit, and leaves the caller's generator where the forward left it.
``LlamaForCausalLM(activations_checkpoint=True)`` gives the gradients of
the model without it, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu.transformer.testing import GPTModel as JaxGPT
from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from apex_tpu_torch.models import gpt_params_from_jax
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.ops import softmax as sm
from apex_tpu_torch.transformer import recompute
from apex_tpu_torch.transformer.testing import GPTModel
from apex_tpu_torch.transformer.testing import standalone_transformer_lm as tlm

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=2,
           vocab_size=128, max_sequence_length=32)
L = CFG["num_layers"]
POLICIES = [None, "dots", "dots_no_batch", "except_activations"]
IDS = ["full", "dots", "dots_no_batch", "except_activations"]


def _ids(seed=0):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"], (2, 32))
    return torch.from_numpy(ids).long()


def _model(flash=True, policy=None, remat=False, state=None):
    model = GPTModel(**CFG, use_flash_attention=flash,
                     activations_checkpoint=remat,
                     activations_checkpoint_policy=policy, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    return model


def _loss_grads(model, ids):
    loss = model(ids, labels=torch.roll(ids, -1, dims=1)).mean()
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "materialized"])
@pytest.mark.parametrize("policy", POLICIES, ids=IDS)
def test_policy_matches_no_recompute(policy, flash):
    ids = _ids(1)
    base = _model(flash)
    ref_loss, ref = _loss_grads(base, ids)
    model = _model(flash, policy, remat=True, state=base.state_dict())
    loss, grads = _loss_grads(model, ids)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for n in ref:
        np.testing.assert_allclose(grads[n].numpy(), ref[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("policy", POLICIES, ids=IDS)
def test_policy_matches_the_jax_policy(monkeypatch, policy):
    monkeypatch.setenv("APEX_TPU_KERNELS", "interpret")
    kw = (dict(activations_checkpoint=True) if policy is None
          else dict(activations_checkpoint_policy=policy))
    jmodel = JaxGPT(**CFG, **kw)
    ids = _ids(2).numpy().astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(ids))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jnp.asarray(ids),
                               labels=jnp.asarray(labels)).mean())(params)
    ref = gpt_params_from_jax(jax.tree.map(np.asarray, ref_grads), L)
    model = _model(True, policy, remat=True, state=gpt_params_from_jax(
        jax.tree.map(np.asarray, params), L))
    loss, grads = _loss_grads(model, torch.from_numpy(ids).long())
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5)
    assert set(grads) == set(ref)
    for n, g in grads.items():
        r = ref[n].numpy()
        tol = 1e-4 * np.abs(r).max() + 1e-4 * np.abs(r)
        assert (np.abs(g.numpy() - r) <= tol).all(), (n, np.abs(g.numpy() - r).max())


class _Ops(TorchDispatchMode):
    """Counts the product ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.counts["mm"] += 1
        elif name in ("bmm", "baddbmm"):
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(monkeypatch, model, ids):
    """What the backward alone runs: plain norm / attention / softmax
    forwards and the product ops."""
    calls = {"norm": 0, "flash": 0, "softmax": 0}
    for mod, key in ((ln, "norm"), (fa, "flash"), (sm, "softmax")):
        orig = mod._plain_forward

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "_plain_forward", counted)
    loss = model(ids, labels=torch.roll(ids, -1, dims=1)).mean()
    for k in calls:
        calls[k] = 0
    with _Ops() as ops:
        loss.backward()
    monkeypatch.undo()
    return dict(calls, **ops.counts)


# per layer, what the backward re-runs beyond the plain backward.  Whole-
# layer recompute re-runs three of the four linear products: the last,
# ``dense_4h_to_h``, makes nothing the backward needs (its weight gradient
# reads its input), and torch.utils.checkpoint stops once the last saved
# tensor is back, as XLA drops a dead recomputation
_EXTRA = {
    (None, True): dict(norm=2, flash=1, softmax=0, mm=3),
    ("dots", True): dict(norm=2, flash=1, softmax=0, mm=0),
    ("dots_no_batch", True): dict(norm=2, flash=1, softmax=0, mm=0),
    ("except_activations", True): dict(norm=2, flash=0, softmax=0, mm=0),
    (None, False): dict(norm=2, flash=0, softmax=1, mm=3, bmm=2),
    ("dots", False): dict(norm=2, flash=0, softmax=1, mm=0, bmm=0),
    ("dots_no_batch", False): dict(norm=2, flash=0, softmax=1, mm=0, bmm=2),
    ("except_activations", False): dict(norm=2, flash=0, softmax=0, mm=0,
                                        bmm=0),
}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "materialized"])
@pytest.mark.parametrize("policy", POLICIES, ids=IDS)
def test_each_policy_recomputes_what_the_jax_policy_does(monkeypatch, policy,
                                                         flash):
    ids = _ids(4)
    base = _model(flash)
    plain = _backward_counts(monkeypatch, base, ids)
    model = _model(flash, policy, remat=True, state=base.state_dict())
    got = _backward_counts(monkeypatch, model, ids)
    extra = {k: got[k] - plain[k] for k in _EXTRA[(policy, flash)]}
    assert extra == {k: v * L for k, v in _EXTRA[(policy, flash)].items()}
    assert plain["norm"] == plain["flash"] == plain["softmax"] == 0


def test_except_activations_drops_three_tensors_a_layer(monkeypatch):
    """The two norm outputs and the gelu output of each layer are kept as
    recipes, not tensors; the recipes run once each in the backward."""
    made = []
    orig = recompute._Dropped.__init__

    def spy(self, tag, t):
        made.append(tag)
        orig(self, tag, t)

    monkeypatch.setattr(recompute._Dropped, "__init__", spy)
    model = _model(True, "except_activations", remat=True)
    ids = _ids(5)
    loss = model(ids, labels=torch.roll(ids, -1, dims=1)).mean()
    assert len(made) == 3 * L and len(set(map(id, made))) == 3 * L
    loss.backward()
    assert all(t.value is None and t.pending == 0 for t in made)
    assert not recompute._ACTIVE


def test_except_activations_refuses_an_input_written_in_place():
    """A recipe's input written in place between the forward and the
    backward makes the recompute raise, as autograd does for a saved
    tensor, in place of recomputing another activation."""
    stack = tlm.ParallelTransformer(
        2, 64, 2, activations_checkpoint_policy="except_activations",
        device="cpu", generator=torch.Generator().manual_seed(11))
    x = torch.randn(32, 2, 64, generator=torch.Generator().manual_seed(12),
                    requires_grad=True)
    h = x * 1.0
    y = stack(h)
    h.mul_(2.0)
    with pytest.raises(RuntimeError, match="recompute recipe was modified"):
        y.square().mean().backward()


@pytest.mark.parametrize("policy", POLICIES, ids=IDS)
def test_dropout_under_recompute_draws_the_same_masks(policy):
    torch.manual_seed(0)
    kw = dict(hidden_dropout=0.2, attention_dropout=0.2, device="cpu",
              generator=torch.Generator().manual_seed(6))
    x0 = torch.randn(32, 2, 64, generator=torch.Generator().manual_seed(7))
    out = {}
    for name, remat in (("plain", False), ("remat", True)):
        stack = tlm.ParallelTransformer(
            2, 64, 2, activations_checkpoint=remat,
            activations_checkpoint_policy=policy if remat else None, **dict(
                kw, generator=torch.Generator().manual_seed(6)))
        x = x0.clone().requires_grad_()
        g = torch.Generator().manual_seed(8)
        y = stack(x, deterministic=False, dropout_generator=g)
        after_forward = g.get_state()
        y.square().mean().backward()
        assert torch.equal(g.get_state(), after_forward)
        out[name] = (y.detach(), x.grad,
                     [p.grad for p in stack.parameters()], after_forward)
    (y0, gx0, gp0, s0), (y1, gx1, gp1, s1) = out["plain"], out["remat"]
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    assert torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(gp0, gp1))


def test_llama_activations_checkpoint_gives_the_same_gradients(monkeypatch):
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=64)
    ids = _ids(9)
    res = {}
    for remat in (False, True):
        model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(10),
                                 activations_checkpoint=remat)
        counts = _backward_counts(monkeypatch, model, ids)
        model.zero_grad(set_to_none=True)
        res[remat] = _loss_grads(model, ids) + (counts,)
    assert torch.equal(res[True][0], res[False][0])
    for n, g in res[False][1].items():
        assert torch.equal(res[True][1][n], g), n
    assert res[True][2]["norm"] - res[False][2]["norm"] == 2 * 2
    assert res[True][2]["flash"] - res[False][2]["flash"] == 2
    # no recompute without a gradient: an evaluation forward runs each
    # layer once
    model = LlamaForCausalLM(cfg, device="cpu", activations_checkpoint=True)
    with torch.no_grad():
        assert torch.isfinite(model(ids)).all()


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="activations_checkpoint_policy"):
        tlm.ParallelTransformer(1, 64, 2, activations_checkpoint_policy="all",
                                device="cpu")
    assert recompute.POLICIES == tuple(POLICIES)
