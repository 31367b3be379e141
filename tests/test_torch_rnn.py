"""``apex_tpu_torch.RNN`` against ``apex_tpu.RNN`` on the CPU.

Each cell type, one-way and bidirectional, at 2 layers, T 5, B 3, F 4,
H 6 in fp32: the same weights (a tree in the JAX layout drawn with
numpy, biases nonzero, carried by ``convert.rnn_params_from_jax``) and
the same input
through both packages; the output, every final hidden tensor and every
parameter's gradient of ``sum(output ** 2)`` (``jax.grad`` against
autograd) agree to rtol 1e-4, atol 1e-5 (measured: <= 7e-7 of the
largest gradient).  Then ``batch_first``, the hidden state carried from
one half of a sequence into the other, dropout between layers, and the
factories' default device.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch import RNN as P
from apex_tpu_torch.models.convert import rnn_params_from_jax
from apex_tpu_torch.RNN import rnn as rnn_mod

T, B, F, H, L = 5, 3, 4, 6, 2
RTOL, ATOL = 1e-4, 1e-5
KINDS = {"lstm": "LSTM", "gru": "GRU", "relu": "ReLU", "tanh": "Tanh",
         "mlstm": "mLSTM"}


def _jax_model(kind, bidirectional, x, **kw):
    """The JAX factory's model and a parameter tree of its layout drawn
    with numpy (weights of variance 1 / fan_in, biases of standard
    deviation 0.1, so they count; no JAX init to compile)."""
    from apex_tpu import RNN as J

    model = getattr(J, KINDS[kind])(F, H, L, bidirectional=bidirectional,
                                    **kw)
    rng = np.random.default_rng(7)
    mult = {"lstm": 4, "mlstm": 4, "gru": 3}.get(kind, 1)
    dirs = 2 if bidirectional else 1

    def draw(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    tree = {}
    for layer in range(L):
        fan = F if layer == 0 else H * dirs
        for d in range(dirs):
            leaves = dict(w_ih=draw(fan, mult * H, std=fan ** -0.5),
                          w_hh=draw(H, mult * H, std=H ** -0.5),
                          b_ih=draw(mult * H, std=0.1),
                          b_hh=draw(mult * H, std=0.1))
            if kind == "mlstm":
                leaves.update(w_mih=draw(fan, H, std=fan ** -0.5),
                              w_mhh=draw(H, H, std=H ** -0.5))
            tree[f"layer{layer}_dir{d}"] = leaves
    return model, {"params": tree}


def _port_model(kind, bidirectional, params, **kw):
    model = getattr(P, KINDS[kind])(F, H, L, bidirectional=bidirectional,
                                    device="cpu", **kw)
    model.load_state_dict(rnn_params_from_jax(params))
    return model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["one_way", "bidirectional"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_output_finals_and_gradients_match_jax(kind, bidirectional):
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(0).standard_normal((T, B, F)).astype(np.float32)
    jm, params = _jax_model(kind, bidirectional, x)

    def loss(p):
        out, finals = jm.apply(p, jnp.asarray(x))
        return jnp.sum(out ** 2), (out, finals)

    (_, (out, finals)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)

    pm = _port_model(kind, bidirectional, params)
    got, got_finals = pm(torch.from_numpy(x))
    (got ** 2).sum().backward()
    dirs = 2 if bidirectional else 1
    assert got.shape == (T, B, H * dirs)
    _close(got.detach(), out)
    assert len(got_finals) == len(finals) == L * dirs
    for g, w in zip(got_finals, finals):
        assert len(g) == len(w) == (2 if kind in ("lstm", "mlstm") else 1)
        for a, b in zip(g, w):
            _close(a.detach(), b)
    want = rnn_params_from_jax(jax.tree.map(np.asarray, grads))
    names = {n for n, _ in pm.named_parameters()}
    assert names == set(want)
    if kind == "mlstm":
        assert {"layer0_dir0.w_mih", "layer0_dir0.w_mhh"} <= names
    for name, p in pm.named_parameters():
        _close(p.grad, want[name])


def test_batch_first_matches_jax():
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(1).standard_normal((B, T, F)).astype(np.float32)
    jm, params = _jax_model("lstm", True, x, batch_first=True)
    out, finals = jax.jit(jm.apply)(params, jnp.asarray(x))
    pm = _port_model("lstm", True, params, batch_first=True)
    got, got_finals = pm(torch.from_numpy(x))
    assert got.shape == (B, T, 2 * H)
    _close(got.detach(), out)
    for g, w in zip(got_finals, finals):
        for a, b in zip(g, w):
            _close(a.detach(), b)


@pytest.mark.parametrize("kind", ["lstm", "gru", "mlstm"])
def test_hidden_state_continues_a_sequence(kind):
    """The finals of a sequence's first half fed to its second half give
    the whole sequence's output and finals, in the port and against the
    same continuation in JAX."""
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(2).standard_normal((T, B, F)).astype(np.float32)
    jm, params = _jax_model(kind, False, x)
    pm = _port_model(kind, False, params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        whole, whole_finals = pm(xt)
        a, hid = pm(xt[:2])
        b, finals = pm(xt[2:], hid)
    torch.testing.assert_close(torch.cat([a, b]), whole, rtol=1e-5,
                               atol=1e-6)
    for g, w in zip(finals, whole_finals):
        for u, v in zip(g, w):
            torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-6)
    apply = jax.jit(jm.apply)
    _, jhid = apply(params, jnp.asarray(x[:2]))
    jb, _ = apply(params, jnp.asarray(x[2:]), jhid)
    _close(b, jb)


def test_init_hidden_is_zeros_per_layer_and_direction():
    pm = P.LSTM(F, H, L, bidirectional=True, device="cpu",
                dtype=torch.float64)
    hid = pm.init_hidden(B)
    assert len(hid) == 2 * L
    for h in hid:
        assert len(h) == 2
        for t in h:
            assert t.shape == (B, H) and t.dtype == torch.float64
            assert not t.any()
    assert P.GRU(F, H, 1, device="cpu").init_hidden(B)[0][0].shape == (B, H)
    assert pm.layer0_dir0.w_ih.dtype == torch.float64


def test_bias_false_has_no_bias_leaves():
    pm = P.Tanh(F, H, 1, bias=False, device="cpu")
    assert {n for n, _ in pm.named_parameters()} == {"layer0_dir0.w_ih",
                                                     "layer0_dir0.w_hh"}
    out, _ = pm(torch.zeros(T, B, F))
    assert not out.any()


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_dropout_between_layers_in_training_only(rate, monkeypatch):
    """Training mode drops a share of the features between layers within
    6 binomial deviations of ``rate``, the kept ones scaled by ``1 / (1 -
    rate)`` (flax's ``nn.Dropout``), drawn from the generator given; eval
    mode drops nothing and equals a model with no dropout."""
    calls = []
    real = rnn_mod._dropout

    def spy(x, p, g):
        y = real(x, p, g)
        calls.append((x.detach(), y.detach(), p))
        return y

    monkeypatch.setattr(rnn_mod, "_dropout", spy)
    torch.manual_seed(0)
    layers, h, t, b = 3, 64, 16, 16
    pm = P.LSTM(F, h, layers, dropout=rate, device="cpu",
                generator=torch.Generator().manual_seed(0))
    x = torch.randn(t, b, F, generator=torch.Generator().manual_seed(1))
    out, _ = pm(x, dropout_generator=torch.Generator().manual_seed(2))
    assert len(calls) == layers - 1
    for inp, got, p in calls:
        assert p == rate
        n = inp.numel()
        dropped = int((got == 0).sum())
        assert abs(dropped - rate * n) <= 6 * np.sqrt(n * rate * (1 - rate))
        kept = got != 0
        torch.testing.assert_close(got[kept], inp[kept] / (1 - rate))
    again, _ = pm(x, dropout_generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dropout_generator"):
        pm(x)

    calls.clear()
    pm.eval()
    evaluated, _ = pm(x)
    assert calls == []
    plain = P.LSTM(F, h, layers, device="cpu")
    plain.load_state_dict(pm.state_dict())
    torch.testing.assert_close(evaluated, plain(x)[0], rtol=0, atol=0)


def test_converter_raises_on_a_foreign_leaf():
    tree = {"params": {"layer0_dir0": {"w_ih": np.zeros((F, 4 * H)),
                                       "kernel": np.zeros((2, 2))}}}
    with pytest.raises(ValueError, match="kernel"):
        rnn_params_from_jax(tree)


def test_unknown_cell_type_raises():
    with pytest.raises(ValueError, match="cell_type"):
        P.RNNBackend("lstmx", F, H, device="cpu")


def test_factories_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    for name in ("LSTM", "GRU", "ReLU", "Tanh", "mLSTM"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(P, name)(F, H, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.RNNBackend("gru", F, H)
