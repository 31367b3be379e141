"""``apex_tpu_torch.examples.dcgan_main_amp`` against
``examples/dcgan/main_amp.py`` on the CPU.

- The two networks against flax at the JAX example's sizes (nz 64, ngf
  32, ndf 32), from the JAX init carried by
  ``convert.dcgan_params_from_jax``: the transposed kernels' flip, the
  norm over each pixel's channels and the two flatten orders; outputs and
  every gradient within 1e-5 of the largest.
- The training run: JAX's ``main()`` under a patched ``sys.argv`` returns
  the last step's ``(Loss_D, Loss_G)``; the port's ``train`` from the same
  initial parameters (the key split of ``main_amp.py:88-91``) and the same
  numpy draws gives them within 1e-5 relative at O0 (measured 2e-7) and
  2e-3 at O2 fp16 (measured 1.7e-4: half products round in another
  order), and the same printed scales.  The JAX runs share one
  module-scoped fixture.
- A forced overflow: an inf in one loss's gradients skips only the step
  of the optimizer that loss feeds, and only that loss's scaler halves.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch.examples import dcgan_main_amp as pdc
from apex_tpu_torch.models.convert import (
    conv_transpose_params_from_jax,
    dcgan_params_from_jax,
)

ROOT = Path(__file__).resolve().parent.parent
NZ = 64
RUNS = {"O0": ([], torch.bfloat16, 1e-5),
        "O2_fp16": (["--half", "fp16"], torch.float16, 2e-3)}


def _jax_dcgan():
    name = "apex_tpu_examples_dcgan_main_amp"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / "dcgan" / "main_amp.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _scales(text: str):
    return [float(s) for s in re.findall(r"scale (\S+)", text)]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX example's init (``main_amp.py:88-91``) as numpy and the
    port's ``state_dict``s, and ``main()``'s result and printed scales at
    steps 1 and 4, O0 and O2 fp16, batch 8."""
    import jax
    import jax.numpy as jnp

    jdc = _jax_dcgan()
    netG, netD = jdc.Generator(nz=NZ), jdc.Discriminator()
    kg, kd, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    g = jax.tree.map(np.asarray, netG.init(kg, jnp.zeros((1, NZ))))
    d = jax.tree.map(np.asarray, netD.init(kd, jnp.zeros((1, 32, 32, 3))))
    runs = {}
    argv = sys.argv
    try:
        for key, (extra, _, _) in RUNS.items():
            level = key.split("_")[0]
            for steps in (1, 4):
                sys.argv = ["main_amp.py", "--steps", str(steps), "--batch",
                            "8", "--opt-level", level] + extra
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    result = jdc.main()
                runs[key, steps] = (result, _scales(buf.getvalue()))
    finally:
        sys.argv = argv
    return dict(jdc=jdc, netG=netG, netD=netD, g=g, d=d,
                state=dcgan_params_from_jax(g, d), runs=runs)


def _rel_close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()) + 1e-12)


def test_generator_output_and_gradients_match_flax(jax_side):
    import jax
    import jax.numpy as jnp

    netG, g = jax_side["netG"], jax_side["g"]
    z = np.random.default_rng(3).standard_normal((5, NZ)).astype(np.float32)
    cot = np.random.default_rng(4).standard_normal((5, 32, 32, 3)).astype(
        np.float32)

    @jax.jit
    def out_and_grads(p):
        out, vjp = jax.vjp(lambda p: netG.apply(p, jnp.asarray(z)), p)
        return out, vjp(jnp.asarray(cot))[0]

    out, grads = out_and_grads(g)
    model = pdc.Generator(NZ, device="cpu")
    model.load_state_dict(jax_side["state"][0])
    got = model(torch.from_numpy(z))
    assert got.shape == (5, 3, 32, 32)
    _rel_close(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(out),
               1e-5)
    got.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    want = dcgan_params_from_jax(jax.tree.map(np.asarray, grads),
                                 jax_side["d"])[0]
    for name, p in model.named_parameters():
        _rel_close(p.grad.numpy(), want[name].numpy(), 1e-5)


def test_discriminator_output_and_gradients_match_flax(jax_side):
    import jax
    import jax.numpy as jnp

    netD, d = jax_side["netD"], jax_side["d"]
    x = np.random.default_rng(5).standard_normal((5, 32, 32, 3)).astype(
        np.float32)
    out, grads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jnp.sin(netD.apply(p, jnp.asarray(x))))))(d)
    model = pdc.Discriminator(device="cpu")
    model.load_state_dict(jax_side["state"][1])
    logits = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert logits.shape == (5,)
    loss = torch.sin(logits).sum()
    np.testing.assert_allclose(float(loss.detach()), float(out), rtol=1e-5,
                               atol=1e-6)
    loss.backward()
    want = dcgan_params_from_jax(jax_side["g"],
                                 jax.tree.map(np.asarray, grads))[1]
    for name, p in model.named_parameters():
        _rel_close(p.grad.numpy(), want[name].numpy(), 1e-5)


def test_transposed_kernel_is_flipped():
    """flax's ``ConvTranspose`` does not flip its kernel; the converter
    flips it for ``nn.ConvTranspose2d``, which does."""
    k = np.arange(2 * 2 * 1 * 1, dtype=np.float32).reshape(2, 2, 1, 1)
    w = conv_transpose_params_from_jax(k)
    assert w.shape == (1, 1, 2, 2)
    np.testing.assert_array_equal(w[0, 0].numpy(), k[::-1, ::-1, 0, 0])


def test_channel_norm_is_per_pixel():
    """Each pixel normalized over its channels: a pixel's channels have
    mean 0 and variance 1 - eps-ish, whatever the other pixels hold."""
    norm = pdc.ChannelLayerNorm(8, device="cpu")
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    x[:, :, 0, 0] *= 100.0
    y = norm(x)
    torch.testing.assert_close(y.mean(1), torch.zeros(2, 4, 4), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(y.var(1, unbiased=False),
                               torch.ones(2, 4, 4), rtol=0, atol=1e-3)


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("key", list(RUNS))
def test_train_matches_jax_main(jax_side, key, steps, capsys):
    _, half, tol = RUNS[key]
    (want_d, want_g), want_scales = jax_side["runs"][key, steps]
    out = pdc.train(steps=steps, batch=8, nz=NZ, opt_level=key.split("_")[0],
                    half=half, device="cpu", init=jax_side["state"])
    l0, l1, l2 = out["losses"][-1]
    np.testing.assert_allclose(l0 + l1, want_d, rtol=tol)
    np.testing.assert_allclose(l2, want_g, rtol=tol)
    assert _scales(capsys.readouterr().out) == want_scales
    assert out["scales"][-1][0] == want_scales[-1]
    assert not any(any(f) for f in out["found_inf"])


def _snapshot(model, opt):
    state = {id(p): {k: v.clone() for k, v in opt.state[p].items()
                     if torch.is_tensor(v)} for p in model.parameters()}
    return [p.detach().clone() for p in model.parameters()], state


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


def _same_bits(model, opt, snap):
    params, state = snap
    return (all(torch.equal(_bits(p), _bits(q))
                for p, q in zip(model.parameters(), params))
            and all(torch.equal(_bits(opt.state[p][k]), _bits(v))
                    for p in model.parameters()
                    for k, v in state[id(p)].items()))


@pytest.mark.parametrize("loss_id", [1, 2])
def test_forced_overflow_skips_only_its_optimizer(loss_id):
    """fp16 O2 after 2 steps: an inf written into loss 1's scaled
    gradients leaves every discriminator parameter, master and Adam
    moment and its step count as they were, bit for bit, takes the
    generator's step and halves scaler 1 alone; into loss 2's, the
    mirror image."""
    tr = pdc.DCGANTrainer(nz=16, ngf=8, ndf=8, opt_level="O2",
                          half=torch.float16, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        tr.step(*pdc.synthetic_batch(rng, 4, 16, "cpu"))
    d_snap = _snapshot(tr.netD, tr.optD)
    g_snap = _snapshot(tr.netG, tr.optG)
    before = [float(s.scale) for s in tr.states]

    def hook(i, grads):
        if i == loss_id:
            grads[0].view(-1)[3] = float("inf")

    _, flags = tr.step(*pdc.synthetic_batch(rng, 4, 16, "cpu"),
                       grad_hook=hook)
    assert [bool(f) for f in flags] == [i == loss_id for i in range(3)]
    skipped, taken = ((tr.netD, tr.optD, d_snap), (tr.netG, tr.optG, g_snap))
    if loss_id == 2:
        skipped, taken = taken, skipped
    assert _same_bits(*skipped)
    assert not _same_bits(*taken)
    after = [float(s.scale) for s in tr.states]
    assert after == [b / 2 if i == loss_id else b
                     for i, b in enumerate(before)]


def test_generator_loss_leaves_no_gradient_on_the_discriminator():
    tr = pdc.DCGANTrainer(nz=16, ngf=8, ndf=8, opt_level="O0", device="cpu")
    tr.step(*pdc.synthetic_batch(np.random.default_rng(0), 4, 16, "cpu"))
    assert all(p.grad is None for p in tr.d_params + tr.g_params)


def test_main_runs_on_the_cpu(capsys):
    loss_d, loss_g = pdc.main(["--device", "cpu", "--steps", "2", "--batch",
                               "4", "--nz", "16"])
    assert np.isfinite(loss_d) and np.isfinite(loss_g)
    text = capsys.readouterr().out
    assert "[0/2] Loss_D" in text and "[1/2] Loss_D" in text
    assert text.rstrip().endswith("dcgan amp OK")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    for make in (lambda: pdc.train(steps=1), lambda: pdc.main(["--steps", "1"]),
                 lambda: pdc.Generator(), lambda: pdc.Discriminator(),
                 lambda: pdc.DCGANTrainer()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
