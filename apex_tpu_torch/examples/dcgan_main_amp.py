"""DCGAN with mixed precision, two models, two optimizers and three losses:
the counterpart of ``examples/dcgan/main_amp.py``.

    python -m apex_tpu_torch.examples.dcgan_main_amp [--opt-level O2] [--half bf16|fp16]
    python -m apex_tpu_torch.examples.dcgan_main_amp --device cpu --steps 8

The generator and the discriminator are the JAX example's, in NCHW:

- ``Generator``: ``z [b, nz]`` through a dense layer to ``[b, 4 ngf, 4,
  4]``, two stride-2 4x4 transposed convolutions each followed by a
  norm over each pixel's channels (flax's ``nn.LayerNorm`` on NHWC,
  epsilon 1e-6) and a ReLU, a third to ``[b, nc, 32, 32]``, a tanh;
- ``Discriminator``: three stride-2 4x4 convolutions (padding 1, flax's
  ``"SAME"`` at these sizes) with a leaky ReLU of slope 0.2, then a dense
  layer over the flattened ``[b, 4 ndf, 4, 4]`` to one logit.

Each layer computes in the promoted dtype of its input and weights, as
flax's layers do (under O2 the generator's fp32 norms lift the layers
after them to fp32).  One ``amp.initialize(..., num_losses=3)`` gives the
three loss scalers: errD_real is loss 0, errD_fake loss 1 and errG loss 2.
Each loss's gradients are taken by ``torch.autograd.grad`` and unscaled
with its own scaler before the next backward; the discriminator steps from
the sum of its two unscaled gradients and skips the step if either
overflowed, the generator from its own.  The generator's loss runs through
the discriminator, whose parameters get no gradient from it.  The losses
reported are the scaled ones divided by the scale each was scaled by.
Both optimizers are :class:`~apex_tpu_torch.optimizers.FusedAdam` (lr
2e-4, betas 0.5 and 0.999), one ``mt_adam`` launch a step each; each
overflow check is one ``mt_scale`` launch.  The data are the JAX example's
seeded draws: smooth 8x8 blobs upsampled to 32x32 as the real images,
normal noise as ``z``.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdam

__all__ = ["ChannelLayerNorm", "Generator", "Discriminator",
           "bce_with_logits", "synthetic_batch", "DCGANTrainer", "train",
           "main"]


def _promoted(x: torch.Tensor, *params: Optional[torch.Tensor]):
    """``x`` and ``params`` in their promoted dtype (jnp's promotion of a
    layer's input and weights, where torch would raise on a mix)."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return [None if t is None else t.to(dt) for t in (x, *params)]


class ChannelLayerNorm(nn.Module):
    """flax's ``nn.LayerNorm()`` on an NHWC tensor, on NCHW: each pixel
    normalized over its channels (dim 1), statistics in fp32 at least
    (the mean of squares less the squared mean, flax's fast variance),
    epsilon 1e-6, the result in the promoted dtype of the input, ``scale``
    and ``bias``."""

    def __init__(self, channels: int, eps: float = 1e-6, *, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = xf.mean(1, keepdim=True)
        var = ((xf * xf).mean(1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.view(1, -1, 1, 1)
        y = (xf - mu) * mul + self.bias.view(1, -1, 1, 1)
        out = torch.promote_types(torch.promote_types(
            x.dtype, self.scale.dtype), self.bias.dtype)
        return y.to(out)


def _linear(x, layer: nn.Linear):
    return F.linear(*_promoted(x, layer.weight, layer.bias))


def _conv(x, layer: nn.Conv2d):
    x, w, b = _promoted(x, layer.weight, layer.bias)
    return F.conv2d(x, w, b, layer.stride, layer.padding)


def _conv_t(x, layer: nn.ConvTranspose2d):
    x, w, b = _promoted(x, layer.weight, layer.bias)
    return F.conv_transpose2d(x, w, b, layer.stride, layer.padding)


@torch.no_grad()
def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's defaults: every kernel truncated normal (within 2 std) of
    variance 1 / fan_in (``lecun_normal``; a transposed convolution's fan
    in is its input channels times its window), biases 0, norm scales 1."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = (m.weight[:, 0].numel() if isinstance(
                m, nn.ConvTranspose2d) else m.weight[0].numel())
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()


class Generator(nn.Module):
    """``z [b, nz] -> image [b, nc, 32, 32]`` (see the module docstring).
    ``Dense_0``'s output features are ordered (channel, row, column), so
    its output is the NCHW ``[b, 4 ngf, 4, 4]`` as it is."""

    def __init__(self, nz: int = 64, ngf: int = 32, nc: int = 3, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.nz, self.ngf, self.nc = nz, ngf, nc
        self.Dense_0 = nn.Linear(nz, 16 * 4 * ngf, device=device)
        up = dict(kernel_size=4, stride=2, padding=1, device=device)
        self.ConvTranspose_0 = nn.ConvTranspose2d(4 * ngf, 2 * ngf, **up)
        self.LayerNorm_0 = ChannelLayerNorm(2 * ngf, device=device)
        self.ConvTranspose_1 = nn.ConvTranspose2d(2 * ngf, ngf, **up)
        self.LayerNorm_1 = ChannelLayerNorm(ngf, device=device)
        self.ConvTranspose_2 = nn.ConvTranspose2d(ngf, nc, **up)
        _init(self, generator)

    def forward(self, z):
        x = _linear(z, self.Dense_0).view(-1, 4 * self.ngf, 4, 4)
        for conv, norm in ((self.ConvTranspose_0, self.LayerNorm_0),
                           (self.ConvTranspose_1, self.LayerNorm_1)):
            x = torch.relu(norm(_conv_t(x, conv)))
        return torch.tanh(_conv_t(x, self.ConvTranspose_2))


class Discriminator(nn.Module):
    """``image [b, nc, 32, 32] -> logit [b]``.  ``Dense_0``'s input
    features are the NCHW flatten of ``[4 ndf, 4, 4]``."""

    def __init__(self, ndf: int = 32, nc: int = 3, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.ndf, self.nc = ndf, nc
        down = dict(kernel_size=4, stride=2, padding=1, device=device)
        self.Conv_0 = nn.Conv2d(nc, ndf, **down)
        self.Conv_1 = nn.Conv2d(ndf, 2 * ndf, **down)
        self.Conv_2 = nn.Conv2d(2 * ndf, 4 * ndf, **down)
        self.Dense_0 = nn.Linear(16 * 4 * ndf, 1, device=device)
        _init(self, generator)

    def forward(self, x):
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.leaky_relu(_conv(x, conv), 0.2)
        return _linear(x.flatten(1), self.Dense_0)[:, 0]


def bce_with_logits(logits, target: float):
    """``-(t log s(x) + (1 - t) log(1 - s(x)))`` in fp32, averaged: the
    reference's BCELoss on the discriminator's logits."""
    logits = logits.float()
    return torch.mean(torch.clamp_min(logits, 0.0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def synthetic_batch(rng: np.random.Generator, batch: int, nz: int, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's ``(real [b, 3, 32, 32], noise [b, nz])``, fp32 on
    ``device``, from the JAX example's draws on ``rng``: an 8x8 normal
    blob a channel, each value repeated over a 4x4 block, through a tanh;
    then the noise."""
    base = rng.standard_normal((batch, 8, 8, 3))
    noise = rng.standard_normal((batch, nz))
    real = torch.from_numpy(base.astype(np.float32)).to(device)
    real = real.permute(0, 3, 1, 2).repeat_interleave(4, 2)
    real = torch.tanh(real.repeat_interleave(4, 3))
    return real, torch.from_numpy(noise.astype(np.float32)).to(device)


GradHook = Callable[[int, List[torch.Tensor]], None]


class DCGANTrainer:
    """The two models under one amp configuration, their optimizers and
    the three scaler states; :meth:`step` is one training step.

    ``init`` is ``(generator state_dict, discriminator state_dict)``
    (e.g. :func:`~apex_tpu_torch.models.convert.dcgan_params_from_jax`)
    in place of the seeded init."""

    def __init__(self, *, nz: int = 64, ngf: int = 32, ndf: int = 32,
                 lr: float = 2e-4, opt_level: str = "O2",
                 half: torch.dtype = torch.bfloat16, device="cuda",
                 init: Optional[Tuple[dict, dict]] = None):
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(0)
        self.netG = Generator(nz, ngf, device=device, generator=gen)
        self.netD = Discriminator(ndf, device=device, generator=gen)
        if init is not None:
            self.netG.load_state_dict(init[0])
            self.netD.load_state_dict(init[1])
        self.ampD = amp.initialize(self.netD, opt_level, half_dtype=half,
                                   num_losses=3)
        self.ampG = amp.initialize(self.netG, opt_level, half_dtype=half,
                                   num_losses=0)
        self.scaler = self.ampD.scaler
        self.states = list(self.ampD.scaler_states)
        self.d_params = list(self.netD.parameters())
        self.g_params = list(self.netG.parameters())
        self.optD = FusedAdam(self.d_params, lr=lr, betas=(0.5, 0.999),
                              master_weights=self.ampD.policy.master_weights)
        self.optG = FusedAdam(self.g_params, lr=lr, betas=(0.5, 0.999),
                              master_weights=self.ampG.policy.master_weights)

    def _grads(self, loss, params, state, loss_id, hook):
        """The scaled loss's gradients over ``params``, unscaled in fp32,
        and whether the scaled ones held an inf or a NaN; ``hook(loss_id,
        grads)`` sees the scaled gradients first."""
        scaled = self.scaler.scale_loss(loss, state)
        grads = list(torch.autograd.grad(scaled, params))
        if hook is not None:
            hook(loss_id, grads)
        grads, found = self.scaler.unscale(grads, state)
        return scaled.detach() / state.scale, grads, found

    def step(self, real, noise, grad_hook: Optional[GradHook] = None):
        """One step: the discriminator on the real batch (loss 0) and the
        detached fake one (loss 1), then the generator through the updated
        discriminator (loss 2).  Returns the three losses and the three
        overflow flags (0-d device tensors)."""
        s0, s1, s2 = self.states
        with torch.no_grad():
            fake = self.ampG.model(noise)
        l0, g0, inf0 = self._grads(
            bce_with_logits(self.ampD.model(real), 1.0), self.d_params, s0,
            0, grad_hook)
        l1, g1, inf1 = self._grads(
            bce_with_logits(self.ampD.model(fake), 0.0), self.d_params, s1,
            1, grad_hook)
        self.optD.step(grads={p: a + b for p, a, b in
                              zip(self.d_params, g0, g1)},
                       found_inf=inf0 | inf1)
        l2, g2, inf2 = self._grads(
            bce_with_logits(self.ampD.model(self.ampG.model(noise)), 1.0),
            self.g_params, s2, 2, grad_hook)
        self.optG.step(grads=dict(zip(self.g_params, g2)), found_inf=inf2)
        self.states = [self.scaler.update(s, f)
                       for s, f in zip(self.states, (inf0, inf1, inf2))]
        return (l0, l1, l2), (inf0, inf1, inf2)


def train(steps: int = 20, batch: int = 16, nz: int = 64, ngf: int = 32,
          ndf: int = 32, lr: float = 2e-4, opt_level: str = "O2",
          half: torch.dtype = torch.bfloat16, device="cuda",
          init: Optional[Tuple[dict, dict]] = None,
          verbose: bool = True) -> dict:
    """``steps`` steps of the JAX example's loop (see the module
    docstring).  Returns ``{"losses"}`` (each step's ``(errD_real,
    errD_fake, errG)`` as floats), ``"scales"`` (each step's three scales
    after its update), ``"found_inf"`` (each step's three flags),
    ``"step_ms"`` (each step's wall, to its end on the device) and
    ``"trainer"``; prints every fifth step and the last, as JAX does."""
    device = resolve_device(device)
    trainer = DCGANTrainer(nz=nz, ngf=ngf, ndf=ndf, lr=lr,
                           opt_level=opt_level, half=half, device=device,
                           init=init)
    rng = np.random.default_rng(0)
    losses, scales, found, step_ms = [], [], [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for step in range(steps):
        real, noise = synthetic_batch(rng, batch, nz, device)
        sync()
        t0 = time.perf_counter()
        step_losses, flags = trainer.step(real, noise)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(torch.stack(step_losses))
        scales.append(torch.stack([s.scale for s in trainer.states]))
        found.append(torch.stack(flags))
        if verbose and (step % 5 == 0 or step == steps - 1):
            l0, l1, l2 = (float(x) for x in step_losses)
            print(f"[{step}/{steps}] Loss_D {l0 + l1:.4f} Loss_G {l2:.4f} "
                  f"scale {float(trainer.states[0].scale):.0f}", flush=True)
    return dict(losses=[tuple(map(float, x.cpu())) for x in losses],
                scales=[tuple(map(float, x.cpu())) for x in scales],
                found_inf=[tuple(map(bool, x.cpu())) for x in found],
                step_ms=step_ms, trainer=trainer)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float]:
    """Train ``--steps`` steps and return the last step's ``(Loss_D,
    Loss_G)``; raises if a scale or a loss is not finite."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--opt-level", default="O2")
    p.add_argument("--half", default="bf16", choices=["bf16", "fp16"])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    half = torch.bfloat16 if args.half == "bf16" else torch.float16
    out = train(steps=args.steps, batch=args.batch, nz=args.nz, lr=args.lr,
                opt_level=args.opt_level, half=half, device=args.device)
    for s in out["scales"][-1]:
        assert np.isfinite(s)
    l0, l1, l2 = out["losses"][-1]
    assert np.isfinite(l0 + l1 + l2), "non-finite GAN losses"
    print("dcgan amp OK")
    return l0 + l1, l2


if __name__ == "__main__":
    main()
