"""Mixed-precision training with a fused optimizer, in its smallest form:
the counterpart of ``examples/simple/main.py``.

    python -m apex_tpu_torch.examples.simple [--opt-level O2] [--half fp16|bf16]
    python -m apex_tpu_torch.examples.simple --device cpu --half fp16
    python -m apex_tpu_torch.examples.simple --opt-level O1 --half fp16

A two-layer tanh MLP regresses ``sin(sum(x))`` on one fixed batch of 512
points: ``amp.initialize`` casts it by the opt level's policy,
:class:`~apex_tpu_torch.optimizers.FusedAdam` keeps fp32 masters when the
policy asks for them, the loss is scaled before its backward, and the
optimizer unscales the gradients and skips a step whose gradients hold an
inf or a NaN, on the device.  Under fp16 the dynamic scaler starts at
2**16 and backs off as it must.  The script asserts the loss converges, as
the JAX one does.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedAdam

__all__ = ["SimpleMLP", "train", "main"]


class SimpleMLP(nn.Module):
    """``tanh(x @ w1 + b1) @ w2 + b2``, the JAX example's ``apply_fn``."""

    def __init__(self, generator: torch.Generator, device):
        super().__init__()
        rand = lambda *s: torch.randn(*s, generator=generator, device=device)
        self.w1 = nn.Parameter(rand(16, 64) * 0.3)
        self.b1 = nn.Parameter(torch.zeros(64, device=device))
        self.w2 = nn.Parameter(rand(64, 1) * 0.3)
        self.b2 = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x):
        # jnp's promotion of a mixed pair (O1's half input against fp32
        # weights) to the wider dtype, where torch.matmul would raise
        x = x.to(torch.promote_types(x.dtype, self.w1.dtype))
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def train(model: SimpleMLP, x: torch.Tensor, *, opt_level: str,
          half: torch.dtype, steps: int, log_every: int = 50):
    """``steps`` steps of the JAX example's loop on ``model`` and the batch
    ``x`` (targets ``sin(sum(x))``): ``amp.initialize`` at ``opt_level``,
    :class:`FusedAdam` (lr 1e-2, fp32 masters when the policy keeps them),
    the scaled loss's backward, the overflow check and the scaler's
    update.  Returns each step's loss (device tensors) and the last scaler
    state; prints every ``log_every`` steps and the last."""
    y = torch.sin(x.sum(dim=1, keepdim=True))
    amped = amp.initialize(model, opt_level=opt_level, half_dtype=half)
    scaler, state = amped.scaler, amped.scaler_state
    params = list(model.parameters())
    opt = FusedAdam(params, lr=1e-2,
                    master_weights=amped.policy.master_weights)
    losses = []
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((amped.model(x).float() - y) ** 2)
        scaler.scale_loss(loss, state).backward()
        losses.append(loss.detach())
        found_inf = scaler.has_overflow([p.grad for p in params])
        opt.step(grad_scale=state.scale, found_inf=found_inf)
        state = scaler.update(state, found_inf)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:4d}  loss {float(losses[-1]):.6f}  "
                  f"loss_scale {float(state.scale):.1f}  "
                  f"device {x.device.type}", flush=True)
    return losses, state


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train ``--steps`` steps and return the last loss; raises unless it
    is below 0.05."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--half", default="bf16", choices=["bf16", "fp16"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    half = torch.bfloat16 if args.half == "bf16" else torch.float16

    gen = torch.Generator(device=device).manual_seed(0)
    model = SimpleMLP(gen, device)
    x = torch.randn(512, 16, generator=gen, device=device)
    losses, _ = train(model, x, opt_level=args.opt_level, half=half,
                      steps=args.steps)
    last = float(losses[-1])
    if not last < 0.05:
        raise AssertionError(f"did not converge: {last}")
    print("converged OK")
    return last


if __name__ == "__main__":
    main()
