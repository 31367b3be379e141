"""The L1 convergence cross product: the counterpart of
``examples/imagenet/run_convergence.py``.

    python -m apex_tpu_torch.examples.imagenet_run_convergence [--steps 12]
    python -m apex_tpu_torch.examples.imagenet_run_convergence --device cpu \\
        --arch resnet10 --image-size 32 --batch-size 8 --num-classes 10 --steps 8

Trains the ImageNet example (:func:`~apex_tpu_torch.examples.
imagenet_main.run_training`) under O0, the fp32 baseline, then under
every (opt level O1-O3 x loss scale) combination, and holds each loss
trace to the baseline's: within ``rtol`` / ``atol`` after the leading
steps a dynamic scaler skips, and falling.  Prints one row a combination
and exits 1 if any diverges.  Each run trains one process with local
batch norms (``run_training(distributed=False)``): the cross product
compares precisions, not data-parallel worlds.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional, Sequence

import numpy as np

from apex_tpu_torch.examples.imagenet_main import run_training
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["OPT_LEVELS", "LOSS_SCALES", "count_scaler_skips",
           "run_cross_product", "main"]

OPT_LEVELS = ["O0", "O1", "O2", "O3"]
LOSS_SCALES = [None, 1.0, 128.0, "dynamic"]


def count_scaler_skips(trace, max_skips=3):
    """Leading steps skipped by dynamic-loss-scale backoff: the loss stays
    at its initial value while the scaler halves down from 65536."""
    skips = 0
    while (skips < max_skips and skips + 1 < len(trace)
           and np.isclose(trace[skips + 1], trace[0], rtol=1e-5)):
        skips += 1
    return skips


def run_cross_product(steps=12, image_size=64, batch_size=16, num_classes=100,
                      arch="resnet18", half="bf16", lr=0.05, rtol=0.15,
                      atol=0.25, verbose=True, *, device="cuda",
                      init_state=None,
                      on_run: Optional[Callable[[str, dict], None]] = None):
    """Returns ``(results, failures)``: each combination's loss trace by
    name (``"O0/none"`` the baseline, ``"O2/128.0"`` ...) and the names
    that diverged.  ``init_state`` (a ``state_dict``) starts every run
    from the same weights in place of the seeded init; ``on_run(name,
    out)`` sees each run's :func:`run_training` result as it ends."""
    device = resolve_device(device)
    common = dict(arch=arch, steps=steps, image_size=image_size,
                  batch_size=batch_size, num_classes=num_classes, lr=lr,
                  verbose=False, device=device, distributed=False,
                  init_state=init_state)
    out = run_training(opt_level="O0", **common)
    if on_run is not None:
        on_run("O0/none", out)
    baseline = out["losses"]
    results, failures = {"O0/none": baseline}, []
    for level in OPT_LEVELS[1:]:  # O0 is the baseline; scaling is moot there
        for scale in LOSS_SCALES:
            name = f"{level}/{scale if scale is not None else 'none'}"
            out = run_training(opt_level=level, half=half, loss_scale=scale,
                               **common)
            if on_run is not None:
                on_run(name, out)
            trace = results[name] = out["losses"]
            # a dynamic scaler backs off from 65536 by skipping early
            # steps: the converging trace is O0's, delayed by the skips
            skips = count_scaler_skips(trace)
            close = np.allclose(trace[skips:],
                                baseline[:len(baseline) - skips],
                                rtol=rtol, atol=atol)
            decreasing = trace[-1] < trace[0]
            status = "OK" if (close and decreasing) else "DIVERGED"
            if status != "OK":
                failures.append(name)
            if verbose:
                print(f"{name:>14}: first={trace[0]:.4f} last={trace[-1]:.4f} "
                      f"max|Δ|={np.abs(np.array(trace) - baseline).max():.4f} "
                      f"{status}", flush=True)
    return results, failures


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the cross product; exits 1 if any combination diverges, else
    returns each combination's trace."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--num-classes", type=int, default=100)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--half", default="bf16", choices=["bf16", "fp16"])
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rtol", type=float, default=0.15)
    ap.add_argument("--atol", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = vars(ap.parse_args(argv))
    results, failures = run_cross_product(**args)
    if failures:
        print(f"FAILED combos: {failures}")
        sys.exit(1)
    print("all combos converged within tolerance of O0")
    return results


if __name__ == "__main__":
    main()
