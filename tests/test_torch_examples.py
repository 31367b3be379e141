"""apex_tpu_torch.examples.simple against examples/simple/main.py.

The port of the JAX package's smallest amp example trains its MLP on the
CPU for the JAX script's default step count (200) under each precision;
the script asserts the loss ends below 0.05, as the JAX one does.  The
JAX script runs too, for the same fp16 case, and both backs off its
initial 2**16 loss scale.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from apex_tpu_torch.examples import simple

ROOT = Path(__file__).resolve().parent.parent


def _jax_default_steps() -> int:
    text = (ROOT / "examples" / "simple" / "main.py").read_text()
    return int(re.search(r'"--steps", type=int, default=(\d+)', text).group(1))


@pytest.mark.parametrize("argv", [
    ["--half", "fp16"], ["--half", "bf16"], ["--opt-level", "O0"],
    ["--opt-level", "O3", "--half", "bf16"]],
    ids=["O2-fp16", "O2-bf16", "O0", "O3-bf16"])
def test_simple_converges_in_the_jax_step_count(argv, capsys):
    steps = _jax_default_steps()
    assert steps == 200
    last = simple.main(argv + ["--device", "cpu", "--steps", str(steps)])
    assert last < 0.05
    out = capsys.readouterr().out
    assert "converged OK" in out
    if "fp16" in argv:
        # the dynamic scaler backed off from 2**16 on the first step
        assert "loss_scale 32768.0" in out.splitlines()[0]


def test_jax_simple_fp16_converges_alike():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "simple" / "main.py"),
         "--half", "fp16"], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "converged OK" in proc.stdout
    first = proc.stdout.splitlines()[0]
    assert "loss_scale" in first and float(first.split("loss_scale")[1].split()[0]) < 2.0 ** 16
