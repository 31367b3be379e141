"""``apex_tpu_torch.examples.imagenet_run_convergence`` against
``examples/imagenet/run_convergence.py`` on the CPU.

- ``count_scaler_skips`` equals JAX's on the same traces, edge cases
  included.
- At ``tests/test_convergence_l1.py``'s ``TINY`` size the port's cross
  product, every run started from the JAX driver's init (through
  ``resnet_params_from_jax``), gives O0, O1 and O3 (bf16) traces within
  that file's tolerances (rtol 0.2, atol 0.35) of JAX's ``run_training``,
  and within 1e-2 (measured: 1e-4 at O0, 1e-7 at O1, 1.8e-3 at O3); all
  13 combinations converge.
- ``main`` exits 0 on a converging product and 1 when the tolerances are
  0; every run trains one process with no process group
  (``run_training(distributed=False)``).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch.examples import imagenet_run_convergence as rc
from apex_tpu_torch.models import resnet_params_from_jax

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(arch="resnet10", steps=8, image_size=32, batch_size=8,
            num_classes=10, lr=0.05)
TINY_ARGS = ["--arch", "resnet10", "--steps", "8", "--image-size", "32",
             "--batch-size", "8", "--num-classes", "10", "--lr", "0.05"]
L1_RTOL, L1_ATOL = 0.2, 0.35
CLOSE_ATOL = 1e-2


def _load(name, path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _jax_main():
    return _load("apex_tpu_examples_imagenet_main",
                 ROOT / "examples" / "imagenet" / "main.py")


def _jax_convergence():
    """JAX's harness, whose ``from main import run_training`` is given
    the JAX driver for the length of the import."""
    name = "apex_tpu_examples_imagenet_run_convergence"
    if name in sys.modules:
        return sys.modules[name]
    prev = sys.modules.get("main")
    sys.modules["main"] = _jax_main()
    try:
        return _load(name, ROOT / "examples" / "imagenet" /
                     "run_convergence.py")
    finally:
        if prev is None:
            del sys.modules["main"]
        else:
            sys.modules["main"] = prev


@pytest.mark.parametrize("trace", [
    [], [2.0], [2.0, 2.0], [2.0, 2.0, 2.0, 2.0, 2.0, 1.0],
    [2.0, 2.0, 1.5, 2.0], [2.0, 2.0 * (1 + 5e-6), 1.0],
    [2.0, 2.0 * (1 + 2e-5), 2.0], [3.0, 2.0, 1.0], [1.0, 1.0, 1.0],
], ids=lambda t: "_".join(f"{x:g}" for x in t) or "empty")
@pytest.mark.parametrize("max_skips", [3, 1])
def test_count_scaler_skips_matches_jax(trace, max_skips):
    want = _jax_convergence().count_scaler_skips(trace, max_skips)
    assert rc.count_scaler_skips(trace, max_skips) == want


@pytest.fixture(scope="module")
def tiny():
    """The port's product at ``TINY`` from the JAX init (every run's
    ``run_training`` keywords recorded), and JAX's O0, O1 and O3 traces."""
    import jax
    import jax.numpy as jnp

    jm = _jax_main()
    model = jm.resnet10_ish(TINY["num_classes"], axis_name=None)
    v = model.init(jax.random.PRNGKey(0),
                   jnp.zeros((2, TINY["image_size"], TINY["image_size"], 3)),
                   train=True)
    init = resnet_params_from_jax(jax.tree.map(np.asarray, v))
    results, failures = rc.run_cross_product(
        **TINY, device="cpu", init_state=init, verbose=False)
    want = {level: jm.run_training(opt_level=level, verbose=False,
                                   **TINY)["losses"]
            for level in ("O0", "O1", "O3")}
    return dict(results=results, failures=failures, jax=want)


@pytest.mark.parametrize("name", ["O0/none", "O1/none", "O3/none"])
def test_traces_match_jax_run_training(tiny, name):
    got, want = tiny["results"][name], tiny["jax"][name.split("/")[0]]
    assert len(got) == len(want) == TINY["steps"]
    np.testing.assert_allclose(got, want, rtol=L1_RTOL, atol=L1_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=CLOSE_ATOL)


def test_every_combination_converges(tiny):
    assert tiny["failures"] == []
    assert list(tiny["results"]) == ["O0/none"] + [
        f"{lvl}/{s if s is not None else 'none'}"
        for lvl in rc.OPT_LEVELS[1:] for s in rc.LOSS_SCALES]
    for trace in tiny["results"].values():
        assert len(trace) == TINY["steps"] and trace[-1] < trace[0]


def test_runs_train_one_process_without_a_group(monkeypatch):
    """Every run is ``run_training(distributed=False)`` on the device
    asked for, the baseline at O0 and the rest at each (level, scale)."""
    calls = []

    def spy(**kw):
        calls.append(kw)
        return {"losses": [2.0, 1.0]}

    monkeypatch.setattr(rc, "run_training", spy)
    results, failures = rc.run_cross_product(device="cpu", verbose=False)
    assert failures == [] and len(calls) == len(results) == 13
    assert all(kw["distributed"] is False and kw["device"].type == "cpu"
               for kw in calls)
    assert [(kw["opt_level"], kw.get("loss_scale")) for kw in calls] == [
        ("O0", None)] + [(lvl, s) for lvl in rc.OPT_LEVELS[1:]
                         for s in rc.LOSS_SCALES]
    assert not dist.is_initialized()


def test_main_exits_0_on_a_converging_product(capsys):
    results = rc.main(TINY_ARGS + ["--device", "cpu"])
    assert len(results) == 13
    out = capsys.readouterr().out
    assert out.count(" OK") == 12 and "DIVERGED" not in out
    assert out.rstrip().endswith("all combos converged within tolerance "
                                 "of O0")
    assert not dist.is_initialized()


def test_main_exits_1_when_the_tolerances_are_zero(capsys):
    with pytest.raises(SystemExit) as exc:
        rc.main(["--arch", "resnet10", "--steps", "2", "--image-size", "16",
                 "--batch-size", "4", "--num-classes", "5", "--rtol", "0",
                 "--atol", "0", "--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "FAILED combos" in out and "DIVERGED" in out


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rc.run_cross_product(steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rc.main(["--steps", "1"])
