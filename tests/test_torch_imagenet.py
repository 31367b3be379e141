"""The ImageNet example: ``apex_tpu_torch.examples.imagenet_main`` and
``imagenet_data`` against ``examples/imagenet/main.py`` and ``data.py``.

- ``resnet10_ish`` from one JAX init carried by
  ``resnet_params_from_jax``: logits (1e-5) and every gradient (1e-5 of
  the largest) against JAX's at 32^2 and 33^2, so that flax's ``SAME``
  padding is exercised on even and odd sizes (the 7x7/2 stem, the 3x3/2
  convolutions and the max pool pad differently there);
- three O2 bf16 steps of ``run_training`` over DDP and SyncBatchNorm in a
  gloo world of 2 against the JAX driver's ``run_training`` on the same
  global batch of 8 over its 8-device mesh, from the same init: each loss
  within 1e-2 (bf16 convolutions round differently in XLA and PyTorch);
  the same world runs the CLI;
- the real-data path on a small fake ``ImageFolder``: the batches equal
  the JAX module's bit for bit, a decode error reaches the loop through
  the prefetcher, workers match the serial path, and ``run_training``
  trains on it;
- the port's own: the FLOP count, O2's fp32 batch norms, O1's fp32 run,
  and ``--save`` / ``--resume`` on the checkpoint layer against an
  uninterrupted run, bit for bit.

JAX is imported inside the tests only, so the spawned ranks stay
JAX-free.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch.examples import imagenet_data as tdata
from apex_tpu_torch.examples import imagenet_main as im
from apex_tpu_torch.models import resnet_params_from_jax
from apex_tpu_torch.transformer.testing.distributed import run_world

ROOT = Path(__file__).resolve().parent.parent
TRAJ = dict(arch="resnet10", opt_level="O2", half="bf16", batch_size=8,
            image_size=32, num_classes=10, steps=3, lr=0.1, seed=0)
TRAJ_TOL = 1e-2         # measured 2.1e-3 (one process, the same batch)


def _load(name, path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _jax_main():
    return _load("apex_tpu_examples_imagenet_main",
                 ROOT / "examples" / "imagenet" / "main.py")


def _jax_data():
    return _load("apex_tpu_examples_imagenet_data",
                 ROOT / "examples" / "imagenet" / "data.py")


def _jax_init(size, num_classes=10, seed=0):
    """The JAX driver's init: ``resnet10_ish.init(PRNGKey(seed), zeros((2,
    s, s, 3)), train=True)``, as numpy."""
    import jax
    import jax.numpy as jnp

    model = _jax_main().resnet10_ish(num_classes)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, size, size, 3)),
                   train=True)
    return model, v, jax.tree.map(np.asarray, v)


# ---------------------------------------------------------------------------
# the model against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [32, 33])
def test_resnet10_logits_and_grads_match_jax(size):
    import jax
    import jax.numpy as jnp

    jm = _jax_main()
    model, v, tree = _jax_init(size)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4)

    def loss_fn(p):
        logits, _ = model.apply({"params": p, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return jm.cross_entropy(logits, jnp.asarray(y)), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    net = im.resnet10_ish(10, device="cpu")
    net.load_state_dict(resnet_params_from_jax(tree))
    out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = im.cross_entropy(out, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    want = resnet_params_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in net.named_parameters():
        ref = want[name]
        np.testing.assert_allclose(p.grad.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()) + 1e-8,
                                   err_msg=name)


def test_same_padding_differs_from_symmetric_padding():
    """The pads JAX's SAME takes where PyTorch's symmetric ones would
    shift the windows: (2, 3) on the 224 stem, (0, 1) for a 3x3/2 on an
    even size, (1, 1) on an odd one."""
    assert im._same_pads(224, 7, 2) == (2, 3)
    assert im._same_pads(56, 3, 2) == (0, 1)
    assert im._same_pads(33, 3, 2) == (1, 1)
    assert im._same_pads(56, 1, 2) == (0, 0)
    assert im._same_pads(112, 3, 2) == (0, 1)      # the max pool


def test_converter_refuses_a_leaf_it_cannot_place():
    _, _, tree = _jax_init(32)
    tree["params"]["Extra_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="Extra_0"):
        resnet_params_from_jax(tree)


def test_resnet50_flops_match_the_published_count():
    """ResNet-50's forward is 4.09 G multiply-adds an image at 224^2; the
    count is 2 x MACs x 3 a training step."""
    flops = im.conv_flops(im.ResNet(device="meta"), 224, 1)
    assert abs(flops / 6 / 4.09e9 - 1) < 0.01
    assert sum(isinstance(m, im.SyncBatchNorm)
               for m in im.ResNet(device="meta").modules()) == 53


def test_o2_keeps_batch_norms_fp32_and_casts_the_rest():
    from apex_tpu_torch.amp import get_policy

    net = get_policy("O2").cast_params(im.resnet10_ish(10, device="cpu"))
    for name, p in net.named_parameters():
        want = torch.float32 if ".bn" in f".{name}" or "_bn" in name \
            else torch.bfloat16
        assert p.dtype == want, name


def test_bf16_steps_check_no_overflow_and_fp16_steps_do():
    """Without a loss scale (bf16 O2) the update checks no gradient (on
    the card: no ``mt_scale`` launch); with fp16's dynamic scale one check
    decides the step."""
    from apex_tpu_torch.amp import get_policy

    for half, checked in ((torch.bfloat16, False), (torch.float16, True)):
        policy = get_policy("O2", half_dtype=half)
        net = policy.cast_params(im.resnet10_ish(10, device="cpu"))
        opt = im.FusedSGD(net.parameters(), lr=0.1, momentum=0.9,
                          master_weights=True)
        scaler = policy.make_scaler()
        images, labels = im._to_device(*im.synthetic_batch(4, 16, 10, 0),
                                       "cpu")
        _, found_inf, _ = im.train_step(net, opt, images, labels, policy,
                                        scaler, scaler.init("cpu"))
        assert (found_inf is not None) == checked


def test_o1_raises():
    """``run_training`` at O1 raises nothing: it trains in fp32 from half
    images (the JAX model's promotion), its parameters fp32, and with fp16
    under the dynamic scaler.  ``tests/test_torch_amp_o1.py`` holds its
    losses to JAX's."""
    out = im.run_training(arch="resnet10", opt_level="O1", half="fp16",
                          batch_size=4, image_size=16, num_classes=5,
                          steps=2, device="cpu", distributed=False,
                          verbose=False)
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
    assert {p.dtype for p in out["model"].parameters()} == {torch.float32}
    assert out["final_scale"] == 2.0 ** 16


# ---------------------------------------------------------------------------
# the trajectory in a gloo world of 2
# ---------------------------------------------------------------------------


def _world2(rank, world, init, tmp):
    import torch.distributed as dist

    out = im.run_training(device="cpu", init_state=init, verbose=False,
                          **TRAJ)
    res = dict(losses=out["losses"], found_inf=out["found_inf"],
               # the DDP broadcast and reduction keep the replicas equal
               fc=out["model"].fc.weight.detach().float().numpy())
    cli = im.main(["--device", "cpu", "--arch", "resnet10", "--image-size",
                   "16", "--batch-size", "4", "--steps", "3", "--num-classes",
                   "5", "--save", str(Path(tmp) / f"ckpt_{rank}")])
    res["cli_losses"] = cli["losses"]
    res["world"] = dist.get_world_size()
    return res


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    _, _, tree = _jax_init(TRAJ["image_size"])
    init = resnet_params_from_jax(tree)
    tmp = tmp_path_factory.mktemp("imagenet_world")
    return run_world(_world2, 2, args=(init, str(tmp)), timeout=150)


def test_o2_bf16_trajectory_over_ddp_matches_jax_run_training(world2):
    want = _jax_main().run_training(verbose=False, **TRAJ)["losses"]
    for r in range(2):
        got = world2[r]["losses"]
        assert len(got) == len(want) == TRAJ["steps"]
        np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_TOL)
        assert got[-1] < got[0]
        assert world2[r]["found_inf"] == [False] * TRAJ["steps"]
    np.testing.assert_array_equal(world2[0]["fc"], world2[1]["fc"])
    # the global batch's losses: every rank reports the same numbers
    assert world2[0]["losses"] == world2[1]["losses"]


def test_cli_trains_in_the_world(world2):
    for r in range(2):
        losses = world2[r]["cli_losses"]
        assert world2[r]["world"] == 2 and len(losses) == 3
        assert all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_save_resume_matches_an_uninterrupted_run(tmp_path):
    kw = dict(arch="resnet10", opt_level="O0", batch_size=4, image_size=16,
              num_classes=5, lr=0.1, device="cpu", distributed=False,
              verbose=False)
    whole = im.run_training(steps=4, **kw)
    im.run_training(steps=2, save=str(tmp_path / "ck"), **kw)
    # the port's v1 checkpoint layer (the JAX driver writes orbax)
    steps = sorted(d.name for d in (tmp_path / "ck").iterdir())
    assert steps == ["step_0000000002"]
    assert (tmp_path / "ck" / steps[0] / "manifest.json").is_file()
    resumed = im.run_training(steps=4, resume=str(tmp_path / "ck"), **kw)
    assert resumed["losses"] == whole["losses"][2:]
    for (n, a), b in zip(whole["model"].state_dict().items(),
                         resumed["model"].state_dict().values()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the real-data path
# ---------------------------------------------------------------------------


def _make_fake_imagefolder(root, classes=3, per_class=6, size=40):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(classes):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            arr = rng.integers(0, 255, (size, size, 3), dtype="uint8")
            Image.fromarray(arr).save(d / f"img_{i}.jpg")


@pytest.mark.parametrize("train", [False, True])
def test_batches_equal_the_jax_modules(tmp_path, train):
    jd = _jax_data()
    _make_fake_imagefolder(tmp_path / "t", classes=2, per_class=4)
    got = list(tdata.batch_iterator(tdata.ImageFolder(str(tmp_path / "t")), 4,
                                    32, train=train, epochs=1, seed=3))
    want = list(jd.batch_iterator(jd.ImageFolder(str(tmp_path / "t")), 4, 32,
                                  train=train, epochs=1, seed=3))
    assert len(got) == len(want) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_prefetch_loader_propagates_decode_errors(tmp_path):
    _make_fake_imagefolder(tmp_path / "t", classes=2, per_class=3)
    (tmp_path / "t" / "class_0" / "img_0.jpg").write_bytes(b"not a jpeg")
    ds = tdata.ImageFolder(str(tmp_path / "t"))
    loader = tdata.PrefetchLoader(tdata.batch_iterator(ds, 6, 32, train=False,
                                                       epochs=1))
    with pytest.raises(Exception) as ei:
        for _ in range(10):
            next(loader)
    assert not isinstance(ei.value, StopIteration)


def test_batch_iterator_workers_matches_serial(tmp_path):
    _make_fake_imagefolder(tmp_path / "t", classes=2, per_class=4)
    ds = tdata.ImageFolder(str(tmp_path / "t"))
    serial = list(tdata.batch_iterator(ds, 4, 32, train=False, epochs=1))
    pooled = list(tdata.batch_iterator(ds, 4, 32, train=False, epochs=1,
                                       workers=4))
    assert len(serial) == len(pooled) == 2
    for (si, sl), (pi, pl) in zip(serial, pooled):
        np.testing.assert_array_equal(sl, pl)
        np.testing.assert_allclose(si, pi, rtol=1e-6)
    imgs, labels = next(tdata.batch_iterator(ds, 4, 32, train=True,
                                             workers=2))
    assert imgs.shape == (4, 32, 32, 3) and labels.shape == (4,)


def test_run_training_on_real_data(tmp_path, capsys):
    _make_fake_imagefolder(tmp_path / "train")
    out = im.run_training(arch="resnet10", image_size=32, batch_size=8,
                          steps=6, data_dir=str(tmp_path / "train"),
                          device="cpu", distributed=False)
    printed = capsys.readouterr().out
    assert "data: 18 images, 3 classes" in printed and "OK" in printed
    assert len(out["losses"]) == 6 and all(np.isfinite(out["losses"]))
