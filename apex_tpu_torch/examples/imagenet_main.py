"""ImageNet ResNet training: the counterpart of ``examples/imagenet/main.py``
(apex's ``examples/imagenet/main_amp.py``).

    python -m apex_tpu_torch.examples.imagenet_main --arch resnet50 --steps 20
    python -m apex_tpu_torch.examples.imagenet_main --device cpu \\
        --arch resnet10 --image-size 32 --batch-size 8 --steps 6
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.imagenet_main \\
        --device cpu --arch resnet10 --image-size 32 --batch-size 8

ResNet v1.5 (the torchvision ResNet-50 the apex example trains) with

- :class:`~apex_tpu_torch.parallel.SyncBatchNorm` (statistics over the
  data-parallel group) and
  :class:`~apex_tpu_torch.parallel.DistributedDataParallel` (the
  gradients averaged over the group after each backward), at any world
  size, 1 included;
- the precision of :func:`apex_tpu_torch.amp.get_policy` (O0-O3; O2
  by default: half convolutions, fp32 batch norms kept by their names,
  fp32 masters in the optimizer; O1 the JAX model's: fp32 parameters, the
  images cast to half and each convolution promoting the mixed pair to
  fp32, as flax's layers do) and the policy's loss scaler (dynamic for
  fp16);
- :class:`~apex_tpu_torch.optimizers.FusedSGD` (momentum 0.9, weight
  decay 1e-4).

The model computes what the JAX model computes: flax's ``padding="SAME"``
convolutions and max pool are padded explicitly (``(2, 3)`` for the 7x7/2
stem on 224, ``(0, 1)`` for a 3x3/2 on an even size, where PyTorch's
symmetric padding would shift the windows), the head is an fp32 product
and the loss an fp32 log-softmax.  Its tensors are NCHW, the images (and
so the activations) in NHWC memory, the JAX model's layout and cuDNN's
fast one; the weights stay contiguous, as the multi-tensor kernels take
their gradients.  The
synthetic batch is the JAX driver's: one fixed global batch of
``np.random.default_rng(seed)`` draws, NHWC, each rank taking its rows;
``--data-dir`` reads an ImageFolder tree
(:mod:`~apex_tpu_torch.examples.imagenet_data`).  ``--save`` /
``--resume`` use the port's checkpoint layer
(:mod:`apex_tpu_torch.resilience.checkpoint`), where the JAX driver uses
orbax.

Without a loss scale (bf16, O0) a step checks no gradient for overflow;
with one (fp16 O1 or O2) one ``mt_scale`` check over every gradient decides
whether the step is applied.  The CLI takes the caller's process group,
else starts one from ``torchrun``'s environment, else a world of one
process (NCCL on ``cuda``, gloo on ``cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import functools
import math
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.optimizers._common import master_copy
from apex_tpu_torch.parallel import DistributedDataParallel, SyncBatchNorm
from apex_tpu_torch.resilience import checkpoint as ckpt
from apex_tpu_torch.utils.conv import conv2d_same
from apex_tpu_torch.utils.conv import same_pads as _same_pads

__all__ = ["SameConv2d", "BottleneckBlock", "ResNet", "resnet50",
           "resnet18_ish", "resnet10_ish", "cross_entropy", "conv_flops",
           "forward_backward", "apply_update", "train_step",
           "synthetic_batch", "run_training", "main"]


class SameConv2d(nn.Conv2d):
    """A bias-free ``nn.Conv2d`` with flax ``nn.Conv``'s ``SAME`` padding,
    computed from each input's size: symmetric pads go to the convolution,
    asymmetric ones (``(0, 1)``, ``(2, 3)``) to an ``F.pad`` first."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 device=None):
        super().__init__(cin, cout, kernel, stride, padding=0, bias=False,
                         device=device)

    def forward(self, x):
        # flax's promote_dtype: a half input against fp32 weights (O1)
        # runs in fp32, where conv2d would raise on the mixed pair
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        return conv2d_same(x, self.weight, self.stride[0])


def _max_pool_same(x):
    """flax's ``max_pool(x, (3, 3), (2, 2), padding="SAME")``: the pads
    filled with -inf."""
    (t, b), (l, r) = _same_pads(x.shape[2], 3, 2), _same_pads(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), 3, 2)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided, v1.5) -> 1x1 x4, each followed by batch norm
    (ReLU fused into the first two), and a 1x1 projection of the input
    where its shape differs from the output's."""

    def __init__(self, cin: int, features: int, strides: int = 1, *,
                 group=None, use_fast_variance: bool = True, device=None):
        super().__init__()
        bn = functools.partial(SyncBatchNorm, process_group=group,
                               use_fast_variance=use_fast_variance,
                               device=device)
        self.conv1 = SameConv2d(cin, features, 1, device=device)
        self.bn1 = bn(features, fuse_relu=True)
        self.conv2 = SameConv2d(features, features, 3, strides, device=device)
        self.bn2 = bn(features, fuse_relu=True)
        self.conv3 = SameConv2d(features, features * 4, 1, device=device)
        self.bn3 = bn(features * 4)
        self.downsample_conv = self.downsample_bn = None
        if cin != features * 4 or strides != 1:
            self.downsample_conv = SameConv2d(cin, features * 4, 1, strides,
                                              device=device)
            self.downsample_bn = bn(features * 4)

    def forward(self, x):
        y = self.bn1(self.conv1(x))
        y = self.bn2(self.conv2(y))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1.5 on NCHW images: the 7x7/2 stem, batch norm with ReLU,
    the 3x3/2 max pool, the bottleneck stages, the spatial mean and an
    fp32 linear head (the logits are fp32).  Batch norms are named ``bn*``
    so that O2 keeps them fp32."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes: int = 1000, *,
                 group=None, use_fast_variance: bool = True, device=None):
        super().__init__()
        self.conv1 = SameConv2d(3, 64, 7, 2, device=device)
        self.bn1 = SyncBatchNorm(64, process_group=group, fuse_relu=True,
                                 use_fast_variance=use_fast_variance,
                                 device=device)
        blocks, cin = [], 64
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                blocks.append(BottleneckBlock(
                    cin, 64 * 2 ** i, 2 if i > 0 and j == 0 else 1,
                    group=group, use_fast_variance=use_fast_variance,
                    device=device))
                cin = 64 * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, num_classes, device=device)

    def forward(self, x):
        x = _max_pool_same(self.bn1(self.conv1(x)))
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight.float(),
                        self.fc.bias.float())


@torch.no_grad()
def _init(model: ResNet, seed: int) -> ResNet:
    """flax's default initializers from a seeded generator on the model's
    device: every convolution and the head's weight truncated normal
    (within 2 std) of variance 1 / fan_in (``lecun_normal``), the head's
    bias 0, batch norm scales 1 and biases 0."""
    device = model.fc.weight.device
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            if m.bias is not None:
                m.bias.zero_()
    return model


def _build(stage_sizes, num_classes, *, group=None, use_fast_variance=True,
           device="cuda", seed=0) -> ResNet:
    return _init(ResNet(stage_sizes, num_classes, group=group,
                        use_fast_variance=use_fast_variance,
                        device=resolve_device(device)), seed)


def resnet50(num_classes=1000, **kw) -> ResNet:
    return _build((3, 4, 6, 3), num_classes, **kw)


def resnet18_ish(num_classes=1000, **kw) -> ResNet:
    return _build((1, 1, 1, 1), num_classes, **kw)


def resnet10_ish(num_classes=1000, **kw) -> ResNet:
    """Two stages: the same block, batch norm and policy code at a small
    fraction of the cost (the CPU tests' model)."""
    return _build((1, 1), num_classes, **kw)


ARCHS = {"resnet50": resnet50, "resnet18": resnet18_ish,
         "resnet10": resnet10_ish}


def cross_entropy(logits, labels):
    """The mean negative log-likelihood of an fp32 log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


def conv_flops(model: ResNet, image_size: int, batch: int) -> float:
    """The multiply-adds of the convolutions and the head for ``batch``
    images, times 2 (FLOPs a forward) and times 3 (forward and backward):
    a training step's model FLOPs, from each layer's output size under
    ``SAME`` padding."""
    def conv(m: nn.Conv2d, s: int):
        """(multiply-adds, output size) of ``m`` on an ``s x s`` input."""
        out = -(-s // m.stride[0])
        return m.weight.numel() * out * out, out

    macs, size = conv(model.conv1, image_size)
    size = -(-size // 2)                                   # the max pool
    for block in model.blocks:
        m1, s1 = conv(block.conv1, size)
        m2, s2 = conv(block.conv2, s1)
        m3, _ = conv(block.conv3, s2)
        macs += m1 + m2 + m3
        if block.downsample_conv is not None:
            macs += conv(block.downsample_conv, size)[0]
        size = s2
    macs += model.fc.weight.numel()
    return 2.0 * macs * batch * 3


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def forward_backward(net, images, labels, policy, scaler, state):
    """The loss of ``net`` on the batch (images cast to the policy's
    compute dtype) and its backward, scaled by ``state`` where the policy
    has a loss scale; returns the loss, detached.  Under
    :class:`DistributedDataParallel` the gradients are averaged over the
    group when the backward ends."""
    loss = cross_entropy(net(policy.cast_inputs(images)), labels)
    (loss if policy.loss_scale is None
     else scaler.scale_loss(loss, state)).backward()
    return loss.detach()


def apply_update(opt, policy, scaler, state):
    """The optimizer's update; with a loss scale, after one overflow check
    of every gradient (``found_inf``, on the device), unscaling them in
    the update and skipping it where ``found_inf``, then the scaler's
    update.  Returns ``(found_inf or None, state)``."""
    if policy.loss_scale is None:
        opt.step()
        return None, state
    grads = [p.grad for g in opt.param_groups for p in g["params"]
             if p.grad is not None]
    found_inf = scaler.has_overflow(grads)
    opt.step(grad_scale=state.scale, found_inf=found_inf)
    return found_inf, scaler.update(state, found_inf)


def train_step(net, opt, images, labels, policy, scaler, state):
    """One step: ``(loss, found_inf or None, state)``, device tensors."""
    opt.zero_grad(set_to_none=True)
    loss = forward_backward(net, images, labels, policy, scaler, state)
    found_inf, state = apply_update(opt, policy, scaler, state)
    return loss, found_inf, state


def synthetic_batch(batch_size: int, image_size: int, num_classes: int,
                    seed: int):
    """The JAX driver's fixed batch: ``default_rng(seed)``'s standard
    normal NHWC images, then its integer labels; numpy."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch_size, image_size, image_size, 3)
                                 ).astype(np.float32)
    labels = rng.integers(0, num_classes, batch_size).astype(np.int64)
    return images, labels


def _to_device(images: np.ndarray, labels: np.ndarray, device):
    """NHWC numpy images as an NCHW tensor in NHWC memory on ``device``,
    and the labels as int64."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return x, torch.from_numpy(np.asarray(labels, np.int64)).to(device)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _opt_state(opt: FusedSGD) -> dict:
    """FusedSGD's state as a tree, made (zeros, masters from the
    parameters) where no step has run yet."""
    params = [p for g in opt.param_groups for p in g["params"]]
    step = None
    for p in params:
        st = opt.state[p]
        if "momentum_buffer" not in st:
            st["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
        if opt.master_weights and "master_param" not in st:
            st["master_param"] = master_copy(p)
        if "step" in st:
            step = st["step"]
    if step is None:
        step = torch.zeros((), dtype=torch.int32, device=params[0].device)
    for p in params:
        opt.state[p]["step"] = step
    tree = {"step": step,
            "momentum": [opt.state[p]["momentum_buffer"] for p in params]}
    if opt.master_weights:
        tree["master"] = [opt.state[p]["master_param"] for p in params]
    return tree


def save_checkpoint(path, step, model, opt, scaler, state) -> str:
    """Every piece of training state under ``path`` as step ``step``'s
    checkpoint: the model's ``state_dict`` (running statistics included),
    the optimizer's step, momentum and masters, and the scaler's state."""
    return ckpt.save_checkpoint(path, step, {
        "step": np.asarray(step, np.int64), "model": model.state_dict(),
        "opt": _opt_state(opt), "scaler": scaler.state_dict(state)})


@torch.no_grad()
def load_checkpoint(path, model, opt, scaler, state):
    """The newest valid checkpoint under ``path`` into the live model and
    optimizer, in place; returns ``(step, scaler state)``."""
    live = {"step": np.asarray(0, np.int64), "model": model.state_dict(),
            "opt": _opt_state(opt), "scaler": scaler.state_dict(state)}
    tree, _ = ckpt.restore_checkpoint(path, live)
    pairs = [(t, tree["model"][name]) for name, t in live["model"].items()]
    pairs.append((live["opt"]["step"], tree["opt"]["step"]))
    for key in ("momentum", "master"):
        pairs += zip(live["opt"].get(key, []), tree["opt"].get(key, []))
    for t, new in pairs:
        t.copy_(new.reshape(t.shape))
    device = state.scale.device
    return int(tree["step"]), scaler.load_state_dict(tree["scaler"], device)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def run_training(arch="resnet18", opt_level="O2", half="bf16", batch_size=64,
                 image_size=224, num_classes=1000, steps=20, lr=0.1,
                 loss_scale=None, save=None, save_interval=None, resume=None,
                 prof=None, seed=0, verbose=True, data_dir=None, workers=0, *,
                 device="cuda", distributed=True, group=None,
                 init_state=None, use_fast_variance=True):
    """Train ``steps`` steps of the global batch ``batch_size`` and return
    ``{"losses", "imgs_per_sec", "final_scale", "step_ms", "found_inf",
    "model", "net", "optimizer", "scaler_state"}`` (``net`` the model as
    trained: behind its DDP wrapper when ``distributed``).

    ``distributed`` (the default) wraps the model in
    :class:`DistributedDataParallel` over ``group`` (the default group
    when None; ``torch.distributed`` must be initialized) with its batch
    norms synchronized over it, each rank taking its rows of the batch;
    ``distributed=False`` trains one process with local batch norms.
    ``init_state`` is a ``state_dict`` to start from (e.g. a JAX init
    through :func:`~apex_tpu_torch.models.convert.resnet_params_from_jax`)
    in place of the seeded init.  The losses are the global batch's, one
    a step; ``step_ms`` times each step after the first (the warm-up) to its
    end on the device, and ``imgs_per_sec`` is the global batch over
    their mean.  ``prof`` is a file for a ``torch.profiler`` trace of
    steps 5-10 (the JAX driver's ``--prof`` window)."""
    device = resolve_device(device)
    world, rank = 1, 0
    if distributed:
        if not dist.is_initialized():
            raise RuntimeError(
                "run_training(distributed=True) trains over a "
                "torch.distributed group: initialize one first (the CLI "
                "starts a world of one), or pass distributed=False")
        group = dist.group.WORLD if group is None else group
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    if batch_size % world:
        raise ValueError(f"batch {batch_size} does not split over {world} "
                         f"ranks")

    loader = None
    if data_dir is not None:
        from apex_tpu_torch.examples import imagenet_data as data

        dataset = data.ImageFolder(data_dir)
        num_classes = len(dataset.classes)
        loader = data.PrefetchLoader(data.batch_iterator(
            dataset, batch_size, image_size, train=True, seed=seed,
            workers=workers))
        if verbose:
            print(f"data: {len(dataset)} images, {num_classes} classes "
                  f"from {data_dir}")

    half_dtype = torch.bfloat16 if half == "bf16" else torch.float16
    overrides = {} if loss_scale is None else {"loss_scale": loss_scale}
    policy = get_policy(opt_level, half_dtype=half_dtype, **overrides)
    model = ARCHS[arch](num_classes, group=group if distributed else None,
                        use_fast_variance=use_fast_variance, device=device,
                        seed=seed)
    if init_state is not None:
        model.load_state_dict(init_state)
    policy.cast_params(model)
    net = DistributedDataParallel(model, group) if distributed else model
    opt = FusedSGD(model.parameters(), lr=lr, momentum=0.9, weight_decay=1e-4,
                   master_weights=policy.master_weights)
    scaler = policy.make_scaler()
    state = scaler.init(device)
    start_step = 0
    if resume is not None:
        start_step, state = load_checkpoint(resume, model, opt, scaler, state)
        if verbose:
            print(f"=> resumed from {resume} at step {start_step}")

    rows = slice(rank * (batch_size // world), (rank + 1) * (batch_size // world))
    if loader is None:
        images_np, labels_np = synthetic_batch(batch_size, image_size,
                                               num_classes, seed)
        images, labels = _to_device(images_np[rows], labels_np[rows], device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, found, step_ms = [], [], []
    profiler = None
    with contextlib.ExitStack() as stack:
        if loader is not None:
            stack.callback(loader.close)
        for step in range(start_step, steps):
            if prof and step == 5:
                profiler = torch.profiler.profile()
                profiler.__enter__()
            if loader is not None:
                imgs_np, lbl_np = next(loader)
                images, labels = _to_device(imgs_np[rows], lbl_np[rows],
                                            device)
            sync()
            t0 = time.perf_counter()
            loss, found_inf, state = train_step(net, opt, images, labels,
                                                policy, scaler, state)
            sync()
            if step > start_step:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            found.append(found_inf)
            if profiler is not None and step == 10:
                profiler.__exit__(None, None, None)
                profiler.export_chrome_trace(prof)
                profiler = None
            if save is not None and save_interval and (step + 1) % save_interval == 0:
                if rank == 0:
                    save_checkpoint(save, step + 1, model, opt, scaler, state)
        if profiler is not None:
            profiler.__exit__(None, None, None)
            profiler.export_chrome_trace(prof)
    if save is not None and rank == 0:
        save_checkpoint(save, steps, model, opt, scaler, state)
    losses = torch.stack(losses) if losses else torch.zeros(0, device=device)
    if distributed and world > 1:
        dist.all_reduce(losses, group=group)
        losses = losses / world
    imgs_per_sec = (batch_size / (sum(step_ms) / len(step_ms) / 1e3)
                    if step_ms else float("nan"))
    overflow = [bool(f) if f is not None else False for f in found]
    out = {"losses": [float(x) for x in losses.cpu()],
           "imgs_per_sec": imgs_per_sec, "final_scale": float(state.scale),
           "step_ms": step_ms, "found_inf": overflow, "model": model,
           "net": net, "optimizer": opt, "scaler_state": state}
    if verbose:
        print(f"throughput: {imgs_per_sec:.1f} imgs/sec over {world} "
              f"rank(s), overflow={any(overflow)}")
        print("OK")
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="resnet50", choices=sorted(ARCHS))
    ap.add_argument("--opt-level", default="O2",
                    choices=["O0", "O1", "O2", "O3"])
    ap.add_argument("--half", default="bf16", choices=["bf16", "fp16"])
    ap.add_argument("--batch-size", type=int, default=64, help="global batch")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--loss-scale", default=None,
                    help='None | float | "dynamic" (main_amp.py --loss-scale)')
    ap.add_argument("--save", default=None, help="checkpoint directory")
    ap.add_argument("--save-interval", type=int, default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint directory to resume from")
    ap.add_argument("--data-dir", default=None,
                    help="ImageFolder tree (class_x/img.jpeg) of real "
                         "images; default: synthetic")
    ap.add_argument("--workers", type=int, default=0,
                    help="decode threads for --data-dir")
    ap.add_argument("--prof", default=None,
                    help="write a torch.profiler trace of steps 5-10 here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


@contextlib.contextmanager
def _process_group(device: torch.device):
    """The caller's process group; else one from torchrun's environment;
    else a world of this one process over a ``file://`` rendezvous in a
    temporary directory.  A group started here is destroyed after."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    env = os.environ
    tmp = None
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                              "MASTER_PORT")):
        if device.type == "cuda":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        tmp = tempfile.mkdtemp(prefix="imagenet_rdv_")
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    loss_scale = args.loss_scale
    if loss_scale is not None and loss_scale != "dynamic":
        loss_scale = float(loss_scale)
    device = resolve_device(args.device)
    with _process_group(device):
        out = run_training(
            arch=args.arch, opt_level=args.opt_level, half=args.half,
            batch_size=args.batch_size, image_size=args.image_size,
            num_classes=args.num_classes, steps=args.steps, lr=args.lr,
            loss_scale=loss_scale, save=args.save,
            save_interval=args.save_interval, resume=args.resume,
            prof=args.prof, data_dir=args.data_dir,
            workers=args.workers, device=device,
            verbose=dist.get_rank() == 0)
    return out


if __name__ == "__main__":
    main()
