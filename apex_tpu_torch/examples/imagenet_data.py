"""The real-data input path of the ImageNet example: the counterpart of
``examples/imagenet/data.py`` (apex's ``main_amp.py`` loader stack:
ImageFolder, RandomResizedCrop and flip, DataLoader workers, prefetched
normalization).

- :class:`ImageFolder`: the ``root/class_x/img.jpeg`` tree, classes the
  sorted subdirectory names, PIL decode (PIL is imported when an image is
  read, not with this module);
- the training transform (random-resized crop and horizontal flip) and
  the evaluation one (resize to 1.14x, centre crop);
- normalization on the host in fp32 by the ImageNet mean and std;
- :func:`batch_iterator`: NHWC fp32 batches and int32 labels, reshuffled
  each epoch, with ``workers`` decode threads;
- :class:`PrefetchLoader`: a background thread and a bounded queue, so the
  host decodes the next batches while the device runs the step; a decode
  error reaches the training loop as itself.

Host numpy only, as in the JAX package: the trainer
(:mod:`~apex_tpu_torch.examples.imagenet_main`) moves each batch to the
device in NCHW.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """``root/class_name/image.ext`` tree -> (path, label) samples.

    Classes are the sorted subdirectory names (torchvision's
    ``ImageFolder`` contract, so label ids line up with a reference run).
    """

    def __init__(self, root: str):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.samples: list[tuple[str, int]] = []
        for label, cls in enumerate(self.classes):
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_EXTS):
                    self.samples.append((os.path.join(cdir, fname), label))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.samples)


def _load_train(path: str, size: int, rng: np.random.Generator) -> np.ndarray:
    """RandomResizedCrop(size) + random horizontal flip (PIL)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        area = w * h
        for _ in range(10):
            target = area * rng.uniform(0.08, 1.0)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = rng.integers(0, w - cw + 1)
                y0 = rng.integers(0, h - ch + 1)
                im = im.resize((size, size), Image.BILINEAR,
                               box=(x0, y0, x0 + cw, y0 + ch))
                break
        else:  # fallback: center crop of the short side
            s = min(w, h)
            x0, y0 = (w - s) // 2, (h - s) // 2
            im = im.resize((size, size), Image.BILINEAR,
                           box=(x0, y0, x0 + s, y0 + s))
        if rng.random() < 0.5:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(im, np.float32)


def _load_eval(path: str, size: int) -> np.ndarray:
    """Resize short side to size*1.14 then center-crop (the reference's
    Resize(256)/CenterCrop(224) ratio)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        short = int(round(size * 1.14))
        if w < h:
            nw, nh = short, int(round(h * short / w))
        else:
            nw, nh = int(round(w * short / h)), short
        im = im.resize((nw, nh), Image.BILINEAR)
        x0, y0 = (nw - size) // 2, (nh - size) // 2
        im = im.crop((x0, y0, x0 + size, y0 + size))
        return np.asarray(im, np.float32)


def _normalize(batch: np.ndarray) -> np.ndarray:
    return (batch / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def batch_iterator(dataset: ImageFolder, batch_size: int, image_size: int,
                   *, train: bool = True, seed: int = 0,
                   epochs: int | None = None, workers: int = 0):
    """Yield (images [b,s,s,3] fp32 normalized, labels [b] int32) forever
    (or for ``epochs`` passes), reshuffling each epoch when training.

    ``workers > 0`` fans per-image decode across a thread pool (PIL
    releases the GIL inside the JPEG codec) — the reference's DataLoader
    ``workers`` knob.  A trainer needs as many decode threads as its
    step rate divided by one core's decode rate.
    """
    if len(dataset) < batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} images < batch_size {batch_size}: "
            "no full batch can be formed (drop_last semantics)")
    rng = np.random.default_rng(seed)
    pool = None
    if workers > 0:
        import concurrent.futures
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)

    def load_one(k, child_seed):
        path, label = dataset.samples[k]
        img = (_load_train(path, image_size,
                           np.random.default_rng(child_seed)) if train
               else _load_eval(path, image_size))
        return img, label

    epoch = 0
    try:
        while epochs is None or epoch < epochs:
            order = (rng.permutation(len(dataset)) if train
                     else np.arange(len(dataset)))
            for i in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                imgs = np.empty((batch_size, image_size, image_size, 3),
                                np.float32)
                labels = np.empty((batch_size,), np.int32)
                if pool is not None:
                    # seeds drawn only in train mode (eval decode is
                    # deterministic); results stream straight into the
                    # preallocated batch — no intermediate list
                    seeds = (rng.integers(0, 2 ** 31, batch_size) if train
                             else np.zeros(batch_size, np.int64))
                    for j, (img, label) in enumerate(
                            pool.map(load_one, idx, seeds)):
                        imgs[j], labels[j] = img, label
                else:
                    for j, k in enumerate(idx):
                        path, label = dataset.samples[k]
                        imgs[j] = (_load_train(path, image_size, rng) if train
                                   else _load_eval(path, image_size))
                        labels[j] = label
                yield _normalize(imgs), labels
            epoch += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


class PrefetchLoader:
    """Bounded-queue background prefetch: host decode of batch N+1/N+2
    overlaps the device's asynchronously-dispatched step N."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._error: BaseException | None = None

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in __next__
                # a decode error (corrupt JPEG, bad path) must surface in
                # the training loop as ITSELF, not as a bare StopIteration
                # indistinguishable from clean end-of-data
                self._error = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # unblock a full queue so the worker can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
