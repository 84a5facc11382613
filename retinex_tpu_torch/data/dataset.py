"""Image listing and decode, and the training data pipeline.

Counterpart of ``retinex_tpu/data/dataset.py``: its two extension sets,
``list_image_files`` and ``decode_image``, which every route uses, and the
training half:

- ``LowLightDataset`` decodes (PIL) and letterboxes to the full square
  ``image_size`` canvas (``auto=False``, PARITY #14), as uint8 HWC;
  ``LowLightTestDataset`` keeps each image's own letterboxed shape;
- ``TrainLoader`` shuffles the indices each epoch with numpy's
  ``default_rng(seed)``, as the JAX package does, so the two give the same
  batch order; a fresh loader (a resume) restarts that generator, as there;
- ``_PrefetchIterator`` decodes and letterboxes each batch of a
  ``LowLightDataset`` through ``native_loader.decode_letterbox_batch`` (a
  pool of threads), as the JAX package's goes through its native loader,
  whose bytes it gives (``__getitem__`` is the PIL route, as there); it
  keeps ``prefetch`` batches in flight; a consumer that leaves an epoch
  early must ``close()`` it.

Augmentation runs on the device (``data/augment.py``).
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
from PIL import Image

from retinex_tpu_torch.data import native_loader
from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox

VALID_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp"}  # predict, evaluate, training
VALID_EXTENSIONS_ENHANCE = VALID_EXTENSIONS | {".tif", ".tiff"}


def list_image_files(image_dir: str, recursive: bool = True, extensions=VALID_EXTENSIONS) -> list[str]:
    """Sorted scan of `image_dir` (and its subdirectories with `recursive`)
    for files whose lower-cased extension is in `extensions`; the JAX
    package's signature and defaults."""
    if recursive:
        found = [os.path.join(root, n) for root, _dirs, names in os.walk(image_dir) for n in names]
    else:
        found = [os.path.join(image_dir, n) for n in os.listdir(image_dir)]
    return sorted(p for p in found if os.path.splitext(p)[1].lower() in extensions)


def decode_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 HWC via PIL."""
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


class LowLightDataset:
    """Training images, letterboxed to a square `image_size` canvas (uint8)."""

    def __init__(self, image_dir: str, image_size: int = 640):
        self.image_dir = image_dir
        self.image_size = image_size
        self.image_files = list_image_files(image_dir, recursive=True, extensions=VALID_EXTENSIONS)
        if not self.image_files:
            raise ValueError(f"No images found in {image_dir}")

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int) -> np.ndarray:
        img = decode_image(self.image_files[idx])
        plan = plan_letterbox(img.shape[0], img.shape[1], self.image_size, auto=False, scaleup=True)
        return letterbox_np(img, plan)


class LowLightTestDataset:
    """Test images at full resolution (or capped at `max_size`), each
    letterboxed to its own multiple of 32; yields (image, file name)."""

    def __init__(self, image_dir: str, max_size: int | None = None):
        self.image_dir = image_dir
        self.max_size = max_size
        self.image_files = list_image_files(image_dir, recursive=True, extensions=VALID_EXTENSIONS)
        if not self.image_files:
            raise ValueError(f"No images found in {image_dir}")

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int):
        img = decode_image(self.image_files[idx])
        h, w = img.shape[:2]
        target = self.max_size if self.max_size is not None else (h, w)
        plan = plan_letterbox(h, w, target, auto=True, scaleup=False)
        return letterbox_np(img, plan), os.path.basename(self.image_files[idx])


class _PrefetchIterator:
    """Threaded batch producer: the host path decodes and letterboxes each
    batch of a LowLightDataset on `num_workers` threads; `prefetch` batches
    stay in flight."""

    def __init__(self, dataset: LowLightDataset, order, batch_size, drop_last, num_workers, prefetch=2, rows=(0, 1)):
        self.dataset = dataset
        self.order = order
        self.batch_size = batch_size
        self.rows = rows
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._produce, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """A bounded put that gives up once the consumer has closed the
        iterator (a plain put would block forever after an early break)."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        for start in range(0, len(self.order), self.batch_size):
            if self._stop.is_set():
                break
            idxs = self.order[start : start + self.batch_size]
            if len(idxs) < self.batch_size and self.drop_last:
                break
            index, count = self.rows
            if count > 1:  # this rank's rows of the batch padded to a multiple of `count`
                idxs = idxs + idxs[-1:] * (-len(idxs) % count)
                per = len(idxs) // count
                idxs = idxs[index * per : (index + 1) * per]
            paths = [self.dataset.image_files[i] for i in idxs]
            batch = native_loader.decode_letterbox_batch(
                paths, self.dataset.image_size, auto_pad=False, scaleup=True, num_threads=self.num_workers
            )
            if not self._put(batch):
                break
        self._put(None)

    def close(self):
        """Stop the producer and drain the queue; safe after exhaustion."""
        self._stop.set()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.q.get()
        if batch is None:
            raise StopIteration
        return batch


class TrainLoader:
    """Epoch-shuffled batch loader yielding uint8 NHWC numpy batches.

    `shard` = (process index, process count) is the JAX package's
    multi-host rule: every process shuffles with the same seed, takes its
    disjoint stride of the order and truncates it to a common length, so
    every process runs the same number of steps. `rows` = (local rank,
    local ranks) then yields only that rank's rows of each of the process's
    batches, padded to a multiple of the local ranks by repeating the last
    image (the JAX trainer's ``pad_to_multiple`` to its local devices); only
    those rows are decoded."""

    def __init__(
        self,
        dataset: LowLightDataset,
        batch_size: int = 8,
        shuffle: bool = True,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
        rows: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.shard = shard
        self.rows = rows
        self.rng = np.random.default_rng(seed)  # the shuffle; a checkpoint keeps its state

    def _shard_len(self) -> int:
        _, count = self.shard
        return len(self.dataset) // count if count > 1 else len(self.dataset)

    def __len__(self) -> int:
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch_order(self) -> list[int]:
        """This process's image indices for the next epoch (one shuffle from
        the generator, as each epoch's iterator takes)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        index, count = self.shard
        if count > 1:
            order = order[index::count][: self._shard_len()]
        return [int(i) for i in order]

    def __iter__(self) -> _PrefetchIterator:
        return _PrefetchIterator(
            self.dataset, self.epoch_order(), self.batch_size, self.drop_last, self.num_workers, rows=self.rows
        )


class TestLoader:
    """Sequential (image [1,H,W,3], name) iterator over a test directory."""

    def __init__(self, dataset: LowLightTestDataset, num_workers: int = 2):
        self.dataset = dataset
        self.num_workers = num_workers

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            img, name = self.dataset[i]
            yield img[None], name


def get_test_loader(image_dir: str, max_size: int | None = None, num_workers: int = 2) -> TestLoader:
    return TestLoader(LowLightTestDataset(image_dir, max_size), num_workers)


def get_train_loader(
    image_dir: str,
    batch_size: int = 8,
    image_size: int = 640,
    num_workers: int = 4,
    shuffle: bool = True,
    drop_last: bool = False,
    seed: int = 0,
    shard: tuple[int, int] = (0, 1),
    rows: tuple[int, int] = (0, 1),
) -> TrainLoader:
    return TrainLoader(
        LowLightDataset(image_dir, image_size),
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=num_workers,
        seed=seed,
        shard=shard,
        rows=rows,
    )
