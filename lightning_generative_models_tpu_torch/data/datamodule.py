"""DataModule: host-side dataset staging and batch iteration.

Counterpart of ``lightning_generative_models_tpu/data/datamodule.py``, with the same
seeded train/val split, the same seeded per-epoch order and the same batches: uint8
numpy arrays, scaled and flipped on the device by ``ops/preprocess.py``. The one-time
crop and resize take the numpy path only (the JAX package's native C++ loader comes
with the preprocess kernel's slice), and the paired two-domain module waits for
CycleGAN.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, Optional

import numpy as np

from lightning_generative_models_tpu_torch.data import datasets as ds
from lightning_generative_models_tpu_torch.utils.path import DATASET_PATH

logger = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]


def _resize_batch(images: np.ndarray, size: int) -> np.ndarray:
    """One-time uint8 resize (area-style) of an [N, H, W, C] stack."""
    n, h, w, c = images.shape
    if h == size and w == size:
        return images
    if h % size == 0 and w % size == 0:
        # Integer-factor box downsample: exact and fast in numpy.
        fh, fw = h // size, w // size
        x = images.reshape(n, size, fh, size, fw, c).astype(np.float32)
        return x.mean(axis=(2, 4)).round().astype(np.uint8)
    from PIL import Image  # noqa: PLC0415 - only image folders need it

    out = np.empty((n, size, size, c), dtype=np.uint8)
    for i in range(n):
        img = images[i, ..., 0] if c == 1 else images[i]
        resized = Image.fromarray(img).resize((size, size), Image.BILINEAR)
        arr = np.asarray(resized, dtype=np.uint8)
        out[i] = arr[..., None] if c == 1 else arr
    return out


def _center_crop_square(images: np.ndarray) -> np.ndarray:
    """Square center-crop to min(H, W)."""
    _, h, w, _ = images.shape
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    return images[:, top : top + side, left : left + side, :]


def _prep_images(images: np.ndarray, size: int) -> np.ndarray:
    """One-time dataset staging: center-crop + resize."""
    return _resize_batch(_center_crop_square(images), size)


class DataModule:
    """Loads, splits and batches a dataset; accepts the JAX DataModule's kwargs.

    ``num_workers`` / ``pin_memory`` / ``persistent_workers`` / ``download`` are
    accepted for config compatibility and do nothing: the whole (small-image) dataset
    is staged once in host memory as uint8, and batches go to the device through the
    prefetcher (``data/pipeline.py``).
    """

    def __init__(
        self,
        name: str,
        img_size: int,
        img_channels: int,
        batch_size: int = 32,
        data_dir: Optional[str] = None,
        train_val_split: float = 0.8,
        download: bool = False,
        num_workers: int = 0,
        pin_memory: bool = False,
        persistent_workers: bool = False,
        hflip: bool = True,
        seed: int = 10,
        synthetic_size: Optional[int] = None,
    ):
        self.name = name
        self.img_size = img_size
        self.img_channels = img_channels
        self.batch_size = batch_size
        self.data_dir = data_dir if data_dir is not None else str(DATASET_PATH)
        self.train_val_split = train_val_split
        self.hflip = hflip
        self.seed = seed
        self.synthetic_size = synthetic_size
        self._is_setup = False
        self.sanity_check()

    def sanity_check(self) -> None:
        expected = 1 if self.name.lower() in ("mnist", "fashionmnist") else 3
        if self.img_channels != expected:
            raise ValueError(
                f"{self.name} expects img_channels={expected}, got {self.img_channels}"
            )

    def setup(self) -> None:
        if self._is_setup:
            return
        train_pool, train_labels, self.is_synthetic = ds.load_dataset(
            self.name, self.data_dir, train=True, synthetic_size=self.synthetic_size
        )
        test_images, test_labels, _ = ds.load_dataset(
            self.name,
            self.data_dir,
            train=False,
            synthetic_size=(self.synthetic_size // 4 if self.synthetic_size else None),
        )
        train_pool = _prep_images(train_pool, self.img_size)
        test_images = _prep_images(test_images, self.img_size)

        # Seeded split, independent of any global seed.
        n = len(train_pool)
        perm = np.random.RandomState(self.seed).permutation(n)
        n_train = int(n * self.train_val_split)
        train_idx, val_idx = perm[:n_train], perm[n_train:]

        self.train_images = train_pool[train_idx]
        self.train_labels = train_labels[train_idx]
        self.val_images = train_pool[val_idx]
        self.val_labels = train_labels[val_idx]
        self.test_images = test_images
        self.test_labels = test_labels
        self._is_setup = True
        logger.info(
            "DataModule %s: train=%d val=%d test=%d img=%dx%dx%d synthetic=%s",
            self.name, len(self.train_images), len(self.val_images),
            len(self.test_images), self.img_size, self.img_size, self.img_channels,
            self.is_synthetic,
        )

    # -- iteration -------------------------------------------------------
    def steps_per_epoch(self, split: str = "train") -> int:
        self.setup()
        n = len(getattr(self, f"{split}_images"))
        return max(n // self.batch_size, 1)

    def _batches(
        self, images: np.ndarray, labels: np.ndarray, shuffle: bool, epoch: int
    ) -> Iterator[Batch]:
        n = len(images)
        bs = min(self.batch_size, n)
        if shuffle:
            order = np.random.RandomState(self.seed + 1000 + epoch).permutation(n)
        else:
            order = np.arange(n)
        for start in range(0, n - bs + 1, bs):
            idx = order[start : start + bs]
            yield {"image": images[idx], "label": labels[idx]}

    def train_batches(self, epoch: int = 0) -> Iterator[Batch]:
        self.setup()
        return self._batches(self.train_images, self.train_labels, True, epoch)

    def val_batches(self) -> Iterator[Batch]:
        self.setup()
        return self._batches(self.val_images, self.val_labels, False, 0)

    def test_batches(self) -> Iterator[Batch]:
        self.setup()
        return self._batches(self.test_images, self.test_labels, False, 0)
