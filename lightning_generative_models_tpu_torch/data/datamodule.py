"""DataModule: host-side dataset staging and batch iteration.

Counterpart of ``lightning_generative_models_tpu/data/datamodule.py``, with the same
seeded train/val split, the same seeded per-epoch order and the same batches: uint8
numpy arrays, scaled and flipped on the device by ``ops/preprocess.py``. The one-time
crop and resize take the native C++ library (``data/native.py``) when a real resize is
needed, as the JAX package does, and the numpy path otherwise. ``PairedDataModule``
gives CycleGAN its two-domain batches.
"""

from __future__ import annotations

import logging
from pathlib import Path
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
    """One-time dataset staging: center-crop + resize, through the native library
    (``data/native.py``) when a real resize is needed, else the numpy path."""
    _, h, w, _ = images.shape
    if min(h, w) != size:
        from lightning_generative_models_tpu_torch.data import native  # noqa: PLC0415

        return native.center_crop_resize_batch(images, size)
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


class PairedDataModule(DataModule):
    """Two-domain batches for unpaired translation (CycleGAN), as the JAX package's
    ``PairedDataModule``: the ``<data_dir>/<name>/trainA`` and ``trainB`` image folders
    when both are there, otherwise two synthetic domains, the synthetic CIFAR-10's images
    of the lower and the upper half of its labels. Nothing is downloaded. Batches carry
    ``image_A`` and ``image_B``; the first ``train_val_split`` of the shorter domain's
    length trains, the rest validates, each domain in its own seeded order per epoch."""

    def sanity_check(self) -> None:  # any channel count is valid for a domain
        pass

    def setup(self) -> None:
        if self._is_setup:
            return
        root = Path(self.data_dir) / self.name
        size3 = (self.img_size, self.img_size, self.img_channels)
        domain_a = domain_b = None
        if root.exists():
            domain_a = ds._load_image_folder(root / "trainA", True, size3)
            domain_b = ds._load_image_folder(root / "trainB", True, size3)
        self.is_synthetic = domain_a is None or domain_b is None
        if self.is_synthetic:
            images, labels = ds.synthetic_dataset(
                "CIFAR10", True, num_samples=self.synthetic_size or 1024)
            half = max(labels.max() // 2, 1)
            domain_a = (images[labels < half], labels[labels < half])
            domain_b = (images[labels >= half], labels[labels >= half])
        self.images_a = _prep_images(domain_a[0], self.img_size)
        self.images_b = _prep_images(domain_b[0], self.img_size)
        n = min(len(self.images_a), len(self.images_b))
        self._n_train, self._n_total = int(n * self.train_val_split), n
        self._is_setup = True
        logger.info("PairedDataModule %s: A=%d B=%d train=%d val=%d img=%dx%dx%d "
                    "synthetic=%s", self.name, len(self.images_a), len(self.images_b),
                    self._n_train, n - self._n_train, self.img_size, self.img_size,
                    self.img_channels, self.is_synthetic)

    def steps_per_epoch(self, split: str = "train") -> int:
        self.setup()
        n = self._n_train if split == "train" else self._n_total - self._n_train
        return max(n // self.batch_size, 1)

    def _paired(self, lo: int, hi: int, shuffle: bool, epoch: int) -> Iterator[Batch]:
        n = hi - lo
        bs = min(self.batch_size, n)
        rs = np.random.RandomState(self.seed + 2000 + epoch)
        order_a = rs.permutation(n) + lo if shuffle else np.arange(lo, hi)
        order_b = rs.permutation(n) + lo if shuffle else np.arange(lo, hi)
        for start in range(0, n - bs + 1, bs):
            yield {"image_A": self.images_a[order_a[start:start + bs]],
                   "image_B": self.images_b[order_b[start:start + bs]]}

    def train_batches(self, epoch: int = 0) -> Iterator[Batch]:
        self.setup()
        return self._paired(0, self._n_train, True, epoch)

    def val_batches(self) -> Iterator[Batch]:
        self.setup()
        return self._paired(self._n_train, self._n_total, False, 0)

    def test_batches(self) -> Iterator[Batch]:
        return self.val_batches()
