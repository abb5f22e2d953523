"""Dataset sources: on-disk parsing with a deterministic synthetic fallback.

The port's own copy of ``lightning_generative_models_tpu/data/datasets.py`` (numpy
only; PIL and scipy are imported inside the functions that decode image folders, so
a machine without them imports this module). Each dataset:

1. parses the standard on-disk format if files are present under
   ``<data_dir>/<name>`` (MNIST idx files, CIFAR-10 python pickle batches,
   image folders for CelebA/Flowers102/LSUN), and otherwise
2. falls back to a *deterministic, seeded synthetic* dataset with the correct
   shapes and label structure, bit for bit the JAX package's: enough for tests,
   overfit runs and throughput measurements (content does not change step time).

All sources return ``(images uint8 [N, H, W, C], labels int32 [N])`` with
images at their native resolution; resize/crop happens in the DataModule.
"""

from __future__ import annotations

import gzip
import logging
import pickle
import struct as pystruct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

NATIVE_SHAPES = {
    "MNIST": (28, 28, 1),
    "FashionMNIST": (28, 28, 1),
    "CIFAR10": (32, 32, 3),
    "CelebA": (178, 178, 3),  # after square center-crop of 178x218
    "Flowers102": (256, 256, 3),
    "LSUN": (256, 256, 3),
}

NUM_CLASSES = {
    "MNIST": 10,
    "FashionMNIST": 10,
    "CIFAR10": 10,
    "CelebA": 2,
    "Flowers102": 102,
    "LSUN": 1,
}


def _read_idx(path: Path) -> np.ndarray:
    """Parse an IDX file (optionally gzipped) — the MNIST container format."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = pystruct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = pystruct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: Path, names: list[str]) -> Optional[Path]:
    for name in names:
        for candidate in (root / name, root / (name + ".gz")):
            if candidate.exists():
                return candidate
        hits = list(root.rglob(name)) + list(root.rglob(name + ".gz"))
        if hits:
            return hits[0]
    return None


def _load_mnist_like(root: Path, train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    prefix = "train" if train else "t10k"
    img_path = _find(root, [f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"])
    lbl_path = _find(root, [f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels.idx1-ubyte"])
    if img_path is None or lbl_path is None:
        return None
    images = _read_idx(img_path)[..., None]  # [N, 28, 28, 1]
    labels = _read_idx(lbl_path).astype(np.int32)
    return images, labels


def _load_cifar10(root: Path, train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    batch_names = (
        [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    )
    imgs, lbls = [], []
    for name in batch_names:
        path = _find(root, [name])
        if path is None:
            return None
        with open(path, "rb") as f:
            entry = pickle.load(f, encoding="bytes")
        data = entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        imgs.append(data)
        lbls.append(np.asarray(entry[b"labels"], dtype=np.int32))
    return np.concatenate(imgs), np.concatenate(lbls)


def _folder_labels(root: Path, files: list[Path]) -> Optional[np.ndarray]:
    """Real class labels for an image folder, aligned with ``files`` order.

    The reference carried real targets for these datasets (Flowers102's 102
    classes and CelebA's attrs via torchvision, reference
    data/datamodule.py:140-178); an all-zero fallback silently degenerates
    conditional models. Label sources, in priority order:

    1. ``labels.txt`` — generic convention: one ``<filename> <int>`` per line.
    2. ``imagelabels.mat`` — Flowers102's official 1-indexed label vector,
       indexed by the number in ``image_NNNNN.jpg``; returned 0-indexed.
    3. ``list_attr_celeba.txt`` — CelebA's attribute file; the ``Male``
       attribute becomes the binary class (NUM_CLASSES["CelebA"] == 2).

    Returns None when no label source exists.
    """
    labels_txt = _find(root, ["labels.txt"])
    if labels_txt is not None:
        table = {}
        for line in Path(labels_txt).read_text().splitlines():
            parts = line.split()
            if len(parts) >= 2 and parts[-1].lstrip("-").isdigit():
                # Key by basename so path-prefixed entries still match.
                table[Path(parts[0]).name] = int(parts[-1])
        if table:
            return _lookup_labels(table, files, labels_txt)

    mat_path = _find(root, ["imagelabels.mat"])
    if mat_path is not None:
        try:
            from scipy.io import loadmat

            flat = np.asarray(loadmat(str(mat_path))["labels"]).ravel()
            out = np.zeros(len(files), dtype=np.int32)
            missing = 0
            for i, p in enumerate(files):
                stem = p.stem  # image_00001 -> index 0
                num = stem.rsplit("_", 1)[-1]
                if num.isdigit() and 1 <= int(num) <= len(flat):
                    out[i] = int(flat[int(num) - 1]) - 1  # 1-indexed -> 0
                else:
                    missing += 1
            if missing:
                logger.warning(
                    "%s: %d/%d filenames do not look like image_NNNNN within "
                    "the label vector's range; those files defaulted to "
                    "class 0.", mat_path, missing, len(files),
                )
            return out
        except Exception as e:
            logger.warning("failed to parse %s: %s", mat_path, e)

    attr_path = _find(root, ["list_attr_celeba.txt"])
    if attr_path is not None:
        try:
            lines = Path(attr_path).read_text().splitlines()
            attr_names = lines[1].split()
            col = attr_names.index("Male")
            table = {}
            for line in lines[2:]:
                parts = line.split()
                if len(parts) == len(attr_names) + 1:
                    table[Path(parts[0]).name] = 1 if int(parts[1 + col]) > 0 else 0
            return _lookup_labels(table, files, attr_path)
        except Exception as e:
            logger.warning("failed to parse %s: %s", attr_path, e)

    return None


def _lookup_labels(table: dict, files: list[Path], source: Path) -> np.ndarray:
    """Map ``files`` through a filename->label table, warning loudly when the
    table only partially covers the folder. Unmatched files fall back to
    class 0 — without the warning that silent default recreates exactly the
    degenerate-label failure the label sources exist to prevent (the
    trainer's all-zero guard never fires on partially-wrong labels)."""
    missing = sum(1 for p in files if p.name not in table)
    if missing:
        logger.warning(
            "%s covers only %d/%d images in the folder (%d unmatched files "
            "defaulted to class 0). Conditional training on these labels is "
            "unreliable — check that the label file keys match the image "
            "filenames.",
            source, len(files) - missing, len(files), missing,
        )
    return np.asarray([table.get(p.name, 0) for p in files], dtype=np.int32)


def _load_image_folder(
    root: Path, train: bool, size: Tuple[int, int, int]
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Load a folder of images (CelebA / Flowers102 / LSUN extracts)."""
    exts = {".png", ".jpg", ".jpeg", ".webp"}
    files = sorted(p for p in root.rglob("*") if p.suffix.lower() in exts)
    if not files:
        return None
    try:
        from PIL import Image
    except ImportError:
        logger.warning("PIL unavailable; cannot decode image folder %s", root)
        return None
    all_labels = _folder_labels(root, files)
    if all_labels is None:
        logger.warning(
            "Image folder %s has no label source (labels.txt / "
            "imagelabels.mat / list_attr_celeba.txt); labels are all zero — "
            "conditional models trained on this data will silently collapse "
            "to a single class.",
            root,
        )
        all_labels = np.zeros(len(files), dtype=np.int32)
    # 90/10 deterministic file-level split between train and eval pools.
    cut = max(1, int(len(files) * 0.9))
    files, labels = (
        (files[:cut], all_labels[:cut]) if train else (files[cut:], all_labels[cut:])
    )
    h, w, c = size
    out = np.empty((len(files), h, w, c), dtype=np.uint8)
    for i, p in enumerate(files):
        img = Image.open(p).convert("RGB" if c == 3 else "L")
        # Square center-crop to min side, then resize to native size.
        side = min(img.size)
        left = (img.size[0] - side) // 2
        top = (img.size[1] - side) // 2
        img = img.crop((left, top, left + side, top + side)).resize((w, h))
        arr = np.asarray(img, dtype=np.uint8)
        out[i] = arr[..., None] if c == 1 else arr
    return out, np.ascontiguousarray(labels)


def synthetic_dataset(
    name: str, train: bool, seed: int = 0, num_samples: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic procedural stand-in with per-class structure.

    Each class renders a distinct oriented sinusoidal texture modulated by a
    centered gaussian window, plus seeded noise — enough structure that
    overfit tests and metrics have signal, while being fully reproducible.
    """
    h, w, c = NATIVE_SHAPES[name]
    n_classes = NUM_CLASSES[name]
    n = num_samples or (4096 if train else 1024)
    rng = np.random.RandomState(seed + (0 if train else 1))
    labels = rng.randint(0, n_classes, size=n).astype(np.int32)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy = (yy - h / 2) / (h / 2)
    xx = (xx - w / 2) / (w / 2)
    window = np.exp(-(xx**2 + yy**2) * 2.0)

    images = np.empty((n, h, w, c), dtype=np.uint8)
    phases = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    shifts = rng.uniform(-0.3, 0.3, size=(n, 2)).astype(np.float32)
    for i in range(n):
        k = labels[i]
        angle = np.pi * k / max(n_classes, 1)
        freq = 3.0 + 2.0 * (k % 3)
        u = (xx - shifts[i, 0]) * np.cos(angle) + (yy - shifts[i, 1]) * np.sin(angle)
        base = 0.5 + 0.5 * np.sin(freq * np.pi * u + phases[i])
        img = base * window
        for ch in range(c):
            chan = img * (0.6 + 0.4 * np.cos(angle + ch))
            images[i, :, :, ch] = np.clip(chan * 255, 0, 255).astype(np.uint8)
    noise = rng.randint(0, 16, size=images.shape, dtype=np.uint8)
    images = np.clip(images.astype(np.int16) + noise - 8, 0, 255).astype(np.uint8)
    return images, labels


def load_dataset(
    name: str,
    data_dir: Optional[str],
    train: bool,
    allow_synthetic: bool = True,
    synthetic_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Return (images uint8 NHWC, labels i32, is_synthetic)."""
    canonical = {k.lower(): k for k in NATIVE_SHAPES}
    key = canonical.get(name.lower())
    if key is None:
        raise ValueError(
            f"Unknown dataset '{name}'. Supported: {sorted(NATIVE_SHAPES)}"
        )

    if data_dir is not None:
        root = Path(data_dir) / key
        if not root.exists():
            root = Path(data_dir)
        loaded = None
        if key in ("MNIST", "FashionMNIST"):
            loaded = _load_mnist_like(root, train)
        elif key == "CIFAR10":
            loaded = _load_cifar10(root, train)
        else:
            loaded = _load_image_folder(root, train, NATIVE_SHAPES[key])
        if loaded is not None:
            images, labels = loaded
            return images, labels, False

    if not allow_synthetic:
        raise FileNotFoundError(
            f"Dataset {key} not found under {data_dir} and synthetic fallback "
            "is disabled"
        )
    logger.warning(
        "Dataset %s not found on disk (no network egress available); using "
        "deterministic synthetic data with matching shapes.",
        key,
    )
    images, labels = synthetic_dataset(key, train, num_samples=synthetic_size)
    return images, labels, True
