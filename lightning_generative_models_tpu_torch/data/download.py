"""Dataset downloaders of the port (copy of ``lightning_generative_models_tpu/data/download.py``).

MNIST / FashionMNIST, CIFAR-10, and the CycleGAN and pix2pix archives, laid out where
``data/datasets.py`` looks for them (``DATASET_PATH/<name>``), with the JAX package's
specs and messages. Needs network access; without it the port trains on the synthetic
stand-ins. Tar archives are extracted with ``filter="data"`` (Python 3.12 warns without a
filter; the JAX copy passes none).

    python -m lightning_generative_models_tpu_torch.data.download mnist cifar10
    python -m lightning_generative_models_tpu_torch.data.download cyclegan:horse2zebra
"""

from __future__ import annotations

import gzip
import shutil
import sys
import tarfile
import urllib.request
import zipfile
from pathlib import Path

from lightning_generative_models_tpu_torch.utils.path import DATASET_PATH

MNIST_URLS = {
    "MNIST": "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "FashionMNIST": "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/",
}
MNIST_FILES = [
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
]
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
# Berkeley-hosted CycleGAN/pix2pix archives.
CYCLEGAN_URL = "http://efrosgans.eecs.berkeley.edu/cyclegan/datasets/{name}.zip"
PIX2PIX_URL = "http://efrosgans.eecs.berkeley.edu/pix2pix/datasets/{name}.tar.gz"


def _fetch(url: str, dest: Path) -> Path:
    dest.parent.mkdir(parents=True, exist_ok=True)
    if dest.exists():
        return dest
    print(f"downloading {url} -> {dest}")
    with urllib.request.urlopen(url) as r, open(dest, "wb") as f:
        shutil.copyfileobj(r, f)
    return dest


def _extract_tar(archive: Path, root: Path) -> None:
    with tarfile.open(archive) as tf:
        tf.extractall(root, filter="data")


def download_mnist_like(name: str) -> None:
    root = Path(DATASET_PATH) / name
    for fname in MNIST_FILES:
        gz = _fetch(MNIST_URLS[name] + fname, root / fname)
        out = root / fname[:-3]
        if not out.exists():
            with gzip.open(gz, "rb") as src, open(out, "wb") as dst:
                shutil.copyfileobj(src, dst)


def download_cifar10() -> None:
    root = Path(DATASET_PATH) / "CIFAR10"
    _extract_tar(_fetch(CIFAR10_URL, root / "cifar-10-python.tar.gz"), root)


def download_cyclegan(name: str) -> None:
    root = Path(DATASET_PATH) / name
    z = _fetch(CYCLEGAN_URL.format(name=name), root / f"{name}.zip")
    with zipfile.ZipFile(z) as zf:
        zf.extractall(root.parent)


def download_pix2pix(name: str) -> None:
    root = Path(DATASET_PATH) / name
    _extract_tar(_fetch(PIX2PIX_URL.format(name=name), root / f"{name}.tar.gz"), root.parent)


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 1
    for spec in argv:
        key = spec.lower()
        if key == "mnist":
            download_mnist_like("MNIST")
        elif key == "fashionmnist":
            download_mnist_like("FashionMNIST")
        elif key == "cifar10":
            download_cifar10()
        elif key.startswith("cyclegan:"):
            download_cyclegan(spec.split(":", 1)[1])
        elif key.startswith("pix2pix:"):
            download_pix2pix(spec.split(":", 1)[1])
        else:
            print(f"unknown dataset spec: {spec}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
