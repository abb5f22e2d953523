"""The port's dataset downloaders (``data/download.py``) against the JAX package's copy, on
the CPU and with no network: tiny MNIST-gz, CIFAR-10 tgz, CycleGAN zip and pix2pix tgz
archives built under ``tmp_path``, the fetchers pointed at their ``file://`` URLs and each
package's dataset root patched. The same files land where the JAX copy puts them, and the
port's loaders read what lands."""

import gzip
import io
import pickle
import tarfile
import warnings
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.data import download as jax_download
from lightning_generative_models_tpu_torch.data import download
from lightning_generative_models_tpu_torch.data.datasets import load_dataset

torch.set_num_threads(1)


def _idx(array: np.ndarray) -> bytes:
    """An MNIST idx file: magic (ubyte, ndim), the dims big-endian, the bytes."""
    head = bytes([0, 0, 0x08, array.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in array.shape)
    return head + array.astype(np.uint8).tobytes()


def _sources(src: Path) -> dict:
    """The archives under ``src``: {what: file URL (MNIST: the directory's)}."""
    rs = np.random.RandomState(0)
    mnist = src / "mnist"
    mnist.mkdir(parents=True)
    for split, n in (("train", 6), ("t10k", 4)):
        for kind, arr in (("images-idx3", rs.randint(0, 256, (n, 28, 28))),
                          ("labels-idx1", rs.randint(0, 10, n))):
            (mnist / f"{split}-{kind}-ubyte.gz").write_bytes(gzip.compress(_idx(arr)))
    tgz = src / "cifar-10-python.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            blob = pickle.dumps({b"data": rs.randint(0, 256, (3, 3072)).astype(np.uint8),
                                 b"labels": [1, 2, 3]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    with zipfile.ZipFile(src / "horse2zebra.zip", "w") as zf:
        zf.writestr("horse2zebra/trainA/a.jpg", b"A")
        zf.writestr("horse2zebra/trainB/b.jpg", b"B")
    with tarfile.open(src / "facades.tar.gz", "w:gz") as tf:
        info = tarfile.TarInfo("facades/train/1.jpg")
        info.size = 1
        tf.addfile(info, io.BytesIO(b"F"))
    return {"mnist": mnist.as_uri() + "/", "cifar10": tgz.as_uri(),
            "cyclegan": (src / "{name}.zip").as_uri().replace("%7B", "{").replace("%7D", "}"),
            "pix2pix": (src / "{name}.tar.gz").as_uri().replace("%7B", "{").replace("%7D", "}")}


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture()
def fetched(tmp_path, monkeypatch):
    """Both packages' downloads of every spec: (the port's root, the JAX copy's root)."""
    urls = _sources(tmp_path / "src")
    roots = {}
    for module, label in ((download, "port"), (jax_download, "jax")):
        monkeypatch.setattr(module, "DATASET_PATH", tmp_path / label)
        monkeypatch.setattr(module, "MNIST_URLS", {"MNIST": urls["mnist"],
                                                   "FashionMNIST": urls["mnist"]})
        monkeypatch.setattr(module, "CIFAR10_URL", urls["cifar10"])
        monkeypatch.setattr(module, "CYCLEGAN_URL", urls["cyclegan"])
        monkeypatch.setattr(module, "PIX2PIX_URL", urls["pix2pix"])
        with warnings.catch_warnings():
            warnings.simplefilter("error" if module is download else "ignore")
            assert module.main(["mnist", "FashionMNIST", "cifar10", "cyclegan:horse2zebra",
                                "pix2pix:facades"]) == 0
        roots[label] = tmp_path / label
    return roots["port"], roots["jax"]


def test_downloads_land_where_the_jax_copy_puts_them(fetched):
    """Every fetched archive and extracted file, byte for byte, at the JAX copy's paths; the
    port's tar extraction (``filter="data"``) raises no warning."""
    port, jax_root = fetched
    tree = _tree(port)
    assert tree == _tree(jax_root)
    for path in ("MNIST/train-images-idx3-ubyte", "FashionMNIST/t10k-labels-idx1-ubyte.gz",
                 "CIFAR10/cifar-10-batches-py/test_batch", "horse2zebra/trainA/a.jpg",
                 "horse2zebra/horse2zebra.zip", "facades/train/1.jpg"):
        assert path in tree, path


def test_port_loaders_read_the_downloads(fetched):
    """``data/datasets.py`` finds what landed: MNIST 6 + 4 images, CIFAR-10 15 + 3."""
    port, _ = fetched
    for name, n_train, n_test, shape in (("MNIST", 6, 4, (28, 28, 1)),
                                         ("CIFAR10", 15, 3, (32, 32, 3))):
        for train, n in ((True, n_train), (False, n_test)):
            images, labels, synthetic = load_dataset(name, str(port), train,
                                                     allow_synthetic=False)
            assert not synthetic and images.shape == (n, *shape) and labels.shape == (n,)


def test_unknown_spec_and_no_spec_return_1_with_jax_messages(capsys):
    assert download.main(["celeba"]) == 1
    assert capsys.readouterr().out == "unknown dataset spec: celeba\n"
    assert jax_download.main(["celeba"]) == 1
    assert capsys.readouterr().out == "unknown dataset spec: celeba\n"
    assert download.main([]) == 1
    assert "python -m lightning_generative_models_tpu_torch.data.download" in \
        capsys.readouterr().out
