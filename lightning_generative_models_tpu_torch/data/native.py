"""ctypes binding for the package's native preprocessing library.

Counterpart of ``lightning_generative_models_tpu/data/native.py``. The source is the
package's own copy, ``csrc/host_preprocess.cpp``, built with g++ and the JAX package's
flags (``native/Makefile``) into ``_build/libhost_preprocess-<digest>.so`` at first use;
the digest covers the source and the flags, so an edited source is rebuilt. The build
writes a temporary file and renames it, so that processes building at once never load
half a library. A build that fails raises with the compiler's output: there is no quiet
numpy fallback. The DataModule's one-time staging calls it for non-trivial resizes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from lightning_generative_models_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "host_preprocess.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhost_preprocess-{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library unless it is built; returns its path. Raises RuntimeError
    with the compiler's output if the build fails."""
    target = library_path()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    return str(target)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.center_crop_resize_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.center_crop_resize_batch.restype = None
        _lib = lib
    return _lib


def center_crop_resize_batch(images: np.ndarray, size: int,
                             num_threads: int = 0) -> np.ndarray:
    """[N, H, W, C] uint8 -> [N, size, size, C] uint8: a centered min(H, W) square
    crop, then an area (box-filter) resize; ``num_threads`` 0 takes every core."""
    lib = _load()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    out = np.empty((n, size, size, c), dtype=np.uint8)
    lib.center_crop_resize_batch(images.ctypes.data, n, h, w, c, out.ctypes.data, size,
                                 num_threads)
    return out
