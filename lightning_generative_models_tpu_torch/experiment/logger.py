"""PNG output of the experiment logger.

Counterpart of ``_write_png`` in ``lightning_generative_models_tpu/experiment/logger.py``.
The JAX package writes through PIL and falls back to ``.npy`` without it; this
writes the PNG with the standard library alone, so the file is a PNG everywhere.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png(path: Path, image: np.ndarray) -> None:
    """Write a uint8 [H, W], [H, W, 1] or [H, W, 3] image as an 8-bit PNG."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[-1] != 3):
        raise ValueError(
            f"_write_png takes uint8 [H, W] or [H, W, 3], got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    color_type = 0 if image.ndim == 2 else 2  # greyscale or RGB
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = b"".join(b"\x00" + row.tobytes() for row in rows)  # filter 0 on every row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw)))
        f.write(_chunk(b"IEND", b""))
