"""Image-grid assembly (torchvision.utils.make_grid equivalent).

Copy of ``lightning_generative_models_tpu/utils/grid.py``: a numpy uint8 HWC grid of
a batch of NHWC images.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def make_grid(
    images: np.ndarray,
    nrow: int = 8,
    padding: int = 2,
    pad_value: float = 0.0,
    value_range: Optional[tuple[float, float]] = None,
) -> np.ndarray:
    """[N, H, W, C] floats -> single [H', W', C] uint8 grid image."""
    images = np.asarray(images)
    if value_range is not None:
        lo, hi = value_range
        images = (images - lo) / max(hi - lo, 1e-8)
    images = np.clip(images, 0.0, 1.0)

    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = math.ceil(n / ncol)
    grid = np.full(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        pad_value,
        dtype=np.float32,
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        top = r * (h + padding) + padding
        left = col * (w + padding) + padding
        grid[top : top + h, left : left + w] = images[idx]
    return (grid * 255).round().astype(np.uint8)
