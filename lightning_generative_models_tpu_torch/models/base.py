"""GenerativeModel: what the port's samplers and entry points need of a model.

Counterpart of ``lightning_generative_models_tpu/models/base.py``, reduced to the
sampling side: images are NHWC in [0, 1], and every source of randomness takes an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Tuple


class GenerativeModel:
    """Base class for the port's models."""

    def __init__(self, img_channels: int, img_size: int):
        self.img_channels = img_channels
        self.img_size = img_size

    @property
    def name(self) -> str:
        return type(self).__name__

    def image_shape(self) -> Tuple[int, int, int]:
        return (self.img_size, self.img_size, self.img_channels)
