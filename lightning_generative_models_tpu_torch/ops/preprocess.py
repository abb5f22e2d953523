"""On-device input preprocessing: uint8 batch -> float [0, 1] with the train-time flip.

Counterpart of ``lightning_generative_models_tpu/ops/preprocess.py`` for its default
``backend="xla"`` path, as plain torch on the batch's device. Batches cross from the
host as uint8 (a quarter of the bytes of f32) and are scaled and flipped here. The
flip is decided by an explicit ``[B]`` bool mask or drawn from a ``torch.Generator``,
so a test can hand the port the flips that JAX drew.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def to_float01(images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, C] -> float [0, 1]."""
    if images.dtype == torch.uint8:
        return images.to(dtype) * (1.0 / 255.0)
    return images.to(dtype)


def random_hflip(images: torch.Tensor, flip: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 prob: float = 0.5) -> torch.Tensor:
    """Per-sample horizontal flip of NHWC images, by the ``[B]`` bool mask ``flip``,
    or by one drawn from ``generator`` when it is None."""
    if flip is None:
        flip = torch.rand(images.shape[0], generator=generator, device=images.device) < prob
    flip = flip.to(device=images.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
    return torch.where(flip, images.flip(2), images)


def prepare_batch(
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    hflip: bool = True,
    dtype: torch.dtype = torch.float32,
    backend: str = "xla",
    flip: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """uint8 batch -> float [0, 1] model batch, flipped at train time (by ``flip``,
    or drawn from ``generator``; neither given: no flip, as JAX without an rng)."""
    if backend == "pallas":
        raise NotImplementedError(
            "prepare_batch(backend='pallas') needs the preprocess kernel "
            "(ops/preprocess.py kernel #7), not yet ported; see ROADMAP.md, Queue 2"
        )
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}; pick 'xla' or 'pallas'")
    out = dict(batch)
    images = to_float01(batch["image"], dtype)
    if train and hflip and (flip is not None or generator is not None):
        images = random_hflip(images, flip, generator)
    out["image"] = images
    return out
