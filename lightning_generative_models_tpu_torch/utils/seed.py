"""Seeding (counterpart of ``lightning_generative_models_tpu/utils/seed.py``).

The JAX package returns one root PRNG key; here the root of a run's randomness is a
``torch.Generator``, on the device where the run draws its noise. Python's and
numpy's global generators are seeded too, for host-side shuffling.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 10, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed host-side RNGs and return a ``torch.Generator`` on ``device`` seeded with
    ``seed``."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
