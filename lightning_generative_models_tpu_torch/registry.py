"""Model registry: config name -> model class.

Counterpart of ``lightning_generative_models_tpu/registry.py``, with the same
case-insensitive table of names. Only the names the port implements resolve; every
other registered name raises ``NotImplementedError``, and an unknown name raises
``ValueError`` listing the valid choices.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

# Every name of the JAX package's registry.
_NAMES = (
    "GAN", "CGAN", "InfoGAN", "DCGAN", "LSGAN", "WGAN", "R1GAN", "CycleGAN", "SGAN",
    "ACGAN", "BEGAN", "VAE", "VQVAE", "VQGAN", "DDPM", "LatentDiffusion",
    "FlowMatching", "LatentFlowMatching", "EDM", "LatentEDM", "ConsistencyModel",
    "DAE", "UNet", "PixelCNN", "NICE", "Glow",
)

# name -> (module path, class name) for the names ported so far.
_PORTED = {
    "GAN": ("lightning_generative_models_tpu_torch.models.gan.gan", "GAN"),
    "DCGAN": ("lightning_generative_models_tpu_torch.models.gan.dcgan", "DCGAN"),
    **{name: (f"lightning_generative_models_tpu_torch.models.gan.{name.lower()}", name)
       for name in ("LSGAN", "WGAN", "R1GAN", "CGAN", "InfoGAN", "ACGAN", "SGAN", "BEGAN",
                    "CycleGAN")},
    "DDPM": ("lightning_generative_models_tpu_torch.models.diffusion.ddpm", "DDPM"),
    "FlowMatching": ("lightning_generative_models_tpu_torch.models.diffusion.flow_matching",
                     "FlowMatching"),
    "VQVAE": ("lightning_generative_models_tpu_torch.models.vae.vqvae", "VQVAE"),
    "VQGAN": ("lightning_generative_models_tpu_torch.models.vae.vqgan", "VQGAN"),
}

_LOWER = {k.lower(): k for k in _NAMES}


def available_models() -> list[str]:
    return sorted(_NAMES)


def resolve_model_class(name: str) -> Any:
    key = _LOWER.get(name.lower())
    if key is None:
        raise ValueError(
            f"Unknown model '{name}'. Available: {', '.join(available_models())}"
        )
    if key not in _PORTED:
        raise NotImplementedError(
            f"Model '{key}' is not yet ported to the PyTorch package, see ROADMAP.md"
        )
    module_path, class_name = _PORTED[key]
    return getattr(importlib.import_module(module_path), class_name)


def load_model(model_config: Dict[str, Any], device: str | torch.device = "cuda") -> Any:
    """``{"name": ..., "args": {...}}`` -> ``ModelClass(**args, device=device)``."""
    cls = resolve_model_class(model_config["name"])
    return cls(**model_config.get("args", {}), device=device)
