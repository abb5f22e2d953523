"""Model registry: config name -> model class.

Counterpart of ``lightning_generative_models_tpu/registry.py``, with the same
case-insensitive table of names: every one resolves to the port's class, and an unknown
name raises ``ValueError`` listing the valid choices.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

# Every name of the JAX package's registry -> (module path, class name).
_MODELS = {
    "GAN": ("lightning_generative_models_tpu_torch.models.gan.gan", "GAN"),
    "DCGAN": ("lightning_generative_models_tpu_torch.models.gan.dcgan", "DCGAN"),
    **{name: (f"lightning_generative_models_tpu_torch.models.gan.{name.lower()}", name)
       for name in ("LSGAN", "WGAN", "R1GAN", "CGAN", "InfoGAN", "ACGAN", "SGAN", "BEGAN",
                    "CycleGAN")},
    "DDPM": ("lightning_generative_models_tpu_torch.models.diffusion.ddpm", "DDPM"),
    "FlowMatching": ("lightning_generative_models_tpu_torch.models.diffusion.flow_matching",
                     "FlowMatching"),
    "LatentFlowMatching": (
        "lightning_generative_models_tpu_torch.models.diffusion.flow_matching",
        "LatentFlowMatching"),
    "LatentDiffusion": ("lightning_generative_models_tpu_torch.models.diffusion.latent_diffusion",
                        "LatentDiffusion"),
    "EDM": ("lightning_generative_models_tpu_torch.models.diffusion.edm", "EDM"),
    "LatentEDM": ("lightning_generative_models_tpu_torch.models.diffusion.edm", "LatentEDM"),
    "ConsistencyModel": ("lightning_generative_models_tpu_torch.models.diffusion.consistency",
                         "ConsistencyModel"),
    "VAE": ("lightning_generative_models_tpu_torch.models.vae.vae", "VAE"),
    "VQVAE": ("lightning_generative_models_tpu_torch.models.vae.vqvae", "VQVAE"),
    "VQGAN": ("lightning_generative_models_tpu_torch.models.vae.vqgan", "VQGAN"),
    "DAE": ("lightning_generative_models_tpu_torch.models.autoencoder.dae", "DAE"),
    "UNet": ("lightning_generative_models_tpu_torch.models.autoencoder.unet", "UNetAE"),
    "PixelCNN": ("lightning_generative_models_tpu_torch.models.autoregressive.pixelcnn",
                 "PixelCNN"),
    "NICE": ("lightning_generative_models_tpu_torch.models.flow.nice", "NICE"),
    "Glow": ("lightning_generative_models_tpu_torch.models.flow.glow", "Glow"),
}

_LOWER = {k.lower(): k for k in _MODELS}


def available_models() -> list[str]:
    return sorted(_MODELS)


def resolve_model_class(name: str) -> Any:
    key = _LOWER.get(name.lower())
    if key is None:
        raise ValueError(
            f"Unknown model '{name}'. Available: {', '.join(available_models())}"
        )
    module_path, class_name = _MODELS[key]
    return getattr(importlib.import_module(module_path), class_name)


def load_model(model_config: Dict[str, Any], device: str | torch.device = "cuda") -> Any:
    """``{"name": ..., "args": {...}}`` -> ``ModelClass(**args, device=device)``."""
    cls = resolve_model_class(model_config["name"])
    return cls(**model_config.get("args", {}), device=device)
