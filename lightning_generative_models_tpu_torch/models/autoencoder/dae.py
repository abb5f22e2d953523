"""DAE: the denoising autoencoder.

Counterpart of ``lightning_generative_models_tpu/models/autoencoder/dae.py``: an MLP
784 -> 256 -> 128 -> 256 -> 784 (ReLU, a tanh output; flax's ``Dense_0`` .. ``Dense_3``),
gaussian or salt-and-pepper input noise on the [-1, 1] image, and the mean squared error
against the clean image, under Adam.

The random draws come from an explicit ``torch.Generator`` or are passed in: a step's flip
(JAX flips MNIST at train time through ``prepare_batch``, and so does the port) and its
noise: gaussian ``noise`` (the image's shape, scaled by ``noise_level``), or the
salt-and-pepper ``salt`` and ``pepper`` masks, each true with probability
``noise_level / 2``, salt applied first and pepper over it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import AdamModel, refuse_sampler_options
from lightning_generative_models_tpu_torch.models.diffusion.gaussian_diffusion import call_chain
from lightning_generative_models_tpu_torch.models.modules.layers import Dense
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.utils.draws import Draw

_WIDTHS = (256, 128, 256)


class MLPAutoencoder(nn.Module):
    """[B, H, W, C] -> [B, H, W, C] in [-1, 1] through Dense_0 .. Dense_3."""

    def __init__(self, img_shape: Tuple[int, int, int]):
        super().__init__()
        self.img_shape = img_shape
        widths = (int(np.prod(img_shape)), *_WIDTHS, int(np.prod(img_shape)))
        for i in range(4):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for i in range(3):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        return torch.tanh(self.Dense_3(h)).reshape(x.shape[0], *self.img_shape)


class DAE(AdamModel):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        noise_type: str = "gaussian",
        noise_level: float = 0.1,
        lr: float = 1e-4,
        b1: float = 0.9,
        b2: float = 0.999,
        weight_decay: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``."""
        if noise_type not in ("gaussian", "salt_and_pepper"):
            raise ValueError("Invalid noise type specified")
        self.noise_type = noise_type
        self.noise_level = noise_level
        super().__init__(img_channels, img_size, MLPAutoencoder((img_size, img_size,
                                                                 img_channels)),
                         lr, b1, b2, weight_decay, device)

    def add_noise(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None, salt: Optional[torch.Tensor] = None,
                  pepper: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (in [-1, 1]) with the configured noise; the draws (x's shape) come from
        ``generator`` unless given."""
        if self.noise_type == "gaussian":
            if noise is None:
                noise = torch.randn(x.shape, generator=generator, device=x.device)
            return x + noise.to(x.device) * self.noise_level
        p = self.noise_level / 2
        if salt is None:
            salt = torch.rand(x.shape, generator=generator, device=x.device) < p
        if pepper is None:
            pepper = torch.rand(x.shape, generator=generator, device=x.device) < p
        salted = torch.where(salt.to(x.device), 1.0, x)
        return torch.where(pepper.to(x.device), -1.0, salted)

    def _x01(self, batch: Dict, generator: Optional[torch.Generator] = None,
             train: bool = False, flip: Optional[torch.Tensor] = None) -> torch.Tensor:
        return prepare_batch(self._to_device(batch), generator, train=train,
                             flip=flip)["image"]

    def _loss(self, x01: torch.Tensor, generator: Optional[torch.Generator], **noise):
        x = self.to_model_space(x01)
        x_hat = self.net(self.add_noise(x, generator, **noise))
        loss = torch.mean((x_hat - x) ** 2)
        return loss, {"loss": loss}

    def grad_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  flip: Optional[torch.Tensor] = None, **noise):
        """Gradients of the loss on a uint8 batch; the flip ([B] bool), then the noise
        (``noise``, or ``salt`` and ``pepper``) from ``generator`` unless given."""
        x01 = self._x01(batch, generator, True, flip)
        return self._grads(*self._loss(x01, generator, **noise))

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  **noise) -> Dict[str, torch.Tensor]:
        """The loss on the unflipped batch, with fresh noise (JAX: ``fold_in(rng, 1)``)."""
        _, metrics = self._loss(self._x01(batch), generator, **noise)
        return self.prefix_metrics(metrics, "val")

    @torch.inference_mode()
    def denoise(self, batch: Dict, generator: Optional[torch.Generator] = None,
                **noise) -> torch.Tensor:
        """The reconstruction of the noised batch, in [0, 1]."""
        noisy = self.add_noise(self.to_model_space(self._x01(batch)), generator, **noise)
        return self.to_image_space(self.net(noisy))

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The DAE has no prior: it decodes gaussian noise images ``noise`` (drawn from
        ``generator`` when None), a diagnostic."""
        if noise is None:
            noise = torch.randn((num_samples, *self.image_shape()), generator=generator,
                                device=self.device)
        return self._decode(noise.to(self.device))

    def _decode(self, noise: torch.Tensor) -> torch.Tensor:
        return self.to_image_space(self.net(noise))

    def serving_chain(self, batch_size: int, method=None, steps=None, labels=None):
        """``(chain, parts)`` of ``sample`` for ``serving.export_sampler``: a normal draw
        of the images' shape through the net."""
        refuse_sampler_options(self, method, steps)
        return (call_chain(self._decode, Draw("noise", (batch_size, *self.image_shape()))),
                {"net": self.net})
