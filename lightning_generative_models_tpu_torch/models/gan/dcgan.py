"""DCGAN (Radford et al. 2016): conv generator and discriminator on the GAN base's step.

Counterpart of ``lightning_generative_models_tpu/models/gan/dcgan.py``, NHWC throughout:

- G: a Dense seed reshaped to NHWC [B, s, s, w0] (s = img_size / 16 with widths 1024, 512,
  256, 128; 28 px: s = 7 with 256, 128), BatchNorm + ReLU, stride-2 4x4 transposed convs
  with BatchNorm + ReLU, a last transposed conv to the image's channels and tanh in f32;
- D: stride-2 4x4 convs (64, 128, 256, 512; 28 px: 64, 128), BatchNorm on all but the
  first, LeakyReLU(0.2); then one VALID conv over the last map to one logit in f32 (28 px:
  a 7x7 VALID conv to 256, BatchNorm, LeakyReLU, a 1x1 conv to one logit in f32);
- conv and Dense kernels from N(0, 0.02), no conv bias, the Dense's bias at 0, BatchNorm
  scales from N(1, 0.02);
- ``use_bf16``: convs and the Dense in bf16, BatchNorm statistics and output in f32, each
  activation rounded back to bf16, as the JAX layers' ``dtype=`` arguments say.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.gan.gan import GAN
from lightning_generative_models_tpu_torch.models.modules.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dense,
)

INIT_STD = 0.02  # the DCGAN paper's N(0, 0.02) kernels and N(1, 0.02) BatchNorm scales


def _widths(img_size: int) -> Tuple[int, Tuple[int, ...], Tuple[int, ...]]:
    """(G's seed side, G's widths, D's widths) of the 16k-px and 28-px branches."""
    if img_size % 16 == 0:
        return img_size // 16, (1024, 512, 256, 128), (64, 128, 256, 512)
    if img_size == 28:
        return 7, (256, 128), (64, 128)
    raise ValueError(f"DCGAN supports 28 or multiples of 16, got {img_size}")


class ConvGenerator(nn.Module):
    def __init__(self, latent_dim: int, img_size: int, img_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.seed_hw, self.widths, _ = _widths(img_size)
        seed = self.seed_hw**2 * self.widths[0]
        self.Dense_0 = Dense(latent_dim, seed, dtype, std=INIT_STD)
        self.BatchNorm_0 = BatchNorm(self.widths[0], INIT_STD)
        outs = self.widths[1:] + (img_channels,)
        for i, (w_in, w_out) in enumerate(zip(self.widths, outs)):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(
                w_in, w_out, 4, stride=2, dtype=dtype, bias=False, std=INIT_STD))
            if i + 1 < len(outs):
                self.add_module(f"BatchNorm_{i + 1}", BatchNorm(w_out, INIT_STD))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.Dense_0(z.to(self.dtype))
        # The seed is NHWC, as the JAX reshape lays it out.
        h = h.reshape(h.shape[0], self.seed_hw, self.seed_hw, self.widths[0])
        h = F.relu(self.BatchNorm_0(h)).to(self.dtype)
        for i in range(len(self.widths) - 1):
            h = getattr(self, f"ConvTranspose_{i}")(h)
            h = F.relu(getattr(self, f"BatchNorm_{i + 1}")(h)).to(self.dtype)
        h = getattr(self, f"ConvTranspose_{len(self.widths) - 1}")(h)
        return torch.tanh(h.float())


class ConvDiscriminator(nn.Module):
    def __init__(self, img_size: int, img_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.img_size = img_size
        _, _, widths = _widths(img_size)
        self.n_convs = len(widths)
        prev = img_channels
        for i, width in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(prev, width, 4, dtype, bias=False, stride=2,
                                              std=INIT_STD))
            if i > 0:
                self.add_module(f"BatchNorm_{i - 1}", BatchNorm(width, INIT_STD))
            prev = width
        n = self.n_convs
        if img_size == 28:  # 7x7 map -> 256 by a VALID 7x7 conv, then a 1x1 head
            self.add_module(f"Conv_{n}", Conv(prev, 256, 7, dtype, bias=False,
                                              padding="VALID", std=INIT_STD))
            self.add_module(f"BatchNorm_{n - 1}", BatchNorm(256, INIT_STD))
            self.add_module(f"Conv_{n + 1}", Conv(256, 1, 1, torch.float32, bias=False,
                                                  std=INIT_STD))
        else:
            final = img_size // 16
            self.add_module(f"Conv_{n}", Conv(prev, 1, final, torch.float32, bias=False,
                                              padding="VALID", std=INIT_STD))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for i in range(self.n_convs):
            h = getattr(self, f"Conv_{i}")(h)
            if i > 0:
                h = getattr(self, f"BatchNorm_{i - 1}")(h)
            h = F.leaky_relu(h, 0.2).to(self.dtype)
        n = self.n_convs
        if self.img_size == 28:
            h = F.leaky_relu(getattr(self, f"BatchNorm_{n - 1}")(getattr(self, f"Conv_{n}")(h)),
                             0.2).to(self.dtype)
            h = getattr(self, f"Conv_{n + 1}")(h)
        else:
            h = getattr(self, f"Conv_{n}")(h)
        return h.reshape(h.shape[0]).float()


class DCGAN(GAN):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        latent_dim: int = 100,
        lr: float = 2e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
        loss_type: str = "non-saturating",
        calculate_metrics: bool = False,
        metrics: Optional[list] = None,
        summary: bool = True,
        use_bf16: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32  # read by _build_networks
        super().__init__(img_channels=img_channels, img_size=img_size, latent_dim=latent_dim,
                         lr=lr, b1=b1, b2=b2, weight_decay=weight_decay, loss_type=loss_type,
                         calculate_metrics=calculate_metrics, metrics=metrics,
                         summary=summary, device=device)

    def _build_networks(self) -> Tuple[nn.Module, nn.Module]:
        return (ConvGenerator(self.latent_dim, self.img_size, self.img_channels, self.dtype),
                ConvDiscriminator(self.img_size, self.img_channels, self.dtype))
