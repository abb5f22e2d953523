"""CGAN (Mirza & Osindero 2014): the conditional GAN.

Counterpart of ``lightning_generative_models_tpu/models/gan/cgan.py``, NHWC throughout
and f32, with no BatchNorm:

- G (``CondGenerator``): [z, one_hot(label)] -> Dense to an NHWC 7x7x256 seed (img_size/4
  when it divides by 4), LeakyReLU(0.2), two stride-2 3x3 "SAME" transposed convs (128,
  then the image's channels) with biases, LeakyReLU between, tanh;
- D (``CondDiscriminator``): the image with the one-hot label broadcast as extra planes
  after its channels, two stride-2 3x3 convs (64, 128) with LeakyReLU(0.2), the NHWC
  flatten, dropout 0.3 in training, a Dense to one logit.

Dropout takes explicit keep-masks (the masked features are scaled by 1 / 0.7, as flax's
``Dropout``): the step's three D passes (real, fake, and the G phase's) each take their
own, drawn from the generator when not given. The step is the GAN base's (G once, D then
G through the stepped D) with BCE losses; ``sample`` cycles the labels 0..9,
``sample_classes`` takes them, and the validation grid has a row per class.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import bce_with_logits
from lightning_generative_models_tpu_torch.models.gan.gan import GAN, ClassConditional
from lightning_generative_models_tpu_torch.models.modules.layers import (
    Conv,
    ConvTranspose,
    Dense,
)

DROPOUT = 0.3


class CondGenerator(nn.Module):
    def __init__(self, in_features: int, img_size: int, img_channels: int):
        super().__init__()
        if not (img_size % 4 == 0 or img_size == 28):
            raise ValueError(f"CGAN takes img_size 28 or a multiple of 4, got {img_size}")
        self.seed_hw = img_size // 4 if img_size % 4 == 0 else 7
        self.Dense_0 = Dense(in_features, self.seed_hw ** 2 * 256)
        self.ConvTranspose_0 = ConvTranspose(256, 128, 3, stride=2)
        self.ConvTranspose_1 = ConvTranspose(128, img_channels, 3, stride=2)

    def forward(self, zc: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Dense_0(zc), 0.2)
        h = h.reshape(h.shape[0], self.seed_hw, self.seed_hw, 256)
        h = F.leaky_relu(self.ConvTranspose_0(h), 0.2)
        return torch.tanh(self.ConvTranspose_1(h))


class CondDiscriminator(nn.Module):
    def __init__(self, img_size: int, in_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 64, 3, stride=2)
        self.Conv_1 = Conv(64, 128, 3, stride=2)
        side = -(-img_size // 4)  # two stride-2 SAME convs
        self.num_features = side * side * 128
        self.Dense_0 = Dense(self.num_features, 1)

    def forward(self, xc: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B]; ``keep`` [B, features] bool: the dropout keep-mask (None: none)."""
        h = F.leaky_relu(self.Conv_0(xc), 0.2)
        h = F.leaky_relu(self.Conv_1(h), 0.2)
        h = h.reshape(h.shape[0], -1)  # NHWC order, as the JAX reshape
        if keep is not None:
            h = torch.where(keep, h / (1.0 - DROPOUT), torch.zeros_like(h))
        return self.Dense_0(h)[:, 0]


class CGAN(ClassConditional, GAN):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        latent_dim: int = 128,
        lr: float = 1e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
        num_classes: int = 10,
        calculate_metrics: bool = False,
        metrics: Optional[list] = None,
        summary: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.num_classes = num_classes
        super().__init__(img_channels=img_channels, img_size=img_size, latent_dim=latent_dim,
                         lr=lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         calculate_metrics=calculate_metrics, metrics=metrics,
                         summary=summary, device=device)

    def _build_networks(self) -> Tuple[nn.Module, nn.Module]:
        return (CondGenerator(self.latent_dim + self.num_classes, self.img_size,
                              self.img_channels),
                CondDiscriminator(self.img_size, self.img_channels + self.num_classes))

    def _one_hot(self, labels: torch.Tensor) -> torch.Tensor:
        return F.one_hot(labels.long(), self.num_classes).float()

    def _generate(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return self.G(torch.cat([z, self._one_hot(labels)], dim=1))

    def _discriminate(self, x: torch.Tensor, labels: torch.Tensor,
                      keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        planes = self._one_hot(labels)[:, None, None, :].expand(b, h, w, self.num_classes)
        return self.D(torch.cat([x, planes], dim=-1), keep)

    def dropout_masks(self, generator: Optional[torch.Generator], n: int) -> torch.Tensor:
        """Three keep-masks [3, n, features] (the real, fake and G-phase passes), drawn
        example-major so that a data rank's rows are the global batch's."""
        return torch.rand(n, 3, self.D.num_features, generator=generator,
                          device=self.device).transpose(0, 1) < 1.0 - DROPOUT

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                   keep: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One D step then one G step on the batch's labels (module doc); ``flip``, ``z``
        and the three dropout keep-masks ``keep`` are drawn from ``generator`` when not
        given."""
        x = self._x(batch, generator, True, flip)
        labels = torch.as_tensor(batch["label"]).to(self.device).long()
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        keep = (self.dropout_masks(generator, x.shape[0]) if keep is None
                else [k.to(self.device) for k in keep])
        self.G.train()
        self.D.train()
        x_hat = self._generate(z, labels)

        logits_real = self._discriminate(x, labels, keep[0])
        logits_fake = self._discriminate(x_hat.detach(), labels, keep[1])
        d_loss_real = bce_with_logits(logits_real, torch.ones_like(logits_real))
        d_loss_fake = bce_with_logits(logits_fake, torch.zeros_like(logits_fake))
        d_loss = (d_loss_real + d_loss_fake) / 2
        self._optimize("D", d_loss, self.D)

        logits = self._discriminate(x_hat, labels, keep[2])
        g_loss = bce_with_logits(logits, torch.ones_like(logits))
        self._optimize("G", g_loss, self.G)
        self.step += 1
        metrics = {"d_loss": d_loss, "d_loss_real": d_loss_real, "d_loss_fake": d_loss_fake,
                   "logits_real": logits_real.mean(), "logits_fake": logits_fake.mean(),
                   "g_loss": g_loss}
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Both losses on the batch's labels, no dropout."""
        x = self._x(batch, None, False, None)
        labels = torch.as_tensor(batch["label"]).to(self.device).long()
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        logits_real = self._discriminate(x, labels)
        logits_fake = self._discriminate(self._generate(z, labels), labels)
        d_loss_real = bce_with_logits(logits_real, torch.ones_like(logits_real))
        d_loss_fake = bce_with_logits(logits_fake, torch.zeros_like(logits_fake))
        g_loss = bce_with_logits(logits_fake, torch.ones_like(logits_fake))
        return self.prefix_metrics({"d_loss": (d_loss_real + d_loss_fake) / 2,
                                    "d_loss_real": d_loss_real, "d_loss_fake": d_loss_fake,
                                    "g_loss": g_loss}, "val")
