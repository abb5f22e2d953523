"""ACGAN (Odena et al. 2017): the auxiliary-classifier GAN.

Counterpart of ``lightning_generative_models_tpu/models/gan/acgan.py``: G is DCGAN's
``ConvGenerator`` (bf16 convs, as the JAX class builds it) on [z, one_hot(gen_labels)];
D (``ACDiscriminator``, f32) is DCGAN's strided conv stack with BatchNorm on every block
but the first and two Dense heads on the NHWC-flattened features, adversarial and class.
D = BCE(adv real / fake) / 2 + (CE(class | real, labels) + CE(class | fake, gen_labels)) / 2;
G = BCE(adv -> real) + CE(class | fake, gen_labels), through the stepped D. The step is
the GAN base's (G once, D then G); ``gen_labels`` is drawn uniformly when not given.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import bce_with_logits
from lightning_generative_models_tpu_torch.models.gan.dcgan import (
    INIT_STD,
    ConvGenerator,
    _widths,
)
from lightning_generative_models_tpu_torch.models.gan.gan import GAN, ClassConditional
from lightning_generative_models_tpu_torch.models.modules.layers import BatchNorm, Conv, Dense


class ConvFeatures(nn.Module):
    """The f32 strided 4x4 conv stack that ACGAN's, SGAN's and InfoGAN's discriminators
    share (64, 128, 256, 512; 28 px: 64, 128), no conv bias, BatchNorm (scale from ones)
    on all but the first, LeakyReLU(0.2). ``features`` maps images [B, H, W, C] to the
    NHWC-flattened features; subclasses add their heads."""

    def __init__(self, img_size: int, img_channels: int):
        super().__init__()
        _, _, widths = _widths(img_size)
        self.n_convs = len(widths)
        prev = img_channels
        for i, width in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(prev, width, 4, bias=False, stride=2,
                                              std=INIT_STD))
            if i > 0:
                self.add_module(f"BatchNorm_{i - 1}", BatchNorm(width))
            prev = width
        side = img_size // 2 ** len(widths)
        self.num_features = side * side * prev

    def features(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        for i in range(self.n_convs):
            h = getattr(self, f"Conv_{i}")(h)
            if i > 0:
                h = getattr(self, f"BatchNorm_{i - 1}")(h)
            h = F.leaky_relu(h, 0.2)
        return h.reshape(h.shape[0], -1)


class ACDiscriminator(ConvFeatures):
    def __init__(self, img_size: int, img_channels: int, num_classes: int):
        super().__init__(img_size, img_channels)
        self.Dense_0 = Dense(self.num_features, 1)
        self.Dense_1 = Dense(self.num_features, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.features(x)
        return self.Dense_0(h)[:, 0], self.Dense_1(h)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy on integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels``, averaged)."""
    return F.cross_entropy(logits.float(), labels.long())


class ACGAN(ClassConditional, GAN):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        latent_dim: int = 100,
        num_classes: int = 10,
        lr: float = 2e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
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
        return (ConvGenerator(self.latent_dim + self.num_classes, self.img_size,
                              self.img_channels),
                ACDiscriminator(self.img_size, self.img_channels, self.num_classes))

    def _generate(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        one_hot = F.one_hot(labels.long(), self.num_classes).float()
        return self.G(torch.cat([z, one_hot], dim=1))

    def sample_labels(self, generator: Optional[torch.Generator], n: int) -> torch.Tensor:
        return torch.randint(0, self.num_classes, (n,), generator=generator,
                             device=self.device)

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                   gen_labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The GAN base's step with the class losses (module doc); ``flip``, ``z`` and
        ``gen_labels`` [B] are drawn from ``generator`` when not given."""
        x = self._x(batch, generator, True, flip)
        labels = torch.as_tensor(batch["label"]).to(self.device).long()
        b = x.shape[0]
        z = self.sample_z(generator, b) if z is None else z.to(self.device)
        gen_labels = (self.sample_labels(generator, b) if gen_labels is None
                      else gen_labels.to(self.device).long())
        self.G.train()
        self.D.train()
        x_hat = self._generate(z, gen_labels)

        adv_r, cls_r = self.D(x)
        adv_f, cls_f = self.D(x_hat.detach())
        adv_loss = (bce_with_logits(adv_r, torch.ones_like(adv_r))
                    + bce_with_logits(adv_f, torch.zeros_like(adv_f))) / 2
        cls_loss = (cross_entropy(cls_r, labels) + cross_entropy(cls_f, gen_labels)) / 2
        d_loss = adv_loss + cls_loss
        acc = (cls_r.argmax(-1) == labels).float().mean()
        self._optimize("D", d_loss, self.D)

        adv_f, cls_f = self.D(x_hat)
        g_loss = (bce_with_logits(adv_f, torch.ones_like(adv_f))
                  + cross_entropy(cls_f, gen_labels))
        self._optimize("G", g_loss, self.G)
        self.step += 1
        metrics = {"d_loss": d_loss, "d_adv_loss": adv_loss, "d_cls_loss": cls_loss,
                   "cls_accuracy": acc, "g_loss": g_loss}
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The adversarial losses and the class accuracy on the real batch, with fakes of
        the batch's own labels, G and D in eval mode."""
        x = self._x(batch, None, False, None)
        labels = torch.as_tensor(batch["label"]).to(self.device).long()
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        self.G.eval()
        self.D.eval()
        x_hat = self._generate(z, labels)
        adv_r, cls_r = self.D(x)
        adv_f, _ = self.D(x_hat)
        d_loss = (bce_with_logits(adv_r, torch.ones_like(adv_r))
                  + bce_with_logits(adv_f, torch.zeros_like(adv_f))) / 2
        g_loss = bce_with_logits(adv_f, torch.ones_like(adv_f))
        acc = (cls_r.argmax(-1) == labels).float().mean()
        return self.prefix_metrics({"d_loss": d_loss, "g_loss": g_loss, "cls_accuracy": acc},
                                   "val")
