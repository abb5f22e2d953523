"""SGAN (Salimans et al. 2016; Odena 2016): the semi-supervised GAN.

Counterpart of ``lightning_generative_models_tpu/models/gan/sgan.py``: G is DCGAN's
``ConvGenerator`` (bf16 convs, as the JAX class builds it); D is ACGAN's conv stack with
one Dense head of num_classes + 1 logits, the last meaning "fake". The labelled share of a
batch is its first max(int(B * labeled_fraction), 1) rows. D = CE on the labelled reals +
-E[log(1 - p_fake(x) + 1e-8)] + CE(fake -> the fake class); G = -E[log(1 - p_fake(x_hat)
+ 1e-8)] through the stepped D. The step is the GAN base's (G once, D then G).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.gan.acgan import ConvFeatures
from lightning_generative_models_tpu_torch.models.gan.dcgan import ConvGenerator
from lightning_generative_models_tpu_torch.models.gan.gan import GAN
from lightning_generative_models_tpu_torch.models.modules.layers import Dense
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib


class ClassifierDiscriminator(ConvFeatures):
    def __init__(self, img_size: int, img_channels: int, num_outputs: int):
        super().__init__(img_size, img_channels)
        self.Dense_0 = Dense(self.num_features, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(self.features(x))


class SGAN(GAN):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        latent_dim: int = 100,
        num_classes: int = 10,
        labeled_fraction: float = 0.1,
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
        self.labeled_fraction = labeled_fraction
        super().__init__(img_channels=img_channels, img_size=img_size, latent_dim=latent_dim,
                         lr=lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         calculate_metrics=calculate_metrics, metrics=metrics,
                         summary=summary, device=device)

    def _build_networks(self) -> Tuple[nn.Module, nn.Module]:
        return (ConvGenerator(self.latent_dim, self.img_size, self.img_channels),
                ClassifierDiscriminator(self.img_size, self.img_channels,
                                        self.num_classes + 1))

    def _p_fake(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(logits, dim=-1)[:, self.num_classes]

    def _g_loss(self, x_hat: torch.Tensor):
        g_loss = -torch.mean(torch.log(1.0 - self._p_fake(self.D(x_hat)) + 1e-8))
        return g_loss, {"g_loss": g_loss}

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The GAN base's step with the semi-supervised losses (module doc)."""
        x = self._x(batch, generator, True, flip)
        labels = torch.as_tensor(batch["label"]).to(self.device).long()
        b = x.shape[0]
        z = self.sample_z(generator, b) if z is None else z.to(self.device)
        self.G.train()
        self.D.train()
        x_hat = self.G(z)

        # The labeled rows are the global batch's first ones; the supervised mean is over
        # all of them (each data rank's share of the sum, over the global count, times the
        # ranks the optimizer's average divides by).
        ranks = mesh_lib.data_size()
        n_labeled = max(int(b * ranks * self.labeled_fraction), 1)
        labeled = (mesh_lib.example_ids(b, self.device) < n_labeled).float()
        fake_labels = torch.full((b,), self.num_classes, dtype=torch.long, device=self.device)
        logits_real = self.D(x)
        logits_fake = self.D(x_hat.detach())
        ce_real = F.cross_entropy(logits_real, labels, reduction="none")
        count = mesh_lib.data_mean(torch.sum(labeled)) * ranks
        supervised = ranks * torch.sum(ce_real * labeled) / count
        unsup_real = -torch.mean(torch.log(1.0 - self._p_fake(logits_real) + 1e-8))
        unsup_fake = F.cross_entropy(logits_fake, fake_labels)
        d_loss = supervised + unsup_real + unsup_fake
        hits = (logits_real[:, :self.num_classes].argmax(-1) == labels).float()
        acc = ranks * torch.sum(hits * labeled) / count
        self._optimize("D", d_loss, self.D)

        g_loss, _ = self._g_loss(x_hat)
        self._optimize("G", g_loss, self.G)
        self.step += 1
        metrics = {"d_loss": d_loss, "supervised_loss": supervised, "d_loss_real": unsup_real,
                   "d_loss_fake": unsup_fake, "labeled_acc": acc, "g_loss": g_loss}
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The supervised loss and accuracy on the whole real batch and G's loss, G and D
        in eval mode."""
        x = self._x(batch, None, False, None)
        labels = torch.as_tensor(batch["label"]).to(self.device).long()
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        self.G.eval()
        self.D.eval()
        logits_real = self.D(x)
        g_loss, _ = self._g_loss(self.G(z))
        acc = (logits_real[:, :self.num_classes].argmax(-1) == labels).float().mean()
        return self.prefix_metrics({"supervised_loss": F.cross_entropy(logits_real, labels),
                                    "accuracy": acc, "g_loss": g_loss}, "val")

    @torch.inference_mode()
    def classify(self, batch: Dict) -> torch.Tensor:
        """The class head's predictions [B] on a uint8 batch, D in eval mode."""
        self.D.eval()
        logits = self.D(self._x(batch, None, False, None))
        return logits[:, :self.num_classes].argmax(-1)
