"""LSGAN (Mao et al. 2017): DCGAN's nets and step with least-squares losses.

Counterpart of ``lightning_generative_models_tpu/models/gan/lsgan.py``:
d = 0.5 E[(D(x) - 1)^2] + 0.5 E[D(x_hat)^2], g = 0.5 E[(D(x_hat) - 1)^2].
"""

from __future__ import annotations

import torch

from lightning_generative_models_tpu_torch.models.gan.dcgan import DCGAN


class LSGAN(DCGAN):
    def _d_loss(self, x: torch.Tensor, x_hat: torch.Tensor):
        logits_real = self.D(x)
        logits_fake = self.D(x_hat)
        d_loss_real = 0.5 * torch.mean((logits_real - 1.0) ** 2)
        d_loss_fake = 0.5 * torch.mean(logits_fake ** 2)
        d_loss = d_loss_real + d_loss_fake
        return d_loss, {"d_loss": d_loss, "d_loss_real": d_loss_real,
                        "d_loss_fake": d_loss_fake, "logits_real": logits_real.mean(),
                        "logits_fake": logits_fake.mean()}

    def _g_loss(self, x_hat: torch.Tensor):
        g_loss = 0.5 * torch.mean((self.D(x_hat) - 1.0) ** 2)
        return g_loss, {"g_loss": g_loss}
