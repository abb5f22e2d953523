"""R1GAN (Mescheder et al. 2018): DCGAN's nets and BCE losses, plus the R1 penalty on
the real batch.

Counterpart of ``lightning_generative_models_tpu/models/gan/r1gan.py``:
d = BCE(real) / 2 + BCE(fake) / 2 + r1_penalty * 0.5 E[||dD(x)/dx||^2], in training only.
The penalty's D pass runs in eval mode on the running statistics that the step's real
and fake train passes left, and it stays differentiable in them (flax returns those
statistics from the train applies inside D's differentiated loss, unstopped), so the
loss runs inside ``batch_stats_in_graph``. f32 by default (``use_bf16=False``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lightning_generative_models_tpu_torch.models.base import bce_with_logits
from lightning_generative_models_tpu_torch.models.gan.dcgan import DCGAN
from lightning_generative_models_tpu_torch.models.modules.layers import batch_stats_in_graph


def input_gradient(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """d sum(net(x)) / dx with ``net`` in eval mode, kept in the graph (create_graph) so
    that a loss on it differentiates again into the weights; the mode is restored."""
    x = x.detach().requires_grad_(True)
    was_training = net.training
    net.eval()
    try:
        (grad,) = torch.autograd.grad(net(x).sum(), x, create_graph=True)
    finally:
        net.train(was_training)
    return grad


class R1GAN(DCGAN):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        latent_dim: int = 100,
        lr: float = 2e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
        r1_penalty: float = 10.0,
        calculate_metrics: bool = False,
        metrics: Optional[list] = None,
        summary: bool = True,
        use_bf16: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.r1_penalty = r1_penalty
        super().__init__(img_channels=img_channels, img_size=img_size, latent_dim=latent_dim,
                         lr=lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         calculate_metrics=calculate_metrics, metrics=metrics,
                         summary=summary, use_bf16=use_bf16, device=device)

    def _r1(self, x: torch.Tensor) -> torch.Tensor:
        """0.5 E[||dD(x)/dx||^2], D in eval mode."""
        grad = input_gradient(self.D, x).float()
        return 0.5 * torch.mean(torch.sum(grad ** 2, dim=(1, 2, 3)))

    def _d_loss(self, x: torch.Tensor, x_hat: torch.Tensor):
        with batch_stats_in_graph(self.D):
            logits_real = self.D(x)
            logits_fake = self.D(x_hat)
            d_loss_real = bce_with_logits(logits_real, torch.ones_like(logits_real))
            d_loss_fake = bce_with_logits(logits_fake, torch.zeros_like(logits_fake))
            d_loss = (d_loss_real + d_loss_fake) / 2
            r1 = self._r1(x) if self.D.training else torch.zeros((), device=x.device)
        d_loss = d_loss + self.r1_penalty * r1
        return d_loss, {"d_loss": d_loss, "d_loss_real": d_loss_real,
                        "d_loss_fake": d_loss_fake, "r1_penalty": r1,
                        "logits_real": logits_real.mean(), "logits_fake": logits_fake.mean()}
