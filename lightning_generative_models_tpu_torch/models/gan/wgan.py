"""WGAN: the Wasserstein GAN with a gradient penalty (``gp``) or weight clipping
(``clip``), on DCGAN's nets.

Counterpart of ``lightning_generative_models_tpu/models/gan/wgan.py``: critic loss
E[D(x_hat)] - E[D(x)] (+ the penalty), generator loss -E[D(x_hat)], and ``n_critic`` D
steps for each G step: step s (the model's step counter, on the host) is a D step when
(s + 1) % (n_critic + 1) != 0, and a G step otherwise. Both return the same five metrics,
zeros for the other step's.

- A D step makes the fake batch with G in train mode (batch statistics) without moving
  G's running statistics (the JAX branch drops them), then D runs in train mode on the
  real and the fake batch (D's statistics move twice); with ``gp`` the penalty follows.
  With ``clip``, every D weight (BatchNorm's scale and bias too, not its buffers) is
  clipped to +-clip_value after the update.
- A G step runs G once in train mode (G's statistics move once) and D, not updated, in
  train mode on its output (D's move once).
- The penalty: interp = alpha x + (1 - alpha) x_hat with alpha ~ U[0, 1) of shape
  [B, 1, 1, 1]; D in eval mode on the running statistics the two train passes left,
  differentiable in them (``batch_stats_in_graph``, as R1GAN); the gradient's norm over
  every non-batch axis with 1e-12 inside the square root; grad_penalty * E[(norm - 1)^2].
- ``gp`` steps with two Adams, ``clip`` with two RMSprops (``make_rmsprop``).
- ``eval_step`` is the GAN base's, with no penalty. f32 by default.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lightning_generative_models_tpu_torch.models.gan.dcgan import DCGAN
from lightning_generative_models_tpu_torch.models.gan.r1gan import input_gradient
from lightning_generative_models_tpu_torch.models.modules.layers import (
    batch_stats_in_graph,
    frozen_batch_stats,
)
from lightning_generative_models_tpu_torch.train.state import make_rmsprop

METRICS = ("d_loss", "d_loss_real", "d_loss_fake", "gradient_penalty", "g_loss")


class WGAN(DCGAN):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        latent_dim: int = 100,
        lr: float = 5e-5,
        weight_decay: float = 0.0,
        b1: float = 0.5,
        b2: float = 0.9,
        n_critic: int = 5,
        clip_value: float = 0.01,
        grad_penalty: float = 10.0,
        constraint_method: str = "gp",
        calculate_metrics: bool = False,
        metrics: Optional[list] = None,
        summary: bool = True,
        use_bf16: bool = False,
        device: str | torch.device = "cuda",
    ):
        if constraint_method not in ("gp", "clip"):
            raise ValueError("constraint_method is gradient penalty ('gp') or weight "
                             f"clipping ('clip'), got {constraint_method!r}")
        self.n_critic = n_critic
        self.clip_value = clip_value
        self.grad_penalty = grad_penalty
        self.constraint_method = constraint_method
        super().__init__(img_channels=img_channels, img_size=img_size, latent_dim=latent_dim,
                         lr=lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         calculate_metrics=calculate_metrics, metrics=metrics,
                         summary=summary, use_bf16=use_bf16, device=device)

    def _build_optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        if self.constraint_method == "clip":
            return {name: make_rmsprop(list(net.parameters()), self.lr)
                    for name, net in self.nets().items()}
        return super()._build_optimizers()

    def flax_layout(self) -> dict:
        layout = super().flax_layout()
        if self.constraint_method == "clip":
            layout["rmsprop"] = layout.pop("adam")
        return layout

    def is_d_step(self, step: Optional[int] = None) -> bool:
        """Whether step ``step`` (the model's next step when omitted) updates D."""
        step = self.step if step is None else step
        return (step + 1) % (self.n_critic + 1) != 0

    def host_branch(self, step: int):
        """A D step or a G step."""
        return self.is_d_step(step)

    # -- losses ----------------------------------------------------------------------
    def gradient_penalty(self, x: torch.Tensor, x_hat: torch.Tensor,
                         alpha: torch.Tensor) -> torch.Tensor:
        """grad_penalty * E[(||dD(interp)/d interp|| - 1)^2], D in eval mode."""
        interp = alpha * x + (1.0 - alpha) * x_hat
        grad = input_gradient(self.D, interp).float()
        norm = torch.sqrt(torch.sum(grad ** 2, dim=(1, 2, 3)) + 1e-12)
        return torch.mean((norm - 1.0) ** 2) * self.grad_penalty

    def _d_loss(self, x: torch.Tensor, x_hat: torch.Tensor,
                alpha: Optional[torch.Tensor] = None):
        with batch_stats_in_graph(self.D):
            d_loss_real = self.D(x).mean()
            d_loss_fake = self.D(x_hat).mean()
            d_loss = d_loss_fake - d_loss_real
            gp = torch.zeros((), device=x.device)
            if self.D.training and self.constraint_method == "gp":
                gp = self.gradient_penalty(x, x_hat, alpha)
                d_loss = d_loss + gp
        return d_loss, {"d_loss": d_loss, "d_loss_real": d_loss_real,
                        "d_loss_fake": d_loss_fake, "gradient_penalty": gp}

    def _g_loss(self, x_hat: torch.Tensor):
        g_loss = -self.D(x_hat).mean()
        return g_loss, {"g_loss": g_loss}

    # -- the interleaved step ----------------------------------------------------------
    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                   alpha: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """A D step or a G step, by the step counter (module doc), on a uint8 batch
        flipped by ``flip`` [B] bool, with the latent batch ``z`` and the penalty's
        ``alpha`` [B, 1, 1, 1], each drawn from ``generator`` when not given (alpha on
        every step, as JAX draws it)."""
        x = self._x(batch, generator, True, flip)
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        if alpha is None:
            alpha = torch.rand(x.shape[0], 1, 1, 1, generator=generator, device=self.device)
        self.G.train()
        self.D.train()
        zero = torch.zeros((), device=self.device)
        if self.is_d_step():
            with torch.no_grad(), frozen_batch_stats(self.G):
                x_hat = self.G(z)
            d_loss, metrics = self._d_loss(x, x_hat, alpha.to(self.device))
            self._optimize("D", d_loss, self.D)
            if self.constraint_method == "clip":
                with torch.no_grad():
                    params = list(self.D.parameters())
                    torch._foreach_clamp_min_(params, -self.clip_value)
                    torch._foreach_clamp_max_(params, self.clip_value)
            metrics["g_loss"] = zero
        else:
            g_loss, metrics = self._g_loss(self.G(z))
            self._optimize("G", g_loss, self.G)
            metrics = {**dict.fromkeys(METRICS, zero), **metrics}
        self.step += 1
        return self.prefix_metrics({k: metrics[k].detach().float() for k in METRICS}, "train")
