"""VQGAN: VQ-VAE with a PatchGAN adversarial decoder (Esser et al. 2021).

Counterpart of ``lightning_generative_models_tpu/models/vae/vqgan.py``:

- the VQ-VAE backbone with the L1 reconstruction and the VQ loss;
- a PatchGAN discriminator trained with the hinge loss, with its own Adam (0.5, 0.9),
  which steps every step: before ``disc_start`` the loss is masked to 0
  (``disc_on``), so the step count, and Adam's bias correction after ``disc_start``,
  are the JAX package's;
- the adaptive adversarial weight
  ``lambda = clip(||d L_rec / d W|| / (||d L_adv / d W|| + 1e-4), 0, 1e4) * disc_weight``
  on the decoder's last transposed-conv kernel W, where L_rec is taming's nll: the L1
  reconstruction plus ``perceptual_weight`` times the mean LPIPS distance
  (``metrics/lpips.py``, frozen, part of the checkpoint) when that weight is positive.

The JAX step takes the two gradient norms from two extra forward passes with the
codebook as it was before the step (``train=False``). With the plain codebook that
pass computes what the training pass computes, so the port reads both norms from the
training pass's graph (``retain_graph``): one codebook search per step. With the EMA
codebook the training pass moves the codebook first, so the port runs one extra
eval-mode pass before it and reads both norms from that: two searches per step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.metrics.lpips import LPIPS
from lightning_generative_models_tpu_torch.models.modules.layers import (
    Conv,
    GroupNorm,
    init_params,
)
from lightning_generative_models_tpu_torch.models.vae.vqvae import VQVAE
from lightning_generative_models_tpu_torch.train.state import (
    apply_grads,
    count_params,
    make_adam,
)


class NLayerDiscriminator(nn.Module):
    """PatchGAN: a 4x4 stride-2 conv, then ``n_layers`` 4x4 convs (stride 2 but the
    last, no bias) each with a per-channel GroupNorm (flax ``group_size=1``) and
    LeakyReLU(0.2), then a 4x4 conv to one logit per patch. Submodules carry flax's
    auto-names in creation order."""

    def __init__(self, img_channels: int = 3, base_features: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.Conv_0 = Conv(img_channels, base_features, 4, stride=2)
        feats = base_features
        for i in range(1, n_layers + 1):
            prev, feats = feats, min(base_features * (2**i), 512)
            stride = 2 if i < n_layers else 1
            self.add_module(f"Conv_{i}", Conv(prev, feats, 4, bias=False, stride=stride))
            self.add_module(f"GroupNorm_{i - 1}", GroupNorm(feats, feats))
        self.add_module(f"Conv_{n_layers + 1}", Conv(feats, 1, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Conv_0(x), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"GroupNorm_{i - 1}")(getattr(self, f"Conv_{i}")(h))
            h = F.leaky_relu(h, 0.2)
        return getattr(self, f"Conv_{self.n_layers + 1}")(h)[..., 0]


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def _norm(g: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(g * g))


class VQGAN(VQVAE):
    monitor = "val_recon_loss"

    def __init__(
        self,
        *,
        disc_start: int = 10000,
        disc_weight: float = 0.8,
        disc_lr: Optional[float] = None,
        perceptual_weight: float = 0.0,
        **vqvae_kwargs,
    ):
        self.disc_start = disc_start
        self.disc_weight = disc_weight
        self.perceptual_weight = perceptual_weight
        self.disc_lr = disc_lr or vqvae_kwargs.get("lr", 1e-4)
        self.disc = NLayerDiscriminator(vqvae_kwargs.get("img_channels", 3))
        super().__init__(**vqvae_kwargs)
        # Frozen, and drawn once here: a run's init_params leaves it as it is.
        self.lpips = LPIPS(device=self.device).net if perceptual_weight > 0 else None

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """The VQ-VAE's weights, then the discriminator's, from one CPU generator; fresh
        optimizers at step 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        super().init_params(generator)
        init_params(self.disc, generator)
        self.disc.to(self.device)
        self.disc_optimizer = make_adam(list(self.disc.parameters()), self.disc_lr,
                                        0.5, 0.9)

    def param_counts(self) -> Dict[str, int]:
        return {**super().param_counts(), "disc": count_params(self.disc)}

    def flax_layout(self) -> dict:
        layout = super().flax_layout()
        layout["params"]["params/disc"] = self.disc
        if self.lpips is not None:
            layout["params"]["mutable/lpips"] = self.lpips
        layout["adam"]["opt_state/disc"] = (self.disc_optimizer, {"": self.disc})
        return layout

    def _nll(self, x_hat: torch.Tensor, x: torch.Tensor):
        """(recon_loss, perceptual_loss, nll): the L1 reconstruction, the mean LPIPS
        distance in model space (None without the perceptual term) and recon +
        perceptual_weight * perceptual."""
        recon_loss = torch.mean(torch.abs(x_hat - x))
        if self.lpips is None:
            return recon_loss, None, recon_loss
        p_loss = torch.mean(self.lpips(x_hat, x))
        return recon_loss, p_loss, recon_loss + self.perceptual_weight * p_loss

    # -- steps ---------------------------------------------------------------------
    def _adaptive_weight(self, nll, g_adv, retain: bool) -> torch.Tensor:
        kernel = self.decoder.last_kernel
        (g_rec,) = torch.autograd.grad(nll, kernel, retain_graph=True)
        (g_adv_grad,) = torch.autograd.grad(g_adv, kernel, retain_graph=retain)
        weight = torch.clamp(_norm(g_rec) / (_norm(g_adv_grad) + 1e-4), 0.0, 1e4)
        return weight.detach() * self.disc_weight

    def host_branch(self, step: int):
        """Whether the discriminator's terms are on (``disc_start``)."""
        return step >= self.disc_start

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One generator step (Adam) and one discriminator step (its own Adam) on a
        uint8 batch, flipped by ``flip`` [B] bool or by a draw from ``generator``."""
        x = self.to_model_space(self._x01(batch, generator, True, flip))
        disc_on = float(self.step >= self.disc_start)

        if self.use_ema:  # the norms from the codebook as it is before this step
            x_hat, _, _ = self._forward(x, False)
            adaptive_w = self._adaptive_weight(self._nll(x_hat, x)[2],
                                               -torch.mean(self.disc(x_hat)), False)
        x_hat, vq_loss, perplexity = self._forward(x, True)
        recon_loss, p_loss, nll = self._nll(x_hat, x)
        g_adv = -torch.mean(self.disc(x_hat))
        if not self.use_ema:
            adaptive_w = self._adaptive_weight(nll, g_adv, True)
        loss = (self.loss_weights["recon_loss"] * nll
                + self.loss_weights["vq_loss"] * vq_loss
                + disc_on * adaptive_w * g_adv)
        params = self._trainable()
        apply_grads(self.optimizer, params,
                    torch.autograd.grad(loss, params, allow_unused=True))

        # The discriminator, with its weights as they were in the generator's loss.
        x_hat = x_hat.detach()
        d_params = list(self.disc.parameters())
        d_loss = disc_on * hinge_d_loss(self.disc(x), self.disc(x_hat))
        apply_grads(self.disc_optimizer, d_params, torch.autograd.grad(d_loss, d_params))
        self.step += 1
        metrics = {"loss": loss, "recon_loss": recon_loss, "vq_loss": vq_loss,
                   "perplexity": perplexity, "g_adv_loss": g_adv,
                   "adaptive_weight": adaptive_w, "d_loss": d_loss}
        if p_loss is not None:
            metrics["perceptual_loss"] = p_loss
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = self.to_model_space(self._x01(batch, None, False, None))
        x_hat, vq_loss, perplexity = self._forward(x, False)
        recon_loss, p_loss, _ = self._nll(x_hat, x)
        metrics = {"recon_loss": recon_loss, "vq_loss": vq_loss, "perplexity": perplexity,
                   "g_adv_loss": -torch.mean(self.disc(x_hat)),
                   "loss": recon_loss + vq_loss}
        if p_loss is not None:
            metrics["perceptual_loss"] = p_loss
            metrics["loss"] = metrics["loss"] + self.perceptual_weight * p_loss
        return self.prefix_metrics(metrics, "val")

    # -- checkpoint state ------------------------------------------------------------
    def state_dict(self) -> dict:
        state = {**super().state_dict(), "disc": self.disc.state_dict(),
                 "disc_optimizer": self.disc_optimizer.state_dict()}
        if self.lpips is not None:
            state["lpips"] = self.lpips.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.disc.load_state_dict(state["disc"])
        self.disc_optimizer.load_state_dict(state["disc_optimizer"])
        if self.lpips is not None:
            self.lpips.load_state_dict(state["lpips"])
