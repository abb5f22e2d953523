"""VAE: Auto-Encoding Variational Bayes (Kingma & Welling, 2014).

Counterpart of ``lightning_generative_models_tpu/models/vae/vae.py``: an MLP encoder
512-256-128 (LeakyReLU 0.2) with mu and log-variance heads, the mirrored decoder with a
tanh output, the reparameterised latent, and the loss ``l1(x_hat, x) + kld_weight * KLD``
with the KLD averaged over every element; Adam with the weight decay added to the
gradient (``train/state.py:make_adam``). The train step is ``grad_step`` +
``apply_grad_step``, as in the JAX package.

The model owns its modules (``net``: ``encoder``, ``decoder``), its optimizer and its step
counter. The random draws come from an explicit ``torch.Generator`` or are passed in: a
step's flip and the reparameterisation's ``eps``, ``sample``'s latent ``z``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import (
    GenerativeModel,
    refuse_sampler_options,
)
from lightning_generative_models_tpu_torch.models.diffusion.gaussian_diffusion import call_chain
from lightning_generative_models_tpu_torch.models.modules.layers import Dense, init_params
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.train.state import (
    apply_grads,
    count_params,
    make_adam,
)
from lightning_generative_models_tpu_torch.utils.draws import Draw
from lightning_generative_models_tpu_torch.weights import load_flax_train_state

_WIDTHS = (512, 256, 128)


class Encoder(nn.Module):
    """Flattened image -> (mu, log_var); flax's auto-names Dense_0 .. Dense_4."""

    def __init__(self, in_features: int, latent_dim: int):
        super().__init__()
        widths = (in_features, *_WIDTHS)
        for i in range(3):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.Dense_3 = Dense(_WIDTHS[-1], latent_dim)
        self.Dense_4 = Dense(_WIDTHS[-1], latent_dim)

    def forward(self, x: torch.Tensor):
        h = x.reshape(x.shape[0], -1)
        for i in range(3):
            h = F.leaky_relu(getattr(self, f"Dense_{i}")(h), 0.2)
        return self.Dense_3(h), self.Dense_4(h)


class Decoder(nn.Module):
    """Latent -> [b, H, W, C] in [-1, 1]; Dense_0 .. Dense_3."""

    def __init__(self, latent_dim: int, img_shape: tuple):
        super().__init__()
        self.img_shape = img_shape
        widths = (latent_dim, *_WIDTHS[::-1])
        for i in range(3):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.Dense_3 = Dense(_WIDTHS[0], int(np.prod(img_shape)))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for i in range(3):
            h = F.leaky_relu(getattr(self, f"Dense_{i}")(h), 0.2)
        return torch.tanh(self.Dense_3(h)).reshape(h.shape[0], *self.img_shape)


class VAE(GenerativeModel):
    def __init__(
        self,
        img_channels: int,
        img_size: int,
        latent_dim: int = 20,
        lr: float = 1e-4,
        b1: float = 0.9,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
        kld_weight: float = 1e-2,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``. The weights start from
        ``init_params`` with seed 0."""
        super().__init__(img_channels, img_size)
        self.device = resolve_device(device)
        self.latent_dim = latent_dim
        self.kld_weight = kld_weight
        self.lr, self.betas, self.weight_decay = lr, (b1, b2), weight_decay
        self.net = nn.ModuleDict({
            "encoder": Encoder(int(np.prod(self.image_shape())), latent_dim),
            "decoder": Decoder(latent_dim, self.image_shape()),
        })
        self.init_params()

    @property
    def encoder(self) -> Encoder:
        return self.net["encoder"]

    @property
    def decoder(self) -> Decoder:
        return self.net["decoder"]

    # -- parameters ----------------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every weight from the CPU ``generator`` and start a fresh optimizer at
        step 0."""
        init_params(self.net, generator)
        self.net.to(self.device)
        self.optimizer = make_adam(list(self.net.parameters()), self.lr, *self.betas,
                                   weight_decay=self.weight_decay)
        self.step = 0

    def param_counts(self) -> Dict[str, int]:
        return {name: count_params(module) for name, module in self.net.items()}

    def flax_layout(self) -> dict:
        return {"params": {"params/encoder": self.encoder, "params/decoder": self.decoder},
                "adam": {"opt_state/model": (self.optimizer, dict(self.net.items()))}}

    def load_flax_weights(self, tree) -> None:
        """``generate --weights``: a flattened JAX ``TrainState`` (its ``params``; the
        optimizer's entries are not read)."""
        load_flax_train_state(self, tree, optimizers=False)

    # -- math ----------------------------------------------------------------------
    def _x01(self, batch: Dict, generator: Optional[torch.Generator], train: bool,
             flip: Optional[torch.Tensor]) -> torch.Tensor:
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return prepare_batch(batch, generator, train=train, flip=flip)["image"]

    def reparameterize(self, mu: torch.Tensor, log_var: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mu + eps exp(log_var / 2); ``eps`` (mu's shape) drawn from ``generator``
        when not given."""
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        return mu + eps.to(mu.device, mu.dtype) * torch.exp(log_var / 2)

    def _loss(self, x01: torch.Tensor, generator: Optional[torch.Generator],
              eps: Optional[torch.Tensor]):
        x = self.to_model_space(x01)
        mu, log_var = self.encoder(x)
        x_hat = self.decoder(self.reparameterize(mu, log_var, generator, eps))
        recon_loss = torch.mean(torch.abs(x_hat - x))
        kld = -0.5 * torch.mean(1 + log_var - mu**2 - torch.exp(log_var))
        loss = recon_loss + self.kld_weight * kld
        return loss, {"loss": loss, "recon_loss": recon_loss, "kld": kld}

    # -- steps ---------------------------------------------------------------------
    def grad_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  flip: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None):
        """Gradients of the loss on a uint8 batch; the flip ([B] bool) and then ``eps``
        ([B, latent_dim]) from ``generator`` unless given. Returns (grads, metrics)."""
        x01 = self._x01(batch, generator, True, flip)
        loss, metrics = self._loss(x01, generator, eps)
        grads = torch.autograd.grad(loss, list(self.net.parameters()))
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def apply_grad_step(self, grads, metrics: Dict) -> Dict[str, torch.Tensor]:
        apply_grads(self.optimizer, list(self.net.parameters()), grads)
        self.step += 1
        return self.prefix_metrics(metrics, "train")

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   **draws) -> Dict[str, torch.Tensor]:
        return self.apply_grad_step(*self.grad_step(batch, generator, **draws))

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        _, metrics = self._loss(self._x01(batch, None, False, None), generator, eps)
        return self.prefix_metrics(metrics, "val")

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode ``z`` [num_samples, latent_dim] (drawn from ``generator`` when None)."""
        if z is None:
            z = torch.randn((num_samples, self.latent_dim), generator=generator,
                            device=self.device)
        return self._decode(z.to(self.device))

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.to_image_space(self.decoder(z))

    def serving_chain(self, batch_size: int, method=None, steps=None, labels=None):
        """``(chain, parts)`` of ``sample`` for ``serving.export_sampler``: z [n, latent]
        normal to the decoder."""
        refuse_sampler_options(self, method, steps)
        return (call_chain(self._decode, Draw("z", (batch_size, self.latent_dim))),
                {"decoder": self.decoder})

    @torch.inference_mode()
    def reconstruct(self, batch: Dict, generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.to_model_space(self._x01(batch, None, False, None))
        mu, log_var = self.encoder(x)
        return self.to_image_space(self.decoder(self.reparameterize(mu, log_var, generator,
                                                                    eps)))

    @torch.inference_mode()
    def encode_for_logging(self, batch: Dict) -> np.ndarray:
        """Latent means of a uint8 batch, for the latent-space table."""
        x = self.to_model_space(self._x01(batch, None, False, None))
        return self.encoder(x)[0].float().cpu().numpy()

    # -- checkpoint state ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"net": self.net.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.net.load_state_dict(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
