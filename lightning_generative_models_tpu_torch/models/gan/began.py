"""BEGAN (Berthelot et al. 2017): the boundary-equilibrium GAN.

Counterpart of ``lightning_generative_models_tpu/models/gan/began.py``, NHWC and f32,
with no BatchNorm. D is an autoencoder (``BEGANEncoder`` then ``BEGANDecoder``, ELU
after every conv but the last) scored by its pixel L1 reconstruction error
L(v) = E|AE(v) - v|; G is a ``BEGANDecoder`` on z. Each decoder stage is a nearest 2x
upsampling (an exact repeat, as ``jax.image.resize`` "nearest" at 2x) and two 3x3 convs.

- D: L(x) - k_t L(G(z)) (the fake detached), then G: L(G(z)) through the stepped D;
- k_{t+1} = clip(k_t + lambda_k (gamma L(x) - L(G(z))), 0, 1), with L(x) from the D phase
  and L(G(z)) from the G phase; ``k_t`` is carried (a 0-d tensor on the device, 0 at the
  start, in the checkpoint); the ``d_loss`` metric uses the old k_t, ``k_t`` the new one;
- the convergence measure L(x) + |gamma L(x) - L(G(z))| is logged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.gan.gan import GAN
from lightning_generative_models_tpu_torch.models.modules.layers import Conv, Dense
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib


class BEGANDecoder(nn.Module):
    def __init__(self, in_features: int, img_size: int, img_channels: int, hidden_dim: int):
        super().__init__()
        self.seed, self.hidden = img_size // 4, hidden_dim
        self.Dense_0 = Dense(in_features, self.seed ** 2 * hidden_dim)
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv(hidden_dim, hidden_dim, 3))
        self.Conv_4 = Conv(hidden_dim, img_channels, 3)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(h).reshape(h.shape[0], self.seed, self.seed, self.hidden)
        for stage in range(2):
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = F.elu(getattr(self, f"Conv_{2 * stage}")(x))
            x = F.elu(getattr(self, f"Conv_{2 * stage + 1}")(x))
        return torch.tanh(self.Conv_4(x))


class BEGANEncoder(nn.Module):
    def __init__(self, img_size: int, img_channels: int, hidden_dim: int, latent_dim: int):
        super().__init__()
        h = hidden_dim
        self.Conv_0 = Conv(img_channels, h, 3)
        self.Conv_1 = Conv(h, h, 3, stride=2)
        self.Conv_2 = Conv(h, h, 3)
        self.Conv_3 = Conv(h, 2 * h, 3, stride=2)
        self.Conv_4 = Conv(2 * h, 2 * h, 3)
        side = -(-img_size // 4)  # two stride-2 SAME convs
        self.Dense_0 = Dense(side * side * 2 * h, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(5):
            h = F.elu(getattr(self, f"Conv_{i}")(h))
        return self.Dense_0(h.reshape(h.shape[0], -1))  # NHWC order, as the JAX reshape


class BEGANAutoencoderD(nn.Module):
    def __init__(self, img_size: int, img_channels: int, hidden_dim: int, latent_dim: int):
        super().__init__()
        self.BEGANEncoder_0 = BEGANEncoder(img_size, img_channels, hidden_dim, latent_dim)
        self.BEGANDecoder_0 = BEGANDecoder(latent_dim, img_size, img_channels, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BEGANDecoder_0(self.BEGANEncoder_0(x))


class BEGAN(GAN):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        latent_dim: int = 64,
        hidden_dim: int = 64,
        gamma: float = 0.5,
        lambda_k: float = 1e-3,
        lr: float = 1e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 0.0,
        calculate_metrics: bool = False,
        metrics: Optional[list] = None,
        summary: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.hidden_dim = hidden_dim
        self.gamma = gamma
        self.lambda_k = lambda_k
        super().__init__(img_channels=img_channels, img_size=img_size, latent_dim=latent_dim,
                         lr=lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         calculate_metrics=calculate_metrics, metrics=metrics,
                         summary=summary, device=device)

    def _build_networks(self) -> Tuple[nn.Module, nn.Module]:
        return (BEGANDecoder(self.latent_dim, self.img_size, self.img_channels,
                             self.hidden_dim),
                BEGANAutoencoderD(self.img_size, self.img_channels, self.hidden_dim,
                                  self.latent_dim))

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """The GAN base's, and k_t at 0."""
        super().init_params(generator)
        self.k_t = torch.zeros((), device=self.device)

    def flax_layout(self) -> dict:
        return {**super().flax_layout(), "tensors": {"mutable/k_t": self.k_t}}

    def _ae_loss(self, v: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(self.D(v) - v))

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One D step, one G step through the stepped D, and the k_t update (module
        doc); ``flip`` and ``z`` are drawn from ``generator`` when not given."""
        x = self._x(batch, generator, True, flip)
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        x_hat = self.G(z)
        k_t = self.k_t.clone()
        l_real = self._ae_loss(x)
        l_fake = self._ae_loss(x_hat.detach())
        d_loss = l_real - k_t * l_fake
        self._optimize("D", d_loss, self.D)
        g_loss = self._ae_loss(x_hat)
        self._optimize("G", g_loss, self.G)
        with torch.no_grad():
            # The global batch's balance: the losses' means over the data ranks.
            balance = mesh_lib.data_mean(self.gamma * l_real - g_loss)
            self.k_t.copy_(torch.clamp(k_t + self.lambda_k * balance, 0.0, 1.0))
        self.step += 1
        metrics = {"d_loss": d_loss, "g_loss": g_loss, "l_real": l_real,
                   "k_t": self.k_t.clone(), "convergence": l_real + torch.abs(balance)}
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        x = self._x(batch, None, False, None)
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        l_real = self._ae_loss(x)
        l_fake = self._ae_loss(self.G(z))
        return self.prefix_metrics({
            "d_loss": l_real - self.k_t * l_fake, "g_loss": l_fake,
            "convergence": l_real + torch.abs(self.gamma * l_real - l_fake)}, "val")

    def state_dict(self) -> dict:
        return {**super().state_dict(), "k_t": self.k_t.clone()}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.k_t.copy_(state["k_t"])
