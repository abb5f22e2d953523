"""NICE: non-linear independent components estimation (Dinh et al. 2015).

Counterpart of ``lightning_generative_models_tpu/models/flow/nice.py``: additive coupling
layers with MLP transformations (LeakyReLU 0.2) whose partitions alternate, the odd
layers' net output cut to the first half, then a diagonal scaling ``exp(log_scale)``
(a raw parameter) under a standard-normal prior; the negative log-likelihood in nats and
bits/dim with the +8 dequantisation correction, under Adam. flax's names:
``nets_{i}/Dense_{j}`` and ``log_scale``.

Inputs are flattened in NHWC order, as JAX reshapes them. ``_flatten`` takes any input as
0-255 values (uint8 or float) and dequantises it to (x + u) / 256, as JAX's does: Glow
takes float input as [0, 1] instead (the two flows' ranges differ in the reference too).
The uniform ``u`` of a train step is passed in or drawn from the generator; evaluation and
the log-likelihood use u = 0.5.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import AdamModel
from lightning_generative_models_tpu_torch.models.modules.layers import Dense

LOG_2PI = float(np.log(2 * np.pi))


class CouplingNet(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, num_hidden_layers: int):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        widths = (in_dim, *([hidden_dim] * num_hidden_layers), out_dim)
        for j in range(num_hidden_layers + 1):
            self.add_module(f"Dense_{j}", Dense(widths[j], widths[j + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for j in range(self.num_hidden_layers):
            h = F.leaky_relu(getattr(self, f"Dense_{j}")(h), 0.2)
        return getattr(self, f"Dense_{self.num_hidden_layers}")(h)


class NICENet(nn.Module):
    """forward: x [B, dim] -> (z [B, dim], log|det J|, a scalar); ``inverse`` exactly."""

    def __init__(self, dim: int, hidden_dim: int, num_coupling_layers: int,
                 num_hidden_layers: int):
        super().__init__()
        self.dim, self.half, self.num_coupling_layers = dim, dim // 2, num_coupling_layers
        for i in range(num_coupling_layers):
            in_dim = self.half if i % 2 == 0 else dim - self.half
            self.add_module(f"nets_{i}", CouplingNet(in_dim, dim - self.half, hidden_dim,
                                                     num_hidden_layers))
        self.log_scale = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.log_scale.data.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x1, x2 = x[:, :self.half], x[:, self.half:]
        for i in range(self.num_coupling_layers):
            net = getattr(self, f"nets_{i}")
            if i % 2 == 0:
                x2 = x2 + net(x1)
            else:
                x1 = x1 + net(x2)[:, :self.half]
        z = torch.cat([x1, x2], dim=1) * torch.exp(self.log_scale)
        return z, torch.sum(self.log_scale)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        x = z * torch.exp(-self.log_scale)
        x1, x2 = x[:, :self.half], x[:, self.half:]
        for i in reversed(range(self.num_coupling_layers)):
            net = getattr(self, f"nets_{i}")
            if i % 2 == 0:
                x2 = x2 - net(x1)
            else:
                x1 = x1 - net(x2)[:, :self.half]
        return torch.cat([x1, x2], dim=1)


class NICE(AdamModel):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        hidden_dim: int = 1000,
        num_coupling_layers: int = 4,
        num_hidden_layers: int = 5,
        lr: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        weight_decay: float = 0.0,
        dequantize: bool = True,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``."""
        self.dim = img_size * img_size * img_channels
        self.dequantize = dequantize
        super().__init__(img_channels, img_size,
                         NICENet(self.dim, hidden_dim, num_coupling_layers, num_hidden_layers),
                         lr, b1, b2, weight_decay, device)

    def _flatten(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                 uniform: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """0-255 images [B, H, W, C] -> (x + u) / 256 flattened in NHWC order; u is
        ``uniform`` (the images' shape, drawn from ``generator`` when None) at train time
        with ``dequantize``, else 0.5."""
        x = torch.as_tensor(images).to(self.device).float()
        if self.dequantize and train:
            if uniform is None:
                uniform = torch.rand(x.shape, generator=generator, device=self.device)
            x = x + uniform.to(self.device).reshape(x.shape)
        else:
            x = x + 0.5
        x = x / 256.0
        return x.reshape(x.shape[0], -1)

    def _log_prob(self, x_flat: torch.Tensor) -> torch.Tensor:
        z, log_det = self.net(x_flat)
        return torch.sum(-0.5 * z**2 - 0.5 * LOG_2PI, dim=1) + log_det

    def _nll(self, x_flat: torch.Tensor):
        nll = -torch.mean(self._log_prob(x_flat))
        bits_per_dim = nll / (self.dim * np.log(2.0)) + 8.0  # dequantisation correction
        return nll, {"loss": nll, "bits_per_dim": bits_per_dim}

    def grad_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None):
        """Gradients of the NLL on a uint8 batch dequantised by ``uniform``."""
        return self._grads(*self._nll(self._flatten(batch["image"], generator, uniform,
                                                    train=True)))

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        return self.prefix_metrics(self._nll(self._flatten(batch["image"]))[1], "val")

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The inverse of ``z`` [n, dim] (drawn from ``generator`` when None), clipped to
        [0, 1], as images."""
        if z is None:
            z = torch.randn((num_samples, self.dim), generator=generator, device=self.device)
        x = torch.clamp(self.net.inverse(z.to(self.device)), 0.0, 1.0)
        return x.reshape(num_samples, *self.image_shape())

    @torch.inference_mode()
    def log_likelihood(self, batch: Dict) -> torch.Tensor:
        """Per-sample log-likelihood in nats (continuous, dequantised at u = 0.5)."""
        return self._log_prob(self._flatten(batch["image"]))
