"""PixelCNN: the masked-convolution autoregressive model (van den Oord et al. 2016).

Counterpart of ``lightning_generative_models_tpu/models/autoregressive/pixelcnn.py``: a
type-A 7x7 masked conv, gated residual blocks (tanh * sigmoid over a type-B 7x7 masked
conv), a 1x1 head whose channel ``c * num_levels + l`` holds level l of image channel c,
and the per-pixel cross-entropy over ``num_levels`` levels, under Adam.

The mask multiplies the kernel inside the forward (``kernel * mask``), as JAX's does, so
the masked taps' gradient is exactly 0 and Adam never moves them. Each masked conv keeps
its own kernel and bias (flax's ``MaskedConv_k/{kernel, bias}``), drawn as flax's
``lecun_normal``: a normal truncated at two standard deviations over the fan-in.

``sample`` runs the raster loop with one full forward per pixel. JAX draws each pixel with
``jax.random.categorical``, which is the Gumbel-max pick argmax(logits + g): ``gumbel``
([H W, n, C, L], pixel by pixel in raster order) is passed in, or drawn from the generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import AdamModel
from lightning_generative_models_tpu_torch.models.modules.layers import Conv

_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2] (flax's rescale)


def causal_mask(kh: int, kw: int, mask_type: str) -> torch.Tensor:
    """[kh, kw] mask: 1 for allowed taps. Type A excludes the center pixel."""
    assert mask_type in ("A", "B")
    mask = torch.ones(kh, kw)
    center_h, center_w = kh // 2, kw // 2
    mask[center_h, center_w + (1 if mask_type == "B" else 0):] = 0.0
    mask[center_h + 1:, :] = 0.0
    return mask


class MaskedConv(Conv):
    """A stride-1 "SAME" conv whose OIHW kernel is multiplied by ``causal_mask`` in the
    forward (a buffer outside the checkpoint); the kernel starts from flax's
    ``lecun_normal``, the bias at 0."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, mask_type: str):
        super().__init__(in_ch, out_ch, kernel_size)
        self.register_buffer("mask", causal_mask(kernel_size, kernel_size, mask_type),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.weight[0].numel() ** -0.5 / _TRUNC
        w = torch.empty(self.weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.weight.data.copy_(w)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.float().permute(0, 3, 1, 2), self.weight * self.mask, self.bias,
                     padding=self.kernel_size // 2)
        return y.permute(0, 2, 3, 1)


class GatedBlock(nn.Module):
    """x (projected by a 1x1 ``Conv_0`` when its channels differ) + tanh(t) sigmoid(s),
    where [t, s] is a type-B masked conv of x."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.MaskedConv_0 = MaskedConv(in_ch, 2 * features, 7, "B")
        if in_ch != features:
            self.Conv_0 = Conv(in_ch, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.MaskedConv_0(x)
        if hasattr(self, "Conv_0"):
            x = self.Conv_0(x)
        t, s = out.chunk(2, dim=-1)
        return x + torch.tanh(t) * torch.sigmoid(s)


class PixelCNNNet(nn.Module):
    """[B, H, W, C] in [0, 1] -> logits [B, H, W, C, num_levels]."""

    def __init__(self, hidden_dim: int, num_layers: int, img_channels: int,
                 num_levels: int):
        super().__init__()
        self.img_channels, self.num_levels, self.num_layers = img_channels, num_levels, num_layers
        self.MaskedConv_0 = MaskedConv(img_channels, hidden_dim, 7, "A")
        for i in range(num_layers):
            self.add_module(f"GatedBlock_{i}", GatedBlock(hidden_dim, hidden_dim))
        self.Conv_0 = Conv(hidden_dim, img_channels * num_levels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.MaskedConv_0(x)
        for i in range(self.num_layers):
            h = getattr(self, f"GatedBlock_{i}")(h)
        logits = self.Conv_0(h)
        b, hh, ww, _ = logits.shape
        return logits.reshape(b, hh, ww, self.img_channels, self.num_levels)


class PixelCNN(AdamModel):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        hidden_dim: int = 64,
        num_layers: int = 7,
        num_levels: int = 256,
        lr: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        weight_decay: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``."""
        self.num_levels = num_levels
        super().__init__(img_channels, img_size,
                         PixelCNNNet(hidden_dim, num_layers, img_channels, num_levels),
                         lr, b1, b2, weight_decay, device)

    def _loss(self, images_u8: torch.Tensor):
        """Cross-entropy of the levels ``u8 L // 256`` given the image ``u8 / 255``."""
        u8 = images_u8.to(self.device)
        levels = (u8.long() * self.num_levels) // 256
        logits = self.net(u8.float() / 255.0)
        loss = F.cross_entropy(logits.reshape(-1, self.num_levels), levels.reshape(-1))
        return loss, {"loss": loss, "bits_per_dim": loss / np.log(2.0)}

    def grad_step(self, batch: Dict, generator: Optional[torch.Generator] = None):
        """Gradients of the loss on a uint8 batch (no draw)."""
        return self._grads(*self._loss(torch.as_tensor(batch["image"])))

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        return self.prefix_metrics(self._loss(torch.as_tensor(batch["image"]))[1], "val")

    def pixel_logits(self, images: torch.Tensor, idx: int) -> torch.Tensor:
        """One full forward of ``images``: the logits [n, C, L] of raster pixel ``idx``."""
        return self.net(images)[:, idx // self.img_size, idx % self.img_size]

    def set_pixel(self, images: torch.Tensor, idx: int, levels: torch.Tensor) -> None:
        """In place: raster pixel ``idx`` of ``images`` to the level centres
        (levels + 0.5) / L ([n, C] integer levels)."""
        images[:, idx // self.img_size, idx % self.img_size] = (
            (levels.float() + 0.5) / self.num_levels)

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raster-order ancestral sampling, one full forward per pixel; pixel idx takes
        argmax(logits + gumbel[idx]), with gumbel[idx] ([n, C, L]) drawn as
        -log(-log(u)) from ``generator`` when ``gumbel`` is None."""
        h = w = self.img_size
        images = torch.zeros((num_samples, h, w, self.img_channels), device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        for idx in range(h * w):
            logits = self.pixel_logits(images, idx)
            if gumbel is None:
                u = torch.rand(logits.shape, generator=generator, device=self.device)
                g = -torch.log(-torch.log(u.clamp_min(tiny)))
            else:
                g = gumbel[idx].to(self.device)
            self.set_pixel(images, idx, torch.argmax(logits + g, dim=-1))
        return torch.clamp(images, 0.0, 1.0)
