"""The UNet autoencoder: a skip-connection UNet trained on the identity.

Counterpart of ``lightning_generative_models_tpu/models/autoencoder/unet.py``: double 3x3
convs (ReLU) with 2x2 max-pool downsampling, 2x2 stride-2 transposed convs up with the
skip concatenated after the upsampled map (flax's ``[up, skip]`` order), a 1x1 conv with a
tanh, and the mean squared error against the input, under Adam. Its flax names:
``DoubleConv_0`` .. ``DoubleConv_{2 depth}``, ``ConvTranspose_0`` .. and ``Conv_0``.
The model has no prior: ``sample`` raises ``NotImplementedError`` as JAX's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import AdamModel
from lightning_generative_models_tpu_torch.models.modules.layers import Conv, ConvTranspose
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch


class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, 3)
        self.Conv_1 = Conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Conv_1(F.relu(self.Conv_0(x))))


class UNetAENet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, base_features: int = 64,
                 depth: int = 2):
        super().__init__()
        self.depth = depth
        feats, ch, k = base_features, in_channels, 0
        for _ in range(depth):
            self.add_module(f"DoubleConv_{k}", DoubleConv(ch, feats))
            ch, feats, k = feats, feats * 2, k + 1
        self.add_module(f"DoubleConv_{k}", DoubleConv(ch, feats))
        ch, k = feats, k + 1
        for i in range(depth):
            feats //= 2
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(ch, feats, 2, stride=2))
            self.add_module(f"DoubleConv_{k}", DoubleConv(2 * feats, feats))
            ch, k = feats, k + 1
        self.Conv_0 = Conv(ch, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"DoubleConv_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        x = getattr(self, f"DoubleConv_{self.depth}")(x)
        for i in range(self.depth):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = torch.cat([x, skips.pop()], dim=-1)
            x = getattr(self, f"DoubleConv_{self.depth + 1 + i}")(x)
        return torch.tanh(self.Conv_0(x))


class UNetAE(AdamModel):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        base_features: int = 64,
        depth: int = 2,
        lr: float = 1e-4,
        b1: float = 0.9,
        b2: float = 0.999,
        weight_decay: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``."""
        if img_size % (2**depth) != 0:
            raise ValueError(f"img_size {img_size} not divisible by {2 ** depth}")
        super().__init__(img_channels, img_size,
                         UNetAENet(img_channels, img_channels, base_features, depth),
                         lr, b1, b2, weight_decay, device)

    def _x01(self, batch: Dict, generator: Optional[torch.Generator] = None,
             train: bool = False, flip: Optional[torch.Tensor] = None) -> torch.Tensor:
        return prepare_batch(self._to_device(batch), generator, train=train,
                             flip=flip)["image"]

    def _loss(self, x01: torch.Tensor):
        x = self.to_model_space(x01)
        loss = torch.mean((self.net(x) - x) ** 2)
        return loss, {"loss": loss}

    def grad_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  flip: Optional[torch.Tensor] = None):
        """Gradients of the loss on a uint8 batch, flipped by ``flip`` ([B] bool; drawn
        from ``generator`` when None)."""
        return self._grads(*self._loss(self._x01(batch, generator, True, flip)))

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        return self.prefix_metrics(self._loss(self._x01(batch))[1], "val")

    @torch.inference_mode()
    def reconstruct(self, batch: Dict) -> torch.Tensor:
        return self.to_image_space(self.net(self.to_model_space(self._x01(batch))))

    def sample(self, generator: Optional[torch.Generator], num_samples: int):
        raise NotImplementedError("UNet autoencoder has no generative prior")

    def serving_chain(self, batch_size: int, method=None, steps=None, labels=None):
        """No sampler to freeze: what ``sample`` raises."""
        raise NotImplementedError("UNet autoencoder has no generative prior")
