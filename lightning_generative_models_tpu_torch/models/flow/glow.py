"""Glow: generative flow with invertible 1x1 convolutions (Kingma & Dhariwal 2018).

Counterpart of ``lightning_generative_models_tpu/models/flow/glow.py``: a multi-scale flow,
(squeeze -> depth x [actnorm -> invertible 1x1 conv -> affine coupling] -> split) over
``levels`` levels, trained by exact maximum likelihood under a standard-normal prior,
under Adam. Everything is NHWC; squeeze and unsqueeze keep JAX's channel order.

- ActNorm: y = (x + bias) exp(log_scale), both zero at init, log|det| H W sum(log_scale).
- Inv1x1Conv: y = x @ w with w [c, d] as flax keeps it (no transform on carry),
  orthogonal at init; log|det| = H W log|det w| by ``torch.linalg.slogdet`` (the sign is
  discarded, as JAX does), the inverse by ``torch.linalg.inv_ex`` (no error check, so no
  host sync: JAX checks neither). ``GlowNet`` takes a level's log-dets in one batched
  ``slogdet`` of its stacked weights and hands each step its own: the same per-matrix math
  as JAX's one call a step, with fewer launches (PERF.md, Findings).
- AffineCoupling: [t, raw_s] = net(x_a), s = sigmoid(raw_s + 2), y_b = (x_b + t) s; the
  coupling net's last 3x3 conv starts at zero, so the flow starts as an identity up to the
  actnorms and the 1x1 convs.
- The latents are flattened into one [B, H W C] vector in JAX's order: each level's
  split-off half (the first half of the channels) in NHWC, then the last level.

flax's paths: ``steps_{level}_{step}/{actnorm/{log_scale, bias}, inv_conv/w,
coupling/net/Conv_{0,1,2}}``. Batches arrive as uint8 (divided by 255) or as floats taken
as [0, 1], then are dequantised onto the 1/256 grid and centred to [-0.5, 0.5]; NICE takes
floats as 0-255 (the reference's two flows differ so too). bits/dim carries the +8
correction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import AdamModel
from lightning_generative_models_tpu_torch.models.modules.layers import Conv

LOG_2PI = float(np.log(2 * np.pi))


def squeeze2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C] space-to-depth, JAX's channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def unsqueeze2x2(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`squeeze2x2`."""
    b, h, w, c4 = x.shape
    x = x.reshape(b, h, w, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c4 // 4)


class ActNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.log_scale.data.zero_()
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, h, w, _ = x.shape
        return (x + self.bias) * torch.exp(self.log_scale), h * w * torch.sum(self.log_scale)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.exp(-self.log_scale) - self.bias


class Inv1x1Conv(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(channels, channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``orthogonal``: Q of the QR of a normal draw, its columns signed by R's
        diagonal."""
        q, r = torch.linalg.qr(torch.empty(self.w.shape).normal_(generator=generator))
        self.w.data.copy_(q * torch.sign(torch.diagonal(r)))

    def forward(self, x: torch.Tensor, logabsdet: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x @ w, H W log|det w|), given log|det w| (``GlowNet`` takes a level's at once)."""
        _, h, w, _ = x.shape
        return x @ self.w, h * w * logabsdet

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y @ torch.linalg.inv_ex(self.w).inverse


class CouplingNet(nn.Module):
    """Conv3x3 -> ReLU -> Conv1x1 -> ReLU -> a zero-initialised Conv3x3."""

    def __init__(self, in_ch: int, width: int, out_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in_ch, width, 3)
        self.Conv_1 = Conv(width, width, 1)
        self.Conv_2 = Conv(width, out_channels, 3, zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_2(F.relu(self.Conv_1(F.relu(self.Conv_0(x)))))


class AffineCoupling(nn.Module):
    def __init__(self, channels: int, width: int):
        super().__init__()
        self.ca = channels // 2
        self.net = CouplingNet(self.ca, width, 2 * (channels - self.ca))

    def _scale_shift(self, xa: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t, raw_s = self.net(xa).chunk(2, dim=-1)
        return torch.sigmoid(raw_s + 2.0), t

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        xa, xb = x[..., :self.ca], x[..., self.ca:]
        s, t = self._scale_shift(xa)
        log_det = torch.sum(torch.log(s), dim=(1, 2, 3))
        return torch.cat([xa, (xb + t) * s], dim=-1), log_det

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        ya, yb = y[..., :self.ca], y[..., self.ca:]
        s, t = self._scale_shift(ya)
        return torch.cat([ya, yb / s - t], dim=-1)


class FlowStep(nn.Module):
    """actnorm -> invertible 1x1 conv -> affine coupling."""

    def __init__(self, channels: int, width: int):
        super().__init__()
        self.actnorm = ActNorm(channels)
        self.inv_conv = Inv1x1Conv(channels)
        self.coupling = AffineCoupling(channels, width)

    def forward(self, x: torch.Tensor, logabsdet: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``logabsdet``: log|det| of the 1x1 conv's weight."""
        x, ld1 = self.actnorm(x)
        x, ld2 = self.inv_conv(x, logabsdet)
        x, ld3 = self.coupling(x)
        return x, ld1 + ld2 + ld3

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return self.actnorm.inverse(self.inv_conv.inverse(self.coupling.inverse(y)))


def _level_channels(img_channels: int, levels: int) -> List[int]:
    """Channel count after the squeeze at each level."""
    out, c = [], img_channels
    for _ in range(levels):
        c *= 4
        out.append(c)
        c //= 2  # the split keeps half (ignored for the last level)
    return out


class GlowNet(nn.Module):
    """The multi-scale flow: forward x [B, H, W, C] -> (z [B, H W C], log|det J| [B])."""

    def __init__(self, img_size: int, img_channels: int, levels: int, depth: int,
                 width: int):
        super().__init__()
        self.img_size, self.img_channels = img_size, img_channels
        self.levels, self.depth = levels, depth
        for lvl, c in enumerate(_level_channels(img_channels, levels)):
            for k in range(depth):
                self.add_module(f"steps_{lvl}_{k}", FlowStep(c, width))

    def level(self, lvl: int) -> List[FlowStep]:
        return [getattr(self, f"steps_{lvl}_{k}") for k in range(self.depth)]

    def latent_shapes(self) -> List[Tuple[int, int, int]]:
        """[H, W, C] of each factored-out latent, in flatten order."""
        shapes, s, c = [], self.img_size, self.img_channels
        for lvl in range(self.levels):
            s, c = s // 2, c * 4
            if lvl < self.levels - 1:
                shapes.append((s, s, c // 2))
                c //= 2
            else:
                shapes.append((s, s, c))
        return shapes

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        h, zs = x, []
        log_det = torch.zeros((b,), dtype=x.dtype, device=x.device)
        for lvl in range(self.levels):
            h = squeeze2x2(h)
            steps = self.level(lvl)
            lads = torch.linalg.slogdet(torch.stack([s.inv_conv.w for s in steps])
                                        ).logabsdet.unbind()
            for step, lad in zip(steps, lads):
                h, ld = step(h, lad)
                log_det = log_det + ld
            if lvl < self.levels - 1:
                z, h = h.chunk(2, dim=-1)
                zs.append(z.reshape(b, -1))
        zs.append(h.reshape(b, -1))
        return torch.cat(zs, dim=1), log_det

    def inverse(self, z_flat: torch.Tensor) -> torch.Tensor:
        b = z_flat.shape[0]
        shapes = self.latent_shapes()
        offsets = np.cumsum([0] + [int(np.prod(s)) for s in shapes])
        zs = [z_flat[:, offsets[i]:offsets[i + 1]].reshape(b, *shapes[i])
              for i in range(self.levels)]
        h = zs[-1]
        for lvl in reversed(range(self.levels)):
            if lvl < self.levels - 1:
                h = torch.cat([zs[lvl], h], dim=-1)
            for step in reversed(self.level(lvl)):
                h = step.inverse(h)
            h = unsqueeze2x2(h)
        return h


class Glow(AdamModel):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 32,
        levels: int = 3,
        depth: int = 8,
        width: int = 256,
        lr: float = 1e-4,
        b1: float = 0.9,
        b2: float = 0.999,
        weight_decay: float = 0.0,
        sample_temperature: float = 1.0,
        dequantize: bool = True,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``."""
        if img_size % (2**levels) != 0:
            raise ValueError(
                f"img_size={img_size} must be divisible by 2^levels={2**levels}"
            )
        self.dim = img_size * img_size * img_channels
        self.dequantize = dequantize
        self.sample_temperature = sample_temperature
        super().__init__(img_channels, img_size,
                         GlowNet(img_size, img_channels, levels, depth, width),
                         lr, b1, b2, weight_decay, device)

    def summary_spec(self) -> dict:
        """The flow's per-layer table (JAX ``glow.py:summary_spec``)."""
        return {"glow": (self.net, (torch.zeros((1, *self.image_shape())),), {})}

    def _prepare(self, images, generator: Optional[torch.Generator] = None,
                 uniform: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """uint8 (or [0, 1] float) images -> (x01 255 + u) / 256 - 0.5; u is ``uniform``
        (drawn from ``generator`` when None) at train time with ``dequantize``, else 0.5."""
        images = torch.as_tensor(images).to(self.device)
        x01 = images.float() / 255.0 if images.dtype == torch.uint8 else images.float()
        if self.dequantize and train:
            if uniform is None:
                uniform = torch.rand(x01.shape, generator=generator, device=self.device)
            u = uniform.to(self.device)
        else:
            u = 0.5
        return (x01 * 255.0 + u) / 256.0 - 0.5

    def _log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z, log_det = self.net(x)
        return torch.sum(-0.5 * z**2 - 0.5 * LOG_2PI, dim=1) + log_det

    def _nll(self, x: torch.Tensor):
        nll = -torch.mean(self._log_prob(x))
        bits_per_dim = nll / (self.dim * np.log(2.0)) + 8.0
        return nll, {"loss": nll, "bits_per_dim": bits_per_dim}

    def grad_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None):
        """Gradients of the NLL on a batch dequantised by ``uniform`` (the images' shape)."""
        return self._grads(*self._nll(self._prepare(batch["image"], generator, uniform,
                                                    train=True)))

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        return self.prefix_metrics(self._nll(self._prepare(batch["image"]))[1], "val")

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The inverse of ``sample_temperature`` z, z [n, dim] a standard normal draw
        (from ``generator`` when None), plus 0.5, clipped to [0, 1]."""
        if z is None:
            z = torch.randn((num_samples, self.dim), generator=generator, device=self.device)
        x = self.net.inverse(z.to(self.device) * self.sample_temperature)
        return torch.clamp(x + 0.5, 0.0, 1.0)

    @torch.inference_mode()
    def log_likelihood(self, batch: Dict) -> torch.Tensor:
        """Per-sample log-likelihood in nats (continuous, dequantised at u = 0.5)."""
        return self._log_prob(self._prepare(batch["image"]))
