"""CycleGAN (Zhu et al. 2017): unpaired image-to-image translation.

Counterpart of ``lightning_generative_models_tpu/models/gan/cyclegan.py``, NHWC and f32:

- two ``ResnetGenerator``s (G_AB, G_BA): a reflect-padded 7x7 stem, two stride-2 3x3
  "SAME" convs, residual blocks of two reflect-padded 3x3 convs, two stride-2 3x3 "SAME"
  transposed convs, a reflect-padded 7x7 conv and tanh; InstanceNorm and LeakyReLU(0.2)
  after every conv but the last;
- two ``PatchDiscriminator``s (D_A, D_B): 4x4 "SAME" convs 64 (stride 2), 128, 256
  (stride 2), 512 (stride 1: lax pads 1 low and 2 high) with InstanceNorm on all but the
  first, and a 4x4 conv to one logit per patch;
- InstanceNorm is flax's ``GroupNorm(group_size=1)`` (``layers.GroupNorm`` with a group
  per channel): eps 1e-6, the biased E[x^2] - E[x]^2 variance, a learnable scale and bias
  (not torch's ``InstanceNorm2d``, eps 1e-5 and no affine by default);
- reflect padding is numpy's "reflect" (the edge not repeated) before a VALID conv.

The step runs G first, then D, the reverse of the GAN base: G's loss (adversarial BCE
through the old D, identity L1 as G_AB(B) ~ B and G_BA(A) ~ A, and cycle L1) steps the
generators' Adam, its gradient into D dropped; then D steps on that pass's detached fakes.
``sample`` raises: the model translates images (``translate``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import bce_with_logits
from lightning_generative_models_tpu_torch.models.gan.gan import AdversarialModel
from lightning_generative_models_tpu_torch.models.modules.layers import (
    Conv,
    ConvTranspose,
    GroupNorm,
)
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.train.state import make_adam


def instance_norm(channels: int) -> GroupNorm:
    return GroupNorm(channels, channels, eps=1e-6)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the two spatial axes of an NHWC tensor by ``pad``."""
    return F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect").permute(0, 2, 3, 1)


class ResnetGenBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = Conv(features, features, 3, padding="VALID")
        self.GroupNorm_0 = instance_norm(features)
        self.Conv_1 = Conv(features, features, 3, padding="VALID")
        self.GroupNorm_1 = instance_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.GroupNorm_0(self.Conv_0(reflect_pad(x, 1))), 0.2)
        return x + self.GroupNorm_1(self.Conv_1(reflect_pad(h, 1)))


class ResnetGenerator(nn.Module):
    """Submodules carry flax's names: Conv_0 (stem), Conv_1-2 (down), ResnetGenBlock_i,
    ConvTranspose_0-1 (up), Conv_3 (head); GroupNorm_0-4 in call order."""

    def __init__(self, in_channels: int, out_channels: int, base_features: int = 64,
                 num_downsamples: int = 2, num_residual_blocks: int = 6):
        super().__init__()
        self.num_downsamples, self.num_blocks = num_downsamples, num_residual_blocks
        feats = base_features
        self.Conv_0 = Conv(in_channels, feats, 7, padding="VALID")
        norms = [instance_norm(feats)]
        for i in range(num_downsamples):
            self.add_module(f"Conv_{i + 1}", Conv(feats, 2 * feats, 3, stride=2))
            feats *= 2
            norms.append(instance_norm(feats))
        for i in range(num_residual_blocks):
            self.add_module(f"ResnetGenBlock_{i}", ResnetGenBlock(feats))
        for i in range(num_downsamples):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(feats, feats // 2, 3, stride=2))
            feats //= 2
            norms.append(instance_norm(feats))
        for i, norm in enumerate(norms):
            self.add_module(f"GroupNorm_{i}", norm)
        self.add_module(f"Conv_{num_downsamples + 1}",
                        Conv(feats, out_channels, 7, padding="VALID"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def block(h, i):
            return F.leaky_relu(getattr(self, f"GroupNorm_{i}")(h), 0.2)

        n = self.num_downsamples
        h = block(self.Conv_0(reflect_pad(x, 3)), 0)
        for i in range(n):
            h = block(getattr(self, f"Conv_{i + 1}")(h), i + 1)
        for i in range(self.num_blocks):
            h = getattr(self, f"ResnetGenBlock_{i}")(h)
        for i in range(n):
            h = block(getattr(self, f"ConvTranspose_{i}")(h), n + 1 + i)
        return torch.tanh(getattr(self, f"Conv_{n + 1}")(reflect_pad(h, 3)))


class PatchDiscriminator(nn.Module):
    """Images [B, H, W, C] -> patch logits [B, H/8, W/8]."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 64, 4, stride=2)
        prev = 64
        for i, (feats, stride) in enumerate(((128, 2), (256, 2), (512, 1))):
            self.add_module(f"Conv_{i + 1}", Conv(prev, feats, 4, stride=stride))
            self.add_module(f"GroupNorm_{i}", instance_norm(feats))
            prev = feats
        self.Conv_4 = Conv(prev, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Conv_0(x), 0.2)
        for i in range(3):
            h = F.leaky_relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i + 1}")(h)),
                             0.2)
        return self.Conv_4(h)[..., 0]


class CycleGAN(AdversarialModel):
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        img_size: int = 64,
        lambda_identity: float = 0.5,
        lambda_cycle: float = 10.0,
        lr: float = 2e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 0.0,
        num_residual_blocks: int = 6,
        img_channels: Optional[int] = None,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments (``img_channels`` sets both channel counts),
        plus ``device``. The weights start from ``init_params`` with seed 0."""
        if img_channels is not None:
            in_channels = out_channels = img_channels
        super().__init__(in_channels, img_size)
        self.device = resolve_device(device)
        self.lambda_identity = lambda_identity
        self.lambda_cycle = lambda_cycle
        self.lr, self.betas, self.weight_decay = lr, (b1, b2), weight_decay
        self.G_AB = ResnetGenerator(in_channels, out_channels,
                                    num_residual_blocks=num_residual_blocks)
        self.G_BA = ResnetGenerator(out_channels, in_channels,
                                    num_residual_blocks=num_residual_blocks)
        self.D_A = PatchDiscriminator(in_channels)
        self.D_B = PatchDiscriminator(out_channels)
        self.init_params()

    def nets(self) -> Dict[str, nn.Module]:
        return {"G_AB": self.G_AB, "G_BA": self.G_BA, "D_A": self.D_A, "D_B": self.D_B}

    def _build_optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        """One Adam over both generators, one over both discriminators."""
        return {name: make_adam([*a.parameters(), *b.parameters()], self.lr, *self.betas,
                                weight_decay=self.weight_decay)
                for name, (a, b) in (("G", (self.G_AB, self.G_BA)),
                                     ("D", (self.D_A, self.D_B)))}

    def flax_layout(self) -> dict:
        trees = {"G": {"AB": self.G_AB, "BA": self.G_BA}, "D": {"A": self.D_A, "B": self.D_B}}
        return {
            "params": {f"params/{k}/{sub}": net for k, nets in trees.items()
                       for sub, net in nets.items()},
            "adam": {f"opt_state/{k}": (self.optimizers[k], nets) for k, nets in trees.items()},
        }

    # -- losses ----------------------------------------------------------------------
    def _x(self, images, flip: Optional[torch.Tensor], generator: Optional[torch.Generator],
           train: bool) -> torch.Tensor:
        batch = {"image": torch.as_tensor(images).to(self.device, non_blocking=True)}
        return self.to_model_space(
            prepare_batch(batch, generator, train=train, flip=flip)["image"])

    def _g_loss(self, real_a: torch.Tensor, real_b: torch.Tensor):
        fake_b, fake_a = self.G_AB(real_a), self.G_BA(real_b)
        cycled_a, cycled_b = self.G_BA(fake_b), self.G_AB(fake_a)
        logits_a, logits_b = self.D_A(fake_a), self.D_B(fake_b)
        adv_loss = (bce_with_logits(logits_a, torch.ones_like(logits_a))
                    + bce_with_logits(logits_b, torch.ones_like(logits_b)))
        identity_loss = (torch.mean(torch.abs(self.G_AB(real_b) - real_b))
                         + torch.mean(torch.abs(self.G_BA(real_a) - real_a)))
        cycle_loss = (torch.mean(torch.abs(cycled_a - real_a))
                      + torch.mean(torch.abs(cycled_b - real_b)))
        g_loss = (adv_loss + identity_loss * self.lambda_identity
                  + cycle_loss * self.lambda_cycle)
        metrics = {"adv_loss": adv_loss, "identity_loss": identity_loss,
                   "cycle_loss": cycle_loss, "g_loss": g_loss}
        return g_loss, metrics, fake_a, fake_b

    def _d_loss(self, real_a, real_b, fake_a, fake_b):
        def single(d, real, fake):
            logits_real, logits_fake = d(real), d(fake)
            return (bce_with_logits(logits_real, torch.ones_like(logits_real))
                    + bce_with_logits(logits_fake, torch.zeros_like(logits_fake))) / 2

        d_loss_a = single(self.D_A, real_a, fake_a)
        d_loss_b = single(self.D_B, real_b, fake_b)
        d_loss = d_loss_a + d_loss_b
        return d_loss, {"d_loss": d_loss, "d_loss_A": d_loss_a, "d_loss_B": d_loss_b}

    # -- steps -----------------------------------------------------------------------
    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip_a: Optional[torch.Tensor] = None,
                   flip_b: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """G's step, then D's on G's detached fakes (module doc), on the uint8 batches
        ``image_A`` and ``image_B``, flipped by ``flip_a`` / ``flip_b`` [B] bool (drawn
        from ``generator`` when not given)."""
        real_a = self._x(batch["image_A"], flip_a, generator, True)
        real_b = self._x(batch["image_B"], flip_b, generator, True)
        g_loss, g_metrics, fake_a, fake_b = self._g_loss(real_a, real_b)
        self._optimize("G", g_loss, self.G_AB, self.G_BA)
        d_loss, d_metrics = self._d_loss(real_a, real_b, fake_a.detach(), fake_b.detach())
        self._optimize("D", d_loss, self.D_A, self.D_B)
        self.step += 1
        metrics = {**g_metrics, **d_metrics}
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        real_a = self._x(batch["image_A"], None, None, False)
        real_b = self._x(batch["image_B"], None, None, False)
        _, g_metrics, fake_a, fake_b = self._g_loss(real_a, real_b)
        _, d_metrics = self._d_loss(real_a, real_b, fake_a, fake_b)
        return self.prefix_metrics({**g_metrics, **d_metrics}, "val")

    @torch.inference_mode()
    def translate(self, images01: torch.Tensor, direction: str = "AB") -> torch.Tensor:
        """Images [N, H, W, C] in [0, 1] of domain A ("AB") or B ("BA") -> the other
        domain's, in [0, 1]."""
        net = self.G_AB if direction == "AB" else self.G_BA
        return self.to_image_space(net(self.to_model_space(images01.to(self.device).float())))

    def sample(self, generator: Optional[torch.Generator], num_samples: int) -> torch.Tensor:
        raise NotImplementedError("CycleGAN translates images; use translate()")

    def serving_chain(self, batch_size: int, method=None, steps=None, labels=None):
        """No sampler to freeze: what ``sample`` raises."""
        raise NotImplementedError("CycleGAN translates images; use translate()")
