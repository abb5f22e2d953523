"""GAN (Goodfellow et al. 2014): an MLP generator and discriminator, and the base class of
the conv GANs.

Counterpart of ``lightning_generative_models_tpu/models/gan/gan.py``: G = latent -> 256 ->
512 -> 1024 -> image, each hidden layer Dense + BatchNorm + LeakyReLU(0.2), a tanh head;
D = image -> 512 -> 256 -> 1 with LeakyReLU(0.2); BCE-with-logits losses, the generator's
"non-saturating" or "min-max"; two Adams with L2 weight decay, D stepped before G.

The JAX step (``gan.py:201-249``) runs G on z in train mode for the fake batch, then:
- the D phase: D in train mode on the real batch, then on the fake one with no gradient
  into G; D's batch statistics move twice, then D's Adam steps;
- the G phase: G runs again on the same z inside G's gradient, from the same weights and
  the same old batch statistics, and D, already stepped, in train mode on its output from
  the statistics the D phase left (a third move); the gradient into D's weights is
  discarded; G's Adam steps.
Both G passes compute the same fake batch and statistics, and only the second's are kept,
so G's statistics move once a step. This port runs G once: the D phase takes the fake
batch detached and the G phase backpropagates through the same tensor. That is the JAX
step with one G forward fewer; running G twice in train mode here would move its
statistics twice and the eval-mode generator would drift.

The model owns its modules (``G``, ``D``), the two optimizers and the step counter. Every
random draw takes an explicit ``torch.Generator``, or is handed in (``z``, ``flip``), so a
test can give both frameworks the same draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import GenerativeModel, bce_with_logits
from lightning_generative_models_tpu_torch.models.modules.layers import (
    BatchNorm,
    Dense,
    init_params,
)
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.train.state import (
    apply_grads,
    count_params,
    make_adam,
)
from lightning_generative_models_tpu_torch.weights import load_flax_train_state


class MLPGenerator(nn.Module):
    """z [B, latent] -> images [B, H, W, C] in [-1, 1]; submodules carry flax's names."""

    def __init__(self, latent_dim: int, img_shape: Tuple[int, int, int]):
        super().__init__()
        self.img_shape = img_shape
        prev = latent_dim
        for i, width in enumerate((256, 512, 1024)):
            self.add_module(f"Dense_{i}", Dense(prev, width))
            self.add_module(f"BatchNorm_{i}", BatchNorm(width))
            prev = width
        self.Dense_3 = Dense(prev, int(np.prod(img_shape)))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for i in range(3):
            h = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(h))
            h = F.leaky_relu(h, 0.2)
        return torch.tanh(self.Dense_3(h)).reshape(h.shape[0], *self.img_shape)


class MLPDiscriminator(nn.Module):
    """Images [B, H, W, C] -> logits [B]."""

    def __init__(self, in_features: int):
        super().__init__()
        self.Dense_0 = Dense(in_features, 512)
        self.Dense_1 = Dense(512, 256)
        self.Dense_2 = Dense(256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Dense_0(x.reshape(x.shape[0], -1)), 0.2)
        h = F.leaky_relu(self.Dense_1(h), 0.2)
        return self.Dense_2(h)[:, 0]


class AdversarialModel(GenerativeModel):
    """What the adversarial models share: named nets (``nets()``) drawn in turn by
    ``init_params``, an optimizer per phase (``_build_optimizers``), one optimizer step
    per phase, and a checkpoint of every net and optimizer. Subclasses set ``device``,
    ``lr``, ``betas`` and ``weight_decay`` and build their nets before ``init_params``."""

    monitor = "val_g_loss"  # GANs log no val_loss
    supports_grad_accum = False  # optimizers stepped in turn

    def nets(self) -> Dict[str, nn.Module]:
        """{name: module}: the checkpoint's names of the nets, in drawing order."""
        raise NotImplementedError

    def _build_optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        """One Adam a net, with the model's settings."""
        return {name: make_adam(list(net.parameters()), self.lr, *self.betas,
                                weight_decay=self.weight_decay)
                for name, net in self.nets().items()}

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw each net's weights in turn from the CPU ``generator`` (seed 0 when
        omitted), reset the batch statistics, and start the optimizers fresh at step 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for net in self.nets().values():
            init_params(net, generator)
            net.to(self.device)
        self.optimizers = self._build_optimizers()
        self.step = 0

    def param_counts(self) -> Dict[str, int]:
        return {name: count_params(net) for name, net in self.nets().items()}

    def load_flax_weights(self, tree) -> None:
        """``generate --weights``: a flattened JAX ``TrainState`` (its ``params`` and the
        batch statistics in ``mutable``; the optimizers' states are not read)."""
        load_flax_train_state(self, tree, optimizers=False)

    def _optimize(self, name: str, loss: torch.Tensor, *nets: nn.Module) -> None:
        """One step of optimizer ``name`` on the weights of ``nets`` down ``loss``'s
        gradient (a weight that ``loss`` does not reach gets a zero gradient, as under
        jax.grad)."""
        params = [p for net in nets for p in net.parameters()]
        apply_grads(self.optimizers[name], params,
                    torch.autograd.grad(loss, params, allow_unused=True))

    def state_dict(self) -> dict:
        """Each net's weights and batch statistics, each optimizer's state, the step."""
        return {**{name: net.state_dict() for name, net in self.nets().items()},
                **{f"optimizer_{name}": opt.state_dict()
                   for name, opt in self.optimizers.items()}, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        for name, net in self.nets().items():
            net.load_state_dict(state[name])
        for name, opt in self.optimizers.items():
            opt.load_state_dict(state[f"optimizer_{name}"])
        self.step = int(state["step"])


class GAN(AdversarialModel):
    def __init__(
        self,
        img_channels: int = 1,
        img_size: int = 28,
        latent_dim: int = 100,
        lr: float = 1e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
        loss_type: str = "non-saturating",
        calculate_metrics: bool = False,
        metrics: Optional[list] = None,
        summary: bool = True,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``. ``summary`` (the per-layer
        tables) is accepted and not printed; ``calculate_metrics`` has the trainer's
        validation and test passes compute the ``metrics`` named ("fid", "kid", "is")
        on the card's InceptionV3. The weights start from ``init_params`` with seed 0."""
        super().__init__(img_channels, img_size)
        if loss_type not in ("min-max", "non-saturating"):
            raise ValueError(f"loss_type is 'min-max' or 'non-saturating', got {loss_type!r}")
        self.calculate_metrics = calculate_metrics
        self.metrics = list(metrics or [])
        self.device = resolve_device(device)
        self.latent_dim = latent_dim
        self.loss_type = loss_type
        self.lr, self.betas, self.weight_decay = lr, (b1, b2), weight_decay
        self.G, self.D = self._build_networks()
        self.init_params()

    def nets(self) -> Dict[str, nn.Module]:
        return {"G": self.G, "D": self.D}

    def _build_networks(self) -> Tuple[nn.Module, nn.Module]:
        shape = self.image_shape()
        return MLPGenerator(self.latent_dim, shape), MLPDiscriminator(int(np.prod(shape)))

    def flax_layout(self) -> dict:
        nets = self.nets()
        return {
            "params": {f"params/{k}": net for k, net in nets.items()},
            "buffers": {f"mutable/{k}/batch_stats": net for k, net in nets.items()
                        if any(True for _ in net.buffers())},
            "adam": {f"opt_state/{k}": (self.optimizers[k], {"": net})
                     for k, net in nets.items()},
        }

    # -- forward -------------------------------------------------------------------
    def _x(self, batch: Dict, generator: Optional[torch.Generator], train: bool,
           flip: Optional[torch.Tensor]) -> torch.Tensor:
        """A uint8 batch on the model's device in model space, [-1, 1]."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        return self.to_model_space(
            prepare_batch(batch, generator, train=train, flip=flip)["image"])

    def sample_z(self, generator: Optional[torch.Generator], n: int) -> torch.Tensor:
        return torch.randn(n, self.latent_dim, generator=generator, device=self.device)

    def summary_spec(self) -> dict:
        """G's and D's per-layer tables (JAX ``gan.py:summary_spec``), in eval mode."""
        return {"G": (self.G, (torch.zeros((1, self.latent_dim)),), {}),
                "D": (self.D, (torch.zeros((1, *self.image_shape())),), {})}

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """D's real/fake logits [B]."""
        return self.D(x)

    def _d_loss(self, x: torch.Tensor, x_hat: torch.Tensor):
        logits_real = self._logits(x)
        logits_fake = self._logits(x_hat)
        d_loss_real = bce_with_logits(logits_real, torch.ones_like(logits_real))
        d_loss_fake = bce_with_logits(logits_fake, torch.zeros_like(logits_fake))
        d_loss = (d_loss_real + d_loss_fake) / 2
        return d_loss, {"d_loss": d_loss, "d_loss_real": d_loss_real,
                        "d_loss_fake": d_loss_fake, "logits_real": logits_real.mean(),
                        "logits_fake": logits_fake.mean()}

    def _g_loss(self, x_hat: torch.Tensor):
        logits_fake = self._logits(x_hat)
        if self.loss_type == "non-saturating":
            g_loss = bce_with_logits(logits_fake, torch.ones_like(logits_fake))
        else:  # min-max: maximize D's error on the fakes
            g_loss = -bce_with_logits(logits_fake, torch.zeros_like(logits_fake))
        return g_loss, {"g_loss": g_loss}

    # -- steps ---------------------------------------------------------------------
    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One D step, then one G step through the stepped D (module doc), on a uint8
        batch flipped by ``flip`` [B] bool and a latent batch ``z``, each drawn from
        ``generator`` when not given."""
        x = self._x(batch, generator, True, flip)
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        self.G.train()
        self.D.train()
        x_hat = self.G(z)

        d_loss, d_metrics = self._d_loss(x, x_hat.detach())
        self._optimize("D", d_loss, self.D)
        g_loss, g_metrics = self._g_loss(x_hat)
        self._optimize("G", g_loss, self.G)
        self.step += 1
        metrics = {k: v.detach() for k, v in {**d_metrics, **g_metrics}.items()}
        return self.prefix_metrics(metrics, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Both losses with G and D in eval mode (the running statistics), on the unflipped
        batch and ``z`` (drawn from ``generator`` when not given)."""
        x = self._x(batch, None, False, None)
        z = self.sample_z(generator, x.shape[0]) if z is None else z.to(self.device)
        self.G.eval()
        self.D.eval()
        x_hat = self.G(z)
        _, d_metrics = self._d_loss(x, x_hat)
        _, g_metrics = self._g_loss(x_hat)
        return self.prefix_metrics({**d_metrics, **g_metrics}, "val")

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G in eval mode on ``z`` (drawn from ``generator`` when not given): images in
        [0, 1]."""
        z = self.sample_z(generator, num_samples) if z is None else z.to(self.device)
        self.G.eval()
        return self.to_image_space(self.G(z))


class ClassConditional:
    """Sampling of a GAN whose generator takes class labels through ``_generate(z,
    labels)`` (CGAN, ACGAN): ``sample_classes`` on given labels, ``sample`` with the labels
    cycling 0, 1, ..., num_classes - 1, and a validation grid with a row of 8 per class."""

    @torch.inference_mode()
    def sample_classes(self, generator: Optional[torch.Generator], labels: torch.Tensor,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G in eval mode on class ``labels`` [N] and ``z`` (drawn when not given):
        images in [0, 1]."""
        labels = labels.to(self.device).long()
        z = self.sample_z(generator, labels.shape[0]) if z is None else z.to(self.device)
        self.G.eval()
        return self.to_image_space(self._generate(z, labels))

    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        labels = torch.arange(num_samples, device=self.device) % self.num_classes
        return self.sample_classes(generator, labels, z=z)

    def validation_grids(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        labels = torch.arange(self.num_classes, device=self.device).repeat_interleave(8)
        return {"per_class_generation": self.sample_classes(generator, labels)}
