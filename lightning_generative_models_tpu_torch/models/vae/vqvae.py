"""VQ-VAE (van den Oord et al. 2017), plain and EMA codebook.

Counterpart of ``lightning_generative_models_tpu/models/vae/vqvae.py``: encoder =
three stride-2 4x4 convs (hidden/4 -> hidden/2 -> hidden) + 3x3 conv + residual stack
+ 1x1 projection to the embedding dim; the decoder mirrors it with flax-style
transposed convs and tanh; loss = weighted MSE reconstruction + weighted VQ loss
(``loss_weights``); codebook perplexity in the metrics; ``use_ema`` selects the EMA
codebook; ``sample`` decodes uniformly random codes. Adam with the weight decay added
to the gradient (``train/state.py:make_adam``).

Where the JAX model threads a ``TrainState`` through pure steps, this one owns its
modules (``net``: ``encoder``, ``decoder``, ``vq``), its optimizer and its step
counter. Like the JAX class it has no ``grad_step``: the trainer accumulates
gradients by concatenating micro-batches.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.base import GenerativeModel
from lightning_generative_models_tpu_torch.models.modules.layers import (
    Conv,
    ConvTranspose,
    init_params,
)
from lightning_generative_models_tpu_torch.models.modules.residual import ResidualStack
from lightning_generative_models_tpu_torch.models.modules.vector_quantizer import (
    VectorQuantizer,
    VectorQuantizerEMA,
)
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.train.state import (
    apply_grads,
    count_params,
    make_adam,
)
from lightning_generative_models_tpu_torch.weights import load_flax_train_state


class Encoder(nn.Module):
    def __init__(self, img_channels: int, embedding_dim: int, hidden_dim: int,
                 num_residual_layers: int, num_residual_hiddens: int):
        super().__init__()
        self.Conv_0 = Conv(img_channels, hidden_dim // 4, 4, stride=2)
        self.Conv_1 = Conv(hidden_dim // 4, hidden_dim // 2, 4, stride=2)
        self.Conv_2 = Conv(hidden_dim // 2, hidden_dim, 4, stride=2)
        self.Conv_3 = Conv(hidden_dim, hidden_dim, 3)
        self.ResidualStack_0 = ResidualStack(hidden_dim, num_residual_layers,
                                             num_residual_hiddens)
        self.Conv_4 = Conv(hidden_dim, embedding_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Conv_0(x))
        h = F.relu(self.Conv_1(h))
        h = F.relu(self.Conv_2(h))
        h = self.ResidualStack_0(self.Conv_3(h))
        return self.Conv_4(h)


class Decoder(nn.Module):
    def __init__(self, img_channels: int, embedding_dim: int, hidden_dim: int,
                 num_residual_layers: int, num_residual_hiddens: int):
        super().__init__()
        self.Conv_0 = Conv(embedding_dim, hidden_dim, 3)
        self.ResidualStack_0 = ResidualStack(hidden_dim, num_residual_layers,
                                             num_residual_hiddens)
        self.ConvTranspose_0 = ConvTranspose(hidden_dim, hidden_dim // 2, 4, stride=2)
        self.ConvTranspose_1 = ConvTranspose(hidden_dim // 2, hidden_dim // 4, 4, stride=2)
        self.ConvTranspose_2 = ConvTranspose(hidden_dim // 4, img_channels, 4, stride=2)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        h = self.ResidualStack_0(self.Conv_0(q))
        h = F.relu(self.ConvTranspose_0(h))
        h = F.relu(self.ConvTranspose_1(h))
        return torch.tanh(self.ConvTranspose_2(h))

    @property
    def last_kernel(self) -> torch.Tensor:
        """The last transposed conv's kernel: VQGAN's adaptive weight reads its grads."""
        return self.ConvTranspose_2.weight


class VQVAE(GenerativeModel):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        embedding_dim: int = 64,
        num_embeddings: int = 512,
        hidden_dim: int = 256,
        num_residual_layers: int = 2,
        num_residual_hiddens: int = 256,
        commitment_cost: float = 0.25,
        use_ema: bool = True,
        decay: float = 0.99,
        epsilon: float = 1e-5,
        lr: float = 1e-4,
        b1: float = 0.5,
        b2: float = 0.999,
        weight_decay: float = 1e-5,
        loss_weights: Optional[Dict[str, float]] = None,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``. The weights start from
        ``init_params`` with seed 0."""
        super().__init__(img_channels, img_size)
        self.device = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.use_ema = use_ema
        self.loss_weights = loss_weights or {"recon_loss": 1.0, "vq_loss": 1.0}
        self.latent_hw = img_size // 8  # three stride-2 convs
        self.lr, self.betas, self.weight_decay = lr, (b1, b2), weight_decay
        if use_ema:
            vq = VectorQuantizerEMA(num_embeddings, embedding_dim, commitment_cost,
                                    decay, epsilon)
        else:
            vq = VectorQuantizer(num_embeddings, embedding_dim, commitment_cost)
        widths = (embedding_dim, hidden_dim, num_residual_layers, num_residual_hiddens)
        self.net = nn.ModuleDict({
            "encoder": Encoder(img_channels, *widths),
            "decoder": Decoder(img_channels, *widths),
            "vq": vq,
        })
        self.step = 0
        self.init_params()

    @property
    def encoder(self) -> Encoder:
        return self.net["encoder"]

    @property
    def decoder(self) -> Decoder:
        return self.net["decoder"]

    @property
    def vq(self) -> nn.Module:
        return self.net["vq"]

    # -- parameters ----------------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every weight (and the EMA codebook) from the CPU ``generator`` and start
        a fresh optimizer at step 0."""
        init_params(self.net, generator)
        self.net.to(self.device)
        self.optimizer = make_adam(self._trainable(), self.lr, *self.betas,
                                   weight_decay=self.weight_decay)
        self.step = 0

    def _trainable(self) -> list:
        return [p for p in self.net.parameters() if p.requires_grad]

    def param_counts(self) -> Dict[str, int]:
        return {name: count_params(module) for name, module in self.net.items()}

    def flax_layout(self) -> dict:
        params = {"params/encoder": self.encoder, "params/decoder": self.decoder}
        if self.use_ema:
            buffers = {"mutable/vq/codebook": self.vq}
        else:
            params["params/vq"] = self.vq
            buffers = {}
        moments = {"encoder": self.encoder, "decoder": self.decoder, "vq": self.vq}
        return {"params": params, "buffers": buffers,
                "adam": {"opt_state/model": (self.optimizer, moments)}}

    def load_flax_weights(self, tree) -> None:
        """``generate --weights``: a flattened JAX ``TrainState`` (its ``params`` and
        ``mutable`` entries; the optimizer's are not read)."""
        load_flax_train_state(self, tree, optimizers=False)

    # -- forward -------------------------------------------------------------------
    def _on_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _x01(self, batch: Dict, generator: Optional[torch.Generator], train: bool,
             flip: Optional[torch.Tensor]) -> torch.Tensor:
        return prepare_batch(self._on_device(batch), generator, train=train,
                             flip=flip)["image"]

    def _apply_vq(self, latents: torch.Tensor, train: bool):
        """The quantizer on encoder latents: (q, vq_loss, perplexity); the EMA codebook
        moves only when ``train``. ``LatentDiffusion`` decodes through it."""
        self.vq.train(train)
        return self.vq(latents)

    def _forward(self, x: torch.Tensor, train: bool):
        """Model-space x -> (x_hat, vq_loss, perplexity)."""
        q, vq_loss, perplexity = self._apply_vq(self.encoder(x), train)
        return self.decoder(q), vq_loss, perplexity

    def _loss(self, x01: torch.Tensor, train: bool):
        x = self.to_model_space(x01)
        x_hat, vq_loss, perplexity = self._forward(x, train)
        recon_loss = torch.mean((x_hat - x) ** 2)
        loss = (self.loss_weights["recon_loss"] * recon_loss
                + self.loss_weights["vq_loss"] * vq_loss)
        return loss, {"loss": loss, "recon_loss": recon_loss, "vq_loss": vq_loss,
                      "perplexity": perplexity}

    # -- steps ---------------------------------------------------------------------
    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   flip: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One Adam step on a uint8 batch, flipped by ``flip`` [B] bool or by a draw
        from ``generator``."""
        x01 = self._x01(batch, generator, True, flip)
        params = self._trainable()
        loss, metrics = self._loss(x01, True)
        apply_grads(self.optimizer, params,
                    torch.autograd.grad(loss, params, allow_unused=True))
        self.step += 1
        return self.prefix_metrics({k: v.detach() for k, v in metrics.items()}, "train")

    @torch.inference_mode()
    def eval_step(self, batch: Dict,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x01 = self._x01(batch, None, False, None)
        _, metrics = self._loss(x01, False)
        return self.prefix_metrics(metrics, "val")

    @torch.inference_mode()
    def reconstruct(self, batch: Dict) -> torch.Tensor:
        """Encode, quantize (eval mode) and decode a uint8 batch: images in [0, 1]."""
        x = self.to_model_space(self._x01(batch, None, False, None))
        return self.to_image_space(self._forward(x, False)[0])

    # -- sampling ------------------------------------------------------------------
    @torch.inference_mode()
    def decode_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook indices [N, h, w] -> images [N, H, W, C] in [0, 1]."""
        indices = torch.as_tensor(indices, device=self.device).long()
        q = F.embedding(indices, self.vq.codebook)
        return self.to_image_space(self.decoder(q))

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator],
               num_samples: int) -> torch.Tensor:
        """Decode uniformly random codebook indices."""
        indices = torch.randint(0, self.num_embeddings,
                                (num_samples, self.latent_hw, self.latent_hw),
                                generator=generator, device=self.device)
        return self.decode_codes(indices)

    def codebook_table(self) -> np.ndarray:
        """The codebook [K, D] for table logging."""
        return self.vq.codebook.detach().float().cpu().numpy()

    # -- checkpoint state ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"net": self.net.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.net.load_state_dict(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
