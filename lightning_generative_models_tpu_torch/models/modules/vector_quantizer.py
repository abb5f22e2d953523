"""Vector quantization: plain and EMA-codebook variants, NHWC.

Counterpart of ``lightning_generative_models_tpu/models/modules/vector_quantizer.py``:
nearest-code assignment through ``ops/vq.py`` (the CUDA kernel on the card), the
straight-through estimator, the VQ loss with the reference's term naming, codebook
perplexity, and the EMA variant's Laplace-smoothed cluster sizes and embedding sums,
updated in place and only in training mode.

The JAX package keeps the EMA codebook in a flax ``codebook`` collection; here it is
three buffers (``embedding``, ``ema_cluster_size``, ``ema_embedding``), which
``weights.py`` fills from ``mutable/vq/codebook``. The EMA statistics are a one-hot
product and a count, both outside the kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.ops.vq import nearest_codes


def _assign_codes(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices (int32) with no gradient: the kernel on the card."""
    return nearest_codes(flat.detach(), codebook.detach())


def perplexity_from_counts(counts: torch.Tensor, n: int, eps: float = 1e-10) -> torch.Tensor:
    avg_probs = counts / n
    return torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + eps)))


def _counts(indices: torch.Tensor, num_embeddings: int) -> torch.Tensor:
    return torch.bincount(indices.long(), minlength=num_embeddings).to(torch.float32)


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    t.data.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))


class VectorQuantizer(nn.Module):
    """Trainable-codebook VQ: the codebook is the parameter ``embedding`` [K, D]."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.embedding = nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform_(self.embedding, 1.0 / self.num_embeddings, generator)

    @property
    def codebook(self) -> torch.Tensor:
        return self.embedding

    def forward(self, latents: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """latents [B, H, W, D] -> (quantized, vq_loss, perplexity). Training mode plays
        no part: the plain codebook learns through its gradient."""
        b, h, w, d = latents.shape
        flat = latents.reshape(-1, d)
        indices = _assign_codes(flat, self.embedding)
        quantized = F.embedding(indices, self.embedding).reshape(b, h, w, d)

        # Reference naming: e_latent_loss carries the codebook's gradient, q_latent_loss
        # the encoder's.
        e_latent_loss = torch.mean((quantized - latents.detach()) ** 2)
        q_latent_loss = torch.mean((quantized.detach() - latents) ** 2)
        vq_loss = e_latent_loss + self.commitment_cost * q_latent_loss

        perplexity = perplexity_from_counts(_counts(indices, self.num_embeddings),
                                            flat.shape[0])
        quantized = latents + (quantized - latents).detach()  # straight-through
        return quantized, vq_loss, perplexity


class VectorQuantizerEMA(nn.Module):
    """EMA-codebook VQ: the codebook is a buffer, moved in training mode by decayed
    cluster sizes and embedding sums (VQ-VAE-2), never by a gradient."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25, decay: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.epsilon = epsilon
        self.register_buffer("embedding", torch.empty(num_embeddings, embedding_dim))
        self.register_buffer("ema_cluster_size", torch.zeros(num_embeddings))
        self.register_buffer("ema_embedding", torch.empty(num_embeddings, embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _uniform_(self.embedding, 1.0 / self.num_embeddings, generator)
        self.ema_cluster_size.zero_()
        self.ema_embedding.copy_(self.embedding)

    @property
    def codebook(self) -> torch.Tensor:
        return self.embedding

    def forward(self, latents: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """latents [B, H, W, D] -> (quantized, vq_loss, perplexity). In training mode
        the indices come from the codebook before the update, and ``quantized`` is
        gathered from the updated one; eval mode leaves the buffers untouched."""
        b, h, w, d = latents.shape
        flat = latents.reshape(-1, d)
        indices = _assign_codes(flat, self.embedding)
        counts = _counts(indices, self.num_embeddings)
        perplexity = perplexity_from_counts(counts, flat.shape[0])

        if self.training:
            with torch.no_grad():
                one_hot = F.one_hot(indices.long(), self.num_embeddings).to(flat.dtype)
                decay = self.decay
                new_cluster = self.ema_cluster_size * decay + counts * (1 - decay)
                n = torch.sum(new_cluster)
                cluster_weights = ((new_cluster + self.epsilon)
                                   / (n + self.num_embeddings * self.epsilon) * n)
                dw = one_hot.T @ flat.detach()  # [K, D]
                new_ema_emb = self.ema_embedding * decay + dw * (1 - decay)
                self.ema_cluster_size.copy_(new_cluster)
                self.ema_embedding.copy_(new_ema_emb)
                self.embedding.copy_(new_ema_emb / cluster_weights[:, None])

        quantized = F.embedding(indices, self.embedding).detach().reshape(b, h, w, d)
        e_latent_loss = torch.mean((quantized - latents.detach()) ** 2)
        # No stop-gradient here: quantized is already cut, as in the reference.
        q_latent_loss = torch.mean((quantized - latents) ** 2)
        vq_loss = e_latent_loss + self.commitment_cost * q_latent_loss

        quantized = latents + (quantized - latents).detach()
        return quantized, vq_loss, perplexity
