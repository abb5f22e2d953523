"""Vector quantization: plain and EMA-codebook variants, NHWC.

Counterpart of ``lightning_generative_models_tpu/models/modules/vector_quantizer.py``:
nearest-code assignment through ``ops/vq.py`` (the CUDA kernel on the card), the
straight-through estimator, the VQ loss with the reference's term naming, codebook
perplexity, and the EMA variant's Laplace-smoothed cluster sizes and embedding sums,
updated in place and only in training mode. Over data ranks the counts and sums are the
global batch's (summed over the ranks before the update and the perplexity).

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
from lightning_generative_models_tpu_torch.parallel import collectives as C
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib


def _assign_codes(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices (int32) with no gradient: the kernel on the card."""
    return nearest_codes(flat.detach(), codebook.detach())


def perplexity_from_counts(counts: torch.Tensor, n: int, eps: float = 1e-10) -> torch.Tensor:
    avg_probs = counts / n
    return torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + eps)))


def _counts(indices: torch.Tensor, num_embeddings: int) -> torch.Tensor:
    """Each code's count, f32. Summed with ``index_add_`` (ones, so any order gives the
    same integers): ``bincount`` reads its input's max on the host, which a CUDA graph
    cannot hold."""
    ones = torch.ones(indices.shape[0], dtype=torch.float32, device=indices.device)
    return torch.zeros(num_embeddings, dtype=torch.float32,
                       device=indices.device).index_add_(0, indices.long(), ones)


def _global_sums(counts: torch.Tensor, dw, rows: int):
    """(code counts, the EMA's embedding sums, rows) of the global batch: summed over
    the ambient mesh's data ranks (one collective), so that N ranks move the codebook as
    one device does; unchanged on one rank."""
    ranks = mesh_lib.data_size()
    if ranks == 1:
        return counts, dw, rows
    packed = counts if dw is None else torch.cat([counts[:, None], dw], dim=1)
    packed = C.all_reduce_(packed.detach().contiguous(), mesh_lib.group(mesh_lib.DATA_AXIS))
    if dw is None:
        return packed, None, rows * ranks
    return packed[:, 0].contiguous(), packed[:, 1:].contiguous(), rows * ranks


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

        counts, _, rows = _global_sums(_counts(indices, self.num_embeddings), None,
                                       flat.shape[0])
        perplexity = perplexity_from_counts(counts, rows)
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
        dw = None
        if self.training:
            with torch.no_grad():
                one_hot = F.one_hot(indices.long(), self.num_embeddings).to(flat.dtype)
                dw = one_hot.T @ flat.detach()  # [K, D]
        counts, dw, rows = _global_sums(counts, dw, flat.shape[0])
        perplexity = perplexity_from_counts(counts, rows)

        if self.training:
            with torch.no_grad():
                decay = self.decay
                new_cluster = self.ema_cluster_size * decay + counts * (1 - decay)
                n = torch.sum(new_cluster)
                cluster_weights = ((new_cluster + self.epsilon)
                                   / (n + self.num_embeddings * self.epsilon) * n)
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
