"""Timestep embeddings for diffusion models.

Counterpart of ``lightning_generative_models_tpu/models/modules/time_embedding.py``:
the sinusoidal embedding with configurable theta, and the random/learned Fourier
variant that appends the raw timestep.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import normal_


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.theta = theta

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        emb = math.log(self.theta) / (half_dim - 1)
        freqs = torch.exp(
            torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb
        )
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Random (frozen) or learned Fourier features; output dim = dim + 1."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        if dim % 2:
            raise ValueError(f"RandomOrLearnedSinusoidalPosEmb needs an even dim, got {dim}")
        self.is_random = is_random
        self.weights = nn.Parameter(torch.empty(dim // 2), requires_grad=not is_random)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weights, 1.0, generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()[:, None]
        freqs = t * self.weights[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)
