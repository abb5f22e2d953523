"""The flax.linen layers the JAX package builds on, as PyTorch modules on NHWC tensors.

``Conv``, ``Dense``, ``GroupNorm`` and ``Embed`` follow flax's numerics (GroupNorm eps
1e-6 with the E[x^2] - E[x]^2 variance, convs in the layer's dtype). Each declares
``FLAX_LEAVES``: how its parameters map to the flax leaves of the same layer, which
``weights.load_flax_params`` reads. Every module of the package also has
``reset_parameters(generator)``, so that ``init_params`` draws all weights from one
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` from N(0, std^2), drawn on the CPU generator ``generator`` so that a
    seed gives the same weights on every device."""
    t.data.copy_(torch.empty(t.shape).normal_(0.0, std, generator=generator))


class Conv(nn.Module):
    """flax ``nn.Conv`` with "SAME" padding and stride 1 on NHWC input. The kernel is
    stored OIHW; input, kernel and bias are cast to ``dtype`` as flax's ``dtype=``."""

    FLAX_LEAVES = {"weight": ("kernel", "conv"), "bias": ("bias", None)}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, self.weight[0].numel() ** -0.5, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), self.weight.to(self.dtype),
                     bias, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense`` in f32: the weight is stored [out, in] (flax: [in, out])."""

    FLAX_LEAVES = {"weight": ("kernel", "dense"), "bias": ("bias", None)}

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, self.weight.shape[1] ** -0.5, generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(dtype=float32)`` over NHWC: statistics and output in f32."""

    FLAX_LEAVES = {"weight": ("scale", None), "bias": ("bias", None)}

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.num_groups
        xg = x.float().reshape(b, h * w, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
        y = (xg - mean) * mul + self.bias.reshape(g, c // g)
        return y.reshape(b, h, w, c)


class Embed(nn.Module):
    """flax ``nn.Embed``: a [num_embeddings, features] f32 table."""

    FLAX_LEAVES = {"weight": ("embedding", None)}

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, 1.0, generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), self.weight)


def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every parameter of ``module`` from the CPU ``generator`` (seed 0 when
    omitted), module by module in a fixed order."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for sub in module.modules():
        reset = getattr(sub, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
