"""The flax.linen layers the JAX package builds on, as PyTorch modules on NHWC tensors.

``Conv``, ``ConvTranspose``, ``Dense``, ``GroupNorm``, ``LayerNorm``, ``BatchNorm`` and
``Embed`` follow flax's numerics (lax's "SAME" and "VALID" padding, the norms' E[x^2] - E[x]^2
variance, convs and Dense in the layer's dtype). Each declares
``FLAX_LEAVES``: how its parameters map to the flax leaves of the same layer, which
``weights.load_flax_params`` reads. Every module of the package also has
``reset_parameters(generator)``, so that ``init_params`` draws all weights from one
explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` from N(0, std^2), drawn on the CPU generator ``generator`` so that a
    seed gives the same weights on every device."""
    t.data.copy_(torch.empty(t.shape).normal_(0.0, std, generator=generator))


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """lax's "SAME" padding (low, high) of one spatial axis: the output has
    ceil(size / stride) positions; the odd pad, if any, goes at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC input, at any stride. With "SAME" padding lax pads
    (low, high) per axis by ``same_padding``, asymmetric for an even kernel at stride 1
    (4x4: (1, 2)); "VALID" pads nothing. The kernel is stored OIHW and drawn from
    N(0, std^2) (``std`` None: fan-in^-1/2; ``zero_init``: zeros, flax's
    ``kernel_init=zeros``); input, kernel and bias are cast to ``dtype`` as flax's
    ``dtype=``."""

    FLAX_LEAVES = {"weight": ("kernel", "conv"), "bias": ("bias", None)}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True, stride: int = 1,
                 padding: str = "SAME", std: Optional[float] = None, zero_init: bool = False):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"Conv padding is SAME or VALID, got {padding!r}")
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.std = std
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.zero_init:
            self.weight.data.zero_()
        else:
            std = self.weight[0].numel() ** -0.5 if self.std is None else self.std
            normal_(self.weight, std, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.padding == "VALID":
            y = F.conv2d(x, self.weight.to(self.dtype), bias, stride=self.stride)
            return y.permute(0, 2, 3, 1)
        ph = same_padding(x.shape[2], self.kernel_size, self.stride)
        pw = same_padding(x.shape[3], self.kernel_size, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        y = F.conv2d(x, self.weight.to(self.dtype), bias, stride=self.stride,
                     padding=padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with "SAME" padding on NHWC input: lax's
    ``conv_transpose`` with ``transpose_kernel=False``, a plain convolution of the
    stride-dilated input with the unflipped HWIO kernel, padded (a, b) by lax's rule
    (k = 4, s = 2: (2, 2); the output is s times the input). torch's
    ``conv_transpose2d`` flips the kernel, so the weight is stored flipped, as
    [in, out, kh, kw] with weight[i, o, a, b] = kernel[k-1-a, k-1-b, i, o]
    (``weights.py``'s "conv_transpose" transform); its padding p stands for k - 1 - p
    on each side of the dilated input, and an uneven (a, b) is cut from the full
    output. ``std``: the kernel's init N(0, std^2) (None: fan-in^-1/2)."""

    FLAX_LEAVES = {"weight": ("kernel", "conv_transpose"), "bias": ("bias", None)}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, bias: bool = True,
                 std: Optional[float] = None):
        super().__init__()
        self.dtype = dtype
        self.std = std
        self.kernel_size = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        k, s = kernel_size, stride
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        self.cut = (k - 1 - pad_a, k - 1 - (pad_len - pad_a))
        if min(self.cut) < 0:
            raise ValueError(f"ConvTranspose takes stride <= kernel_size; got {k}, {s}")

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[0] * self.kernel_size**2
        normal_(self.weight, fan_in**-0.5 if self.std is None else self.std, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cut_a, cut_b = self.cut
        s = self.stride
        bias = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        w = self.weight.to(self.dtype)
        if cut_a == cut_b:
            y = F.conv_transpose2d(x, w, bias, stride=s, padding=cut_a)
        else:
            y = F.conv_transpose2d(x, w, bias, stride=s)
            y = y[:, :, cut_a:y.shape[2] - cut_b, cut_a:y.shape[3] - cut_b]
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: the weight is stored [out, in] (flax: [in, out]). In f32 by
    default; with a lower ``dtype`` the input, weight and bias are cast to it as flax's
    ``dtype=`` does, and the product is rounded to it before the bias is added.
    ``zero_init`` starts the weight at 0 (flax's ``kernel_init=zeros``), ``std`` draws it
    from N(0, std^2) (None: fan-in^-1/2)."""

    FLAX_LEAVES = {"weight": ("kernel", "dense"), "bias": ("bias", None)}

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False,
                 std: Optional[float] = None):
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init
        self.std = std
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.zero_init:
            self.weight.data.zero_()
        else:
            std = self.weight.shape[1] ** -0.5 if self.std is None else self.std
            normal_(self.weight, std, generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return F.linear(x.float(), self.weight, self.bias)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(self.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(dtype=float32)`` over NHWC: statistics and output in f32.
    flax's ``group_size=1`` is ``num_groups=channels``: one group per channel."""

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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(use_bias=False, use_scale=False, dtype=float32)`` over the last
    axis: no parameters, statistics and output in f32, the variance as E[x^2] - E[x]^2
    clipped at 0 (flax's ``use_fast_variance``)."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.99, epsilon 1e-5, ``use_fast_variance``) over
    every axis but the last (NHWC maps, [B, F] features), statistics and output in f32.

    In train mode (``module.train()``) it normalizes by the batch's mean and its biased
    variance E[x^2] - E[x]^2 clipped at 0, and moves the running buffers ``mean`` and
    ``var`` (flax's ``batch_stats``) as ``ra = 0.99 ra + 0.01 batch``. torch's
    ``BatchNorm2d`` keeps the unbiased variance with momentum 0.1, so the buffers move by
    hand here. In eval mode it normalizes by the buffers. The scale starts at
    1 + N(0, scale_std^2) (0: ones), the bias at 0.

    Two contexts change what a pass does with the running statistics:
    ``frozen_batch_stats`` keeps a train-mode pass from moving them (flax's train apply
    whose updated ``batch_stats`` the caller drops), and ``batch_stats_in_graph`` keeps
    the moved statistics in the autograd graph for an eval-mode pass to read, as a flax
    eval apply on the ``batch_stats`` that train applies returned inside the same
    differentiated function does: its gradient reaches the weights through them too."""

    FLAX_LEAVES = {"weight": ("scale", None), "bias": ("bias", None)}
    MOMENTUM = 0.99
    EPS = 1e-5

    def __init__(self, features: int, scale_std: float = 0.0):
        super().__init__()
        self.scale_std = scale_std
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.move_stats = True  # False inside frozen_batch_stats
        self.graph_stats = None  # (mean, var) in the graph inside batch_stats_in_graph

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.scale_std:
            normal_(self.weight, self.scale_std, generator)
            self.weight.data.add_(1.0)
        else:
            self.weight.data.fill_(1.0)
        self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            if self.move_stats:
                self._move(mean, var)
        else:
            mean, var = self.graph_stats or (self.mean, self.var)
        return (x - mean) * (torch.rsqrt(var + self.EPS) * self.weight) + self.bias

    def _move(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = 0.99 ra + 0.01 batch into the buffers (and, in the graph, graph_stats)."""
        m = self.MOMENTUM
        if self.graph_stats is None:
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
            return
        ra_mean, ra_var = self.graph_stats
        self.graph_stats = (m * ra_mean + (1.0 - m) * mean, m * ra_var + (1.0 - m) * var)
        with torch.no_grad():
            self.mean.copy_(self.graph_stats[0])
            self.var.copy_(self.graph_stats[1])


def _batch_norms(*nets: nn.Module) -> list:
    return [m for net in nets for m in net.modules() if isinstance(m, BatchNorm)]


@contextlib.contextmanager
def frozen_batch_stats(*nets: nn.Module):
    """Inside, the train-mode BatchNorm passes of ``nets`` normalize by the batch's
    statistics and leave the running buffers as they are."""
    norms = _batch_norms(*nets)
    for bn in norms:
        bn.move_stats = False
    try:
        yield
    finally:
        for bn in norms:
            bn.move_stats = True


@contextlib.contextmanager
def batch_stats_in_graph(net: nn.Module):
    """Inside, each train-mode BatchNorm pass of ``net`` keeps the running statistics it
    moves as tensors of the autograd graph (the buffers get their values too), and
    eval-mode passes normalize by those tensors: a gradient through an eval pass then
    reaches the weights of the train passes before it through the statistics."""
    norms = _batch_norms(net)
    for bn in norms:
        bn.graph_stats = (bn.mean.clone(), bn.var.clone())
    try:
        yield
    finally:
        for bn in norms:
            bn.graph_stats = None


class Embed(nn.Module):
    """flax ``nn.Embed``: a [num_embeddings, features] f32 table, drawn from N(0, std^2)."""

    FLAX_LEAVES = {"weight": ("embedding", None)}

    def __init__(self, num_embeddings: int, features: int, std: float = 1.0):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, self.std, generator)

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
