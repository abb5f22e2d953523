"""Attention blocks for the diffusion UNet, on NHWC tensors.

Counterpart of ``lightning_generative_models_tpu/models/modules/attention.py``:
pixel-space ``RMSNorm``; softmax-kernel ``LinearAttention`` with learned memory KV at
the outer resolutions, whose whole block is one CUDA kernel on the card
(``ops/linear_attention.py``); full ``Attention`` with memory KV at the innermost
resolution, as plain PyTorch (it sees at most 64 + 4 keys at the repo's resolutions), or
with ``flash`` at n_kv >= 256 through the flash path of ``ops/attention.py``.

Parameter names and shapes are the flax module's, so ``weights.load_flax_params``
maps them one to one. The two memory-KV layouts differ, as in the JAX package:
``LinearAttention.mem_kv`` is [2, heads, d, m], ``Attention.mem_kv`` is [2, heads, m, d].
"""

from __future__ import annotations

import torch
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import Conv, normal_
from lightning_generative_models_tpu_torch.ops.attention import (
    FLASH_MIN_KV,
    scaled_dot_product_attention,
)
from lightning_generative_models_tpu_torch.ops.linear_attention import linear_attention


class RMSNorm(nn.Module):
    """Channel RMSNorm over the last axis, times sqrt(dim), eps 1e-12. Statistics in
    f32; the result is cast back to the input dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.g = nn.Parameter(torch.ones(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.g.data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(torch.sum(x32 * x32, dim=-1, keepdim=True) + 1e-12)
        return (normed * self.g * (self.dim**0.5)).to(x.dtype)


class LinearAttention(nn.Module):
    """Softmax-kernel linear attention, O(n d^2), with flat parameters as the flax
    module: ``norm_g``, ``qkv_kernel``, ``mem_kv``, ``out_kernel``, ``out_bias``,
    ``out_norm_g``."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4,
                 dtype: torch.dtype = torch.float32, residual: bool = False):
        super().__init__()
        hd = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.dtype, self.residual = dtype, residual
        self.norm_g = nn.Parameter(torch.ones(dim))
        self.qkv_kernel = nn.Parameter(torch.empty(dim, 3 * hd))
        self.mem_kv = nn.Parameter(torch.empty(2, heads, dim_head, num_mem_kv))
        self.out_kernel = nn.Parameter(torch.empty(hd, dim))
        self.out_bias = nn.Parameter(torch.zeros(dim))
        self.out_norm_g = nn.Parameter(torch.ones(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.norm_g.data.fill_(1.0)
        normal_(self.qkv_kernel, self.qkv_kernel.shape[0] ** -0.5, generator)
        normal_(self.mem_kv, 1.0, generator)
        normal_(self.out_kernel, self.out_kernel.shape[0] ** -0.5, generator)
        self.out_bias.data.zero_()
        self.out_norm_g.data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        out = linear_attention(
            x.to(self.dtype).reshape(b, h * w, c),
            self.norm_g, self.qkv_kernel, self.mem_kv, self.out_kernel,
            self.out_bias, self.out_norm_g,
            heads=self.heads, dim_head=self.dim_head, dtype=self.dtype,
            residual=self.residual,
        )
        return out.reshape(b, h, w, c)


class Attention(nn.Module):
    """Full softmax attention over flattened pixels, with memory KV; f32 logits and
    softmax, products of compute-type values summed in f32."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4,
                 flash: bool = False, dtype: torch.dtype = torch.float32,
                 residual: bool = False):
        super().__init__()
        hd = heads * dim_head
        self.heads, self.dim_head, self.num_mem_kv = heads, dim_head, num_mem_kv
        self.flash, self.dtype, self.residual = flash, dtype, residual
        self.RMSNorm_0 = RMSNorm(dim)
        self.Conv_0 = Conv(dim, 3 * hd, 1, dtype, bias=False)
        self.mem_kv = nn.Parameter(torch.empty(2, heads, num_mem_kv, dim_head))
        self.Conv_1 = Conv(hd, dim, 1, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.mem_kv, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        n = h * w
        hd = self.heads * self.dim_head
        x_in = x
        x = self.RMSNorm_0(x.to(self.dtype))
        qkv = self.Conv_0(x).reshape(b, n, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(2)  # [b, n, h, d]

        mk, mv = (
            self.mem_kv[i].permute(1, 0, 2)[None].to(self.dtype)
            .expand(b, self.num_mem_kv, self.heads, self.dim_head)
            for i in range(2)
        )
        k = torch.cat([mk, k], dim=1)
        v = torch.cat([mv, v], dim=1)

        if self.flash and k.shape[1] >= FLASH_MIN_KV:
            # [b, h, n, d] views; the SDPA dispatcher's own gate checks d.
            out = scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), use_pallas=True,
            ).transpose(1, 2)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (self.dim_head**-0.5)
            weights = torch.softmax(logits, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(self.dtype)
        out = self.Conv_1(out.reshape(b, h, w, hd))
        return out + x_in.to(out.dtype) if self.residual else out
