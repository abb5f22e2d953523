"""Diffusion UNet on NHWC tensors.

Counterpart of ``lightning_generative_models_tpu/models/diffusion/unet.py``: 7x7 init
conv; per resolution [2 x FiLM ResnetBlock + attention + downsample]; mid
block/attention/block; the symmetric up path with skip concatenations; a final
residual block over the concatenated init features; sinusoidal (or random/learned
Fourier) time embedding -> MLP -> per-block scale/shift; linear attention at the outer
resolutions and full attention innermost.

Submodules carry flax's auto-names (``Conv_0``, ``ResnetBlock_3``,
``LinearAttention_1``, ...), given in the order the flax module creates them, so a
flax parameter tree maps onto ``named_parameters`` path for path. Dtypes follow flax's
``dtype=``: the convs run in the UNet dtype; GroupNorm, the time MLP, the FiLM Dense
and the final 1x1 conv stay f32.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.attention import (
    Attention,
    LinearAttention,
)
from lightning_generative_models_tpu_torch.models.modules.layers import (
    Conv,
    Dense,
    Embed,
    GroupNorm,
)
from lightning_generative_models_tpu_torch.models.modules.time_embedding import (
    RandomOrLearnedSinusoidalPosEmb,
    SinusoidalPosEmb,
)


class Block(nn.Module):
    """conv 3x3 -> GroupNorm -> (FiLM scale/shift) -> SiLU."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(dim_in, dim_out, 3, dtype)
        self.GroupNorm_0 = GroupNorm(groups, dim_out)

    def forward(self, x, scale_shift=None):
        x = self.GroupNorm_0(self.Conv_0(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale[:, None, None, :] + 1) + shift[:, None, None, :]
        return F.silu(x).to(self.dtype)


class ResnetBlock(nn.Module):
    """Two blocks + FiLM time conditioning + skip (1x1 conv when widths differ)."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(time_dim, dim_out * 2)
        self.Block_0 = Block(dim_in, dim_out, groups, dtype)
        self.Block_1 = Block(dim_out, dim_out, groups, dtype)
        self.Conv_0 = Conv(dim_in, dim_out, 1, dtype) if dim_in != dim_out else None

    def forward(self, x, time_emb):
        scale_shift = self.Dense_0(F.silu(time_emb)).chunk(2, dim=-1)
        h = self.Block_1(self.Block_0(x, scale_shift))
        if self.Conv_0 is not None:
            x = self.Conv_0(x)
        return h + x


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H/2,W/2,4C], channels packed as (dy, dx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class Downsample(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(4 * dim_in, dim_out, 1, dtype)

    def forward(self, x):
        return self.Conv_0(space_to_depth(x))


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


class Upsample(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(dim_in, dim_out, 3, dtype)

    def forward(self, x):
        return self.Conv_0(nearest_upsample_2x(x))


def _cast_tuple(value, length: int) -> Tuple:
    if isinstance(value, (tuple, list)):
        if len(value) != length:
            raise ValueError(f"expected {length} values, got {value!r}")
        return tuple(value)
    return (value,) * length


class UNet(nn.Module):
    def __init__(
        self,
        dim: int,
        init_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 3,
        self_condition: bool = False,
        num_classes: Optional[int] = None,
        resnet_block_groups: int = 8,
        learned_variance: bool = False,
        learned_sinusoidal_cond: bool = False,
        random_fourier_features: bool = False,
        learned_sinusoidal_dim: int = 16,
        sinusoidal_pos_emb_theta: float = 10000.0,
        attn_dim_head: Union[int, Sequence[int]] = 32,
        attn_heads: Union[int, Sequence[int]] = 4,
        full_attn: Optional[Sequence[bool]] = None,  # default: innermost only
        flash_attn: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim = dim
        self.channels = channels
        self.self_condition = self_condition
        self.num_classes = num_classes
        self.dtype = dtype
        self.output_channels = out_dim if out_dim is not None else channels * (
            2 if learned_variance else 1
        )
        self._counts = defaultdict(int)

        num_stages = len(dim_mults)
        full_attn = _cast_tuple(full_attn or ((False,) * (num_stages - 1) + (True,)),
                                num_stages)
        heads = _cast_tuple(attn_heads, num_stages)
        dim_heads = _cast_tuple(attn_dim_head, num_stages)
        init_dim = init_dim or dim
        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        groups = resnet_block_groups
        time_dim = dim * 4

        def attn_layer(stage: int, width: int) -> nn.Module:
            if full_attn[stage]:
                return self._add("Attention", Attention(
                    width, heads=heads[stage], dim_head=dim_heads[stage],
                    flash=flash_attn, dtype=dtype, residual=True))
            return self._add("LinearAttention", LinearAttention(
                width, heads=heads[stage], dim_head=dim_heads[stage],
                dtype=dtype, residual=True))

        # Created in the order of the flax module's __call__, so the names match.
        # Tuples and lists below only alias the modules registered by _add.
        in_ch = channels * (2 if self_condition else 1)
        init_conv = self._add("Conv", Conv(in_ch, init_dim, 7, dtype))
        if learned_sinusoidal_cond or random_fourier_features:
            pos_emb = self._add("RandomOrLearnedSinusoidalPosEmb",
                                RandomOrLearnedSinusoidalPosEmb(
                                    learned_sinusoidal_dim, random_fourier_features))
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            pos_emb = self._add("SinusoidalPosEmb",
                                SinusoidalPosEmb(dim, sinusoidal_pos_emb_theta))
            fourier_dim = dim
        self.stem = (init_conv, pos_emb, self._add("Dense", Dense(fourier_dim, time_dim)),
                     self._add("Dense", Dense(time_dim, time_dim)))
        if num_classes is not None:
            self.class_emb = Embed(num_classes + 1, time_dim)

        self.downs = []
        for stage, (dim_in, dim_out) in enumerate(in_out):
            last = stage == num_stages - 1
            self.downs.append((
                self._add("ResnetBlock", ResnetBlock(dim_in, dim_in, time_dim, groups, dtype)),
                self._add("ResnetBlock", ResnetBlock(dim_in, dim_in, time_dim, groups, dtype)),
                attn_layer(stage, dim_in),
                self._add("Conv", Conv(dim_in, dim_out, 3, dtype)) if last
                else self._add("Downsample", Downsample(dim_in, dim_out, dtype)),
            ))

        mid_dim = dims[-1]
        self.mid = (
            self._add("ResnetBlock", ResnetBlock(mid_dim, mid_dim, time_dim, groups, dtype)),
            self._add("Attention", Attention(
                mid_dim, heads=heads[-1], dim_head=dim_heads[-1], flash=flash_attn,
                dtype=dtype, residual=True)),
            self._add("ResnetBlock", ResnetBlock(mid_dim, mid_dim, time_dim, groups, dtype)),
        )

        self.ups = []
        for stage, (dim_in, dim_out) in enumerate(reversed(in_out)):
            last = stage == num_stages - 1
            self.ups.append((
                self._add("ResnetBlock", ResnetBlock(
                    dim_out + dim_in, dim_out, time_dim, groups, dtype)),
                self._add("ResnetBlock", ResnetBlock(
                    dim_out + dim_in, dim_out, time_dim, groups, dtype)),
                attn_layer(num_stages - 1 - stage, dim_out),
                self._add("Conv", Conv(dim_out, dim_in, 3, dtype)) if last
                else self._add("Upsample", Upsample(dim_out, dim_in, dtype)),
            ))

        self.head = (
            self._add("ResnetBlock", ResnetBlock(2 * init_dim, dim, time_dim, groups, dtype)),
            self._add("Conv", Conv(dim, self.output_channels, 1, torch.float32)),
        )

    def _add(self, kind: str, module: nn.Module) -> nn.Module:
        """Register ``module`` under flax's next auto-name for ``kind``."""
        self.add_module(f"{kind}_{self._counts[kind]}", module)
        self._counts[kind] += 1
        return module

    @property
    def null_class(self) -> int:
        """Label value meaning 'unconditional' when ``num_classes`` is set."""
        if self.num_classes is None:
            raise ValueError("null_class needs UNet(num_classes=...)")
        return self.num_classes

    def forward(
        self,
        x: torch.Tensor,
        time: torch.Tensor,
        x_self_cond: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x: [B, H, W, C] f32, time: [B] -> [B, H, W, output_channels] f32."""
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=-1)

        init_conv, pos_emb, dense0, dense1 = self.stem
        x = init_conv(x.to(self.dtype))
        r = x

        t = dense1(F.gelu(dense0(pos_emb(time)), approximate="tanh"))
        if self.num_classes is not None:
            if labels is None:
                raise ValueError(
                    "UNet(num_classes=...) requires labels; pass "
                    f"torch.full((B,), {self.null_class}) for unconditional"
                )
            t = t + self.class_emb(labels)

        skips = []
        for res1, res2, attn, down in self.downs:
            x = res1(x, t)
            skips.append(x)
            x = attn(res2(x, t))
            skips.append(x)
            x = down(x)

        res1, attn, res2 = self.mid
        x = res2(attn(res1(x, t)), t)

        for res1, res2, attn, up in self.ups:
            x = res1(torch.cat([x, skips.pop()], dim=-1), t)
            x = res2(torch.cat([x, skips.pop()], dim=-1), t)
            x = up(attn(x))

        final_res, final_conv = self.head
        x = final_res(torch.cat([x, r], dim=-1), t)
        return final_conv(x).float()
