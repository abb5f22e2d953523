"""DiT: the Diffusion Transformer backbone (Peebles & Xie 2022, arXiv:2212.09748).

Counterpart of ``lightning_generative_models_tpu/models/diffusion/dit.py``: patchify the
NHWC image into tokens with one Dense, add fixed 2D sin-cos positions, run ``depth``
adaLN-Zero transformer blocks conditioned on the timestep (and class) embedding, and
unpatchify a zero-initialised linear head. Same call signature as the UNet
(``x, time, x_self_cond=None, labels=None``) and ``null_class``, so ``DDPM(network="dit")``
swaps it in with the sampler, the trainer, classifier-free guidance and the EMA unchanged.

Submodules carry the flax names (``patch_embed``, ``t_fc1``, ``t_fc2``, ``class_emb``,
``block_{i}/{adaLN_modulation,qkv,proj,fc1,fc2}``, ``final_modulation``, ``head``), so a
flax parameter tree maps onto ``named_parameters`` path for path. Dtypes follow flax's
``dtype=``: the residual stream, qkv, proj and the MLP in the compute dtype; the
LayerNorms, modulation, the conditioning MLP, the two modulation Denses and the head in
f32; the output f32. Attention goes through ``ops.attention.fused_attention_qkv`` on the
packed qkv (the CUDA kernels on the card), or its plain version with ``einsum_attn``;
with ``flash_attn``, q, k and v go as [b, h, n, d] views of the packed qkv (no copy)
through ``ops.attention.scaled_dot_product_attention(use_pallas=True)``: the flash
kernel on the card at n >= 256, the plain attention otherwise.

With ``num_experts > 0`` the MLP of every ``moe_every``-th block, counted from the last,
is a top-1 ``MoEMlp`` (``block_{i}/moe/{router,wi,bi,wo,bo}``, flax's names);
``forward(..., return_aux=True)`` also returns the mean of those layers' load-balancing
losses, which flax sows. Not ported yet: ``pipeline_stages`` (raises
``NotImplementedError``, see ROADMAP.md). ``seq_parallel`` is accepted and does nothing on
one device, as the JAX package's ``seq_shard`` off a tensor-parallel mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import Dense, Embed, LayerNorm
from lightning_generative_models_tpu_torch.models.modules.moe import MoEMlp
from lightning_generative_models_tpu_torch.models.modules.time_embedding import (
    SinusoidalPosEmb,
)
from lightning_generative_models_tpu_torch.ops.attention import (
    attention_qkv_plain,
    fused_attention_qkv,
    scaled_dot_product_attention,
)


def posemb_sincos_2d(h: int, w: int, dim: int) -> np.ndarray:
    """Fixed 2D sin-cos positional table [h*w, dim] (DiT/MAE convention): dim/2 encodes
    the row index, dim/2 the column, each as sin||cos over log-spaced frequencies."""
    if dim % 4:
        raise ValueError(f"posemb_sincos_2d needs dim % 4 == 0, got {dim}")
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))
    yy, xx = np.mgrid[:h, :w]
    out = np.concatenate(
        [
            np.sin(yy.reshape(-1, 1) * omega),
            np.cos(yy.reshape(-1, 1) * omega),
            np.sin(xx.reshape(-1, 1) * omega),
            np.cos(xx.reshape(-1, 1) * omega),
        ],
        axis=1,
    )
    return out.astype(np.float32)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1 + scale) + shift, broadcast over tokens."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning: the LayerNorms carry no
    affine; shift, scale and gate of both branches come from a zero-initialised Dense of
    SiLU(c), so the block is the identity at init. With ``num_experts > 0`` the MLP is a
    top-1 ``MoEMlp``; ``forward`` returns the block's output and its MoE load-balancing
    loss (None for a dense MLP)."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float = 4.0, flash: bool = False,
                 dtype: torch.dtype = torch.float32, qkv_layout: str = "s3hd",
                 einsum_attn: bool = False, num_experts: int = 0,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.heads = heads
        self.flash = flash
        self.dtype = dtype
        self.qkv_layout = qkv_layout
        self.einsum_attn = einsum_attn
        mlp_dim = int(hidden * mlp_ratio)
        # Registered in the flax module's order of creation.
        self.adaLN_modulation = Dense(hidden, 6 * hidden, zero_init=True)
        self.norm1 = LayerNorm()
        self.qkv = Dense(hidden, 3 * hidden, dtype)
        self.proj = Dense(hidden, hidden, dtype)
        self.norm2 = LayerNorm()
        if num_experts > 0:
            self.moe = MoEMlp(hidden, mlp_dim, num_experts, capacity_factor, dtype)
        else:
            self.moe = None
            self.fc1 = Dense(hidden, mlp_dim, dtype)
            self.fc2 = Dense(mlp_dim, hidden, dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        mod = self.adaLN_modulation(F.silu(c))
        sh_a, sc_a, gate_a, sh_m, sc_m, gate_m = mod.chunk(6, dim=-1)

        h = modulate(self.norm1(x), sh_a, sc_a).to(self.dtype)
        qkv = self.qkv(h)
        if self.flash:
            att = self._flash_attention(qkv)
        else:
            attend = attention_qkv_plain if self.einsum_attn else fused_attention_qkv
            att = attend(qkv, self.heads, self.qkv_layout)
        att = self.proj(att)
        x = x + gate_a[:, None, :].to(x.dtype) * att.to(x.dtype)

        h = modulate(self.norm2(x), sh_m, sc_m).to(self.dtype)
        aux = None
        if self.moe is not None:
            h, aux = self.moe(h)
        else:
            h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
        return x + gate_m[:, None, :].to(x.dtype) * h.to(x.dtype), aux

    def _flash_attention(self, qkv: torch.Tensor) -> torch.Tensor:
        """The JAX block's flash branch: [b, h, n, d] views of q, k and v in the packed
        qkv, the SDPA dispatcher, and the output back to [b, n, h*d]."""
        b, n, w3 = qkv.shape
        d = w3 // (3 * self.heads)
        if self.qkv_layout == "h3d":
            qkv5 = qkv.reshape(b, n, self.heads, 3, d)
            q, k, v = (qkv5[..., i, :].transpose(1, 2) for i in range(3))
        else:
            qkv5 = qkv.reshape(b, n, 3, self.heads, d)
            q, k, v = (qkv5[:, :, i].transpose(1, 2) for i in range(3))
        att = scaled_dot_product_attention(q, k, v, use_pallas=True)
        return att.transpose(1, 2).reshape(b, n, self.heads * d)


class DiT(nn.Module):
    """Diffusion Transformer denoiser, NHWC in and out. ``hidden``/``depth``/``heads``
    select the scale (DiT-S = 384/12/6), ``patch_size`` the token granularity."""

    def __init__(
        self,
        hidden: int = 384,
        depth: int = 12,
        heads: int = 6,
        patch_size: int = 2,
        channels: int = 3,
        mlp_ratio: float = 4.0,
        num_classes: Optional[int] = None,
        out_channels: Optional[int] = None,
        flash_attn: bool = False,
        dtype: torch.dtype = torch.float32,
        qkv_layout: str = "s3hd",
        seq_parallel: bool = False,
        num_experts: int = 0,
        capacity_factor: float = 1.25,
        moe_every: int = 2,
        pipeline_stages: int = 0,
        pipeline_microbatches: int = 0,
        einsum_attn: bool = False,
        pp_fused_attn: bool = False,
    ):
        """The JAX module's fields. ``seq_parallel``, ``pipeline_microbatches`` and
        ``pp_fused_attn`` change nothing on one device without pipeline stages; block i
        is MoE when ``num_experts > 0`` and ``(depth - 1 - i) % moe_every == 0``, so the
        last block always is."""
        super().__init__()
        if pipeline_stages > 0:
            raise NotImplementedError(
                "DiT(pipeline_stages > 0) is not yet ported to the PyTorch package; "
                "see ROADMAP.md")
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        self.hidden = hidden
        self.heads = heads
        self.patch_size = patch_size
        self.channels = channels
        self.num_classes = num_classes
        self.output_channels = out_channels or channels
        self.dtype = dtype
        self.num_experts = num_experts
        p = patch_size

        self.patch_embed = Dense(p * p * channels, hidden, dtype)
        self.time_emb = SinusoidalPosEmb(256)
        self.t_fc1 = Dense(256, hidden)
        self.t_fc2 = Dense(hidden, hidden)
        if num_classes is not None:
            self.class_emb = Embed(num_classes + 1, hidden, std=0.02)
        self.blocks = []
        for i in range(depth):
            moe_here = num_experts > 0 and (depth - 1 - i) % moe_every == 0
            block = DiTBlock(hidden, heads, mlp_ratio, flash_attn, dtype, qkv_layout,
                             einsum_attn, num_experts if moe_here else 0, capacity_factor)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.final_modulation = Dense(hidden, 2 * hidden, zero_init=True)
        self.final_norm = LayerNorm()
        self.head = Dense(hidden, p * p * self.output_channels, zero_init=True)
        self._pos: Dict[Tuple, torch.Tensor] = {}

    @property
    def null_class(self) -> int:
        """Label value meaning 'unconditional' when ``num_classes`` is set."""
        if self.num_classes is None:
            raise ValueError("null_class needs DiT(num_classes=...)")
        return self.num_classes

    def _positions(self, gh: int, gw: int, device: torch.device) -> torch.Tensor:
        key = (gh, gw, device)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(posemb_sincos_2d(gh, gw, self.hidden)).to(device)
        return self._pos[key]

    def forward(
        self,
        x: torch.Tensor,
        time: torch.Tensor,
        x_self_cond: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        return_aux: bool = False,
    ):
        """x: [B, H, W, C], time: [B] -> [B, H, W, output_channels] f32; with
        ``return_aux`` also the mean of the MoE layers' load-balancing losses (0 without
        MoE), which the JAX module sows into ``intermediates``."""
        if x_self_cond is not None:
            raise ValueError(
                "DiT does not support self-conditioning; configure the DDPM "
                "with self_condition=False (the default)"
            )
        b, hh, ww, cc = x.shape
        p = self.patch_size
        if hh % p or ww % p:
            raise ValueError(f"image {hh}x{ww} not divisible by patch {p}")
        gh, gw = hh // p, ww // p
        n = gh * gw

        # patchify: [b, h, w, c] -> [b, n, p*p*c] -> Dense
        tok = x.to(self.dtype).reshape(b, gh, p, gw, p, cc)
        tok = tok.permute(0, 1, 3, 2, 4, 5).reshape(b, n, p * p * cc)
        tok = self.patch_embed(tok)
        tok = tok + self._positions(gh, gw, tok.device)[None].to(tok.dtype)

        # conditioning vector: timestep [+ class]
        c = self.t_fc2(F.silu(self.t_fc1(self.time_emb(time))))
        if self.num_classes is not None:
            if labels is None:
                raise ValueError(
                    "DiT(num_classes=...) requires labels; pass "
                    f"torch.full((B,), {self.null_class}) for unconditional"
                )
            c = c + self.class_emb(labels)

        auxes = []
        for block in self.blocks:
            tok, aux = block(tok, c)
            if aux is not None:
                auxes.append(aux)

        # final layer: adaLN (zero-init) -> zero-init linear head
        shift, scale = self.final_modulation(F.silu(c)).chunk(2, dim=-1)
        out = self.head(modulate(self.final_norm(tok), shift, scale))

        # unpatchify: [b, n, p*p*co] -> [b, h, w, co]
        co = self.output_channels
        out = out.reshape(b, gh, gw, p, p, co).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, hh, ww, co).float()
        if not return_aux:
            return out
        return out, (torch.stack(auxes).mean() if auxes else out.new_zeros(()))
