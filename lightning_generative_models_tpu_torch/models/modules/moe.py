"""Mixture-of-Experts MLP: Switch-style top-1 routing with GShard's one-hot dispatch.

Counterpart of ``lightning_generative_models_tpu/models/modules/moe.py``. The router is a
``Dense`` in f32 on ``x.float()``; its softmax gives each token a gate (the largest
probability) and an expert (the first maximum, as ``jnp.argmax``). The Switch
load-balancing loss ``e * sum_e(f_e * P_e)`` (f: the share of tokens routed to expert e,
P: its mean router probability; 1.0 at perfect balance) is taken before any token is
dropped. A token's slot in its expert is its rank among the tokens of its batch row that
chose that expert (a cumulative sum over the token axis); each expert takes
``cap = ceil(n * capacity_factor / e)`` tokens a row, and a token past that is dropped:
its output is exactly zero (the block's skip connection carries it). Dispatch and
combine are JAX's two one-hot einsums, plain products on the card. The expert weights
are expert-major, as flax keeps them: ``wi [e, d, f]``, ``bi [e, f]``, ``wo [e, f, d]``,
``bo [e, d]``. The forward returns ``(out, aux)``: the aux loss is handed back, where
flax sows it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import Dense, normal_


class MoEMlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, num_experts: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = Dense(hidden, num_experts)
        self.wi = nn.Parameter(torch.empty(num_experts, hidden, mlp_dim))
        self.bi = nn.Parameter(torch.zeros(num_experts, mlp_dim))
        self.wo = nn.Parameter(torch.empty(num_experts, mlp_dim, hidden))
        self.bo = nn.Parameter(torch.zeros(num_experts, hidden))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's lecun_normal on a 3-d kernel counts the expert axis into the fan-in.
        for w in (self.wi, self.wo):
            normal_(w, (w.shape[0] * w.shape[1]) ** -0.5, generator)
        self.bi.data.zero_()
        self.bo.data.zero_()

    def capacity(self, n: int) -> int:
        return max(1, math.ceil(n * self.capacity_factor / self.num_experts))

    def route(self, x: torch.Tensor):
        """Router probabilities [b, n, e] (f32) and each token's expert [b, n]."""
        probs = torch.softmax(self.router(x.float()), dim=-1)
        return probs, probs.argmax(dim=-1)

    def dispatch(self, probs: torch.Tensor, choice: torch.Tensor):
        """(dispatch [b, n, e, cap] one-hot f32, combine = dispatch * gate, aux loss)."""
        b, n, e = probs.shape
        cap = self.capacity(n)
        onehot = F.one_hot(choice, e).float()
        gate = probs.gather(-1, choice[..., None])[..., 0]
        aux = e * torch.sum(onehot.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
        # 0-based rank of each token within its expert; a rank >= cap matches no slot.
        slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1).long() - 1
        slots = torch.arange(cap, device=probs.device)
        dispatch = (slot[..., None] == slots).float()[:, :, None, :] * onehot[..., None]
        return dispatch, dispatch * gate[:, :, None, None], aux

    def forward(self, x: torch.Tensor):
        """x [b, n, d] -> (out [b, n, d] in ``dtype``, the load-balancing loss)."""
        probs, choice = self.route(x)
        dispatch, combine, aux = self.dispatch(probs, choice)
        dt = self.dtype
        xin = torch.einsum("bnec,bnd->ebcd", dispatch.to(dt), x.to(dt))
        h = torch.einsum("ebcd,edf->ebcf", xin, self.wi.to(dt))
        h = F.gelu(h + self.bi.to(dt)[:, None, None, :], approximate="tanh")
        out = torch.einsum("ebcf,efd->ebcd", h, self.wo.to(dt))
        out = out + self.bo.to(dt)[:, None, None, :]
        return torch.einsum("bnec,ebcd->bnd", combine.to(dt), out), aux
