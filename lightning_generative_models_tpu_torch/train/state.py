"""Optimizer and EMA helpers.

Counterpart of ``lightning_generative_models_tpu/train/state.py``. The JAX package
threads an immutable ``TrainState`` through pure steps; here the model owns its
modules and its ``torch.optim`` optimizer, and the EMA update is in place. The opt-in
bf16 Adam moments (``--mu_dtype`` / ``--nu_dtype bfloat16``) are not ported.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn


def _refuse_bf16(which: str, dtype) -> None:
    if dtype is not None and str(dtype).split(".")[-1] not in ("float32",):
        raise NotImplementedError(
            f"Adam's {which} in {dtype} is not ported to the PyTorch package; the "
            "moments stay float32 (see ROADMAP.md)"
        )


def set_default_mu_dtype(dtype: Optional[object]) -> None:
    """Only None / float32 (the moments in the parameters' dtype) is ported."""
    _refuse_bf16("first moment (mu)", dtype)


def set_default_nu_dtype(dtype: Optional[object]) -> None:
    """Only None / float32 (the moments in the parameters' dtype) is ported."""
    _refuse_bf16("second moment (nu)", dtype)


def make_adam(
    params: Iterable[torch.Tensor],
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    weight_decay: float = 0.0,
) -> torch.optim.Adam:
    """Adam with torch semantics: L2 weight decay added to the gradient before the
    moment update (not AdamW), eps 1e-8, as optax's ``scale_by_adam`` chain."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                            weight_decay=weight_decay)


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop(lr, decay, eps)`` as the JAX package builds it (optax 0.2.6: eps
    inside the square root, initial scale 0, no momentum, not centred):
    nu <- decay nu + (1 - decay) g^2, p <- p - lr g / sqrt(nu + eps). torch's RMSprop
    adds eps outside the square root, so the update is written out here, with foreach
    ops over the parameters that have a gradient. The state is ``{"nu": tensor}``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            nus = []
            for p in params:
                if "nu" not in self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
                nus.append(self.state[p]["nu"])
            decay = group["decay"]
            torch._foreach_mul_(nus, decay)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - decay)
            scale = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


def make_rmsprop(params: Iterable[torch.Tensor], lr: float) -> RMSprop:
    """``make_rmsprop`` of the JAX package: decay 0.99, eps 1e-8 inside the square root
    (its docstring says "matching torch defaults"; torch puts eps outside)."""
    return RMSprop(params, lr, decay=0.99, eps=1e-8)


def apply_grads(optimizer: torch.optim.Optimizer, params: list, grads) -> None:
    """One ``optimizer`` step on ``params`` with ``grads`` (None: a zero gradient).
    Contiguous, as the moments are: cuDNN hands back conv grads channels-last, and a
    stride that differs sends Adam's foreach ops down their per-tensor path."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g.contiguous()
    optimizer.step()
    for p in params:
        p.grad = None


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """In place: ema <- decay * ema + (1 - decay) * model, parameter by parameter,
    with decay and 1 - decay in f32 as the JAX step computes them."""
    d32 = np.float32(decay)
    ema_params = [p for p in ema.parameters()]
    new_params = [p.detach() for p in model.parameters()]
    if d32 == 0.0:
        torch._foreach_copy_(ema_params, new_params)
        return
    torch._foreach_mul_(ema_params, float(d32))
    torch._foreach_add_(ema_params, new_params, alpha=float(np.float32(1.0) - d32))


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
