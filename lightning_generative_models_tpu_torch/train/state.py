"""Optimizer and EMA helpers.

Counterpart of ``lightning_generative_models_tpu/train/state.py``. The JAX package
threads an immutable ``TrainState`` through pure steps; here the model owns its
modules and its optimizer, and the EMA update is in place. ``Adam`` is optax's
``scale_by_adam`` chain written out with foreach ops, its step count on the device (so
that a CUDA graph of k steps replays each step's bias correction), and its moments in
the process-wide dtypes of ``set_default_mu_dtype`` / ``set_default_nu_dtype``
(``--mu_dtype`` / ``--nu_dtype bfloat16``), rounded where optax rounds them. Both
optimizers average the gradients over the ambient mesh's data ranks before they update
(``parallel/mesh.py:grads_for_update``; under ``fsdp`` a large leaf, its gradient and its
moments are this rank's shard), so a model's step on N ranks is one device's on the
global batch.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib

# Process-wide dtypes of Adam's moments, read by ``make_adam`` when a model builds its
# optimizer: None keeps the parameters' dtype (float32), as optax's default does.
_MU_DTYPE: Optional[torch.dtype] = None
_NU_DTYPE: Optional[torch.dtype] = None


def _as_dtype(dtype) -> Optional[torch.dtype]:
    """None, a torch dtype, or its name ("bfloat16", "jnp.bfloat16", ...)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).split(".")[-1]
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"Adam's moments are float32 or bfloat16, got {dtype!r}")
    return getattr(torch, name)


def set_default_mu_dtype(dtype) -> None:
    """Set the process-wide dtype of Adam's first moment (None: the parameters'). Set it
    before the model is built: a model builds its optimizer in its constructor."""
    global _MU_DTYPE
    _MU_DTYPE = _as_dtype(dtype)


def set_default_nu_dtype(dtype) -> None:
    """Set the process-wide dtype of Adam's second moment (None: the parameters')."""
    global _NU_DTYPE
    _NU_DTYPE = _as_dtype(dtype)


def default_mu_dtype() -> Optional[torch.dtype]:
    return _MU_DTYPE


def default_nu_dtype() -> Optional[torch.dtype]:
    return _NU_DTYPE


class Adam(torch.optim.Optimizer):
    """``optax.chain(add_decayed_weights(wd), scale_by_adam(b1, b2, eps, mu_dtype),
    scale(-lr))`` under ``with_nu_dtype(nu_dtype)``, as the JAX package's ``make_adam``
    builds it (optax 0.2.6), on the parameters that have a gradient:

        g <- g + wd p;  mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
        p <- p - lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    Where it rounds is optax's under ``jit``: the stored moment enters in its own dtype,
    times the decay rounded to that dtype (the weak-typed ``b1 * mu``: 0.9 is 0.8984375 in
    bf16, 0.999 is 1), the product and the sum in f32 with the f32 gradient; the update is
    computed from the unrounded f32 moments, which are then stored in their dtypes
    (``mu_dtype``, and ``nu`` cast after the update by ``with_nu_dtype``). The bias
    corrections are f32 on the device, from ``step``, one 0-dim f32 tensor on the
    parameters' device that their states share. The state of a parameter is
    ``{"step", "exp_avg", "exp_avg_sq"}``, as ``torch.optim.Adam``'s; a checkpoint keeps the
    moments' dtypes, and loading one whose moments are of other dtypes raises."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype=None, nu_dtype=None):
        super().__init__(params, {"lr": lr, "betas": (b1, b2), "eps": eps,
                                  "weight_decay": weight_decay})
        self.mu_dtype, self.nu_dtype = _as_dtype(mu_dtype), _as_dtype(nu_dtype)

    def moment_dtypes(self, param: torch.Tensor):
        """(first, second) moment dtypes of ``param``."""
        return self.mu_dtype or param.dtype, self.nu_dtype or param.dtype

    def _shared_step(self, params: list) -> torch.Tensor:
        """The parameters' step count: one 0-dim f32 tensor on their device that every
        state holds (made at 0, or from the count that a checkpoint or a JAX state left
        in the states), and their moments, made at zero where missing in the shape of
        the parameters (under ``fsdp``, a shard)."""
        states = [self.state[p] for p in params]
        found = [s["step"] for s in states if "step" in s]
        step = found[0] if found else None
        if step is None or step.device != params[0].device or step.dtype != torch.float32 \
                or any(f is not step for f in found):
            step = torch.full((), float(step) if found else 0.0, dtype=torch.float32,
                              device=params[0].device)
        for p, s in zip(params, states):
            if "exp_avg" not in s:
                mu_dtype, nu_dtype = self.moment_dtypes(p)
                s["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype)
                s["exp_avg_sq"] = torch.zeros_like(p, dtype=nu_dtype)
            s["step"] = step
        return step

    @staticmethod
    def _decayed(moments: list, decay: float, like: list) -> list:
        """f32 ``decay * moment``, the decay rounded to the moments' dtype."""
        if moments[0].dtype == torch.float32:
            return torch._foreach_mul(moments, decay)
        up = [torch.empty_like(g, dtype=torch.float32) for g in like]
        torch._foreach_copy_(up, moments)
        torch._foreach_mul_(up, float(torch.tensor(decay, dtype=moments[0].dtype)))
        return up

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = mesh_lib.grads_for_update(params)
            step = self._shared_step(params)
            b1, b2 = group["betas"]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            for key, decay, power in (("exp_avg", b1, 1), ("exp_avg_sq", b2, 2)):
                moments = [self.state[p][key] for p in params]
                new = torch._foreach_mul(grads, grads) if power == 2 else list(grads)
                new = torch._foreach_mul(new, 1.0 - decay)
                torch._foreach_add_(new, self._decayed(moments, decay, grads))
                if key == "exp_avg":
                    mu = new
                else:
                    nu = new
            step.add_(1.0)
            update = torch._foreach_div(mu, 1.0 - torch.pow(b1, step))
            denom = torch._foreach_div(nu, 1.0 - torch.pow(b2, step))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(params, update)
            for key, new in (("exp_avg", mu), ("exp_avg_sq", nu)):
                torch._foreach_copy_([self.state[p][key] for p in params], new)

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load, after a check that the moments are of this optimizer's dtypes
        (a resume keeps ``--mu_dtype`` / ``--nu_dtype``); the moments keep them."""
        params = [p for group in self.param_groups for p in group["params"]]
        for i, s in state_dict["state"].items():
            if not 0 <= i < len(params) or "exp_avg" not in s:
                continue
            p = params[i]
            for key, want, flag in zip(("exp_avg", "exp_avg_sq"), self.moment_dtypes(p),
                                       ("--mu_dtype", "--nu_dtype")):
                if s[key].dtype != want:
                    raise ValueError(
                        f"the checkpoint's Adam {key} is {s[key].dtype} but this optimizer "
                        f"keeps it in {want}: resume with the run's {flag}")
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                s = self.state.get(p)
                if s and "exp_avg" in s:
                    mu_dtype, nu_dtype = self.moment_dtypes(p)
                    s["exp_avg"] = s["exp_avg"].to(mu_dtype)
                    s["exp_avg_sq"] = s["exp_avg_sq"].to(nu_dtype)


def make_adam(
    params: Iterable[torch.Tensor],
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    weight_decay: float = 0.0,
) -> Adam:
    """Adam with torch semantics: L2 weight decay added to the gradient before the
    moment update (not AdamW), eps 1e-8, as optax's ``scale_by_adam`` chain; the moments
    in the process-wide dtypes (``set_default_mu_dtype``, ``set_default_nu_dtype``)."""
    return Adam(params, lr, b1, b2, eps=1e-8, weight_decay=weight_decay,
                mu_dtype=_MU_DTYPE, nu_dtype=_NU_DTYPE)


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
            grads = mesh_lib.grads_for_update(params)
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
