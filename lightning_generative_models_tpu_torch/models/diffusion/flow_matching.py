"""Flow matching / rectified flow on the DDPM machinery.

Counterpart of ``lightning_generative_models_tpu/models/diffusion/flow_matching.py``:
the linear path x_t = (1 - t) x0 + t eps with the velocity target eps - x0 (t = 0 data,
t = 1 noise), uniform or logit-normal training times, and the deterministic ODE solvers
euler, midpoint and heun (Euler on the final node) integrating dx/dt = v from t = 1 to
0. The network sees ``t * time_scale``. ``FlowMatching`` is the port's ``DDPM`` with
this process in place of ``GaussianDiffusion``: the backbone (UNet or DiT), Adam, the
EMA, classifier-free guidance, the trainer protocol and the parameter tree are DDPM's.

The JAX samplers are one ``lax.scan`` over a host-computed node table; here a Python
loop over the same f32 table, with the per-step scalars in f32 as the scan has them.
The random draws come from an explicit ``torch.Generator``, or are passed in (``t`` and
``noise`` for ``p_losses``, ``x_T`` for ``sample``), so that a test can hand both
implementations the same numbers. ``interpolate`` and ``LatentFlowMatching`` are not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.models.diffusion.gaussian_diffusion import ApplyFn
from lightning_generative_models_tpu_torch.ops.common import resolve_device

SOLVERS = ("euler", "midpoint", "heun")
TIME_SAMPLERS = ("uniform", "logit_normal")


class RectifiedFlow:
    """Linear-path conditional flow matching, with the ``p_losses``/``sample`` surface of
    ``GaussianDiffusion``."""

    def __init__(
        self,
        img_size: int,
        channels: int = 3,
        sampling_steps: int = 50,
        solver: str = "euler",
        time_sampling: str = "uniform",
        logit_normal_mean: float = 0.0,
        logit_normal_std: float = 1.0,
        time_scale: float = 1000.0,
        auto_normalize: bool = True,
        device: str | torch.device = "cuda",
    ):
        if solver not in SOLVERS:
            raise ValueError(f"unknown flow solver {solver!r}; pick from {SOLVERS}")
        if time_sampling not in TIME_SAMPLERS:
            raise ValueError(
                f"unknown time_sampling {time_sampling!r}; pick from {TIME_SAMPLERS}"
            )
        self.device = resolve_device(device)
        self.img_size = img_size
        self.channels = channels
        self.sampling_steps = int(sampling_steps)
        self.solver = solver
        self.time_sampling = time_sampling
        self.logit_normal_mean = logit_normal_mean
        self.logit_normal_std = logit_normal_std
        self.time_scale = float(time_scale)
        self.auto_normalize = auto_normalize

    # -- normalization ([0,1] <-> [-1,1]) --------------------------------------
    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * 2.0 - 1.0 if self.auto_normalize else x

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0) if self.auto_normalize else x

    # -- training ---------------------------------------------------------------
    def _sample_times(self, generator: Optional[torch.Generator], b: int,
                      device: torch.device) -> torch.Tensor:
        if self.time_sampling == "logit_normal":
            z = torch.randn(b, generator=generator, device=device)
            return torch.sigmoid(self.logit_normal_mean + self.logit_normal_std * z)
        return torch.rand(b, generator=generator, device=device)

    def p_losses(
        self,
        apply_fn: ApplyFn,
        x_start01: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Conditional flow-matching MSE on a [0, 1] image batch: the network at
        x_t = (1 - t) x0 + t eps regresses the path velocity eps - x0. ``t`` [B] in
        [0, 1] and ``noise`` (the batch's shape) are drawn from ``generator`` (t first)
        when not given."""
        b = x_start01.shape[0]
        dev = x_start01.device
        x0 = self.normalize(x_start01)
        t = (self._sample_times(generator, b, dev) if t is None else t).to(dev, torch.float32)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=dev)
        noise = noise.to(dev, torch.float32)
        t_b = t.reshape(b, *((1,) * (x0.dim() - 1)))
        x_t = (1.0 - t_b) * x0 + t_b * noise
        out = apply_fn(x_t, t * self.time_scale, None)
        return torch.mean((out - (noise - x0)) ** 2)

    # -- sampling ---------------------------------------------------------------
    def _integrate(self, apply_fn: ApplyFn, x: torch.Tensor, t_start: float, method: str,
                   steps: int) -> torch.Tensor:
        """Integrate dx/dt = v from ``t_start`` to 0 over ``steps`` uniform nodes. Heun's
        last step is Euler's (its corrector would need v at t = 0); the JAX scan still
        evaluates that corrector and discards it, the port skips it."""
        b = x.shape[0]
        ts = np.linspace(float(t_start), 0.0, steps + 1).astype(np.float32)
        half = np.float32(0.5)

        def eval_v(xi, t):
            tt = torch.full((b,), float(t), dtype=torch.float32, device=xi.device)
            return apply_fn(xi, tt * self.time_scale, None)

        for i in range(steps):
            t, t_next = ts[i], ts[i + 1]
            dt = np.float32(t_next - t)
            v1 = eval_v(x, t)
            if method == "euler":
                x = x + float(dt) * v1
            elif method == "midpoint":
                half_dt = np.float32(half * dt)
                x_mid = x + float(half_dt) * v1
                x = x + float(dt) * eval_v(x_mid, np.float32(t + half_dt))
            else:  # heun
                x_e = x + float(dt) * v1
                if i == steps - 1:
                    x = x_e
                else:
                    v2 = eval_v(x_e, t_next)
                    x = x + float(np.float32(half * dt)) * (v1 + v2)
        return x

    def sample(
        self,
        apply_fn: ApplyFn,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        method: Optional[str] = None,
        steps: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Deterministic ODE sampling from x(1) = ``x_T`` (drawn from ``generator``
        when None). ``method`` picks the solver (default: the configured one); the
        diffusion samplers' names are refused with JAX's message."""
        method = method or self.solver
        if method not in SOLVERS:
            raise ValueError(
                f"unknown flow sampling method {method!r}; flow-matching "
                f"models use {SOLVERS} (not ddpm/ddim/dpmpp)"
            )
        steps = steps or self.sampling_steps
        shape = (batch_size, self.img_size, self.img_size, self.channels)
        if x_T is None:
            x = torch.randn(shape, generator=generator, device=self.device)
        elif tuple(x_T.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected {shape}")
        else:
            x = x_T.to(self.device, torch.float32)
        return self.unnormalize(self._integrate(apply_fn, x, 1.0, method, steps))

    def interpolate(self, *args, **kwargs):
        raise NotImplementedError(
            "RectifiedFlow.interpolate is not yet ported to the PyTorch package; "
            "see ROADMAP.md")


class FlowMatching(DDPM):
    """Rectified-flow model: the DDPM's backbone, Adam and EMA weights, with
    ``RectifiedFlow`` as its process. The JAX constructor's arguments, plus ``device``;
    the rest (``network``, the DiT's shape, ...) pass through to ``DDPM``."""

    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        dim: int = 64,
        sampling_steps: int = 50,
        solver: str = "euler",
        time_sampling: str = "logit_normal",
        logit_normal_mean: float = 0.0,
        logit_normal_std: float = 1.0,
        time_scale: float = 1000.0,
        lr: float = 2e-5,
        betas: Tuple[float, float] = (0.9, 0.99),
        ema_update_every: int = 10,
        ema_decay: float = 0.995,
        ema_update_after_step: int = 100,
        use_bf16: bool = True,
        flash_attn: bool = False,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
        num_classes: Optional[int] = None,
        cond_drop_prob: float = 0.1,
        guidance_scale: float = 3.0,
        device: str | torch.device = "cuda",
        **network_kwargs,
    ):
        super().__init__(
            img_channels=img_channels,
            img_size=img_size,
            dim=dim,
            lr=lr,
            betas=betas,
            ema_update_every=ema_update_every,
            ema_decay=ema_decay,
            ema_update_after_step=ema_update_after_step,
            self_condition=False,
            use_bf16=use_bf16,
            flash_attn=flash_attn,
            dim_mults=dim_mults,
            num_classes=num_classes,
            cond_drop_prob=cond_drop_prob,
            guidance_scale=guidance_scale,
            device=device,
            **network_kwargs,
        )
        self.diffusion = RectifiedFlow(
            img_size=img_size,
            channels=img_channels,
            sampling_steps=sampling_steps,
            solver=solver,
            time_sampling=time_sampling,
            logit_normal_mean=logit_normal_mean,
            logit_normal_std=logit_normal_std,
            time_scale=time_scale,
            device=self.device,
        )
