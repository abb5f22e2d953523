"""EDM: the Karras et al. 2022 diffusion formulation (arXiv:2206.00364).

Counterpart of ``lightning_generative_models_tpu/models/diffusion/edm.py``: the
preconditioned denoiser D(x; sigma) = c_skip x + c_out F(c_in x, c_noise) with
c_skip = sd^2 / (sigma^2 + sd^2), c_out = sigma sd / sqrt(sigma^2 + sd^2),
c_in = 1 / sqrt(sigma^2 + sd^2), c_noise = ln(sigma) / 4 (sd = sigma_data); the training
loss in its weight-free form, a plain MSE of F against (x0 - c_skip x_t) / c_out at a
log-normal sigma; and Algorithm 2, Heun's (or Euler's) method on the probability-flow ODE
down the rho-warped sigma grid, with optional stochastic churn. The network sees
``c_noise * time_scale``.

The JAX sampler is one ``lax.scan`` over a host-computed f32 node table (sigma,
sigma_next, gamma, is_last); here a Python loop over the same table, with the per-step
scalars in f32 as the scan has them. JAX's scan evaluates Heun's corrector on the last
step too (at a clamped sigma) and drops it through a ``where``; the port skips it, so
Heun-N runs 2N - 1 network evaluations and gives the same result. The random draws come
from an explicit ``torch.Generator`` or are passed in: ``p_losses``' normal behind the
log-normal sigma and its noise, ``sample``'s start ``x_T`` and the churn noise of every
step (``noise_fn``), which JAX draws on every step whether the churn uses it or not.

``EDM`` is the port's ``DDPM`` with this process in place of ``GaussianDiffusion``;
``LatentEDM`` runs it in a frozen autoencoder's latent space (``LatentDiffusion``'s
hooks). ``interpolate`` blends two images at sigma(t) and integrates down the truncated
grid, its two noises and churn noises passed in or drawn.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.models.diffusion.gaussian_diffusion import (
    ApplyFn,
    NoiseFn,
    normal_draw,
)
from lightning_generative_models_tpu_torch.models.diffusion.latent_diffusion import (
    LatentDiffusion,
)
from lightning_generative_models_tpu_torch.ops.common import resolve_device

SOLVERS = ("heun", "euler")


def batch_view(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """[b] -> [b, 1, 1, 1] for an image batch of ``ndim`` axes."""
    return c.reshape(-1, *((1,) * (ndim - 1)))


class EDMProcess:
    """Karras preconditioned diffusion, with the ``p_losses``/``sample`` surface of
    ``GaussianDiffusion``. ``sigma_data`` should match the data's per-channel std: 0.5
    for [-1, 1] images, about 1 for unit-variance latents."""

    def __init__(
        self,
        img_size: int,
        channels: int = 3,
        sampling_steps: int = 18,
        solver: str = "heun",
        sigma_data: float = 0.5,
        p_mean: float = -1.2,
        p_std: float = 1.2,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        s_noise: float = 1.0,
        time_scale: float = 250.0,
        auto_normalize: bool = True,
        device: str | torch.device = "cuda",
    ):
        if solver not in SOLVERS:
            raise ValueError(f"unknown EDM solver {solver!r}; pick from {SOLVERS}")
        if sigma_min <= 0 or sigma_max <= sigma_min:
            raise ValueError("need 0 < sigma_min < sigma_max")
        self.device = resolve_device(device)
        self.img_size = img_size
        self.channels = channels
        self.sampling_steps = int(sampling_steps)
        self.solver = solver
        self.sigma_data = float(sigma_data)
        self.p_mean = float(p_mean)
        self.p_std = float(p_std)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)
        self.s_churn = float(s_churn)
        self.s_tmin = float(s_tmin)
        self.s_tmax = float(s_tmax)
        self.s_noise = float(s_noise)
        # c_noise = ln(sigma) / 4 spans only ~[-1.55, 1.10]: time_scale stretches it into
        # the band the sinusoidal embedding was built for.
        self.time_scale = float(time_scale)
        self.auto_normalize = auto_normalize

    # -- normalization ([0,1] <-> [-1,1]) --------------------------------------
    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * 2.0 - 1.0 if self.auto_normalize else x

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0) if self.auto_normalize else x

    # -- preconditioning ------------------------------------------------------
    def coeffs(self, sigma: torch.Tensor):
        """(c_skip, c_out, c_in, c_noise) at ``sigma`` (elementwise)."""
        sd2 = self.sigma_data**2
        denom = sigma**2 + sd2
        c_skip = sd2 / denom
        c_out = sigma * self.sigma_data / torch.sqrt(denom)
        c_in = 1.0 / torch.sqrt(denom)
        c_noise = torch.log(sigma) / 4.0
        return c_skip, c_out, c_in, c_noise

    def _denoise(self, apply_fn: ApplyFn, x: torch.Tensor, sigma: torch.Tensor):
        """D(x; sigma): the preconditioned denoiser. ``sigma`` is [b]."""
        c_skip, c_out, c_in, c_noise = self.coeffs(sigma)
        f = apply_fn(batch_view(c_in, x.dim()) * x, c_noise * self.time_scale, None)
        return batch_view(c_skip, x.dim()) * x + batch_view(c_out, x.dim()) * f

    # -- training ---------------------------------------------------------------
    def p_losses(
        self,
        apply_fn: ApplyFn,
        x_start01: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        sigma_normal: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """EDM training loss (Eq. 8) on a [0, 1] batch, in its weight-free form: a plain
        MSE of the raw network output F against (x0 - c_skip x_t) / c_out. ``sigma_normal``
        [B] is the standard normal behind sigma = exp(p_mean + p_std sigma_normal), and
        ``noise`` has the batch's shape; each is drawn from ``generator`` (sigma's first)
        when not given."""
        b = x_start01.shape[0]
        dev = x_start01.device
        x0 = self.normalize(x_start01)
        if sigma_normal is None:
            sigma_normal = torch.randn(b, generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=dev)
        sigma = torch.exp(self.p_mean + self.p_std * sigma_normal.to(dev, torch.float32))
        x_t = x0 + batch_view(sigma, x0.dim()) * noise.to(dev, torch.float32)
        c_skip, c_out, c_in, c_noise = self.coeffs(sigma)
        f = apply_fn(batch_view(c_in, x0.dim()) * x_t, c_noise * self.time_scale, None)
        target = (x0 - batch_view(c_skip, x0.dim()) * x_t) / batch_view(c_out, x0.dim())
        return torch.mean((f - target) ** 2)

    # -- sampling ---------------------------------------------------------------
    def sigma_grid(self, steps: int, sigma_start: Optional[float] = None) -> np.ndarray:
        """The rho-warped sigma nodes (Eq. 5) in float64 on the host, with 0 appended."""
        hi = self.sigma_max if sigma_start is None else float(sigma_start)
        if steps <= 1:
            return np.asarray([hi, 0.0], np.float64)
        inv = 1.0 / self.rho
        i = np.arange(steps, dtype=np.float64)
        sig = (hi**inv + i / (steps - 1) * (self.sigma_min**inv - hi**inv)) ** self.rho
        return np.append(sig, 0.0)

    def _integrate(self, apply_fn: ApplyFn, x: torch.Tensor, sigmas: np.ndarray,
                   generator: Optional[torch.Generator], method: str,
                   noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
        """Algorithm 2 over the node table: ``method='euler'`` one evaluation a step,
        'heun' two but on the last step (2N - 1). Step i's churn noise is
        ``noise_fn(i, shape)``, or a draw from ``generator``; it is drawn on every step,
        and at gamma = 0 (no churn) it adds exactly 0."""
        b = x.shape[0]
        n = len(sigmas) - 1
        gammas = np.where(
            (sigmas[:-1] >= self.s_tmin) & (sigmas[:-1] <= self.s_tmax),
            min(self.s_churn / max(n, 1), math.sqrt(2.0) - 1.0),
            0.0,
        )
        rows = np.stack([sigmas[:-1], sigmas[1:], gammas], axis=1).astype(np.float32)
        one, half = np.float32(1.0), np.float32(0.5)

        def denoise(xi, sig):
            return self._denoise(apply_fn, xi, torch.full((b,), float(sig),
                                                          dtype=torch.float32,
                                                          device=xi.device))

        for i, (sig, sig_next, gamma) in enumerate(rows):
            sig_hat = np.float32(sig * (one + gamma))
            lift = float(np.sqrt(np.maximum(np.float32(sig_hat * sig_hat - sig * sig),
                                            np.float32(0.0))))
            eps = (noise_fn(i, tuple(x.shape)) if noise_fn is not None
                   else torch.randn(x.shape, generator=generator, device=x.device))
            x_hat = x + lift * (self.s_noise * eps.to(x.device, torch.float32))
            d = (x_hat - denoise(x_hat, sig_hat)) / float(sig_hat)
            x_e = x_hat + float(np.float32(sig_next - sig_hat)) * d
            if method == "euler" or i == n - 1:
                x = x_e
                continue
            d2 = (x_e - denoise(x_e, sig_next)) / float(sig_next)
            x = x_hat + float(np.float32(np.float32(sig_next - sig_hat) * half)) * (d + d2)
        return x

    def sample(
        self,
        apply_fn: ApplyFn,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        method: Optional[str] = None,
        steps: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
        noise_fn: Optional[NoiseFn] = None,
    ) -> torch.Tensor:
        """Sample from x = sigma_max x_T down the sigma grid. ``x_T`` is the standard
        normal draw (drawn from ``generator`` when None), ``noise_fn`` the churn noise
        (see ``_integrate``). The diffusion and flow samplers' names are refused with
        JAX's message."""
        method = method or self.solver
        if method not in SOLVERS:
            raise ValueError(
                f"unknown EDM sampling method {method!r}; EDM models use "
                f"{SOLVERS} (not ddpm/ddim/dpmpp/midpoint)"
            )
        steps = steps or self.sampling_steps
        shape = (batch_size, self.img_size, self.img_size, self.channels)
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=self.device)
        elif tuple(x_T.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected {shape}")
        x = self.sigma_max * x_T.to(self.device, torch.float32)
        return self.unnormalize(
            self._integrate(apply_fn, x, self.sigma_grid(steps), generator, method, noise_fn))

    def sigma_at(self, t: float) -> float:
        """sigma(t) = exp(lerp(ln sigma_min, ln sigma_max, t)), in float64."""
        return math.exp((1.0 - t) * math.log(self.sigma_min) + t * math.log(self.sigma_max))

    def interpolate(
        self,
        apply_fn: ApplyFn,
        x1_01: torch.Tensor,
        x2_01: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        t: Optional[float] = None,
        lam=0.5,
        noise1: Optional[torch.Tensor] = None,
        noise2: Optional[torch.Tensor] = None,
        noise_fn: Optional[NoiseFn] = None,
    ) -> torch.Tensor:
        """Push both [0, 1] batches to ``sigma_at(t)`` (default t 0.9, in (0, 1]) with
        independent noises ``noise1`` and ``noise2``, blend them by ``lam`` (a float or a
        [N, 1, 1, 1] tensor), and integrate back down the rho grid truncated at that
        sigma, over ``max(1, round(sampling_steps t))`` steps of the configured solver,
        step i's churn noise ``noise_fn(i, shape)`` (JAX ``interpolate``). Each draw
        comes from ``generator`` when not given."""
        t = 0.9 if t is None else float(t)
        if not 0.0 < t <= 1.0:
            raise ValueError(f"EDM interpolation time must be in (0, 1], got {t}")
        sigma_t = self.sigma_at(t)
        shape = tuple(x1_01.shape)
        noise1 = normal_draw(noise1, shape, generator, self.device)
        noise2 = normal_draw(noise2, shape, generator, self.device)
        z1 = self.normalize(x1_01.to(self.device, torch.float32)) + sigma_t * noise1
        z2 = self.normalize(x2_01.to(self.device, torch.float32)) + sigma_t * noise2
        x = (1 - lam) * z1 + lam * z2
        steps = max(1, int(round(self.sampling_steps * t)))
        sigmas = self.sigma_grid(steps, sigma_start=sigma_t)
        return self.unnormalize(
            self._integrate(apply_fn, x, sigmas, generator, self.solver, noise_fn))


class EDM(DDPM):
    """EDM model: the DDPM's backbone, Adam and EMA weights, with ``EDMProcess`` as its
    process. The JAX constructor's arguments, plus ``device``; the rest pass through to
    ``DDPM``. Train steps take ``sigma_normal`` and ``noise`` as their loss draws."""

    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        dim: int = 64,
        sampling_steps: int = 18,
        solver: str = "heun",
        sigma_data: float = 0.5,
        p_mean: float = -1.2,
        p_std: float = 1.2,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        s_noise: float = 1.0,
        time_scale: float = 250.0,
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
        self.diffusion = EDMProcess(
            img_size=img_size,
            channels=img_channels,
            sampling_steps=sampling_steps,
            solver=solver,
            sigma_data=sigma_data,
            p_mean=p_mean,
            p_std=p_std,
            sigma_min=sigma_min,
            sigma_max=sigma_max,
            rho=rho,
            s_churn=s_churn,
            s_tmin=s_tmin,
            s_tmax=s_tmax,
            s_noise=s_noise,
            time_scale=time_scale,
            device=self.device,
        )


class LatentEDM(LatentDiffusion):
    """EDM in a frozen VQ autoencoder's latent space: ``LatentDiffusion``'s hooks with
    ``EDMProcess`` (``auto_normalize=False``; ``sigma_data`` 1 for latents scaled to
    about unit variance). The JAX constructor's arguments, plus ``device``."""

    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        autoencoder: Optional[dict] = None,
        latent_scale: float = 1.0,
        dim_mults=(1, 2, 4),
        sampling_steps: int = 18,
        solver: str = "heun",
        sigma_data: float = 1.0,
        p_mean: float = -1.2,
        p_std: float = 1.2,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        s_noise: float = 1.0,
        time_scale: float = 250.0,
        device: str | torch.device = "cuda",
        **ddpm_kwargs,
    ):
        super().__init__(
            img_channels=img_channels,
            img_size=img_size,
            autoencoder=autoencoder,
            latent_scale=latent_scale,
            dim_mults=dim_mults,
            self_condition=False,
            device=device,
            **ddpm_kwargs,
        )
        self.diffusion = EDMProcess(
            img_size=self.latent_hw,
            channels=self.latent_c,
            sampling_steps=sampling_steps,
            solver=solver,
            sigma_data=sigma_data,
            p_mean=p_mean,
            p_std=p_std,
            sigma_min=sigma_min,
            sigma_max=sigma_max,
            rho=rho,
            s_churn=s_churn,
            s_tmin=s_tmin,
            s_tmax=s_tmax,
            s_noise=s_noise,
            time_scale=time_scale,
            auto_normalize=False,
            device=self.device,
        )
