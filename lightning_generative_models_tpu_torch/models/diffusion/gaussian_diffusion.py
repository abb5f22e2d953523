"""Gaussian diffusion: schedules and samplers.

Counterpart of ``lightning_generative_models_tpu/models/diffusion/gaussian_diffusion.py``:
linear/cosine/sigmoid beta schedules computed in float64 and stored as f32 buffers;
objectives pred_noise / pred_x0 / pred_v; ancestral DDPM sampling over all T steps;
strided DDIM sampling with eta-scaled noise and clip + rederive; DPM-Solver++(2M).

The JAX samplers are one ``lax.scan`` program each; here each is a Python loop over
the steps, with the per-step scalars computed on the host in f32 as the scan computes
them. Randomness comes from an explicit ``torch.Generator``; every sampler also takes
``x_T``, and ``p_sample_loop`` a per-step ``noise_fn``, so that a test can hand both
implementations the same random numbers.

The model is an ``apply_fn(x, t, self_cond) -> out`` closure. ``p_losses`` is the
training objective; its random draws (t, noise, offset noise, the self-conditioning
coin) can each be passed in. ``interpolate`` blends two images through the chain, its
draws (the two noises, the chain's per-step noise) passed in or drawn.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from lightning_generative_models_tpu_torch.ops.common import resolve_device

ApplyFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
NoiseFn = Callable[[int, tuple], torch.Tensor]


def normal_draw(given: Optional[torch.Tensor], shape: tuple, generator,
                device) -> torch.Tensor:
    """An explicit draw moved to ``device``, or a standard normal one from ``generator``."""
    if given is not None:
        return given.to(device, torch.float32)
    return torch.randn(shape, generator=generator, device=device)


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3, end: float = 3, tau: float = 1.0
) -> np.ndarray:
    def sigmoid(x):
        return 1 / (1 + np.exp(-x))

    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start, v_end = sigmoid(start / tau), sigmoid(end / tau)
    alphas_cumprod = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


BETA_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}

OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] broadcast to an image batch: [B] -> [B, 1, 1, 1]."""
    return a[t].reshape(t.shape[0], *((1,) * (ndim - 1)))


def _f32(v) -> float:
    """v rounded to float32, as a Python float (exact, so it multiplies f32 tensors
    without further rounding)."""
    return float(np.float32(v))


def ddim_times(num_timesteps: int, steps: int) -> list:
    """The strided time nodes [T-1, ..., -1] the DDIM and DPM++ samplers visit."""
    times = np.linspace(-1, num_timesteps - 1, steps + 1)
    return list(reversed(times.astype(int).tolist()))


class GaussianDiffusion:
    def __init__(
        self,
        img_size: int,
        channels: int = 3,
        timesteps: int = 1000,
        sampling_timesteps: Optional[int] = None,
        objective: str = "pred_v",
        beta_schedule: str = "sigmoid",
        schedule_fn_kwargs: Optional[dict] = None,
        ddim_sampling_eta: float = 0.0,
        auto_normalize: bool = True,
        offset_noise_strength: float = 0.0,
        min_snr_loss_weight: bool = False,
        min_snr_gamma: float = 5.0,
        self_condition: bool = False,
        x_start_clip: Optional[float] = 1.0,
        device: str | torch.device = "cuda",
    ):
        """``x_start_clip`` bounds the denoised x0 estimate to [-clip, clip]; ``None``
        disables clipping. ``offset_noise_strength`` and the min-SNR settings shape the
        training loss."""
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; pick one of {OBJECTIVES}")
        if beta_schedule not in BETA_SCHEDULES:
            raise ValueError(f"unknown beta schedule {beta_schedule}")
        self.device = resolve_device(device)
        self.img_size = img_size
        self.channels = channels
        self.objective = objective
        self.self_condition = self_condition
        self.num_timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps or timesteps
        if self.sampling_timesteps > timesteps:
            raise ValueError(
                f"sampling_timesteps {self.sampling_timesteps} > timesteps {timesteps}"
            )
        self.is_ddim_sampling = self.sampling_timesteps < timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        self.offset_noise_strength = offset_noise_strength
        self.min_snr_loss_weight = min_snr_loss_weight
        self.min_snr_gamma = min_snr_gamma
        self.auto_normalize = auto_normalize
        self.x_start_clip = x_start_clip

        # float64 schedule math, f32 buffers.
        betas = BETA_SCHEDULES[beta_schedule](timesteps, **(schedule_fn_kwargs or {}))
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1 - alphas_cumprod_prev) / (1 - alphas_cumprod)
        buffers = {
            "betas": betas,
            "alphas_cumprod": alphas_cumprod,
            "alphas_cumprod_prev": alphas_cumprod_prev,
            "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
            "sqrt_one_minus_alphas_cumprod": np.sqrt(1 - alphas_cumprod),
            "log_one_minus_alphas_cumprod": np.log(1 - alphas_cumprod),
            "sqrt_recip_alphas_cumprod": np.sqrt(1 / alphas_cumprod),
            "sqrt_recipm1_alphas_cumprod": np.sqrt(1 / alphas_cumprod - 1),
            "posterior_variance": posterior_variance,
            "posterior_log_variance_clipped": np.log(np.clip(posterior_variance, 1e-20, None)),
            "posterior_mean_coef1": betas * np.sqrt(alphas_cumprod_prev) / (1 - alphas_cumprod),
            "posterior_mean_coef2": (
                (1 - alphas_cumprod_prev) * np.sqrt(alphas) / (1 - alphas_cumprod)
            ),
        }
        snr = alphas_cumprod / (1 - alphas_cumprod)
        clipped_snr = np.minimum(snr, min_snr_gamma) if min_snr_loss_weight else snr
        buffers["loss_weight"] = {
            "pred_noise": clipped_snr / snr,
            "pred_x0": clipped_snr,
            "pred_v": clipped_snr / (snr + 1),
        }[objective]
        for name, value in buffers.items():
            setattr(self, name, torch.as_tensor(value, dtype=torch.float32, device=self.device))
        # Host copy of the f32 alphas_cumprod for the samplers' per-step scalars.
        self._alphas_cumprod_host = np.asarray(alphas_cumprod, np.float32)

    # -- normalization ([0,1] <-> [-1,1]) --------------------------------------
    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * 2.0 - 1.0 if self.auto_normalize else x

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0) if self.auto_normalize else x

    # -- closed-form conversions ------------------------------------------------
    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.dim()
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise
        )

    def predict_noise_from_start(self, x_t, t, x0):
        nd = x_t.dim()
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0
        ) / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd)

    def predict_v(self, x_start, t, noise):
        nd = x_start.dim()
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * noise
            - _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * x_start
        )

    def predict_start_from_v(self, x_t, t, v):
        nd = x_t.dim()
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_t
            - _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * v
        )

    def q_posterior(self, x_start, x_t, t):
        nd = x_t.dim()
        mean = (
            _extract(self.posterior_mean_coef1, t, nd) * x_start
            + _extract(self.posterior_mean_coef2, t, nd) * x_t
        )
        variance = _extract(self.posterior_variance, t, nd)
        log_variance = _extract(self.posterior_log_variance_clipped, t, nd)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        nd = x_start.dim()
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    # -- model wrappers ------------------------------------------------------------
    def model_predictions(
        self,
        apply_fn: ApplyFn,
        x: torch.Tensor,
        t: torch.Tensor,
        x_self_cond: Optional[torch.Tensor] = None,
        clip_x_start: bool = False,
        rederive_pred_noise: bool = False,
    ) -> ModelPrediction:
        model_output = apply_fn(x, t, x_self_cond)
        bound = self.x_start_clip
        clip_x_start = clip_x_start and bound is not None

        def clip(v):
            return torch.clamp(v, -bound, bound) if clip_x_start else v

        if self.objective == "pred_noise":
            pred_noise = model_output
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
            if clip_x_start and rederive_pred_noise:
                pred_noise = self.predict_noise_from_start(x, t, x_start)
        elif self.objective == "pred_x0":
            x_start = clip(model_output)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v
            x_start = clip(self.predict_start_from_v(x, t, model_output))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return ModelPrediction(pred_noise, x_start)

    def p_mean_variance(self, apply_fn, x, t, x_self_cond=None):
        preds = self.model_predictions(apply_fn, x, t, x_self_cond)
        x_start = preds.pred_x_start
        if self.x_start_clip is not None:
            x_start = torch.clamp(x_start, -self.x_start_clip, self.x_start_clip)
        mean, variance, log_variance = self.q_posterior(x_start, x, t)
        return mean, variance, log_variance, x_start

    # -- training loss -------------------------------------------------------------
    def p_losses(
        self,
        apply_fn: ApplyFn,
        x_start01: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        offset: Optional[torch.Tensor] = None,
        sc_coin: Optional[bool] = None,
    ) -> torch.Tensor:
        """The training objective on a [0, 1] image batch: the loss-weighted mean
        squared error of the objective's target. ``t`` [B], ``noise`` (the batch's
        shape), ``offset`` [B, 1, 1, C] (with offset noise) and ``sc_coin`` (with
        self-conditioning: condition on a no-grad x0 estimate) are drawn from
        ``generator`` when not given."""
        b = x_start01.shape[0]
        dev = x_start01.device
        x_start = self.normalize(x_start01)
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator, device=dev)
        t = t.to(dev).long()
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=dev)
        noise = noise.to(dev, torch.float32)

        if self.offset_noise_strength > 0.0:
            if offset is None:
                offset = torch.randn((b, 1, 1, x_start.shape[-1]), generator=generator,
                                     device=dev)
            noise = noise + self.offset_noise_strength * offset.to(dev, torch.float32)

        x = self.q_sample(x_start, t, noise)

        x_self_cond = None
        if self.self_condition:
            if sc_coin is None:
                # The coin stays on the device and picks between both branches, as JAX's
                # lax.cond does: no host sync, so a CUDA graph can hold the step.
                coin = torch.rand((), generator=generator, device=dev) < 0.5
                with torch.no_grad():
                    x_self_cond = torch.where(
                        coin, self.model_predictions(apply_fn, x, t).pred_x_start,
                        torch.zeros_like(x))
            elif sc_coin:
                with torch.no_grad():
                    x_self_cond = self.model_predictions(apply_fn, x, t).pred_x_start
            else:
                x_self_cond = torch.zeros_like(x)

        model_out = apply_fn(x, t, x_self_cond)

        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)

        loss = torch.mean((model_out - target) ** 2, dim=(1, 2, 3))
        return (loss * self.loss_weight[t]).mean()

    # -- sampling ----------------------------------------------------------------
    def _shape(self, batch_size: int) -> tuple:
        return (batch_size, self.img_size, self.img_size, self.channels)

    def _x_T(self, batch_size, generator, x_T):
        if x_T is not None:
            if tuple(x_T.shape) != self._shape(batch_size):
                raise ValueError(
                    f"x_T has shape {tuple(x_T.shape)}, expected {self._shape(batch_size)}"
                )
            return x_T.to(self.device, torch.float32)
        return torch.randn(self._shape(batch_size), generator=generator, device=self.device)

    def _t(self, batch_size: int, t: int) -> torch.Tensor:
        return torch.full((batch_size,), t, dtype=torch.long, device=self.device)

    def p_sample_loop(
        self,
        apply_fn: ApplyFn,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
        noise_fn: Optional[NoiseFn] = None,
    ) -> torch.Tensor:
        """Ancestral sampling over all T steps. ``noise_fn(t, shape)`` supplies the
        noise of step t (default: normal draws from ``generator``)."""
        shape = self._shape(batch_size)
        img = self._x_T(batch_size, generator, x_T)
        x_start = torch.zeros_like(img)
        for t in range(self.num_timesteps - 1, -1, -1):
            self_cond = x_start if self.self_condition else None
            mean, _, log_var, x_start = self.p_mean_variance(
                apply_fn, img, self._t(batch_size, t), self_cond
            )
            if t > 0:
                noise = (noise_fn(t, shape).to(self.device) if noise_fn is not None
                         else torch.randn(shape, generator=generator, device=self.device))
                img = mean + torch.exp(0.5 * log_var) * noise
            else:
                img = mean
        return self.unnormalize(img)

    def ddim_sample(
        self,
        apply_fn: ApplyFn,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        steps: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        shape = self._shape(batch_size)
        eta = np.float32(self.ddim_sampling_eta)
        times = ddim_times(self.num_timesteps, steps or self.sampling_timesteps)
        ac = self._alphas_cumprod_host
        one = np.float32(1.0)

        img = self._x_T(batch_size, generator, x_T)
        x_start = torch.zeros_like(img)
        for t, t_next in zip(times[:-1], times[1:]):
            self_cond = x_start if self.self_condition else None
            pred_noise, x_start = self.model_predictions(
                apply_fn, img, self._t(batch_size, t), self_cond,
                clip_x_start=True, rederive_pred_noise=True,
            )
            if t_next < 0:  # final step: the prediction itself
                img = x_start
                continue
            alpha, alpha_next = ac[t], ac[t_next]
            sigma = eta * np.sqrt(np.maximum(
                (one - alpha / alpha_next) * (one - alpha_next) / (one - alpha),
                np.float32(0.0)))
            c = np.sqrt(np.maximum(one - alpha_next - sigma * sigma, np.float32(0.0)))
            img = x_start * _f32(np.sqrt(alpha_next)) + _f32(c) * pred_noise
            if sigma > 0:
                noise = torch.randn(shape, generator=generator, device=self.device)
                img = img + _f32(sigma) * noise
        return self.unnormalize(img)

    def dpmpp_sample(
        self,
        apply_fn: ApplyFn,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        steps: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095) on the DDIM nodes;
        deterministic; the final node (t = -1) returns the x0 prediction."""
        times = ddim_times(self.num_timesteps, steps or self.sampling_timesteps)
        ab = np.asarray(self._alphas_cumprod_host, np.float64)
        ab_nodes = np.array([ab[t] if t >= 0 else 1.0 for t in times])
        a_nodes = np.sqrt(ab_nodes)        # VP-ODE alpha_t
        s_nodes = np.sqrt(1.0 - ab_nodes)  # VP-ODE sigma_t
        with np.errstate(divide="ignore"):
            lam_nodes = np.log(a_nodes) - np.log(s_nodes)  # +inf at t = -1, never read
        per_step = np.stack([
            np.array(times[:-1], np.float64),
            np.array(times[1:], np.float64),
            a_nodes[1:],
            s_nodes[:-1],
            s_nodes[1:],
            lam_nodes[:-1],
            np.nan_to_num(lam_nodes[1:], posinf=0.0),
        ], axis=1).astype(np.float32)

        img = self._x_T(batch_size, generator, x_T)
        x0_prev = torch.zeros_like(img)
        lam_prev = np.float32(0.0)
        for i, row in enumerate(per_step):
            t, t_next = int(row[0]), int(row[1])
            a_next, s_t, s_next, lam_t, lam_next = row[2:7]
            self_cond = x0_prev if self.self_condition else None
            _, x0 = self.model_predictions(
                apply_fn, img, self._t(batch_size, t), self_cond, clip_x_start=True
            )
            if t_next < 0:  # final node: the x0 prediction itself
                img = x0
            else:
                h = lam_next - lam_t
                ratio = s_next / s_t
                phi = np.expm1(-h)
                if i == 0:  # first order: DPM-Solver++(1), DDIM with eta 0
                    img = _f32(ratio) * img - _f32(a_next * phi) * x0
                else:  # second-order multistep through the previous node
                    r = (lam_t - lam_prev) / h
                    inv = np.float32(1.0) / (np.float32(2.0) * r)
                    d = _f32(np.float32(1.0) + inv) * x0 - _f32(inv) * x0_prev
                    img = _f32(ratio) * img - _f32(a_next * phi) * d
            x0_prev, lam_prev = x0, lam_t
        return self.unnormalize(img)

    def interpolate(
        self,
        apply_fn: ApplyFn,
        x1_01: torch.Tensor,
        x2_01: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        t: Optional[int] = None,
        lam=0.5,
        noise1: Optional[torch.Tensor] = None,
        noise2: Optional[torch.Tensor] = None,
        noise_fn: Optional[NoiseFn] = None,
    ) -> torch.Tensor:
        """JAX ``interpolate`` (``ddpm.py:847-867`` of the reference): noise both [0, 1]
        batches to step ``t`` (default T - 1) with independent noises ``noise1`` and
        ``noise2``, blend them as ``(1 - lam) x1 + lam x2`` (``lam`` a float or a [N, 1,
        1, 1] tensor), and run the ancestral chain down from step t - 1 with
        self-conditioning; ``noise_fn(i, shape)`` is step i's noise (none at i = 0).
        Each draw comes from ``generator`` when not given."""
        t = self.num_timesteps - 1 if t is None else int(t)
        b = x1_01.shape[0]
        shape = tuple(x1_01.shape)

        noise1 = normal_draw(noise1, shape, generator, self.device)
        noise2 = normal_draw(noise2, shape, generator, self.device)
        t_b = self._t(b, t)
        xt1 = self.q_sample(self.normalize(x1_01.to(self.device, torch.float32)), t_b, noise1)
        xt2 = self.q_sample(self.normalize(x2_01.to(self.device, torch.float32)), t_b, noise2)
        img = (1 - lam) * xt1 + lam * xt2
        x_start = torch.zeros_like(img)
        for i in range(t - 1, -1, -1):
            self_cond = x_start if self.self_condition else None
            mean, _, log_var, x_start = self.p_mean_variance(apply_fn, img, self._t(b, i),
                                                             self_cond)
            if i > 0:
                noise = (noise_fn(i, shape).to(self.device) if noise_fn is not None
                         else torch.randn(shape, generator=generator, device=self.device))
                img = mean + torch.exp(0.5 * log_var) * noise
            else:
                img = mean
        return self.unnormalize(img)

    def sample(
        self,
        apply_fn: ApplyFn,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        method: Optional[str] = None,
        steps: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Dispatch: method None keeps the reference convention, DDIM iff
        sampling_timesteps < timesteps, ancestral otherwise."""
        if method is None:
            method = "ddim" if self.is_ddim_sampling else "ddpm"
        if method == "dpmpp":
            return self.dpmpp_sample(apply_fn, batch_size, generator, steps=steps, x_T=x_T)
        if method == "ddim":
            return self.ddim_sample(apply_fn, batch_size, generator, steps=steps, x_T=x_T)
        if method == "ddpm":
            return self.p_sample_loop(apply_fn, batch_size, generator, x_T=x_T)
        raise ValueError(f"unknown sampling method {method!r}")
