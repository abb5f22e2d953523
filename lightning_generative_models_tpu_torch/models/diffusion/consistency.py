"""Consistency models trained with improved consistency training (iCT).

Counterpart of ``lightning_generative_models_tpu/models/diffusion/consistency.py``
(Song et al. 2023, arXiv:2303.01469; Song & Dhariwal 2023, arXiv:2310.14189), on the EDM
sigma axis:

- the boundary-respecting preconditioning f(x; sigma) = c_skip x + c_out F(c_in x,
  c_noise) with c_skip = sd^2 / ((sigma - sigma_min)^2 + sd^2), c_out = sd (sigma -
  sigma_min) / sqrt(sd^2 + sigma^2), c_in = 1 / sqrt(sd^2 + sigma^2), c_noise =
  ln(sigma) / 4, so that f(x; sigma_min) = x exactly;
- the training loss: a grid index i from the discrete log-normal over the N(k)-interval
  Karras grid, one noise z at both levels sigma_i and sigma_{i+1}, and
  lambda(sigma_i) d(f(x_{i+1}), stopgrad f(x_i)) with lambda = 1 / (sigma_{i+1} -
  sigma_i) and the pseudo-Huber metric d(a, b) = sqrt(||a - b||^2 + c^2) - c;
- the curriculum N(k) = min(s0 2^(k // K'), s1) from the step counter, and the index
  distribution over a static s1-entry table with the dead entries at -inf;
- sampling: f at sigma_max, then per extra level re-noise to tau and map back.

Both network evaluations of the loss are one forward over the doubled batch
[x_{i+1}; x_i], whose target half is detached after the forward: the backward runs over
the doubled batch too, with zeros in the target half, as JAX's ``stop_gradient`` does.
The random draws come from an explicit ``torch.Generator`` or are passed in: the grid
index itself (``index``, the categorical draw: JAX's ``jax.random.categorical`` cannot be
replayed from a seed, so a test hands the port the index JAX drew) and the noise;
``sample``'s start and the re-noising draws; ``interpolate``'s two noises (one
consistency evaluation at sigma(t)).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.models.diffusion.edm import batch_view
from lightning_generative_models_tpu_torch.models.diffusion.gaussian_diffusion import (
    ApplyFn,
    Chain,
    NoiseFn,
    Segment,
    normal_draw,
    rows_on,
    run_chain,
)
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch

SOLVERS = ("onestep", "multistep")


class ConsistencyProcess:
    """iCT consistency process over an ``apply_fn(x, t, self_cond) -> F`` closure, with
    the ``p_losses``/``sample`` surface of ``GaussianDiffusion``. ``curriculum_steps`` K
    should match the planned training length; 0 disables the curriculum (N = s1)."""

    def __init__(
        self,
        img_size: int,
        channels: int = 3,
        sampling_steps: int = 2,
        s0: int = 10,
        s1: int = 1280,
        curriculum_steps: int = 100_000,
        p_mean: float = -1.1,
        p_std: float = 2.0,
        sigma_data: float = 0.5,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        huber_c: Optional[float] = None,
        time_scale: float = 250.0,
        auto_normalize: bool = True,
        device: str | torch.device = "cuda",
    ):
        if sigma_min <= 0 or sigma_max <= sigma_min:
            raise ValueError("need 0 < sigma_min < sigma_max")
        if s0 < 2 or s1 < s0:
            raise ValueError(f"need 2 <= s0 <= s1, got s0={s0}, s1={s1}")
        self.device = resolve_device(device)
        self.img_size = img_size
        self.channels = channels
        self.sampling_steps = int(sampling_steps)
        self.s0 = int(s0)
        self.s1 = int(s1)
        self.curriculum_steps = int(curriculum_steps)
        self.p_mean = float(p_mean)
        self.p_std = float(p_std)
        self.sigma_data = float(sigma_data)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)
        dim = img_size * img_size * channels
        # arXiv:2310.14189 section 3.3: c = 0.00054 sqrt(d) for d data dimensions.
        self.huber_c = 0.00054 * math.sqrt(dim) if huber_c is None else float(huber_c)
        self.time_scale = float(time_scale)
        self.auto_normalize = auto_normalize

    # -- normalization ([0,1] <-> [-1,1]) --------------------------------------
    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * 2.0 - 1.0 if self.auto_normalize else x

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0) if self.auto_normalize else x

    # -- preconditioning ------------------------------------------------------
    def coeffs(self, sigma: torch.Tensor):
        """(c_skip, c_out, c_in, c_noise) at ``sigma``: c_skip(sigma_min) = 1 and
        c_out(sigma_min) = 0, so f(x, sigma_min) = x exactly."""
        sd2 = self.sigma_data**2
        shifted = sigma - self.sigma_min
        c_skip = sd2 / (shifted**2 + sd2)
        c_out = shifted * self.sigma_data / torch.sqrt(sigma**2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma**2 + sd2)
        c_noise = torch.log(sigma) / 4.0
        return c_skip, c_out, c_in, c_noise

    def denoise(self, apply_fn: ApplyFn, x: torch.Tensor, sigma: torch.Tensor):
        """f(x; sigma): the consistency function. ``sigma`` is [b]."""
        c_skip, c_out, c_in, c_noise = self.coeffs(sigma)
        f = apply_fn(batch_view(c_in, x.dim()) * x, c_noise * self.time_scale, None)
        return batch_view(c_skip, x.dim()) * x + batch_view(c_out, x.dim()) * f

    # -- curriculum -----------------------------------------------------------
    def n_intervals(self, step: Optional[int]) -> int:
        """N(k): the grid's intervals at train step ``step`` (N + 1 nodes), min(s0
        2^(step // K'), s1) (arXiv:2310.14189 Eq. 11); s1 without a curriculum or a
        step (the eval path)."""
        if step is None or self.curriculum_steps <= 0:
            return self.s1
        n_doublings = math.log2(self.s1 / self.s0) + 1.0
        k_prime = max(int(self.curriculum_steps / n_doublings), 1)
        stage = min(max(int(step) // k_prime, 0), 30)
        return min(self.s0 * 2**stage, self.s1)

    def sigma_of_index(self, i: torch.Tensor, n: int) -> torch.Tensor:
        """sigma at ascending node ``i`` of an (n + 1)-node Karras grid: sigma_0 =
        sigma_min, sigma_n = sigma_max (closed form, in f32)."""
        inv = 1.0 / self.rho
        frac = i.float() / max(float(n), 1.0)
        lo, hi = self.sigma_min**inv, self.sigma_max**inv
        return (lo + frac * (hi - lo)) ** self.rho

    def _index_logits(self, n: int, device: torch.device) -> torch.Tensor:
        """Log-probabilities of the log-normal index distribution over the static [s1]
        table, -inf past the n live entries (arXiv:2310.14189 Eq. 15)."""
        idx = torch.arange(self.s1, dtype=torch.float32, device=device)
        s_lo = self.sigma_of_index(idx, n)
        s_hi = self.sigma_of_index(idx + 1.0, n)
        root2 = math.sqrt(2.0)
        w = torch.special.erf(
            (torch.log(s_hi) - self.p_mean) / (root2 * self.p_std)
        ) - torch.special.erf((torch.log(s_lo) - self.p_mean) / (root2 * self.p_std))
        logits = torch.log(torch.clamp(w, min=1e-20))
        return torch.where(idx < float(n), logits, torch.full_like(logits, -math.inf))

    # -- training -------------------------------------------------------------
    def p_losses(
        self,
        apply_fn: ApplyFn,
        x_start01: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        step: Optional[int] = None,
        index: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """iCT loss on a [0, 1] batch; ``step`` drives the curriculum (None: N = s1).
        ``index`` [B] is the grid index of each example (ints in [0, N)), drawn from the
        masked log-normal table by Gumbel-max on uniforms from ``generator`` when not
        given; ``noise`` (the batch's shape, drawn after the index) is the one z of both
        levels."""
        b = x_start01.shape[0]
        dev = x_start01.device
        x0 = self.normalize(x_start01)
        n = self.n_intervals(step)
        if index is None:
            logits = self._index_logits(n, dev)
            u = torch.rand((b, self.s1), generator=generator, device=dev)
            index = torch.argmax(logits - torch.log(-torch.log(u)), dim=1)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=dev)
        i = index.to(dev).float()
        sig_lo = self.sigma_of_index(i, n)
        sig_hi = self.sigma_of_index(i + 1.0, n)
        z = noise.to(dev, torch.float32)
        x_lo = x0 + batch_view(sig_lo, x0.dim()) * z  # the same z at both levels
        x_hi = x0 + batch_view(sig_hi, x0.dim()) * z
        # One forward over the doubled batch; the target half is cut from the graph after
        # it, so the backward still runs over both halves, zeros in the target's.
        f2 = self.denoise(apply_fn, torch.cat([x_hi, x_lo]), torch.cat([sig_hi, sig_lo]))
        f_online, f_target = f2[:b], f2[b:].detach()
        diff2 = torch.sum((f_online - f_target) ** 2, dim=tuple(range(1, x0.dim())))
        huber = torch.sqrt(diff2 + self.huber_c**2) - self.huber_c
        lam = 1.0 / (sig_hi - sig_lo)
        return torch.mean(lam * huber)

    # -- sampling -------------------------------------------------------------
    def tau_grid(self, steps: int, sigma_start: Optional[float] = None) -> np.ndarray:
        """Descending noise levels of multistep sampling: ``steps`` nodes of the Karras
        grid from sigma_start (default sigma_max) down to sigma_min, float64 on the
        host."""
        hi = self.sigma_max if sigma_start is None else float(sigma_start)
        if steps <= 1:
            return np.asarray([hi], np.float64)
        inv = 1.0 / self.rho
        i = np.arange(steps, dtype=np.float64)
        return (hi**inv + i / (steps - 1) * (self.sigma_min**inv - hi**inv)) ** self.rho

    def multistep_chain(self, apply_fn: ApplyFn, shape: tuple, taus: np.ndarray) -> Chain:
        """arXiv:2303.01469 Alg. 1 from x = sigma_max x_T: f at the start level (the
        chain's init), then per extra level tau_j a step that re-noises (draw key j - 1)
        and maps back: one network evaluation a level."""
        b = shape[0]
        taus = np.asarray(taus, np.float32)
        std = np.sqrt(np.maximum(taus[1:] * taus[1:] - np.float32(self.sigma_min**2),
                                 np.float32(0.0)))
        tau0 = torch.tensor(taus[0], device=self.device)

        def init(x_T):
            return self.denoise(apply_fn, self.sigma_max * x_T, tau0.expand(b))

        def step(x, row):
            return self.denoise(apply_fn, x + row["std"] * row["noise"], row["tau"].expand(b))

        rows = rows_on(self.device, tau=taus[1:], std=std.astype(np.float32))
        segments = [Segment(step, rows, list(range(len(taus) - 1)))] if len(taus) > 1 else []
        return Chain(init, segments, self.unnormalize, shape)

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
        """Sample from x = sigma_max x_T (``x_T`` the standard normal draw, from
        ``generator`` when None), step j's re-noising draw ``noise_fn(j, shape)`` or from
        ``generator`` (``chain``)."""
        chain = self.chain(apply_fn, batch_size, method, steps)
        if x_T is None:
            x_T = torch.randn(chain.shape, generator=generator, device=self.device)
        elif tuple(x_T.shape) != chain.shape:
            raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected {chain.shape}")
        return run_chain(chain, x_T.to(self.device, torch.float32), generator, noise_fn)

    def chain(self, apply_fn: ApplyFn, batch_size: int, method: Optional[str] = None,
              steps: Optional[int] = None) -> Chain:
        """``onestep`` is one evaluation of f, ``multistep`` (the default when
        ``sampling_steps`` > 1) ``steps`` levels, as a ``Chain``. Other samplers' names are
        refused with JAX's message."""
        method = method or ("onestep" if self.sampling_steps <= 1 else "multistep")
        if method not in SOLVERS:
            raise ValueError(
                f"unknown consistency sampling method {method!r}; consistency "
                f"models use {SOLVERS} (not ddpm/ddim/dpmpp/heun/euler)"
            )
        steps = 1 if method == "onestep" else (steps or self.sampling_steps)
        shape = (batch_size, self.img_size, self.img_size, self.channels)
        return self.multistep_chain(apply_fn, shape, self.tau_grid(steps))

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
    ) -> torch.Tensor:
        """Noise both [0, 1] batches to sigma(t), the log-lerp of the sigma range
        (default t 0.9, in (0, 1]), with independent noises ``noise1`` and ``noise2``
        (drawn from ``generator`` when not given), blend them by ``lam`` (a float or a [N,
        1, 1, 1] tensor), and map back with one consistency evaluation (JAX
        ``interpolate``)."""
        t = 0.9 if t is None else float(t)
        if not 0.0 < t <= 1.0:
            raise ValueError(f"consistency interpolation time must be in (0, 1], got {t}")
        sigma_t = math.exp((1.0 - t) * math.log(self.sigma_min)
                           + t * math.log(self.sigma_max))
        shape = tuple(x1_01.shape)
        noise1 = normal_draw(noise1, shape, generator, self.device)
        noise2 = normal_draw(noise2, shape, generator, self.device)
        z1 = self.normalize(x1_01.to(self.device, torch.float32)) + sigma_t * noise1
        z2 = self.normalize(x2_01.to(self.device, torch.float32)) + sigma_t * noise2
        x = (1 - lam) * z1 + lam * z2
        sigma = torch.full((shape[0],), sigma_t, dtype=torch.float32, device=self.device)
        return self.unnormalize(self.denoise(apply_fn, x, sigma))


class ConsistencyModel(DDPM):
    """Consistency model: the DDPM's backbone, Adam and EMA weights, with
    ``ConsistencyProcess`` as its process and the step counter threaded into the loss.
    The JAX constructor's arguments, plus ``device``. Train steps take ``index`` and
    ``noise`` as their loss draws."""

    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 32,
        dim: int = 64,
        sampling_steps: int = 2,
        s0: int = 10,
        s1: int = 1280,
        curriculum_steps: int = 100_000,
        p_mean: float = -1.1,
        p_std: float = 2.0,
        sigma_data: float = 0.5,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        huber_c: Optional[float] = None,
        time_scale: float = 250.0,
        lr: float = 1e-4,
        betas: Tuple[float, float] = (0.9, 0.995),
        ema_update_every: int = 10,
        ema_decay: float = 0.9999,
        ema_update_after_step: int = 100,
        use_bf16: bool = True,
        flash_attn: bool = False,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
        num_classes: Optional[int] = None,
        cond_drop_prob: float = 0.1,
        guidance_scale: float = 1.5,
        device: str | torch.device = "cuda",
        **network_kwargs,
    ):
        if network_kwargs.get("num_experts"):
            raise ValueError(
                "ConsistencyModel does not support MoE backbones (the "
                "doubled-batch consistency loss would need per-half router "
                "aux bookkeeping; use EDM/DDPM for DiT-MoE)"
            )
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
        self.diffusion = ConsistencyProcess(
            img_size=img_size,
            channels=img_channels,
            sampling_steps=sampling_steps,
            s0=s0,
            s1=s1,
            curriculum_steps=curriculum_steps,
            p_mean=p_mean,
            p_std=p_std,
            sigma_data=sigma_data,
            sigma_min=sigma_min,
            sigma_max=sigma_max,
            rho=rho,
            huber_c=huber_c,
            time_scale=time_scale,
            device=self.device,
        )

    def host_branch(self, step: int):
        """The EMA's decay and the curriculum's interval count of the step."""
        return self.ema_decay_at(step + 1), self.diffusion.n_intervals(step)

    def grad_step(
        self,
        batch: Dict,
        generator: Optional[torch.Generator] = None,
        flip: Optional[torch.Tensor] = None,
        drop: Optional[torch.Tensor] = None,
        index: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """``DDPM.grad_step`` with the step counter in the loss (the curriculum) and both
        halves of the doubled batch on the same (dropped) labels. Returns (grads,
        {"loss", "ct_intervals"})."""
        prepared = prepare_batch(self._on_device(batch), generator, train=True, flip=flip)
        x01 = self._to_diffusion_space(prepared["image"])
        labels = None
        if self.num_classes:
            labels = prepared["label"].long()
            if drop is None:
                drop = torch.rand(labels.shape, generator=generator,
                                  device=self.device) < self.cond_drop_prob
            labels = torch.where(drop.to(self.device), self.null_labels(labels.shape[0]),
                                 labels)
            labels = torch.cat([labels, labels])
        loss = self.diffusion.p_losses(self._apply_fn(self.unet, labels), x01, generator,
                                       step=self.step, index=index, noise=noise)
        intervals = torch.full((), float(self.diffusion.n_intervals(self.step)),
                               device=self.device)
        return self._grads(loss, self._trainable()), {"loss": loss.detach(),
                                                      "ct_intervals": intervals}

    @torch.inference_mode()
    def eval_step(
        self,
        batch: Dict,
        generator: Optional[torch.Generator] = None,
        index: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """``DDPM.eval_step`` with the labels doubled (EMA weights, true labels, the
        terminal discretization N = s1)."""
        prepared = prepare_batch(self._on_device(batch), train=False)
        x01 = self._to_diffusion_space(prepared["image"])
        labels = None
        if self.num_classes:
            lab = prepared["label"].long()
            labels = torch.cat([lab, lab])
        loss = self.diffusion.p_losses(self._apply_fn(self.ema_unet, labels), x01,
                                       generator, index=index, noise=noise)
        return {"val_loss": loss}
