"""DDPM: UNet or DiT + GaussianDiffusion + Adam + EMA weights.

Counterpart of ``lightning_generative_models_tpu/models/diffusion/ddpm.py``: the
constructor's UNet and DiT branches with the same argument checks, the apply closures
(``_apply_fn``, ``_guided_apply_fn`` for classifier-free guidance), the train step as
``grad_step`` + ``apply_grad_step`` (Adam, then the EMA: a hard copy up to
``ema_update_after_step``, then a decay every ``ema_update_every`` steps), ``eval_step``
with the EMA weights, ``sample``, ``sample_classes``, ``sample_raw`` and ``interpolate``,
each through the diffusion-space hooks ``_to_diffusion_space`` / ``_from_diffusion_space``
(identities here; ``LatentDiffusion`` runs the same steps in a frozen autoencoder's
latent space). The EMA weights are a second copy of the denoiser (``ema_unet``, the name the JAX package gives
the UNet and the DiT alike); the JAX package keeps them as
``TrainState.ema_params``. The model owns its step counter (``step``), as the JAX
``TrainState.step``.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from lightning_generative_models_tpu_torch.models.base import GenerativeModel
from lightning_generative_models_tpu_torch.models.diffusion.gaussian_diffusion import (
    GaussianDiffusion,
)
from lightning_generative_models_tpu_torch.models.diffusion.dit import DiT
from lightning_generative_models_tpu_torch.models.diffusion.unet import UNet
from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.train.state import count_params, ema_update, make_adam
from lightning_generative_models_tpu_torch.weights import load_flax_params


class DDPM(GenerativeModel):
    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        dim: int = 64,
        diffusion_timesteps: int = 1000,
        sampling_timesteps: Optional[int] = None,
        lr: float = 2e-5,
        betas: Tuple[float, float] = (0.9, 0.99),
        ema_update_every: int = 10,
        ema_decay: float = 0.995,
        ema_update_after_step: int = 100,
        objective: str = "pred_v",
        beta_schedule: str = "sigmoid",
        min_snr_loss_weight: bool = False,
        min_snr_gamma: float = 5.0,
        self_condition: bool = False,
        offset_noise_strength: float = 0.0,
        use_bf16: bool = True,
        flash_attn: bool = False,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
        num_classes: Optional[int] = None,
        cond_drop_prob: float = 0.1,
        guidance_scale: float = 3.0,
        network: str = "unet",
        patch_size: int = 2,
        depth: int = 12,
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        qkv_layout: str = "s3hd",
        seq_parallel: bool = False,
        num_experts: int = 0,
        capacity_factor: float = 1.25,
        moe_every: int = 2,
        moe_aux_weight: float = 0.01,
        pipeline_stages: int = 0,
        pipeline_microbatches: int = 0,
        einsum_attn: bool = False,
        pp_fused_attn: bool = False,
        device: str | torch.device = "cuda",
    ):
        """The JAX constructor's arguments, plus ``device``, checked as there:
        ``network`` picks the UNet or the DiT (``dim`` is then the hidden width, and
        ``patch_size``/``depth``/``num_heads``/``mlp_ratio``/``qkv_layout`` its shape).
        With ``num_experts`` the DiT's MoE blocks add ``moe_aux_weight`` times their
        mean load-balancing loss to the training loss. The DiT's pipeline stages are not
        ported yet and raise.
        The weights start from ``init_params`` with seed 0; ``init_params(generator)``
        redraws them."""
        super().__init__(img_channels, img_size)
        self.device = resolve_device(device)
        self.ema_update_every = ema_update_every
        self.ema_decay = ema_decay
        self.ema_update_after_step = ema_update_after_step
        self.num_classes = int(num_classes or 0)
        self.moe_aux_weight = moe_aux_weight
        self.cond_drop_prob = cond_drop_prob
        self.guidance_scale = guidance_scale
        self.step = 0

        dtype = torch.bfloat16 if use_bf16 else torch.float32
        if network == "dit":
            if self_condition:
                raise ValueError("network='dit' does not support self_condition")
            self.unet = DiT(
                hidden=dim,
                depth=depth,
                heads=num_heads,
                patch_size=patch_size,
                channels=img_channels,
                mlp_ratio=mlp_ratio,
                num_classes=num_classes,
                flash_attn=flash_attn,
                dtype=dtype,
                qkv_layout=qkv_layout,
                seq_parallel=seq_parallel,
                num_experts=num_experts,
                capacity_factor=capacity_factor,
                moe_every=moe_every,
                pipeline_stages=pipeline_stages,
                pipeline_microbatches=pipeline_microbatches,
                einsum_attn=einsum_attn,
                pp_fused_attn=pp_fused_attn,
            )
        elif network == "unet":
            if qkv_layout != "s3hd":
                raise ValueError(
                    "qkv_layout applies to the DiT backbone only (the UNet "
                    "does not use packed-qkv attention)"
                )
            if seq_parallel:
                raise ValueError("seq_parallel applies to the DiT backbone only")
            if num_experts:
                raise ValueError("num_experts (MoE) applies to the DiT backbone only")
            if pipeline_stages:
                raise ValueError("pipeline_stages applies to the DiT backbone only")
            if einsum_attn:
                raise ValueError(
                    "einsum_attn applies to the DiT backbone only (the "
                    "UNet does not use packed-qkv attention)"
                )
            if pp_fused_attn:
                raise ValueError(
                    "pp_fused_attn applies to the pipeline-parallel DiT "
                    "backbone only (the UNet has no pipeline stages)"
                )
            self.unet = UNet(
                dim=dim,
                dim_mults=tuple(dim_mults),
                channels=img_channels,
                self_condition=self_condition,
                num_classes=num_classes,
                flash_attn=flash_attn,
                dtype=dtype,
            )
        else:
            raise ValueError(f"unknown network {network!r}; pick 'unet' or 'dit'")
        self.init_params()

        if sampling_timesteps is not None:
            sampling_timesteps = min(sampling_timesteps, diffusion_timesteps)
        self.diffusion = GaussianDiffusion(
            img_size=img_size,
            channels=img_channels,
            timesteps=diffusion_timesteps,
            sampling_timesteps=sampling_timesteps,
            objective=objective,
            beta_schedule=beta_schedule,
            min_snr_loss_weight=min_snr_loss_weight,
            min_snr_gamma=min_snr_gamma,
            self_condition=self_condition,
            offset_noise_strength=offset_noise_strength,
            device=self.device,
        )
        self.optimizer = make_adam(self._trainable(), lr, b1=betas[0], b2=betas[1])

    # -- parameters --------------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the denoiser's weights from the CPU ``generator`` and copy them to the
        EMA set, as the JAX ``init_state`` does."""
        init_params(self.unet, generator)
        self.unet.to(self.device)
        self.copy_params_to_ema()

    def copy_params_to_ema(self) -> None:
        """EMA weights := current weights (the EMA's hard copy)."""
        self.ema_unet = copy.deepcopy(self.unet).requires_grad_(False)

    # -- apply closures ------------------------------------------------------------
    def _apply_fn(self, net: torch.nn.Module, labels: Optional[torch.Tensor] = None):
        """Denoiser (UNet or DiT) apply closure for GaussianDiffusion. For a conditional model
        ``labels`` rides in the closure; unconditional models ignore it."""
        if self.num_classes:
            if labels is None:
                raise ValueError(
                    "conditional DDPM: _apply_fn requires labels "
                    "(use null_labels(B) for unconditional)"
                )

            def apply(x, t, x_self_cond=None):
                return net(x, t, x_self_cond, labels=labels)

            return apply

        def apply(x, t, x_self_cond=None):
            return net(x, t, x_self_cond)

        return apply

    # -- diffusion-space hooks (identities in pixel space) -----------------------------
    def _to_diffusion_space(self, x01: torch.Tensor) -> torch.Tensor:
        """A [0, 1] image batch into the space the process diffuses in."""
        return x01

    def _from_diffusion_space(self, z: torch.Tensor) -> torch.Tensor:
        """A sample of the process back to [0, 1] images."""
        return z

    def null_labels(self, batch: int) -> torch.Tensor:
        """The learned null (unconditional) token, broadcast to a batch."""
        return torch.full((batch,), self.unet.null_class, dtype=torch.long, device=self.device)

    def _guided_apply_fn(self, net: torch.nn.Module, labels: torch.Tensor, w: float):
        """Classifier-free-guided closure: one network eval on the doubled batch
        [cond; uncond], combined as u + w*(c - u) on the raw network output."""
        b = labels.shape[0]
        lab2 = torch.cat([labels.long(), self.null_labels(b)])

        def apply(x, t, x_self_cond=None):
            sc2 = None if x_self_cond is None else torch.cat([x_self_cond, x_self_cond])
            out = net(torch.cat([x, x]), torch.cat([t, t]), sc2, labels=lab2)
            c, u = out[:b], out[b:]
            return u + w * (c - u)

        return apply

    # -- steps ---------------------------------------------------------------------
    def _on_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def grad_step(
        self,
        batch: Dict,
        generator: Optional[torch.Generator] = None,
        flip: Optional[torch.Tensor] = None,
        drop: Optional[torch.Tensor] = None,
        **loss_draws,
    ):
        """Gradients of the training loss on a uint8 batch, without changing the
        weights. The random draws (the flip, the classifier-free-guidance label drop,
        then the loss's, in that order) come from ``generator`` unless given: ``flip``
        [B] bool, ``drop`` [B] bool, and ``loss_draws`` as the process's ``p_losses``
        names them (GaussianDiffusion: ``t`` [B] and ``noise`` of the batch's shape).
        Returns (grads, {"loss": loss}); a DiT with MoE blocks adds ``moe_aux_weight``
        times the mean of their load-balancing losses to the loss, and that mean as
        ``moe_aux`` (JAX ``ddpm.py``: the training loss calls the network once)."""
        batch = self._on_device(batch)
        prepared = prepare_batch(batch, generator, train=True, flip=flip)
        x01 = self._to_diffusion_space(prepared["image"])

        labels = None
        if self.num_classes:
            labels = prepared["label"].long()
            if drop is None:
                drop = torch.rand(labels.shape, generator=generator,
                                  device=self.device) < self.cond_drop_prob
            labels = torch.where(drop.to(self.device), self.null_labels(labels.shape[0]),
                                 labels)

        params = self._trainable()
        if getattr(self.unet, "num_experts", 0) <= 0:
            loss = self.diffusion.p_losses(self._apply_fn(self.unet, labels), x01,
                                           generator, **loss_draws)
            return self._grads(loss, params), {"loss": loss.detach()}
        auxes = []

        def apply(x, t, x_self_cond=None):
            kwargs = {"labels": labels} if self.num_classes else {}
            out, aux = self.unet(x, t, x_self_cond, return_aux=True, **kwargs)
            auxes.append(aux)
            return out

        loss = self.diffusion.p_losses(apply, x01, generator, **loss_draws)
        loss = loss + self.moe_aux_weight * auxes[0]
        return self._grads(loss, params), {"loss": loss.detach(),
                                           "moe_aux": auxes[0].detach()}

    def _grads(self, loss: torch.Tensor, params: list) -> list:
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # Contiguous, as the parameters and Adam's moments are: cuDNN returns the conv
        # kernels' grads in channels-last strides, and a stride that differs from the
        # moments' sends Adam's foreach ops down their per-tensor path (a launch per
        # parameter and op).
        return [torch.zeros_like(p) if g is None else g.contiguous()
                for p, g in zip(params, grads)]

    def _trainable(self) -> list:
        return [p for p in self.unet.parameters() if p.requires_grad]

    def ema_decay_at(self, step: int) -> float:
        """The EMA's effective decay at 1-based step ``step``: 0 (hard copy) up to
        ``ema_update_after_step``, then ``ema_decay`` every ``ema_update_every``
        steps and 1 (keep) in between."""
        if step <= self.ema_update_after_step:
            return 0.0
        return self.ema_decay if step % self.ema_update_every == 0 else 1.0

    def ema_step_needed(self, next_step: int) -> bool:
        """True when step ``next_step`` (1-based) changes the EMA weights."""
        return self.ema_decay_at(next_step) != 1.0

    def host_branch(self, step: int):
        """The EMA's decay after the step: the JAX trainer's EMA flag, and the branch a
        graph of steps bakes in."""
        return self.ema_decay_at(step + 1)

    def summary_spec(self) -> dict:
        """The denoiser's per-layer table (JAX ``ddpm.py:summary_spec``)."""
        kwargs = {"labels": torch.zeros((1,), dtype=torch.long)} if self.num_classes else {}
        return {"unet": (self.unet, (torch.zeros((1, *self.image_shape())),
                                     torch.zeros((1,), dtype=torch.long)), kwargs)}

    def apply_grad_step(self, grads, metrics: Dict) -> Dict[str, torch.Tensor]:
        """Adam on ``grads``, then the EMA, then the step counter."""
        params = self._trainable()
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step()
        for p in params:
            p.grad = None
        self.step += 1
        decay = self.ema_decay_at(self.step)
        if decay != 1.0:
            ema_update(self.ema_unet, self.unet, decay)
        return {("train_loss" if k == "loss" else f"train_{k}"): v
                for k, v in metrics.items()}

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   **draws) -> Dict[str, torch.Tensor]:
        return self.apply_grad_step(*self.grad_step(batch, generator, **draws))

    @torch.inference_mode()
    def eval_step(
        self,
        batch: Dict,
        generator: Optional[torch.Generator] = None,
        **loss_draws,
    ) -> Dict[str, torch.Tensor]:
        """Validation loss of the EMA weights on a uint8 batch (no flip, no label
        drop); the loss's draws (``loss_draws``, as in ``grad_step``) from ``generator``
        unless given."""
        prepared = prepare_batch(self._on_device(batch), train=False)
        x01 = self._to_diffusion_space(prepared["image"])
        labels = prepared["label"].long() if self.num_classes else None
        loss = self.diffusion.p_losses(self._apply_fn(self.ema_unet, labels), x01,
                                       generator, **loss_draws)
        return {"val_loss": loss}

    # -- checkpoint state ------------------------------------------------------------
    def param_counts(self) -> Dict[str, int]:
        return {"unet": count_params(self.unet), "ema_unet": count_params(self.ema_unet)}

    def flax_layout(self) -> dict:
        """Where a JAX ``TrainState`` goes (``weights.load_flax_train_state``)."""
        return {"params": {"params/model": self.unet, "ema_params": self.ema_unet},
                "adam": {"opt_state/model": (self.optimizer, {"": self.unet})}}

    def load_flax_weights(self, tree) -> None:
        """``generate --weights``: a flax parameter tree (``state.ema_params``) into the
        UNet, copied to the EMA set."""
        load_flax_params(self.unet, tree)
        self.copy_params_to_ema()

    def state_dict(self) -> dict:
        return {
            "unet": self.unet.state_dict(),
            "ema_unet": self.ema_unet.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.unet.load_state_dict(state["unet"])
        self.ema_unet.load_state_dict(state["ema_unet"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    # -- sampling ----------------------------------------------------------------
    @torch.inference_mode()
    def sample(
        self,
        generator: Optional[torch.Generator],
        num_samples: int,
        method: Optional[str] = None,
        steps: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """EMA-model sampling, [num_samples, H, W, C] in [0, 1]. The default method
        is DDIM iff sampling_timesteps < timesteps; "dpmpp" selects DPM-Solver++(2M)
        with ``steps`` model evaluations. Conditional models sample cycling labels
        0..num_classes-1 with classifier-free guidance."""
        if self.num_classes:
            labels = torch.arange(num_samples, device=self.device) % self.num_classes
            return self.sample_classes(
                generator, labels, method=method, steps=steps, x_T=x_T
            )
        return self._from_diffusion_space(self.diffusion.sample(
            self._apply_fn(self.ema_unet), num_samples, generator,
            method=method, steps=steps, x_T=x_T,
        ))

    @torch.inference_mode()
    def sample_classes(
        self,
        generator: Optional[torch.Generator],
        labels: torch.Tensor,
        guidance_scale: Optional[float] = None,
        method: Optional[str] = None,
        steps: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Classifier-free-guided sampling of the given classes (conditional models
        only). ``guidance_scale`` defaults to the constructor's."""
        if not self.num_classes:
            raise ValueError("sample_classes requires DDPM(num_classes=...)")
        labels = torch.as_tensor(labels, device=self.device).long()
        w = self.guidance_scale if guidance_scale is None else guidance_scale
        apply_fn = self._guided_apply_fn(self.ema_unet, labels, w)
        return self._from_diffusion_space(self.diffusion.sample(
            apply_fn, labels.shape[0], generator, method=method, steps=steps, x_T=x_T
        ))

    @torch.inference_mode()
    def interpolate(self, x1_01: torch.Tensor, x2_01: torch.Tensor,
                    generator: Optional[torch.Generator] = None, t=None, lam=0.5,
                    **draws) -> torch.Tensor:
        """Blend two [0, 1] image batches through the process's ``interpolate`` with the
        EMA weights (null labels for a conditional model), in the diffusion space
        (JAX ``ddpm.py:interpolate``): a latent model blends in its autoencoder's latents.
        ``lam`` is a float or a per-sample [N, 1, 1, 1] tensor; ``draws`` are the
        process's explicit draws."""
        x1 = torch.as_tensor(x1_01).to(self.device, torch.float32)
        x2 = torch.as_tensor(x2_01).to(self.device, torch.float32)
        if isinstance(lam, torch.Tensor):
            lam = lam.to(self.device, torch.float32)
        labels = self.null_labels(x1.shape[0]) if self.num_classes else None
        z = self.diffusion.interpolate(
            self._apply_fn(self.ema_unet, labels), self._to_diffusion_space(x1),
            self._to_diffusion_space(x2), generator, t=t, lam=lam, **draws)
        return self._from_diffusion_space(z)

    def validation_grids(self, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Per-class grid (row r: 4 guided samples of class r), conditional models
        only."""
        if not self.num_classes:
            return {}
        labels = torch.arange(self.num_classes, device=self.device).repeat_interleave(4)
        return {"per_class_generation": self.sample_classes(generator, labels)}

    @torch.inference_mode()
    def sample_raw(self, generator: Optional[torch.Generator], num_samples: int,
                   **kwargs) -> torch.Tensor:
        """Sampling with the raw (non-EMA) weights, for diagnostics."""
        if self.num_classes:
            labels = torch.arange(num_samples, device=self.device) % self.num_classes
            apply_fn = self._guided_apply_fn(self.unet, labels, self.guidance_scale)
        else:
            apply_fn = self._apply_fn(self.unet)
        return self._from_diffusion_space(
            self.diffusion.sample(apply_fn, num_samples, generator, **kwargs))
