"""Latent diffusion: DDPM in a frozen VQ autoencoder's latent space.

Counterpart of ``lightning_generative_models_tpu/models/diffusion/latent_diffusion.py``
(the VQ-regularized recipe of arXiv:2112.10752): a pre-trained VQ-VAE or VQGAN, frozen,
and the DDPM's process and UNet on its continuous pre-quantization latents; sampling
diffuses a latent and decodes it through the quantizer (kernel #6 on the card) and the
decoder. Only the two diffusion-space hooks differ from the DDPM's: the encoder under
``torch.no_grad`` times ``latent_scale`` into the space, the quantizer and decoder out of
it. Latents are unbounded, so the process runs with ``auto_normalize=False`` and
``x_start_clip=None``; ``latent_scale`` should be about 1 / the logged
``val_latent_std``.

The frozen autoencoder is part of the model's ``state_dict``, so a checkpoint of a
latent model is self-contained: restoring it replaces the autoencoder it was built with
(a random one when the config names no trained run), and ``--resume`` never needs the
autoencoder's experiment. With an ``experiment_name`` the autoencoder is restored, strictly,
from the port's own checkpoint of that run under
``experiments/<AE name>/<experiment_name>/checkpoints`` (``which``: last or best).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.train.state import count_params
from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR
from lightning_generative_models_tpu_torch.weights import load_flax_train_state

logger = logging.getLogger(__name__)

#: attributes an autoencoder must expose (VQVAE and VQGAN both qualify).
_AE_PROTOCOL = ("encoder", "decoder", "_apply_vq", "embedding_dim")
#: the autoencoder's entries that a JAX latent model keeps in its state.
_AE_TREE = ("params/encoder", "params/decoder", "params/vq", "mutable/vq/codebook")


class LatentDiffusion(DDPM):
    """DDPM over a frozen VQ autoencoder's continuous latents.

    ``autoencoder`` configures the frozen stage-1 model::

        {"config_path": "configs/vae/vqvae_cifar10.json",
         "experiment_name": "<trained AE run>",   # optional
         "which": "last"}

    Without ``experiment_name`` the autoencoder is random (with a warning), until a
    checkpoint of this model replaces it. ``img_size``/``img_channels`` keep their image
    meaning; the UNet and the process run at ``img_size / 8`` with ``embedding_dim``
    channels. Further arguments pass through to ``DDPM``.
    """

    def __init__(
        self,
        img_channels: int = 3,
        img_size: int = 64,
        autoencoder: Optional[dict] = None,
        latent_scale: float = 1.0,
        dim_mults=(1, 2, 4),
        device: str | torch.device = "cuda",
        **ddpm_kwargs,
    ):
        device = resolve_device(device)
        self.ae, downsample = self._build_autoencoder(autoencoder, img_channels, img_size,
                                                      device)
        if img_size % downsample:
            raise ValueError(
                f"img_size {img_size} not divisible by the autoencoder's "
                f"downsample factor {downsample}"
            )
        latent_hw = img_size // downsample
        latent_c = self.ae.embedding_dim
        super().__init__(
            img_channels=latent_c,
            img_size=latent_hw,
            dim_mults=tuple(dim_mults),
            device=device,
            **ddpm_kwargs,
        )
        # The image-space surface stays; the latent geometry is internal.
        self.img_channels = img_channels
        self.img_size = img_size
        self.latent_hw = latent_hw
        self.latent_c = latent_c
        self.latent_scale = float(latent_scale)
        self.diffusion.auto_normalize = False
        self.diffusion.x_start_clip = None

    # -- stage-1 autoencoder ---------------------------------------------------
    @staticmethod
    def _build_autoencoder(spec, img_channels, img_size, device):
        """Build the frozen autoencoder and restore it when ``spec`` names a run;
        returns ``(model, downsample factor)``."""
        # Local imports: the registry imports the model modules.
        from lightning_generative_models_tpu_torch.config import ConfigError, load_config
        from lightning_generative_models_tpu_torch.registry import load_model
        from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager

        if not spec or "config_path" not in spec:
            raise ValueError(
                "LatentDiffusion requires autoencoder={'config_path': ..., "
                "'experiment_name': <trained run, optional>}"
            )
        ae_config = load_config(spec["config_path"])
        ae_name = ae_config["model"]["name"]
        ae_args = ae_config["model"]["args"]
        if ae_args.get("img_size") != img_size or (
            ae_args.get("img_channels") != img_channels
        ):
            raise ConfigError(
                f"autoencoder config {spec['config_path']} is "
                f"{ae_args.get('img_size')}x{ae_args.get('img_size')}x"
                f"{ae_args.get('img_channels')} but LatentDiffusion is "
                f"{img_size}x{img_size}x{img_channels}"
            )
        ae = load_model(ae_config["model"], device=device)
        missing = [a for a in _AE_PROTOCOL if not hasattr(ae, a)]
        if missing:
            raise ValueError(
                f"{ae_name} cannot back LatentDiffusion (missing {missing}); "
                "use VQVAE or VQGAN"
            )
        exp_name = spec.get("experiment_name")
        if exp_name:
            which = spec.get("which", "last")
            directory = EXPERIMENT_DIR / ae_name / exp_name / "checkpoints"
            if not (directory / which).exists():
                raise FileNotFoundError(f"No checkpoint at {directory / which}")
            step, _ = CheckpointManager(directory, monitor=ae.monitor).restore(ae, which)
            logger.info("LatentDiffusion: frozen %s from experiment %s (%s, step %s)",
                        ae_name, exp_name, which, step)
        else:
            logger.warning(
                "LatentDiffusion: autoencoder has NO experiment_name — using "
                "RANDOM-INIT %s weights (smoke testing only). Restoring an "
                "LDM checkpoint will replace them with the AE stored inside "
                "it.", ae_name,
            )
        ae.net.requires_grad_(False)
        # VQ backbone: three stride-2 convs -> f8.
        return ae, ae.img_size // ae.latent_hw

    # -- diffusion-space hooks -----------------------------------------------------
    @torch.no_grad()
    def _to_diffusion_space(self, x01: torch.Tensor) -> torch.Tensor:
        """[0, 1] images -> scaled continuous (pre-quantization) latents."""
        return self.ae.encoder(self.to_model_space(x01)) * self.latent_scale

    @torch.no_grad()
    def _from_diffusion_space(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> [0, 1] images, through the quantizer and the decoder."""
        q, _, _ = self.ae._apply_vq(z / self.latent_scale, False)
        return self.to_image_space(self.ae.decoder(q))

    # -- steps ---------------------------------------------------------------------
    @torch.inference_mode()
    def eval_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                  **loss_draws) -> Dict[str, torch.Tensor]:
        """``DDPM.eval_step`` plus ``val_latent_std``, the unscaled latents' std (set
        ``latent_scale`` to about 1 / it)."""
        metrics = super().eval_step(batch, generator, **loss_draws)
        z = self._to_diffusion_space(
            prepare_batch(self._on_device(batch), train=False)["image"])
        metrics["val_latent_std"] = torch.std(z, correction=0) / self.latent_scale
        return metrics

    # -- checkpoint state ------------------------------------------------------------
    def param_counts(self) -> Dict[str, int]:
        return {**super().param_counts(), "autoencoder": count_params(self.ae.net)}

    def flax_layout(self) -> dict:
        """DDPM's, plus the frozen autoencoder's encoder, decoder and quantizer at
        ``mutable/autoencoder`` (``params/{encoder,decoder,vq}`` and ``vq``)."""
        layout = super().flax_layout()
        ae = self.ae.flax_layout()
        for kind in ("params", "buffers"):
            layout.setdefault(kind, {}).update(
                {f"mutable/autoencoder/{k.replace('mutable/', '')}": m
                 for k, m in ae.get(kind, {}).items() if k in _AE_TREE})
        return layout

    def load_flax_weights(self, tree) -> None:
        """``generate --weights``: a flattened JAX ``TrainState`` (the UNet's raw and EMA
        weights and the autoencoder inside it; the optimizer's entries are not read)."""
        load_flax_train_state(self, tree, optimizers=False)

    def state_dict(self) -> dict:
        return {**super().state_dict(), "autoencoder": self.ae.net.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.ae.net.load_state_dict(state["autoencoder"])
