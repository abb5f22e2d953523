"""Sampling CLI of the port: generate a grid of images from a config.

Counterpart of the repo's ``generate.py``. Samples N images with the model's
``sample`` (a diffusion, flow, EDM or consistency model's EMA weights, decoded by its frozen
autoencoder for a latent model; a VQ model decodes random codes; a VAE random latents) and
writes a grid PNG. The weights come from ``--weights``, an ``.npz`` with "/"-joined keys
read by the model's ``load_flax_weights`` (a DDPM or FlowMatching: the flax tree of
``state.ema_params`` alone; a VQ-VAE or VQGAN: the whole flattened ``TrainState``), or,
without it, are drawn from ``--seed``. A JAX run's orbax checkpoint reaches the port as
an ``.npz`` written where JAX runs (README, "Continuing a JAX run in the port").
``--sampler``, ``--sampling_steps``, ``--label`` and ``--guidance_scale`` are refused for
models whose sampling does not take them, as the JAX ``generate.py`` refuses them (a CGAN
or ACGAN takes ``--label``; CycleGAN, which translates, raises ``NotImplementedError`` as
its ``sample`` does); each sampling family (diffusion, flow matching, EDM, consistency)
refuses the others' sampler names with the JAX package's messages. A latent model's
``--weights`` is its whole flattened ``TrainState``, the autoencoder inside it.

    python -m lightning_generative_models_tpu_torch.generate \
        --config_path configs/diffusion/ddim_cifar10.json --num_samples 64 [--device cuda]
"""

from __future__ import annotations

import argparse
import inspect
from pathlib import Path

import numpy as np
import torch

from lightning_generative_models_tpu_torch.config import load_config
from lightning_generative_models_tpu_torch.experiment.logger import _write_png
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.utils.grid import make_grid
from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Generate samples with the PyTorch port")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default=None,
                        help="output directory (default: experiments/<MODEL>/generated_torch)")
    parser.add_argument("--weights", type=str, default=None,
                        help=".npz read by the model's load_flax_weights (default: "
                        "weights from --seed)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--label", type=int, default=None,
                        help="class label for a conditional model (CGAN, ACGAN, a "
                        "conditional DDPM)")
    parser.add_argument("--guidance_scale", type=float, default=None,
                        help="classifier-free guidance scale for --label (default: the "
                        "model config's guidance_scale)")
    parser.add_argument("--sampler", type=str, default="auto",
                        choices=["auto", "ddpm", "ddim", "dpmpp", "euler", "midpoint", "heun",
                                 "onestep", "multistep"],
                        help="auto keeps each model's convention (diffusion: DDIM iff "
                        "sampling_timesteps < T; flow matching and EDM: the configured "
                        "solver; consistency: multistep iff sampling_steps > 1); dpmpp: "
                        "DPM-Solver++(2M); euler/midpoint/heun: the flow-matching ODE "
                        "solvers (EDM: heun/euler); onestep/multistep: the consistency "
                        "samplers. Each family refuses the others' samplers")
    parser.add_argument("--sampling_steps", type=int, default=0,
                        help="override the sampler's step count (0 = the config's "
                        "sampling_timesteps or sampling_steps); ancestral ddpm always runs "
                        "the full chain")
    parser.add_argument("--interpolate", type=int, default=0, metavar="N",
                        help="not ported yet")
    parser.add_argument("--fid", type=int, default=0, metavar="N", help="not ported yet")
    return parser.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the sampled images, [N, H, W, C] in [0, 1]."""
    args = parse_args(argv)
    if args.fid:
        raise NotImplementedError(
            "--fid needs the Inception metrics, not yet ported; see ROADMAP.md")
    if args.interpolate:
        raise NotImplementedError(
            "--interpolate needs the diffusion interpolation, not yet ported; see ROADMAP.md")
    device = resolve_device(args.device)
    config = load_config(args.config_path)
    model = load_model(config["model"], device=device)
    name = type(model).__name__
    if (args.sampler != "auto" or args.sampling_steps) and \
            "method" not in inspect.signature(model.sample).parameters:
        raise SystemExit(f"{name} does not support --sampler/--sampling_steps "
                         "(diffusion models only)")
    if args.label is not None and not hasattr(model, "sample_classes"):
        raise SystemExit(f"{name} does not support --label (conditional models only)")
    if args.weights:
        model.load_flax_weights(args.weights)
    else:
        model.init_params(torch.Generator().manual_seed(args.seed))

    generator = torch.Generator(device=device).manual_seed(args.seed)
    kwargs = {}
    if args.sampler != "auto" or args.sampling_steps:
        kwargs = {"method": None if args.sampler == "auto" else args.sampler,
                  "steps": args.sampling_steps or None}
    if args.label is not None:
        labels = torch.full((args.num_samples,), args.label, dtype=torch.long)
        if args.guidance_scale is not None:
            if "guidance_scale" not in inspect.signature(model.sample_classes).parameters:
                raise SystemExit(f"{name} does not support --guidance_scale")
            kwargs["guidance_scale"] = args.guidance_scale
        images = model.sample_classes(generator, labels, **kwargs)
    else:
        images = model.sample(generator, args.num_samples, **kwargs)
    images = images.float().cpu().numpy()

    out_dir = (Path(args.out) if args.out
               else EXPERIMENT_DIR / config["model"]["name"] / "generated_torch")
    out_dir.mkdir(parents=True, exist_ok=True)
    grid_path = out_dir / "grid.png"
    _write_png(grid_path, make_grid(images))
    print(f"Wrote {grid_path}")
    return images


if __name__ == "__main__":
    main()
