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
``--save_individual`` also writes one PNG a sample, ``sample_{i:04d}.png`` beside the grid,
each ``(clip(img, 0, 1) * 255).astype(uint8)`` (truncated, as the JAX CLI writes them).
``--experiment_name`` (with ``--which`` last or best) restores instead a port run's
checkpoint from ``experiments/<MODEL>/<experiment_name>/``, its optimizer with the run's
Adam moment dtypes (the run's ``args.json``).

    python -m lightning_generative_models_tpu_torch.generate \
        --config_path configs/diffusion/ddim_cifar10.json --num_samples 64 [--device cuda]

Under ``torchrun`` the sampling is sharded over the ranks, as the JAX ``generate.py``
shards it over the devices: each rank draws the global start noise (and every later
draw) and keeps its rows, the rows are gathered, and rank 0 writes; the samples are one
device's (a batch the ranks do not divide is sampled whole on every rank). ``--fid``
samples its fakes the same way; every rank runs InceptionV3 on all of them.

``--interpolate N`` writes instead a one-row grid of N blends of two samples
(``interpolation_<which>_step<step>.png``, JAX's name; ``--interpolate_t`` the noising
time), through the model's ``interpolate``; a model without one exits with JAX's message.

``--fid N`` computes FID@N instead of a grid, as the JAX ``generate.py --fid`` does: the
real statistics over the full train split (train and validation; a synthetic stand-in is
regenerated at ``--fid_real`` or N images, and its real set is N images), N fakes
sampled in ``--fid_batch`` chunks, each from its own generator, quantised to uint8 by
truncation, InceptionV3 on the card; the result goes to
``fid_<N>_<which>_step<step>[_<sampler><steps>].json`` (JAX's keys) in the run's
directory (``--experiment_name``) or the output directory, where ``<which>`` is the
checkpoint restored, ``weights`` for ``--weights`` or ``seed`` for drawn weights.
"""

from __future__ import annotations

import argparse
import inspect
import json
import time
from pathlib import Path

import numpy as np
import torch

from lightning_generative_models_tpu_torch.config import load_config
from lightning_generative_models_tpu_torch.data.datamodule import DataModule
from lightning_generative_models_tpu_torch.experiment.logger import _write_png
from lightning_generative_models_tpu_torch.metrics import inception
from lightning_generative_models_tpu_torch.metrics.generative import (
    FrechetInceptionDistance,
    to_uint8,
)
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.train.state import (
    set_default_mu_dtype,
    set_default_nu_dtype,
)
from lightning_generative_models_tpu_torch.utils.grid import make_grid
from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Generate samples with the PyTorch port")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default=None,
                        help="output directory (default: experiments/<MODEL>/generated_torch)")
    parser.add_argument("--save_individual", action="store_true",
                        help="also write one PNG per sample")
    parser.add_argument("--weights", type=str, default=None,
                        help=".npz read by the model's load_flax_weights (default: "
                        "weights from --seed)")
    parser.add_argument("--experiment_name", type=str, default=None,
                        help="restore this port run's checkpoint "
                        "(experiments/<MODEL>/<experiment_name>/checkpoints/<which>)")
    parser.add_argument("--which", type=str, default="last", choices=("last", "best"),
                        help="which checkpoint --experiment_name restores")
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
                        help="blend two generated samples at N lambdas in [0, 1] through the "
                        "model's interpolate (diffusion, flow matching, EDM, consistency "
                        "and latent models)")
    parser.add_argument("--interpolate_t", type=float, default=None,
                        help="noising time of --interpolate: a step for a diffusion model "
                        "(default T-1, the full chain), a time in (0, 1] for flow "
                        "matching, EDM and consistency models (default 0.9)")
    parser.add_argument("--fid", type=int, default=0, metavar="N",
                        help="compute FID@N against the train split's statistics and "
                        "write fid_<N>_<which>_step<step>.json")
    parser.add_argument("--fid_batch", type=int, default=256,
                        help="sampling/feature batch size for --fid")
    parser.add_argument("--fid_real", type=int, default=0,
                        help="cap on real images for --fid statistics (0 = full train "
                        "split, or N on synthetic data)")
    return parser.parse_args(argv)


def compute_fid(model, config: dict, args: argparse.Namespace, step: int, which: str,
                out_dir: Path, sample_kwargs: dict) -> dict:
    """FID@N (see the module doc); prints the value and the wall split into sampling,
    InceptionV3 and the statistics; returns the artifact."""
    n, bs = args.fid, args.fid_batch
    dm = DataModule(**config["dataset"])
    dm.setup()
    # The seeded train/val split partitions the train pool: their union restores it.
    reals = np.concatenate([dm.train_images, dm.val_images])
    if dm.is_synthetic and len(reals) < (args.fid_real or n):
        # The synthetic pool is smaller than the protocol's real set: regenerate it.
        dm = DataModule(**{**config["dataset"], "synthetic_size": args.fid_real or n})
        dm.setup()
        reals = np.concatenate([dm.train_images, dm.val_images])
    if args.fid_real:
        reals = reals[: args.fid_real]
    elif dm.is_synthetic:
        reals = reals[:n]  # synthetic protocol: real-set size == fake-set size

    device = model.device
    extractor = inception.InceptionFeatureExtractor(device=device)
    fid = FrechetInceptionDistance(extractor)
    t0 = time.perf_counter()
    for start in range(0, len(reals), bs):
        fid.update(reals[start: start + bs], real=True)
    t_inception, t_sampling = time.perf_counter() - t0, 0.0
    done, i = 0, 0
    while done < n:
        b = min(bs, n - done)
        seed = np.random.SeedSequence([args.seed, i]).generate_state(1)[0]
        generator = torch.Generator(device=device).manual_seed(int(seed))
        t0 = time.perf_counter()
        fake_u8 = to_uint8(mesh_lib.sample_rows(
            lambda rows: model.sample(generator, rows, **sample_kwargs), b))
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the sampling's time, apart from InceptionV3's
        t1 = time.perf_counter()
        fid.update(fake_u8, real=False)
        t_sampling += t1 - t0
        t_inception += time.perf_counter() - t1
        done += b
        i += 1
    t0 = time.perf_counter()
    value = float(fid.compute())
    t_stats = time.perf_counter() - t0

    artifact = {
        "fid": value,
        "n_fake": n,
        "n_real": int(len(reals)),
        "pretrained_inception": bool(extractor.pretrained),
        "comparable_to_published": bool(extractor.pretrained),
        "checkpoint": which,
        "step": int(step),
        "dataset": config["dataset"]["name"],
        "synthetic_data": bool(dm.is_synthetic),
        "seed": args.seed,
        "sampler": args.sampler,
        "sampling_steps": args.sampling_steps or None,
    }
    suffix = "" if args.sampler == "auto" and not args.sampling_steps else (
        f"_{args.sampler}{args.sampling_steps or ''}")
    out_path = out_dir / f"fid_{n}_{which}_step{step}{suffix}.json"
    if mesh_lib.is_main_process():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=2)
    kind = "pretrained" if extractor.pretrained else (
        "He-scaled random-init (relative tracking only — drop "
        "pt_inception-2015-12-05.pth for published-comparable numbers, "
        "see docs/FID.md)")
    print(f"FID@{n} = {value:.4f}  [{kind}]")
    print(f"FID@{n} wall: sampling {t_sampling:.3f} s, InceptionV3 {t_inception:.3f} s, "
          f"statistics {t_stats:.3f} s")
    print(f"Wrote {out_path}")
    return artifact


def use_run_moment_dtypes(run_dir: Path) -> None:
    """Adam's moment dtypes of a port run (its ``args.json``: ``--mu_dtype`` /
    ``--nu_dtype``), so that its checkpoint restores into the optimizer it was saved from."""
    path = run_dir / "args.json"
    saved = json.loads(path.read_text()) if path.exists() else {}
    for key, setter in (("mu_dtype", set_default_mu_dtype), ("nu_dtype", set_default_nu_dtype)):
        value = saved.get(key, "float32")
        setter(None if value == "float32" else value)


def interpolate(model, args: argparse.Namespace, generator: torch.Generator, out_dir: Path,
                which: str, step: int) -> np.ndarray:
    """``--interpolate N``: two samples, broadcast to N rows each and blended at lambdas
    ``linspace(0, 1, N)`` by the model's ``interpolate`` (its draws from a second
    generator), written as a one-row grid ``interpolation_<which>_step<step>.png``."""
    if not hasattr(model, "interpolate"):
        raise SystemExit(f"{type(model).__name__} does not support interpolate")
    n = args.interpolate
    ends = model.sample(generator, 2).float()
    x1 = ends[0].expand(n, *ends.shape[1:])
    x2 = ends[1].expand(n, *ends.shape[1:])
    lam = torch.linspace(0.0, 1.0, n, device=ends.device).reshape(n, 1, 1, 1)
    seed = np.random.SeedSequence([args.seed, 2]).generate_state(1)[0]
    blend_generator = torch.Generator(device=model.device).manual_seed(int(seed))
    images = model.interpolate(x1, x2, blend_generator, t=args.interpolate_t,
                               lam=lam).float().cpu().numpy()
    path = out_dir / f"interpolation_{which}_step{step}.png"
    if mesh_lib.is_main_process():
        out_dir.mkdir(parents=True, exist_ok=True)
        _write_png(path, make_grid(images, nrow=n))
        print(f"Wrote {path}")
    return images


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the sampled images, [N, H, W, C] in [0, 1] (with ``--fid``,
    the FID artifact)."""
    args = parse_args(argv)
    device = resolve_device(mesh_lib.initialize_distributed(args.device))
    mesh_lib.set_mesh(mesh_lib.create_mesh())
    config = load_config(args.config_path)
    run_dir = EXPERIMENT_DIR / config["model"]["name"] / (args.experiment_name or "")
    if args.experiment_name:
        use_run_moment_dtypes(run_dir)
    model = load_model(config["model"], device=device)
    name = type(model).__name__
    if (args.sampler != "auto" or args.sampling_steps) and \
            "method" not in inspect.signature(model.sample).parameters:
        raise SystemExit(f"{name} does not support --sampler/--sampling_steps "
                         "(diffusion models only)")
    if args.label is not None and not hasattr(model, "sample_classes"):
        raise SystemExit(f"{name} does not support --label (conditional models only)")
    step, which = 0, "weights" if args.weights else "seed"
    if args.weights:
        model.load_flax_weights(args.weights)
    else:
        model.init_params(torch.Generator().manual_seed(args.seed))
    if args.experiment_name:
        step, _ = CheckpointManager(run_dir / "checkpoints").restore(model, args.which)
        which = args.which

    generator = torch.Generator(device=device).manual_seed(args.seed)
    kwargs = {}
    if args.sampler != "auto" or args.sampling_steps:
        kwargs = {"method": None if args.sampler == "auto" else args.sampler,
                  "steps": args.sampling_steps or None}
    out_dir = (Path(args.out) if args.out
               else run_dir if args.experiment_name
               else EXPERIMENT_DIR / config["model"]["name"] / "generated_torch")
    if args.fid:
        return compute_fid(model, config, args, step, which, out_dir, kwargs)
    if args.interpolate:
        return interpolate(model, args, generator, out_dir, which, step)
    if args.label is not None and args.guidance_scale is not None:
        if "guidance_scale" not in inspect.signature(model.sample_classes).parameters:
            raise SystemExit(f"{name} does not support --guidance_scale")
        kwargs["guidance_scale"] = args.guidance_scale

    def draw(n: int) -> torch.Tensor:
        if args.label is None:
            return model.sample(generator, n, **kwargs)
        return model.sample_classes(
            generator, torch.full((n,), args.label, dtype=torch.long), **kwargs)

    images = mesh_lib.sample_rows(draw, args.num_samples).float().cpu().numpy()
    if not mesh_lib.is_main_process():
        return images
    out_dir.mkdir(parents=True, exist_ok=True)
    grid_path = out_dir / "grid.png"
    _write_png(grid_path, make_grid(images))
    print(f"Wrote {grid_path}")
    if args.save_individual:
        for i, img in enumerate(images):
            _write_png(out_dir / f"sample_{i:04d}.png",
                       (np.clip(img, 0, 1) * 255).astype(np.uint8))
        print(f"Wrote {len(images)} individual samples to {out_dir}")
    return images


if __name__ == "__main__":
    main()
