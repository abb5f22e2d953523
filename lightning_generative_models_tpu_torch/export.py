"""Export CLI of the port: freeze a trained sampler into one serving artifact.

Counterpart of the repo's ``export.py``. Restores a port run from
``experiments/<MODEL>/<experiment_name>/`` (``--which`` last or best, with the run's Adam
moment dtypes from its ``args.json``), freezes its sampler with
``serving.export_sampler`` (the weights, the sampler, its step count and a ``--label`` baked
in) and writes ``<exp_dir>/exported/<model>_sample_bs<B><suffix>.pt2`` with its JSON
sidecar, which a serving process loads with ``serving.load_artifact`` and calls with a
seed. ``--device`` (default cuda) takes the place of the JAX CLI's ``--platforms``: the
artifact runs on the device it was exported on. ``--smoke`` reloads the artifact and runs
one batch.

    python -m lightning_generative_models_tpu_torch.export \\
        --config_path configs/diffusion/ddim_cifar10.json --experiment_name my_run \\
        --batch 64 [--sampler ddim --sampling_steps 50] [--label 3] [--smoke]
"""

from __future__ import annotations

import argparse
import inspect
import time
from pathlib import Path

import torch

from lightning_generative_models_tpu_torch.config import load_config
from lightning_generative_models_tpu_torch.generate import use_run_moment_dtypes
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.serving import (
    export_sampler,
    load_artifact,
    save_artifact,
)
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Export a frozen sampler for serving")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--which", type=str, default="last", choices=["last", "best"])
    parser.add_argument("--batch", type=int, default=64,
                        help="static serving batch size baked into the artifact")
    parser.add_argument(
        "--sampler", type=str, default="auto",
        choices=["auto", "ddpm", "ddim", "dpmpp", "heun", "euler",
                 "midpoint", "onestep", "multistep"],
        help="sampler baked into the artifact: ddpm/ddim/dpmpp for the diffusion family, "
        "heun/euler for EDM, euler/midpoint/heun for flow matching, onestep/multistep "
        "for consistency models (each family validates its own names)",
    )
    parser.add_argument("--sampling_steps", type=int, default=0,
                        help="sampler step-count override (diffusion; 0 = config value)")
    parser.add_argument("--label", type=int, default=None,
                        help="bake a fixed class label (conditional models; the whole "
                        "batch samples this class)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device the artifact is exported for and runs on (cuda or cpu)")
    parser.add_argument("--out", type=str, default=None,
                        help="output path (default: <exp_dir>/exported/...)")
    parser.add_argument("--smoke", action="store_true",
                        help="after writing, reload the artifact and run one batch")
    return parser.parse_args(argv)


def main(argv=None) -> Path:
    """Run the CLI; returns the artifact's path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config_path)
    name = config["model"]["name"]
    exp_dir = Path(EXPERIMENT_DIR) / name / args.experiment_name
    use_run_moment_dtypes(exp_dir)
    model = load_model(config["model"], device=device)
    step, _ = CheckpointManager(exp_dir / "checkpoints").restore(model, args.which)
    print(f"Restored {args.which} checkpoint at step {step} from {exp_dir}")

    method = None if args.sampler == "auto" else args.sampler
    steps = args.sampling_steps or None
    labels = [args.label] * args.batch if args.label is not None else None
    if (method or steps) and labels is None and \
            "method" not in inspect.signature(model.sample).parameters:
        raise SystemExit(f"{type(model).__name__} does not support --sampler/"
                         "--sampling_steps (diffusion models only)")

    t0 = time.perf_counter()
    exported = export_sampler(model, args.batch, method=method, steps=steps, labels=labels,
                              device=str(device))
    export_s = time.perf_counter() - t0

    suffix = "" if args.sampler == "auto" and not args.sampling_steps else (
        f"_{args.sampler}{args.sampling_steps or ''}")
    if args.label is not None:
        suffix += f"_label{args.label}"
    out_path = (Path(args.out) if args.out
                else exp_dir / "exported" / f"{name.lower()}_sample_bs{args.batch}{suffix}.pt2")
    sidecar = save_artifact(exported, out_path, meta={
        "model": name,
        "checkpoint": args.which,
        "step": int(step),
        "batch": args.batch,
        "sampler": args.sampler,
        "sampling_steps": args.sampling_steps or None,
        "label": args.label,
        "export_seconds": export_s,
    })
    print(f"Wrote {out_path} ({sidecar['size_bytes'] / 1e6:.1f} MB, device="
          f"{sidecar['device']}, output={sidecar['output_shape']} {sidecar['output_dtype']}) "
          f"in {export_s:.1f} s")

    if args.smoke:
        artifact = load_artifact(out_path)
        images = artifact(1).float()
        if tuple(images.shape) != tuple(sidecar["output_shape"]):
            raise SystemExit(f"smoke run: output {tuple(images.shape)}, sidecar says "
                             f"{sidecar['output_shape']}")
        if not bool(torch.isfinite(images).all()):
            raise SystemExit("smoke run: non-finite sample output")
        print(f"Smoke run OK: {tuple(images.shape)} {images.dtype}, range "
              f"[{images.min().item():.3f}, {images.max().item():.3f}]")
    return out_path


if __name__ == "__main__":
    main()
