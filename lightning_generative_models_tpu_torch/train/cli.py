"""Training CLI of the port: the counterpart of the repo's ``train.py``.

    python -m lightning_generative_models_tpu_torch.train \
        --config_path configs/diffusion/ddpm_cifar10.json [--device cuda] [--max_steps N]

The flags keep ``train.py``'s names for what is ported, and add ``--device`` (cuda by
default; cpu only when asked). ``--eval test`` evaluates the test split from the
``--eval_which`` checkpoint instead of training and returns its ``test_`` metrics.
``--unroll_steps k`` runs k optimisation steps a dispatch (one CUDA graph of k steps on
the card, a loop on the CPU), ``--profile_steps start:stop`` writes one profiler trace
under ``<run>/profile/``, and ``--mu_dtype`` / ``--nu_dtype bfloat16`` keep Adam's
moments in bf16 (a resume must pass the same dtypes). ``--strategy`` fsdp/tp/pp raises
``NotImplementedError`` naming ROADMAP.md (the port trains on one device). Runs write to
``experiments/<model name>/<experiment_name>/``: ``metrics.jsonl``,
``samples/*.png``, ``checkpoints/{last,best}`` and their meta files.
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
import os
from datetime import datetime
from pathlib import Path

import torch

from lightning_generative_models_tpu_torch.config import load_config
from lightning_generative_models_tpu_torch.data.datamodule import (
    DataModule,
    PairedDataModule,
)
from lightning_generative_models_tpu_torch.experiment.logger import ExperimentLogger
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.registry import load_model, resolve_model_class
from lightning_generative_models_tpu_torch.train.state import (
    set_default_mu_dtype,
    set_default_nu_dtype,
)
from lightning_generative_models_tpu_torch.train.trainer import Trainer
from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

logger = logging.getLogger("train")


def setup_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Train with the PyTorch port")
    parser.add_argument("--config_path", type=str, required=True, help="Path to configs")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--check_val_every_n_epoch", type=int, default=5)
    parser.add_argument("--max_epochs", type=int, default=-1)
    parser.add_argument("--max_steps", type=int, default=-1)
    parser.add_argument("--strategy", type=str, default="data_parallel",
                        choices=("data_parallel", "ddp", "auto", "fsdp", "tp", "pp"),
                        help="data_parallel/ddp/auto: one device; fsdp/tp/pp are not "
                        "ported")
    parser.add_argument("--tp_size", type=int, default=0, help="for --strategy tp")
    parser.add_argument("--pp_size", type=int, default=0, help="for --strategy pp")
    parser.add_argument("--accumulate_grad_batches", type=int, default=1)
    parser.add_argument("--precision", type=str, default=None,
                        help="'bf16' forces bfloat16 compute, '32' float32, for models "
                        "with use_bf16")
    parser.add_argument("--mu_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="dtype of Adam's first moment; a resume must use the run's")
    parser.add_argument("--nu_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="dtype of Adam's second moment; a resume must use the run's")
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--seed", type=int, default=10)
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd anomaly detection")
    parser.add_argument("--sample_every_n_steps", type=int, default=1000,
                        help="mid-training sample-grid cadence (0 disables)")
    parser.add_argument("--unroll_steps", type=int, default=1,
                        help="optimisation steps a dispatch (one CUDA graph of k steps on "
                        "the card); global_step advances by k")
    parser.add_argument("--profile_steps", type=str, default=None,
                        help="'start:stop' global steps of one torch.profiler window; the "
                        "chrome trace goes to <run>/profile/")
    parser.add_argument("--grad_accum_mode", type=str, default="auto",
                        choices=("auto", "concat", "scan"))
    parser.add_argument("--eval", type=str, default=None, choices=("test",),
                        dest="eval_split",
                        help="evaluate the held-out test split from a checkpoint instead "
                        "of training")
    parser.add_argument("--eval_which", type=str, default="last", choices=("last", "best"),
                        help="which checkpoint --eval restores")
    parser.add_argument("--project", type=str, default="Lightning generative models")
    parser.add_argument("--experiment_name", type=str,
                        default=datetime.now().strftime("%Y-%m-%d_%H:%M"))
    parser.add_argument("--resume", action="store_true", help="Resume the run.")
    parser.add_argument("--id", type=str, default=None, help="Run ID to resume from.")
    parser.add_argument("--wandb", action="store_true", help="Mirror logs to W&B.")
    args = parser.parse_args(argv)
    if args.profile_steps:
        start, stop = (int(v) for v in args.profile_steps.split(":"))
        args.profile_steps = (start, stop)
    args.config = load_config(args.config_path)
    args.experiment_dir = os.path.join(
        EXPERIMENT_DIR, args.config["model"]["name"], args.experiment_name)
    return args


def _refuse_unported(args: argparse.Namespace) -> None:
    def refuse(what: str) -> None:
        raise NotImplementedError(f"{what} is not ported to the PyTorch package; see "
                                  "ROADMAP.md, Queue 1")

    if args.strategy in ("fsdp", "tp", "pp"):
        refuse(f"--strategy {args.strategy} (#11, scale-out)")
    resolve_model_class(args.config["model"]["name"])  # raises for an unknown name
    set_default_mu_dtype(None if args.mu_dtype == "float32" else args.mu_dtype)
    set_default_nu_dtype(None if args.nu_dtype == "float32" else args.nu_dtype)


def main(argv=None):
    """Run the CLI; returns the trained model (with ``--eval test``, the test
    metrics)."""
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = setup_arguments(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    torch.autograd.set_detect_anomaly(args.debug_nans)

    os.makedirs(args.experiment_dir, exist_ok=True)
    dump = {k: v for k, v in vars(args).items() if k != "config"}
    with open(os.path.join(args.experiment_dir, "args.json"), "w") as f:
        json.dump(dump, f, indent=2, default=str)
    with open(os.path.join(args.experiment_dir, Path(args.config_path).name), "w") as f:
        json.dump(args.config, f, indent=2)

    cls = resolve_model_class(args.config["model"]["name"])
    if args.precision and "use_bf16" in inspect.signature(cls.__init__).parameters:
        wants_bf16 = args.precision.lower() in ("bf16", "bfloat16", "16")
        args.config["model"]["args"].setdefault("use_bf16", wants_bf16)
    model = load_model(args.config["model"], device=device)
    paired = args.config["dataset"].pop("paired", None)
    if paired is None:
        paired = args.config["model"]["name"].lower() == "cyclegan"
    data_cls = PairedDataModule if paired else DataModule
    datamodule = data_cls(**args.config["dataset"], num_workers=args.num_workers)
    exp_logger = ExperimentLogger(
        args.experiment_dir, project=args.project, name=args.experiment_name,
        config={**args.config["model"], "dataset": args.config["dataset"]},
        use_wandb=args.wandb, resume=args.resume, run_id=args.id,
    )
    trainer = Trainer(
        model=model,
        datamodule=datamodule,
        experiment_dir=args.experiment_dir,
        exp_logger=exp_logger,
        max_epochs=args.max_epochs,
        max_steps=args.max_steps,
        check_val_every_n_epoch=args.check_val_every_n_epoch,
        accumulate_grad_batches=args.accumulate_grad_batches,
        seed=args.seed,
        sample_every_n_steps=args.sample_every_n_steps,
        grad_accum_mode=args.grad_accum_mode,
        strategy=args.strategy,
        unroll_steps=args.unroll_steps,
        profile_steps=args.profile_steps,
    )
    try:
        if args.eval_split == "test":
            metrics = trainer.test(which=args.eval_which)
            print(json.dumps(metrics, indent=2, sort_keys=True))
            return metrics
        return trainer.fit(ckpt_path=args.ckpt_path, resume=args.resume)
    finally:
        exp_logger.finish()
