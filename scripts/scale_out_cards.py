"""The strategies across cards: one f32 step of ddp, fsdp, tp (the DiT with sequence
parallelism), ep (DiT-MoE under tp) and pp (the 4-stage GPipe DiT) on N NCCL ranks, one
card each, held against the same step on one card on the global batch; then DDPM's bf16
train images/s on 1 and on N ranks at 128 rows a rank.

    python -m torch.distributed.run --standalone --nproc_per_node 4 scripts/scale_out_cards.py

Every case draws its weights from one seed (the DiTs' every weight then moved by
N(0, 0.02^2), so that adaLN-Zero's branches open) and trains one step on one seeded
global batch of the config's synthetic data, TF32 off and cuDNN deterministic: rank 0
alone with no mesh (the reference), then every rank under the strategy (its rows of the
batch, the global batch's draws). Held: the loss within 1e-5 relative; the gradient by
its norm within 1e-3, read from every weight's Adam first moment after the step (it is
(1 - b1) g from a fresh state: the gradient averaged over the ranks, so a rank that
skipped a reduction misses by about the gradient's own size). Rank 0 prints each case and
one JSON line, and writes chiprun_out/scale_out_cards.json; a case that misses raises, so
the run exits non-zero. Each case also prints the share of the weights' elements a rank holds under the strategy
(fsdp, tp and pp hold less than the whole). ``--device cpu --small`` runs the same cases
over gloo at small widths, fsdp sharding leaves of 1,024 elements and more there (a check
of the script, not a measurement). Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lightning_generative_models_tpu_torch.config import load_config  # noqa: E402
from lightning_generative_models_tpu_torch.data.datamodule import DataModule  # noqa: E402
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from lightning_generative_models_tpu_torch.registry import load_model  # noqa: E402

CONFIGS = ROOT / "configs" / "diffusion"
LOSS_TOL, GRADIENT_TOL = 1e-5, 1e-3
SMALL = {"ddpm": {"dim": 16, "dim_mults": [1, 2], "img_size": 16},
         "dit": {"dim": 32, "depth": 4, "num_heads": 4, "img_size": 16}}


def cases(n: int) -> list:
    """(name, config, strategy, tp_size, pp_size) of the run on ``n`` ranks."""
    out = [("ddp", "ddpm_cifar10.json", "ddp", 0, 0),
           ("fsdp", "ddpm_cifar10.json", "fsdp", 0, 0),
           (f"tp{n}_sp", "dit_cifar10_tp.json", "tp", n, 0),
           (f"ep{n}", "dit_moe_cifar10.json", "tp", n, 0)]
    if n == 4:
        out.append(("dp2_tp2_sp", "dit_cifar10_tp.json", "tp", 2, 0))
        out.append(("pp4", "dit_cifar10_pp.json", "pp", 0, 4))
    return out


def model_and_batch(name: str, device, small: bool, dtype_args: dict):
    config = load_config(CONFIGS / name)
    args = {**config["model"]["args"], **dtype_args}
    data = {**config["dataset"], "synthetic_size": 1280}
    if small:
        shrink = SMALL["dit" if args.get("network") == "dit" else "ddpm"]
        args.update(shrink)
        data.update(img_size=shrink["img_size"], batch_size=8)
    model = load_model({"name": config["model"]["name"], "args": args}, device=device)
    model.init_params(torch.Generator().manual_seed(17))
    if args.get("network") == "dit":
        gen = torch.Generator().manual_seed(18)
        with torch.no_grad():
            for p in model.unet.parameters():
                p.add_((torch.randn(p.shape, generator=gen) * 0.02).to(p.device))
        model.copy_params_to_ema()
    return model, next(DataModule(**data).train_batches(0))


def first_moments(model) -> dict:
    """Adam's first moment of every weight, whole (``gathered``), f32 on the host."""
    state = model.optimizer.state
    with mesh_lib.gathered(model):
        return {name: state[p]["exp_avg"].float().cpu().clone()
                for name, p in model.unet.named_parameters() if "exp_avg" in state.get(p, {})}


def one_step(model, batch: dict, device, rows: int) -> float:
    local = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    with mesh_lib.global_draws(rows):
        metrics = model.train_step(local, torch.Generator(device=device).manual_seed(19))
    return float(mesh_lib.data_mean(metrics["train_loss"]))


def gradient_gap(ref: dict, got: dict) -> float:
    """||mu_got - mu_ref|| / ||mu_ref|| over every weight's Adam first moment."""
    d = torch.cat([(got[k] - v).double().reshape(-1) for k, v in ref.items()])
    return float(d.norm() / torch.cat([v.double().reshape(-1) for v in ref.values()]).norm())


def run_case(case: tuple, device, small: bool) -> dict:
    name, config, strategy, tp_size, pp_size = case
    ref = None
    if dist.get_rank() == 0:
        mesh_lib.set_mesh(None)
        model, batch = model_and_batch(config, device, small, {"use_bf16": False})
        loss = one_step(model, batch, device, batch["image"].shape[0])
        ref = (first_moments(model), loss)
        del model
    dist.barrier()
    mesh_lib.set_mesh(None)
    model, batch = model_and_batch(config, device, small, {"use_bf16": False})
    whole = sum(p.numel() for p in model.unet.parameters())
    mesh = mesh_lib.strategy_mesh(strategy, tp_size, pp_size)
    if strategy == "tp":
        mesh_lib.validate_tp(model, mesh)
    elif strategy == "pp":
        mesh_lib.validate_pp(model, mesh)
    mesh_lib.shard_model(model, strategy, mesh)
    local = mesh_lib.local_rows(batch)
    loss = one_step(model, local, device, local["image"].shape[0])
    held = sum(p.numel() for p in model.unet.parameters()) / whole
    got = first_moments(model)
    mesh_lib.set_mesh(None)
    del model
    if ref is None:
        return {}
    after, ref_loss = ref
    out = {"loss": loss, "one_card_loss": ref_loss,
           "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
           "gradient_gap": gradient_gap(after, got), "mesh": dict(mesh.shape),
           "weights_held": held}
    out["ok"] = out["loss_rel"] <= LOSS_TOL and out["gradient_gap"] <= GRADIENT_TOL
    print(f"  {name} on {dict(mesh.shape)}: loss {loss:.6f} against one card's "
          f"{ref_loss:.6f} (rel {out['loss_rel']:.3e}), gradient (Adam's first moment) by "
          f"its norm {out['gradient_gap']:.3e}; rank 0 holds {held:.4f} of the weights",
          flush=True)
    return out


def images_per_sec(device, small: bool, steps: int) -> dict:
    """DDPM bf16 train steps at 128 rows a rank (8 with --small): one card alone, then
    every rank under ddp (the global batch 128 N); host clock around steps that end in a
    synchronize, after 2 warm-up steps."""
    def timed(model, batch, together: bool) -> float:
        local = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        gen = torch.Generator(device=device).manual_seed(0)
        for _ in range(2):
            model.train_step(local, gen)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if together:  # the ranks start their timed steps at once
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_step(local, gen)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    n = dist.get_world_size()
    out = {}
    if dist.get_rank() == 0:
        mesh_lib.set_mesh(None)
        model, batch = model_and_batch("ddpm_cifar10.json", device, small, {})
        out["one_card_s_per_step"] = timed(model, batch, together=False)
        del model
    dist.barrier()
    mesh_lib.set_mesh(None)
    model, batch = model_and_batch("ddpm_cifar10.json", device, small, {})
    mesh_lib.shard_model(model, "ddp", mesh_lib.strategy_mesh("ddp"))
    step_s = timed(model, batch, together=True)
    mesh_lib.set_mesh(None)
    if dist.get_rank() == 0:
        rows = batch["image"].shape[0]
        out.update(ddp_s_per_step=step_s, ranks=n, rows_per_rank=rows,
                   one_card_images_per_s=rows / out["one_card_s_per_step"],
                   ddp_images_per_s=n * rows / step_s)
        out["scaling_efficiency"] = out["ddp_images_per_s"] / (n * out["one_card_images_per_s"])
        print(f"  DDPM bf16 train: one card {out['one_card_images_per_s']:.1f} images/s, "
              f"{n} ranks under ddp {out['ddp_images_per_s']:.1f} images/s "
              f"({out['scaling_efficiency']:.3f} of {n}x)", flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    if args.small:
        mesh_lib.FSDP_MIN_SIZE = 1024
    device = mesh_lib.initialize_distributed(args.device, timeout_s=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    main_rank = dist.get_rank() == 0
    if main_rank and device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
        print(f"cards: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    results = {case[0]: run_case(case, device, args.small)
               for case in cases(dist.get_world_size())}
    results["throughput"] = images_per_sec(device, args.small, args.steps)
    if main_rank:
        results["wall_s"] = time.perf_counter() - t0
        line = json.dumps(results)
        print(line, flush=True)
        out = ROOT / "chiprun_out" / "scale_out_cards.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
        missed = [k for k, v in results.items() if isinstance(v, dict) and v.get("ok") is False]
        if missed:
            raise SystemExit(f"missed: {missed}")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
