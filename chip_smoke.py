#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. versions, the card's name and power limit; TF32 off for matmuls and convs;
     build every CUDA kernel from the sources in the checkout (one nvcc per source,
     all started together), with ptxas' registers and spills;
  2. each kernel against its plain PyTorch version on the card: the forward at the
     sampling path's shapes (batch 64, bf16) and at batch 128 in f32 and bf16, with
     and without the residual, plus a head-scale-disparity input; the backward at the
     training batch (128) in f32 and bf16, residual on and off, plus the disparity
     input, with two calls compared bit for bit; the autograd path (forward kernel +
     backward kernel) against torch autograd through the plain version; times by
     CUDA events;
  3. card against CPU, f32, the same weights and inputs: the full-width DDPM UNet
     (dim 64) forward, a 3-step DDIM chain, and one train step's loss and gradients;
  4. sampling path: the port's generate entry point samples DDIM-50 at batch 64 in
     bf16 from configs/diffusion/ddim_cifar10.json, with every launch count set to
     0 just before and read just after;
  5. DDIM-50 samples/s at batch 64 and 128 with the model built, and one batch-64
     run under torch.profiler (full table in chiprun_out/chip_smoke/profile.txt);
  6. training path: the port's train entry point trains the full-width DDPM (batch
     128, bf16, synthetic CIFAR-10) for 120 steps, validates with the EMA weights
     and samples a DDIM-50 grid, with every launch count set to 0 just before and
     read just after; then a --resume of 10 more steps;
  7. train images/s at batch 128 (median of 3 timings of 20 steps) and one step
     under torch.profiler (full table in chiprun_out/chip_smoke/train_profile.txt);
  8. a JSON line of the kernels, the card's line, and the last line
     {"ok": true, "device": {...}}.
It needs no network and exits non-zero, printing no result, without a CUDA GPU or
outside a checkout of the repo.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "diffusion" / "ddim_cifar10.json"
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
TRAIN_RUN = "chip_smoke_train"  # experiments/DDPM/<this>: the train entry point's run

# H100 SXM peaks (NVIDIA data sheet, dense): the least time for a kernel's work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores

# Tolerances of a kernel against its plain version, on max |k - p| / (1 + |p|):
# f32 differs by the order of f32 sums; bf16 by rounding points (the kernel keeps
# q, k, v and y in f32 where the plain version rounds them), a few bf16 ulps.
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
# The backward kernel against its plain version, on max |k - p| / (1 + max |p|) per
# tensor (the weight grads are sums over b * n tokens: scaled by the tensor's largest
# magnitude, not element by element). f32: the order of f32 sums. bf16: both round at
# _bwd_kernel's points, but an f32 sum taken in another order can land one bf16 ulp
# (2^-8 = 3.9e-3) away before a rounding and carry it into the later products.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
UNET_TOL = 1e-3  # f32 UNet / DDIM chain, card against CPU, relative to max(1, max|ref|)
# f32 train step, card against CPU: loss relative to |ref|; each parameter gradient
# as max |k - p| / max |p| (a gradient's scale is its own: some are ~1e-4).
GRAD_TOL = 1e-3
TRAIN_BATCH = 128
TRAIN_STEPS = 120  # past step 100, where the EMA's hard copy ends: one decay at 110
RESUME_STEPS = 10

# (n, c) of the UNet's six linear-attention calls per evaluation (dim 64, 32 px).
LA_SHAPES = [(1024, 64), (256, 64), (256, 128), (64, 128), (64, 256), (1024, 64)]
MAIN_BATCH = 64
DDIM_STEPS = 50

# Device kernels grouped by a mark in their names, for the profile's summary.
PROFILE_GROUPS = {
    "linear attention (csrc/linear_attention.cu)": ("context_kernel", "output_kernel"),
    "linear attention backward (csrc/linear_attention_bwd.cu)": (
        "stats_kernel", "token_a_kernel", "context_grad_kernel", "token_b_kernel",
        "atb_partial_kernel", "reduce_rows_kernel"),
    "optimizer and EMA (foreach)": ("multi_tensor_apply",),
    "convolution (cuDNN)": ("fprop", "convolve", "cudnn", "nhwcAddPadding"),
    "matmul (cuBLAS)": ("gemm", "nvjet", "splitKreduce"),
    "elementwise and other": (),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def la_inputs(b, n, c, dtype, gen, m=4, disparity=False):
    import torch

    hd = 128
    kw = dict(device="cuda", generator=gen)
    x = torch.randn(b, n, c, **kw).to(dtype)
    g0 = torch.randn(c, **kw) * 0.1 + 1.0
    wqkv = torch.randn(c, 3 * hd, **kw) * c**-0.5
    if disparity:  # head 0's q logits ~300x the others'
        wqkv[:, :32] *= 300.0
    mem = torch.randn(2, 4, 32, m, **kw)
    wo = torch.randn(hd, c, **kw) * hd**-0.5
    bo = torch.randn(c, **kw) * 0.1
    g1 = torch.randn(c, **kw) * 0.1 + 1.0
    return [x, g0, wqkv, mem, wo, bo, g1]


def la_bound_ms(b, n, c, dtype, m=4):
    """(bytes ms, operations ms) of one call: each input read once and the output
    written once at the memory rate; the block's flops at the peak rate of the compute
    type. The least time the card could take is the larger of the two."""
    elt = 2 if dtype == "bfloat16" else 4
    params = 4 * (c * 384 + 2 * 128 * m + 128 * c + 3 * c)
    nbytes = 2 * b * n * c * elt + params
    per_token = 2 * c * 384 + 2 * 4 * 32 * 32 + 2 * 4 * 32 * 32 + 2 * 128 * c
    flops = b * n * per_token + b * 4 * 2 * m * 32 * 32
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype]


def check_linear_attention(torch, la) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(128, n, c, dt, res, False) for (n, c) in LA_SHAPES[:5]
             for dt in ("float32", "bfloat16") for res in (True, False)]
    cases += [(128, 64, 64, dt, True, True) for dt in ("float32", "bfloat16")]
    cases += [(MAIN_BATCH, n, c, "bfloat16", True, False) for (n, c) in LA_SHAPES[:5]]
    main_err, shapes = 0.0, []
    for b, n, c, dt, res, disp in cases:
        dtype = getattr(torch, dt)
        args = la_inputs(b, n, c, dtype, gen, disparity=disp)
        out = la.linear_attention_cuda(*args, 4, 32, dtype, res)
        ref = la.linear_attention_plain(*args, 4, 32, dtype, res)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        abs_err = diff.max().item()
        rel_err = (diff / (1 + ref.float().abs())).max().item()
        finite = bool(torch.isfinite(out.float()).all())
        # Disparity in bf16: head 0's logits (~1e3) round to bf16 steps of ~4 in the
        # plain version and not in the kernel, so their softmaxes differ by design (the
        # JAX package's own disparity test is f32). What must hold is finiteness.
        ok = finite and (rel_err <= TOL[dt] or (disp and dt == "bfloat16"))
        print(f"  linear_attention b={b} n={n} c={c} {dt} residual={res} disparity={disp}: "
              f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} tol={TOL[dt]:.0e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"linear_attention kernel disagrees with its plain version at b={b} "
                 f"n={n} c={c} {dt} residual={res}")
        if not (disp and dt == "bfloat16"):
            worst[dt] = max(worst[dt], rel_err)
        if b == MAIN_BATCH:
            main_err = max(main_err, abs_err)
        if res and not disp and dt == "bfloat16":
            ms = time_ms(lambda: la.linear_attention_cuda(*args, 4, 32, dtype, True))
            plain_ms = time_ms(lambda: la.linear_attention_plain(*args, 4, 32, dtype, True))
            bytes_ms, ops_ms = la_bound_ms(b, n, c, dt)
            shapes.append({"b": b, "n": n, "c": c, "dtype": dt, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                           "bytes_ms": bytes_ms, "ops_ms": ops_ms})
            print(f"  time b={b} n={n} c={c} {dt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                  f" bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
                  f"operations {ops_ms:.4f})", flush=True)
    # One UNet evaluation of the main path runs the (1024, 64) shape twice.
    per_eval = [s for s in shapes if s["b"] == MAIN_BATCH]
    per_eval = per_eval + [per_eval[0]]
    return {
        "max_abs_err": main_err,
        "ms": sum(s["ms"] for s in per_eval),
        "plain_ms": sum(s["plain_ms"] for s in per_eval),
        "bound_ms": sum(s["bound_ms"] for s in per_eval),
        "bound_by": ("bytes" if sum(s["bytes_ms"] for s in per_eval)
                     > sum(s["ops_ms"] for s in per_eval) else "operations"),
        "worst_rel_err": worst,
        "shapes": shapes,
    }


def la_bwd_bound_ms(b, n, c, dtype, m=4):
    """(bytes ms, operations ms) of one backward call: x and dout read and dx written
    once, the f32 parameters read once and their f32 gradients written once; the
    flops of _bwd_kernel's per-token products, per head (3072 c + 49152 a token), and
    the memory tokens' terms (6 m 4096 a batch row)."""
    elt = 2 if dtype == "bfloat16" else 4
    params = 4 * (c * 384 + 2 * 128 * m + 128 * c + 3 * c)
    nbytes = 3 * b * n * c * elt + 2 * params
    flops = b * n * (3072 * c + 49152) + b * 6 * m * 4096
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype]


def grad_err(k, p) -> float:
    """max |k - p| / (1 + max |p|)."""
    k, p = k.float(), p.float()
    return ((k - p).abs().max() / (1.0 + p.abs().max())).item()


def check_linear_attention_bwd(torch, la) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = ("dx", "dg0", "dqkv_kernel", "dmem_kv", "dout_kernel", "dout_bias", "dg1")
    cases = [(TRAIN_BATCH, n, c, dt, res, False) for (n, c) in LA_SHAPES[:5]
             for dt in ("float32", "bfloat16") for res in (True, False)]
    cases.append((TRAIN_BATCH, 64, 64, "float32", True, True))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    main_err, shapes = 0.0, []
    for b, n, c, dt, res, disp in cases:
        dtype = getattr(torch, dt)
        args = la_inputs(b, n, c, dtype, gen, disparity=disp)
        dout = torch.randn(b, n, c, device="cuda", generator=gen).to(dtype)
        out = la.linear_attention_bwd_cuda(*args, dout, 4, 32, dtype, res)
        again = la.linear_attention_bwd_cuda(*args, dout, 4, 32, dtype, res)
        ref = la.linear_attention_bwd_plain(*args, dout, 4, 32, dtype, res)
        torch.cuda.synchronize()
        errs = [grad_err(k, p) for k, p in zip(out, ref)]
        abs_err = max((k.float() - p.float()).abs().max().item() for k, p in zip(out, ref))
        finite = all(bool(torch.isfinite(k.float()).all()) for k in out)
        same = all(torch.equal(k, k2) for k, k2 in zip(out, again))
        ok = finite and same and max(errs) <= BWD_TOL[dt]
        print(f"  linear_attention_bwd b={b} n={n} c={c} {dt} residual={res} "
              f"disparity={disp}: max_abs_err={abs_err:.3e} rel_err "
              + " ".join(f"{nm}={e:.2e}" for nm, e in zip(names, errs))
              + f" tol={BWD_TOL[dt]:.0e} bit-identical repeat={same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"linear_attention backward kernel disagrees with its plain version or "
                 f"repeats differently at b={b} n={n} c={c} {dt} residual={res}")
        worst[dt] = max(worst[dt], max(errs))
        if res and not disp and dt == "bfloat16":
            main_err = max(main_err, abs_err)
            ms = time_ms(lambda: la.linear_attention_bwd_cuda(*args, dout, 4, 32, dtype, True))
            plain_ms = time_ms(
                lambda: la.linear_attention_bwd_plain(*args, dout, 4, 32, dtype, True))
            bytes_ms, ops_ms = la_bwd_bound_ms(b, n, c, dt)
            shapes.append({"b": b, "n": n, "c": c, "dtype": dt, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                           "bytes_ms": bytes_ms, "ops_ms": ops_ms})
            print(f"  time bwd b={b} n={n} c={c} {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
                  f"{bytes_ms:.4f}, operations {ops_ms:.4f})", flush=True)
    # One train step runs the (1024, 64) shape twice.
    per_step = shapes + [shapes[0]]
    return {
        "max_abs_err": main_err,
        "ms": sum(s["ms"] for s in per_step),
        "plain_ms": sum(s["plain_ms"] for s in per_step),
        "bound_ms": sum(s["bound_ms"] for s in per_step),
        "bound_by": ("bytes" if sum(s["bytes_ms"] for s in per_step)
                     > sum(s["ops_ms"] for s in per_step) else "operations"),
        "worst_rel_err": worst,
        "shapes": shapes,
    }


def check_autograd(torch, la) -> None:
    """FusedLinearAttention (forward kernel + backward kernel) against torch autograd
    through the plain version, f32."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = la_inputs(16, 256, 128, torch.float32, gen)
    dout = torch.randn(16, 256, 128, device="cuda", generator=gen)
    grads = []
    for fn in (la.linear_attention, la.linear_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in base]
        fn(*leaves, 4, 32, torch.float32, True).backward(dout)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    err = max(grad_err(k, p) for k, p in zip(*grads))
    ok = err <= BWD_TOL["float32"]
    print(f"  autograd b=16 n=256 c=128 f32, kernels vs autograd through plain: "
          f"rel_err {err:.2e} tol {BWD_TOL['float32']:.0e} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("FusedLinearAttention's gradients disagree with autograd through the plain "
             "version")


def check_train_step(torch) -> None:
    """One f32 train step of the full-width UNet at batch 4, card against CPU, from the
    same weights (seed 0), batch, flips, t and noise: loss and every gradient."""
    import numpy as np

    from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM

    rs = np.random.RandomState(4)
    batch = {"image": rs.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8),
             "label": np.zeros(4, np.int32)}
    draws = {"flip": torch.tensor([True, False, True, False]),
             "t": torch.tensor([0, 250, 500, 999]),
             "noise": torch.tensor(rs.randn(4, 32, 32, 3).astype(np.float32))}
    results = []
    for dev in ("cpu", "cuda"):
        model = DDPM(img_size=32, dim=64, use_bf16=False, device=dev)
        grads, metrics = model.grad_step(batch, **draws)
        results.append((float(metrics["loss"]), [g.float().cpu() for g in grads]))
    (ref_loss, ref), (loss, out) = results
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    worst = max(((k - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
                for k, p in zip(out, ref))
    ok = np.isfinite(loss) and loss_err <= GRAD_TOL and worst <= GRAD_TOL
    print(f"  train step f32 bs4 full width, card vs CPU: loss {loss:.6f} vs {ref_loss:.6f}"
          f" (rel {loss_err:.2e}); worst gradient max|k - p| / max|p| = {worst:.2e} over "
          f"{len(out)} tensors; tol {GRAD_TOL:.0e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("train step: card and CPU disagree")


def check_unet_and_ddim(torch) -> None:
    import copy

    from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
    from lightning_generative_models_tpu_torch.models.diffusion.unet import UNet
    from lightning_generative_models_tpu_torch.models.modules.layers import init_params

    def report(name, out, ref):
        err = (out.float().cpu() - ref.float()).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        ok = bool(torch.isfinite(out).all()) and err <= UNET_TOL * scale
        print(f"  {name}: max_abs_err={err:.3e} (max|ref|={scale:.3f}, tol "
              f"{UNET_TOL:.0e} x max(1, max|ref|)) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name}: card and CPU disagree")

    gen = torch.Generator().manual_seed(1)
    cpu_net = init_params(UNet(dim=64, dim_mults=(1, 2, 4, 8)), gen)
    gpu_net = copy.deepcopy(cpu_net).cuda()
    x = torch.randn(4, 32, 32, 3, generator=gen)
    t = torch.tensor([0, 250, 500, 999])
    with torch.inference_mode():
        ref = cpu_net(x, t)
        out = gpu_net(x.cuda(), t.cuda())
    report("UNet dim 64 f32 bs4 forward, card vs CPU", out, ref)

    args = dict(img_size=32, dim=64, diffusion_timesteps=1000, sampling_timesteps=50,
                use_bf16=False)
    x_T = torch.randn(2, 32, 32, 3, generator=gen)
    samples = [DDPM(**args, device=dev).sample(None, 2, steps=3, x_T=x_T)
               for dev in ("cpu", "cuda")]
    report("DDIM-3 f32 bs2 from one x_T, card vs CPU", samples[1], samples[0])


def profile_summary(torch, prof, wall_us: float, what: str, out_name: str,
                    card: str) -> dict:
    """Print the device's busy share of ``wall_us`` and its time by kernel group from a
    torch.profiler run; write the full table to chiprun_out/chip_smoke/<out_name>."""
    # Kernels only: a user annotation (Optimizer.step#Adam.step) also carries device
    # time, the span of the kernels inside it, and would count them twice.
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        print("  profiler: no device time recorded; busy share not measured")
        return {}
    launches = sum(e.count for e in events)
    print(f"  profiled {what}: wall {wall_us / 1e3:.1f} ms (profiler on), device busy "
          f"{busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.1f}% of wall, {launches} "
          f"kernel launches on {card}")
    groups = dict.fromkeys(PROFILE_GROUPS, 0.0)
    for e in events:
        group = next((g for g, marks in PROFILE_GROUPS.items()
                      if any(mark in e.key for mark in marks)), "elementwise and other")
        groups[group] += e.self_device_time_total
    for group, us in groups.items():
        print(f"    {group}: {us / 1e3:.2f} ms, {100 * us / busy_us:.1f}% of device time")
    lines = [f"{100 * e.self_device_time_total / busy_us:6.2f}%  "
             f"{e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:110]}"
             for e in events]
    for line in lines[:12]:
        print("   ", line)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / out_name).write_text("\n".join(lines) + "\n")
    return {"busy_us": busy_us, "wall_us": wall_us, "launches": launches}


def sampling_breakdown(torch, card: str, repeats: int = 3) -> None:
    """DDIM-50 samples/s with the model already built (host clock around work that
    ends in a synchronize, median of ``repeats``), then one bs64 run under
    torch.profiler: the device's busy share of the wall time and the kernels that
    take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.registry import load_model

    model = load_model(load_config(CONFIG)["model"], device="cuda")
    model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(batch):
        model.sample(gen, batch)
        torch.cuda.synchronize()

    for batch in (MAIN_BATCH, 2 * MAIN_BATCH):
        run(batch)  # warm-up
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(batch)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        print(f"  DDIM-{DDIM_STEPS} bs{batch} bf16: {wall:.4f} s median of "
              f"{[round(w, 4) for w in walls]}, {batch / wall:.2f} samples/s, "
              f"{1e3 * wall / DDIM_STEPS:.3f} ms per UNet evaluation on {card}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(MAIN_BATCH)
        wall_us = 1e6 * (time.perf_counter() - t0)
    profile_summary(torch, prof, wall_us, f"DDIM-{DDIM_STEPS} bs{MAIN_BATCH}", "profile.txt",
                    card)


def read_metrics(run_dir: Path) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def train_main_path(torch, la, card: str) -> dict:
    """The train entry point at full width, batch 128, bf16, on synthetic CIFAR-10:
    TRAIN_STEPS steps, then validation (EMA weights) and a DDIM-50 grid of 64; then
    a resume of RESUME_STEPS more. Returns each run's launch counts."""
    from lightning_generative_models_tpu_torch import train
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run_dir = EXPERIMENT_DIR / "DDPM" / TRAIN_RUN
    shutil.rmtree(run_dir, ignore_errors=True)
    val_batches = len(list(DataModule(**load_config(CONFIG)["dataset"]).val_batches()))
    argv = ["--config_path", str(CONFIG), "--device", "cuda", "--experiment_name",
            TRAIN_RUN, "--check_val_every_n_epoch", "1000", "--sample_every_n_steps", "0"]
    counts = {}
    for name, steps, extra in (("train", TRAIN_STEPS, []),
                               ("resume", TRAIN_STEPS + RESUME_STEPS, ["--resume"])):
        torch.cuda.synchronize()
        la.linear_attention.launches = 0
        la.linear_attention_bwd.launches = 0
        t0 = time.perf_counter()
        model = train.main(argv + ["--max_steps", str(steps)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = la.linear_attention.launches, la.linear_attention_bwd.launches
        new_steps = steps - (0 if name == "train" else TRAIN_STEPS)
        want_fwd = 6 * new_steps + 6 * val_batches + 6 * DDIM_STEPS
        want_bwd = 6 * new_steps
        counts[name] = {"forward": fwd, "backward": bwd}
        print(f"  {name}: {new_steps} steps to step {model.step} in {wall:.1f} s (model "
              f"build, data, validation, the grid and checkpoints included) on {card}")
        print(f"  {name}: linear_attention launches {fwd} (expected 6 x {new_steps} steps "
              f"+ 6 x {val_batches} validation batches + 6 x {DDIM_STEPS} grid = "
              f"{want_fwd}), backward launches {bwd} (expected {want_bwd})", flush=True)
        if (fwd, bwd) != (want_fwd, want_bwd):
            fail(f"the {name} run launched the kernels {fwd} + {bwd} times")
        if model.step != steps:
            fail(f"the {name} run ended at step {model.step}, not {steps}")

    records = read_metrics(run_dir)
    train_records = [r for r in records if "train_loss" in r]
    losses = [r["train_loss"] for r in train_records]
    print("  train_loss by step: " + ", ".join(
        f"{r['step']}: {r['train_loss']:.4f}" for r in train_records))
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        fail("a train loss is not finite")
    if not losses[-1] < losses[0]:
        fail(f"the train loss did not fall: {losses[0]} -> {losses[-1]}")
    if train_records[-1]["step"] != TRAIN_STEPS + RESUME_STEPS - 1:
        fail("the resumed run did not log its last step")
    val = [r["val_loss"] for r in records if "val_loss" in r]
    if len(val) != 2 or not all(v == v for v in val):
        fail(f"expected one finite val_loss per run, got {val}")
    pngs = sorted((run_dir / "samples").glob("random_generation_*.png"))
    if len(pngs) != 2:
        fail(f"expected a sample grid per run, found {[p.name for p in pngs]}")
    for which in ("last", "best"):
        if not (run_dir / "checkpoints" / f"checkpoint_meta_{which}.json").exists():
            fail(f"no {which} checkpoint meta")
    last = json.loads((run_dir / "checkpoints" / "checkpoint_meta_last.json").read_text())
    print(f"  val_loss (EMA weights) {val}; grids {[p.name for p in pngs]}; last "
          f"checkpoint at step {last['step']}; images/s logged at the last step "
          f"{train_records[-1]['images_per_sec']:.1f}")
    return counts


def train_breakdown(torch, card: str, steps: int = 20, repeats: int = 3) -> dict:
    """Train images/s at batch 128, bf16, with the model built and warmed up (host
    clock around ``steps`` steps that end in a synchronize, median of ``repeats``),
    then one step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model

    config = load_config(CONFIG)
    model = load_model(config["model"], device="cuda")
    it = DataModule(**config["dataset"]).train_batches(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()} for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(n):
        for i in range(n):
            model.train_step(batches[i % len(batches)], gen)
        torch.cuda.synchronize()

    run(5)  # warm-up: cuDNN plans, the allocator
    # Past the EMA's hard-copy phase, as in a long run: a decay every 10th step.
    model.step = model.ema_update_after_step
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(steps)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    ips = steps * TRAIN_BATCH / wall
    print(f"  train bs{TRAIN_BATCH} bf16: {1e3 * wall / steps:.2f} ms per step, median of "
          f"{[round(w, 4) for w in walls]} s per {steps} steps, {ips:.1f} images/s on "
          f"{card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = profile_summary(torch, prof, wall_us, f"one train step bs{TRAIN_BATCH}",
                              "train_profile.txt", card)
    return {"images_per_s": ips, "ms_per_step": 1e3 * wall / steps, **summary}


def main() -> None:
    import numpy as np
    import torch

    if not (CONFIG.exists() and (ROOT / "lightning_generative_models_tpu_torch").is_dir()):
        fail(f"{ROOT} is not a checkout of the repo: chip_smoke.py runs from its root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lightning_generative_models_tpu_torch import generate
    from lightning_generative_models_tpu_torch.ops import cuda_build
    from lightning_generative_models_tpu_torch.ops import linear_attention as la

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    logs = cuda_build.build(["linear_attention", "linear_attention_bwd"], verbose=True)
    print(f"  built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())

    print("[2] kernels against their plain versions", flush=True)
    with torch.inference_mode():
        la_stats = check_linear_attention(torch, la)
        bwd_stats = check_linear_attention_bwd(torch, la)
    check_autograd(torch, la)

    print("[3] card against CPU", flush=True)
    check_unet_and_ddim(torch)
    check_train_step(torch)

    print(f"[4] sampling path: generate DDIM-{DDIM_STEPS} bs{MAIN_BATCH} bf16", flush=True)
    argv = ["--config_path", str(CONFIG), "--num_samples", str(MAIN_BATCH),
            "--device", "cuda", "--seed", "0", "--out", str(OUT_DIR)]
    generate.main(argv + ["--sampling_steps", "2"])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    la.linear_attention.launches = 0
    la.linear_attention_bwd.launches = 0
    t0 = time.perf_counter()
    images = generate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = la.linear_attention.launches
    print(f"  wall {wall:.3f} s, {MAIN_BATCH / wall:.2f} samples/s "
          f"(model build, init and PNG included) on {card}")
    print(f"  linear_attention launches: {launches} (expected {6 * DDIM_STEPS}), "
          f"backward launches: {la.linear_attention_bwd.launches} (expected 0)")
    if images.shape != (MAIN_BATCH, 32, 32, 3):
        fail(f"samples have shape {images.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
        fail("samples are not finite values in [0, 1]")
    if launches != 6 * DDIM_STEPS or la.linear_attention_bwd.launches:
        fail(f"the sampling path launched the kernels {launches} + "
             f"{la.linear_attention_bwd.launches} times")
    if not (OUT_DIR / "grid.png").exists():
        fail("generate wrote no grid.png")

    print("[5] sampling throughput and where the time goes", flush=True)
    sampling_breakdown(torch, card, repeats=2)

    print(f"[6] training path: train {TRAIN_STEPS} steps bs{TRAIN_BATCH} bf16, then resume",
          flush=True)
    train_counts = train_main_path(torch, la, card)

    print("[7] train throughput and where the time goes", flush=True)
    train_stats = train_breakdown(torch, card)

    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "lightning_generative_models_tpu_torch/csrc/linear_attention.cu",
        "replaces": "lightning_generative_models_tpu/ops/linear_attention.py:173",
        "launches": launches,
        "launches_by_path": {"generate": launches,
                             "train": train_counts["train"]["forward"],
                             "resume": train_counts["resume"]["forward"]},
        "max_abs_err": la_stats["max_abs_err"],
        "ms": la_stats["ms"],
        "plain_ms": la_stats["plain_ms"],
        "bound_ms": la_stats["bound_ms"],
        "bound_by": la_stats["bound_by"],
        "library_ms": None,
        "status": "ok",
        "ms_is": "the six calls of one UNet evaluation at batch 64, bf16",
        "worst_rel_err": la_stats["worst_rel_err"],
        "shapes": la_stats["shapes"],
    }, {
        "name": "linear_attention_bwd",
        "route": "cuda",
        "source": "lightning_generative_models_tpu_torch/csrc/linear_attention_bwd.cu",
        "replaces": "lightning_generative_models_tpu/ops/linear_attention.py:302",
        "launches": train_counts["train"]["backward"],
        "launches_by_path": {"generate": 0,
                             "train": train_counts["train"]["backward"],
                             "resume": train_counts["resume"]["backward"]},
        "max_abs_err": bwd_stats["max_abs_err"],
        "ms": bwd_stats["ms"],
        "plain_ms": bwd_stats["plain_ms"],
        "bound_ms": bwd_stats["bound_ms"],
        "bound_by": bwd_stats["bound_by"],
        "library_ms": None,
        "status": "ok",
        "ms_is": "the six calls of one train step at batch 128, bf16",
        "worst_rel_err": bwd_stats["worst_rel_err"],
        "shapes": bwd_stats["shapes"],
    }]
    print(json.dumps({"train": train_stats}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
