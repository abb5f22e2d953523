#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. versions, the card's name and power limit; TF32 off for matmuls and convs;
  2. build every CUDA kernel of the main path from the sources in the checkout;
  3. each kernel against its plain PyTorch version on the card, at the main path's
     shapes (batch 64, bf16) and at batch 128 in f32 and bf16, with and without the
     residual, plus a head-scale-disparity input; times by CUDA events;
  4. the full-width DDPM UNet (dim 64) forward on the card (through the kernel)
     against the same weights on the CPU (plain version), f32; then a 3-step DDIM
     chain, card against CPU, f32;
  5. the main path: the port's generate entry point samples DDIM-50 at batch 64 in
     bf16 from configs/diffusion/ddim_cifar10.json, with every kernel's launch count
     set to 0 just before and read just after;
  6. DDIM-50 samples/s at batch 64 and 128 with the model built, and one batch-64
     run under torch.profiler: the device's busy share and its top kernels
     (full table in chiprun_out/chip_smoke/profile.txt);
  7. a JSON line of the kernels, the card's line, and the last line
     {"ok": true, "device": {...}}.
It needs no network and exits non-zero, printing no result, without a CUDA GPU or
outside a checkout of the repo.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "diffusion" / "ddim_cifar10.json"
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, dense): the least time for a kernel's work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores

# Tolerances of a kernel against its plain version, on max |k - p| / (1 + |p|):
# f32 differs by the order of f32 sums; bf16 by rounding points (the kernel keeps
# q, k, v and y in f32 where the plain version rounds them), a few bf16 ulps.
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
UNET_TOL = 1e-3  # f32 UNet / DDIM chain, card against CPU, relative to max(1, max|ref|)

# (n, c) of the UNet's six linear-attention calls per evaluation (dim 64, 32 px).
LA_SHAPES = [(1024, 64), (256, 64), (256, 128), (64, 128), (64, 256), (1024, 64)]
MAIN_BATCH = 64
DDIM_STEPS = 50

# Device kernels grouped by a mark in their names, for the profile's summary.
PROFILE_GROUPS = {
    "linear attention (csrc/linear_attention.cu)": ("context_kernel", "output_kernel"),
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


def sampling_breakdown(torch, card: str) -> None:
    """DDIM-50 samples/s with the model already built (host clock around work that
    ends in a synchronize, median of 3), then one bs64 run under torch.profiler: the
    device's busy share of the wall time and the kernels that take the most of it.
    The full table goes to chiprun_out/chip_smoke/profile.txt."""
    import statistics

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
        for _ in range(3):
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
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        print("  profiler: no device time recorded; busy share not measured")
        return
    print(f"  profiled DDIM-{DDIM_STEPS} bs{MAIN_BATCH}: wall {wall_us / 1e3:.1f} ms "
          f"(profiler on), device busy {busy_us / 1e3:.1f} ms = "
          f"{100 * busy_us / wall_us:.1f}% of wall, {sum(e.count for e in events)} "
          f"kernel launches")
    groups = dict.fromkeys(PROFILE_GROUPS, 0.0)
    for e in events:
        group = next((g for g, marks in PROFILE_GROUPS.items()
                      if any(mark in e.key for mark in marks)), "elementwise and other")
        groups[group] += e.self_device_time_total
    for group, us in groups.items():
        print(f"    {group}: {us / 1e3:.1f} ms, {100 * us / busy_us:.1f}% of device time")
    lines = [f"{100 * e.self_device_time_total / busy_us:6.2f}%  "
             f"{e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:110]}"
             for e in events]
    for line in lines[:12]:
        print("   ", line)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "profile.txt").write_text("\n".join(lines) + "\n")


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
    logs = cuda_build.build(["linear_attention"], verbose=True)
    print(f"  built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for line in "".join(logs.values()).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    print("[2] kernels against their plain versions", flush=True)
    with torch.inference_mode():
        la_stats = check_linear_attention(torch, la)

    print("[3] card against CPU", flush=True)
    check_unet_and_ddim(torch)

    print(f"[4] main path: generate DDIM-{DDIM_STEPS} bs{MAIN_BATCH} bf16", flush=True)
    argv = ["--config_path", str(CONFIG), "--num_samples", str(MAIN_BATCH),
            "--device", "cuda", "--seed", "0", "--out", str(OUT_DIR)]
    generate.main(argv + ["--sampling_steps", "2"])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    la.linear_attention.launches = 0
    t0 = time.perf_counter()
    images = generate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = la.linear_attention.launches
    print(f"  wall {wall:.3f} s, {MAIN_BATCH / wall:.2f} samples/s "
          f"(model build, init and PNG included) on {card}")
    print(f"  linear_attention launches: {launches} (expected {6 * DDIM_STEPS})")
    if images.shape != (MAIN_BATCH, 32, 32, 3):
        fail(f"samples have shape {images.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
        fail("samples are not finite values in [0, 1]")
    if launches != 6 * DDIM_STEPS:
        fail(f"the main path launched the linear-attention kernel {launches} times")
    if not (OUT_DIR / "grid.png").exists():
        fail("generate wrote no grid.png")

    print("[5] sampling throughput and where the time goes", flush=True)
    sampling_breakdown(torch, card)

    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "lightning_generative_models_tpu_torch/csrc/linear_attention.cu",
        "replaces": "lightning_generative_models_tpu/ops/linear_attention.py:173",
        "launches": launches,
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
