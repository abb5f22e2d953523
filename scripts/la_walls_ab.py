"""DDPM's two host-paced walls and their device time, for one tree of the PyTorch port.

Imports ``lightning_generative_models_tpu_torch`` from ``--root`` (this checkout by
default, or an unpacked older commit), builds its kernels there, and measures on the
card, with the model built and warmed up:

- DDIM-50 at batch 64 in bf16: samples/s, median of ``--repeats`` batches;
- the DDPM train step at batch 128 in bf16: ms a step, median of ``--repeats`` runs of
  20 steps, past the EMA's hard-copy phase;
- one profiled train step and one profiled DDIM-50 batch: the device's busy time read two
  ways, the sum of the kernels' durations and the union of their intervals (kernels
  launched with programmatic dependent launch overlap their predecessors, which the sum
  counts twice), and the linear-attention kernels' share of each;
- the host's time to enqueue one call of each linear-attention kernel at its main shape
  ((1024, 64), bf16; the forward at batch 64, the backward at 128) while the device is
  held busy by a ~100 ms spin kernel, so that no call waits for the device: the host cost
  a call adds to the walls. The same for one UNet evaluation of the DDIM batch, where a
  reading of ~100 ms or more says that the evaluation waited for the device (a
  synchronizing call, or a full launch queue) instead of its host cost.

Prints one JSON line and appends it to chiprun_out/la_walls_ab.jsonl. To compare two
commits, run the script on each tree in turn in one session: parent, change, change,
parent. Needs a CUDA card; imports neither JAX nor the JAX package.

    python3 scripts/la_walls_ab.py --root checkout_copy/parent --label parent
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
LA_MARKS = ("LaFwd", "LaBwd", "la_fwd_", "la_bwd_", "linear_attention", "context_kernel",
            "output_kernel", "stats_kernel", "token_a_kernel", "token_b_kernel",
            "atb_partial_kernel", "reduce_rows_kernel", "context_grad_kernel")


def kernel_spans(torch, prof) -> list:
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("Optimizer.")), key=lambda s: s[1])


def busy_ms(spans: list) -> dict:
    """Device busy time as the sum of the kernels' durations and as the union of their
    intervals, in ms, in all and for the linear-attention kernels."""
    out = {"sum_ms": 0.0, "union_ms": 0.0, "la_sum_ms": 0.0, "la_union_ms": 0.0}
    prev_end = float("-inf")
    for name, start, end in spans:
        own = max(0.0, end - max(start, prev_end)) / 1e3
        prev_end = max(prev_end, end)
        is_la = any(mark in name for mark in LA_MARKS)
        out["sum_ms"] += (end - start) / 1e3
        out["union_ms"] += own
        if is_la:
            out["la_sum_ms"] += (end - start) / 1e3
            out["la_union_ms"] += own
    return out


def host_us_per_call(torch, fn, calls: int = 50, repeats: int = 5) -> float:
    """Median over ``repeats`` of the host's µs to enqueue one of ``calls`` calls of
    ``fn`` behind a ~100 ms spin kernel."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(200_000_000)  # cycles: ~100 ms at the H100's 1.98 GHz
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def la_host_costs(torch, la) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for what, b in (("forward", 64), ("backward", 128)):
        kw = dict(device="cuda", generator=gen)
        n, c = 1024, 64
        args = [torch.randn(b, n, c, **kw).bfloat16(), torch.randn(c, **kw) * 0.1 + 1.0,
                torch.randn(c, 384, **kw) * c**-0.5, torch.randn(2, 4, 32, 4, **kw),
                torch.randn(128, c, **kw) * 128**-0.5, torch.randn(c, **kw) * 0.1,
                torch.randn(c, **kw) * 0.1 + 1.0]
        if what == "forward":
            fn = partial(la.linear_attention_cuda, *args, 4, 32, torch.bfloat16, True)
        else:
            dout = torch.randn(b, n, c, **kw).bfloat16()
            fn = partial(la.linear_attention_bwd_cuda, *args, dout, 4, 32, torch.bfloat16, True)
        out[f"{what}_host_us_per_call"] = host_us_per_call(torch, fn)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="change")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("la_walls_ab: needs a CUDA card")
    import lightning_generative_models_tpu_torch as pkg
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.ops import linear_attention as la
    from lightning_generative_models_tpu_torch.registry import load_model

    if not Path(pkg.__file__).resolve().is_relative_to(root):
        sys.exit(f"la_walls_ab: imported {pkg.__file__}, not the tree at {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"label": args.label, "root": str(root), "card": card}
    result.update(la_host_costs(torch, la))

    # DDIM-50 at batch 64.
    model = load_model(load_config(root / "configs/diffusion/ddim_cifar10.json")["model"],
                       device="cuda")
    model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def sample():
        model.sample(gen, 64)
        torch.cuda.synchronize()

    sample()
    # The host's time to enqueue one UNet evaluation of the batch, the device held busy
    # (~100 ms or more: the evaluation waited for the device).
    apply_fn = model._apply_fn(model.ema_unet)
    x = torch.randn(model.diffusion._shape(64), device="cuda", generator=gen)
    t = model.diffusion._t(64, 500)
    with torch.inference_mode():
        result["unet_eval_bs64_host_ms"] = 1e-3 * host_us_per_call(
            torch, partial(apply_fn, x, t), calls=1, repeats=9)
    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        sample()
        walls.append(time.perf_counter() - t0)
    result["ddim50_bs64_samples_per_s"] = 64 / statistics.median(walls)
    result["ddim50_bs64_walls_s"] = walls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sample()
    result["ddim50_bs64_device"] = busy_ms(kernel_spans(torch, prof))
    del model

    # The train step at batch 128.
    config = load_config(root / "configs/diffusion/ddpm_cifar10.json")
    model = load_model(config["model"], device="cuda")
    it = DataModule(**config["dataset"]).train_batches(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()} for _ in range(4)]

    def steps(n):
        for i in range(n):
            model.train_step(batches[i % len(batches)], gen)
        torch.cuda.synchronize()

    steps(5)
    model.step = model.ema_update_after_step
    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        steps(20)
        walls.append((time.perf_counter() - t0) / 20)
    result["train_bs128_ms_per_step"] = 1e3 * statistics.median(walls)
    result["train_bs128_ms_per_step_each"] = [1e3 * w for w in walls]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps(1)
    result["train_bs128_device"] = busy_ms(kernel_spans(torch, prof))

    line = json.dumps(result)
    print(line, flush=True)
    out = HERE / "chiprun_out" / "la_walls_ab.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
