"""The preprocess kernel (#7, ``csrc/preprocess.cu``) of two or more trees of the PyTorch
port, timed in turns on one card.

Builds each tree's ``lightning_generative_models_tpu_torch/csrc/preprocess.cu`` with this
tree's nvcc flags into ``chiprun_out/preprocess_ab/`` (one nvcc per tree, all started
together), loads each with ctypes and calls its C entry ``lgm_normalize_flip`` (the
interface every version keeps) at the shapes of ``chip_smoke.py``'s ``PRE_SHAPES``, f32 and
bf16. Each output is checked against the plain version (bit for bit in f32, within 2^-7 in
bf16); each time is CUDA events over 20 launches queued behind a spin kernel
(``chip_smoke.time_ms``), taken for the trees in the order given and then in the reverse
order (parent, change, change, parent for two). A tree whose library has
``lgm_empty_launch`` also gets the launch floor: an empty kernel of 1 and of 128 blocks
timed the same way.

Prints one JSON line and appends it to chiprun_out/preprocess_ab.jsonl. Needs a CUDA
card; imports neither JAX nor the JAX package.

    python3 scripts/preprocess_ab.py --roots checkout_copy/parent . --labels parent change
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke  # noqa: E402
from lightning_generative_models_tpu_torch.ops import cuda_build  # noqa: E402

OUT = HERE / "chiprun_out" / "preprocess_ab"
SOURCE = Path("lightning_generative_models_tpu_torch") / "csrc" / "preprocess.cu"


def build(roots: list, labels: list) -> dict:
    """{label: loaded library} of each tree's preprocess.cu."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for root, label in zip(roots, labels):
        target = OUT / f"libpreprocess-{label}.so"
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(target),
               str(Path(root) / SOURCE)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), target)
    libs = {}
    for label, (proc, target) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = ctypes.CDLL(str(target))
        lib.lgm_normalize_flip.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.lgm_normalize_flip.restype = ctypes.c_int
        lib.lgm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lgm_cuda_error_string.restype = ctypes.c_char_p
        libs[label] = lib
    return libs


def main() -> None:
    import torch

    from lightning_generative_models_tpu_torch.ops.preprocess import fused_normalize_flip_plain

    parser = argparse.ArgumentParser()
    parser.add_argument("--roots", nargs="+", required=True, help="trees of the repo")
    parser.add_argument("--labels", nargs="+", required=True)
    args = parser.parse_args()
    if len(args.roots) != len(args.labels):
        parser.error("one label per root")
    if not torch.cuda.is_available():
        sys.exit("preprocess_ab.py needs a CUDA card")
    card = chip_smoke.card_line()
    libs = build(args.roots, args.labels)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, images, flip, out):
        b, h, w, c = images.shape
        err = lib.lgm_normalize_flip(images.data_ptr(), flip.data_ptr(), out.data_ptr(),
                                     b, h, w, c, int(out.dtype == torch.bfloat16), stream)
        cuda_build.check(lib, err, "preprocess kernel")

    gen = torch.Generator(device="cuda").manual_seed(18)
    order = args.labels + args.labels[::-1]
    rows = []
    for shape in chip_smoke.PRE_SHAPES:
        images = torch.randint(0, 256, shape, device="cuda", generator=gen, dtype=torch.uint8)
        flip = (torch.rand(shape[0], device="cuda", generator=gen) < 0.5).to(torch.uint8)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            ref = fused_normalize_flip_plain(images, flip.bool(), dtype)
            out = torch.empty(shape, dtype=dtype, device="cuda")
            for label, lib in libs.items():
                call(lib, images, flip, out)
                torch.cuda.synchronize()
                err = ((out.float() - ref.float()).abs()
                       / ref.float().abs().clamp_min(1e-30)).max().item()
                if not (torch.equal(out, ref) if dt == "float32" else err <= 2.0**-7):
                    sys.exit(f"{label} disagrees with the plain version at {shape} {dt}")
            times = [(label, chip_smoke.time_ms(lambda: call(libs[label], images, flip, out)))
                     for label in order]
            row = {"shape": list(shape), "dtype": dt, "times_ms": times}
            rows.append(row)
            print(f"{shape} {dt}: " + ", ".join(f"{label} {ms:.4f}" for label, ms in times)
                  + " ms", flush=True)
    floors = {}
    for label, lib in libs.items():
        if hasattr(lib, "lgm_empty_launch"):
            lib.lgm_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.lgm_empty_launch.restype = ctypes.c_int
            floors[label] = {blocks: chip_smoke.time_ms(lambda: lib.lgm_empty_launch(
                blocks, stream)) for blocks in (1, 128)}
            print(f"{label} launch floor: {floors[label]} ms", flush=True)
    record = {"card": card, "order": order, "rows": rows, "launch_floor_ms": floors}
    (HERE / "chiprun_out").mkdir(exist_ok=True)
    with open(HERE / "chiprun_out" / "preprocess_ab.jsonl", "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record))
    print(card)


if __name__ == "__main__":
    main()
