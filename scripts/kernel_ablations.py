#!/usr/bin/env python3
"""Where the time of the port's flash attention (#5) and VQ search (#6) kernels goes, on
one NVIDIA GPU (H100).

    python3 scripts/kernel_ablations.py

Builds, beside each kernel, copies of its source with one part taken out (the results
of those copies are wrong and are not checked), and times each at the main path's shape
by CUDA events (chip_smoke.time_ms), the kernel itself first and last:
  #5 at b 128, h 6, n 256, d 64, bf16, views of a packed s3hd qkv:
    loads   the consumer warps only wait for each K/V tile and hand it back (TMA and
            barriers: no products, no softmax, no output);
    no_lo   P V without its second (lo) product;
    no_exp  the softmax without its exp2;
  #6 at N 4,096, K 512, D 64, f32 (and N 1,024):
    no_mma  no products (the copies, the split, the norms, the argmin stay);
    loads   the copies and barriers only.
Prints one line a variant with the card's name and power limit. Needs nvcc and a card;
the variants are built into the package's git-ignored _build/ directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _cut(source: str, cuts) -> str:
    for old, new in cuts:
        if old not in source:
            raise SystemExit(f"kernel_ablations: the source no longer has {old[:60]!r}")
        source = source.replace(old, new)
    return source


FLASH_LOADS = [(
    "  // Tile 0's scores alone;",
    "  mbar_wait(q_full, 0);\n  for (int j = 0; j < n_tiles; ++j) {\n"
    "    mbar_wait(full(j % STAGES), (j / STAGES) & 1);\n    __syncwarp();\n"
    "    if (lane == 0) mbar_arrive(empty(j % STAGES));\n  }\n  if (n_tiles >= 0) return;\n"
    "  // Tile 0's scores alone;")]
FLASH_NO_LO = [("      mma_bf16_rs(o[sl], p_lo[kk], dv);\n", "")]
FLASH_NO_EXP = [("s[4 * jj + 2 * i] = exp2_ftz(s[4 * jj + 2 * i] - m_new[i]);",
                 "s[4 * jj + 2 * i] = s[4 * jj + 2 * i] - m_new[i];"),
                ("s[4 * jj + 2 * i + 1] = exp2_ftz(s[4 * jj + 2 * i + 1] - m_new[i]);",
                 "s[4 * jj + 2 * i + 1] = s[4 * jj + 2 * i + 1] - m_new[i];")]
VQ_MMA = """      mma_tf32_rs(acc, a_lo[e], hi, e > 0);
      mma_tf32_rs(acc, a_hi[e], lo, 1);
      mma_tf32_rs(acc, a_hi[e], hi, 1);"""
VQ_NO_MMA = [(VQ_MMA, "      if (e < 0) mma_tf32_rs(acc, a_lo[e], hi, 0);")]
VQ_LOADS = VQ_NO_MMA + [
    ("    for (int r = 0; r < kCodes * D / 4 / kThreads; ++r) {",
     "    for (int r = 0; r < 0; ++r) {"),
    ("      for (int q = half; q < D / 4; q += 2) {", "      for (int q = half; q < 0; q += 2) {"),
    ("          if (score < best[r]) {", "          if (score != score && score == 0.f) {"),
]


def build_variants(sources: dict) -> dict:
    """{name: source} -> {name: loaded library}, one nvcc a source, all started together."""
    from lightning_generative_models_tpu_torch.ops import cuda_build

    out = cuda_build.BUILD_DIR / "ablations"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(source)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> None:
    import torch

    import chip_smoke as cs
    from lightning_generative_models_tpu_torch.ops import attention as ta
    from lightning_generative_models_tpu_torch.ops import cuda_build, vq

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablations: needs a CUDA GPU")
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = cuda_build.CSRC_DIR
    flash_src = (csrc / "flash_attention.cu").read_text()
    vq_src = (csrc / "vq.cu").read_text()
    libs = build_variants(
        {f"flash_{name}": _cut(flash_src, cuts) for name, cuts in
         (("loads", FLASH_LOADS), ("no_lo", FLASH_NO_LO), ("no_exp", FLASH_NO_EXP))}
        | {f"vq_{name}": _cut(vq_src, cuts) for name, cuts in
           (("no_mma", VQ_NO_MMA), ("loads", VQ_LOADS))})
    flash_libs = {k[6:]: lib for k, lib in libs.items() if k.startswith("flash_")}
    vq_libs = {k[3:]: lib for k, lib in libs.items() if k.startswith("vq_")}

    def flash_call(lib):
        lib.lgm_flash_attention_fwd.argtypes = ta._FLASH_ARGTYPES
        lib.lgm_flash_attention_fwd.restype = ctypes.c_int

        def run(q, k, v):
            b, h, n_q, d = q.shape
            out = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
            strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                                 for s in ta._bhnd_strides(t)))
            err = lib.lgm_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.addressof(strides), b, h, n_q, k.shape[2], d, d**-0.5,
                torch.cuda.current_stream().cuda_stream)
            cuda_build.check(lib, err, "flash attention variant")
        return run

    def vq_call(lib):
        lib.lgm_vq_nearest.argtypes = vq._ARGTYPES
        lib.lgm_vq_nearest.restype = ctypes.c_int

        def run(flat, codebook):
            out = torch.empty(flat.shape[0], dtype=torch.int32, device=flat.device)
            err = lib.lgm_vq_nearest(flat.data_ptr(), codebook.data_ptr(), out.data_ptr(),
                                     flat.shape[0], codebook.shape[0], flat.shape[1],
                                     torch.cuda.current_stream().cuda_stream)
            cuda_build.check(lib, err, "VQ variant")
        return run

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, heads, n_q, n_kv, d, operands, dt = cs.FLASH_MAIN
    bases, views = cs.flash_operands(torch, gen, b, heads, n_q, n_kv, d, operands,
                                     getattr(torch, dt))
    q, k, v = views(bases)
    with torch.inference_mode():
        times = {"kernel": cs.time_ms(lambda: ta.flash_attention_cuda(q, k, v))}
        for name, lib in flash_libs.items():
            run = flash_call(lib)
            times[name] = cs.time_ms(lambda: run(q, k, v))
        times["kernel again"] = cs.time_ms(lambda: ta.flash_attention_cuda(q, k, v))
    print(f"#5 b {b} h {heads} n {n_q} d {d} {dt} {operands}: "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items()) + f" on {card}",
          flush=True)
    for n in (1024, cs.VQ_MAIN[0]):
        _, k_codes, dim = cs.VQ_MAIN
        flat = torch.randn(n, dim, device="cuda", generator=gen)
        codebook = torch.randn(k_codes, dim, device="cuda", generator=gen)
        times = {"kernel": cs.time_ms(lambda: vq.nearest_codes_cuda(flat, codebook))}
        for name, lib in vq_libs.items():
            run = vq_call(lib)
            times[name] = cs.time_ms(lambda: run(flat, codebook))
        times["kernel again"] = cs.time_ms(lambda: vq.nearest_codes_cuda(flat, codebook))
        print(f"#6 N {n} K {k_codes} D {dim} f32: "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
              + f" on {card}", flush=True)


if __name__ == "__main__":
    main()
