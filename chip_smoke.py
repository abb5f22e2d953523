#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. versions, the card's name and power limit; TF32 off for matmuls and convs;
     build every CUDA kernel from the sources in the checkout (one nvcc per source,
     all started together), with ptxas' registers and spills;
  2. each kernel against its plain PyTorch version on the card: the forward at the
     sampling path's shapes (batch 64, bf16) and at batch 128 in f32 and bf16, with
     and without the residual, plus a head-scale-disparity input (f32 at (64, 64) and
     every UNet shape); the backward at the training batch (128) in f32 and bf16,
     residual on and off, plus the disparity input in f32 at the same shapes, held
     against the exact f64 gradient as well; for both, two calls compared bit for bit; the autograd path (forward
     kernel + backward kernel) against torch autograd through the plain version; times
     by CUDA events, and each kernel's time split by launch at its main shape under
     torch.profiler;
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
  8. the VQ codebook search (kernel #6) against its plain version at the VQ
     models' shapes (N = 1,024, 4,096, 16,384 and an odd 1,000; K = 512, D = 64) and
     on duplicated codebooks: every chosen code's distance within 1e-5 (1 + |d_min|)
     of the true minimum, indices equal on 99.9% of rows, first indices on ties, bit
     identical repeats; times of the kernel, the plain version and cuBLAS addmm +
     argmin, beside the bound (operations at the 3xTF32 rate, PEAK_F32_ACCURATE_FLOPS;
     the f32 FMA bound printed beside it);
  9. card against CPU, f32, batch 4, full width: a VQ-VAE step's loss, metrics and
     gradients with the plain codebook and with the EMA codebook (and its buffers
     after the step), and a VQGAN step after disc_start (every metric);
 10. VQ training path: the train entry point on configs/vae/vqvae_cifar10.json
     (bs256) then a --resume, the EMA codebook (the same widths, use_ema, vq_loss 10)
     and configs/vae/vqgan.json with disc_start inside the run, each with kernel #6's
     launches counted from 0 and held to the count worked out from the steps and the
     validation batches; then generate decodes random codes (no search);
 11. VQ-VAE train images/s at bs256, f32 (median of 3 timings of 20 steps), and five
     steps under torch.profiler (full table in chiprun_out/chip_smoke/vq_profile.txt);
 12. the packed-qkv attention kernels (#3 forward, #4 backward) against their plain
     versions at DiT-S/2's shape (b 128, n 256, h 6, d 64) in bf16 and f32 and both
     layouts, at h 8, d 48 (h3d), at a ragged n = 200, at n = 64 and at d 128 with a
     ragged n = 260: bit-identical repeats, the autograd path against torch autograd
     through the plain version; times of the kernels, the plain versions and
     scaled_dot_product_attention (forward, and its backward alone), beside the bounds
     (f32 operations at the 3xTF32 rate, PEAK_F32_ACCURATE_FLOPS);
 13. card against CPU, f32, bs2, the full-width DiT-S/2 of configs/diffusion/dit_cifar10.json
     (weights moved off adaLN-Zero's zeros): the forward, a 3-step DDIM chain with
     classifier-free guidance from one x_T, and one train step's loss and gradients;
 14. DiT sampling path: generate DDIM-50 at bs64 with guidance (a doubled batch of 128
     per evaluation), every launch count set to 0 just before and read just after (600
     forward launches, 0 backward), the grid in chiprun_out/chip_smoke/dit/grid.png;
 15. DiT training path: the train entry point at bs128, bf16, DIT_TRAIN_STEPS steps then
     a --resume of DIT_RESUME_STEPS, with validation (the loss, a guided sample grid and
     the per-class grid), launch counts held to the counts worked out from the run;
 16. DiT train images/s at bs128 (median of 3 timings of 20 steps) with one step under
     torch.profiler (chiprun_out/chip_smoke/dit_train_profile.txt), and DDIM-50 guided
     samples/s at bs64 with one batch under torch.profiler (dit_sample_profile.txt);
 17. flash attention (kernel #5) against its plain version on [b, h, n, d] operands: the
     views of DiT-S/2's packed qkv at bs128 in both layouts, the UNet's flash shape
     (n_q 256, n_kv 260, d 32), a ragged n = 300 and a long n = 1024, bf16 and f32
     (f32 goes through kernel #3's forward), and d 128 at a ragged n = 260 in bf16;
     bit-identical repeats; its backward route (kernel #4's entry on [b, h, n, d]
     strides) and the autograd path against autograd through the plain version; times of
     the kernel, the plain versions and scaled_dot_product_attention, beside the bounds,
     and of kernel #3's kernel on the same operands (checked against the f32 math);
 18. the preprocess kernel (#7) against its plain version at 128 x 32 x 32 x 3,
     64 x 64 x 64 x 3 and 1024 x 64 x 64 x 3 (62.9 MB in f32, beyond the L2), f32 (bit
     for bit) and bf16; times beside the bound, the backend="xla" path and the launch
     floor (an empty kernel timed the same way); then prepare_batch(backend="pallas")
     over 8 train batches with its launches counted from 0;
 19. card against CPU, f32, bs2, the full-width FlowMatching DiT-S/2 of
     configs/diffusion/fm_dit_cifar10.json with "flash_attn": true (derived into
     chiprun_out/chip_smoke/fm_dit_flash_cifar10.json): the forward, an Euler-3 chain
     and one train step; and on the card flash off (kernel #3) against flash on (#5);
 20. FM-DiT flash sampling path: generate Euler-50 at bs64 (600 flash launches, 0
     backward, no packed-qkv launch), the grid in chiprun_out/chip_smoke/fm_dit/;
 21. FM-DiT flash training path: train FM_TRAIN_STEPS steps at bs128 bf16 with
     validation, then a --resume of FM_RESUME_STEPS, launch counts held as in 15;
 22. FM-DiT flash train images/s and Euler-50 samples/s with profiles
     (fm_dit_{train,sample}_profile.txt);
 23. card against CPU, f32 (TF32 off), bs8, the full-width DCGAN of
     configs/gan/dcgan_cifar10.json: three train steps, each from the CPU model's state,
     on the same batch, flips and z (every loss, D's gradients, each weight's gradient
     and update norms, every BatchNorm buffer), then eval_step and sample;
 24. DCGAN training path: train DCGAN_STEPS steps at bs128 bf16 with validation, then a
     --resume of DCGAN_RESUME_STEPS, and generate 64 samples to a PNG grid
     (chiprun_out/chip_smoke/dcgan/), every kernel counter set to 0 just before each run
     and held to 0 just after: DCGAN runs no TPU kernel;
 25. DCGAN train images/s at bs128 bf16 (median of 3 timings of 20 steps) and five steps
     under torch.profiler (dcgan_train_profile.txt): busy share, top kernels, launches a
     step;
 26. card against CPU, f32 (TF32 off), every other GAN-family config at its own widths
     (GAN_FAMILY: WGAN-GP on CIFAR-10 and MNIST, WGAN-clip, LSGAN, R1GAN, InfoGAN, BEGAN,
     CycleGAN, CGAN, ACGAN, SGAN), batch 8 (CycleGAN 2): three train steps each (WGAN
     n_critic + 1) from the CPU model's state on the same batch and draws (every metric,
     the penalties and k_t among them; each weight's gradient and update norms; every
     BatchNorm buffer), then eval_step and sample (CycleGAN: translate);
 27. their entry points: train GAN_STEPS steps with a validation, a --resume of
     GAN_RESUME_STEPS, then generate 64 samples (CGAN and ACGAN also --label 3; CycleGAN's
     generate raises, as JAX's does, and the model translates a validation batch), every
     kernel counter set to 0 before each config and held to 0 after: no TPU kernel runs on
     these paths; the per-class grids of CGAN and ACGAN written;
 28. WGAN-GP CIFAR-10 train images/s at bs64 f32 over whole critic cycles, the D and G
     steps timed apart, one cycle under torch.profiler (wgan_gp_train_profile.txt), a D and
     a G step's launches and device time, and the penalty's share of a D step;
 29. kernels #1 and #2 at the slice's new shapes against their plain versions with [2]'s
     tolerances: the latent UNet's outer stage (b, 16, 64) at b 64 and 128 in f32 and bf16,
     residual on and off, the disparity input (#2's f32 gradients against the exact f64
     ones too), and the consistency model's doubled batch (256, 1024, 64) in bf16; every
     call repeated bit for bit; times beside the bounds and the plain versions; #6 at a
     latent decode's N = 2,048;
 30. card against CPU, f32 (TF32 off), each model of the slice at its config's widths:
     EDM, ConsistencyModel (edm_cifar10, ct_cifar10), LatentDiffusion, LatentEDM,
     LatentFlowMatching (ldm/ledm/lfm_cifar10 on a random vqvae_cifar10 autoencoder) and
     the VAE: one train step on the same batch and draws (metrics, gradients, update
     norms) and a short sampler chain on the same draws; VQGAN with LPIPS
     (vqgan_lpips.json, disc_start 0): a step with the card's ReLU masks replayed, eval,
     a decode of fixed codes;
 31. EDM path (edm_cifar10.json, bs128 bf16): train EDM_STEPS steps, resume, generate
     Heun-18 at bs64 (35 evaluations), launch counts worked out from the UNet (6 #1 an
     evaluation, 6 #2 a step);
 32. ConsistencyModel path (ct_cifar10.json; 256 rows a forward): train, resume, generate
     multistep (2 evaluations) and onestep (1);
 33. the latent paths (LDM, LEDM, LFM) on configs derived into chiprun_out/chip_smoke/
     whose autoencoder is [10]'s VQ-VAE run: train, resume from a random-autoencoder
     config (its checkpoint restores the AE, checked), generate; 2 #1 an evaluation, one
     #6 a decode; then the VAE (vae.json) and VQGAN with LPIPS (vqgan_lpips.json): train,
     resume, generate, every counter at its worked-out count;
 34. throughput with a profile: EDM train bs128 bf16, Heun-18 samples/s at bs64, CT train
     bs128, LDM train bs128 (busy share, top kernels);
 35. card against CPU, f32 (TF32 off), batch 8, DAE, the UNet autoencoder, PixelCNN, NICE
     and Glow at their configs' widths (dae, unet, pixelcnn, nice, glow_cifar10; every zero
     leaf drawn off zero): one train step on the same batch and draws (metrics, gradient
     and update norms, noise-level elements left out as [26] does); DAE's decode and
     UNet's reconstruction; NICE's and Glow's z and log-det, inverse(forward(x)) on the
     card and a sample on a fixed z; PixelCNN's first 32 pixels on fixed Gumbel draws, the
     card replaying the CPU's picks, every step's logits held;
 36. their entry points on 1,024 synthetic images a config: train, resume, generate 64
     (the UNet autoencoder's generate raises NotImplementedError as JAX's does), every
     kernel counter set to 0 before each run and held to 0 after: no TPU kernel runs here;
 37. Glow CIFAR-10 train bs128 f32 (ms a step, images/s, busy share, launches a step, the
     top device operations from a one-step profile),
     Glow's sample at bs64, PixelCNN train bs64 and PixelCNN sampling at bs64 (784
     forwards) with profiles, and the host syncs of NICE's and Glow's steps;
 38. InceptionV3 (the FID/KID/IS extractor) at 299 x 299, bs8, f32 (TF32 off), card
     against CPU on the same He-scaled random weights (BatchNorms drawn off their
     defaults): the ingestion of uint8 32 px images and the features and logits, within
     1e-3 of 1 + |ref|; then metrics.verify's stage 1 on the card (the reference
     torchvision-layout net through torchmetrics' ingestion against the port's extractor
     through load_torch_weights) and its stage 2 (a local pytorch-fid file, if any);
 39. kernels #3 and #4 against their plain versions at the DiT-MoE shape (b 128, n 256,
     h 8, d 48, h3d, bf16), with their times, bounds and scaled_dot_product_attention's;
 40. card against CPU, f32, bs4, the full-width DiT-MoE of configs/diffusion/
     dit_moe_cifar10.json (8 experts on the 6 odd blocks, weights moved off adaLN-Zero's
     zeros): the forward, a 3-step guided DDIM chain and one train step (loss, moe_aux,
     gradients), the card's MoE layers replaying the CPU's top-1 choices (RouteTape), with
     the tokens whose route the card's router would change counted and bounded;
 41. DiT-MoE paths: generate DDIM-50 guided at bs64 (600 #3 launches), then train
     DIT_MOE_TRAIN_STEPS steps at bs128 bf16 with validation and a --resume, launch counts
     held as in 15 (12 #3 and 12 #4 a step), moe_aux logged and finite;
 42. FID on a trained model: generate --fid 10000 --fid_batch 256 from [24]'s DCGAN
     CIFAR-10 run (InceptionV3 at 299 in f32, TF32 off), the artifact's keys and sizes,
     the wall split into sampling, InceptionV3 and the statistics, every kernel counter
     0; FID of 24 real against 24 fake images with the same extractor on the card and on
     the CPU, within FID_REL_TOL relative;
 43. GAN validation with the generative metrics: dcgan_cifar10.json with
     calculate_metrics and metrics [fid, kid, is] (derived into chiprun_out/chip_smoke/)
     trained DCGAN_METRICS_STEPS steps through one validation (fid_score, mean/std KID and
     IS logged, finite), then --eval test (test_-prefixed keys);
 44. throughput: DiT-MoE train bs128 bf16 (images/s, a step under torch.profiler: busy
     share, launches), the MoE layers' share of a step's device time (a MoE layer's
     forward and backward at the step's shape by CUDA events, times six), guided DDIM-50
     samples/s at bs64, InceptionV3 images/s at bs256 (f32, TF32 off);
 45. UNROLL-step CUDA graphs (train/graphs.py) against UNROLL eager steps from one state
     with the same draws, cuDNN deterministic: DDPM (ddpm_cifar10) at bs128 bf16 and at
     bs8 f32, DiT-S/2, FM-DiT flash, DCGAN, WGAN-GP (a whole critic cycle of 6) and VQ-VAE,
     every state tensor bit for bit (else Adam's moments within 1e-6 of 1 + |ref| and the
     rest by update norm within 1e-3, with two eager runs compared to name the cause);
     kernels #1-#6 counted per replay equal to the eager steps' counts; graphs per model;
 46. the train entry point on ddpm_cifar10.json (its validation grid by DDIM-50) at full
     width with --unroll_steps 4 --mu_dtype bfloat16 --nu_dtype bfloat16 --profile_steps
     8:12 for 48 steps, then a
     --resume with the same flags: #1 and #2 per replay and per run, the logging cadence,
     bf16 moments in the checkpoint, the trace under profile/ naming #1 and #2, a resume
     with float32 moments refused, a bf16-moment Adam card against CPU; DCGAN with
     --unroll_steps 4 (train, resume, generate); then every other trainable registry name
     from its run's last checkpoint: 2 dispatches of the trainer at --unroll_steps 2,
     captured or not, graphs, launches per replay;
 47. train throughput at --unroll_steps 1 and 4, interleaved, 3 repeats: DDPM and DCGAN
     at bs128 bf16 (ms a step, images/s; a dispatch's worth of steps profiled: device
     busy, kernel launches and CUDA runtime calls a step);
 48. interpolation: the four processes card against CPU (f32, dim 64, explicit draws,
     1e-4 of 1 + |ref|); generate --interpolate 8 on [6]'s DDPM run (999 ancestral
     evaluations, #1 counted) and on the FM-DiT flash, EDM and CT runs;
 49. a JSON line of the kernels, the card's line, and the last line
     {"ok": true, "device": {...}}.
It needs no network and exits non-zero, printing no result, without a CUDA GPU or
outside a checkout of the repo.
"""

from __future__ import annotations

import importlib
import json
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "diffusion" / "ddim_cifar10.json"
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
TRAIN_RUN = "chip_smoke_train"  # experiments/DDPM/<this>: the train entry point's run
VQVAE_CONFIG = ROOT / "configs" / "vae" / "vqvae_cifar10.json"
VQGAN_CONFIG = ROOT / "configs" / "vae" / "vqgan.json"
DIT_CONFIG = ROOT / "configs" / "diffusion" / "dit_cifar10.json"
DIT_RUN = "chip_smoke_dit"  # experiments/DDPM/<this>
FM_BASE_CONFIG = ROOT / "configs" / "diffusion" / "fm_dit_cifar10.json"
FM_CONFIG = ROOT / "chiprun_out" / "chip_smoke" / "fm_dit_flash_cifar10.json"  # derived
FM_RUN = "chip_smoke_fm_dit"  # experiments/FlowMatching/<this>
DCGAN_CONFIG = ROOT / "configs" / "gan" / "dcgan_cifar10.json"
DCGAN_RUN = "chip_smoke_dcgan"  # experiments/DCGAN/<this>
DIT_MOE_CONFIG = ROOT / "configs" / "diffusion" / "dit_moe_cifar10.json"
DIT_MOE_RUN = "chip_smoke_dit_moe"  # experiments/DDPM/<this>
DCGAN_METRICS_CONFIG = ROOT / "chiprun_out" / "chip_smoke" / "dcgan_cifar10_metrics.json"
DCGAN_METRICS_RUN = "chip_smoke_dcgan_metrics"  # experiments/DCGAN/<this>

# H100 SXM peaks (NVIDIA data sheet, dense): the least time for a kernel's work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores
PEAK_TF32_FLOPS = 494.7e12  # TF32 tensor cores
# The rate of f32-accurate products on the tensor cores: 3xTF32 takes three TF32 products
# for one f32 product. The softmax-attention kernels' f32 path and the VQ search run at it,
# and can beat the 67 TFLOP/s of f32 FMA, so their f32 operations bound is taken at this
# rate.
PEAK_F32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3
ATTN_PEAK_FLOPS = {"bfloat16": PEAK_FLOPS["bfloat16"], "float32": PEAK_F32_ACCURATE_FLOPS}
ATTN_PEAK_IS = {"bfloat16": "989 TFLOP/s bf16", "float32": "165 TFLOP/s f32-accurate (3xTF32)"}

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

# The VQ search: a chosen code's squared distance within VQ_TIE_TOL * (1 + |d_min|) of the
# row's true minimum (f64), and the kernel's indices equal to the plain version's on at
# least VQ_AGREE of the rows: the two sum the f32 dot in other orders, so near-tied codes
# can flip.
VQ_TIE_TOL = 1e-5
VQ_AGREE = 0.999
VQ_SHAPES = [(1024, 512, 64), (4096, 512, 64), (16384, 512, 64), (1000, 512, 64)]
VQ_MAIN = (4096, 512, 64)  # vqvae_cifar10 at bs256: 256 images x 4 x 4 latents
VQ_TOL = 1e-3  # f32 VQ steps, card against CPU, as GRAD_TOL
VQ_STEPS = 48  # four epochs of the synthetic CIFAR-10 at bs256
VQ_RESUME_STEPS = 12
# disc_start close to the end: the hinge loss saturates at 0 once the discriminator
# separates real from fake (20 of its steps did), so the last logged step keeps it > 0.
VQGAN_STEPS, VQGAN_DISC_START = 40, 36

# Kernels #3 and #4 (b, n, heads, d, layout, dtype): DiT-S/2 at bs128 (the train batch and
# the guided sampling batch, 64 doubled) in both layouts and both dtypes, heads 8 at d 48
# (dit_cifar10_tp / dit_moe_cifar10), a ragged n, a small n and d 128 at a ragged n.
ATTN_MAIN = (128, 256, 6, 64)
ATTN_CASES = [(*ATTN_MAIN, lay, dt) for dt in ("bfloat16", "float32") for lay in ("s3hd", "h3d")]
ATTN_CASES += [(128, 256, 8, 48, "h3d", dt) for dt in ("bfloat16", "float32")]
ATTN_CASES += [(128, 200, 6, 64, "s3hd", dt) for dt in ("bfloat16", "float32")]
ATTN_CASES += [(128, 64, 6, 64, "h3d", dt) for dt in ("bfloat16", "float32")]
# The widest head the kernels take (their d = 128 instances) at a ragged n.
ATTN_CASES += [(64, 260, 2, 128, "s3hd", dt) for dt in ("bfloat16", "float32")]
# Forward, max |k - p| / (1 + |p|): f32 the order of f32 sums; bf16 the plain version
# rounds the logits (steps of 2^-6 at magnitude 2-4), the probabilities and p v to bf16
# where the kernel keeps f32 and rounds the output once. ATTN_BF16_MATH: the bf16 kernel
# against the plain math in f32 on the same bf16 inputs, where only that rounding is left.
ATTN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ATTN_BF16_MATH = 8e-3
# Backward, max |k - p| / (1 + max |p|): both in f32 from the same inputs; in bf16 a value
# summed in another order can round to the next bf16 step (2^-8).
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
DIT_TOL = 1e-3  # f32 DiT forward, chain and train step, card against CPU, as UNET_TOL
DIT_BATCH = 64  # generate --num_samples: guided, so 128 rows per evaluation
DIT_TRAIN_STEPS = 60
DIT_RESUME_STEPS = 10
DIT_DEPTH = 12
FM_TRAIN_STEPS = 40
FM_RESUME_STEPS = 10
DCGAN_TOL = 1e-3  # f32 DCGAN steps, card against CPU: metrics, gradients, update norms
DCGAN_BN_TOL = 1e-4  # its BatchNorm buffers, relative to 1 + |ref|
DCGAN_STEPS = 36
DCGAN_RESUME_STEPS = 12
# The GAN family: every config the port trains besides DCGAN's, each at its own widths.
GAN_FAMILY = [ROOT / "configs" / "gan" / f"{name}.json" for name in (
    "wgan_gp_cifar10", "wgan_gp", "wgan_cp", "lsgan", "r1gan", "infogan", "began", "cyclegan",
    "cgan", "acgan", "sgan")]
WGAN_CONFIG = GAN_FAMILY[0]  # [28]: WGAN-GP on CIFAR-10, bs64, f32
GAN_TOL = 1e-3  # f32 GAN-family steps, card against CPU: metrics, gradient and update norms
GAN_BN_TOL = 1e-4  # their BatchNorm buffers (of 1 + |ref|) and samples (abs)
GAN_NOISE_SHARE = 5e-2  # most of the stepped elements left out of the update norms as noise
GAN_STEPS = 24  # [27]: WGAN's n_critic 5 makes 4 critic cycles
GAN_RESUME_STEPS = 6
GAN_SYNTHETIC = 1024  # [27]: synthetic images a config stages

# Kernel #5, flash attention (b, heads, n_q, n_kv, d, operands, dtype): DiT-S/2 at bs128
# as the flash DiT hands it over (views of the packed qkv in either layout), the UNet's
# flash shape (16 x 16 queries and 4 memory keys more, [b, n, h, d] tensors seen as
# [b, h, n, d]), a ragged n and a long n (contiguous [b, h, n, d]), and the widest head
# (two 64-column slabs of the bf16 kernel) at a ragged n. Tolerances as kernel #3's
# (ATTN_TOL, ATTN_BF16_MATH, ATTN_BWD_TOL): the same math and rounding points (in f32
# the flash entry launches #3's kernel).
FLASH_MAIN = (128, 6, 256, 256, 64, "s3hd", "bfloat16")
FLASH_CASES = [(128, 6, 256, 256, 64, lay, dt) for dt in ("bfloat16", "float32")
               for lay in ("s3hd", "h3d")]
FLASH_CASES += [(64, 4, 256, 260, 32, "bnhd", dt) for dt in ("bfloat16", "float32")]
FLASH_CASES += [(128, 6, 300, 300, 64, "s3hd", dt) for dt in ("bfloat16", "float32")]
FLASH_CASES += [(16, 4, 1024, 1024, 32, "bhnd", dt) for dt in ("bfloat16", "float32")]
FLASH_CASES += [(64, 2, 260, 260, 128, "s3hd", "bfloat16")]
# Kernel #7, uint8 -> float with the flip: the train batch at 32 px, a 64 px batch, and
# 1024 images at 64 px (62.9 MB in f32, beyond the 50 MB L2: where bandwidth shows).
PRE_SHAPES = [(128, 32, 32, 3), (64, 64, 64, 3), (1024, 64, 64, 3)]
PRE_MAIN = ((128, 32, 32, 3), "float32")
PRE_PATH_BATCHES = 8  # prepare_batch(backend="pallas") over the FM config's train batches

# (n, c) of the UNet's six linear-attention calls per evaluation (dim 64, 32 px).
LA_SHAPES = [(1024, 64), (256, 64), (256, 128), (64, 128), (64, 256), (1024, 64)]
MAIN_BATCH = 64
DDIM_STEPS = 50

# Device kernels grouped by a mark in their names, for the profile's summary.
# The two linear-attention libraries share their first four kernels: those carry the
# direction as a template tag (LaFwd, LaBwd) in their names, the others a la_fwd_/la_bwd_
# prefix.
PROFILE_GROUPS = {
    "linear attention (csrc/linear_attention.cu)": ("LaFwd", "la_fwd_"),
    "linear attention backward (csrc/linear_attention_bwd.cu)": ("LaBwd", "la_bwd_"),
    "VQ nearest codes (csrc/vq.cu)": ("vq_nearest_wgmma_kernel",),
    "packed-qkv attention (csrc/attention_qkv.cu)": ("attention_fwd_kernel",),
    "packed-qkv attention backward (csrc/attention_qkv_bwd.cu)": (
        "attention_bwd_query_kernel", "attention_bwd_key_kernel"),
    "flash attention (csrc/flash_attention.cu)": ("flash_fwd_wgmma_kernel",),
    "preprocess (csrc/preprocess.cu)": ("normalize_flip_kernel",),
    "optimizer and EMA (foreach)": ("multi_tensor_apply",),
    "convolution (cuDNN)": ("fprop", "convolve", "cudnn", "nhwcAddPadding", "wgrad"),
    "LU, solves and inverses (cuSOLVER, cuBLAS)": ("getrf", "getrs", "getri", "trsm", "laswp"),
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
    """Device time per call of ``fn`` by CUDA events. The timed calls queue behind a
    50 ms spin kernel, so that the host's cost of launching them (tens of µs a call
    through Python) is not timed where a kernel is shorter than that."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # cycles: ~50 ms at the H100's 1.98 GHz
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
    written once at the memory rate; the block's flops at the tensor cores' rate for the
    compute type (ATTN_PEAK_FLOPS: bf16, or f32-accurate 3xTF32, which the kernel runs).
    The least time the card could take is the larger of the two."""
    elt = 2 if dtype == "bfloat16" else 4
    params = 4 * (c * 384 + 2 * 128 * m + 128 * c + 3 * c)
    nbytes = 2 * b * n * c * elt + params
    per_token = 2 * c * 384 + 2 * 4 * 32 * 32 + 2 * 4 * 32 * 32 + 2 * 128 * c
    flops = b * n * per_token + b * 4 * 2 * m * 32 * 32
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / ATTN_PEAK_FLOPS[dtype]


def exclusive_kernel_us(torch, prof) -> dict:
    """{kernel name: [exclusive µs, launches]} of a profile's device kernels. A kernel
    launched with programmatic dependent launch starts while its predecessor on the stream
    finishes and waits for it, so durations overlap: each kernel is charged only the time
    after the previous kernel's end (its end minus the later of its start and that end), and
    the charges add up to the time the device was busy. User annotations and the
    optimizer's spans are left out: they also carry device time, that of the kernels inside."""
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("Optimizer.")), key=lambda s: s[1])
    out, prev_end = {}, float("-inf")
    for name, start, end in spans:
        us = max(0.0, end - max(start, prev_end))
        prev_end = max(prev_end, end)
        entry = out.setdefault(name, [0.0, 0])
        entry[0] += us
        entry[1] += 1
    return out


def launch_split(torch, fn, what: str, calls: int = 5) -> None:
    """Each kernel's exclusive device time per call of ``fn`` (a warm-up call, then
    ``calls`` calls under torch.profiler; exclusive_kernel_us), largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(exclusive_kernel_us(torch, prof).items(), key=lambda kv: -kv[1][0])
    total = sum(us for us, _ in dict(kernels).values()) / calls / 1e3
    print(f"  launches of one call, {what}: {total:.4f} ms of device time (each kernel's time "
          f"after its predecessor's end)", flush=True)
    for name, (us, count) in kernels:
        name = name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
        print(f"    {us / calls / 1e3:8.4f} ms  {count // calls:2d}x  {name[:100]}", flush=True)


def check_linear_attention(torch, la, cases=None, timed=("bfloat16",)) -> dict:
    """Kernel #1 against its plain version at ``cases`` ((b, n, c, dtype, residual,
    disparity); None: the UNet's shapes of [2]), timing the residual cases of the
    ``timed`` dtypes. With the default cases the summary is one UNet evaluation's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    main_path = cases is None
    if main_path:
        cases = [(128, n, c, dt, res, False) for (n, c) in LA_SHAPES[:5]
                 for dt in ("float32", "bfloat16") for res in (True, False)]
        cases += [(128, 64, 64, dt, True, True) for dt in ("float32", "bfloat16")]
        cases += [(128, n, c, "float32", True, True) for (n, c) in LA_SHAPES[:5]]
        cases += [(MAIN_BATCH, n, c, "bfloat16", True, False) for (n, c) in LA_SHAPES[:5]]
    main_err, shapes = 0.0, []
    for b, n, c, dt, res, disp in cases:
        dtype = getattr(torch, dt)
        args = la_inputs(b, n, c, dtype, gen, disparity=disp)
        out = la.linear_attention_cuda(*args, 4, 32, dtype, res)
        again = la.linear_attention_cuda(*args, 4, 32, dtype, res)
        ref = la.linear_attention_plain(*args, 4, 32, dtype, res)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        abs_err = diff.max().item()
        rel_err = (diff / (1 + ref.float().abs())).max().item()
        finite = bool(torch.isfinite(out.float()).all())
        same = torch.equal(out, again)
        # Disparity in bf16: head 0's logits (~1e3) round to bf16 steps of ~4 in the
        # plain version and not in the kernel, so their softmaxes differ by design (the
        # JAX package's own disparity test is f32). What must hold is finiteness.
        ok = finite and same and (rel_err <= TOL[dt] or (disp and dt == "bfloat16"))
        print(f"  linear_attention b={b} n={n} c={c} {dt} residual={res} disparity={disp}: "
              f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} tol={TOL[dt]:.0e} "
              f"bit-identical repeat={same} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"linear_attention kernel disagrees with its plain version or repeats "
                 f"differently at b={b} n={n} c={c} {dt} residual={res}")
        if not (disp and dt == "bfloat16"):
            worst[dt] = max(worst[dt], rel_err)
        if b == MAIN_BATCH:
            main_err = max(main_err, abs_err)
        if res and not disp and dt in timed:
            ms = time_ms(lambda: la.linear_attention_cuda(*args, 4, 32, dtype, True))
            plain_ms = time_ms(lambda: la.linear_attention_plain(*args, 4, 32, dtype, True))
            bytes_ms, ops_ms = la_bound_ms(b, n, c, dt)
            shapes.append({"b": b, "n": n, "c": c, "dtype": dt, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                           "bytes_ms": bytes_ms, "ops_ms": ops_ms, "rel_err": rel_err})
            print(f"  time b={b} n={n} c={c} {dt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                  f" bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
                  f"operations {ops_ms:.4f})", flush=True)
            if main_path and (b, n, c) == (MAIN_BATCH, *LA_SHAPES[0]):
                launch_split(torch, lambda: la.linear_attention_cuda(*args, 4, 32, dtype, True),
                             f"linear_attention b={b} n={n} c={c} {dt}")
    if not main_path:
        return {"max_abs_err": main_err, "worst_rel_err": worst, "shapes": shapes}
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
    the memory tokens' terms (6 m 4096 a batch row), at ATTN_PEAK_FLOPS of the type."""
    elt = 2 if dtype == "bfloat16" else 4
    params = 4 * (c * 384 + 2 * 128 * m + 128 * c + 3 * c)
    nbytes = 3 * b * n * c * elt + 2 * params
    flops = b * n * (3072 * c + 49152) + b * 6 * m * 4096
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / ATTN_PEAK_FLOPS[dtype]


def grad_err(k, p) -> float:
    """max |k - p| / (1 + max |p|)."""
    k, p = k.float(), p.float()
    return ((k - p).abs().max() / (1.0 + p.abs().max())).item()


def check_linear_attention_bwd(torch, la, cases=None, timed=("bfloat16",)) -> dict:
    """Kernel #2 against its plain version at ``cases`` (as check_linear_attention's;
    None: the training shapes of [2]), timing the residual cases of the ``timed`` dtypes.
    With the default cases the summary is one train step's."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = ("dx", "dg0", "dqkv_kernel", "dmem_kv", "dout_kernel", "dout_bias", "dg1")
    main_path = cases is None
    if main_path:
        cases = [(TRAIN_BATCH, n, c, dt, res, False) for (n, c) in LA_SHAPES[:5]
                 for dt in ("float32", "bfloat16") for res in (True, False)]
        # The disparity input in f32 at (64, 64) and every UNet shape: each gradient is
        # held against the exact f64 one (linear_attention_bwd_exact) and, at (64, 64),
        # against the plain version as well. At the larger shapes the plain f32 version is
        # itself ~1e-4 from the exact gradient, so kernel against plain is printed there
        # beside both distances from the exact one.
        cases += [(TRAIN_BATCH, n, c, "float32", True, True)
                  for (n, c) in [(64, 64)] + LA_SHAPES[:5]]
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
        exact = ""
        if disp:
            truth = la.linear_attention_bwd_exact(*args, dout, 4, 32, res)
            kernel_exact = [grad_err(k, t) for k, t in zip(out, truth)]
            plain_exact = [grad_err(p, t) for p, t in zip(ref, truth)]
            gated = kernel_exact + (errs if (n, c) in ((64, 64), (16, 64)) else [])
            exact = (" | against f64: kernel " + " ".join(f"{e:.2e}" for e in kernel_exact)
                     + ", plain " + " ".join(f"{e:.2e}" for e in plain_exact))
        else:
            gated = errs
        ok = finite and same and max(gated) <= BWD_TOL[dt]
        print(f"  linear_attention_bwd b={b} n={n} c={c} {dt} residual={res} "
              f"disparity={disp}: max_abs_err={abs_err:.3e} rel_err "
              + " ".join(f"{nm}={e:.2e}" for nm, e in zip(names, errs))
              + f"{exact} tol={BWD_TOL[dt]:.0e} bit-identical repeat={same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"linear_attention backward kernel disagrees with its plain version or "
                 f"repeats differently at b={b} n={n} c={c} {dt} residual={res}")
        worst[dt] = max(worst[dt], max(gated))
        if res and not disp and dt in timed:
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
            if main_path and (n, c) == LA_SHAPES[0]:
                launch_split(
                    torch, lambda: la.linear_attention_bwd_cuda(*args, dout, 4, 32, dtype, True),
                    f"linear_attention_bwd b={b} n={n} c={c} {dt}")
    if not main_path:
        return {"max_abs_err": main_err, "worst_rel_err": worst, "shapes": shapes}
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
    # Kernels only, each charged its time after the previous kernel's end
    # (exclusive_kernel_us): the linear-attention kernels overlap their predecessors.
    events = sorted(exclusive_kernel_us(torch, prof).items(), key=lambda kv: -kv[1][0])
    busy_us = sum(us for _, (us, _) in events)
    if busy_us == 0:
        print("  profiler: no device time recorded; busy share not measured")
        return {}
    launches = sum(count for _, (_, count) in events)
    print(f"  profiled {what}: wall {wall_us / 1e3:.1f} ms (profiler on), device busy "
          f"{busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.1f}% of wall, {launches} "
          f"kernel launches on {card}")
    groups = dict.fromkeys(PROFILE_GROUPS, 0.0)
    for name, (us, _) in events:
        group = next((g for g, marks in PROFILE_GROUPS.items()
                      if any(mark in name for mark in marks)), "elementwise and other")
        groups[group] += us
    for group, us in groups.items():
        print(f"    {group}: {us / 1e3:.2f} ms, {100 * us / busy_us:.1f}% of device time")
    lines = [f"{100 * us / busy_us:6.2f}%  {us / 1e3:9.3f} ms  {count:6d}x  {name[:110]}"
             for name, (us, count) in events]
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
    from lightning_generative_models_tpu_torch.ops import preprocess as pp
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
        pp.fused_normalize_flip.launches = 0
        t0 = time.perf_counter()
        model = train.main(argv + ["--max_steps", str(steps)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = la.linear_attention.launches, la.linear_attention_bwd.launches
        pre = pp.fused_normalize_flip.launches
        new_steps = steps - (0 if name == "train" else TRAIN_STEPS)
        want_fwd = 6 * new_steps + 6 * val_batches + 6 * DDIM_STEPS
        want_bwd = 6 * new_steps
        counts[name] = {"forward": fwd, "backward": bwd, "preprocess": pre}
        print(f"  {name}: {new_steps} steps to step {model.step} in {wall:.1f} s (model "
              f"build, data, validation, the grid and checkpoints included) on {card}")
        print(f"  {name}: linear_attention launches {fwd} (expected 6 x {new_steps} steps "
              f"+ 6 x {val_batches} validation batches + 6 x {DDIM_STEPS} grid = "
              f"{want_fwd}), backward launches {bwd} (expected {want_bwd}), preprocess "
              f"kernel launches {pre} (expected 0: the trainer keeps backend='xla')",
              flush=True)
        if (fwd, bwd, pre) != (want_fwd, want_bwd, 0):
            fail(f"the {name} run launched the kernels {fwd} + {bwd} + {pre} times")
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


def train_breakdown(torch, card: str, steps: int = 20, repeats: int = 3, config_path=CONFIG,
                    out_name: str = "train_profile.txt", precision: str = "bf16") -> dict:
    """Train images/s at the config's batch (128 but for PixelCNN's 64) of
    ``config_path``'s model built and warmed up (host clock around ``steps`` steps that end
    in a synchronize, median of ``repeats``), then one step under torch.profiler (its table
    to chiprun_out/chip_smoke/<out_name>). ``precision`` labels the printout: the config's
    (bf16 for the diffusion models)."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model

    config = load_config(config_path)
    model = load_model(config["model"], device="cuda")
    it = DataModule(**config["dataset"]).train_batches(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()} for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(n):
        for i in range(n):
            model.train_step(batches[i % len(batches)], gen)
        torch.cuda.synchronize()

    run(5)  # warm-up: cuDNN plans, cuSOLVER's lazy load, the allocator
    if hasattr(model, "ema_update_after_step"):
        # Past the EMA's hard-copy phase, as in a long run: a decay every 10th step.
        model.step = model.ema_update_after_step
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(steps)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    n = batches[0]["image"].shape[0]
    ips = steps * n / wall
    print(f"  {config['model']['name']} train bs{n} {precision}: "
          f"{1e3 * wall / steps:.2f} ms per step, median of {[round(w, 4) for w in walls]} s "
          f"per {steps} steps, {ips:.1f} images/s on {card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = profile_summary(torch, prof, wall_us, f"one train step bs{n}", out_name, card)
    return {"images_per_s": ips, "ms_per_step": 1e3 * wall / steps, **summary}


def vq_distances(torch, flat, codebook, idx):
    """Each row's squared distance (f64) to its chosen code, and to its nearest one."""
    dist = torch.cdist(flat.double(), codebook.double()) ** 2
    return dist.gather(1, idx.long()[:, None])[:, 0], dist.min(dim=1).values


def vq_bound_ms(n, k, d):
    """(bytes ms, operations ms, f32 FMA operations ms) of one search: flat, codebook and
    the indices read or written once; 2 n k d flops of f32 accuracy, at the 3xTF32 rate
    of the tensor cores (PEAK_F32_ACCURATE_FLOPS) and at the 67 TFLOP/s of f32 FMA."""
    nbytes = 4 * (n * d + k * d + n)
    flops = 2 * n * k * d
    return (1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_ACCURATE_FLOPS,
            1e3 * flops / PEAK_FLOPS["float32"])


def check_vq(torch, vq, vq_shapes=VQ_SHAPES, duplicates: bool = True) -> dict:
    """Kernel #6 against its plain version at ``vq_shapes`` (the VQ models' by default),
    on duplicated codebooks, and repeated; times by CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    main, shapes = {}, []
    for n, k, d in vq_shapes:
        flat = torch.randn(n, d, device="cuda", generator=gen)
        codebook = torch.randn(k, d, device="cuda", generator=gen)
        out = vq.nearest_codes_cuda(flat, codebook)
        again = vq.nearest_codes_cuda(flat, codebook)
        ref = vq.nearest_codes_plain(flat, codebook)
        torch.cuda.synchronize()
        chosen, d_min = vq_distances(torch, flat, codebook, out)
        ref_chosen, _ = vq_distances(torch, flat, codebook, ref)
        excess = ((chosen - d_min) / (1.0 + d_min.abs())).max().item()
        agree = (out == ref).float().mean().item()
        abs_err = (chosen - ref_chosen).abs().max().item()
        same = torch.equal(out, again)
        ok = excess <= VQ_TIE_TOL and agree >= VQ_AGREE and same
        print(f"  nearest_codes N={n} K={k} D={d}: worst (d_chosen - d_min) / (1 + |d_min|) "
              f"{excess:.2e} (tol {VQ_TIE_TOL:.0e}), indices equal to plain on "
              f"{100 * agree:.3f}% of rows, max |d_kernel - d_plain| {abs_err:.3e}, "
              f"bit-identical repeat={same} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the VQ kernel disagrees with its plain version at N={n} K={k} D={d}")
        cb_sq = (codebook * codebook).sum(1)
        ms = time_ms(lambda: vq.nearest_codes_cuda(flat, codebook))
        plain_ms = time_ms(lambda: vq.nearest_codes_plain(flat, codebook))
        library_ms = time_ms(
            lambda: torch.addmm(cb_sq, flat, codebook.T, alpha=-2.0).argmin(1))
        bytes_ms, ops_ms, fma_ms = vq_bound_ms(n, k, d)
        shape = {"n": n, "k": k, "d": d, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
                 "bytes_ms": bytes_ms, "ops_ms": ops_ms, "fma_ops_ms": fma_ms,
                 "max_abs_err": abs_err}
        shapes.append(shape)
        print(f"  time N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, addmm + argmin "
              f"{library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.5f} ms (bytes "
              f"{bytes_ms:.5f}, operations {ops_ms:.5f} at 165 TFLOP/s f32-accurate "
              f"(3xTF32); at 67 TFLOP/s of f32 FMA {fma_ms:.5f})", flush=True)
        if (n, k, d) == VQ_MAIN:
            main = shape
    if not duplicates:
        return {"shapes": shapes}
    flat = torch.randn(4096, 64, device="cuda", generator=gen)
    base = torch.randn(256, 64, device="cuda", generator=gen)
    for what, codebook, first in (
            ("[E; E]", torch.cat([base, base]), lambda i: i < 256),
            ("E repeated row by row", base.repeat_interleave(2, dim=0), lambda i: i % 2 == 0)):
        out = vq.nearest_codes_cuda(flat, codebook)
        plain = vq.nearest_codes_plain(flat, codebook)
        ok = bool(first(out).all()) and bool(first(plain).all())
        print(f"  duplicated codebook {what}: first index on every row: kernel "
              f"{bool(first(out).all())}, plain {bool(first(plain).all())} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the VQ search did not return the first index on a duplicated codebook")
    return {**main, "bound_by": "bytes" if main["bytes_ms"] > main["ops_ms"] else "operations",
            "shapes": shapes}


def rel_err(out, ref) -> float:
    """max |k - p| / max(max |p|, 1e-30), on the CPU."""
    out, ref = out.detach().float().cpu(), ref.detach().float().cpu()
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


class ReluMasks:
    """Stands in for F.relu and F.leaky_relu: records each call's mask (input > 0) on
    the card's pass and applies the same masks, in the same order, on the CPU's pass,
    counting the inputs that lie on the other side of 0 there. An input within f32
    noise of 0 (the decoder's activations are ~1e-3 at random init) can switch between
    the devices and move that element's gradient by its full size (ReLU) or 4/5 of it
    (LeakyReLU(0.2)); with the card's masks the CPU computes the same piecewise-linear
    function, and the two differ only by the order of f32 sums."""

    def __init__(self, torch):
        self.F = torch.nn.functional
        self.relu, self.leaky_relu = self.F.relu, self.F.leaky_relu
        self.masks, self.replay, self.flips, self.inputs = [], None, 0, 0

    def _mask(self, x):
        if self.replay is None:
            self.masks.append((x > 0).cpu())
            return None
        mask = self.masks[next(self.replay)].to(x.device)
        self.flips += int(((x > 0) != mask).sum())
        self.inputs += mask.numel()
        return mask

    def _relu(self, x, inplace=False):
        mask = self._mask(x)
        return self.relu(x) if mask is None else x * mask.to(x.dtype)

    def _leaky_relu(self, x, negative_slope=0.01, inplace=False):
        mask = self._mask(x)
        if mask is None:
            return self.leaky_relu(x, negative_slope)
        return x * (mask.to(x.dtype) * (1.0 - negative_slope) + negative_slope)

    def __enter__(self):
        self.F.relu, self.F.leaky_relu = self._relu, self._leaky_relu
        return self

    def __exit__(self, *exc):
        self.F.relu, self.F.leaky_relu = self.relu, self.leaky_relu
        if self.replay is None:
            self.replay = iter(range(len(self.masks)))


def check_vq_models(torch) -> None:
    """One f32 step at full width and batch 4, card against CPU, from the same weights
    (seed 0), batch and flips: the VQ-VAE's loss, metrics and gradients (plain and EMA
    codebook, and the EMA buffers after the step; the CPU takes the card's ReLU masks,
    see ReluMasks), and a VQGAN step after disc_start (every metric)."""
    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.registry import load_model

    rs = np.random.RandomState(7)
    batch = {"image": rs.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)}
    flip = torch.tensor([True, False, False, True])
    vae_args = load_config(VQVAE_CONFIG)["model"]["args"]
    for use_ema in (False, True):
        results, relu = [], ReluMasks(torch)
        for dev in ("cuda", "cpu"):
            model = load_model({"name": "VQVAE", "args": {**vae_args, "use_ema": use_ema}},
                               device=dev)
            names, params = zip(*[(n, p) for n, p in model.net.named_parameters()
                                  if p.requires_grad])
            with relu:
                loss, metrics = model._loss(model._x01(batch, None, True, flip), True)
                grads = torch.autograd.grad(loss, params)
            results.append(({k: v.detach() for k, v in metrics.items()}, grads,
                            list(model.net.buffers())))
        (m, g, b), (ref_m, ref_g, ref_b) = results
        errs = {k: rel_err(m[k], ref_m[k]) for k in ref_m}
        worst_g, worst_name = max((rel_err(x, y), n) for x, y, n in zip(g, ref_g, names))
        worst_b = max([rel_err(x, y) for x, y in zip(b, ref_b)], default=0.0)
        ok = (all(np.isfinite(float(v)) for v in m.values()) and max(errs.values()) <= VQ_TOL
              and worst_g <= VQ_TOL and worst_b <= VQ_TOL)
        print(f"  VQ-VAE step f32 bs4 full width, use_ema={use_ema}, card vs CPU: "
              + ", ".join(f"{k} {float(m[k]):.6f} (rel {e:.2e})" for k, e in errs.items())
              + f"; worst gradient max|k - p| / max|p| {worst_g:.2e} ({worst_name}) over "
              f"{len(g)} tensors, with the card's ReLU masks ({relu.flips} of {relu.inputs} "
              f"ReLU inputs on the other side of 0 on the CPU); buffers after the step "
              f"{worst_b:.2e} over {len(b)}; tol {VQ_TOL:.0e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"VQ-VAE step (use_ema={use_ema}): card and CPU disagree")

    gan_args = {**load_config(VQGAN_CONFIG)["model"]["args"], "disc_start": 0}
    results, relu = [], ReluMasks(torch)
    for dev in ("cuda", "cpu"):
        with relu:
            results.append(load_model({"name": "VQGAN", "args": gan_args},
                                      device=dev).train_step(batch, flip=flip))
    out, ref = results
    errs = {k: rel_err(out[k], ref[k]) for k in ref}
    ok = all(np.isfinite(float(v)) for v in out.values()) and max(errs.values()) <= VQ_TOL
    print("  VQGAN step f32 bs4 full width after disc_start, card vs CPU: " + ", ".join(
        f"{k} {float(out[k]):.6g} (rel {e:.2e})" for k, e in errs.items())
        + f", with the card's (leaky) ReLU masks ({relu.flips} of {relu.inputs} inputs on "
        f"the other side of 0 on the CPU); tol {VQ_TOL:.0e} {'ok' if ok else 'FAIL'}",
        flush=True)
    if not ok:
        fail("VQGAN step: card and CPU disagree")


def vq_train_run(torch, vq, train, config: Path, name: str, steps: int, extra: list,
                 per_step: int, val_batches: int, card: str, resume_from: int = 0):
    """One run of the train entry point; kernel #6's launches counted from 0 and held to
    per_step x new steps + one per validation batch."""
    argv = ["--config_path", str(config), "--device", "cuda", "--experiment_name", name,
            "--check_val_every_n_epoch", "1000", "--sample_every_n_steps", "0",
            "--max_steps", str(steps)] + extra
    torch.cuda.synchronize()
    vq.nearest_codes.launches = 0
    t0 = time.perf_counter()
    model = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vq.nearest_codes.launches
    new_steps = steps - resume_from
    want = per_step * new_steps + val_batches
    print(f"  {name}{' (resume)' if resume_from else ''}: {new_steps} steps to step "
          f"{model.step} in {wall:.1f} s (model build, data, validation, the grid and "
          f"checkpoints included) on {card}")
    print(f"  {name}: nearest_codes launches {launches} (expected {per_step} x {new_steps} "
          f"steps + {val_batches} validation batches = {want})", flush=True)
    if launches != want:
        fail(f"the {name} run launched the VQ kernel {launches} times, not {want}")
    if model.step != steps:
        fail(f"the {name} run ended at step {model.step}, not {steps}")
    return model, launches


def check_vq_run_dir(run_dir: Path, last_step: int, runs: int,
                     falls: str = "train_loss") -> list:
    """The run's metrics, grids, codebook tables and checkpoints, and that the metric
    ``falls`` fell; returns its train records."""
    import math

    records = read_metrics(run_dir)
    train_records = [r for r in records if "train_loss" in r]
    if not all(math.isfinite(r["train_loss"]) for r in train_records):
        fail(f"{run_dir.name}: a train loss is not finite")
    if train_records[-1]["step"] != last_step:
        fail(f"{run_dir.name}: the last logged step is {train_records[-1]['step']}")
    losses = [r[falls] for r in train_records]
    if not losses[-1] < losses[0]:
        fail(f"{run_dir.name}: {falls} did not fall: {losses[0]} -> {losses[-1]}")
    val = [r for r in records if "val_loss" in r]
    pngs = sorted((run_dir / "samples").glob("random_generation_*.png"))
    tables = sorted(run_dir.glob("codebook_*.json"))
    if len(val) != runs or len(pngs) != runs or len(tables) != runs:
        fail(f"{run_dir.name}: expected {runs} validations, grids and codebook tables; got "
             f"{len(val)}, {len(pngs)}, {len(tables)}")
    for which in ("last", "best"):
        if not (run_dir / "checkpoints" / f"checkpoint_meta_{which}.json").exists():
            fail(f"{run_dir.name}: no {which} checkpoint meta")
    print(f"  {run_dir.name}: {falls} by logged step " + ", ".join(
        f"{r['step']}: {r[falls]:.4f}" for r in train_records)
        + f"; val {[round(v['val_loss'], 4) for v in val]}; images/s logged at the last "
        f"step {train_records[-1]['images_per_sec']:.1f}", flush=True)
    return train_records


def vq_main_path(torch, vq, card: str) -> dict:
    """The VQ training path through the train entry point, then generate."""
    from lightning_generative_models_tpu_torch import generate, train
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vae = load_config(VQVAE_CONFIG)
    ema = json.loads(json.dumps(vae))
    ema["model"]["args"]["use_ema"] = True  # vqvae_ema.json's widths and settings at 32 px
    ema["model"]["args"]["loss_weights"]["vq_loss"] = 10
    ema_config = OUT_DIR / "vqvae_ema_cifar10.json"
    ema_config.write_text(json.dumps(ema, indent=2))
    gan = load_config(VQGAN_CONFIG)
    gan["model"]["args"]["disc_start"] = VQGAN_DISC_START
    gan_config = OUT_DIR / f"vqgan_disc_start_{VQGAN_DISC_START}.json"
    gan_config.write_text(json.dumps(gan, indent=2))

    def val_batches(config):
        return len(list(DataModule(**config["dataset"]).val_batches()))

    for name, dirname in (("chip_smoke_vqvae", "VQVAE"), ("chip_smoke_vqvae_ema", "VQVAE"),
                          ("chip_smoke_vqgan", "VQGAN")):
        shutil.rmtree(EXPERIMENT_DIR / dirname / name, ignore_errors=True)
    counts = {}
    vae_val = val_batches(vae)
    _, counts["vqvae"] = vq_train_run(torch, vq, train, VQVAE_CONFIG, "chip_smoke_vqvae",
                                      VQ_STEPS, [], 1, vae_val, card)
    _, counts["vqvae_resume"] = vq_train_run(
        torch, vq, train, VQVAE_CONFIG, "chip_smoke_vqvae", VQ_STEPS + VQ_RESUME_STEPS,
        ["--resume"], 1, vae_val, card, resume_from=VQ_STEPS)
    check_vq_run_dir(EXPERIMENT_DIR / "VQVAE" / "chip_smoke_vqvae",
                     VQ_STEPS + VQ_RESUME_STEPS - 1, 2)

    model, counts["vqvae_ema"] = vq_train_run(torch, vq, train, ema_config,
                                              "chip_smoke_vqvae_ema", VQ_STEPS, [], 1,
                                              val_batches(ema), card)
    check_vq_run_dir(EXPERIMENT_DIR / "VQVAE" / "chip_smoke_vqvae_ema", VQ_STEPS - 1, 1)
    start = load_model(ema["model"], device="cuda")
    start.init_params(torch.Generator().manual_seed(10))  # the train CLI's default seed
    moved = (model.vq.embedding - start.vq.embedding).abs().max().item()
    used = int((model.vq.ema_cluster_size > 1e-3).sum())
    print(f"  EMA codebook: max |moved| {moved:.4e} after {VQ_STEPS} steps; {used} of "
          f"{model.num_embeddings} codes with a cluster size above 1e-3", flush=True)
    if not moved > 0:
        fail("the EMA codebook did not move")

    model, counts["vqgan"] = vq_train_run(torch, vq, train, gan_config, "chip_smoke_vqgan",
                                          VQGAN_STEPS, [], 1, val_batches(gan), card)
    # After disc_start the total adds the adversarial term, which need not fall while
    # the discriminator learns: the reconstruction is what must.
    records = check_vq_run_dir(EXPERIMENT_DIR / "VQGAN" / "chip_smoke_vqgan",
                               VQGAN_STEPS - 1, 1, falls="train_recon_loss")
    d_losses = {r["step"]: r["train_d_loss"] for r in records}
    print(f"  VQGAN by logged step: d_loss {d_losses} (disc_start {VQGAN_DISC_START}); "
          f"train_loss {[round(r['train_loss'], 4) for r in records]}; g_adv_loss "
          f"{[round(r['train_g_adv_loss'], 4) for r in records]}; adaptive weight "
          f"{[round(r['train_adaptive_weight'], 6) for r in records]}", flush=True)
    if d_losses[0] != 0.0 or not d_losses[VQGAN_STEPS - 1] > 0.0:
        fail("VQGAN: d_loss is not 0 before disc_start and non-zero after it")

    vq.nearest_codes.launches = 0
    out = OUT_DIR / "vqvae"
    images = generate.main(["--config_path", str(VQVAE_CONFIG), "--num_samples", "64",
                            "--device", "cuda", "--seed", "0", "--out", str(out)])
    torch.cuda.synchronize()
    print(f"  generate {VQVAE_CONFIG.name}: {images.shape} decoded from random codes, "
          f"nearest_codes launches {vq.nearest_codes.launches} (expected 0)", flush=True)
    if vq.nearest_codes.launches or not (out / "grid.png").exists():
        fail("generate on the VQ-VAE searched codes or wrote no grid")
    if images.shape != (64, 32, 32, 3) or not (images.min() >= 0.0 and images.max() <= 1.0):
        fail(f"VQ-VAE samples have shape {images.shape} or leave [0, 1]")
    return counts


def vq_train_breakdown(torch, vq, card: str, steps: int = 20, repeats: int = 3) -> dict:
    """VQ-VAE train images/s at bs256, f32 (TF32 off), with the model built and warmed
    up, median of ``repeats`` timings of ``steps`` steps; then five steps under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model

    config = load_config(VQVAE_CONFIG)
    batch_size = config["dataset"]["batch_size"]
    model = load_model(config["model"], device="cuda")
    it = DataModule(**config["dataset"]).train_batches(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()} for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(n):
        for i in range(n):
            model.train_step(batches[i % len(batches)], gen)
        torch.cuda.synchronize()

    run(5)  # warm-up: cuDNN plans, the allocator
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(steps)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    ips = steps * batch_size / wall
    print(f"  VQ-VAE train bs{batch_size} f32 (TF32 off): {1e3 * wall / steps:.3f} ms per step, "
          f"median of {[round(w, 4) for w in walls]} s per {steps} steps, {ips:.1f} images/s "
          f"on {card}", flush=True)
    profiled = 5
    vq.nearest_codes.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(profiled)
        wall_us = 1e6 * (time.perf_counter() - t0)
    searches = vq.nearest_codes.launches
    summary = profile_summary(torch, prof, wall_us, f"{profiled} VQ-VAE train steps bs{batch_size}",
                              "vq_profile.txt", card)
    vq_us = sum(e.self_device_time_total for e in prof.key_averages()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and "vq_nearest_wgmma_kernel" in e.key)
    out = {"images_per_s": ips, "ms_per_step": 1e3 * wall / steps,
           "vq_launches_per_step": searches / profiled}
    if summary:
        out.update({"launches_per_step": summary["launches"] / profiled,
                    "busy_share": summary["busy_us"] / summary["wall_us"],
                    "vq_share_of_device_time": vq_us / summary["busy_us"]})
        print(f"  per step: {out['launches_per_step']:.0f} kernel launches, "
              f"{out['vq_launches_per_step']:.0f} of kernel #6; kernel #6 "
              f"{vq_us / profiled:.1f} us = {100 * out['vq_share_of_device_time']:.2f}% of "
              f"device time", flush=True)
    return out


def attn_bound_ms(b, n, heads, d, dtype, backward=False):
    """(bytes ms, operations ms) of one call: qkv read and the output written once
    (backward: qkv and g read, dqkv written); 4 b h n^2 d flops forward (q k^T and p v),
    10 b h n^2 d backward (the five [n, n] x d products), at ATTN_PEAK_FLOPS of the type."""
    elt = 2 if dtype == "bfloat16" else 4
    hd = heads * d
    nbytes = b * n * (3 * hd + hd + (3 * hd if backward else 0)) * elt
    flops = (10 if backward else 4) * b * heads * n * n * d
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / ATTN_PEAK_FLOPS[dtype]


def sdpa_views(qkv, heads, layout):
    """[b, h, n, d] views of q, k and v in the packed tensor, for the library yardstick."""
    b, n, w3 = qkv.shape
    d = w3 // (3 * heads)
    if layout == "h3d":
        x = qkv.view(b, n, heads, 3, d)
        return [x[:, :, :, i].transpose(1, 2) for i in range(3)]
    x = qkv.view(b, n, 3, heads, d)
    return [x[:, :, i].transpose(1, 2) for i in range(3)]


def check_attention(torch, ta, cases=ATTN_CASES,
                    main_case=(*ATTN_MAIN, "s3hd", "bfloat16")) -> dict:
    """Kernels #3 and #4 against their plain versions on the card (``cases``): the
    forward, the backward, bit-identical repeats, and the autograd path (forward kernel +
    backward kernel) against torch autograd through the plain version (f32; in bf16
    against autograd through the plain math in f32 on the same bf16 inputs). Times by
    CUDA events beside the bounds and torch's scaled_dot_product_attention."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes, main = [], {}
    for b, n, heads, d, layout, dt in cases:
        dtype = getattr(torch, dt)
        qkv = torch.randn(b, n, 3 * heads * d, device="cuda", generator=gen).to(dtype)
        g = torch.randn(b, n, heads * d, device="cuda", generator=gen).to(dtype)
        with torch.inference_mode():
            out = ta.attention_qkv_cuda(qkv, heads, layout)
            again = ta.attention_qkv_cuda(qkv, heads, layout)
            ref = ta.attention_qkv_plain(qkv, heads, layout)
            dqkv = ta.attention_qkv_bwd_cuda(qkv, g, heads, layout)
            dagain = ta.attention_qkv_bwd_cuda(qkv, g, heads, layout)
            dref = ta.attention_qkv_bwd_plain(qkv, g, heads, layout)
            math = ta.attention_qkv_plain(qkv.float(), heads, layout)
        leaves = [qkv.detach().clone().requires_grad_(True) for _ in range(2)]
        ta.fused_attention_qkv(leaves[0], heads, layout).backward(g)
        ta.attention_qkv_plain(leaves[1].float(), heads, layout).backward(g.float())
        torch.cuda.synchronize()
        fwd_err = ((out.float() - ref.float()).abs() / (1 + ref.float().abs())).max().item()
        math_err = ((out.float() - math).abs() / (1 + math.abs())).max().item()
        bwd_err = grad_err(dqkv, dref)
        auto_err = grad_err(leaves[0].grad, leaves[1].grad)
        abs_err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(dqkv.float()).all())
        same = torch.equal(out, again) and torch.equal(dqkv, dagain)
        ok = (finite and same and fwd_err <= ATTN_TOL[dt] and bwd_err <= ATTN_BWD_TOL[dt]
              and auto_err <= ATTN_BWD_TOL[dt]
              and (dt == "float32" or math_err <= ATTN_BF16_MATH))
        print(f"  attention_qkv b={b} n={n} h={heads} d={d} {layout} {dt}: forward rel_err "
              f"{fwd_err:.2e} (tol {ATTN_TOL[dt]:.0e}"
              + (f"; vs f32 math {math_err:.2e}, tol {ATTN_BF16_MATH:.0e}" if dt == "bfloat16" else "")
              + f"), backward rel_err {bwd_err:.2e}, autograd path {auto_err:.2e} (tol "
              f"{ATTN_BWD_TOL[dt]:.0e}), bit-identical repeats={same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the attention kernels disagree with their plain versions or repeat "
                 f"differently at b={b} n={n} h={heads} d={d} {layout} {dt}")

        q, k, v = sdpa_views(qkv, heads, layout)
        ql, kl, vl = sdpa_views(qkv.detach().clone().requires_grad_(True), heads, layout)
        sdpa_out = F.scaled_dot_product_attention(ql, kl, vl)
        g4 = g.view(b, n, heads, d).transpose(1, 2)
        with torch.inference_mode():
            ms = time_ms(lambda: ta.attention_qkv_cuda(qkv, heads, layout))
            plain_ms = time_ms(lambda: ta.attention_qkv_plain(qkv, heads, layout))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            bwd_ms = time_ms(lambda: ta.attention_qkv_bwd_cuda(qkv, g, heads, layout))
            bwd_plain_ms = time_ms(lambda: ta.attention_qkv_bwd_plain(qkv, g, heads, layout))
        bwd_library_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (ql, kl, vl), g4, retain_graph=True))
        bytes_ms, ops_ms = attn_bound_ms(b, n, heads, d, dt)
        bbytes_ms, bops_ms = attn_bound_ms(b, n, heads, d, dt, backward=True)
        shape = {"b": b, "n": n, "heads": heads, "d": d, "layout": layout, "dtype": dt,
                 "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                 "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
                 "bwd_library_ms": bwd_library_ms, "bwd_bound_ms": max(bbytes_ms, bops_ms),
                 "bwd_bytes_ms": bbytes_ms, "bwd_ops_ms": bops_ms,
                 "max_abs_err": abs_err,
                 "bwd_max_abs_err": (dqkv.float() - dref.float()).abs().max().item(),
                 "rel_err": fwd_err, "bwd_rel_err": bwd_err}
        shapes.append(shape)
        print(f"  time: forward kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {shape['bound_ms']:.4f} ms (bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f} at {ATTN_PEAK_IS[dt]}); backward kernel {bwd_ms:.4f} "
              f"ms, plain {bwd_plain_ms:.4f} ms, SDPA backward {bwd_library_ms:.4f} ms, bound "
              f"{shape['bwd_bound_ms']:.4f} ms (bytes {bbytes_ms:.4f}, operations "
              f"{bops_ms:.4f})", flush=True)
        if (b, n, heads, d, layout, dt) == main_case:
            main = shape
    return {**main, "shapes": shapes}


def open_dit(torch, net, seed: int, std: float = 0.02):
    """Move every DiT weight by N(0, std^2) from a CPU generator: adaLN-Zero starts the
    gates, the final modulation and the head at 0, where the output is 0 whatever the
    attention computes."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * std)
    return net


def report_close(torch, name: str, out, ref) -> None:
    """Fail unless ``out`` is finite and within DIT_TOL x max(1, max |ref|) of ``ref``."""
    err = (out.float().cpu() - ref.float().cpu()).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    ok = bool(torch.isfinite(out).all()) and err <= DIT_TOL * scale
    print(f"  {name}: max_abs_err={err:.3e} (max|ref|={scale:.3f}, tol {DIT_TOL:.0e} x "
          f"max(1, max|ref|)) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: the two disagree")


def report_grad_steps(torch, name: str, models: dict, batch: dict, draws: dict) -> list:
    """One grad_step on the CPU and on the card from the same batch and draws: the loss
    within DIT_TOL relative, each gradient within DIT_TOL of its largest magnitude.
    Returns the two steps' metrics, CPU first."""
    import numpy as np

    results, step_metrics = [], []
    for dev in ("cpu", "cuda"):
        grads, metrics = models[dev].grad_step(batch, **draws)
        step_metrics.append({k: float(v) for k, v in metrics.items()})
        results.append((float(metrics["loss"]), [g.float().cpu() for g in grads]))
    (ref_loss, ref_g), (loss, out_g) = results
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    worst = max(((k - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
                for k, p in zip(out_g, ref_g))
    ok = np.isfinite(loss) and loss_err <= DIT_TOL and worst <= DIT_TOL
    print(f"  {name}: loss {loss:.6f} vs {ref_loss:.6f} (rel {loss_err:.2e}); worst gradient "
          f"max|k - p| / max|p| = {worst:.2e} over {len(out_g)} tensors; tol {DIT_TOL:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: card and CPU disagree")
    return step_metrics


def check_dit_card_vs_cpu(torch) -> None:
    """The full-width DiT-S/2 in f32 at bs2, card against CPU, the same weights and
    inputs: the forward, a 3-step DDIM chain with guidance, one train step."""
    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM

    args = {**load_config(DIT_CONFIG)["model"]["args"], "use_bf16": False}
    models = {dev: DDPM(**args, device=dev) for dev in ("cpu", "cuda")}
    open_dit(torch, models["cpu"].unet, seed=13)
    for dev, model in models.items():
        if dev != "cpu":
            model.unet.load_state_dict(models["cpu"].unet.state_dict())
        model.copy_params_to_ema()

    gen = torch.Generator().manual_seed(14)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    t, labels = torch.tensor([0, 999]), torch.tensor([3, 10])  # 10: the null class
    with torch.inference_mode():
        ref = models["cpu"].unet(x, t, labels=labels)
        out = models["cuda"].unet(x.cuda(), t.cuda(), labels=labels.cuda())
    report_close(torch, "DiT-S/2 f32 bs2 forward, card vs CPU", out, ref)

    x_T = torch.randn(2, 32, 32, 3, generator=gen)
    samples = [models[dev].sample(None, 2, steps=3, x_T=x_T) for dev in ("cpu", "cuda")]
    report_close(torch, "DDIM-3 with guidance (w 3) f32 bs2 from one x_T, card vs CPU",
                 samples[1], samples[0])

    rs = np.random.RandomState(15)
    batch = {"image": rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             "label": np.array([4, 7], np.int32)}
    draws = {"flip": torch.tensor([True, False]), "drop": torch.tensor([False, True]),
             "t": torch.tensor([10, 600]),
             "noise": torch.tensor(rs.randn(2, 32, 32, 3).astype(np.float32))}
    report_grad_steps(torch, "DiT train step f32 bs2, card vs CPU", models, batch, draws)


def flash_bound_ms(b, heads, n_q, n_kv, d, dtype, backward=False):
    """(bytes ms, operations ms) of one call: q, k, v read and o written once (backward:
    q, k, v and g read, dq, dk, dv written); 4 b h n_q n_kv d flops forward, 10 backward
    (the five [n_q, n_kv] x d products), at ATTN_PEAK_FLOPS of the type."""
    elt = 2 if dtype == "bfloat16" else 4
    rows = (3 * n_q + 4 * n_kv) if backward else (2 * n_q + 2 * n_kv)
    nbytes = b * heads * rows * d * elt
    flops = (10 if backward else 4) * b * heads * n_q * n_kv * d
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / ATTN_PEAK_FLOPS[dtype]


def flash_operands(torch, gen, b, heads, n_q, n_kv, d, operands, dtype):
    """(bases, views): the tensors that own the memory, and a function from bases to
    the [b, h, n, d] q, k, v that the caller hands over: views of a packed qkv ("s3hd",
    "h3d", n_q == n_kv), of [b, n, h, d] tensors ("bnhd"), or the tensors themselves
    ("bhnd")."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    if operands in ("s3hd", "h3d"):
        return [randn(b, n_q, 3 * heads * d)], lambda t: sdpa_views(t[0], heads, operands)
    if operands == "bnhd":
        bases = [randn(b, n_q, heads, d), randn(b, n_kv, heads, d), randn(b, n_kv, heads, d)]
        return bases, lambda t: [x.transpose(1, 2) for x in t]
    return [randn(b, heads, n_q, d), randn(b, heads, n_kv, d), randn(b, heads, n_kv, d)], list


def qkv_kernel_on_views(torch, ta, q, k, v):
    """Kernel #3's kernel (csrc/attention_qkv.cu) on [b, h, n, d] q, k and v through its C
    entry, which takes any (batch, token, head) strides and n_q != n_kv: is it faster than
    #5 on #5's own operands? Launched here only, so counted nowhere."""
    import ctypes

    b, h, n_q, d = q.shape
    if not all(ta._rows_aligned(t) for t in (q, k, v)):
        fail("the flash operands are not 16-byte aligned rows")
    out = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(2), t.stride(1))]
    strides = (ctypes.c_longlong * 12)(*strides, n_q * h * d, h * d, d)
    lib = ta._library("attention_qkv", "lgm_attention_qkv_fwd", ta._FWD_ARGTYPES)
    err = lib.lgm_attention_qkv_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
        b, h, n_q, k.shape[2], d, int(q.dtype == torch.bfloat16), d**-0.5,
        torch.cuda.current_stream().cuda_stream)
    ta.cuda_build.check(lib, err, "attention kernel on [b, h, n, d] views")
    return out.transpose(1, 2)


def check_flash_attention(torch, ta) -> dict:
    """Kernel #5 against flash_attention_plain on the card (FLASH_CASES): the forward,
    bit-identical repeats, in bf16 also against the plain math in f32; the backward route
    (kernel #4's entry on [b, h, n, d] strides, with n_q != n_kv) against the plain
    gradient in f32, and the autograd path through the operands' views against torch
    autograd through the plain version. Times by CUDA events beside the bounds and
    scaled_dot_product_attention (forward, and its backward alone)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(17)
    shapes, main = [], {}
    for b, heads, n_q, n_kv, d, operands, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        bases, views = flash_operands(torch, gen, b, heads, n_q, n_kv, d, operands, dtype)
        q, k, v = views(bases)
        g = torch.randn(b, n_q, heads, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
        with torch.inference_mode():
            out = ta.flash_attention_cuda(q, k, v)
            again = ta.flash_attention_cuda(q, k, v)
            ref = ta.flash_attention_plain(q, k, v)
            math = ta.flash_attention_plain(q.float(), k.float(), v.float())
            grads = ta.flash_attention_bwd_cuda(q, k, v, g)
            grads_again = ta.flash_attention_bwd_cuda(q, k, v, g)
        # The gradient's yardstick: autograd through the plain version in f32 (in bf16 on
        # the same bf16 inputs: autograd in bf16 rounds dP and dS and is none).
        grads_ref = ta.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
        leaves = [[x.detach().clone().requires_grad_(True) for x in bases] for _ in range(2)]
        ta.flash_attention(*views(leaves[0])).backward(g)
        ta.flash_attention_plain(*(x.float() for x in views(leaves[1]))).backward(g.float())
        torch.cuda.synchronize()
        fwd_err = ((out.float() - ref.float()).abs() / (1 + ref.float().abs())).max().item()
        math_err = ((out.float() - math).abs() / (1 + math.abs())).max().item()
        bwd_err = max(grad_err(x, r) for x, r in zip(grads, grads_ref))
        auto_err = max(grad_err(a.grad, p.grad) for a, p in zip(*leaves))
        finite = bool(torch.isfinite(out.float()).all()) and all(
            bool(torch.isfinite(x.float()).all()) for x in grads)
        same = torch.equal(out, again) and all(torch.equal(x, y)
                                               for x, y in zip(grads, grads_again))
        ok = (finite and same and fwd_err <= ATTN_TOL[dt] and bwd_err <= ATTN_BWD_TOL[dt]
              and auto_err <= ATTN_BWD_TOL[dt]
              and (dt == "float32" or math_err <= ATTN_BF16_MATH))
        print(f"  flash_attention b={b} h={heads} n_q={n_q} n_kv={n_kv} d={d} {operands} {dt}: "
              f"forward rel_err {fwd_err:.2e} (tol {ATTN_TOL[dt]:.0e}; vs f32 math "
              f"{math_err:.2e}" + (f", tol {ATTN_BF16_MATH:.0e}" if dt == "bfloat16" else "")
              + f"), backward route {bwd_err:.2e}, autograd path {auto_err:.2e} (tol "
              f"{ATTN_BWD_TOL[dt]:.0e}), bit-identical repeats={same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the flash attention kernel or its backward route disagrees with the plain "
                 f"version or repeats differently at b={b} h={heads} n_q={n_q} n_kv={n_kv} "
                 f"d={d} {operands} {dt}")

        sdpa_leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*sdpa_leaves)
        with torch.inference_mode():
            ms = time_ms(lambda: ta.flash_attention_cuda(q, k, v))
            plain_ms = time_ms(lambda: ta.flash_attention_plain(q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            bwd_ms = time_ms(lambda: ta.flash_attention_bwd_cuda(q, k, v, g))
            qkv_out = qkv_kernel_on_views(torch, ta, q, k, v)
            qkv_ms = time_ms(lambda: qkv_kernel_on_views(torch, ta, q, k, v))
        qkv_err = ((qkv_out.float() - math).abs() / (1 + math.abs())).max().item()
        if qkv_err > (ATTN_TOL["float32"] if dt == "float32" else ATTN_BF16_MATH):
            fail(f"kernel #3 on the flash operands disagrees with the plain math: {qkv_err:.2e}")
        bwd_plain_ms = time_ms(lambda: ta.flash_attention_bwd_plain(q, k, v, g))
        bwd_library_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, sdpa_leaves, g, retain_graph=True))
        bytes_ms, ops_ms = flash_bound_ms(b, heads, n_q, n_kv, d, dt)
        bbytes_ms, bops_ms = flash_bound_ms(b, heads, n_q, n_kv, d, dt, backward=True)
        shape = {"b": b, "heads": heads, "n_q": n_q, "n_kv": n_kv, "d": d,
                 "operands": operands, "dtype": dt, "ms": ms, "plain_ms": plain_ms,
                 "qkv_kernel_ms": qkv_ms, "qkv_kernel_math_rel_err": qkv_err,
                 "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
                 "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bwd_ms": bwd_ms,
                 "bwd_plain_ms": bwd_plain_ms, "bwd_library_ms": bwd_library_ms,
                 "bwd_bound_ms": max(bbytes_ms, bops_ms), "bwd_bytes_ms": bbytes_ms,
                 "bwd_ops_ms": bops_ms,
                 "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                 "math_max_abs_err": (out.float() - math).abs().max().item(),
                 "rel_err": fwd_err, "math_rel_err": math_err, "bwd_rel_err": bwd_err}
        shapes.append(shape)
        print(f"  time: forward kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {shape['bound_ms']:.4f} ms (bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f} at {ATTN_PEAK_IS[dt]}), kernel #3 on the same operands "
              f"{qkv_ms:.4f} ms (vs f32 math {qkv_err:.2e}); backward route {bwd_ms:.4f} ms, "
              f"plain (autograd) "
              f"{bwd_plain_ms:.4f} ms, SDPA backward {bwd_library_ms:.4f} ms, bound "
              f"{shape['bwd_bound_ms']:.4f} ms (bytes {bbytes_ms:.4f}, operations "
              f"{bops_ms:.4f})", flush=True)
        if (b, heads, n_q, n_kv, d, operands, dt) == FLASH_MAIN:
            main = shape
    return {**main, "shapes": shapes}


def check_preprocess(torch, pp) -> dict:
    """Kernel #7 against fused_normalize_flip_plain on the card (PRE_SHAPES, f32 and
    bf16): bit for bit in f32, within one bf16 step in bf16, bit-identical repeats; times
    beside the bound (bytes), the default backend="xla" path of prepare_batch and the
    launch floor: an empty kernel (csrc/preprocess.cu's lgm_empty_launch) of one block and
    of as many blocks as the main shape has images, timed the same way. Then
    prepare_batch(backend="pallas") over PRE_PATH_BATCHES train batches of the FM config
    with the kernel's count from 0: one launch a batch, each batch equal bit for bit to
    backend="xla" (f32)."""
    import ctypes

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.ops import cuda_build

    lib = cuda_build.load("preprocess")
    lib.lgm_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.lgm_empty_launch.restype = ctypes.c_int

    def empty(blocks):
        cuda_build.check(lib, lib.lgm_empty_launch(
            blocks, torch.cuda.current_stream().cuda_stream), "empty kernel")

    floor = {blocks: time_ms(lambda: empty(blocks)) for blocks in (1, PRE_MAIN[0][0])}
    print(f"  launch floor (an empty kernel, 256 threads a block, timed as the kernels are): "
          f"{floor[1]:.4f} ms at 1 block, {floor[PRE_MAIN[0][0]]:.4f} ms at "
          f"{PRE_MAIN[0][0]} blocks", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(18)
    shapes, main = [], {}
    for shape in PRE_SHAPES:
        images = torch.randint(0, 256, shape, device="cuda", generator=gen, dtype=torch.uint8)
        flip = torch.rand(shape[0], device="cuda", generator=gen) < 0.5
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            out = pp.fused_normalize_flip_cuda(images, flip, dtype)
            again = pp.fused_normalize_flip_cuda(images, flip, dtype)
            ref = pp.fused_normalize_flip_plain(images, flip, dtype)
            torch.cuda.synchronize()
            err = ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1e-30)
                   ).max().item()
            ok = (torch.equal(out, again) and out.dtype == dtype
                  and (torch.equal(out, ref) if dt == "float32" else err <= 2.0**-7))
            ms = time_ms(lambda: pp.fused_normalize_flip_cuda(images, flip, dtype))
            plain_ms = time_ms(lambda: pp.fused_normalize_flip_plain(images, flip, dtype))
            xla_ms = time_ms(lambda: pp.prepare_batch({"image": images}, train=True,
                                                      flip=flip, dtype=dtype))
            elt = 2 if dt == "bfloat16" else 4
            bound_ms = 1e3 * (images.numel() * (1 + elt) + shape[0]) / PEAK_BYTES_PER_S
            entry = {"shape": list(shape), "dtype": dt, "ms": ms, "plain_ms": plain_ms,
                     "xla_ms": xla_ms, "bound_ms": bound_ms,
                     "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                     "rel_err": err}
            shapes.append(entry)
            print(f"  preprocess {shape} {dt}: rel_err {err:.2e} (f32: bit for bit; bf16 tol "
                  f"2^-7), repeats bit-identical={torch.equal(out, again)} "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"backend xla {xla_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes)", flush=True)
            if not ok:
                fail(f"the preprocess kernel disagrees with its plain version at {shape} {dt}")
            if (shape, dt) == PRE_MAIN:
                main = entry

    it = DataModule(**load_config(FM_CONFIG)["dataset"]).train_batches(0)
    pp.fused_normalize_flip.launches = 0
    for _ in range(PRE_PATH_BATCHES):
        batch = {k: torch.as_tensor(v).cuda() for k, v in next(it).items()}
        flip = torch.rand(batch["image"].shape[0], device="cuda", generator=gen) < 0.5
        fused = pp.prepare_batch(batch, train=True, flip=flip, backend="pallas")["image"]
        xla = pp.prepare_batch(batch, train=True, flip=flip)["image"]
        if not torch.equal(fused, xla):
            fail("prepare_batch(backend='pallas') differs from backend='xla' in f32")
    launches = pp.fused_normalize_flip.launches
    print(f"  prepare_batch(backend='pallas') over {PRE_PATH_BATCHES} train batches of "
          f"{FM_CONFIG.name}: {launches} launches (expected {PRE_PATH_BATCHES}), each equal "
          f"bit for bit to backend='xla'", flush=True)
    if launches != PRE_PATH_BATCHES:
        fail(f"prepare_batch(backend='pallas') launched the kernel {launches} times")
    return {**main, "launches": launches, "shapes": shapes,
            "launch_floor_ms": {f"{b} blocks": ms for b, ms in floor.items()}}


def check_fm_card_vs_cpu(torch) -> None:
    """FlowMatching DiT-S/2 with flash_attn (FM_CONFIG) in f32 at bs2, card against CPU,
    the same weights and inputs: the forward (the flash kernel on the card, 12 launches,
    no packed-qkv kernel), an Euler-3 chain from one x_1 and one train step's loss and
    gradients. Then on the card the same weights with flash_attn off (kernel #3) against
    flash_attn on (kernel #5)."""
    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.models.diffusion.flow_matching import (
        FlowMatching,
    )

    args = {**load_config(FM_CONFIG)["model"]["args"], "use_bf16": False}
    models = {dev: FlowMatching(**args, device=dev) for dev in ("cpu", "cuda")}
    models["packed"] = FlowMatching(**{**args, "flash_attn": False}, device="cuda")
    open_dit(torch, models["cpu"].unet, seed=23)
    for dev, model in models.items():
        if dev != "cpu":
            model.unet.load_state_dict(models["cpu"].unet.state_dict())
        model.copy_params_to_ema()

    gen = torch.Generator().manual_seed(24)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    t = torch.tensor([0.02, 0.97]) * 1000.0  # the flow's t times its time_scale
    with torch.inference_mode():
        ref = models["cpu"].unet(x, t)
        zero_counts()
        out = models["cuda"].unet(x.cuda(), t.cuda())
        torch.cuda.synchronize()
        flash_counts = read_counts()
        packed = models["packed"].unet(x.cuda(), t.cuda())
        torch.cuda.synchronize()
        packed_counts = {k: v - flash_counts[k] for k, v in read_counts().items()}
    report_close(torch, "FM-DiT-S/2 flash f32 bs2 forward, card vs CPU", out, ref)
    report_close(torch, "FM-DiT-S/2 f32 bs2 forward on the card, flash off (kernel #3) vs "
                 "on (kernel #5)", packed, out)
    want_flash = dict.fromkeys(PATH_COUNTERS, 0) | {"flash_attention": DIT_DEPTH}
    want_packed = dict.fromkeys(PATH_COUNTERS, 0) | {"fused_attention_qkv": DIT_DEPTH}
    print(f"  launches: flash on {flash_counts}, flash off {packed_counts}", flush=True)
    if flash_counts != want_flash or packed_counts != want_packed:
        fail("the flash and packed DiT forwards did not launch their own kernels")

    x_T = torch.randn(2, 32, 32, 3, generator=gen)
    samples = [models[dev].sample(None, 2, steps=3, x_T=x_T) for dev in ("cpu", "cuda")]
    report_close(torch, "Euler-3 f32 bs2 from one x_1, card vs CPU", samples[1], samples[0])

    rs = np.random.RandomState(25)
    batch = {"image": rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             "label": np.zeros(2, np.int32)}
    draws = {"flip": torch.tensor([False, True]), "t": torch.tensor([0.3, 0.85]),
             "noise": torch.tensor(rs.randn(2, 32, 32, 3).astype(np.float32))}
    report_grad_steps(torch, "FM-DiT flash train step f32 bs2, card vs CPU", models, batch,
                      draws)


@dataclass(frozen=True)
class TransformerPath:
    """One DiT-backbone main path: its config, the experiment it trains into, the launch
    counters of its attention kernels, the rows and the evaluations of a generate batch
    and the grids one validation writes."""
    name: str
    config: Path
    model: str  # experiments/<model>/<run>
    run: str
    fwd: str  # ops.attention counters of its forward and backward kernels
    bwd: str
    sampler: str
    rows: int  # rows of one network evaluation in generate
    grids: int
    steps: int
    resume_steps: int
    out: str  # chiprun_out/chip_smoke/<out>/grid.png, <out>_{train,sample}_profile.txt


DIT_PATH = TransformerPath(
    "DiT", DIT_CONFIG, "DDPM", DIT_RUN, "fused_attention_qkv", "fused_attention_qkv_bwd",
    f"DDIM-{DDIM_STEPS} guided", 2 * DIT_BATCH, 2, DIT_TRAIN_STEPS, DIT_RESUME_STEPS, "dit")
FM_PATH = TransformerPath(
    "FM-DiT flash", FM_CONFIG, "FlowMatching", FM_RUN, "flash_attention",
    "flash_attention_bwd_cuda", f"Euler-{DDIM_STEPS}", DIT_BATCH, 1, FM_TRAIN_STEPS,
    FM_RESUME_STEPS, "fm_dit")
#: Every kernel's launch counter, by name, with the ops module that owns it. The DiT-backbone
#: and DCGAN paths hold all of them; each launches its own kernels and none of the others,
#: not the preprocess kernel, which no trainer selects (prepare_batch keeps backend="xla").
PATH_COUNTERS = {"fused_attention_qkv": "attention", "fused_attention_qkv_bwd": "attention",
                 "flash_attention": "attention", "flash_attention_bwd_cuda": "attention",
                 "fused_normalize_flip": "preprocess", "linear_attention": "linear_attention",
                 "linear_attention_bwd": "linear_attention", "nearest_codes": "vq"}


def _counter(name: str):
    module = f"lightning_generative_models_tpu_torch.ops.{PATH_COUNTERS[name]}"
    return getattr(importlib.import_module(module), name)


def zero_counts() -> None:
    for name in PATH_COUNTERS:
        _counter(name).launches = 0


def read_counts() -> dict:
    return {name: _counter(name).launches for name in PATH_COUNTERS}


def derive_fm_flash_config() -> None:
    """FM_CONFIG: configs/diffusion/fm_dit_cifar10.json with "flash_attn": true."""
    config = json.loads(FM_BASE_CONFIG.read_text())
    config["model"]["args"]["flash_attn"] = True
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    FM_CONFIG.write_text(json.dumps(config, indent=4) + "\n")


def transformer_generate_path(torch, card: str, path: TransformerPath) -> dict:
    """generate on the path's config at DIT_BATCH: DDIM_STEPS evaluations, every count of
    PATH_COUNTERS set to 0 just before and read just after; only the path's forward
    kernel runs, DIT_DEPTH times an evaluation. Returns the counts read."""
    import numpy as np

    from lightning_generative_models_tpu_torch import generate

    out_dir = OUT_DIR / path.out
    argv = ["--config_path", str(path.config), "--num_samples", str(DIT_BATCH),
            "--device", "cuda", "--seed", "0", "--out", str(out_dir)]
    generate.main(argv + ["--sampling_steps", "2"])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    images = generate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = dict.fromkeys(PATH_COUNTERS, 0) | {path.fwd: DIT_DEPTH * DDIM_STEPS}
    print(f"  wall {wall:.3f} s, {DIT_BATCH / wall:.2f} samples/s (model build, init and PNG "
          f"included) on {card}")
    print(f"  launches {counts} (expected {path.fwd}: {DIT_DEPTH} blocks x {DDIM_STEPS} "
          f"evaluations = {want[path.fwd]}, every other 0)", flush=True)
    if images.shape != (DIT_BATCH, 32, 32, 3):
        fail(f"{path.name} samples have shape {images.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
        fail(f"{path.name} samples are not finite values in [0, 1]")
    if counts != want:
        fail(f"the {path.name} sampling path launched the kernels {counts}")
    if not (out_dir / "grid.png").exists():
        fail(f"generate wrote no {path.name} grid.png")
    return counts


def transformer_train_path(torch, card: str, path: TransformerPath) -> dict:
    """The train entry point on the path's config (bs128, bf16): path.steps steps,
    validation (the loss over the validation batches, a sample grid of 64 and, for a
    conditional model, the per-class grid), then a --resume of path.resume_steps more.
    Launches held to DIT_DEPTH x steps backward and DIT_DEPTH x (steps + validation
    batches) + DIT_DEPTH x DDIM_STEPS x grids forward, every other count of PATH_COUNTERS
    0. Returns each run's counts."""
    import math

    from lightning_generative_models_tpu_torch import train
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run_dir = EXPERIMENT_DIR / path.model / path.run
    shutil.rmtree(run_dir, ignore_errors=True)
    val_batches = len(list(DataModule(**load_config(path.config)["dataset"]).val_batches()))
    argv = ["--config_path", str(path.config), "--device", "cuda", "--experiment_name",
            path.run, "--check_val_every_n_epoch", "1000", "--sample_every_n_steps", "0"]
    counts = {}
    for name, steps, extra in (("train", path.steps, []),
                               ("resume", path.steps + path.resume_steps, ["--resume"])):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        model = train.main(argv + ["--max_steps", str(steps)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        new_steps = steps - (0 if name == "train" else path.steps)
        want = dict.fromkeys(PATH_COUNTERS, 0) | {
            path.fwd: DIT_DEPTH * (new_steps + val_batches) + DIT_DEPTH * DDIM_STEPS * path.grids,
            path.bwd: DIT_DEPTH * new_steps}
        counts[name] = got
        print(f"  {name}: {new_steps} steps to step {model.step} in {wall:.1f} s (model "
              f"build, data, validation, the grids and checkpoints included) on {card}")
        print(f"  {name}: launches {got} (expected {path.fwd}: {DIT_DEPTH} x ({new_steps} "
              f"steps + {val_batches} validation batches) + {DIT_DEPTH * DDIM_STEPS} x "
              f"{path.grids} grids = {want[path.fwd]}; {path.bwd}: {want[path.bwd]}; every "
              f"other 0)", flush=True)
        if got != want:
            fail(f"the {path.name} {name} run launched the kernels {got}")
        if model.step != steps:
            fail(f"the {path.name} {name} run ended at step {model.step}, not {steps}")

    records = read_metrics(run_dir)
    train_records = [r for r in records if "train_loss" in r]
    losses = [r["train_loss"] for r in train_records]
    print(f"  {path.name} train_loss by logged step: " + ", ".join(
        f"{r['step']}: {r['train_loss']:.4f}" for r in train_records))
    if not all(math.isfinite(v) for v in losses):
        fail(f"a {path.name} train loss is not finite")
    if not losses[-1] < losses[0]:
        fail(f"the {path.name} train loss did not fall: {losses[0]} -> {losses[-1]}")
    if train_records[-1]["step"] != path.steps + path.resume_steps - 1:
        fail(f"the resumed {path.name} run did not log its last step")
    val = [r["val_loss"] for r in records if "val_loss" in r]
    if len(val) != 2 or not all(math.isfinite(v) for v in val):
        fail(f"expected one finite {path.name} val_loss per run, got {val}")
    samples = sorted((run_dir / "samples").glob("*.png"))
    per_class = [p for p in samples if p.name.startswith("per_class_generation")]
    if len(samples) != 2 * path.grids or len(per_class) != 2 * (path.grids - 1):
        fail(f"expected {path.grids} grids per {path.name} run, found "
             f"{[p.name for p in samples]}")
    for which in ("last", "best"):
        if not (run_dir / "checkpoints" / f"checkpoint_meta_{which}.json").exists():
            fail(f"no {path.name} {which} checkpoint meta")
    print(f"  {path.name} val_loss (EMA weights) {val}; grids {[p.name for p in samples]}; "
          f"images/s logged at the last step {train_records[-1]['images_per_sec']:.1f}",
          flush=True)
    return counts


def transformer_breakdown(torch, card: str, path: TransformerPath, steps: int = 20,
                          repeats: int = 3) -> dict:
    """Train images/s at bs128, bf16, with the model built and warmed up (median of
    ``repeats`` timings of ``steps`` steps), one step under torch.profiler; then the
    path's sampler's samples/s at DIT_BATCH, and one batch under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model

    config = load_config(path.config)
    batch_size = config["dataset"]["batch_size"]
    model = load_model(config["model"], device="cuda")
    it = DataModule(**config["dataset"]).train_batches(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()} for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(n):
        for i in range(n):
            model.train_step(batches[i % len(batches)], gen)
        torch.cuda.synchronize()

    run(5)  # warm-up: cuBLAS handles, the allocator
    model.step = model.ema_update_after_step  # past the EMA's hard copy, as in a long run
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(steps)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    ips = steps * batch_size / wall
    print(f"  {path.name} train bs{batch_size} bf16: {1e3 * wall / steps:.2f} ms per step, "
          f"median of {[round(w, 4) for w in walls]} s per {steps} steps, {ips:.1f} images/s "
          f"on {card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = profile_summary(torch, prof, wall_us, f"one {path.name} train step "
                              f"bs{batch_size}", f"{path.out}_train_profile.txt", card)
    out = {"images_per_s": ips, "ms_per_step": 1e3 * wall / steps, **summary}

    def sample():
        model.sample(gen, DIT_BATCH)
        torch.cuda.synchronize()

    sample()  # warm-up
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sample()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    out["samples_per_s"] = DIT_BATCH / wall
    print(f"  {path.name} {path.sampler} bs{DIT_BATCH} bf16: {wall:.4f} s median of "
          f"{[round(w, 4) for w in walls]}, {DIT_BATCH / wall:.2f} samples/s, "
          f"{1e3 * wall / DDIM_STEPS:.3f} ms per evaluation of {path.rows} rows on "
          f"{card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample()
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = profile_summary(torch, prof, wall_us, f"{path.name} {path.sampler} "
                              f"bs{DIT_BATCH}", f"{path.out}_sample_profile.txt", card)
    out.update({f"sample_{k}": v for k, v in summary.items()})
    return out

def gan_snapshot(torch, model) -> dict:
    """{"G/name" or "D/name": a CPU copy} of every weight and buffer, and of each weight's
    Adam first moment under "m:" (zeros before its first step)."""
    out = {}
    for net in ("G", "D"):
        module, opt = getattr(model, net), model.optimizers[net]
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            out[f"{net}/{name}"] = t.detach().float().cpu().clone()
        for name, p in module.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[f"m:{net}/{name}"] = (torch.zeros(p.shape) if m is None
                                      else m.detach().float().cpu().clone())
    return out


def check_dcgan_card_vs_cpu(torch, seed: int = 23) -> None:
    """The full-width DCGAN of DCGAN_CONFIG in f32 (TF32 off) at bs8, card against CPU:
    three train steps, the card's model loaded with the CPU model's state before each
    (weights, batch statistics, both Adams), on the same batch, flips and z, the card's step
    on the CPU step's fake batch and ReLU/LeakyReLU branches (``taped_step``: an activation
    within f32 noise of 0 that falls the other way on the card sends a gradient down the
    other slope, where the check is of the arithmetic). Within DCGAN_TOL: every metric (of
    1 + |ref|), each of D's gradients (of its norm: the D phase runs before any update), and
    each weight's gradient norm and update norm; every BatchNorm buffer, and the card's fake
    batch against the CPU's that it replays, within DCGAN_BN_TOL of 1 + |ref|. G's gradients
    are compared by their norms: G's loss passes through D as the D phase left it, and Adam
    moves each D weight by about +-lr whatever its gradient's size, so the few whose
    gradient is f32 noise move by +-lr at random on each device, and G's gradient carries
    that (5e-4 of its norm at step 0 here, 1e-2 in some states); an update's norm is the
    same for either sign. Then eval_step and sample from one state. The state is
    deep-copied: a loaded optimizer keeps the CPU's Adam step counts as they are, the same
    tensors. ``seed`` draws the batch, flips and z (``scripts/gan_parity_seeds.py`` runs
    the check over many)."""
    import copy

    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.registry import load_model

    config = load_config(DCGAN_CONFIG)["model"]
    config["args"]["use_bf16"] = False
    models = {dev: load_model(config, device=dev) for dev in ("cpu", "cuda")}
    b1 = models["cpu"].betas[0]
    rs = np.random.RandomState(seed)
    batch = {"image": rs.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)}

    def rel(out, ref):
        return ((out - ref).abs() / (1 + ref.abs())).max().item()

    def rel_norm(out, ref):
        return ((out - ref).norm() / ref.norm()).item()

    for step in range(3):
        models["cuda"].load_state_dict(copy.deepcopy(models["cpu"].state_dict()))
        flip = torch.tensor(rs.rand(8) < 0.5)
        z = torch.tensor(rs.randn(8, config["args"]["latent_dim"]).astype(np.float32))
        before = {dev: gan_snapshot(torch, m) for dev, m in models.items()}
        tape = {}
        metrics = {dev: taped_step(torch, m, batch, {"flip": flip, "z": z}, tape,
                                   replay=dev != "cpu") for dev, m in models.items()}
        after = {dev: gan_snapshot(torch, m) for dev, m in models.items()}
        metric_err = max(rel(metrics["cuda"][k].float().cpu(), metrics["cpu"][k].float())
                         for k in metrics["cpu"])
        bn_err, worst = 0.0, (0.0, "")
        for key, ref in after["cpu"].items():
            if key.startswith("m:"):
                continue
            if key.endswith((".mean", ".var")):
                bn_err = max(bn_err, rel(after["cuda"][key], ref))
                continue
            g = {dev: (after[dev]["m:" + key] - b1 * before[dev]["m:" + key]) / (1 - b1)
                 for dev in models}
            d = {dev: after[dev][key] - before[dev][key] for dev in models}
            errs = {"gradient norm": rel_norm(g["cuda"].norm(), g["cpu"].norm()),
                    "update norm": rel_norm(d["cuda"].norm(), d["cpu"].norm())}
            if key.startswith("D/"):
                errs["gradient"] = rel_norm(g["cuda"], g["cpu"])
            for what, err in errs.items():
                if not err <= worst[0]:  # NaN (no gradient on the CPU) counts as the worst
                    worst = (err, f"{key} {what}")
        ok = (metric_err <= DCGAN_TOL and max(bn_err, tape["fake_err"]) <= DCGAN_BN_TOL
              and worst[0] <= DCGAN_TOL)
        print(f"  DCGAN f32 train step {step} bs8, card vs CPU: metrics {metric_err:.2e}, "
              f"BatchNorm buffers {bn_err:.2e}, replayed fakes {tape['fake_err']:.2e} (of "
              f"1 + |ref|); worst {worst[1]} {worst[0]:.2e} "
              f"(tol {DCGAN_TOL:.0e} / {DCGAN_BN_TOL:.0e}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"DCGAN train step {step}: card and CPU disagree")

    models["cuda"].load_state_dict(copy.deepcopy(models["cpu"].state_dict()))
    z = torch.tensor(rs.randn(8, config["args"]["latent_dim"]).astype(np.float32))
    evals = {dev: m.eval_step(batch, z=z) for dev, m in models.items()}
    err = max(rel(evals["cuda"][k].float().cpu(), evals["cpu"][k].float()) for k in evals["cpu"])
    images = {dev: m.sample(None, 8, z=z).float().cpu() for dev, m in models.items()}
    img_err = (images["cuda"] - images["cpu"]).abs().max().item()
    ok = err <= DCGAN_TOL and img_err <= DCGAN_BN_TOL
    print(f"  DCGAN f32 eval_step: metrics {err:.2e} of 1 + |ref|; sample bs8: max_abs_err "
          f"{img_err:.2e} (tol {DCGAN_BN_TOL:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("DCGAN eval_step or sample: card and CPU disagree")


def dcgan_train_path(torch, card: str) -> dict:
    """The train entry point on DCGAN_CONFIG (bs128, bf16): DCGAN_STEPS steps with a
    validation and a sample grid at the end, then a --resume of DCGAN_RESUME_STEPS; then
    generate 64 samples to a PNG. Every count of PATH_COUNTERS is set to 0 just before each
    run and must read 0 just after: DCGAN runs no TPU kernel. The losses and val_g_loss
    finite, the checkpoints there, the samples finite in [0, 1]. Returns each run's
    counts."""
    import math

    import numpy as np

    from lightning_generative_models_tpu_torch import generate, train
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run_dir = EXPERIMENT_DIR / "DCGAN" / DCGAN_RUN
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--config_path", str(DCGAN_CONFIG), "--device", "cuda", "--experiment_name",
            DCGAN_RUN, "--check_val_every_n_epoch", "1000", "--sample_every_n_steps", "0"]
    total = DCGAN_STEPS + DCGAN_RESUME_STEPS
    counts = {}
    for name, steps, extra in (("train", DCGAN_STEPS, []), ("resume", total, ["--resume"])):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        model = train.main(argv + ["--max_steps", str(steps)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = read_counts()
        print(f"  {name}: to step {model.step} in {wall:.1f} s (model build, data, validation, "
              f"the grid and checkpoints included) on {card}; launches {counts[name]} "
              f"(expected all 0)", flush=True)
        if any(counts[name].values()):
            fail(f"the DCGAN {name} run launched a kernel: {counts[name]}")
        if model.step != steps:
            fail(f"the DCGAN {name} run ended at step {model.step}, not {steps}")

    records = read_metrics(run_dir)
    train_records = [r for r in records if "train_g_loss" in r]
    losses = [r[k] for r in train_records for k in ("train_d_loss", "train_g_loss")]
    val = [r["val_g_loss"] for r in records if "val_g_loss" in r]
    print("  DCGAN train_d_loss / train_g_loss by logged step: " + ", ".join(
        f"{r['step']}: {r['train_d_loss']:.4f} / {r['train_g_loss']:.4f}"
        for r in train_records) + f"; val_g_loss {val}; images/s logged at the last step "
        f"{train_records[-1]['images_per_sec']:.1f}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("a DCGAN train loss is not finite")
    if train_records[-1]["step"] != total - 1:
        fail("the resumed DCGAN run did not log its last step")
    if len(val) != 2 or not all(math.isfinite(v) for v in val):
        fail(f"expected one finite DCGAN val_g_loss per run, got {val}")
    grids = sorted((run_dir / "samples").glob("random_generation_*.png"))
    if len(grids) != 2:
        fail(f"expected a DCGAN sample grid per run, found {[p.name for p in grids]}")
    meta = json.loads((run_dir / "checkpoints" / "checkpoint_meta_last.json").read_text())
    if meta["step"] != total or meta["monitor"] != "val_g_loss" or \
            not (run_dir / "checkpoints" / "checkpoint_meta_best.json").exists():
        fail(f"the DCGAN checkpoints are not there as expected: last {meta}")

    out_dir = OUT_DIR / "dcgan"
    gen_argv = ["--config_path", str(DCGAN_CONFIG), "--num_samples", "64", "--device", "cuda",
                "--seed", "0", "--out", str(out_dir)]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    images = generate.main(gen_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["generate"] = read_counts()
    print(f"  generate 64 samples: {wall:.3f} s (model build, init and PNG included); "
          f"launches {counts['generate']} (expected all 0)", flush=True)
    if any(counts["generate"].values()):
        fail(f"DCGAN generate launched a kernel: {counts['generate']}")
    if images.shape != (64, 32, 32, 3):
        fail(f"DCGAN samples have shape {images.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
        fail("DCGAN samples are not finite values in [0, 1]")
    if not (out_dir / "grid.png").exists():
        fail("generate wrote no DCGAN grid.png")
    return counts


def dcgan_breakdown(torch, card: str, steps: int = 20, repeats: int = 3) -> dict:
    """DCGAN train images/s at bs128, bf16, with the model built and warmed up (median of
    ``repeats`` timings of ``steps`` steps), then five steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model

    config = load_config(DCGAN_CONFIG)
    batch_size = config["dataset"]["batch_size"]
    model = load_model(config["model"], device="cuda")
    it = DataModule(**config["dataset"]).train_batches(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()} for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(n):
        for i in range(n):
            model.train_step(batches[i % len(batches)], gen)
        torch.cuda.synchronize()

    run(5)  # warm-up: cuDNN plans, the allocator
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(steps)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    ips = steps * batch_size / wall
    print(f"  DCGAN train bs{batch_size} bf16: {1e3 * wall / steps:.3f} ms per step, median of "
          f"{[round(w, 4) for w in walls]} s per {steps} steps, {ips:.1f} images/s on {card}",
          flush=True)
    profiled = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(profiled)
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = profile_summary(torch, prof, wall_us, f"{profiled} DCGAN train steps "
                              f"bs{batch_size}", "dcgan_train_profile.txt", card)
    out = {"images_per_s": ips, "ms_per_step": 1e3 * wall / steps}
    if summary:
        out.update({"launches_per_step": summary["launches"] / profiled,
                    "busy_ms_per_step": summary["busy_us"] / profiled / 1e3,
                    "busy_share": summary["busy_us"] / summary["wall_us"]})
        print(f"  per step: {out['launches_per_step']:.0f} kernel launches, "
              f"{out['busy_ms_per_step']:.2f} ms device busy, "
              f"{100 * out['busy_share']:.1f}% of the profiled wall", flush=True)
    return out


# -- The GAN family: [26]-[28] ---------------------------------------------------------

def gan_draws(torch, model, n: int, gen) -> dict:
    """One train step's explicit draws for ``model`` (the CPU one), from the CPU
    generator ``gen``: the flips, z (InfoGAN: its codes), WGAN's alpha, ACGAN's gen_labels
    and CGAN's three dropout keep-masks."""
    name = type(model).__name__
    if name == "CycleGAN":
        return {"flip_a": torch.rand(n, generator=gen) < 0.5,
                "flip_b": torch.rand(n, generator=gen) < 0.5}
    draws = {"flip": torch.rand(n, generator=gen) < 0.5}
    if name == "InfoGAN":
        draws["codes"] = model.generate_codes(gen, n)
        return draws
    draws["z"] = model.sample_z(gen, n)
    if name == "WGAN":
        draws["alpha"] = torch.rand(n, 1, 1, 1, generator=gen)
    if name == "ACGAN":
        draws["gen_labels"] = model.sample_labels(gen, n)
    if name == "CGAN":
        draws["keep"] = model.dropout_masks(gen, n)
    return draws


def gan_batch(model, n: int, rs) -> dict:
    """A uint8 batch at the model's size with labels (CycleGAN: image_A and image_B)."""
    shape = (n, model.img_size, model.img_size, model.img_channels)
    if type(model).__name__ == "CycleGAN":
        return {k: rs.randint(0, 256, shape).astype("uint8") for k in ("image_A", "image_B")}
    return {"image": rs.randint(0, 256, shape).astype("uint8"), "label": rs.randint(0, 10, n)}


def no_bf16(cfg: dict) -> dict:
    """``cfg`` (a model section) with use_bf16 off where the model takes it."""
    import inspect

    from lightning_generative_models_tpu_torch.registry import resolve_model_class

    if "use_bf16" in inspect.signature(resolve_model_class(cfg["name"]).__init__).parameters:
        cfg["args"]["use_bf16"] = False
    return cfg


def f32_generator(torch, model) -> None:
    """Run the generator that ACGAN, SGAN and InfoGAN build with DCGAN's bf16
    ConvGenerator in f32 (every layer reads its ``dtype`` at call time)."""
    for m in model.G.modules() if hasattr(model, "G") else ():
        if hasattr(m, "dtype"):
            m.dtype = torch.float32


def capture_grads(model) -> dict:
    """{optimizer name: its gradients at its last step, on the CPU}, filled as the model's
    optimizers step (each ``step`` wrapped on the instance)."""
    grads = {}
    for name, opt in model.optimizers.items():
        def step(*args, _name=name, _opt=opt, _step=opt.step, **kwargs):
            grads[_name] = [p.grad.detach().float().cpu().clone()
                            for p in _opt.param_groups[0]["params"]]
            return _step(*args, **kwargs)
        opt.step = step
    return grads


def taped_step(torch, model, batch: dict, draws: dict, tape: dict, replay: bool) -> dict:
    """One train step that records (``replay`` False) or replays (True) into ``tape``
    the value of every generator call, the branch every ReLU and LeakyReLU input takes
    (> 0 or not) and the sign of every ``torch.abs`` input (BEGAN's and CycleGAN's L1
    losses), in call order. The card's step replays the CPU's: a fake batch that the two
    compute apart by f32 noise, or an activation or L1 residual within that noise of 0,
    would otherwise send D's or G's gradient down another slope (a G gradient moved by
    1.9e-3 in R1GAN's step, a BEGAN decoder bias's by 3.7e-3) where the check is of the
    arithmetic. The values are the CPU's, the gradients the card's own; ``tape["fake_err"]``
    keeps the largest max |CPU's - card's| / (1 + |card's|) over the replayed generator
    calls made before the step's first optimizer update. A call after it (InfoGAN's Q phase) runs on weights that Adam moved
    apart on the two devices where f32 noise dominates a gradient element, so its output is
    held instead to the CPU's forward of a copy of the card's generator on the same inputs
    and branches: ``tape["updated_fake_err"]`` keeps the largest such distance."""
    import copy

    F = torch.nn.functional
    relu, leaky_relu, abs_ = F.relu, F.leaky_relu, torch.abs
    outs, masks = tape.setdefault("outputs", []), tape.setdefault("masks", [])
    used = {"outputs": 0, "masks": 0}
    updated, starts = [], []
    steps = {name: opt.step for name, opt in model.optimizers.items()}

    def noted(step):
        def wrapped(*args, **kwargs):
            updated.append(True)
            return step(*args, **kwargs)
        return wrapped

    def branch(x, low):
        if replay:
            mask = masks[used["masks"]].to(x.device)
            used["masks"] += 1
            return torch.where(mask, x, low)
        masks.append((x > 0).detach().cpu())
        return None

    def taped_relu(x, inplace=False):
        out = branch(x, torch.zeros_like(x))
        return relu(x) if out is None else out

    def taped_leaky_relu(x, negative_slope=0.01, inplace=False):
        out = branch(x, x * negative_slope)
        return leaky_relu(x, negative_slope) if out is None else out

    def taped_abs(x):
        if replay:
            sign = masks[used["masks"]].to(x.device, x.dtype)
            used["masks"] += 1
            return x * sign
        masks.append(torch.sign(x).detach().cpu())
        return abs_(x)

    def pre_hook(module, args):
        starts.append(used["masks"])

    def cpu_forward(module, args):
        """The CPU's forward of a copy of the card's ``module``, on the branches and signs
        that the card's call took."""
        end, used["masks"] = used["masks"], starts[-1]
        clone = copy.deepcopy(module).cpu()
        clone._forward_hooks.clear()
        clone._forward_pre_hooks.clear()
        with torch.no_grad():
            same = clone(*[a.detach().cpu() if torch.is_tensor(a) else a for a in args])
        if used["masks"] != end:
            fail(f"the CPU's copy of a generator took {used['masks'] - starts[-1]} masks, "
                 f"the card's call {end - starts[-1]}")
        return same

    def hook(module, args, out):
        if not replay:
            outs.append(out.detach().cpu())
            return None
        ref = outs[used["outputs"]].to(out.device, out.dtype)
        used["outputs"] += 1
        same = cpu_forward(module, args).to(out.device, out.dtype) if updated else ref
        err = ((same - out).abs() / (1 + out.abs())).max().item()
        key = "updated_fake_err" if updated else "fake_err"
        tape[key] = max(tape.get(key, 0.0), err)
        return out + (ref - out).detach()

    gens = [model.G] if hasattr(model, "G") else [model.G_AB, model.G_BA]
    handles = [g.register_forward_hook(hook) for g in gens]
    if replay:
        handles += [g.register_forward_pre_hook(pre_hook) for g in gens]
    F.relu, F.leaky_relu, torch.abs = taped_relu, taped_leaky_relu, taped_abs
    for name, opt in model.optimizers.items():
        opt.step = noted(steps[name])
    try:
        metrics = model.train_step(batch, **draws)
    finally:
        F.relu, F.leaky_relu, torch.abs = relu, leaky_relu, abs_
        for name, opt in model.optimizers.items():
            opt.step = steps[name]
        for h in handles:
            h.remove()
    if replay and (used["outputs"], used["masks"]) != (len(outs), len(masks)):
        fail(f"the card's step replayed {used} of {len(outs)} outputs and {len(masks)} masks")
    return metrics


def gan_state(torch, model) -> dict:
    """{"net/name": a CPU copy} of every weight and buffer of the model's nets."""
    return {f"{k}/{n}": t.detach().float().cpu().clone() for k, net in model.nets().items()
            for n, t in list(net.named_parameters()) + list(net.named_buffers())}


def check_gan_family_card_vs_cpu(torch, seed: int = 26) -> None:
    """Every GAN-family config of GAN_FAMILY at its own widths, f32 (TF32 off), batch 8
    (CycleGAN 2), card against CPU: three train steps (WGAN n_critic + 1, a G step among
    them), the card's model loaded with the CPU model's state before each, on the same
    batch and draws, the card's step on the CPU step's fakes and branches
    (``taped_step``). Within GAN_TOL: every metric (of 1 + |ref|; the penalties and k_t among
    them), each weight's gradient norm (from what each optimizer stepped with, "Q" too) and
    update norm, leaving out the weights whose CPU gradient is f32 noise (a norm below 1e-5
    of the optimizer's largest: a bias that a norm cancels) and, from the update norms, the
    elements whose two gradients differ by more than GAN_TOL of the CPU's: f32 noise
    dominates them (WGAN's last BatchNorm bias, whose gradient is exactly 0 where the real
    and fake batches take the same LeakyReLU branches; CGAN's one-element output bias,
    whose gradient sums 8 x 28 x 28 terms), and Adam moves them by as much as a weight with
    a real gradient; at most GAN_NOISE_SHARE of the stepped elements, and their share is
    printed); within GAN_BN_TOL of 1 + |ref|: every BatchNorm buffer, and the card's
    generator outputs against the CPU's that its step replays (those on weights the step
    has updated against the CPU's forward of the card's weights: ``taped_step``). Then
    eval_step on the same draws and sample (CycleGAN: translate both ways) within GAN_TOL
    and GAN_BN_TOL. ``seed`` draws the batches and draws (``scripts/gan_parity_seeds.py``
    runs the check over many)."""
    import copy

    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.registry import load_model

    def rel(out, ref):
        return ((out - ref).abs() / (1 + ref.abs())).max().item()

    def rel_norm(out, ref):
        return abs(out - ref) / ref if ref > 0 else float(out != ref)

    for path in GAN_FAMILY:
        cfg = no_bf16(load_config(path)["model"])
        models = {d: load_model(cfg, device=d) for d in ("cpu", "cuda")}
        for m in models.values():
            f32_generator(torch, m)
        cpu = models["cpu"]
        name = type(cpu).__name__
        n = 2 if name == "CycleGAN" else 8
        steps = cpu.n_critic + 1 if name == "WGAN" else 3
        rs = np.random.RandomState(seed)
        gen = torch.Generator().manual_seed(seed)
        batch = gan_batch(cpu, n, rs)
        names = {id(p): f"{k}/{pn}" for k, net in cpu.nets().items()
                 for pn, p in net.named_parameters()}
        worst = {"metrics": 0.0, "buffers": 0.0, "fakes": 0.0, "updated_fakes": 0.0,
                 "norms": (0.0, "")}
        left_out = [0, 0]  # elements left out of the update norms as noise, of all stepped
        t0 = time.perf_counter()
        grads = {d: capture_grads(m) for d, m in models.items()}
        for _ in range(steps):
            models["cuda"].load_state_dict(copy.deepcopy(cpu.state_dict()))
            draws = gan_draws(torch, cpu, n, gen)
            for g in grads.values():
                g.clear()
            before = {d: gan_state(torch, m) for d, m in models.items()}
            tape = {}
            metrics = {d: taped_step(torch, m, batch, draws, tape, replay=d != "cpu")
                       for d, m in models.items()}
            after = {d: gan_state(torch, m) for d, m in models.items()}
            worst["fakes"] = max(worst["fakes"], tape["fake_err"])
            worst["updated_fakes"] = max(worst["updated_fakes"],
                                         tape.get("updated_fake_err", 0.0))
            worst["metrics"] = max(worst["metrics"], max(
                rel(metrics["cuda"][k].float().cpu(), metrics["cpu"][k].float())
                for k in metrics["cpu"]))
            noise, signal = set(), {}
            for opt_name, ref in grads["cpu"].items():
                params = cpu.optimizers[opt_name].param_groups[0]["params"]
                top = max(float(g.norm()) for g in ref)
                for p, g_ref, g_out in zip(params, ref, grads["cuda"][opt_name]):
                    kept = (g_out - g_ref).abs() <= GAN_TOL * g_ref.abs()
                    key = names[id(p)]
                    signal[key] = signal[key] & kept if key in signal else kept
                    if float(g_ref.norm()) < 1e-5 * top:
                        noise.add(key)
                        continue
                    err = rel_norm(float(g_out.norm()), float(g_ref.norm()))
                    if not err <= worst["norms"][0]:
                        worst["norms"] = (err, f"{key} gradient ({opt_name})")
            for key, ref in after["cpu"].items():
                if key.endswith((".mean", ".var")):
                    worst["buffers"] = max(worst["buffers"], rel(after["cuda"][key], ref))
                elif key not in noise and key in names.values():
                    kept = signal.get(key, torch.ones(ref.shape, dtype=torch.bool))
                    if key in signal:
                        left_out[0] += int((~kept).sum())
                        left_out[1] += kept.numel()
                    d_ref = float((ref - before["cpu"][key])[kept].norm())
                    err = rel_norm(float((after["cuda"][key]
                                          - before["cuda"][key])[kept].norm()), d_ref)
                    if not err <= worst["norms"][0]:
                        worst["norms"] = (err, f"{key} update")
        models["cuda"].load_state_dict(copy.deepcopy(cpu.state_dict()))
        draws = gan_draws(torch, cpu, n, gen)
        if name == "CycleGAN":
            evals = {d: m.eval_step(batch) for d, m in models.items()}
            images = torch.rand(n, cpu.img_size, cpu.img_size, cpu.img_channels, generator=gen)
            outs = {d: torch.cat([m.translate(images, "AB"), m.translate(images, "BA")])
                    for d, m in models.items()}
        else:
            code = {"codes": draws["codes"]} if name == "InfoGAN" else {"z": draws["z"]}
            evals = {d: m.eval_step(batch, **code) for d, m in models.items()}
            outs = {d: m.sample(None, n, **code) for d, m in models.items()}
        eval_err = max(rel(evals["cuda"][k].float().cpu(), evals["cpu"][k].float())
                       for k in evals["cpu"])
        img_err = (outs["cuda"].float().cpu() - outs["cpu"].float()).abs().max().item()
        ok = (max(worst["metrics"], worst["norms"][0], eval_err) <= GAN_TOL
              and max(worst["buffers"], worst["fakes"], worst["updated_fakes"], img_err)
              <= GAN_BN_TOL and left_out[0] <= GAN_NOISE_SHARE * left_out[1])
        print(f"  {path.name} ({name}) f32 {steps} steps bs{n}, card vs CPU: metrics "
              f"{worst['metrics']:.2e}, BatchNorm buffers {worst['buffers']:.2e}, replayed "
              f"fakes {worst['fakes']:.2e} (on updated weights, against the CPU on the "
              f"card's weights {worst['updated_fakes']:.2e}); worst "
              f"{worst['norms'][1]} norm {worst['norms'][0]:.2e} ({left_out[0]} of "
              f"{left_out[1]} stepped elements left out as noise); eval {eval_err:.2e}, "
              f"{'translate' if name == 'CycleGAN' else 'sample'} max_abs_err {img_err:.2e} "
              f"(tol {GAN_TOL:.0e} / {GAN_BN_TOL:.0e}) in {time.perf_counter() - t0:.1f} s "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{path.name}: card and CPU disagree")


def derive_gan_configs() -> list:
    """Each GAN_FAMILY config as chiprun_out/chip_smoke/gan/<name>.json, its model section
    as it is and its synthetic data cut to GAN_SYNTHETIC images (CelebA's 5,120 synthetic
    178-px images take 12 s to stage)."""
    out = []
    (OUT_DIR / "gan").mkdir(parents=True, exist_ok=True)
    for path in GAN_FAMILY:
        config = json.loads(path.read_text())
        config["dataset"]["synthetic_size"] = GAN_SYNTHETIC
        derived = OUT_DIR / "gan" / path.name
        derived.write_text(json.dumps(config, indent=2))
        out.append(derived)
    return out


def gan_family_entry_points(torch, card: str) -> tuple:
    """For every derived GAN-family config: the train entry point for GAN_STEPS steps with
    a validation at the end, a --resume of GAN_RESUME_STEPS, then generate 64 samples (CGAN
    and ACGAN: also --label 3; CycleGAN: generate raises NotImplementedError, as JAX's
    generate.py does, and the model translates a validation batch both ways from the last
    checkpoint). Every count of PATH_COUNTERS is set to 0 before each config's runs and
    must read 0 after them; the losses and val_g_loss finite; CGAN's and ACGAN's per-class
    grids written at each validation; the images finite in [0, 1]. Returns the walls and
    each counter's reads summed over the configs."""
    import math

    import numpy as np

    from lightning_generative_models_tpu_torch import generate, train
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import PairedDataModule
    from lightning_generative_models_tpu_torch.registry import load_model
    from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
    from lightning_generative_models_tpu_torch.utils.grid import make_grid
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR
    from lightning_generative_models_tpu_torch.experiment.logger import _write_png

    walls, launches = {}, dict.fromkeys(PATH_COUNTERS, 0)
    for path in derive_gan_configs():
        config = load_config(path)
        name = config["model"]["name"]
        run = f"chip_smoke_{path.stem}"
        run_dir = EXPERIMENT_DIR / name / run
        shutil.rmtree(run_dir, ignore_errors=True)
        argv = ["--config_path", str(path), "--device", "cuda", "--experiment_name", run,
                "--check_val_every_n_epoch", "1000", "--sample_every_n_steps", "0"]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        total = GAN_STEPS + GAN_RESUME_STEPS
        for n, extra in ((GAN_STEPS, []), (total, ["--resume"])):
            model = train.main(argv + ["--max_steps", str(n)] + extra)
            if model.step != n:
                fail(f"{path.name}: the run ended at step {model.step}, not {n}")
        records = read_metrics(run_dir)
        losses = [v for r in records for k, v in r.items()
                  if k.startswith(("train_", "val_")) and k.endswith("loss")]
        val = [r["val_g_loss"] for r in records if "val_g_loss" in r]
        if not losses or not all(math.isfinite(v) for v in losses):
            fail(f"{path.name}: a logged loss is not finite")
        if len(val) != 2 or not all(math.isfinite(v) for v in val):
            fail(f"{path.name}: expected one finite val_g_loss per run, got {val}")
        grids = sorted(p.name for p in (run_dir / "samples").glob("*.png")) \
            if (run_dir / "samples").exists() else []
        if name in ("CGAN", "ACGAN") and \
                sum(g.startswith("per_class_generation") for g in grids) != 2:
            fail(f"{path.name}: expected a per-class grid per validation, found {grids}")
        out_dir = OUT_DIR / "gan" / path.stem
        gen_argv = ["--config_path", str(path), "--num_samples", "64", "--device", "cuda",
                    "--seed", "0", "--out", str(out_dir)]
        if name == "CycleGAN":
            try:
                generate.main(gen_argv)
            except NotImplementedError:
                pass
            else:
                fail("CycleGAN generate did not raise NotImplementedError")
            model = load_model(config["model"], device="cuda")
            CheckpointManager(run_dir / "checkpoints").restore(model)
            data = PairedDataModule(**config["dataset"])
            val_batch = next(data.val_batches())
            images01 = {k: torch.as_tensor(v).float() / 255.0 for k, v in val_batch.items()}
            images = torch.cat([model.translate(images01["image_A"], "AB"),
                                model.translate(images01["image_B"], "BA")]).float().cpu().numpy()
            out_dir.mkdir(parents=True, exist_ok=True)
            _write_png(out_dir / "translate.png", make_grid(images))
        else:
            images = generate.main(gen_argv)
            if name in ("CGAN", "ACGAN"):
                labelled = generate.main(gen_argv + ["--label", "3"])
                images = np.concatenate([images, labelled])
        torch.cuda.synchronize()
        walls[path.stem] = time.perf_counter() - t0
        counts = read_counts()
        for k, v in counts.items():
            launches[k] += v
        print(f"  {path.name} ({name}): train {GAN_STEPS} + resume to {total} steps, "
              f"{'translate' if name == 'CycleGAN' else 'generate'} {len(images)} images in "
              f"{walls[path.stem]:.1f} s on {card}; val_g_loss {[round(v, 4) for v in val]}; "
              f"grids {len(grids)}; kernel launches {sum(counts.values())} (expected 0)",
              flush=True)
        if any(counts.values()):
            fail(f"{path.name}: the GAN-family path launched a kernel: {counts}")
        if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
            fail(f"{path.name}: images are not finite values in [0, 1]")
    return walls, launches


def wgan_breakdown(torch, card: str, cycles: int = 4, repeats: int = 3) -> dict:
    """WGAN-GP on CIFAR-10 (WGAN_CONFIG: bs64, f32, n_critic 5, the DCGAN nets at 32 px):
    images/s over whole critic cycles (n_critic D steps and one G step; median of
    ``repeats`` timings of ``cycles`` cycles after one cycle of warm-up), the D and G steps
    timed apart (host clock to a synchronize, median over the steps of one timing), then
    one cycle under torch.profiler (busy share, top kernels), a D step and a G step under
    it alone (launches and device time each), and a D step with the penalty taken out
    (its share of the D step's device time)."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model

    config = load_config(WGAN_CONFIG)
    bs = config["dataset"]["batch_size"]
    model = load_model(config["model"], device="cuda")
    period = model.n_critic + 1
    it = DataModule(**config["dataset"]).train_batches(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()} for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    step_walls = {"D": [], "G": []}

    def run(n_steps, per_step=False):
        for i in range(n_steps):
            kind = "D" if model.is_d_step() else "G"
            t0 = time.perf_counter()
            model.train_step(batches[i % len(batches)], gen)
            if per_step:
                torch.cuda.synchronize()
                step_walls[kind].append(time.perf_counter() - t0)
        torch.cuda.synchronize()

    run(period)  # warm-up: cuDNN plans, the allocator; the counter is at a cycle's start
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(cycles * period)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    ips = cycles * period * bs / wall
    run(cycles * period, per_step=True)
    d_ms, g_ms = (1e3 * statistics.median(step_walls[k]) for k in ("D", "G"))
    print(f"  WGAN-GP CIFAR-10 train bs{bs} f32: {1e3 * wall / cycles:.3f} ms per critic cycle "
          f"({model.n_critic} D + 1 G), median of {[round(w, 4) for w in walls]} s per "
          f"{cycles} cycles, {ips:.1f} images/s; a D step {d_ms:.3f} ms, a G step {g_ms:.3f} "
          f"ms (each synchronized, median of {len(step_walls['D'])} and "
          f"{len(step_walls['G'])}) on {card}", flush=True)
    out = {"images_per_s": ips, "ms_per_cycle": 1e3 * wall / cycles, "d_step_ms": d_ms,
           "g_step_ms": g_ms}

    def profiled(n_steps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(n_steps)
            wall_us = 1e6 * (time.perf_counter() - t0)
        return prof, wall_us

    prof, wall_us = profiled(period)
    summary = profile_summary(torch, prof, wall_us, f"one WGAN-GP critic cycle bs{bs}",
                              "wgan_gp_train_profile.txt", card)
    if summary:
        out["busy_share"] = summary["busy_us"] / summary["wall_us"]
        out["busy_ms_per_cycle"] = summary["busy_us"] / 1e3
    for kind in ("D", "G"):
        while model.is_d_step() != (kind == "D"):
            run(1)
        prof, wall_us = profiled(1)
        events = exclusive_kernel_us(torch, prof)
        out[f"{kind.lower()}_step_launches"] = sum(c for _, c in events.values())
        out[f"{kind.lower()}_step_busy_ms"] = sum(us for us, _ in events.values()) / 1e3
    while not model.is_d_step():
        run(1)
    model.gradient_penalty = lambda x, x_hat, alpha: torch.zeros((), device=x.device)
    try:
        prof, _ = profiled(1)
    finally:
        del model.gradient_penalty  # the class's method again
    events = exclusive_kernel_us(torch, prof)
    no_gp_ms = sum(us for us, _ in events.values()) / 1e3
    if not out["d_step_busy_ms"]:
        print("  profiler: no device time recorded; launches and shares not measured")
        return out
    out["penalty_share_of_d_step"] = 1 - no_gp_ms / out["d_step_busy_ms"]
    print(f"  a D step: {out['d_step_launches']} kernel launches, {out['d_step_busy_ms']:.3f} "
          f"ms device busy ({no_gp_ms:.3f} ms with the penalty taken out: the penalty's "
          f"forward and double backward are {100 * out['penalty_share_of_d_step']:.1f}% of "
          f"it); a G step: {out['g_step_launches']} launches, {out['g_step_busy_ms']:.3f} ms "
          f"device busy", flush=True)
    return out


# -- the continuous-time and latent diffusion slice, the VAE family ([29]-[34]) -----------

#: (b, n, c, dtype, residual, disparity) of kernels #1 and #2 on the slice's new paths: the
#: latent UNet's outer stage (n 16 = 4 x 4 latents, c 64) at the latent paths' bs64 and
#: bs128 in both types, the disparity input there, and the consistency model's doubled
#: batch at the full UNet's outer stage (b 256, n 1024, c 64).
LATENT_LA_CASES = (
    [(b, 16, 64, dt, res, False) for b in (64, 128) for dt in ("float32", "bfloat16")
     for res in (True, False)]
    + [(128, 16, 64, dt, True, True) for dt in ("float32", "bfloat16")]
    + [(256, 1024, 64, "bfloat16", True, False)])
LATENT_LA_BWD_CASES = (
    [(b, 16, 64, dt, res, False) for b in (64, 128) for dt in ("float32", "bfloat16")
     for res in (True, False)]
    + [(128, 16, 64, "float32", True, True), (256, 1024, 64, "bfloat16", True, False)])
LATENT_VQ_SHAPES = [(2048, 512, 64)]  # a latent model's decode of 128 images: 128 x 4 x 4
EDM_CONFIG = ROOT / "configs" / "diffusion" / "edm_cifar10.json"
CT_CONFIG = ROOT / "configs" / "diffusion" / "ct_cifar10.json"
LDM_CONFIGS = {name: ROOT / "configs" / "diffusion" / f"{name}_cifar10.json"
               for name in ("ldm", "ledm", "lfm")}
VAE_CONFIG = ROOT / "configs" / "vae" / "vae.json"
VQGAN_LPIPS_CONFIG = ROOT / "configs" / "vae" / "vqgan_lpips.json"
SLICE_TOL = 1e-3  # f32 card against CPU: metrics, gradients, update norms, chains
ADAM_EPS = 1e-8  # train/state.py's make_adam
EDM_STEPS, EDM_RESUME_STEPS = 24, 6
CT_STEPS, CT_RESUME_STEPS = 24, 6
LATENT_STEPS, LATENT_RESUME_STEPS = 12, 4
VAE_STEPS, VAE_RESUME_STEPS = 20, 5
LPIPS_STEPS, LPIPS_RESUME_STEPS = 8, 2
AE_RUN = "chip_smoke_vqvae"  # [10]'s VQ-VAE run: the latent models' frozen autoencoder


def check_latent_kernel_shapes(torch, la, vq) -> dict:
    """[29]: kernels #1 and #2 at the slice's new shapes against their plain versions with
    [2]'s tolerances (the disparity input's f32 gradients against the exact f64 ones),
    every call repeated bit for bit, times beside the bounds; #6 at a latent decode's
    rows."""
    with torch.inference_mode():
        fwd = check_linear_attention(torch, la, LATENT_LA_CASES, ("float32", "bfloat16"))
        bwd = check_linear_attention_bwd(torch, la, LATENT_LA_BWD_CASES,
                                         ("float32", "bfloat16"))
        vq_shapes = check_vq(torch, vq, LATENT_VQ_SHAPES, duplicates=False)["shapes"]
    return {"linear_attention": fwd, "linear_attention_bwd": bwd, "vq": vq_shapes}


def _rel(out, ref) -> float:
    out, ref = out.float().cpu(), ref.float().cpu()
    return ((out - ref).abs() / (1 + ref.abs())).max().item()


def _rel_norm(out: float, ref: float) -> float:
    return abs(out - ref) / ref if ref > 0 else float(out != ref)


def slice_step_card_vs_cpu(torch, name: str, models: dict, batch: dict, draws: dict,
                           elementwise: bool = True) -> None:
    """One grad_step + apply_grad_step on the CPU and on the card from the same weights,
    batch and draws: every metric within SLICE_TOL of 1 + |ref|; each gradient within
    SLICE_TOL of its largest magnitude (``elementwise``), or by its norm (LeakyReLU nets,
    whose inputs within f32 noise of 0 can take the other slope); each weight's update by
    its norm (Adam's first step moves a weight by about lr whatever its gradient's size)."""
    results = {}
    for dev, m in models.items():
        params = m.optimizer.param_groups[0]["params"]
        before = [p.detach().float().cpu().clone() for p in params]
        grads, metrics = m.grad_step(batch, **draws)
        grads = [g.float().cpu() for g in grads]
        metrics = m.apply_grad_step([g.to(m.device) for g in grads], metrics)
        updates = [p.detach().float().cpu() - b for p, b in zip(params, before)]
        results[dev] = (metrics, grads, updates)
    (m_ref, g_ref, u_ref), (m_out, g_out, u_out) = results["cpu"], results["cuda"]
    metric_err = max(_rel(m_out[k], m_ref[k]) for k in m_ref)
    if elementwise:
        grad_err = max(((k - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
                       for k, p in zip(g_out, g_ref))
    else:
        grad_err = max(_rel_norm(float(k.norm()), float(p.norm())) for k, p in zip(g_out, g_ref))
    upd_err = max(_rel_norm(float(k.norm()), float(p.norm())) for k, p in zip(u_out, u_ref))
    ok = max(metric_err, grad_err, upd_err) <= SLICE_TOL
    print(f"  {name} train step, card vs CPU: metrics {metric_err:.2e} ("
          + ", ".join(f"{k} {float(m_out[k]):.5f}" for k in sorted(m_ref))
          + f"), gradients {grad_err:.2e} ({'elementwise' if elementwise else 'norms'}, "
          f"{len(g_ref)} tensors), update norms {upd_err:.2e}; tol {SLICE_TOL:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: the card's train step disagrees with the CPU's")


def slice_chain_card_vs_cpu(torch, name: str, models: dict, run) -> None:
    """``run(model)`` (a short sampler chain on fixed draws) on the CPU and on the card:
    within SLICE_TOL x max(1, max |ref|)."""
    with torch.inference_mode():
        out = {dev: run(m).float().cpu() for dev, m in models.items()}
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    scale = max(1.0, out["cpu"].abs().max().item())
    ok = bool(torch.isfinite(out["cuda"]).all()) and err <= SLICE_TOL * scale
    print(f"  {name}: {tuple(out['cpu'].shape)} max_abs_err={err:.3e} (tol {SLICE_TOL:.0e} x "
          f"max(1, max|ref|) = {SLICE_TOL * scale:.1e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: card and CPU disagree")


def check_slice_card_vs_cpu(torch) -> None:
    """[30]: every model of the slice at its config's widths in f32 (TF32 off), the card
    against the CPU from the same weights: one train step on the same batch and draws and
    a short sampler chain on the same draws (EDM Heun-3, consistency multistep-2 with its
    re-noising, LDM DDIM-3, LEDM Heun-2, LFM Euler-3, decoded through the frozen
    autoencoder; the VAE's decoder on fixed latents); the VQGAN with LPIPS: a step past
    disc_start (metrics and update norms), eval_step and a decode of fixed codes."""
    import copy

    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.registry import load_model

    rs = np.random.RandomState(30)
    n = 4
    img_batch = {"image": rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
                 "label": np.zeros(n, np.int32)}
    flip = torch.tensor([True, False, False, True])

    def build(path, **overrides):
        cfg = load_config(path)["model"]
        cfg["args"] = {**cfg["args"], **overrides}
        if "autoencoder" in cfg["args"]:
            cfg["args"]["autoencoder"] = {**cfg["args"]["autoencoder"],
                                          "config_path": str(VQVAE_CONFIG)}
        return {dev: load_model(cfg, device=dev) for dev in ("cpu", "cuda")}

    def randn(*shape):
        return torch.tensor(rs.randn(*shape).astype(np.float32))

    t0 = time.perf_counter()
    edm = build(EDM_CONFIG, use_bf16=False)
    slice_step_card_vs_cpu(torch, "EDM edm_cifar10 bs4", edm, img_batch, {
        "flip": flip, "sigma_normal": randn(n), "noise": randn(n, 32, 32, 3)})
    x_T = randn(2, 32, 32, 3)
    slice_chain_card_vs_cpu(torch, "EDM Heun-3 bs2 from one x_T", edm, lambda m: m.sample(
        None, 2, method="heun", steps=3, x_T=x_T))

    ct = build(CT_CONFIG, use_bf16=False)
    slice_step_card_vs_cpu(torch, "ConsistencyModel ct_cifar10 bs4 (8 rows a forward)", ct,
                           img_batch, {"flip": flip, "index": torch.tensor([0, 3, 6, 9]),
                                       "noise": randn(n, 32, 32, 3)})
    walk = [randn(2, 32, 32, 3)]
    slice_chain_card_vs_cpu(
        torch, "ConsistencyModel multistep-2 bs2 on one x_T and re-noising draw", ct,
        lambda m: m.diffusion.sample(m._apply_fn(m.ema_unet), 2, method="multistep", steps=2,
                                     x_T=x_T, noise_fn=lambda j, shape: walk[j]))

    z_T = randn(2, 4, 4, 64)
    for name, draws, method in (
            ("ldm", {"t": torch.tensor([0, 300, 700, 999])}, "DDIM-3"),
            ("ledm", {"sigma_normal": randn(n)}, "Heun-2"),
            ("lfm", {"t": torch.tensor([0.1, 0.4, 0.6, 0.9])}, "Euler-3")):
        models = build(LDM_CONFIGS[name], use_bf16=False)
        label = f"{type(models['cpu']).__name__} {LDM_CONFIGS[name].name}"
        slice_step_card_vs_cpu(torch, f"{label} bs4 (4 x 4 x 64 latents)", models, img_batch,
                               {"flip": flip, **draws, "noise": randn(n, 4, 4, 64)})
        steps = int(method.split("-")[1])
        slice_chain_card_vs_cpu(torch, f"{label} {method} bs2 from one latent x_T, decoded",
                                models, lambda m: m.sample(None, 2, steps=steps, x_T=z_T))

    vae = build(VAE_CONFIG)
    mnist = {"image": rs.randint(0, 256, (n, 28, 28, 1)).astype(np.uint8),
             "label": np.zeros(n, np.int32)}
    slice_step_card_vs_cpu(torch, "VAE vae.json bs4", vae, mnist,
                           {"flip": flip, "eps": randn(n, 20)}, elementwise=False)
    z = randn(2, 20)
    slice_chain_card_vs_cpu(torch, "VAE decode of fixed latents", vae,
                            lambda m: m.sample(None, 2, z=z))

    # VQGAN with LPIPS as [9] runs the VQGAN: the CPU's pass replays the card's ReLU and
    # LeakyReLU masks (ReluMasks; VGG16's ReLUs among them). Each gradient is read back
    # from Adam's first moment after its first step (g = m / (1 - b1)) and held by its
    # norm. Adam's first step moves an element by lr |g| / (|g| + eps): within 1% of
    # lr sign(g) where |g| >= 100 eps, so there the update does not see f32 noise in g.
    # Below that its size follows |g|, and the update norms leave out the elements there
    # whose two gradients differ by more than SLICE_TOL of the CPU's, at most
    # GAN_NOISE_SHARE of all (on an H100 a 64-element decoder bias's update norm moved
    # 7.3e-3 so while its gradient norm agreed within 1.7e-4). eval_step runs on the CPU
    # step's weights on both devices.
    gan = build(VQGAN_LPIPS_CONFIG, disc_start=0)
    params = {d: {f"net.{k}": v for k, v in m.net.named_parameters()}
              | {f"disc.{k}": v for k, v in m.disc.named_parameters()} for d, m in gan.items()}
    before = {d: {k: v.detach().float().cpu().clone() for k, v in ps.items()}
              for d, ps in params.items()}
    metrics, relu = {}, ReluMasks(torch)
    for dev in ("cuda", "cpu"):
        with relu:
            metrics[dev] = gan[dev].train_step(img_batch, flip=flip)
    metric_err = max(_rel(metrics["cuda"][k], metrics["cpu"][k]) for k in metrics["cpu"])

    def grads(m, ps):
        out = {}
        for opt in (m.optimizer, m.disc_optimizer):
            b1 = opt.param_groups[0]["betas"][0]
            for k, p in ps.items():
                if p in opt.state:
                    out[k] = opt.state[p]["exp_avg"].float().cpu() / (1.0 - b1)
        return out

    g = {d: grads(gan[d], params[d]) for d in gan}
    top = max(float(v.norm()) for v in g["cpu"].values())
    worst, left_out, stepped = (0.0, ""), 0, 0
    for k in before["cpu"]:
        g_out, g_ref = g["cuda"][k], g["cpu"][k]
        if float(g_ref.norm()) >= 1e-5 * top:
            err = _rel_norm(float(g_out.norm()), float(g_ref.norm()))
            worst = max(worst, (err, f"{k} gradient"))
        eps_regime = torch.minimum(g_out.abs(), g_ref.abs()) < 100 * ADAM_EPS
        kept = ~(eps_regime & ((g_out - g_ref).abs() > SLICE_TOL * g_ref.abs()))
        left_out += int((~kept).sum())
        stepped += kept.numel()
        d_out = (params["cuda"][k].detach().float().cpu() - before["cuda"][k])[kept]
        d_ref = (params["cpu"][k].detach().float().cpu() - before["cpu"][k])[kept]
        worst = max(worst, (_rel_norm(float(d_out.norm()), float(d_ref.norm())), f"{k} update"))
    gan["cuda"].load_state_dict(copy.deepcopy(gan["cpu"].state_dict()))
    evals, eval_relu = {}, ReluMasks(torch)
    for dev in ("cuda", "cpu"):
        with eval_relu:
            evals[dev] = gan[dev].eval_step(img_batch)
    eval_err = max(_rel(evals["cuda"][k], evals["cpu"][k]) for k in evals["cpu"])
    ok = (max(metric_err, worst[0], eval_err) <= SLICE_TOL
          and left_out <= GAN_NOISE_SHARE * stepped
          and "train_perceptual_loss" in metrics["cpu"] and "val_perceptual_loss" in evals["cpu"])
    print(f"  VQGAN vqgan_lpips.json (perceptual_weight 1.0, disc_start 0) bs4 train step, "
          f"card vs CPU with the card's (leaky) ReLU masks ({relu.flips} of {relu.inputs} "
          f"inputs on the other side of 0 on the CPU): metrics {metric_err:.2e} "
          f"(perceptual_loss {float(metrics['cuda']['train_perceptual_loss']):.5f} vs "
          f"{float(metrics['cpu']['train_perceptual_loss']):.5f}, adaptive weight "
          f"{float(metrics['cuda']['train_adaptive_weight']):.3e}); worst gradient and update "
          f"norm {worst[0]:.2e} ({worst[1]}; {left_out} of {stepped} stepped elements left "
          f"out as noise); eval on the same weights {eval_err:.2e}; tol {SLICE_TOL:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("VQGAN with LPIPS: the card's step disagrees with the CPU's")
    codes = torch.tensor(rs.randint(0, 512, (2, 4, 4)))
    slice_chain_card_vs_cpu(torch, "VQGAN decode of fixed codes", gan,
                            lambda m: m.decode_codes(codes))
    print(f"  [30] took {time.perf_counter() - t0:.1f} s", flush=True)


@dataclass
class SlicePath:
    """One model of the slice through its entry points: the config it trains (a derived
    one for the latent models), the experiment, the steps, and the launches worked out from
    its UNet: ``la`` linear-attention blocks an evaluation (6 at dim_mults (1, 2, 4, 8), 2
    at (1, 2)), ``grid_evals`` network evaluations of a validation grid of 64 and
    ``generate`` [(extra argv, evaluations)] of each generate call; ``vq`` searches a
    decode (1 for the latent models), ``vq_step`` a train step (VQGAN: 1)."""
    name: str
    config: Path
    model: str
    run: str
    steps: int
    resume_steps: int
    la: int
    grid_evals: int
    generate: list
    vq: int = 0
    vq_step: int = 0
    resume_config: Optional[Path] = None  # the latent models resume with a random-AE config


def slice_train_path(torch, card: str, path: SlicePath) -> dict:
    """train path.steps steps (validation, a grid of 64, checkpoints), a --resume of
    path.resume_steps more, then each generate call; every count of PATH_COUNTERS set to 0
    before each run and held after it to the count worked out: linear_attention la x
    (steps + validation batches + grid evaluations), its backward la x steps,
    nearest_codes vq_step x steps + vq per decode (the grid's; VQGAN: one per validation
    batch), every other 0. Returns the counts and the walls."""
    import math

    import numpy as np

    from lightning_generative_models_tpu_torch import generate, train
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run_dir = EXPERIMENT_DIR / path.model / path.run
    shutil.rmtree(run_dir, ignore_errors=True)
    config = load_config(path.config)
    val_batches = len(list(DataModule(**config["dataset"]).val_batches()))
    argv = ["--experiment_name", path.run, "--device", "cuda", "--check_val_every_n_epoch",
            "1000", "--sample_every_n_steps", "0"]
    counts, walls, model = {}, {}, None
    runs = (("train", path.config, path.steps, []),
            ("resume", path.resume_config or path.config, path.steps + path.resume_steps,
             ["--resume"]))
    for name, cfg, steps, extra in runs:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        model = train.main(argv + ["--config_path", str(cfg), "--max_steps", str(steps)] + extra)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        got = read_counts()
        new = steps - (0 if name == "train" else path.steps)
        vq_val = val_batches if path.vq_step else 0
        want = dict.fromkeys(PATH_COUNTERS, 0) | {
            "linear_attention": path.la * (new + val_batches + path.grid_evals),
            "linear_attention_bwd": path.la * new,
            "nearest_codes": path.vq_step * new + vq_val + path.vq}
        counts[name] = got
        print(f"  {path.name} {name}: {new} steps to step {model.step} in {walls[name]:.1f} s "
              f"(model build, data, validation, the grid and checkpoints included) on {card}")
        print(f"  {path.name} {name}: launches {got} (expected linear_attention {path.la} x "
              f"({new} steps + {val_batches} validation batches + {path.grid_evals} grid "
              f"evaluations) = {want['linear_attention']}, backward {path.la} x {new} = "
              f"{want['linear_attention_bwd']}, nearest_codes {path.vq_step} x {new} + "
              f"{vq_val} + {path.vq} = {want['nearest_codes']}, every other 0)", flush=True)
        if got != want:
            fail(f"the {path.name} {name} run launched the kernels {got}, not {want}")
        if model.step != steps:
            fail(f"the {path.name} {name} run ended at step {model.step}, not {steps}")
    records = read_metrics(run_dir)
    train_records = [r for r in records if "train_loss" in r]
    losses = [r["train_loss"] for r in train_records]
    val = [r for r in records if any(k.startswith("val_") for k in r)]
    print(f"  {path.name} train_loss by logged step: " + ", ".join(
        f"{r['step']}: {r['train_loss']:.4f}" for r in train_records)
        + f"; validation {[{k: round(v, 4) for k, v in r.items() if k.startswith('val_')} for r in val]}",
        flush=True)
    if not all(math.isfinite(v) for v in losses) or len(val) != 2:
        fail(f"{path.name}: a train loss is not finite, or not one validation per run")
    if train_records[-1]["step"] != path.steps + path.resume_steps - 1:
        fail(f"the resumed {path.name} run did not log its last step")
    if len(sorted((run_dir / "samples").glob("random_generation_*.png"))) != 2:
        fail(f"{path.name}: expected a sample grid per run")
    for which in ("last", "best"):
        if not (run_dir / "checkpoints" / f"checkpoint_meta_{which}.json").exists():
            fail(f"{path.name}: no {which} checkpoint meta")

    out_dir = OUT_DIR / path.run
    for extra, evals in path.generate:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        images = generate.main(["--config_path", str(path.config), "--num_samples", "64",
                                "--device", "cuda", "--seed", "0", "--out", str(out_dir)]
                               + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        want = dict.fromkeys(PATH_COUNTERS, 0) | {"linear_attention": path.la * evals,
                                                  "nearest_codes": path.vq}
        label = f"generate {' '.join(extra) or 'default'}"
        counts[label] = got
        walls[label] = wall
        print(f"  {path.name} {label} bs64: {images.shape} in {wall:.2f} s ({64 / wall:.1f} "
              f"samples/s, model build, init and PNG included); launches {got} (expected "
              f"linear_attention {path.la} x {evals} evaluations = {want['linear_attention']},"
              f" nearest_codes {path.vq}, every other 0)", flush=True)
        if got != want:
            fail(f"{path.name} {label} launched the kernels {got}, not {want}")
        if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
            fail(f"{path.name} samples are not finite values in [0, 1]")
        if not (out_dir / "grid.png").exists():
            fail(f"{path.name}: generate wrote no grid.png")
    return {"counts": counts, "walls_s": walls, "model": model}


def derive_latent_configs() -> dict:
    """Each latent config with its autoencoder restored from [10]'s VQ-VAE run
    (``<name>_cifar10_ae.json``), and the same with a random autoencoder
    (``<name>_cifar10_random_ae.json``, the resume's: its checkpoint holds the AE), both in
    chiprun_out/chip_smoke/ (no file is added under configs/)."""
    out = {}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, path in LDM_CONFIGS.items():
        config = json.loads(path.read_text())
        pair = []
        for suffix, run in (("ae", AE_RUN), ("random_ae", None)):
            config["model"]["args"]["autoencoder"] = {
                "config_path": str(VQVAE_CONFIG), "experiment_name": run, "which": "last"}
            derived = OUT_DIR / f"{name}_cifar10_{suffix}.json"
            derived.write_text(json.dumps(config, indent=4) + "\n")
            pair.append(derived)
        out[name] = tuple(pair)
    return out


SLICE_PATHS = {
    "edm": SlicePath("EDM", EDM_CONFIG, "EDM", "chip_smoke_edm", EDM_STEPS, EDM_RESUME_STEPS,
                     6, 35, [([], 35)]),
    "ct": SlicePath("ConsistencyModel", CT_CONFIG, "ConsistencyModel", "chip_smoke_ct",
                    CT_STEPS, CT_RESUME_STEPS, 6, 2,
                    [(["--sampler", "multistep"], 2), (["--sampler", "onestep"], 1)]),
}


def latent_paths(configs: dict) -> list:
    evals = {"ldm": 50, "ledm": 35, "lfm": 50}
    return [SlicePath(name.upper(), configs[name][0],
                      {"ldm": "LatentDiffusion", "ledm": "LatentEDM",
                       "lfm": "LatentFlowMatching"}[name], f"chip_smoke_{name}", LATENT_STEPS,
                      LATENT_RESUME_STEPS, 2, evals[name], [([], evals[name])], vq=1,
                      resume_config=configs[name][1]) for name in ("ldm", "ledm", "lfm")]


def check_resume_restores_autoencoder(torch, model) -> None:
    """The resumed latent model was built with a random autoencoder (its config names no
    run); its checkpoint put back the one it trained with, [10]'s VQ-VAE."""
    from lightning_generative_models_tpu_torch.registry import load_model
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    ae = load_model(load_config(VQVAE_CONFIG)["model"], device="cuda")
    random_ae = {k: v.clone() for k, v in ae.net.state_dict().items()}
    CheckpointManager(EXPERIMENT_DIR / "VQVAE" / AE_RUN / "checkpoints").restore(ae)
    same = all(torch.equal(v, ae.net.state_dict()[k]) for k, v in model.ae.net.state_dict().items())
    was_random = any(not torch.equal(v, random_ae[k]) for k, v in model.ae.net.state_dict().items())
    print(f"  {type(model).__name__} resumed from a random-autoencoder config: its autoencoder "
          f"equals {AE_RUN}'s last checkpoint {same}, differs from the random one "
          f"{was_random}", flush=True)
    if not (same and was_random):
        fail("the resumed latent model's autoencoder is not the one of its checkpoint")


def sample_breakdown(torch, card: str, config_path: Path, label: str, out_name: str,
                     repeats: int = 3, precision: str = "bf16", **sample_kwargs) -> dict:
    """Samples/s at bs64 of the config's model built (EMA weights from a seed), median of
    ``repeats`` after a warm-up, then one batch under torch.profiler; ``precision`` labels
    the printout."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.registry import load_model

    model = load_model(load_config(config_path)["model"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        model.sample(gen, MAIN_BATCH, **sample_kwargs)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"  {label} bs{MAIN_BATCH} {precision}: {wall:.4f} s median of "
          f"{[round(w, 4) for w in walls]}"
          f", {MAIN_BATCH / wall:.2f} samples/s on {card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = profile_summary(torch, prof, wall_us, f"{label} bs{MAIN_BATCH}", out_name, card)
    return {"samples_per_s": MAIN_BATCH / wall, "s_per_batch": wall, **summary}


# -- the last five families: DAE, the UNet autoencoder, PixelCNN, NICE, Glow ([35]-[37]) --

FAMILY_CONFIGS = {name: ROOT / "configs" / path for name, path in (
    ("DAE", "autoencoder/dae.json"), ("UNet", "autoencoder/unet.json"),
    ("PixelCNN", "autoregressive/pixelcnn.json"), ("NICE", "flow/nice.json"),
    ("Glow", "flow/glow_cifar10.json"))}
FAMILY_BATCH = 8  # [35]
FAMILY_TOL = 1e-3  # f32 card against CPU: metrics, gradient and update norms, chains
FLOW_TOL = 1e-4  # the flows' z and log-det (of 1 + |ref|) and inverse(forward(x)) on the card
PIXELCNN_CHAIN = 32  # [35]: the first pixels of a PixelCNN chain, card against CPU
FAMILY_STEPS, FAMILY_RESUME_STEPS = 12, 4  # [36]
FAMILY_SYNTHETIC = 1024  # [36]: synthetic images a config stages (the data cut, not widths)


def off_zero(torch, net, seed: int, std: float = 0.05) -> None:
    """Every parameter that starts at exactly 0 (biases, ActNorm, NICE's scale, Glow's
    zero-initialised coupling convs) drawn on the CPU from N(0, std^2), a kernel's from
    N(0, std^2 / fan-in): at init most gradients of the flows are exactly 0, and a check
    there tests almost nothing."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            if not p.detach().any():
                scale = std * (p[0].numel() ** -0.5 if p.dim() > 1 else 1.0)
                p.copy_(torch.randn(p.shape, generator=gen) * scale)


def family_step_card_vs_cpu(torch, name: str, models: dict, batch: dict, draws: dict) -> None:
    """One grad_step + apply_grad_step on the CPU and on the card from the same weights,
    batch and draws: every metric within FAMILY_TOL of 1 + |ref|; each weight's gradient
    norm, leaving out the weights whose CPU gradient is f32 noise (a norm below 1e-5 of the
    largest); each weight's update norm, leaving out the elements whose two gradients differ
    by more than FAMILY_TOL of the CPU's (Adam's first step moves an element by about lr
    whatever its gradient's size, so f32 noise in a small gradient moves it by up to 2 lr),
    at most GAN_NOISE_SHARE of the stepped elements, as [26] does."""
    res = {}
    for dev, m in models.items():
        params = list(m.net.parameters())
        before = [p.detach().cpu().clone() for p in params]
        grads, metrics = m.grad_step(batch, **draws)
        grads = [g.cpu() for g in grads]
        metrics = m.apply_grad_step([g.to(m.device) for g in grads], metrics)
        res[dev] = (metrics, grads, [p.detach().cpu() - b for p, b in zip(params, before)])
    (m_ref, g_ref, u_ref), (m_out, g_out, u_out) = res["cpu"], res["cuda"]
    metric_err = max(_rel(m_out[k], m_ref[k]) for k in m_ref)
    top = max(float(g.norm()) for g in g_ref)
    worst, left_out, stepped = (0.0, ""), 0, 0
    for (pname, _), go, gr, uo, ur in zip(models["cpu"].net.named_parameters(), g_out, g_ref,
                                          u_out, u_ref):
        if float(gr.norm()) >= 1e-5 * top:
            worst = max(worst, (_rel_norm(float(go.norm()), float(gr.norm())),
                                f"{pname} gradient"))
        kept = (go - gr).abs() <= FAMILY_TOL * gr.abs()
        left_out += int((~kept).sum())
        stepped += kept.numel()
        worst = max(worst, (_rel_norm(float(uo[kept].norm()), float(ur[kept].norm())),
                            f"{pname} update"))
    ok = max(metric_err, worst[0]) <= FAMILY_TOL and left_out <= GAN_NOISE_SHARE * stepped
    print(f"  {name} train step, card vs CPU: metrics {metric_err:.2e} ("
          + ", ".join(f"{k} {float(m_out[k]):.5f}" for k in sorted(m_ref))
          + f"), worst gradient and update norm {worst[0]:.2e} ({worst[1]}; {left_out} of "
          f"{stepped} stepped elements left out as noise); tol {FAMILY_TOL:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: the card's train step disagrees with the CPU's")


def pixelcnn_chain(torch, model, gumbel, picks=None) -> tuple:
    """The first len(gumbel) pixels of ``model``'s raster chain from a blank batch: each
    pixel's logits (one full forward) and its own Gumbel-max pick; with ``picks`` the chain
    goes on with those (the CPU's) instead of its own. Returns (logits, own picks, images)."""
    logits_seen, own = [], []
    with torch.inference_mode():
        images = torch.zeros((gumbel.shape[1], model.img_size, model.img_size,
                              model.img_channels), device=model.device)
        for idx in range(gumbel.shape[0]):
            logits = model.pixel_logits(images, idx)
            pick = torch.argmax(logits + gumbel[idx].to(model.device), dim=-1)
            logits_seen.append(logits.cpu())
            own.append(pick.cpu())
            model.set_pixel(images, idx, pick if picks is None else picks[idx].to(model.device))
    return torch.stack(logits_seen), torch.stack(own), images.cpu()


def check_families_card_vs_cpu(torch) -> None:
    """[35]: each of the five at its config's widths in f32 (TF32 off), batch 8, the card
    against the CPU from the same weights (every zero leaf drawn off zero: ``off_zero``):
    one train step on the same batch and draws (family_step_card_vs_cpu); DAE's decode of
    fixed noise images and UNet's reconstruction; NICE's and Glow's z and log-det within
    FLOW_TOL of 1 + |ref| on the prepared batch, ``inverse(forward(x))`` on the card within
    FLOW_TOL, and a sample on a fixed z; PixelCNN's first PIXELCNN_CHAIN pixels on fixed
    Gumbel draws, the card replaying the CPU's picks (a near tie of two levels can pick
    another one on the card, and every later pixel would differ), every step's logits held
    within FAMILY_TOL of max(1, max |ref|), and the card's own picks counted against the
    CPU's."""
    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.registry import load_model

    rs = np.random.RandomState(35)
    n = FAMILY_BATCH
    t0 = time.perf_counter()

    def randn(*shape):
        return torch.tensor(rs.randn(*shape).astype(np.float32))

    for i, (name, path) in enumerate(FAMILY_CONFIGS.items()):
        cfg = load_config(path)["model"]
        models = {d: load_model(cfg, device=d) for d in ("cpu", "cuda")}
        for m in models.values():
            off_zero(torch, m.net, 35 + i)
        cpu = models["cpu"]
        s, c = cpu.img_size, cpu.img_channels
        batch = {"image": rs.randint(0, 256, (n, s, s, c)).astype(np.uint8),
                 "label": np.zeros(n, np.int32)}
        flip = torch.tensor(rs.rand(n) < 0.5)
        draws = {"DAE": {"flip": flip, "noise": randn(n, s, s, c)}, "UNet": {"flip": flip},
                 "PixelCNN": {}}.get(name, {"uniform": torch.tensor(rs.rand(n, s, s, c)
                                                                   .astype(np.float32))})
        label = f"{name} {path.name} bs{n}"
        family_step_card_vs_cpu(torch, label, models, batch, draws)
        if name == "DAE":
            noise = randn(2, s, s, c)
            slice_chain_card_vs_cpu(torch, "DAE decode of fixed noise images", models,
                                    lambda m: m.sample(None, 2, noise=noise))
        elif name == "UNet":
            slice_chain_card_vs_cpu(torch, "UNet autoencoder reconstruction", models,
                                    lambda m: m.reconstruct(batch))
        elif name == "PixelCNN":
            gumbel = -torch.log(-torch.log(torch.tensor(
                rs.rand(PIXELCNN_CHAIN, 2, c, cpu.num_levels).astype(np.float32)
            ).clamp_min(torch.finfo(torch.float32).tiny)))
            ref_logits, ref_picks, ref_images = pixelcnn_chain(torch, cpu, gumbel)
            logits, picks, images = pixelcnn_chain(torch, models["cuda"], gumbel, ref_picks)
            err = (logits - ref_logits).abs().max().item()
            scale = max(1.0, ref_logits.abs().max().item())
            other = int((picks != ref_picks).sum())
            ok = err <= FAMILY_TOL * scale and torch.equal(images, ref_images)
            print(f"  PixelCNN chain of the first {PIXELCNN_CHAIN} pixels bs2, the card on the "
                  f"CPU's picks: logits max_abs_err {err:.3e} (tol {FAMILY_TOL:.0e} x "
                  f"max(1, max|ref|) = {FAMILY_TOL * scale:.1e}); the card's own picks differ "
                  f"at {other} of {picks.numel()}; images equal {torch.equal(images, ref_images)}"
                  f" {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail("PixelCNN: card and CPU chains disagree")
        else:
            prep = {d: (m._flatten(batch["image"]) if name == "NICE"
                        else m._prepare(batch["image"])) for d, m in models.items()}
            with torch.inference_mode():
                out = {d: m.net(prep[d]) for d, m in models.items()}
                z_err = _rel(out["cuda"][0], out["cpu"][0])
                ld_err = _rel(out["cuda"][1].reshape(-1), out["cpu"][1].reshape(-1))
                back = models["cuda"].net.inverse(out["cuda"][0])
                inv_err = (back - prep["cuda"]).abs().max().item()
            ok = max(z_err, ld_err, inv_err) <= FLOW_TOL
            print(f"  {name} forward, card vs CPU: z {z_err:.2e}, log-det {ld_err:.2e} (of 1 + "
                  f"|ref|; log-det {float(out['cpu'][1].reshape(-1)[0]):.2f}), inverse(forward(x))"
                  f" on the card max_abs_err {inv_err:.2e}; tol {FLOW_TOL:.0e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name}: the card's flow disagrees with the CPU's or does not invert")
            z = randn(2, s * s * c)
            slice_chain_card_vs_cpu(torch, f"{name} sample on a fixed z", models,
                                    lambda m: m.sample(None, 2, z=z))
    print(f"  [35] took {time.perf_counter() - t0:.1f} s", flush=True)


def derive_family_configs() -> dict:
    """Each config of FAMILY_CONFIGS with its synthetic data cut to FAMILY_SYNTHETIC images
    (``<name>_synthetic.json`` in chiprun_out/chip_smoke/; no file is added under
    configs/): the widths and batch as they are."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, path in FAMILY_CONFIGS.items():
        config = json.loads(path.read_text())
        config["dataset"]["synthetic_size"] = FAMILY_SYNTHETIC
        derived = OUT_DIR / f"{path.stem}_synthetic.json"
        derived.write_text(json.dumps(config, indent=4) + "\n")
        out[name] = derived
    return out


def family_entry_path(torch, card: str, name: str, config_path: Path) -> dict:
    """[36]: train FAMILY_STEPS steps (a validation, a grid of 64 but for the UNet
    autoencoder, checkpoints), a --resume to FAMILY_STEPS + FAMILY_RESUME_STEPS, then
    generate 64 (the UNet autoencoder's raises NotImplementedError with JAX's text), every
    kernel counter set to 0 before each run and held to 0 after it. Returns the walls."""
    import math

    import numpy as np

    from lightning_generative_models_tpu_torch import generate, train
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run = f"chip_smoke_{name.lower()}"
    run_dir = EXPERIMENT_DIR / name / run
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--config_path", str(config_path), "--experiment_name", run, "--device", "cuda",
            "--check_val_every_n_epoch", "1000", "--sample_every_n_steps", "0"]
    walls, counts = {}, {}
    total = FAMILY_STEPS + FAMILY_RESUME_STEPS
    for label, steps, extra in (("train", FAMILY_STEPS, []), ("resume", total, ["--resume"])):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        model = train.main(argv + ["--max_steps", str(steps)] + extra)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        counts[label] = read_counts()
        if model.step != steps:
            fail(f"the {name} {label} run ended at step {model.step}, not {steps}")
    records = read_metrics(run_dir)
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    val = [{k: round(v, 4) for k, v in r.items() if k.startswith("val_")} for r in records
           if any(k.startswith("val_") for k in r)]
    grids = len(list((run_dir / "samples").glob("random_generation_*.png")))
    print(f"  {name}: train {FAMILY_STEPS} steps {walls['train']:.1f} s, resume to {total} "
          f"{walls['resume']:.1f} s (model build, data, validation, grid, checkpoints); "
          f"train_loss {[round(v, 4) for v in losses]}; validation {val}; {grids} grids",
          flush=True)
    want_grids = 0 if name == "UNet" else 2
    if not all(math.isfinite(v) for v in losses) or len(val) != 2 or grids != want_grids:
        fail(f"{name}: a loss is not finite, or not one validation and grid per run")
    for which in ("last", "best"):
        if not (run_dir / "checkpoints" / f"checkpoint_meta_{which}.json").exists():
            fail(f"{name}: no {which} checkpoint meta")
    argv = ["--config_path", str(config_path), "--num_samples", "64", "--device", "cuda",
            "--seed", "0", "--out", str(OUT_DIR / run)]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    if name == "UNet":
        try:
            generate.main(argv)
            fail("the UNet autoencoder's generate did not raise")
        except NotImplementedError as err:
            print(f"  UNet generate raises NotImplementedError: {err}", flush=True)
            if str(err) != "UNet autoencoder has no generative prior":
                fail("the UNet autoencoder's generate raised another text than JAX's")
    else:
        images = generate.main(argv)
        torch.cuda.synchronize()
        walls["generate"] = time.perf_counter() - t0
        print(f"  {name} generate bs64: {images.shape} in {walls['generate']:.2f} s (model "
              f"build, init and PNG included)", flush=True)
        if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
            fail(f"{name} samples are not finite values in [0, 1]")
    counts["generate"] = read_counts()
    if any(any(c.values()) for c in counts.values()):
        fail(f"{name}'s paths launched a TPU kernel's counterpart: {counts}")
    print(f"  {name}: every kernel counter 0 on train, resume and generate", flush=True)
    return walls


def glow_syncs(torch, configs: dict) -> dict:
    """NICE's and Glow's train_step once each (after a warm-up step) under
    torch.cuda.set_sync_debug_mode("warn"): the host syncs it reports, by message."""
    import warnings

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model

    out = {}
    for name in ("NICE", "Glow"):
        config = load_config(configs[name])
        model = load_model(config["model"], device="cuda")
        batch = {k: torch.as_tensor(v).cuda() for k, v in
                 next(DataModule(**config["dataset"]).train_batches(0)).items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        model.train_step(batch, gen)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                model.train_step(batch, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        msgs = {}
        for w in caught:
            text = str(w.message).splitlines()[0][:120]
            if not text.startswith("Synchronization debug mode is a prototype"):
                msgs[text] = msgs.get(text, 0) + 1
        out[name] = msgs
        print(f"  {name} train_step under set_sync_debug_mode('warn'): {sum(msgs.values())} "
              f"host syncs {msgs}", flush=True)
    return out


def family_breakdown(torch, card: str, configs: dict) -> dict:
    """[37]: Glow CIFAR-10 training at bs128; Glow's sample at bs64; PixelCNN training at
    bs64; PixelCNN sampling at bs64 (after a warm-up batch, one batch of 784 forwards
    timed, one under torch.profiler); the host syncs of NICE's and Glow's steps."""
    stats = {"glow_train": train_breakdown(
        torch, card, steps=20, repeats=3, config_path=configs["Glow"], precision="f32",
        out_name="glow_train_profile.txt")}
    stats["glow_sample"] = sample_breakdown(torch, card, FAMILY_CONFIGS["Glow"], "Glow sample",
                                            "glow_sample_profile.txt", repeats=2,
                                            precision="f32")
    stats["pixelcnn_train"] = train_breakdown(
        torch, card, steps=20, repeats=2, config_path=configs["PixelCNN"],
        precision="f32", out_name="pixelcnn_train_profile.txt")
    stats["pixelcnn_sample"] = sample_breakdown(
        torch, card, FAMILY_CONFIGS["PixelCNN"], "PixelCNN sample (784 forwards)",
        "pixelcnn_sample_profile.txt", repeats=1, precision="f32")
    stats["syncs"] = glow_syncs(torch, configs)
    return stats


# --- the metrics and DiT-MoE slice: [38]-[44] ---------------------------------------------
INCEPTION_TOL = 1e-3  # f32 InceptionV3 card against CPU: ingestion, features, logits (1 + |ref|)
INCEPTION_BATCH = 8  # [38]
INCEPTION_THROUGHPUT_BATCH = 256  # [44]
# The DiT-MoE shape of kernels #3 and #4: dit_moe_cifar10 at bs128 (8 heads of d 48, h3d).
MOE_ATTN_CASE = (128, 256, 8, 48, "h3d", "bfloat16")
MOE_BATCH = 4  # [40]
# [40]: most tokens whose top-1 expert the card's own router would change, as a share of
# the routed tokens: each is a token whose two best router probabilities lie within the
# f32 difference of the two devices' sums.
MOE_REPLAY_SHARE = 1e-2
DIT_MOE_TRAIN_STEPS, DIT_MOE_RESUME_STEPS = 30, 10  # [41]
FID_N, FID_BATCH = 10000, 256  # [42]
FID_SMALL = 24  # [42]: images in each set of the card-against-CPU FID
# FID card against CPU on 24 + 24 images: rank-deficient covariances (24 rows of 2,048
# features), where the square root of near-zero eigenvalues amplifies f32 differences.
FID_REL_TOL = 1e-3
DCGAN_METRICS_STEPS = 4  # [43]
GEN_METRIC_KEYS = ("fid_score", "mean_kid_score", "std_kid_score", "mean_inception_score",
                   "std_inception_score")
JAX_FID_KEYS = {"fid", "n_fake", "n_real", "pretrained_inception", "comparable_to_published",
                "checkpoint", "step", "dataset", "synthetic_data", "seed", "sampler",
                "sampling_steps"}
DIT_MOE_PATH = TransformerPath(
    "DiT-MoE", DIT_MOE_CONFIG, "DDPM", DIT_MOE_RUN, "fused_attention_qkv",
    "fused_attention_qkv_bwd", f"DDIM-{DDIM_STEPS} guided", 2 * DIT_BATCH, 2,
    DIT_MOE_TRAIN_STEPS, DIT_MOE_RESUME_STEPS, "dit_moe")


def inception_pair(torch, seed: int):
    """The port's InceptionV3 with He-scaled random weights and BatchNorms drawn off their
    defaults, as two extractors: on the CPU and on the card."""
    import copy

    from lightning_generative_models_tpu_torch.metrics import inception as ti

    net = ti.he_scaled_random_init(ti.InceptionV3(), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.copy_(0.5 + torch.rand(c, generator=gen))
                mod.bias.copy_(0.2 * torch.randn(c, generator=gen))
                mod.running_mean.copy_(0.2 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return (ti.InceptionFeatureExtractor(copy.deepcopy(net), device="cpu"),
            ti.InceptionFeatureExtractor(net, device="cuda"))


def check_inception_card_vs_cpu(torch) -> dict:
    """[38]: ingestion, features and logits of bs8 uint8 32 px images, card against CPU
    (f32, TF32 off), within INCEPTION_TOL of 1 + |ref|; metrics.verify's stages on the
    card."""
    import numpy as np

    from lightning_generative_models_tpu_torch.metrics import inception as ti
    from lightning_generative_models_tpu_torch.metrics import verify

    cpu, card = inception_pair(torch, seed=38)
    images = np.random.RandomState(38).randint(0, 256, (INCEPTION_BATCH, 32, 32, 3),
                                               dtype=np.uint8)
    errs = {"ingestion": _rel(ti.ingest(images, torch.device("cuda")).cpu(),
                              ti.ingest(images, torch.device("cpu")))}
    (rf, rl), (kf, kl) = cpu(images), card(images)
    errs["features"] = _rel(torch.from_numpy(kf), torch.from_numpy(rf))
    errs["logits"] = _rel(torch.from_numpy(kl), torch.from_numpy(rl))
    ok = all(np.isfinite(a).all() for a in (kf, kl)) and max(errs.values()) <= INCEPTION_TOL
    spread = float(rf.std(axis=0).mean())
    print(f"  InceptionV3 bs{INCEPTION_BATCH} at 299 f32, card vs CPU: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (max |k - p| / (1 + |p|), tol {INCEPTION_TOL:.0e}); feature spread over the "
          f"batch {spread:.3e} {'ok' if ok and spread > 1e-3 else 'FAIL'}", flush=True)
    if not ok or spread <= 1e-3:
        fail("InceptionV3 on the card disagrees with the CPU")
    fid = verify.verify_loader_path("cuda")
    stage2 = verify.verify_pretrained("cuda")
    return {**errs, "verify_stage1_fid": fid, "pretrained_found": stage2 == 0}


class RouteTape:
    """Top-1 routes of a model's MoE layers on the CPU, replayed on the card: every CPU
    MoEMlp records the experts its router picks, call by call; the card's layer at the
    same place computes its own router probabilities and picks, counts the tokens whose
    pick differs from the CPU's and routes them as the CPU did. ``margin`` is the
    smallest gap between a token's two best CPU probabilities."""

    def __init__(self, torch, cpu_net, card_net):
        from lightning_generative_models_tpu_torch.models.modules.moe import MoEMlp

        layers = [[m for m in net.modules() if isinstance(m, MoEMlp)]
                  for net in (cpu_net, card_net)]
        self.torch = torch
        self.queues = [[] for _ in layers[0]]
        self.replayed = self.routed = 0
        self.margin = float("inf")
        for i, (cpu_layer, card_layer) in enumerate(zip(*layers)):
            cpu_layer.route = self._record(i, cpu_layer.route)
            card_layer.route = self._replay(i, card_layer.route)

    def _record(self, i, route):
        def record(x):
            probs, choice = route(x)
            top = self.torch.topk(probs.detach(), 2, dim=-1).values
            self.margin = min(self.margin, float((top[..., 0] - top[..., 1]).min()))
            self.queues[i].append(choice.detach().clone())
            return probs, choice
        return record

    def _replay(self, i, route):
        def replay(x):
            probs, choice = route(x)
            want = self.queues[i].pop(0).to(choice.device)
            self.replayed += int((choice != want).sum())
            self.routed += choice.numel()
            return probs, want
        return replay


def check_dit_moe_card_vs_cpu(torch) -> dict:
    """[40]: the full-width DiT-MoE in f32 at bs4, card against CPU, the same weights and
    inputs, the card replaying the CPU's routes: the forward, a 3-step guided DDIM chain,
    one train step."""
    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM

    args = {**load_config(DIT_MOE_CONFIG)["model"]["args"], "use_bf16": False}
    models = {dev: DDPM(**args, device=dev) for dev in ("cpu", "cuda")}
    open_dit(torch, models["cpu"].unet, seed=40)
    models["cuda"].unet.load_state_dict(models["cpu"].unet.state_dict())
    for model in models.values():
        model.copy_params_to_ema()
    tapes = [RouteTape(torch, models["cpu"].unet, models["cuda"].unet),
             RouteTape(torch, models["cpu"].ema_unet, models["cuda"].ema_unet)]

    gen = torch.Generator().manual_seed(41)
    x = torch.randn(MOE_BATCH, 32, 32, 3, generator=gen)
    t, labels = torch.tensor([0, 250, 600, 999]), torch.tensor([3, 10, 7, 1])  # 10: null
    with torch.inference_mode():
        ref, ref_aux = models["cpu"].unet(x, t, labels=labels, return_aux=True)
        out, aux = models["cuda"].unet(x.cuda(), t.cuda(), labels=labels.cuda(),
                                       return_aux=True)
    report_close(torch, f"DiT-MoE f32 bs{MOE_BATCH} forward, card vs CPU", out, ref)
    report_close(torch, "its mean load-balancing loss", aux.reshape(1), ref_aux.reshape(1))

    x_T = torch.randn(2, 32, 32, 3, generator=gen)
    samples = [models[dev].sample(None, 2, steps=3, x_T=x_T) for dev in ("cpu", "cuda")]
    report_close(torch, "DDIM-3 with guidance (w 3) f32 bs2 from one x_T, card vs CPU",
                 samples[1], samples[0])

    rs = np.random.RandomState(42)
    batch = {"image": rs.randint(0, 256, (MOE_BATCH, 32, 32, 3)).astype(np.uint8),
             "label": np.array([4, 7, 0, 9], np.int32)}
    draws = {"flip": torch.tensor([True, False, False, True]),
             "drop": torch.tensor([False, True, False, False]),
             "t": torch.tensor([10, 600, 300, 999]),
             "noise": torch.tensor(rs.randn(MOE_BATCH, 32, 32, 3).astype(np.float32))}
    aux_vals = [m["moe_aux"] for m in report_grad_steps(
        torch, f"DiT-MoE train step f32 bs{MOE_BATCH}, card vs CPU", models, batch, draws)]
    replayed = sum(tp.replayed for tp in tapes)
    routed = sum(tp.routed for tp in tapes)
    margin = min(tp.margin for tp in tapes)
    ok = (replayed <= MOE_REPLAY_SHARE * routed and not any(q for tp in tapes for q in tp.queues)
          and abs(aux_vals[1] - aux_vals[0]) <= DIT_TOL * abs(aux_vals[0]))
    print(f"  routes replayed: {replayed} of {routed} routed tokens took another expert on "
          f"the card (bound {MOE_REPLAY_SHARE:.0%}); smallest CPU top-2 margin {margin:.3e}; "
          f"moe_aux card {aux_vals[1]:.6f} vs CPU {aux_vals[0]:.6f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the DiT-MoE routes or load-balancing loss disagree between card and CPU")
    return {"replayed": replayed, "routed": routed, "min_top2_margin": margin}


def dit_moe_paths(torch, card: str) -> dict:
    """[41]: generate and train + resume on dit_moe_cifar10.json, launch counts held as
    for the DiT; the train runs log a finite moe_aux."""
    import math

    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    counts = {"generate": transformer_generate_path(torch, card, DIT_MOE_PATH)}
    counts.update(transformer_train_path(torch, card, DIT_MOE_PATH))
    aux = [r["train_moe_aux"] for r in read_metrics(EXPERIMENT_DIR / "DDPM" / DIT_MOE_RUN)
           if "train_moe_aux" in r]
    print(f"  DiT-MoE train_moe_aux by logged step: {[round(a, 4) for a in aux]}", flush=True)
    if not aux or not all(math.isfinite(a) and a > 0 for a in aux):
        fail(f"the DiT-MoE runs logged no finite moe_aux: {aux}")
    return counts


def fid_path(torch, card: str) -> dict:
    """[42]: generate --fid FID_N from [24]'s DCGAN run, then FID_SMALL + FID_SMALL images
    through the same random-init extractor on the card and on the CPU."""
    import contextlib
    import io
    import re

    import numpy as np

    from lightning_generative_models_tpu_torch import generate
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.metrics.generative import (
        FrechetInceptionDistance,
        to_uint8,
    )
    from lightning_generative_models_tpu_torch.registry import load_model
    from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run_dir = EXPERIMENT_DIR / "DCGAN" / DCGAN_RUN
    argv = ["--config_path", str(DCGAN_CONFIG), "--device", "cuda", "--experiment_name",
            DCGAN_RUN, "--which", "last", "--fid", str(FID_N), "--fid_batch", str(FID_BATCH)]
    torch.cuda.synchronize()
    zero_counts()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        art = generate.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print("\n".join("  " + line for line in text.getvalue().splitlines()))
    split = dict(zip(("sampling_s", "inception_s", "statistics_s"), map(float, re.search(
        r"sampling ([\d.]+) s, InceptionV3 ([\d.]+) s, statistics ([\d.]+) s",
        text.getvalue()).groups())))
    step = DCGAN_STEPS + DCGAN_RESUME_STEPS
    path = run_dir / f"fid_{FID_N}_last_step{step}.json"
    ok = (set(art) == JAX_FID_KEYS and art["n_fake"] == art["n_real"] == FID_N
          and art["step"] == step and np.isfinite(art["fid"]) and art["fid"] > 0
          and path.exists() and not any(counts.values()))
    images = 2 * FID_N
    print(f"  FID@{FID_N} = {art['fid']:.4f} in {wall:.1f} s (model build, the synthetic "
          f"real set and the JSON included): sampling {split['sampling_s']:.3f} s, "
          f"InceptionV3 {split['inception_s']:.3f} s ({images / split['inception_s']:.1f} "
          f"images/s over {images} images, f32, TF32 off), statistics "
          f"{split['statistics_s']:.3f} s; launches {counts} (expected all 0) on {card} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"generate --fid wrote {art} to {path} with launches {counts}")

    config = load_config(DCGAN_CONFIG)
    model = load_model(config["model"], device="cuda")
    CheckpointManager(run_dir / "checkpoints").restore(model, "last")
    reals = next(DataModule(**config["dataset"]).val_batches())["image"][:FID_SMALL]
    fakes = to_uint8(model.sample(torch.Generator(device="cuda").manual_seed(42),
                                  FID_SMALL)).cpu().numpy()
    values = []
    for extractor in inception_pair(torch, seed=42):
        fid = FrechetInceptionDistance(extractor)
        fid.update(reals, real=True)
        fid.update(fakes, real=False)
        values.append(fid.compute())
    rel = abs(values[1] - values[0]) / abs(values[0])
    ok = np.isfinite(values).all() and rel <= FID_REL_TOL
    print(f"  FID of {FID_SMALL} real vs {FID_SMALL} DCGAN images: card {values[1]:.6f}, CPU "
          f"{values[0]:.6f}, relative difference {rel:.2e} (tol {FID_REL_TOL:.0e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("FID on the card disagrees with the CPU")
    return {"fid": art["fid"], "wall_s": wall, **split, "launches": counts,
            "small_set_card": values[1], "small_set_cpu": values[0], "small_set_rel": rel}


def derive_dcgan_metrics_config() -> None:
    """DCGAN_METRICS_CONFIG: dcgan_cifar10.json with FID, KID and IS in validation."""
    config = json.loads(DCGAN_CONFIG.read_text())
    config["model"]["args"].update(calculate_metrics=True, metrics=["fid", "kid", "is"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    DCGAN_METRICS_CONFIG.write_text(json.dumps(config, indent=4) + "\n")


def gan_metrics_path(torch, card: str) -> dict:
    """[43]: the derived DCGAN config trained through one validation with the generative
    metrics, then --eval test; every kernel counter 0."""
    import math

    from lightning_generative_models_tpu_torch import train
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    derive_dcgan_metrics_config()
    run_dir = EXPERIMENT_DIR / "DCGAN" / DCGAN_METRICS_RUN
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--config_path", str(DCGAN_METRICS_CONFIG), "--device", "cuda",
            "--experiment_name", DCGAN_METRICS_RUN]
    out = {}
    for name, extra in (("train", ["--max_steps", str(DCGAN_METRICS_STEPS),
                                   "--check_val_every_n_epoch", "1000",
                                   "--sample_every_n_steps", "0"]),
                        ("test", ["--eval", "test"])):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        result = train.main(argv + extra)
        torch.cuda.synchronize()
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        out[f"{name}_launches"] = read_counts()
    val = [r for r in read_metrics(run_dir) if "fid_score" in r]
    test = result
    keys = {k: val[-1].get(k) for k in GEN_METRIC_KEYS} if val else {}
    test_keys = {f"test_{k}": test.get(f"test_{k}") for k in GEN_METRIC_KEYS}
    finite = all(v is not None and math.isfinite(v) for v in (*keys.values(),
                                                                 *test_keys.values()))
    ok = (len(val) == 1 and finite and not any(v for c in (out["train_launches"],
                                                           out["test_launches"])
                                               for v in c.values()))
    print(f"  validation after {DCGAN_METRICS_STEPS} steps in {out['train_wall_s']:.1f} s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in keys.items()), flush=True)
    print(f"  --eval test in {out['test_wall_s']:.1f} s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in test_keys.items())
          + f"; launches {out['train_launches']} / {out['test_launches']} (expected all 0) "
          f"on {card} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"the GAN metrics path logged {val} and tested {test}")
    return {**out, **keys, **test_keys}


def moe_layer_ms(torch) -> float:
    """Device time of one MoE layer's forward and backward at dit_moe_cifar10's train
    shape (bs128, 256 tokens, width 384, bf16), by CUDA events."""
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.models.modules.layers import init_params
    from lightning_generative_models_tpu_torch.models.modules.moe import MoEMlp

    args = load_config(DIT_MOE_CONFIG)["model"]["args"]
    hidden = args["dim"]
    moe = init_params(MoEMlp(hidden, 4 * hidden, args["num_experts"], args["capacity_factor"],
                             torch.bfloat16), torch.Generator().manual_seed(44)).cuda()
    x = torch.randn(TRAIN_BATCH, 256, hidden, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    g = torch.randn_like(x)
    params = [x, *moe.parameters()]

    def step():
        out, aux = moe(x)
        torch.autograd.grad((out, aux), params, (g, torch.ones_like(aux)))

    return time_ms(step, iters=10)


def inception_throughput(torch, card: str) -> float:
    """[44]: InceptionV3 images/s at bs256 from uint8 32 px images (ingestion included),
    f32 with TF32 off, median of 3 timings."""
    import numpy as np

    _, card_extractor = inception_pair(torch, seed=44)
    images = torch.from_numpy(np.random.RandomState(44).randint(
        0, 256, (INCEPTION_THROUGHPUT_BATCH, 32, 32, 3), dtype=np.uint8)).cuda()
    card_extractor(images)  # warm-up: cuDNN plans
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_extractor(images)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    ips = INCEPTION_THROUGHPUT_BATCH / wall
    print(f"  InceptionV3 bs{INCEPTION_THROUGHPUT_BATCH} at 299 f32 (TF32 off): "
          f"{1e3 * wall:.1f} ms a batch, median of {[round(w, 4) for w in walls]} s, "
          f"{ips:.1f} images/s on {card}", flush=True)
    return ips


def moe_breakdown(torch, card: str) -> dict:
    """[44]: DiT-MoE train and sampling throughput with profiles, the MoE layers' share of
    a step's device time, InceptionV3 images/s."""
    stats = transformer_breakdown(torch, card, DIT_MOE_PATH)
    layer_ms = moe_layer_ms(torch)
    moe_layers = 6
    stats["moe_layer_fwd_bwd_ms"] = layer_ms
    if stats.get("busy_us"):
        stats["moe_share_of_step_device_time"] = moe_layers * layer_ms * 1e3 / stats["busy_us"]
        print(f"  a MoE layer's forward + backward at bs{TRAIN_BATCH}: {layer_ms:.3f} ms; "
              f"x {moe_layers} = {moe_layers * layer_ms:.2f} ms of the step's "
              f"{stats['busy_us'] / 1e3:.2f} ms busy "
              f"({100 * stats['moe_share_of_step_device_time']:.1f}%)", flush=True)
    stats["inception_images_per_s"] = inception_throughput(torch, card)
    return stats


# -- unrolled steps as CUDA graphs, bf16 Adam moments, the profiler window,
# interpolation ([45]-[48]) ---------------------------------------------------------------
UNROLL = 4  # [45]-[47]: steps a CUDA graph replays
DDPM_UNROLL_CONFIG = ROOT / "configs" / "diffusion" / "ddpm_cifar10.json"
# [46]: the same config with its validation grid by DDIM-50 (sampling_timesteps 50, derived
# into chiprun_out/chip_smoke/): the 1,000-step ancestral grid of 64 took 45 s a fit.
DDPM_UNROLL_DERIVED = ROOT / "chiprun_out" / "chip_smoke" / "ddpm_cifar10_ddim50.json"
DDPM_UNROLL_RUN = "chip_smoke_ddpm_unroll"  # experiments/DDPM/<this>: [46]
DDPM_UNROLL_FLAGS = ["--unroll_steps", str(UNROLL), "--mu_dtype", "bfloat16", "--nu_dtype",
                     "bfloat16", "--profile_steps", "8:12"]
DDPM_UNROLL_STEPS, DDPM_UNROLL_RESUME = 48, 16
DCGAN_UNROLL_RUN = "chip_smoke_dcgan_unroll"  # experiments/DCGAN/<this>: [46]
DCGAN_UNROLL_STEPS, DCGAN_UNROLL_RESUME = 24, 12
NAME_UNROLL, NAME_DISPATCHES = 2, 2  # [46]: every other registry name, 2 dispatches of 2
GRAPH_MOMENT_TOL = 1e-6  # [45] if not bit-identical: Adam's moments, of 1 + |ref|
GRAPH_UPDATE_TOL = 1e-3  # [45] if not bit-identical: each parameter's update, by its norm
ADAM_CARD_TOL = 1e-5  # [46]: a bf16-moment Adam step, card against CPU (f32 weights)
INTERP_TOL = 1e-4  # [48]: the four processes' interpolate, card against CPU, of 1 + |ref|
INTERP_N = 8  # [48]: generate --interpolate
THROUGHPUT_STEPS = 20  # [47]: steps a timing (5 dispatches of 4)
LA_COUNTERS = ("linear_attention", "linear_attention_bwd")


def graph_cases() -> list:
    """[45]: (label, config, model-arg overrides, batch, k) of each model held graph against
    eager: k = UNROLL, WGAN-GP a whole critic cycle (n_critic + 1 = 6)."""
    return [("DDPM bs128 bf16", DDPM_UNROLL_CONFIG, {}, TRAIN_BATCH, UNROLL),
            ("DDPM bs8 f32", DDPM_UNROLL_CONFIG, {"use_bf16": False}, 8, UNROLL),
            ("DiT-S/2 bs128 bf16", DIT_CONFIG, {}, TRAIN_BATCH, UNROLL),
            ("FM-DiT flash bs128 bf16", FM_CONFIG, {}, TRAIN_BATCH, UNROLL),
            ("DCGAN bs128 bf16", DCGAN_CONFIG, {}, TRAIN_BATCH, UNROLL),
            ("WGAN-GP bs64 f32", WGAN_CONFIG, {}, 64, 6),
            ("VQ-VAE bs256 f32", VQVAE_CONFIG, {}, 256, UNROLL)]


def stacked_batches(torch, config: dict, batch: int, k: int, paired: bool = False) -> dict:
    """k train batches of ``config``'s data at ``batch``, stacked [k, B, ...] on the card."""
    from lightning_generative_models_tpu_torch.data.datamodule import (
        DataModule,
        PairedDataModule,
    )

    data = {**config["dataset"], "batch_size": batch}
    data.pop("paired", None)
    dm = (PairedDataModule if paired else DataModule)(**data)
    it = dm.train_batches(0)
    items = [next(it) for _ in range(k)]
    return {key: torch.stack([torch.as_tensor(b[key]) for b in items]).cuda()
            for key in items[0]}


def snapshot(model) -> tuple:
    from lightning_generative_models_tpu_torch.train.graphs import host_scalars, state_tensors

    return ({n: t.detach().clone() for n, t in state_tensors(model).items()},
            host_scalars(model))


def restore(torch, model, snap: tuple) -> None:
    from lightning_generative_models_tpu_torch.train.graphs import state_tensors

    tensors, scalars = snap
    with torch.no_grad():
        for n, t in state_tensors(model).items():
            t.copy_(tensors[n])
    vars(model).update(scalars)


def state_diff(torch, a: dict, b: dict) -> tuple:
    """(max |a - b| over every state tensor, the names that differ)."""
    worst, names = 0.0, []
    for n, t in a.items():
        d = float((t.double() - b[n].double()).abs().max()) if t.numel() else 0.0
        if d > 0:
            names.append(n)
        worst = max(worst, d)
    return worst, names


def graph_against_eager(torch, label: str, config_path: Path, overrides: dict, batch: int,
                        k: int) -> dict:
    """[45]: one state, the same draws: k eager steps twice (their difference is the
    steps' own nondeterminism) and one k-step CUDA-graph replay (train/graphs.py), held bit
    for bit, else as JAX's unroll test reasons (module doc, 45); the launch counts of the
    replay against the eager steps'."""
    import numpy as np

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.ops.common import launch_counts
    from lightning_generative_models_tpu_torch.registry import load_model
    from lightning_generative_models_tpu_torch.train.graphs import StepGraphs

    config = load_config(config_path)
    config["model"]["args"].update(overrides)
    model = load_model(config["model"], device="cuda")
    model.init_params(torch.Generator().manual_seed(45))
    stacked = stacked_batches(torch, config, batch, k)
    graphs = StepGraphs(model, k, model.train_step, torch.device("cuda"))

    def seeds():
        return [int(np.random.SeedSequence([45, 0, model.step + i]).generate_state(1)[0])
                for i in range(k)]

    graphs(stacked, seeds())  # warm-up: the key's eager dispatch (state made, no sync)
    torch.cuda.synchronize()
    start = snapshot(model)

    def eager():
        restore(torch, model, start)
        before = launch_counts()
        for i, seed in enumerate(seeds()):
            model.train_step({n: v[i] for n, v in stacked.items()},
                             torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        counts = {n: c - before[n] for n, c in launch_counts().items()}
        return snapshot(model)[0], counts

    eager1, eager_counts = eager()
    restore(torch, model, start)
    key_seeds = seeds()
    graphs(stacked, key_seeds)
    torch.cuda.synchronize()
    graphed = snapshot(model)[0]
    entry = next(iter(graphs.graphs.values()))
    worst, differ = state_diff(torch, graphed, eager1)
    # Two eager runs, compared only where the graph differs: the steps' own nondeterminism.
    eager2 = eager()[0] if worst > 0 else eager1
    noise, _ = state_diff(torch, eager1, eager2)
    out = {"max_abs_diff": worst, "eager_repeat_max_abs_diff": noise,
           "graphs": len(graphs.graphs), "launches_per_replay": entry.launches,
           "eager_launches": eager_counts, "step": model.step}
    print(f"  {label}: k={k}, graph against eager max |diff| {worst:.3e} over "
          f"{len(graphed)} state tensors ({len(differ)} differ); "
          f"{len(graphs.graphs)} graph(s); launches per replay "
          f"{ {n: c for n, c in entry.launches.items() if c} } (eager "
          f"{ {n: c for n, c in eager_counts.items() if c} })", flush=True)
    if entry.launches != eager_counts:
        fail(f"[45] {label}: a replay counts {entry.launches}, k eager steps {eager_counts}")
    if worst > 0:
        # As JAX's test_ddpm_trainer_unroll_gated_matches_plain reasons: the moments
        # (linear in the gradients) tightly, the rest (weights, EMA weights, buffers) by
        # its update's norm; the EMA flags are the branch tuple, the same by construction.
        errs = {"moments": {}, "updates": {}}
        for n in differ:
            ref, got, was = eager1[n].double(), graphed[n].double(), start[0][n].double()
            if "exp_avg" in n:
                errs["moments"][n] = float(((got - ref).abs() / (1 + ref.abs())).max())
            else:
                step = float((ref - was).norm())
                errs["updates"][n] = float((got - ref).norm()) / max(step, 1e-30)
        for kind, tol in (("moments", GRAPH_MOMENT_TOL), ("updates", GRAPH_UPDATE_TOL)):
            if errs[kind]:
                n = max(errs[kind], key=errs[kind].get)
                print(f"    {kind}: {len(errs[kind])} differ, worst {errs[kind][n]:.3e} "
                      f"({n}; tol {tol})", flush=True)
                if errs[kind][n] > tol:
                    fail(f"[45] {label}: {n} differs from the eager steps by "
                         f"{errs[kind][n]:.3e}")
        first = sorted(set(differ) & set(state_diff(torch, eager1, eager2)[1]))
        print(f"    not bit-identical; two eager runs differ by {noise:.3e} in "
              f"{len(state_diff(torch, eager1, eager2)[1])} tensors: "
              f"{'the steps own nondeterminism' if noise > 0 else 'the graph'}"
              f"{f' (e.g. {first[:3]})' if first else ''}", flush=True)
        out["differ"] = {k: len(v) for k, v in errs.items()}
    del graphs, model
    torch.cuda.empty_cache()
    return out


def graphs_against_eager(torch) -> dict:
    """[45] for every case of ``graph_cases`` with cuDNN's deterministic algorithms: by
    default its backward may sum with atomics, and two eager runs then differ by as much
    as the graph does (DDPM's last conv, WGAN-GP's penalty through Adam's first steps)."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, config, overrides, batch, k in graph_cases():
            out[label] = graph_against_eager(torch, label, config, overrides, batch, k)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def adam_bf16_card_vs_cpu(torch) -> float:
    """[46]: three steps of the bf16-moment Adam (f32 weights) on the card and on the CPU
    from the same weights and gradients: the weights within ADAM_CARD_TOL, the bf16
    moments bit for bit or one bf16 step apart."""
    from lightning_generative_models_tpu_torch.train.state import Adam

    gen = torch.Generator().manual_seed(46)
    shapes = [(64, 3, 3, 3), (257,), (128, 64)]
    weights = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 1e-2 for s in shapes] for _ in range(3)]
    params, opts = {}, {}
    for dev in ("cpu", "cuda"):
        params[dev] = [w.clone().to(dev).requires_grad_() for w in weights]
        opts[dev] = Adam(params[dev], 2e-4, 0.9, 0.99, mu_dtype="bfloat16",
                         nu_dtype="bfloat16")
        for step in grads:
            for p, g in zip(params[dev], step):
                p.grad = g.to(dev)
            opts[dev].step()
    err = max(float((a.detach() - b.detach().cpu()).abs().max())
              for a, b in zip(params["cpu"], params["cuda"]))
    for p_cpu, p_gpu in zip(params["cpu"], params["cuda"]):
        for key in ("exp_avg", "exp_avg_sq"):
            a, b = opts["cpu"].state[p_cpu][key], opts["cuda"].state[p_gpu][key].cpu()
            if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
                fail(f"[46] Adam's {key} is {a.dtype} / {b.dtype}, not bfloat16")
            ulp = (a.float().abs() * 2.0**-7).clamp(min=1e-30)
            if bool(((a.float() - b.float()).abs() > ulp).any()):
                fail(f"[46] the bf16 {key} differs card against CPU by more than a bf16 step")
    print(f"  bf16-moment Adam, 3 steps, card against CPU: weights max |diff| {err:.3e} "
          f"(tol {ADAM_CARD_TOL}), moments within a bf16 step", flush=True)
    if err > ADAM_CARD_TOL:
        fail(f"[46] the bf16-moment Adam step differs card against CPU by {err:.3e}")
    return err


def logged_steps(k: int, start: int, stop: int, every: int = 50) -> list:
    """The steps a run of k-step dispatches from ``start`` to ``stop`` logs (the trainer's
    ``crossed`` cadence, the first step and the last)."""
    out, step = [], start
    while step < stop:
        nxt = step + k
        if every > 0 and step // every != nxt // every or step == 0 or nxt >= stop:
            out.append(step)
        step = nxt
    return out


def check_profile_trace(run_dir: Path) -> dict:
    """[46]: the run's one chrome trace under profile/ names kernels #1 and #2 (the
    window's dispatches are graph replays)."""
    traces = sorted((run_dir / "profile").glob("*.json"))
    text = traces[0].read_text() if len(traces) == 1 else ""
    named = {g: sum(text.count(m) for m in PROFILE_GROUPS[g]) for g in list(PROFILE_GROUPS)[:2]}
    print(f"  profile: {[t.name for t in traces]}, {len(text) / 1e6:.1f} MB; mentions of "
          f"#1 {list(named.values())[0]}, of #2 {list(named.values())[1]}", flush=True)
    if len(traces) != 1 or not all(named.values()):
        fail("[46] the --profile_steps trace is missing or does not name kernels #1 and #2")
    return {"files": [t.name for t in traces], "mentions": list(named.values())}


def ddpm_unroll_path(torch, card: str) -> dict:
    """[46]: the train entry point on ddpm_cifar10.json (DDPM_UNROLL_DERIVED: its grid by
    DDIM-50) at full width, bs128 bf16, with DDPM_UNROLL_FLAGS for DDPM_UNROLL_STEPS steps, then a --resume with the same flags to
    + DDPM_UNROLL_RESUME: kernels #1 and #2 counted per replay (6 a step each, as eager),
    the logging cadence, bf16 moments in the checkpoint, the profiler's trace naming #1 and
    #2, and a resume with float32 moments refused."""
    from lightning_generative_models_tpu_torch import train
    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.train import trainer as trainer_mod
    from lightning_generative_models_tpu_torch.train.state import (
        set_default_mu_dtype,
        set_default_nu_dtype,
    )
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run_dir = EXPERIMENT_DIR / "DDPM" / DDPM_UNROLL_RUN
    shutil.rmtree(run_dir, ignore_errors=True)
    config = json.loads(DDPM_UNROLL_CONFIG.read_text())
    config["model"]["args"]["sampling_timesteps"] = DDIM_STEPS
    DDPM_UNROLL_DERIVED.parent.mkdir(parents=True, exist_ok=True)
    DDPM_UNROLL_DERIVED.write_text(json.dumps(config, indent=4) + "\n")
    val_batches = len(list(DataModule(**load_config(DDPM_UNROLL_CONFIG)["dataset"])
                           .val_batches()))
    argv = ["--config_path", str(DDPM_UNROLL_DERIVED), "--device", "cuda", "--experiment_name",
            DDPM_UNROLL_RUN, "--check_val_every_n_epoch", "1000", "--sample_every_n_steps",
            "0"] + DDPM_UNROLL_FLAGS
    made = []
    base = trainer_mod.StepGraphs

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    trainer_mod.StepGraphs = Recorded
    out = {}
    try:
        total = DDPM_UNROLL_STEPS + DDPM_UNROLL_RESUME
        for name, steps, extra in (("train", DDPM_UNROLL_STEPS, []),
                                   ("resume", total, ["--resume"])):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            model = train.main(argv + ["--max_steps", str(steps)] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            new = steps - (0 if name == "train" else DDPM_UNROLL_STEPS)
            graphs = made[-1].graphs
            per_replay = {n: sum(e.launches[n] for e in graphs.values()) // max(len(graphs), 1)
                          for n in LA_COUNTERS}
            # Validation: each val batch one evaluation; the grid of 64: DDIM-50.
            want = {"linear_attention": 6 * (new + val_batches + DDIM_STEPS),
                    "linear_attention_bwd": 6 * new}
            print(f"  {name}: {new} steps to step {model.step} in {wall:.1f} s on {card}; "
                  f"{len(graphs)} graph(s) of {UNROLL} steps, #1/#2 per replay "
                  f"{per_replay} (eager: {6 * UNROLL} each); launches {got['linear_attention']}"
                  f" / {got['linear_attention_bwd']} (expected {want['linear_attention']} / "
                  f"{want['linear_attention_bwd']})", flush=True)
            if per_replay != {n: 6 * UNROLL for n in LA_COUNTERS}:
                fail(f"[46] the DDPM graph counts {per_replay} launches per replay")
            if {n: got[n] for n in LA_COUNTERS} != want or model.step != steps:
                fail(f"[46] the {name} run: launches {got}, step {model.step}")
            out[name] = {"wall_s": wall, "graphs": len(graphs), "per_replay": per_replay,
                         "counts": {n: got[n] for n in LA_COUNTERS}}
            if name == "train":
                out["trace"] = check_profile_trace(run_dir)
    finally:
        trainer_mod.StepGraphs = base
        set_default_mu_dtype(None)
        set_default_nu_dtype(None)
    records = [r for r in read_metrics(run_dir) if "train_loss" in r]
    want_steps = (logged_steps(UNROLL, 0, DDPM_UNROLL_STEPS)
                  + logged_steps(UNROLL, DDPM_UNROLL_STEPS, total))
    print(f"  logged train steps {[r['step'] for r in records]} (expected {want_steps}); "
          f"losses {[round(r['train_loss'], 4) for r in records]}", flush=True)
    if [r["step"] for r in records] != want_steps:
        fail("[46] the unrolled DDPM run's logging cadence")
    if not all(r["train_loss"] == r["train_loss"] for r in records):
        fail("[46] a train loss is not finite")
    state = torch.load(run_dir / "checkpoints" / "last", map_location="cpu", weights_only=True)
    dtypes = {str(s[k].dtype) for s in state["optimizer"]["state"].values()
              for k in ("exp_avg", "exp_avg_sq")}
    print(f"  the checkpoint's Adam moments: {sorted(dtypes)}", flush=True)
    if dtypes != {"torch.bfloat16"}:
        fail(f"[46] the checkpoint's moments are {dtypes}")
    # On a copy: the entry point writes its args.json (generate reads the dtypes there).
    refused = f"{DDPM_UNROLL_RUN}_f32_resume"
    shutil.rmtree(run_dir.parent / refused, ignore_errors=True)
    shutil.copytree(run_dir, run_dir.parent / refused)
    f32_argv = [a for a in argv if a not in ("bfloat16", "--mu_dtype", "--nu_dtype")]
    f32_argv[f32_argv.index(DDPM_UNROLL_RUN)] = refused
    try:
        train.main(f32_argv + ["--max_steps", str(total + UNROLL), "--resume"])
        fail("[46] a resume with float32 moments from a bf16-moment checkpoint trained")
    except ValueError as e:
        print(f"  resume with float32 moments refused: {e}", flush=True)
    shutil.rmtree(run_dir.parent / refused, ignore_errors=True)
    out["adam_card_vs_cpu"] = adam_bf16_card_vs_cpu(torch)
    return out


def dcgan_unroll_path(torch, card: str) -> dict:
    """[46]: DCGAN (dcgan_cifar10.json, full width, bs128 bf16) with --unroll_steps 4:
    train, resume, generate; every kernel counter 0."""
    from lightning_generative_models_tpu_torch import generate, train
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    run_dir = EXPERIMENT_DIR / "DCGAN" / DCGAN_UNROLL_RUN
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--config_path", str(DCGAN_CONFIG), "--device", "cuda", "--experiment_name",
            DCGAN_UNROLL_RUN, "--unroll_steps", str(UNROLL), "--sample_every_n_steps", "0"]
    total = DCGAN_UNROLL_STEPS + DCGAN_UNROLL_RESUME
    zero_counts()
    walls = {}
    for name, steps, extra in (("train", DCGAN_UNROLL_STEPS, []), ("resume", total, ["--resume"])):
        t0 = time.perf_counter()
        model = train.main(argv + ["--max_steps", str(steps)] + extra)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if model.step != steps:
            fail(f"[46] the DCGAN {name} run ended at step {model.step}")
    images = generate.main(["--config_path", str(DCGAN_CONFIG), "--device", "cuda",
                            "--experiment_name", DCGAN_UNROLL_RUN, "--num_samples", "64",
                            "--out", str(OUT_DIR / "dcgan_unroll")])
    records = [r for r in read_metrics(run_dir) if "train_g_loss" in r]
    counts = read_counts()
    print(f"  DCGAN --unroll_steps {UNROLL}: train {DCGAN_UNROLL_STEPS} in {walls['train']:.1f} s,"
          f" resume to {total} in {walls['resume']:.1f} s; logged steps "
          f"{[r['step'] for r in records]}; generate {images.shape}; counters {counts}",
          flush=True)
    if any(counts.values()) or not (images.min() >= 0 and images.max() <= 1):
        fail("[46] the unrolled DCGAN path launched a kernel or sampled out of [0, 1]")
    if not all(r["train_g_loss"] == r["train_g_loss"] for r in records):
        fail("[46] a DCGAN loss is not finite")
    return walls


def registry_runs() -> list:
    """[46]: (registry name, config, experiment) of every trainable registry name but the
    two unrolled above: the runs of [6], [10], [15], [21], [27], [31]-[33], [36] and [41]."""
    runs = [("DDPM", CONFIG, TRAIN_RUN), ("DDPM (DiT)", DIT_CONFIG, DIT_RUN),
            ("DDPM (DiT-MoE)", DIT_MOE_CONFIG, DIT_MOE_RUN),
            ("FlowMatching", FM_CONFIG, FM_RUN), ("VQVAE", VQVAE_CONFIG, "chip_smoke_vqvae"),
            ("VQGAN", VQGAN_CONFIG, "chip_smoke_vqgan")]
    for path in derive_gan_configs():
        name = json.loads(path.read_text())["model"]["name"]
        runs.append((name, path, f"chip_smoke_{path.stem}"))
    runs += [(p.model, p.config, p.run) for p in SLICE_PATHS.values()]
    runs += [(p.model, p.resume_config, p.run) for p in latent_paths(derive_latent_configs())]
    runs += [("VAE", VAE_CONFIG, "chip_smoke_vae"),
             ("VQGAN (LPIPS)", VQGAN_LPIPS_CONFIG, "chip_smoke_vqgan_lpips")]
    runs += [(json.loads(p.read_text())["model"]["name"], p, f"chip_smoke_{name.lower()}")
             for name, p in derive_family_configs().items()]
    return runs


def unrolled_dispatches(torch, card: str) -> dict:
    """[46]: every name of ``registry_runs`` from its run's last checkpoint (its resume
    leg's; fresh weights where there is none): NAME_DISPATCHES dispatches of the trainer
    at --unroll_steps NAME_UNROLL (the first of a branch tuple eager, the second captured
    and replayed: every name's next 4 steps are of one tuple); per name whether it
    captured, its graphs and its launches per replay."""
    import gc

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import (
        DataModule,
        PairedDataModule,
    )
    from lightning_generative_models_tpu_torch.registry import load_model
    from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
    from lightning_generative_models_tpu_torch.train.trainer import Trainer
    from lightning_generative_models_tpu_torch.utils.path import EXPERIMENT_DIR

    out, failed = {}, []
    for name, config_path, run in registry_runs():
        t0 = time.perf_counter()
        config = load_config(config_path)
        model_name = config["model"]["name"]
        paired = config["dataset"].pop("paired", None)
        paired = model_name.lower() == "cyclegan" if paired is None else paired
        label = f"{name} ({Path(config_path).name})"
        try:
            model = load_model(config["model"], device="cuda")
            ckpt = CheckpointManager(EXPERIMENT_DIR / model_name / run / "checkpoints")
            restored = ckpt.has_checkpoint("last")
            if restored:
                ckpt.restore(model, "last")
            dm = (PairedDataModule if paired else DataModule)(**config["dataset"])
            trainer = Trainer(model, dm, OUT_DIR / "unrolled" / run, unroll_steps=NAME_UNROLL)
            trainer.global_step = model.step
            start = model.step
            batches = trainer._train_batches(0)
            zero_counts()
            for _ in range(NAME_DISPATCHES):
                metrics = trainer._dispatch(next(batches))
                trainer.global_step += NAME_UNROLL
            torch.cuda.synchronize()
            graphs = trainer._graphs.graphs
            finite = all(bool(torch.isfinite(v).all()) for v in metrics.values())
            per_replay = {k: v for e in graphs.values() for k, v in e.launches.items() if v}
            out[label] = {"captured": bool(graphs), "graphs": len(graphs),
                          "launches_per_replay": per_replay, "from_step": start,
                          "restored": restored, "wall_s": time.perf_counter() - t0}
            print(f"  {label}: from step {start} ({'restored' if restored else 'fresh'}), "
                  f"{'captured' if graphs else 'NOT captured'}, {len(graphs)} graph(s), "
                  f"launches per replay {per_replay}, metrics finite {finite}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if not graphs or not finite or model.step != start + NAME_DISPATCHES * NAME_UNROLL:
                failed.append(label)
        except Exception as e:  # noqa: BLE001 - every name is tried, then the phase fails
            print(f"  {label}: FAILED: {type(e).__name__}: {e}", flush=True)
            out[label] = {"captured": False, "error": f"{type(e).__name__}: {e}"}
            failed.append(label)
        finally:
            model = trainer = None
            gc.collect()
            torch.cuda.empty_cache()
    if failed:
        fail(f"[46] unrolled dispatches failed for {failed}")
    return out


def unroll_throughput(torch, card: str, repeats: int = 3) -> dict:
    """[47]: DDPM (ddpm_cifar10) and DCGAN (dcgan_cifar10) at bs128 bf16 through the
    trainer's dispatch at --unroll_steps 1 and UNROLL, interleaved, ``repeats`` timings of
    THROUGHPUT_STEPS steps each (host clock around work that ends in a synchronize); then
    one dispatch's worth of steps under torch.profiler: device-busy time a step
    (exclusive_kernel_us), kernel launches and CUDA runtime calls a step."""
    from torch.profiler import ProfilerActivity, profile

    from lightning_generative_models_tpu_torch.config import load_config
    from lightning_generative_models_tpu_torch.data.datamodule import DataModule
    from lightning_generative_models_tpu_torch.registry import load_model
    from lightning_generative_models_tpu_torch.train.trainer import Trainer

    out = {}
    for label, path in (("DDPM", DDPM_UNROLL_CONFIG), ("DCGAN", DCGAN_CONFIG)):
        config = load_config(path)
        model = load_model(config["model"], device="cuda")
        dm = DataModule(**config["dataset"])
        trainers = {k: Trainer(model, dm, OUT_DIR / "throughput", unroll_steps=k)
                    for k in (1, UNROLL)}
        if hasattr(model, "ema_update_after_step"):
            model.step = model.ema_update_after_step  # past the EMA's hard copy
        stacked = stacked_batches(torch, config, TRAIN_BATCH, UNROLL)
        single = {n: v[0] for n, v in stacked.items()}

        def run(k, steps):
            trainer = trainers[k]
            for _ in range(steps // k):
                trainer.global_step = model.step
                trainer._dispatch(stacked if k > 1 else single)
            torch.cuda.synchronize()

        run(1, UNROLL)  # warm-up: the eager step's
        run(UNROLL, 40)  # every branch tuple's eager dispatch, then its capture
        walls = {1: [], UNROLL: []}
        for _ in range(repeats):
            for k in (1, UNROLL):
                t0 = time.perf_counter()
                run(k, THROUGHPUT_STEPS)
                walls[k].append(time.perf_counter() - t0)
        res = {}
        for k in (1, UNROLL):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(k, UNROLL)
            kernels = exclusive_kernel_us(torch, prof)
            busy_us = sum(us for us, _ in kernels.values())
            launches = sum(c for _, c in kernels.values())
            host_calls = sum(1 for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CPU
                             and e.name.startswith("cu"))
            wall = statistics.median(walls[k])
            res[k] = {"ms_per_step": 1e3 * wall / THROUGHPUT_STEPS,
                      "images_per_s": THROUGHPUT_STEPS * TRAIN_BATCH / wall,
                      "walls_s": [round(w, 4) for w in walls[k]],
                      "busy_ms_per_step": busy_us / 1e3 / UNROLL,
                      "launches_per_step": launches / UNROLL,
                      "host_calls_per_step": host_calls / UNROLL,
                      "graphs": len(trainers[k]._graphs.graphs) if k > 1 else 0}
            print(f"  {label} bs{TRAIN_BATCH} bf16, unroll {k}: {res[k]['ms_per_step']:.2f} ms a "
                  f"step (median of {res[k]['walls_s']} s per {THROUGHPUT_STEPS} steps), "
                  f"{res[k]['images_per_s']:.1f} images/s, device busy "
                  f"{res[k]['busy_ms_per_step']:.2f} ms a step, {res[k]['launches_per_step']:.0f}"
                  f" launches and {res[k]['host_calls_per_step']:.0f} CUDA runtime calls a step"
                  f" (profiled), {res[k]['graphs']} graph(s), on {card}", flush=True)
        out[label] = res
        del trainers, model
        torch.cuda.empty_cache()
    return out


def interpolation_cases() -> list:
    """[48]: (label, model name, small-width args) of the four processes, f32."""
    tiny = {"img_size": 32, "dim": 64, "dim_mults": [1, 2], "use_bf16": False}
    return [("GaussianDiffusion", "DDPM", {**tiny, "diffusion_timesteps": 20}),
            ("RectifiedFlow", "FlowMatching", {**tiny, "sampling_steps": 6}),
            ("EDMProcess", "EDM", {**tiny, "sampling_steps": 5, "s_churn": 10.0}),
            ("ConsistencyProcess", "ConsistencyModel", tiny)]


def interpolation_card_vs_cpu(torch) -> dict:
    """[48]: each process's interpolate through its model's, card against CPU, the same
    weights and explicit draws (the two noises, the chain's or the churn's per-step noise),
    per-sample lambdas: within INTERP_TOL of 1 + |ref|."""
    from lightning_generative_models_tpu_torch.registry import load_model

    out = {}
    for label, name, args in interpolation_cases():
        models = {dev: load_model({"name": name, "args": args}, device=dev)
                  for dev in ("cpu", "cuda")}
        models["cpu"].init_params(torch.Generator().manual_seed(48))
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        gen = torch.Generator().manual_seed(480)
        shape = (4, 32, 32, 3)
        x1, x2 = torch.rand(shape, generator=gen), torch.rand(shape, generator=gen)
        draws = {"noise1": torch.randn(shape, generator=gen),
                 "noise2": torch.randn(shape, generator=gen)}
        steps = [torch.randn(shape, generator=gen) for _ in range(20)]
        if name in ("DDPM", "EDM"):
            draws["noise_fn"] = lambda i, s: steps[i]
        lam = torch.linspace(0, 1, 4).reshape(4, 1, 1, 1)
        res = {dev: m.interpolate(x1, x2, None, lam=lam, **draws).float().cpu()
               for dev, m in models.items()}
        err = float(((res["cuda"] - res["cpu"]).abs() / (1 + res["cpu"].abs())).max())
        print(f"  {label} ({name}, dim 64, dim_mults (1, 2), f32): card against CPU {err:.3e} "
              f"(tol {INTERP_TOL})", flush=True)
        if err > INTERP_TOL or not torch.isfinite(res["cuda"]).all():
            fail(f"[48] {label}'s interpolate differs card against CPU by {err:.3e}")
        out[label] = err
    return out


def interpolation_paths(torch, card: str) -> dict:
    """[48]: generate --interpolate INTERP_N on [6]'s DDPM run (ddim_cifar10: the ends by
    DDIM-50, then 999 ancestral evaluations, #1 counted: 6 an evaluation) and on the
    FM-DiT flash, EDM and CT runs of [21], [31] and [32]; every grid finite in [0, 1]."""
    import numpy as np

    from lightning_generative_models_tpu_torch import generate

    out = {}
    for label, config, run, want in (
            ("DDPM", CONFIG, TRAIN_RUN, 6 * (DDIM_STEPS + 999)),
            ("FlowMatching", FM_CONFIG, FM_RUN, None),
            ("EDM", EDM_CONFIG, SLICE_PATHS["edm"].run, None),
            ("ConsistencyModel", CT_CONFIG, SLICE_PATHS["ct"].run, None)):
        zero_counts()
        t0 = time.perf_counter()
        images = generate.main(["--config_path", str(config), "--device", "cuda",
                                "--experiment_name", run, "--interpolate", str(INTERP_N),
                                "--out", str(OUT_DIR / "interpolate" / label)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        pngs = sorted((OUT_DIR / "interpolate" / label).glob("interpolation_last_step*.png"))
        print(f"  {label}: generate --interpolate {INTERP_N} {images.shape} in {wall:.1f} s, "
              f"launches {counts}, {[p.name for p in pngs]} on {card}", flush=True)
        if images.shape[0] != INTERP_N or not pngs or not (
                np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1):
            fail(f"[48] generate --interpolate on {run} wrote no grid in [0, 1]")
        if want is not None and counts.get("linear_attention") != want:
            fail(f"[48] {label}'s interpolation launched #1 {counts} times, not {want}")
        out[label] = {"wall_s": wall, "launches": counts}
    return out


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
    from lightning_generative_models_tpu_torch.ops import attention as ta
    from lightning_generative_models_tpu_torch.ops import cuda_build
    from lightning_generative_models_tpu_torch.ops import linear_attention as la
    from lightning_generative_models_tpu_torch.ops import preprocess as pp
    from lightning_generative_models_tpu_torch.ops import vq

    started = time.perf_counter()
    print("[1] build", flush=True)
    t0 = time.perf_counter()
    logs = cuda_build.build(["linear_attention", "linear_attention_bwd", "vq", "attention_qkv",
                             "attention_qkv_bwd", "flash_attention", "preprocess"], verbose=True)
    print(f"  built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Performance Loss")):
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
    print(f"  phases 1-7 took {time.perf_counter() - started:.1f} s", flush=True)

    print("[8] VQ codebook search (kernel #6) against its plain version", flush=True)
    with torch.inference_mode():
        vq_stats = check_vq(torch, vq)

    print("[9] VQ models, card against CPU", flush=True)
    check_vq_models(torch)

    print(f"[10] VQ training path: {VQVAE_CONFIG.name} {VQ_STEPS} steps + resume, the EMA "
          f"codebook, {VQGAN_CONFIG.name} with disc_start {VQGAN_DISC_START}; generate",
          flush=True)
    vq_counts = vq_main_path(torch, vq, card)

    print("[11] VQ-VAE train throughput and where the time goes", flush=True)
    vq_train_stats = vq_train_breakdown(torch, vq, card)
    print(f"  phases 1-11 took {time.perf_counter() - started:.1f} s", flush=True)

    print("[12] packed-qkv attention (kernels #3, #4) against their plain versions",
          flush=True)
    attn_stats = check_attention(torch, ta)

    print("[13] DiT-S/2, card against CPU", flush=True)
    check_dit_card_vs_cpu(torch)

    print(f"[14] DiT sampling path: generate DDIM-{DDIM_STEPS} guided bs{DIT_BATCH} bf16",
          flush=True)
    dit_gen_counts = transformer_generate_path(torch, card, DIT_PATH)

    print(f"[15] DiT training path: train {DIT_TRAIN_STEPS} steps bs{TRAIN_BATCH} bf16, then "
          f"resume", flush=True)
    dit_counts = transformer_train_path(torch, card, DIT_PATH)

    print("[16] DiT train and sampling throughput, where the time goes", flush=True)
    dit_stats = transformer_breakdown(torch, card, DIT_PATH)
    print(f"  phases 1-16 took {time.perf_counter() - started:.1f} s", flush=True)

    derive_fm_flash_config()
    print("[17] flash attention (kernel #5) and its backward route against their plain "
          "versions", flush=True)
    flash_stats = check_flash_attention(torch, ta)

    print("[18] preprocess (kernel #7) against its plain version; prepare_batch(backend="
          "'pallas')", flush=True)
    pre_stats = check_preprocess(torch, pp)

    print(f"[19] FlowMatching DiT-S/2 with flash attention ({FM_CONFIG.name}), card against "
          f"CPU", flush=True)
    check_fm_card_vs_cpu(torch)

    print(f"[20] FM-DiT flash sampling path: generate {FM_PATH.sampler} bs{DIT_BATCH} bf16",
          flush=True)
    fm_gen_counts = transformer_generate_path(torch, card, FM_PATH)

    print(f"[21] FM-DiT flash training path: train {FM_TRAIN_STEPS} steps bs{TRAIN_BATCH} "
          f"bf16, then resume", flush=True)
    fm_counts = transformer_train_path(torch, card, FM_PATH)

    print("[22] FM-DiT flash train and sampling throughput, where the time goes", flush=True)
    fm_stats = transformer_breakdown(torch, card, FM_PATH)
    print(f"  phases 1-22 took {time.perf_counter() - started:.1f} s", flush=True)

    print("[23] DCGAN (dcgan_cifar10.json), card against CPU, f32", flush=True)
    check_dcgan_card_vs_cpu(torch)

    print(f"[24] DCGAN training path: train {DCGAN_STEPS} steps bs{TRAIN_BATCH} bf16, then "
          f"resume; generate", flush=True)
    dcgan_counts = dcgan_train_path(torch, card)

    print("[25] DCGAN train throughput and where the time goes", flush=True)
    dcgan_stats = dcgan_breakdown(torch, card)
    print(f"  phases 1-25 took {time.perf_counter() - started:.1f} s", flush=True)

    print("[26] the GAN family at its configs' widths, card against CPU, f32", flush=True)
    check_gan_family_card_vs_cpu(torch)

    print(f"[27] GAN-family entry points: train {GAN_STEPS} steps, resume to "
          f"{GAN_STEPS + GAN_RESUME_STEPS}, generate (CycleGAN: translate)", flush=True)
    gan_walls, gan_counts = gan_family_entry_points(torch, card)

    print("[28] WGAN-GP CIFAR-10 train throughput and where the time goes", flush=True)
    wgan_stats = wgan_breakdown(torch, card)
    print(f"  phases 1-28 took {time.perf_counter() - started:.1f} s", flush=True)

    print("[29] kernels #1, #2 and #6 at the slice's new shapes against their plain versions",
          flush=True)
    t_slice = time.perf_counter()
    t0 = time.perf_counter()
    latent_stats = check_latent_kernel_shapes(torch, la, vq)
    print(f"  [29] took {time.perf_counter() - t0:.1f} s", flush=True)

    print("[30] the slice at its configs' widths, card against CPU, f32", flush=True)
    check_slice_card_vs_cpu(torch)

    slice_runs = {}
    for key, phase, what in (("edm", 31, "Heun-18"), ("ct", 32, "multistep and onestep")):
        path = SLICE_PATHS[key]
        print(f"[{phase}] {path.name} path ({path.config.name}): train {path.steps} steps "
              f"bs{TRAIN_BATCH} bf16, resume to {path.steps + path.resume_steps}, generate "
              f"{what} bs64", flush=True)
        t0 = time.perf_counter()
        slice_runs[key] = slice_train_path(torch, card, path)
        print(f"  [{phase}] took {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[33] the latent paths on {AE_RUN}'s autoencoder (LDM, LEDM, LFM), then VAE and "
          f"VQGAN with LPIPS: train, resume, generate", flush=True)
    t0 = time.perf_counter()
    latent_configs = derive_latent_configs()
    for path in latent_paths(latent_configs):
        slice_runs[path.model] = slice_train_path(torch, card, path)
        check_resume_restores_autoencoder(torch, slice_runs[path.model]["model"])
    for path in (SlicePath("VAE", VAE_CONFIG, "VAE", "chip_smoke_vae", VAE_STEPS,
                           VAE_RESUME_STEPS, 0, 0, [([], 0)]),
                 SlicePath("VQGAN-LPIPS", VQGAN_LPIPS_CONFIG, "VQGAN", "chip_smoke_vqgan_lpips",
                           LPIPS_STEPS, LPIPS_RESUME_STEPS, 0, 0, [([], 0)], vq_step=1)):
        slice_runs[path.name] = slice_train_path(torch, card, path)
    print(f"  [33] took {time.perf_counter() - t0:.1f} s", flush=True)

    print("[34] the slice's throughput and where the time goes", flush=True)
    t0 = time.perf_counter()
    slice_stats = {
        "edm_train": train_breakdown(torch, card, steps=10, repeats=2, config_path=EDM_CONFIG,
                                     out_name="edm_train_profile.txt"),
        "edm_heun18": sample_breakdown(torch, card, EDM_CONFIG, "EDM Heun-18",
                                       "edm_sample_profile.txt", repeats=2),
        "ct_train": train_breakdown(torch, card, steps=10, repeats=2, config_path=CT_CONFIG,
                                    out_name="ct_train_profile.txt"),
        "ldm_train": train_breakdown(torch, card, steps=10, repeats=2,
                                     config_path=latent_configs["ldm"][1],
                                     out_name="ldm_train_profile.txt"),
    }
    print(f"  [34] took {time.perf_counter() - t0:.1f} s; phases 29-34 took "
          f"{time.perf_counter() - t_slice:.1f} s", flush=True)

    print("[35] DAE, the UNet autoencoder, PixelCNN, NICE and Glow at their configs' widths, "
          "card against CPU, f32", flush=True)
    t_families = time.perf_counter()
    check_families_card_vs_cpu(torch)
    print(f"[36] their entry points: train {FAMILY_STEPS} steps, resume to "
          f"{FAMILY_STEPS + FAMILY_RESUME_STEPS}, generate 64", flush=True)
    t0 = time.perf_counter()
    family_configs = derive_family_configs()
    family_walls = {name: family_entry_path(torch, card, name, path)
                    for name, path in family_configs.items()}
    print(f"  [36] took {time.perf_counter() - t0:.1f} s", flush=True)
    print("[37] Glow and PixelCNN throughput and where the time goes", flush=True)
    t0 = time.perf_counter()
    family_stats = family_breakdown(torch, card, family_configs)
    print(f"  [37] took {time.perf_counter() - t0:.1f} s; phases 35-37 took "
          f"{time.perf_counter() - t_families:.1f} s", flush=True)

    print(f"[38] InceptionV3 at 299 x 299 bs{INCEPTION_BATCH}, card against CPU, f32; "
          "metrics.verify on the card", flush=True)
    t_metrics = t0 = time.perf_counter()
    inception_stats = check_inception_card_vs_cpu(torch)
    print(f"  [38] took {time.perf_counter() - t0:.1f} s", flush=True)
    print("[39] kernels #3 and #4 at the DiT-MoE shape against their plain versions",
          flush=True)
    moe_attn_stats = check_attention(torch, ta, cases=[MOE_ATTN_CASE], main_case=MOE_ATTN_CASE)
    print(f"[40] DiT-MoE ({DIT_MOE_CONFIG.name}) at full width, card against CPU, f32, "
          f"routes replayed", flush=True)
    t0 = time.perf_counter()
    moe_card_stats = check_dit_moe_card_vs_cpu(torch)
    print(f"  [40] took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[41] DiT-MoE paths: generate DDIM-{DDIM_STEPS} guided bs{DIT_BATCH}, train "
          f"{DIT_MOE_TRAIN_STEPS} steps bs{TRAIN_BATCH} bf16, then resume", flush=True)
    t0 = time.perf_counter()
    moe_counts = dit_moe_paths(torch, card)
    print(f"  [41] took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[42] generate --fid {FID_N} on {DCGAN_RUN} (DCGAN CIFAR-10); FID card against "
          f"CPU", flush=True)
    t0 = time.perf_counter()
    fid_stats = fid_path(torch, card)
    print(f"  [42] took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[43] DCGAN with calculate_metrics through a validation, then --eval test",
          flush=True)
    t0 = time.perf_counter()
    gan_metrics_stats = gan_metrics_path(torch, card)
    print(f"  [43] took {time.perf_counter() - t0:.1f} s", flush=True)
    print("[44] DiT-MoE and InceptionV3 throughput and where the time goes", flush=True)
    t0 = time.perf_counter()
    moe_stats = moe_breakdown(torch, card)
    print(f"  [44] took {time.perf_counter() - t0:.1f} s; phases 38-44 took "
          f"{time.perf_counter() - t_metrics:.1f} s", flush=True)

    print(f"[45] {UNROLL}-step CUDA graphs against {UNROLL} eager steps from one state",
          flush=True)
    t_unroll = t0 = time.perf_counter()
    graph_stats = graphs_against_eager(torch)
    print(f"  [45] took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[46] {DDPM_UNROLL_CONFIG.name} through the CLI with {' '.join(DDPM_UNROLL_FLAGS)}; "
          f"DCGAN --unroll_steps {UNROLL}; every other registry name's unrolled dispatches",
          flush=True)
    t0 = time.perf_counter()
    ddpm_unroll = ddpm_unroll_path(torch, card)
    dcgan_unroll = dcgan_unroll_path(torch, card)
    name_unroll = unrolled_dispatches(torch, card)
    print(f"  [46] took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[47] throughput at --unroll_steps 1 and {UNROLL}: DDPM and DCGAN bs{TRAIN_BATCH} "
          "bf16", flush=True)
    t0 = time.perf_counter()
    unroll_stats = unroll_throughput(torch, card)
    print(f"  [47] took {time.perf_counter() - t0:.1f} s", flush=True)
    print("[48] interpolation: the four processes card against CPU; generate --interpolate "
          f"{INTERP_N}", flush=True)
    t0 = time.perf_counter()
    interp_stats = {"card_vs_cpu": interpolation_card_vs_cpu(torch),
                    "generate": interpolation_paths(torch, card)}
    print(f"  [48] took {time.perf_counter() - t0:.1f} s; phases 45-48 took "
          f"{time.perf_counter() - t_unroll:.1f} s", flush=True)
    print(f"  all phases took {time.perf_counter() - started:.1f} s", flush=True)
    slice_counts = {f"{key}_{run}": got for key, res in slice_runs.items()
                    for run, got in res["counts"].items()}

    def per_replay(case: str, counter: str) -> dict:
        return {f"{case}, {UNROLL} steps": graph_stats[case]["launches_per_replay"][counter]}

    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "launches_per_replay": per_replay("DDPM bs128 bf16", "linear_attention"),
        "source": "lightning_generative_models_tpu_torch/csrc/linear_attention.cu",
        "replaces": "lightning_generative_models_tpu/ops/linear_attention.py:173",
        "launches": launches,
        "launches_by_path": {"generate": launches,
                             "train": train_counts["train"]["forward"],
                             "resume": train_counts["resume"]["forward"]}
                            | {k: v["linear_attention"] for k, v in slice_counts.items()},
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
        "slice_shapes": latent_stats["linear_attention"]["shapes"],
        "slice_worst_rel_err": latent_stats["linear_attention"]["worst_rel_err"],
    }, {
        "name": "linear_attention_bwd",
        "route": "cuda",
        "launches_per_replay": per_replay("DDPM bs128 bf16", "linear_attention_bwd"),
        "source": "lightning_generative_models_tpu_torch/csrc/linear_attention_bwd.cu",
        "replaces": "lightning_generative_models_tpu/ops/linear_attention.py:302",
        "launches": train_counts["train"]["backward"],
        "launches_by_path": {"generate": 0,
                             "train": train_counts["train"]["backward"],
                             "resume": train_counts["resume"]["backward"]}
                            | {k: v["linear_attention_bwd"] for k, v in slice_counts.items()},
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
        "slice_shapes": latent_stats["linear_attention_bwd"]["shapes"],
        "slice_worst_rel_err": latent_stats["linear_attention_bwd"]["worst_rel_err"],
    }, {
        "name": "vq_nearest",
        "route": "cuda",
        "launches_per_replay": per_replay("VQ-VAE bs256 f32", "nearest_codes"),
        "source": "lightning_generative_models_tpu_torch/csrc/vq.cu",
        "replaces": "lightning_generative_models_tpu/ops/vq.py:23",
        "launches": vq_counts["vqvae"],
        "launches_by_path": {**vq_counts, "generate": 0}
                            | {k: v["nearest_codes"] for k, v in slice_counts.items()
                               if v["nearest_codes"]},
        "max_abs_err": vq_stats["max_abs_err"],
        "ms": vq_stats["ms"],
        "plain_ms": vq_stats["plain_ms"],
        "bound_ms": vq_stats["bound_ms"],
        "bound_by": vq_stats["bound_by"],
        "library_ms": vq_stats["library_ms"],
        "status": "ok",
        "ms_is": "one search at N=4096, K=512, D=64, f32 (vqvae_cifar10 at bs256)",
        "max_abs_err_is": "max over rows of |d(z, kernel's code) - d(z, plain's code)|",
        "library_is": "torch.addmm(|e|^2, z, e^T, alpha=-2).argmin(1)",
        "bound_is": "2 N K D flops at 165 TFLOP/s f32-accurate (3xTF32 on the tensor cores)",
        "fma_bound_ms": vq_stats["fma_ops_ms"],
        "shapes": vq_stats["shapes"] + latent_stats["vq"],
    }, {
        "name": "attention_qkv",
        "route": "cuda",
        "launches_per_replay": per_replay("DiT-S/2 bs128 bf16", "fused_attention_qkv"),
        "source": "lightning_generative_models_tpu_torch/csrc/attention_qkv.cu",
        "replaces": "lightning_generative_models_tpu/ops/attention.py:212",
        "launches": dit_gen_counts["fused_attention_qkv"],
        "launches_by_path": {"generate": dit_gen_counts["fused_attention_qkv"],
                             "train": dit_counts["train"]["fused_attention_qkv"],
                             "resume": dit_counts["resume"]["fused_attention_qkv"],
                             "fm_flash_generate": fm_gen_counts["fused_attention_qkv"],
                             "fm_flash_train": fm_counts["train"]["fused_attention_qkv"],
                             "dit_moe_generate": moe_counts["generate"]["fused_attention_qkv"],
                             "dit_moe_train": moe_counts["train"]["fused_attention_qkv"],
                             "dit_moe_resume": moe_counts["resume"]["fused_attention_qkv"]},
        "max_abs_err": attn_stats["max_abs_err"],
        "ms": attn_stats["ms"],
        "plain_ms": attn_stats["plain_ms"],
        "bound_ms": attn_stats["bound_ms"],
        "bound_by": "bytes" if attn_stats["bytes_ms"] > attn_stats["ops_ms"] else "operations",
        "library_ms": attn_stats["library_ms"],
        "status": "ok",
        "ms_is": "one call at b 128, n 256, h 6, d 64, bf16, s3hd (dit_cifar10: a train "
                 "step's and a guided bs64 evaluation's shape)",
        "library_is": "torch.nn.functional.scaled_dot_product_attention on [b, h, n, d] views",
        "shapes": [{k: v for k, v in sh.items() if not k.startswith("bwd_")}
                   for sh in attn_stats["shapes"]],
        "moe_shape": {k: v for k, v in moe_attn_stats.items()
                      if k != "shapes" and not k.startswith("bwd_")},
    }, {
        "name": "attention_qkv_bwd",
        "route": "cuda",
        "launches_per_replay": per_replay("DiT-S/2 bs128 bf16", "fused_attention_qkv_bwd"),
        "source": "lightning_generative_models_tpu_torch/csrc/attention_qkv_bwd.cu",
        "replaces": "lightning_generative_models_tpu/ops/attention.py:231",
        "launches": dit_counts["train"]["fused_attention_qkv_bwd"],
        "launches_by_path": {"generate": dit_gen_counts["fused_attention_qkv_bwd"],
                             "train": dit_counts["train"]["fused_attention_qkv_bwd"],
                             "resume": dit_counts["resume"]["fused_attention_qkv_bwd"],
                             "fm_flash_train": fm_counts["train"]["flash_attention_bwd_cuda"],
                             "fm_flash_resume": fm_counts["resume"]["flash_attention_bwd_cuda"],
                             "dit_moe_generate": moe_counts["generate"]["fused_attention_qkv_bwd"],
                             "dit_moe_train": moe_counts["train"]["fused_attention_qkv_bwd"],
                             "dit_moe_resume": moe_counts["resume"]["fused_attention_qkv_bwd"]},
        "launches_by_path_are": "its own entry in the DiT runs; in the FM-DiT flash runs the "
                                "flash path's backward route (flash_attention_bwd_cuda's count)",
        "max_abs_err": attn_stats["bwd_max_abs_err"],
        "ms": attn_stats["bwd_ms"],
        "plain_ms": attn_stats["bwd_plain_ms"],
        "bound_ms": attn_stats["bwd_bound_ms"],
        "bound_by": ("bytes" if attn_stats["bwd_bytes_ms"] > attn_stats["bwd_ops_ms"]
                     else "operations"),
        "library_ms": attn_stats["bwd_library_ms"],
        "status": "ok",
        "ms_is": "one call at b 128, n 256, h 6, d 64, bf16, s3hd (a DiT-S/2 train step "
                 "runs 12)",
        "library_is": "torch.autograd.grad through scaled_dot_product_attention (its "
                      "backward alone) on [b, h, n, d] views",
        "shapes": [{k[4:]: v for k, v in sh.items() if k.startswith("bwd_")}
                   | {k: sh[k] for k in ("b", "n", "heads", "d", "layout", "dtype")}
                   for sh in attn_stats["shapes"]],
        "moe_shape": {k[4:]: v for k, v in moe_attn_stats.items() if k.startswith("bwd_")}
                     | {k: moe_attn_stats[k] for k in ("b", "n", "heads", "d", "layout", "dtype")},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "launches_per_replay": per_replay("FM-DiT flash bs128 bf16", "flash_attention"),
        "source": "lightning_generative_models_tpu_torch/csrc/flash_attention.cu",
        "replaces": "lightning_generative_models_tpu/ops/attention.py:42",
        "launches": fm_gen_counts["flash_attention"],
        "launches_by_path": {"fm_flash_generate": fm_gen_counts["flash_attention"],
                             "fm_flash_train": fm_counts["train"]["flash_attention"],
                             "fm_flash_resume": fm_counts["resume"]["flash_attention"],
                             "dit_generate": dit_gen_counts["flash_attention"],
                             "dit_train": dit_counts["train"]["flash_attention"]},
        "max_abs_err": flash_stats["max_abs_err"],
        "ms": flash_stats["ms"],
        "plain_ms": flash_stats["plain_ms"],
        "bound_ms": flash_stats["bound_ms"],
        "bound_by": "bytes" if flash_stats["bytes_ms"] > flash_stats["ops_ms"] else "operations",
        "library_ms": flash_stats["library_ms"],
        "status": "ok",
        "ms_is": "one call at b 128, h 6, n 256, d 64, bf16, on views of the packed s3hd qkv "
                 "(FM-DiT-S/2 flash: a train step's shape; generate's rows are 64)",
        "library_is": "torch.nn.functional.scaled_dot_product_attention on the same views",
        "backward_route": {k[4:]: v for k, v in flash_stats.items() if k.startswith("bwd_")}
                          | {"launches": fm_counts["train"]["flash_attention_bwd_cuda"],
                             "entry": "lgm_attention_qkv_bwd (csrc/attention_qkv_bwd.cu)"},
        "shapes": flash_stats["shapes"],
    }, {
        "name": "preprocess",
        "route": "cuda",
        "source": "lightning_generative_models_tpu_torch/csrc/preprocess.cu",
        "replaces": "lightning_generative_models_tpu/ops/preprocess.py:81",
        "launches": pre_stats["launches"],
        "launches_by_path": {"prepare_batch_pallas": pre_stats["launches"],
                             "fm_flash_train": fm_counts["train"]["fused_normalize_flip"],
                             "dit_train": dit_counts["train"]["fused_normalize_flip"],
                             "dcgan_train": dcgan_counts["train"]["fused_normalize_flip"],
                             "gan_family": gan_counts["fused_normalize_flip"],
                             "train": train_counts["train"]["preprocess"]},
        "max_abs_err": pre_stats["max_abs_err"],
        "ms": pre_stats["ms"],
        "plain_ms": pre_stats["plain_ms"],
        "bound_ms": pre_stats["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "status": "ok",
        "ms_is": "one call at 128 x 32 x 32 x 3 uint8 -> f32 (a train batch)",
        "xla_path_ms": pre_stats["xla_ms"],
        "launch_floor_ms": pre_stats["launch_floor_ms"],
        "opt_in": "prepare_batch(backend='pallas'); the trainers keep backend='xla'",
        "shapes": pre_stats["shapes"],
    }]
    print(json.dumps({"train": train_stats, "vq_train": vq_train_stats, "dit": dit_stats,
                      "fm_dit_flash": fm_stats, "dcgan": dcgan_stats, "wgan_gp": wgan_stats,
                      "gan_family_entry_point_walls_s": gan_walls,
                      "gan_family_launches": gan_counts, "slice": slice_stats,
                      "slice_walls_s": {k: v["walls_s"] for k, v in slice_runs.items()},
                      "families": family_stats, "family_walls_s": family_walls,
                      "inception": inception_stats, "dit_moe_card_vs_cpu": moe_card_stats,
                      "dit_moe": moe_stats, "fid": fid_stats,
                      "gan_metrics": gan_metrics_stats, "graphs_against_eager": graph_stats,
                      "ddpm_unroll": ddpm_unroll, "dcgan_unroll_walls_s": dcgan_unroll,
                      "unrolled_dispatches": name_unroll, "unroll_throughput": unroll_stats,
                      "interpolation": interp_stats}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
