"""On-device input preprocessing: uint8 batch -> float [0, 1] with the train-time flip.

Counterpart of ``lightning_generative_models_tpu/ops/preprocess.py``. Batches cross from
the host as uint8 (a quarter of the bytes of f32) and are scaled and flipped on the
batch's device. The flip is decided by an explicit ``[B]`` bool mask or drawn from a
``torch.Generator``, so a test can hand the port the flips that JAX drew.

Two backends, as in the JAX package. ``backend="xla"`` (the default, the trainer's) is
plain torch: ``to_float01`` casts to the target dtype and then scales, so in bf16 the
product is rounded in bf16. ``backend="pallas"`` is the fused pass of the TPU kernel
(``fused_normalize_flip_pallas``), ``fused_normalize_flip``: scaled in f32 and rounded
once to the target dtype. It dispatches on the batch's device: a CUDA batch calls the
custom op ``lgm_torch::normalize_flip``, which launches the kernel in
``csrc/preprocess.cu`` (or raises), a CPU batch takes ``fused_normalize_flip_plain``,
the same math in plain ops (the op's CPU implementation too; its fake one gives the
output's shape and dtype).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from lightning_generative_models_tpu_torch.ops import cuda_build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def to_float01(images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, C] -> float [0, 1]."""
    if images.dtype == torch.uint8:
        return images.to(dtype) * (1.0 / 255.0)
    return images.to(dtype)


def random_hflip(images: torch.Tensor, flip: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 prob: float = 0.5) -> torch.Tensor:
    """Per-sample horizontal flip of NHWC images, by the ``[B]`` bool mask ``flip``,
    or by one drawn from ``generator`` when it is None."""
    if flip is None:
        flip = torch.rand(images.shape[0], generator=generator, device=images.device) < prob
    flip = flip.to(device=images.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
    return torch.where(flip, images.flip(2), images)


def _check_fused_args(images_u8: torch.Tensor, flip: torch.Tensor, dtype: torch.dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
        raise ValueError(f"fused_normalize_flip takes uint8 [B, H, W, C] images, got "
                         f"{images_u8.dtype} of shape {tuple(images_u8.shape)}")
    if tuple(flip.shape) != (images_u8.shape[0],):
        raise ValueError(f"flip must be a [B] mask, got shape {tuple(flip.shape)} for "
                         f"{images_u8.shape[0]} images")
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_normalize_flip returns float32 or bfloat16, got {dtype}")


def fused_normalize_flip_plain(images_u8: torch.Tensor, flip: torch.Tensor,
                               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain ops: ``x * (1/255)`` in f32, W reversed where
    ``flip``, rounded once to ``dtype``."""
    _check_fused_args(images_u8, flip, dtype)
    x = images_u8.float() * (1.0 / 255.0)
    x = torch.where(flip.to(device=x.device, dtype=torch.bool).reshape(-1, 1, 1, 1),
                    x.flip(2), x)
    return x.to(dtype)


def _check_kernel_shapes(images_u8: torch.Tensor, flip: torch.Tensor, dtype: torch.dtype,
                         what: str):
    """Raise ValueError for what the kernel does not take, from shapes, dtypes and the
    device alone; returns (B, H, W, C)."""
    _check_fused_args(images_u8, flip, dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {images_u8.device}")
    b, h, w, c = images_u8.shape
    if b * h >= 2**31 or w * c >= 2**31:
        raise ValueError(f"the CUDA kernel takes B*H and W*C below 2^31, got "
                         f"{tuple(images_u8.shape)}")
    return b, h, w, c


def fused_normalize_flip_cuda(images_u8: torch.Tensor, flip: torch.Tensor,
                              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The pass through the CUDA kernel. Raises ValueError for what it does not take.
    Counts its launches in ``fused_normalize_flip.launches``."""
    b, h, w, c = _check_kernel_shapes(images_u8, flip, dtype, "fused_normalize_flip_cuda")
    images_u8 = images_u8.contiguous()
    # The kernel reads one byte a flag, non-zero to flip: a bool mask as it is, with no
    # conversion launched.
    flip = flip.to(device=images_u8.device, dtype=torch.bool).contiguous()
    out = torch.empty((b, h, w, c), dtype=dtype, device=images_u8.device)

    lib = cuda_build.load("preprocess")
    lib.lgm_normalize_flip.argtypes = _ARGTYPES
    lib.lgm_normalize_flip.restype = ctypes.c_int
    with torch.cuda.device(images_u8.device):
        stream = torch.cuda.current_stream(images_u8.device).cuda_stream
        err = lib.lgm_normalize_flip(images_u8.data_ptr(), flip.data_ptr(), out.data_ptr(),
                                     b, h, w, c, int(dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, "preprocess kernel")
    fused_normalize_flip.launches += 1
    return out


@torch.library.custom_op("lgm_torch::normalize_flip", mutates_args=(), device_types="cuda")
def _normalize_flip_op(images_u8: torch.Tensor, flip: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Kernel #7 on the card."""
    return fused_normalize_flip_cuda(images_u8, flip, dtype)


@_normalize_flip_op.register_kernel("cpu")
def _(images_u8, flip, dtype):
    return fused_normalize_flip_plain(images_u8, flip, dtype)


@_normalize_flip_op.register_fake
def _(images_u8, flip, dtype):
    return images_u8.new_empty(images_u8.shape, dtype=dtype)


def fused_normalize_flip(images_u8: torch.Tensor, flip: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, C] and a [B] flip mask -> ``dtype`` [B, H, W, C] in [0, 1], on the
    images' device: the kernel on a CUDA tensor (the op ``lgm_torch::normalize_flip``),
    the plain version on a CPU tensor. ``fused_normalize_flip.launches`` counts the
    kernel's launches."""
    if images_u8.device.type == "cuda":
        _check_kernel_shapes(images_u8, flip, dtype, "fused_normalize_flip")
        return torch.ops.lgm_torch.normalize_flip(images_u8, flip, dtype)
    if images_u8.device.type == "cpu":
        return fused_normalize_flip_plain(images_u8, flip, dtype)
    raise ValueError(f"fused_normalize_flip runs on cuda or cpu, got {images_u8.device}")


fused_normalize_flip.launches = 0


def prepare_batch(
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    hflip: bool = True,
    dtype: torch.dtype = torch.float32,
    backend: str = "xla",
    flip: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """uint8 batch -> float [0, 1] model batch, flipped at train time (by ``flip``,
    or drawn from ``generator``; neither given: no flip, as JAX without an rng).
    ``backend="pallas"`` takes ``fused_normalize_flip`` for a uint8 batch."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}; pick 'xla' or 'pallas'")
    out = dict(batch)
    images = batch["image"]
    do_flip = train and hflip and (flip is not None or generator is not None)
    if backend == "pallas" and images.dtype == torch.uint8:
        if not do_flip:
            flip = torch.zeros(images.shape[0], dtype=torch.bool, device=images.device)
        elif flip is None:
            flip = torch.rand(images.shape[0], generator=generator, device=images.device) < 0.5
        out["image"] = fused_normalize_flip(images, flip, dtype)
        return out
    images = to_float01(images, dtype)
    if do_flip:
        images = random_hflip(images, flip, generator)
    out["image"] = images
    return out
