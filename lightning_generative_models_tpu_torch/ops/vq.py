"""VQ codebook nearest-neighbour search: plain PyTorch version and the Hopper kernel.

Counterpart of ``lightning_generative_models_tpu/ops/vq.py``. The function is
``argmin_k ||e_k||^2 - 2 z . e_k`` over a [K, D] codebook for each row of a [N, D]
latent matrix, in f32, with the first index on ties; the row-constant ``||z||^2`` is
dropped, as the TPU kernel drops it.

``nearest_codes`` dispatches on the tensor's device: a CPU tensor takes
``nearest_codes_plain``; a CUDA tensor calls the custom op ``lgm_torch::nearest_codes``
(``torch.library``: its CUDA implementation holds the pointer reads, its fake one gives
the [N] int32 shape, its CPU one is the plain version), which launches the kernel in
``csrc/vq.cu`` at every N
(the JAX package's XLA branch below N = 1,024 computes the same argmin) or raises
``ValueError`` for a shape it does not take. Inputs are cast to f32 first, as
``nearest_codes_pallas`` casts them. The indices carry no gradient: the caller cuts it,
as ``vector_quantizer._assign_codes`` does.
"""

from __future__ import annotations

import ctypes

import torch

from lightning_generative_models_tpu_torch.ops import cuda_build

#: Latent widths the CUDA kernel takes (a warp holds its rows' operand fragments in
#: registers, one template instance a width).
KERNEL_DIMS = (8, 16, 32, 64, 128)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check_shapes(flat: torch.Tensor, codebook: torch.Tensor) -> None:
    if flat.dim() != 2 or codebook.dim() != 2 or flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"nearest codes take flat [N, D] and codebook [K, D]; got "
                         f"{tuple(flat.shape)} and {tuple(codebook.shape)}")
    if flat.shape[0] < 1 or codebook.shape[0] < 1:
        raise ValueError(f"nearest codes need N >= 1 and K >= 1; got {tuple(flat.shape)} "
                         f"and {tuple(codebook.shape)}")
    if not (flat.is_floating_point() and codebook.is_floating_point()):
        raise ValueError(f"nearest codes take floating-point inputs; got {flat.dtype} and "
                         f"{codebook.dtype}")


def nearest_codes_plain(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] -> [N] int32: the TPU kernel's scores in plain ops, f32."""
    _check_shapes(flat, codebook)
    flat = flat.detach().float()
    codebook = codebook.detach().float()
    cb_sq = torch.sum(codebook * codebook, dim=1)
    scores = cb_sq[None, :] - 2.0 * (flat @ codebook.T)
    return torch.argmin(scores, dim=1).to(torch.int32)  # first index on ties


def _check_kernel_shapes(flat: torch.Tensor, codebook: torch.Tensor, what: str):
    """Raise ValueError for what the kernel does not take, from shapes and devices alone;
    returns (N, K, D)."""
    _check_shapes(flat, codebook)
    if flat.device.type != "cuda" or codebook.device != flat.device:
        raise ValueError(f"{what} needs both inputs on one CUDA device; got "
                         f"{flat.device} and {codebook.device}")
    n, d = flat.shape
    k = codebook.shape[0]
    if d not in KERNEL_DIMS:
        raise ValueError(f"the CUDA kernel takes D in {KERNEL_DIMS}; got D={d}")
    if n >= 2**31 or k >= 2**31:
        raise ValueError(f"the CUDA kernel takes N, K < 2^31; got N={n}, K={k}")
    return n, k, d


def nearest_codes_cuda(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] -> [N] int32 through the CUDA kernel. Raises ValueError for what
    the kernel does not take. Counts its launches in ``nearest_codes.launches``."""
    n, k, d = _check_kernel_shapes(flat, codebook, "nearest_codes_cuda")
    flat = flat.detach().to(torch.float32).contiguous()
    codebook = codebook.detach().to(torch.float32).contiguous()
    # The kernel copies rows in 16-byte chunks.
    flat, codebook = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (flat, codebook))
    out = torch.empty(n, dtype=torch.int32, device=flat.device)

    lib = cuda_build.load("vq")
    lib.lgm_vq_nearest.argtypes = _ARGTYPES
    lib.lgm_vq_nearest.restype = ctypes.c_int
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.lgm_vq_nearest(flat.data_ptr(), codebook.data_ptr(), out.data_ptr(),
                                 n, k, d, stream)
    cuda_build.check(lib, err, "VQ nearest-code kernel")
    nearest_codes.launches += 1
    return out


@torch.library.custom_op("lgm_torch::nearest_codes", mutates_args=(), device_types="cuda")
def _nearest_codes_op(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Kernel #6 on the card."""
    return nearest_codes_cuda(flat, codebook)


@_nearest_codes_op.register_kernel("cpu")
def _(flat, codebook):
    return nearest_codes_plain(flat, codebook)


@_nearest_codes_op.register_fake
def _(flat, codebook):
    return flat.new_empty((flat.shape[0],), dtype=torch.int32)


def nearest_codes(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices on flat's device: the kernel on a CUDA tensor (the op
    ``lgm_torch::nearest_codes``), the plain version on a CPU tensor.
    ``nearest_codes.launches`` counts the kernel's launches."""
    if flat.device.type == "cuda":
        _check_kernel_shapes(flat, codebook, "nearest_codes")
        return torch.ops.lgm_torch.nearest_codes(flat, codebook)
    if flat.device.type == "cpu":
        return nearest_codes_plain(flat, codebook)
    raise ValueError(f"nearest_codes runs on cuda or cpu, got {flat.device}")


nearest_codes.launches = 0
