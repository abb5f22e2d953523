"""Fused linear-attention block: plain PyTorch version and the Hopper kernel.

Counterpart of ``lightning_generative_models_tpu/ops/linear_attention.py``. The block
is RMSNorm -> qkv projection -> per-head softmax of q over features and softmax of k
over tokens with m learned memory tokens -> per-head context k^T v -> q . context ->
output projection + bias -> RMSNorm -> optional residual.

``linear_attention`` dispatches on the tensor's device: a CPU tensor takes
``linear_attention_plain`` (the math of the JAX package's ``linear_attention_xla``), a
CUDA tensor takes the CUDA kernel in ``csrc/linear_attention.cu`` or raises. There is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from lightning_generative_models_tpu_torch.ops import cuda_build

_EPS = 1e-12

#: Shapes the CUDA kernel takes (every UNet config of the repo: dim 64, dim_mults up to 4).
KERNEL_HEADS = 4
KERNEL_DIM_HEAD = 32
KERNEL_CHANNELS = (64, 128, 256)
KERNEL_TILE = 32  # n must be a multiple of this
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, dim: int) -> torch.Tensor:
    x32 = x.float()
    normed = x32 * torch.rsqrt(torch.sum(x32 * x32, dim=-1, keepdim=True) + _EPS)
    return (normed * g * (dim**0.5)).to(x.dtype)


def linear_attention_plain(
    x: torch.Tensor,           # [b, n, c]
    g0: torch.Tensor,          # [c]
    qkv_kernel: torch.Tensor,  # [c, 3*h*d]
    mem_kv: torch.Tensor,      # [2, heads, d, m]
    out_kernel: torch.Tensor,  # [h*d, c]
    out_bias: torch.Tensor,    # [c]
    g1: torch.Tensor,          # [c]
    heads: int,
    dim_head: int,
    dtype: torch.dtype,
    residual: bool = False,
) -> torch.Tensor:
    """The block in plain PyTorch ops, cast for cast as ``linear_attention_xla``."""
    b, n, c = x.shape
    hd = heads * dim_head
    m = mem_kv.shape[-1]

    xn = _rmsnorm(x.to(dtype), g0, c)
    qkv = (xn @ qkv_kernel.to(dtype)).reshape(b, n, 3, heads, dim_head)
    q, k, v = qkv.unbind(2)  # [b, n, h, d]

    mk, mv = (
        mem_kv[i].permute(2, 0, 1)[None].to(dtype).expand(b, m, heads, dim_head)
        for i in range(2)
    )
    k = torch.cat([mk, k], dim=1)
    v = torch.cat([mv, v], dim=1)

    q = torch.softmax(q.float(), dim=-1) * (dim_head**-0.5)
    k = torch.softmax(k.float(), dim=1)
    q = q.to(dtype)
    k = k.to(dtype)

    # f32 products of the compute-type values: the reference's preferred_element_type.
    context = torch.einsum("bnhd,bnhe->bhde", k.float(), v.float()).to(dtype)
    out = torch.einsum("bhde,bnhd->bnhe", context.float(), q.float()).to(dtype)
    out = out.reshape(b, n, hd)
    out = out @ out_kernel.to(dtype) + out_bias.to(dtype)
    out = _rmsnorm(out, g1, c)
    return out + x.to(out.dtype) if residual else out


def _kernel_library() -> ctypes.CDLL:
    lib = cuda_build.load("linear_attention")
    fn = lib.lgm_linear_attention_fwd
    # Pointers and the stream as c_void_p: as plain ints ctypes would cut them to 32 bits.
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def linear_attention_cuda(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
    heads: int, dim_head: int, dtype: torch.dtype, residual: bool = False,
) -> torch.Tensor:
    """The block through the CUDA kernel. Raises ValueError for what the kernel does
    not take, and RuntimeError where a gradient would be needed (the backward kernel
    is not ported yet)."""
    if x.device.type != "cuda":
        raise ValueError(f"linear_attention_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [b, n, c], got shape {tuple(x.shape)}")
    b, n, c = x.shape
    if (heads, dim_head) != (KERNEL_HEADS, KERNEL_DIM_HEAD):
        raise ValueError(
            f"the CUDA kernel takes heads={KERNEL_HEADS}, dim_head={KERNEL_DIM_HEAD}; "
            f"got heads={heads}, dim_head={dim_head}"
        )
    if c not in KERNEL_CHANNELS or n % KERNEL_TILE or not 1 <= b <= 65535:
        raise ValueError(
            f"the CUDA kernel takes c in {KERNEL_CHANNELS}, n a multiple of "
            f"{KERNEL_TILE} and 1 <= b <= 65535; got x of shape {tuple(x.shape)}"
        )
    if x.dtype not in KERNEL_DTYPES or x.dtype != dtype:
        raise ValueError(
            f"the CUDA kernel computes in the dtype of x (float32 or bfloat16); "
            f"got x {x.dtype}, compute dtype {dtype}"
        )
    params = (g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise RuntimeError(
            "linear_attention on CUDA has no backward kernel yet (see ROADMAP.md); "
            "run it under torch.inference_mode() or torch.no_grad()"
        )
    hd = heads * dim_head
    m = mem_kv.shape[-1]
    shapes = ((c,), (c, 3 * hd), (2, heads, dim_head, m), (hd, c), (c,), (c,))
    for t, shape in zip(params, shapes):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"parameter of shape {tuple(t.shape)} on {t.device} does not fit "
                f"{shape} on {x.device}"
            )
    g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1 = (
        t.detach().to(torch.float32).contiguous() for t in params
    )
    x = x.contiguous()
    out = torch.empty_like(x)
    ctx = torch.empty((b, heads, dim_head, dim_head), dtype=torch.float32, device=x.device)

    lib = _kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lgm_linear_attention_fwd(
            x.data_ptr(), g0.data_ptr(), qkv_kernel.data_ptr(), mem_kv.data_ptr(),
            out_kernel.data_ptr(), out_bias.data_ptr(), g1.data_ptr(),
            out.data_ptr(), ctx.data_ptr(), b, n, c, m, int(residual),
            int(x.dtype == torch.bfloat16), stream,
        )
    cuda_build.check(lib, err, "linear attention kernel")
    linear_attention.launches += 1
    return out


def linear_attention(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
    heads: int, dim_head: int, dtype: torch.dtype = torch.float32,
    residual: bool = False,
) -> torch.Tensor:
    """The block on x's device: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor. ``linear_attention.launches`` counts the kernel's launches."""
    if x.device.type == "cuda":
        return linear_attention_cuda(
            x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
            heads, dim_head, dtype, residual,
        )
    if x.device.type == "cpu":
        return linear_attention_plain(
            x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
            heads, dim_head, dtype, residual,
        )
    raise ValueError(f"linear_attention runs on cuda or cpu, got {x.device}")


linear_attention.launches = 0
