"""Multi-head softmax attention on packed qkv: plain PyTorch versions and the Hopper kernels.

Counterpart of the fused attention of ``lightning_generative_models_tpu/ops/attention.py``
(``fused_attention_qkv``, ``_vmem_attn_fwd_kernel``, ``_vmem_attn_bwd_kernel``). The input
is the raw ``Dense(3*h*d)`` output ``[b, n, 3*h*d]``, packed in one of two ``LAYOUTS``:
"s3hd" is the ``[b, n, 3, h, d]`` order (the q block, then k, then v, heads-major in
each), "h3d" the ``[b, n, h, 3, d]`` order (each head's q, k, v together). The output is
``[b, n, h*d]``, heads-major, for both.

``fused_attention_qkv`` dispatches on the tensor's device: a CPU tensor takes
``attention_qkv_plain`` (the math of the JAX package's ``_einsum_attention_qkv``, its own
path off a TPU), differentiated by torch autograd; a CUDA tensor takes
``FusedAttentionQKV``, whose forward is the kernel in ``csrc/attention_qkv.cu`` and whose
backward is the kernel in ``csrc/attention_qkv_bwd.cu``, or raises. There is no fallback
from one to the other, and no size gate: the kernels stream keys through shared memory,
so they take any n. ``attention_qkv_bwd_plain`` is the backward kernel's yardstick: the
math of ``_vmem_attn_bwd_kernel``, in f32.
"""

from __future__ import annotations

import ctypes

import torch

from lightning_generative_models_tpu_torch.ops import cuda_build

LAYOUTS = ("s3hd", "h3d")

#: What the CUDA kernels take: the head width d a multiple of 8 up to 128, f32 or bf16.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_MAX_DIM_HEAD = 128
KERNEL_DIM_HEAD_MULTIPLE = 8
KERNEL_MAX_BATCH = 65535


def qkv_offsets(layout: str, hd: int, d: int, hh: int):
    """(q, k, v) channel offsets of head ``hh`` in the packed qkv dim."""
    if layout == "s3hd":
        return hh * d, hd + hh * d, 2 * hd + hh * d
    base = hh * 3 * d
    return base, base + d, base + 2 * d


def _check_args(qkv: torch.Tensor, heads: int, layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown qkv layout {layout!r}; pick from {LAYOUTS}")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [b, n, 3*heads*d], got shape {tuple(qkv.shape)}")
    if heads < 1 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv width {qkv.shape[-1]} is not 3*heads*d for heads={heads}")


def _split(qkv: torch.Tensor, heads: int, layout: str):
    """q, k, v as [b, n, heads, d] views of the packed tensor."""
    b, n, w3 = qkv.shape
    d = w3 // (3 * heads)
    if layout == "h3d":
        x = qkv.reshape(b, n, heads, 3, d)
        return x[..., 0, :], x[..., 1, :], x[..., 2, :]
    x = qkv.reshape(b, n, 3, heads, d)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def attention_qkv_plain(qkv: torch.Tensor, heads: int, layout: str = "s3hd") -> torch.Tensor:
    """The attention in plain PyTorch ops, cast for cast as ``_einsum_attention_qkv``:
    q is scaled by d^-1/2 in qkv's dtype, and the logits, the softmax and the output stay
    in that dtype."""
    _check_args(qkv, heads, layout)
    b, n, w3 = qkv.shape
    d = w3 // (3 * heads)
    q, k, v = _split(qkv, heads, layout)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * d**-0.5, k)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, heads * d)


def attention_qkv_bwd_plain(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                            layout: str = "s3hd") -> torch.Tensor:
    """The attention's gradient with respect to qkv, the math of ``_vmem_attn_bwd_kernel``:
    q, k, v and g in f32, P recomputed by the softmax, then

        dV = P^T g;  dP = g V^T;  dS = P * (dP - rowsum(P * dP));
        dQ = dS K * scale;  dK = dS^T Q * scale,

    packed at the layout's offsets into a tensor of qkv's shape, rounded to its dtype."""
    _check_args(qkv, heads, layout)
    b, n, w3 = qkv.shape
    d = w3 // (3 * heads)
    if tuple(g.shape) != (b, n, heads * d):
        raise ValueError(f"g of shape {tuple(g.shape)} does not fit qkv of shape {tuple(qkv.shape)}")
    scale = d**-0.5
    q, k, v = (t.float() for t in _split(qkv, heads, layout))
    gh = g.float().reshape(b, n, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dqkv = torch.stack([dq, dk, dv], dim=3 if layout == "h3d" else 2)
    return dqkv.reshape(b, n, w3).to(qkv.dtype)


# Pointers, the strides array and the stream as c_void_p: as plain ints ctypes would cut
# them to 32 bits.
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def _library(name: str, fn_name: str, argtypes: list) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def _kernel_args(qkv: torch.Tensor, heads: int, layout: str, what: str):
    """Check what the kernels take; returns (b, n, d) and the contiguous qkv."""
    _check_args(qkv, heads, layout)
    if qkv.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16 qkv, got {qkv.dtype}")
    b, n, w3 = qkv.shape
    d = w3 // (3 * heads)
    if d < 1 or d % KERNEL_DIM_HEAD_MULTIPLE or d > KERNEL_MAX_DIM_HEAD:
        raise ValueError(
            f"the CUDA kernels take a head width d that is a multiple of "
            f"{KERNEL_DIM_HEAD_MULTIPLE} up to {KERNEL_MAX_DIM_HEAD}; got d={d}")
    if not (1 <= b <= KERNEL_MAX_BATCH and n >= 1):
        raise ValueError(f"the CUDA kernels take 1 <= b <= {KERNEL_MAX_BATCH} and n >= 1; "
                         f"got qkv of shape {tuple(qkv.shape)}")
    return (b, n, d), qkv.detach().contiguous()


def _packed_layout(qkv: torch.Tensor, layout: str, d: int):
    """Byte offsets of head 0's q, k and v in the packed tensor, and the (batch, token,
    head) strides of q, k and v and of the [b, n, h*d] output, in elements."""
    b, n, w3 = qkv.shape
    hd = w3 // 3
    offsets = [off * qkv.element_size() for off in qkv_offsets(layout, hd, d, 0)]
    head = d if layout == "s3hd" else 3 * d
    strides = [n * w3, w3, head] * 3 + [n * hd, hd, d]
    return offsets, (ctypes.c_longlong * 12)(*strides)


def attention_qkv_cuda(qkv: torch.Tensor, heads: int, layout: str = "s3hd") -> torch.Tensor:
    """The attention through the forward CUDA kernel, with no autograd graph (use
    ``fused_attention_qkv`` for that). Raises ValueError for what the kernel does not
    take. Counts its launches in ``fused_attention_qkv.launches``."""
    (b, n, d), qkv = _kernel_args(qkv, heads, layout, "attention_qkv_cuda")
    out = torch.empty((b, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    offsets, strides = _packed_layout(qkv, layout, d)

    lib = _library("attention_qkv", "lgm_attention_qkv_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.lgm_attention_qkv_fwd(
            *(qkv.data_ptr() + o for o in offsets), out.data_ptr(), ctypes.addressof(strides),
            b, heads, n, n, d, int(qkv.dtype == torch.bfloat16), d**-0.5, stream,
        )
    cuda_build.check(lib, err, "attention kernel")
    fused_attention_qkv.launches += 1
    return out


def attention_qkv_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                           layout: str = "s3hd") -> torch.Tensor:
    """dqkv through the backward CUDA kernel (``csrc/attention_qkv_bwd.cu``), as
    ``attention_qkv_bwd_plain`` returns it. Raises ValueError for what the kernel does
    not take. Counts its launches in ``fused_attention_qkv_bwd.launches``."""
    (b, n, d), qkv = _kernel_args(qkv, heads, layout, "attention_qkv_bwd_cuda")
    if tuple(g.shape) != (b, n, heads * d) or g.device != qkv.device:
        raise ValueError(f"g of shape {tuple(g.shape)} on {g.device} does not fit qkv of "
                         f"shape {tuple(qkv.shape)} on {qkv.device}")
    g = g.detach().to(qkv.dtype).contiguous()
    dqkv = torch.empty_like(qkv)
    # Per (batch row, head, query): the softmax's running max and sum, and rowsum(P * dP).
    stats = torch.empty((3, b, heads, n), dtype=torch.float32, device=qkv.device)
    offsets, strides = _packed_layout(qkv, layout, d)

    lib = _library("attention_qkv_bwd", "lgm_attention_qkv_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.lgm_attention_qkv_bwd(
            *(qkv.data_ptr() + o for o in offsets), g.data_ptr(),
            *(dqkv.data_ptr() + o for o in offsets), stats.data_ptr(), ctypes.addressof(strides),
            b, heads, n, n, d, int(qkv.dtype == torch.bfloat16), d**-0.5, stream,
        )
    cuda_build.check(lib, err, "attention backward kernel")
    fused_attention_qkv_bwd.launches += 1
    return dqkv


class FusedAttentionQKV(torch.autograd.Function):
    """The attention on the card with its gradient: the forward kernel, then the backward
    kernel, which recomputes the softmax from the saved qkv as the JAX package's custom
    VJP does. Nothing of the forward's intermediates is kept."""

    @staticmethod
    def forward(ctx, qkv, heads, layout):
        out = attention_qkv_cuda(qkv, heads, layout)
        ctx.save_for_backward(qkv)
        ctx.config = (heads, layout)
        return out

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return attention_qkv_bwd_cuda(qkv, g, *ctx.config), None, None


def fused_attention_qkv(qkv: torch.Tensor, heads: int, layout: str = "s3hd") -> torch.Tensor:
    """The attention on qkv's device: on a CUDA tensor the kernels, through
    ``FusedAttentionQKV``; on a CPU tensor the plain version, differentiated by torch
    autograd. ``fused_attention_qkv.launches`` counts the forward kernel's launches,
    ``fused_attention_qkv_bwd.launches`` the backward kernel's."""
    _check_args(qkv, heads, layout)
    if qkv.device.type == "cuda":
        return FusedAttentionQKV.apply(qkv, heads, layout)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads, layout)
    raise ValueError(f"fused_attention_qkv runs on cuda or cpu, got {qkv.device}")


def fused_attention_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                            layout: str = "s3hd") -> torch.Tensor:
    """dqkv on qkv's device: the backward kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    fn = {"cuda": attention_qkv_bwd_cuda, "cpu": attention_qkv_bwd_plain}.get(qkv.device.type)
    if fn is None:
        raise ValueError(f"fused_attention_qkv_bwd runs on cuda or cpu, got {qkv.device}")
    return fn(qkv, g, heads, layout)


fused_attention_qkv.launches = 0
fused_attention_qkv_bwd.launches = 0
