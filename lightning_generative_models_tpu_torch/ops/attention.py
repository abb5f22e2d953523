"""Multi-head softmax attention on packed qkv: plain PyTorch versions and the Hopper kernels.

Counterpart of the fused attention of ``lightning_generative_models_tpu/ops/attention.py``
(``fused_attention_qkv``, ``_vmem_attn_fwd_kernel``, ``_vmem_attn_bwd_kernel``). The input
is the raw ``Dense(3*h*d)`` output ``[b, n, 3*h*d]``, packed in one of two ``LAYOUTS``:
"s3hd" is the ``[b, n, 3, h, d]`` order (the q block, then k, then v, heads-major in
each), "h3d" the ``[b, n, h, 3, d]`` order (each head's q, k, v together). The output is
``[b, n, h*d]``, heads-major, for both.

``fused_attention_qkv`` dispatches on the tensor's device: a CPU tensor takes
``attention_qkv_plain`` (the math of the JAX package's ``_einsum_attention_qkv``, its own
path off a TPU), differentiated by torch autograd; a CUDA tensor takes the custom op
``lgm_torch::attention_qkv``, the kernel in ``csrc/attention_qkv.cu``, whose autograd
formula is the op ``lgm_torch::attention_qkv_bwd``, the kernel in
``csrc/attention_qkv_bwd.cu``; or it raises. There is no fallback
from one to the other, and no size gate: the kernels stream keys through shared memory,
so they take any n. ``attention_qkv_bwd_plain`` is the backward kernel's yardstick: the
math of ``_vmem_attn_bwd_kernel``, in f32.

The flash attention of the same JAX module (``scaled_dot_product_attention``,
``_flash_kernel``) takes separate ``[b, h, n, d]`` q, k and v, with n_q and n_kv free.
``scaled_dot_product_attention(use_pallas=True)`` keeps JAX's shape gate (n_kv >= 256
and d a multiple of 8) and then dispatches on the device: a CPU tensor takes
``flash_attention_plain`` (``_xla_attention``, cast for cast), a CUDA tensor the op
``lgm_torch::flash_attention``, the kernel in ``csrc/flash_attention.cu`` in bf16 and
the forward kernel of ``csrc/attention_qkv.cu`` on the same strides in f32, whose
autograd formula (the op ``lgm_torch::flash_attention_bwd``) is the gradient of
``_xla_attention`` as JAX's custom VJP takes it, computed in f32 by the backward kernel
of ``csrc/attention_qkv_bwd.cu`` on ``[b, h, n, d]`` strides
(``flash_attention_bwd_cuda``; ``flash_attention_bwd_plain`` is its yardstick).

The ops (``torch.library``) hold every pointer read (the ``ctypes`` calls, the strides
arrays, the alignment copies) in their CUDA implementations; their fake implementations
give shapes, dtypes and strides only, so that ``torch.export`` traces through them, and
their CPU implementations are the plain versions (``torch.library.opcheck``). The
wrappers check shapes before they call an op.
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
    q, k, v = (t.transpose(1, 2) for t in _split(qkv, heads, layout))
    grads = _attention_bwd_f32(q, k, v, g.reshape(b, n, heads, d).transpose(1, 2))
    dqkv = torch.stack([t.transpose(1, 2) for t in grads], dim=3 if layout == "h3d" else 2)
    return dqkv.reshape(b, n, w3).to(qkv.dtype)


def _attention_bwd_f32(q, k, v, g):
    """(dq, dk, dv) in f32 of softmax attention on [b, h, n, d] q, k, v with output
    gradient g, P recomputed from q and k: ``attention_qkv_bwd_plain``'s math."""
    scale = q.shape[-1] ** -0.5
    q, k, v, g = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv


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
    return _check_kernel_shapes(qkv, heads, layout, what), _aligned_contiguous(qkv)


def _check_kernel_shapes(qkv: torch.Tensor, heads: int, layout: str, what: str):
    """Raise ValueError for what the kernels do not take, from the shape, dtype and
    device alone; returns (b, n, d)."""
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
    return b, n, d


def _aligned_contiguous(t: torch.Tensor) -> torch.Tensor:
    """t detached and contiguous, with its first element 16-byte aligned: the kernels read
    rows as 16-byte chunks, which fault at a misaligned address, and ``.contiguous()``
    returns a contiguous view one element into its buffer as it is."""
    t = t.detach().contiguous()
    return t if _rows_aligned(t) else t.clone()


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


def _check_bwd_shapes(qkv, g, heads, layout, what):
    b, n, d = _check_kernel_shapes(qkv, heads, layout, what)
    if tuple(g.shape) != (b, n, heads * d) or g.device != qkv.device:
        raise ValueError(f"g of shape {tuple(g.shape)} on {g.device} does not fit qkv of "
                         f"shape {tuple(qkv.shape)} on {qkv.device}")


def attention_qkv_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                           layout: str = "s3hd") -> torch.Tensor:
    """dqkv through the backward CUDA kernel (``csrc/attention_qkv_bwd.cu``), as
    ``attention_qkv_bwd_plain`` returns it. Raises ValueError for what the kernel does
    not take. Counts its launches in ``fused_attention_qkv_bwd.launches``."""
    _check_bwd_shapes(qkv, g, heads, layout, "attention_qkv_bwd_cuda")
    (b, n, d), qkv = _kernel_args(qkv, heads, layout, "attention_qkv_bwd_cuda")
    g = _aligned_contiguous(g.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    stats = _bwd_stats(b, heads, n, qkv.device)
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


def _bwd_stats(b: int, heads: int, n_q: int, device) -> torch.Tensor:
    """The backward kernel's scratch: per (batch row, head, query) the softmax's max, 1 /
    its sum, and rowsum(P * dP), the queries rounded up to the kernel's 64-row tiles."""
    return torch.empty((3, b, heads, -(-n_q // 64) * 64), dtype=torch.float32, device=device)


@torch.library.custom_op("lgm_torch::attention_qkv", mutates_args=(), device_types="cuda")
def _attention_qkv_op(qkv: torch.Tensor, heads: int, layout: str) -> torch.Tensor:
    """Kernel #3: the forward kernel on the card."""
    return attention_qkv_cuda(qkv, heads, layout)


@_attention_qkv_op.register_kernel("cpu")
def _(qkv, heads, layout):
    return attention_qkv_plain(qkv, heads, layout)


@_attention_qkv_op.register_fake
def _(qkv, heads, layout):
    b, n, w3 = qkv.shape
    return qkv.new_empty((b, n, w3 // 3))


@torch.library.custom_op("lgm_torch::attention_qkv_bwd", mutates_args=(), device_types="cuda")
def _attention_qkv_bwd_op(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                          layout: str) -> torch.Tensor:
    """Kernel #4: the backward kernel on the card."""
    return attention_qkv_bwd_cuda(qkv, g, heads, layout)


@_attention_qkv_bwd_op.register_kernel("cpu")
def _(qkv, g, heads, layout):
    return attention_qkv_bwd_plain(qkv, g, heads, layout)


@_attention_qkv_bwd_op.register_fake
def _(qkv, g, heads, layout):
    return qkv.new_empty(qkv.shape)


def _qkv_setup_context(ctx, inputs, output):
    qkv, heads, layout = inputs
    ctx.save_for_backward(qkv)
    ctx.config = (heads, layout)


def _qkv_backward(ctx, g):
    """The backward kernel recomputes the softmax from the saved qkv, as the JAX
    package's custom VJP does. Nothing of the forward's intermediates is kept."""
    (qkv,) = ctx.saved_tensors
    return torch.ops.lgm_torch.attention_qkv_bwd(qkv, g, *ctx.config), None, None


_attention_qkv_op.register_autograd(_qkv_backward, setup_context=_qkv_setup_context)


def fused_attention_qkv(qkv: torch.Tensor, heads: int, layout: str = "s3hd") -> torch.Tensor:
    """The attention on qkv's device: on a CUDA tensor the kernels, through the op
    ``lgm_torch::attention_qkv``; on a CPU tensor the plain version, differentiated by
    torch autograd. ``fused_attention_qkv.launches`` counts the forward kernel's launches,
    ``fused_attention_qkv_bwd.launches`` the backward kernel's."""
    _check_args(qkv, heads, layout)
    if qkv.device.type == "cuda":
        _check_kernel_shapes(qkv, heads, layout, "fused_attention_qkv")
        return torch.ops.lgm_torch.attention_qkv(qkv, heads, layout)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads, layout)
    raise ValueError(f"fused_attention_qkv runs on cuda or cpu, got {qkv.device}")


def fused_attention_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                            layout: str = "s3hd") -> torch.Tensor:
    """dqkv on qkv's device: the backward kernel on a CUDA tensor (the op
    ``lgm_torch::attention_qkv_bwd``), the plain version on a CPU tensor."""
    if qkv.device.type == "cuda":
        _check_bwd_shapes(qkv, g, heads, layout, "fused_attention_qkv_bwd")
        return torch.ops.lgm_torch.attention_qkv_bwd(qkv, g, heads, layout)
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, g, heads, layout)
    raise ValueError(f"fused_attention_qkv_bwd runs on cuda or cpu, got {qkv.device}")


fused_attention_qkv.launches = 0
fused_attention_qkv_bwd.launches = 0


# -- flash attention on [b, h, n, d] -------------------------------------------------------

#: n_kv at which ``scaled_dot_product_attention(use_pallas=True)`` takes the flash kernel,
#: and the head width's multiple it needs: the JAX package's gate.
FLASH_MIN_KV = 256
FLASH_DIM_HEAD_MULTIPLE = 8

_FLASH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def _check_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be [b, h, n, d], got shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or tuple(k.shape[:2]) != (b, h) or k.shape[3] != d:
        raise ValueError(f"k and v of shapes {tuple(k.shape)} and {tuple(v.shape)} do not fit "
                         f"q of shape {tuple(q.shape)}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[b, h, n_q, d] softmax attention in plain PyTorch ops, cast for cast as the JAX
    package's ``_xla_attention``: q scaled by d^-1/2 in q's dtype, the logits, the
    softmax and the output in the inputs' dtype."""
    _check_bhnd(q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def _bhnd_strides(t: torch.Tensor) -> list:
    """(batch, head, token) strides in elements of a [b, h, n, d] tensor."""
    return [t.stride(0), t.stride(1), t.stride(2)]


def _flash_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str):
    """Check what the flash kernels take; returns q, k and v, each as it is where the
    kernels read it in place (``_rows_aligned``, ``_no_zero_stride``), else as a copy: at
    its own strides where only its first element is misaligned (``_in_place_strides``),
    contiguous otherwise."""
    _check_flash_shapes(q, k, v, what)
    return [_kernel_operand(t) for t in (q, k, v)]


def _check_flash_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str):
    """Raise ValueError for what the flash kernels do not take, from shapes, dtypes and
    devices alone."""
    _check_bhnd(q, k, v)
    if not (q.device.type == k.device.type == v.device.type == "cuda"):
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{what} takes float32 or bfloat16 q, k and v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, h, n_q, d = q.shape
    if d < 1 or d % KERNEL_DIM_HEAD_MULTIPLE or d > KERNEL_MAX_DIM_HEAD:
        raise ValueError(
            f"{what} takes a head width d that is a multiple of "
            f"{KERNEL_DIM_HEAD_MULTIPLE} up to {KERNEL_MAX_DIM_HEAD}; got d={d}")
    if not (1 <= b <= KERNEL_MAX_BATCH and 1 <= h <= KERNEL_MAX_BATCH and n_q >= 1
            and k.shape[2] >= 1):
        raise ValueError(f"{what} takes 1 <= b, h <= {KERNEL_MAX_BATCH} and n >= 1; got q "
                         f"of shape {tuple(q.shape)} and k of shape {tuple(k.shape)}")


def _in_place_strides(t: torch.Tensor) -> bool:
    """Whether t's strides let the kernels read it in place (``_rows_aligned`` but the
    pointer, and ``_no_zero_stride``): a rule on strides alone, which the ops' fake
    implementations follow for the backward's gradient layout."""
    size = t.element_size()
    return (t.stride(-1) == 1 and all(s * size % 16 == 0 for s in t.stride()[:-1])
            and _no_zero_stride(t))


def _strided_like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of t's shape and dtype, at t's strides where the kernels read them
    in place (``_in_place_strides``), contiguous otherwise."""
    if _in_place_strides(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels read it: itself when ``_rows_aligned`` and ``_no_zero_stride``,
    else a copy laid out by ``_strided_like``."""
    t = t.detach()
    if _in_place_strides(t) and _rows_aligned(t):
        return t
    return _strided_like(t).copy_(t)


def _no_zero_stride(t: torch.Tensor) -> bool:
    """Whether no dim longer than 1 has stride 0 (an expanded dim): the flash kernel's
    tensor maps take none, so such a tensor is copied."""
    return all(s > 0 for s, n in zip(t.stride(), t.shape) if n > 1)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels can read t's last-dim rows in place as 16-byte chunks: the last
    dim contiguous, the first element and every row 16-byte aligned. True of the DiT's
    views of a packed qkv and of any fresh tensor with d a multiple of 8; a copy is made
    otherwise."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1]))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[b, h, n_q, d] attention through the flash kernel, with no autograd graph
    (``flash_attention`` has one): in bf16 the kernel of ``csrc/flash_attention.cu``; in
    f32 the forward kernel of ``csrc/attention_qkv.cu`` (kernel #3's), which computes the
    same function on the same strides and was the faster f32 design at every measured
    shape. The dtype decides; nothing is caught. q, k and v are read in place through
    their strides; the output is a [b, h, n_q, d] view of a [b, n_q, h, d] tensor, so
    that transposing it back to tokens-major is free. Raises ValueError for what the
    kernels do not take. Counts its launches, either kernel's, in
    ``flash_attention.launches``."""
    q, k, v = _flash_kernel_args(q, k, v, "flash_attention_cuda")
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    out = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if q.dtype == torch.bfloat16:
            strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                                 for s in _bhnd_strides(t)))
            lib = _library("flash_attention", "lgm_flash_attention_fwd", _FLASH_ARGTYPES)
            err = lib.lgm_flash_attention_fwd(*ptrs, ctypes.addressof(strides), b, h, n_q,
                                              n_kv, d, d**-0.5, stream)
        else:
            # (batch, token, head) strides, the order of kernel #3's entry.
            strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                                 for s in (t.stride(0), t.stride(2),
                                                           t.stride(1))))
            lib = _library("attention_qkv", "lgm_attention_qkv_fwd", _FWD_ARGTYPES)
            err = lib.lgm_attention_qkv_fwd(*ptrs, ctypes.addressof(strides), b, h, n_q, n_kv,
                                            d, 0, d**-0.5, stream)
    cuda_build.check(lib, err, "flash attention kernel")
    flash_attention.launches += 1
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             g: torch.Tensor):
    """(dq, dk, dv) of ``flash_attention_plain``'s math with respect to [b, h, n, d] q, k
    and v, computed in f32 by the backward kernel of ``csrc/attention_qkv_bwd.cu``, each
    rounded once to the inputs' dtype. q, k, v and g are read in place through their
    strides, and the kernel writes each gradient at its input's strides, so dq, dk and dv
    are allocated with q's, k's and v's (for the DiT's views of the packed qkv, strided
    [b, h, n, d] tensors; ``_strided_like``). Counts its launches in
    ``flash_attention_bwd_cuda.launches``."""
    if tuple(g.shape) != tuple(q.shape) or g.device != q.device:
        raise ValueError(f"g of shape {tuple(g.shape)} on {g.device} does not fit q of shape "
                         f"{tuple(q.shape)} on {q.device}")
    q, k, v = _flash_kernel_args(q, k, v, "flash_attention_bwd_cuda")
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    g = g.detach().to(q.dtype)
    if not _rows_aligned(g):
        g = g.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = (torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    stats = _bwd_stats(b, h, n_q, q.device)
    # The kernel takes (batch, token, head) strides of q, k, v and g.
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, g)
                                         for s in (t.stride(0), t.stride(2), t.stride(1))))

    lib = _library("attention_qkv_bwd", "lgm_attention_qkv_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lgm_attention_qkv_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), ctypes.addressof(strides),
            b, h, n_q, n_kv, d, int(q.dtype == torch.bfloat16), d**-0.5, stream,
        )
    cuda_build.check(lib, err, "flash attention backward kernel")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


@torch.library.custom_op("lgm_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel #5 (in f32 #3's forward entry on the same strides): the forward on the card."""
    return flash_attention_cuda(q, k, v)


def _flash_out(q: torch.Tensor) -> torch.Tensor:
    """The forward's output layout: a [b, h, n_q, d] view of a [b, n_q, h, d] tensor."""
    b, h, n_q, d = q.shape
    return q.new_empty((b, n_q, h, d), dtype=q.dtype).transpose(1, 2)


@_flash_attention_op.register_kernel("cpu")
def _(q, k, v):
    return _flash_out(q).copy_(flash_attention_plain(q, k, v))


@_flash_attention_op.register_fake
def _(q, k, v):
    return _flash_out(q)


@torch.library.custom_op("lgm_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel #5's backward route, #4's entry on [b, h, n, d] strides, on the card."""
    return flash_attention_bwd_cuda(q, k, v, g)


@_flash_attention_bwd_op.register_kernel("cpu")
def _(q, k, v, g):
    """The backward route's math in plain ops, in f32, each gradient rounded once to its
    input's dtype (written out: an op's CPU implementation runs below autograd)."""
    _check_bhnd(q, k, v)
    return tuple(_strided_like(t).copy_(d)
                 for t, d in zip((q, k, v), _attention_bwd_f32(q, k, v, g)))


@_flash_attention_bwd_op.register_fake
def _(q, k, v, g):
    return tuple(_strided_like(t) for t in (q, k, v))


def _flash_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _flash_backward(ctx, g):
    """Only q, k and v are saved; the backward recomputes the softmax from them, as the
    JAX package's custom VJP (``_flash_attention_bwd``: the VJP of ``_xla_attention``)
    does."""
    return torch.ops.lgm_torch.flash_attention_bwd(*ctx.saved_tensors, g)


_flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[b, h, n_q, d] attention on q's device: on CUDA tensors the flash kernel, through
    the op ``lgm_torch::flash_attention``; on CPU tensors ``flash_attention_plain``,
    differentiated by torch autograd. ``flash_attention.launches`` counts the forward
    kernel's launches, ``flash_attention_bwd_cuda.launches`` the backward's."""
    _check_bhnd(q, k, v)
    if q.device.type == "cuda":
        _check_flash_shapes(q, k, v, "flash_attention")
        return torch.ops.lgm_torch.flash_attention(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              g: torch.Tensor):
    """(dq, dk, dv) by torch autograd through ``flash_attention_plain``: the VJP of
    ``_xla_attention`` that JAX's ``_flash_attention_bwd`` takes, in the inputs' dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(flash_attention_plain(*leaves), leaves, g)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 use_pallas: bool = False) -> torch.Tensor:
    """[b, h, n, d] attention with the JAX package's shape gate: the flash path
    (``flash_attention``) when asked for and n_kv >= 256 with d a multiple of 8, else
    the plain attention. The gate is a shape rule, not a fallback: past it, a CUDA
    tensor takes the kernel or raises."""
    if use_pallas and k.shape[2] >= FLASH_MIN_KV and q.shape[-1] % FLASH_DIM_HEAD_MULTIPLE == 0:
        return flash_attention(q, k, v)
    return flash_attention_plain(q, k, v)


flash_attention.launches = 0
flash_attention_bwd_cuda.launches = 0
