"""Fused linear-attention block: plain PyTorch version and the Hopper kernel.

Counterpart of ``lightning_generative_models_tpu/ops/linear_attention.py``. The block
is RMSNorm -> qkv projection -> per-head softmax of q over features and softmax of k
over tokens with m learned memory tokens -> per-head context k^T v -> q . context ->
output projection + bias -> RMSNorm -> optional residual.

``linear_attention`` dispatches on the tensor's device: a CPU tensor takes
``linear_attention_plain`` (the math of the JAX package's ``linear_attention_xla``),
whose gradient comes from torch autograd; a CUDA tensor takes ``FusedLinearAttention``,
the forward kernel in ``csrc/linear_attention.cu`` and the backward kernel in
``csrc/linear_attention_bwd.cu``, or raises. There is no fallback from one to the
other. ``linear_attention_bwd_plain`` is the backward kernel's yardstick: the math of
the JAX package's ``_bwd_kernel``.
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
KERNEL_TILE = 16  # n must be a multiple of this: the kernels' 16-token subtile
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_BWD_MAX_MEM = 8  # memory tokens the backward kernel takes


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


def linear_attention_bwd_plain(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1, dout,
    heads: int, dim_head: int, dtype: torch.dtype, residual: bool = False,
):
    """The block's gradient in plain PyTorch ops: the math of the JAX package's
    ``_bwd_kernel``, per head (no [hd, hd] block-diagonal mask), rounded to ``dtype``
    where it rounds (xn, v, ke, me, memv, context, qs, a, dy, da, du, dp) and f32
    everywhere else. Returns ``(dx, dg0, dqkv_kernel, dmem_kv, dout_kernel,
    dout_bias, dg1)``: dx in x's dtype, the weight grads in f32, dmem_kv in the
    [2, heads, d, m] layout of ``mem_kv``."""
    b, n, c = x.shape
    hd = heads * dim_head
    scale = dim_head**-0.5
    sqrt_c = c**0.5

    def rnd(t):
        return t.to(dtype).float()

    x32 = x.float()
    g0, wqkv, mem, wo, bo, g1 = (
        t.detach().float() for t in (g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1)
    )
    d = dout.float()

    # -- the forward again ------------------------------------------------------
    r0 = torch.rsqrt(torch.sum(x32 * x32, dim=-1, keepdim=True) + _EPS)
    xn = rnd(x32 * r0 * (g0 * sqrt_c))
    wqkvc = rnd(wqkv)
    q, k, v = (xn @ wqkvc).reshape(b, n, 3, heads, dim_head).unbind(2)  # [b, n, h, d]
    pq = torch.softmax(q, dim=-1)
    qs = rnd(pq * scale)

    memk = mem[0].permute(2, 0, 1)  # [m, h, d]
    memv = mem[1].permute(2, 0, 1)
    kmax = torch.maximum(k.amax(dim=1), memk.amax(dim=0))  # [b, h, d]
    ke = torch.exp(k - kmax[:, None])                    # [b, n, h, d]
    me = torch.exp(memk[None] - kmax[:, None])           # [b, m, h, d]
    z = ke.sum(dim=1) + me.sum(dim=1)                    # [b, h, d]
    v3, kec, mec, memvc = rnd(v), rnd(ke), rnd(me), rnd(memv)
    u = (torch.einsum("bnhd,bnhe->bhde", kec, v3)
         + torch.einsum("bmhd,mhe->bhde", mec, memvc))
    context = u / z[..., None]                           # [b, h, d, e]
    contextc = rnd(context)
    ac = rnd(torch.einsum("bnhd,bhde->bnhe", qs, contextc)).reshape(b, n, hd)
    woc = rnd(wo)
    y = ac @ woc + bo
    r1 = torch.rsqrt(torch.sum(y * y, dim=-1, keepdim=True) + _EPS)

    # -- backward -----------------------------------------------------------------
    u1 = d * (g1 * sqrt_c)
    dy = u1 * r1 - y * r1**3 * torch.sum(u1 * y, dim=-1, keepdim=True)
    dg1 = torch.sum(d * y * r1, dim=(0, 1)) * sqrt_c
    dyc = rnd(dy)
    dwo = ac.reshape(-1, hd).T @ dyc.reshape(-1, c)
    dbo = dy.sum(dim=(0, 1))
    da3 = rnd(dyc @ woc.T).reshape(b, n, heads, dim_head)

    dqs = torch.einsum("bnhe,bhde->bnhd", da3, contextc)
    dcontext = torch.einsum("bnhd,bnhe->bhde", qs, da3)
    du = dcontext / z[..., None]
    dz = -torch.sum(dcontext * context, dim=-1) / z      # [b, h, d]
    duc = rnd(du)
    dke = torch.einsum("bnhe,bhde->bnhd", v3, duc) + dz[:, None]
    dv = torch.einsum("bnhd,bhde->bnhe", kec, duc)
    dme = torch.einsum("mhe,bhde->bmhd", memvc, duc) + dz[:, None]
    dmv = torch.einsum("bmhd,bhde->bmhe", mec, duc)
    dk = ke * dke  # the stabiliser kmax has exactly zero gradient
    dmem = torch.stack([(me * dme).sum(dim=0).permute(1, 2, 0),
                        dmv.sum(dim=0).permute(1, 2, 0)])

    dpq = dqs * scale
    dq = pq * dpq - pq * torch.sum(dpq * pq, dim=-1, keepdim=True)
    dpc = rnd(torch.stack([dq, dk, dv], dim=2).reshape(b, n, 3 * hd))
    dxn = dpc @ wqkvc.T
    dw = xn.reshape(-1, c).T @ dpc.reshape(-1, 3 * hd)

    u0 = dxn * (g0 * sqrt_c)
    dx = u0 * r0 - x32 * r0**3 * torch.sum(u0 * x32, dim=-1, keepdim=True)
    dg0 = torch.sum(dxn * x32 * r0, dim=(0, 1)) * sqrt_c
    if residual:
        dx = dx + d
    return dx.to(x.dtype), dg0, dw, dmem, dwo, dbo, dg1


def linear_attention_bwd_exact(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1, dout,
    heads: int, dim_head: int, residual: bool = False,
) -> list:
    """The block's gradients in f64, by autograd of its forward written out afresh in
    f64, in the order and layouts of ``linear_attention_bwd_plain``'s. An exact yardstick
    for the f32 kernel where the plain f32 version's own rounding is of the order of the
    tolerance: inputs whose q logits reach ~1e3 through a near one-hot softmax. Takes
    tensors made under ``torch.inference_mode`` too: it computes on f64 copies, with
    autograd on."""

    def rms(t, g):
        return t * torch.rsqrt((t * t).sum(-1, keepdim=True) + _EPS) * g * c**0.5

    b, n, c = x.shape
    with torch.inference_mode(False), torch.enable_grad():
        x, g0, wqkv, mem, wo, bo, g1, dout = (
            t.detach().to(torch.float64, copy=True)
            for t in (x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1, dout)
        )
        inputs = [x, g0, wqkv, mem, wo, bo, g1]
        for t in inputs:
            t.requires_grad_()
        q, k, v = (rms(x, g0) @ wqkv).reshape(b, n, 3, heads, dim_head).unbind(2)
        memk, memv = (mem[i].permute(2, 0, 1).expand(b, -1, -1, -1) for i in (0, 1))
        ke = torch.softmax(torch.cat([k, memk], 1), 1)  # over tokens and memory tokens
        context = torch.einsum("bnhd,bnhe->bhde", ke, torch.cat([v, memv], 1))
        a = torch.einsum("bnhd,bhde->bnhe", torch.softmax(q, -1) * dim_head**-0.5, context)
        out = rms(a.reshape(b, n, heads * dim_head) @ wo + bo, g1)
        if residual:
            out = out + x
        return list(torch.autograd.grad(out, inputs, dout))


def _library(name: str, fn_name: str, argtypes: list) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def _workspace(lib, fn_name: str, b, n, c, m, bf16, device) -> torch.Tensor:
    """The device scratch a kernel asks for at these shapes (rounded weights, per-block
    partials, the rows' contexts and, for the backward, the intermediates)."""
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_size_t
    return torch.empty(fn(b, n, c, m, bf16), dtype=torch.uint8, device=device)


# Pointers and the stream as c_void_p: as plain ints ctypes would cut them to 32 bits.
_FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _kernel_args(x, params, heads, dim_head, dtype, what):
    """Check what the kernels take; returns (b, n, c, m) and the f32 parameters."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
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
    hd = heads * dim_head
    m = params[2].shape[-1]
    shapes = ((c,), (c, 3 * hd), (2, heads, dim_head, m), (hd, c), (c,), (c,))
    for t, shape in zip(params, shapes):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"parameter of shape {tuple(t.shape)} on {t.device} does not fit "
                f"{shape} on {x.device}"
            )
    return (b, n, c, m), [t.detach().to(torch.float32).contiguous() for t in params]


def linear_attention_cuda(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
    heads: int, dim_head: int, dtype: torch.dtype, residual: bool = False,
) -> torch.Tensor:
    """The block through the forward CUDA kernel, with no autograd graph (use
    ``linear_attention`` for that). Raises ValueError for what the kernel does not
    take. Counts its launches in ``linear_attention.launches``."""
    (b, n, c, m), params = _kernel_args(
        x, (g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1), heads, dim_head, dtype,
        "linear_attention_cuda")
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    bf16 = int(x.dtype == torch.bfloat16)

    lib = _library("linear_attention", "lgm_linear_attention_fwd", _FWD_ARGTYPES)
    workspace = _workspace(lib, "lgm_linear_attention_fwd_workspace", b, n, c, m, bf16, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lgm_linear_attention_fwd(
            x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(),
            workspace.data_ptr(), b, n, c, m, int(residual), bf16, stream,
        )
    cuda_build.check(lib, err, "linear attention kernel")
    linear_attention.launches += 1
    return out


def linear_attention_bwd_cuda(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1, dout,
    heads: int, dim_head: int, dtype: torch.dtype, residual: bool = False,
):
    """The block's gradient through the backward CUDA kernel
    (``csrc/linear_attention_bwd.cu``): ``(dx, dg0, dqkv_kernel, dmem_kv,
    dout_kernel, dout_bias, dg1)`` as ``linear_attention_bwd_plain`` returns them.
    Raises ValueError for what the kernel does not take. Counts its launches in
    ``linear_attention_bwd.launches``."""
    (b, n, c, m), params = _kernel_args(
        x, (g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1), heads, dim_head, dtype,
        "linear_attention_bwd_cuda")
    if m > KERNEL_BWD_MAX_MEM:
        raise ValueError(f"the backward kernel takes at most {KERNEL_BWD_MAX_MEM} memory "
                         f"tokens, got {m}")
    if tuple(dout.shape) != tuple(x.shape) or dout.device != x.device:
        raise ValueError(f"dout of shape {tuple(dout.shape)} on {dout.device} does not fit "
                         f"x of shape {tuple(x.shape)} on {x.device}")
    x = x.detach().contiguous()
    dout = dout.detach().to(x.dtype).contiguous()
    bf16 = int(x.dtype == torch.bfloat16)

    lib = _library("linear_attention_bwd", "lgm_linear_attention_bwd", _BWD_ARGTYPES)
    workspace = _workspace(lib, "lgm_linear_attention_bwd_workspace", b, n, c, m, bf16, x.device)
    grads = [torch.empty_like(x)] + [torch.empty_like(t) for t in params]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lgm_linear_attention_bwd(
            x.data_ptr(), *(t.data_ptr() for t in params), dout.data_ptr(),
            *(g.data_ptr() for g in grads), workspace.data_ptr(),
            b, n, c, m, int(residual), bf16, stream,
        )
    cuda_build.check(lib, err, "linear attention backward kernel")
    linear_attention_bwd.launches += 1
    return tuple(grads)


class FusedLinearAttention(torch.autograd.Function):
    """The block on the card with its gradient: forward through the forward kernel,
    backward through the backward kernel. The backward recomputes what it needs from
    the saved inputs, as the JAX package's custom VJP does; nothing of the forward's
    intermediates is kept."""

    @staticmethod
    def forward(ctx, x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
                heads, dim_head, dtype, residual):
        out = linear_attention_cuda(x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
                                    heads, dim_head, dtype, residual)
        ctx.save_for_backward(x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1)
        ctx.config = (heads, dim_head, dtype, residual)
        return out

    @staticmethod
    def backward(ctx, dout):
        inputs = ctx.saved_tensors
        grads = linear_attention_bwd_cuda(*inputs, dout, *ctx.config)
        grads = [g.to(t.dtype) for g, t in zip(grads, inputs)]
        return (*grads, None, None, None, None)


def linear_attention(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
    heads: int, dim_head: int, dtype: torch.dtype = torch.float32,
    residual: bool = False,
) -> torch.Tensor:
    """The block on x's device: on a CUDA tensor the kernels, through
    ``FusedLinearAttention``; on a CPU tensor the plain version, differentiated by
    torch autograd. ``linear_attention.launches`` counts the forward kernel's
    launches, ``linear_attention_bwd.launches`` the backward kernel's."""
    if x.device.type == "cuda":
        return FusedLinearAttention.apply(
            x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
            heads, dim_head, dtype, residual,
        )
    if x.device.type == "cpu":
        return linear_attention_plain(
            x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1,
            heads, dim_head, dtype, residual,
        )
    raise ValueError(f"linear_attention runs on cuda or cpu, got {x.device}")


def linear_attention_bwd(
    x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1, dout,
    heads: int, dim_head: int, dtype: torch.dtype = torch.float32,
    residual: bool = False,
):
    """The block's gradient on x's device: the backward kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    fn = {"cuda": linear_attention_bwd_cuda, "cpu": linear_attention_bwd_plain}.get(
        x.device.type)
    if fn is None:
        raise ValueError(f"linear_attention_bwd runs on cuda or cpu, got {x.device}")
    return fn(x, g0, qkv_kernel, mem_kv, out_kernel, out_bias, g1, dout,
              heads, dim_head, dtype, residual)


linear_attention.launches = 0
linear_attention_bwd.launches = 0
