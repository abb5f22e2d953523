"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and skips without one. The file imports neither JAX
nor the JAX package, so on a machine with a card and without JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

from lightning_generative_models_tpu_torch.data.pipeline import prefetch_to_device
from lightning_generative_models_tpu_torch.ops import linear_attention as TLA

pytestmark = pytest.mark.gpu


def _la_args(b, n, c, dtype, heads=4, dim_head=32, m=4, seed=0):
    rs = np.random.RandomState(seed)
    hd = heads * dim_head
    args = [
        rs.randn(b, n, c), rs.randn(c) * 0.1 + 1.0, rs.randn(c, 3 * hd) * c**-0.5,
        rs.randn(2, heads, dim_head, m), rs.randn(hd, c) * hd**-0.5,
        rs.randn(c) * 0.1, rs.randn(c) * 0.1 + 1.0,
    ]
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in args]
    args[0] = args[0].to(dtype)
    return args


# (b, n, c, m): the UNet's five shapes at b 8; n 32, 96 and 160 (not multiples of 64: a
# row's 16-token subtiles do not fill a four-warp block evenly) at c 64 and 256; b 1; one
# memory token, and eight (the backward's most).
LA_CASES = [(8, 1024, 64, 4), (8, 256, 64, 4), (8, 256, 128, 4), (8, 64, 128, 4),
            (8, 64, 256, 4), (8, 32, 64, 4), (8, 96, 64, 4), (8, 160, 64, 4), (8, 32, 256, 4),
            (8, 96, 256, 4), (8, 160, 256, 4), (1, 96, 64, 4), (1, 160, 256, 4),
            (4, 64, 64, 1), (4, 256, 128, 8)]


# bf16: the kernel keeps q, k, v and y in f32 where the plain version rounds them to
# bf16, a few bf16 ulps (2^-8) apart on outputs of magnitude up to ~10.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("b,n,c,m", LA_CASES)
def test_linear_attention_kernel_matches_plain(b, n, c, m, residual, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _la_args(b, n, c, dtype, m=m)
    before = TLA.linear_attention.launches
    with torch.inference_mode():
        out = TLA.linear_attention(*args, 4, 32, dtype, residual).float()
        ref = TLA.linear_attention_plain(*args, 4, 32, dtype, residual).float()
    assert TLA.linear_attention.launches == before + 1
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


def test_linear_attention_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    args = _la_args(2, 48, 64, torch.float32)  # n not a multiple of 32
    with torch.inference_mode(), pytest.raises(ValueError, match="multiple of"):
        TLA.linear_attention(*args, 4, 32, torch.float32)
    args = _la_args(2, 64, 64, torch.float32)
    args[1].requires_grad_(True)  # a gradient flows, through the backward kernel
    before = TLA.linear_attention_bwd.launches
    TLA.linear_attention(*args, 4, 32, torch.float32).sum().backward()
    assert TLA.linear_attention_bwd.launches == before + 1
    assert args[1].grad is not None and bool(torch.isfinite(args[1].grad).all())


def _rel_err(out, ref):
    """max |k - p| / (1 + max |p|): the weight grads are sums over b * n tokens, so the
    error is scaled by the tensor's largest magnitude, not element by element."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / (1.0 + ref.abs().max())).item()


# bf16: the kernel rounds at the plain version's points, but the f32 sums ahead of each
# rounding run in another order, so a value can land one bf16 ulp (2^-8 = 3.9e-3) away
# and carry that through the later products.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("b,n,c,m", LA_CASES)
def test_linear_attention_bwd_kernel_matches_plain(b, n, c, m, residual, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _la_args(b, n, c, dtype, m=m)
    dout = torch.tensor(np.random.RandomState(1).randn(b, n, c), dtype=dtype, device="cuda")
    before = TLA.linear_attention_bwd.launches
    out = TLA.linear_attention_bwd(*args, dout, 4, 32, dtype, residual)
    ref = TLA.linear_attention_bwd_plain(*args, dout, 4, 32, dtype, residual)
    assert TLA.linear_attention_bwd.launches == before + 1
    for k, p in zip(out, ref):
        assert k.shape == p.shape and k.dtype == p.dtype
        assert bool(torch.isfinite(k.float()).all())
        assert _rel_err(k, p) <= tol
    # The k columns of dW on their own: dk flows through the k softmax over the tokens.
    assert _rel_err(out[2][:, 128:256], ref[2][:, 128:256]) <= tol


# The head-scale-disparity input (head 0's q logits ~300x the others', up to ~1e3) in f32
# at the UNet's five shapes: the gradients against the exact f64 ones, since there the plain
# f32 version's own rounding, through the near one-hot softmax of head 0, is of the order of
# the tolerance.
@pytest.mark.parametrize("n,c", [(1024, 64), (256, 64), (256, 128), (64, 128), (64, 256)])
def test_linear_attention_bwd_kernel_disparity_matches_exact(n, c):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    args = _la_args(32, n, c, torch.float32)
    args[2][:, :32] *= 300.0
    dout = torch.tensor(np.random.RandomState(1).randn(32, n, c), dtype=torch.float32,
                        device="cuda")
    out = TLA.linear_attention_bwd_cuda(*args, dout, 4, 32, torch.float32, True)
    exact = TLA.linear_attention_bwd_exact(*args, dout, 4, 32, True)
    for k, t in zip(out, exact):
        assert k.shape == t.shape
        assert _rel_err(k, t) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_kernel_is_deterministic(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    args = _la_args(16, 256, 64, dtype)
    with torch.inference_mode():
        first = TLA.linear_attention_cuda(*args, 4, 32, dtype, True)
        second = TLA.linear_attention_cuda(*args, 4, 32, dtype, True)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_bwd_kernel_is_deterministic(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    args = _la_args(16, 256, 64, dtype)
    dout = torch.tensor(np.random.RandomState(2).randn(16, 256, 64), dtype=dtype,
                        device="cuda")
    first = TLA.linear_attention_bwd_cuda(*args, dout, 4, 32, dtype, True)
    second = TLA.linear_attention_bwd_cuda(*args, dout, 4, 32, dtype, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_linear_attention_grads_match_autograd_through_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = _la_args(4, 256, 128, torch.float32)
    dout = torch.tensor(np.random.RandomState(3).randn(4, 256, 128), dtype=torch.float32,
                        device="cuda")
    grads = []
    for fn in (TLA.linear_attention, TLA.linear_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in base]
        fn(*leaves, 4, 32, torch.float32, True).backward(dout)
        grads.append([t.grad for t in leaves])
    for k, p in zip(*grads):
        assert _rel_err(k, p) <= 1e-4


def test_prefetch_to_device_delivers_every_batch_in_order():
    """The side-stream copies are ordered before use: a kernel that reads each batch
    at once on the consumer's stream sees the host's bytes, for many small batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rs = np.random.RandomState(4)
    host = [{"image": rs.randint(0, 256, (64, 32, 32, 3)).astype(np.uint8),
             "label": np.full(64, i, np.int32)} for i in range(200)]
    sums = []
    for batch in prefetch_to_device(iter(host), "cuda", size=4):
        assert batch["image"].is_cuda and batch["image"].dtype == torch.uint8
        sums.append((batch["image"].int().sum(), batch["label"][0]))
    assert len(sums) == len(host)
    for (total, label), h in zip(sums, host):
        assert int(total) == int(h["image"].astype(np.int64).sum())
        assert int(label) == int(h["label"][0])


def test_prefetch_to_device_stops_its_thread_when_abandoned():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import threading

    host = ({"x": np.full((8,), i, np.float32)} for i in range(1000))
    it = prefetch_to_device(host, "cuda", size=2)
    assert float(next(it)["x"][0]) == 0.0
    it.close()
    assert not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate())


def _vq_inputs(n, k, d, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.tensor(rs.randn(n, d), dtype=torch.float32, device="cuda"),
            torch.tensor(rs.randn(k, d), dtype=torch.float32, device="cuda"))


def _vq_near_ties_hold(flat, codebook, idx, tol=1e-5):
    """Each row's chosen code is within tol * (1 + |d_min|) of its true nearest distance
    (f64 on the card)."""
    dist = torch.cdist(flat.double(), codebook.double()) ** 2
    d_min = dist.min(dim=1).values
    chosen = dist.gather(1, idx.long()[:, None])[:, 0]
    return bool((chosen <= d_min + tol * (1.0 + d_min.abs())).all())


@pytest.mark.parametrize("n,k,d", [(1024, 512, 64), (4096, 512, 64), (16384, 512, 64),
                                   (1000, 512, 64), (37, 100, 8), (513, 130, 128)])
def test_vq_kernel_matches_plain(n, k, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import vq

    flat, codebook = _vq_inputs(n, k, d)
    before = vq.nearest_codes.launches
    out = vq.nearest_codes(flat, codebook)
    assert vq.nearest_codes.launches == before + 1
    ref = vq.nearest_codes_plain(flat, codebook)
    assert out.dtype == torch.int32 and out.shape == (n,)
    assert _vq_near_ties_hold(flat, codebook, out)
    assert float((out == ref).float().mean()) >= 0.999
    assert torch.equal(out, vq.nearest_codes(flat, codebook))  # repeats bit for bit


def test_vq_kernel_first_index_on_duplicated_codebook_and_refusals():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import vq

    flat, base = _vq_inputs(4096, 256, 64, seed=1)
    assert bool((vq.nearest_codes(flat, torch.cat([base, base])) < 256).all())
    assert bool((vq.nearest_codes(flat, base.repeat_interleave(2, dim=0)) % 2 == 0).all())
    with pytest.raises(ValueError, match="takes D in"):
        vq.nearest_codes(flat[:, :48], base[:, :48])


def test_vq_kernel_first_index_across_cluster_shares_and_nan_rows():
    """The kernel splits the codebook between the blocks of a cluster (halves, in 64-code
    tiles): a code and its copy in the other half ([E; E] at K 1,024), or in another tile
    ([E; E] at K 200), give the first index; a row of NaN still gets a code of the book
    and leaves the other rows as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import vq

    flat, base = _vq_inputs(4096, 512, 64, seed=2)
    ref = vq.nearest_codes(flat, base)
    assert torch.equal(vq.nearest_codes(flat, torch.cat([base, base])), ref)
    small = base[:100]
    assert torch.equal(vq.nearest_codes(flat, torch.cat([small, small])),
                       vq.nearest_codes(flat, small))
    nan_rows = flat.clone()
    nan_rows[[7, 4000]] = float("nan")
    out = vq.nearest_codes(nan_rows, base)
    assert bool(((out >= 0) & (out < 512)).all())
    keep = torch.ones(4096, dtype=torch.bool, device="cuda")
    keep[[7, 4000]] = False
    assert torch.equal(out[keep], ref[keep])


# -- packed-qkv softmax attention (kernels #3 and #4) ----------------------------------

# (b, n, heads, d): DiT-S/2's shape (n 256, d 64) at a small batch, a ragged n, heads 8 at
# d 48 (the tp/MoE DiT configs), one token, and the widest head the kernels take; then the
# kernels' 64-row tiles' edges (n one below, at and one above a multiple of 64) at the
# head widths whose k steps differ: d 8 and 48 (not a multiple of the bf16 product's 16,
# so the k step is zero-padded), 32 and 128.
ATTN_SHAPES = [(8, 256, 6, 64), (4, 200, 6, 64), (4, 64, 8, 48), (2, 1, 2, 8),
               (2, 100, 1, 128), (2, 63, 2, 8), (2, 64, 2, 32), (2, 65, 3, 48),
               (2, 127, 2, 128), (2, 129, 2, 48)]
# Forward, on max |k - p| / (1 + |p|). f32: the order of f32 sums. bf16: the kernel keeps
# the logits, the softmax and p v in f32 and rounds the output once; the plain version
# rounds the logits (steps of 2^-6 at magnitude 2-4), the probabilities and the output to
# bf16, a few percent of an output of magnitude ~1 (ATTN_BF16_MATH: against the plain
# version's math in f32 on the same bf16 inputs, where only the output rounding is left).
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
ATTN_BF16_MATH = 8e-3
# Backward, on max |k - p| / (1 + max |p|). Both compute in f32 from the same inputs; in
# bf16 an f32 value that the two sum in another order can round to the next bf16 step
# (2^-8 relative).
ATTN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _attn_inputs(b, n, heads, d, dtype, seed=0):
    rs = np.random.RandomState(seed)
    qkv = torch.tensor(rs.randn(b, n, 3 * heads * d), dtype=torch.float32, device="cuda")
    g = torch.tensor(rs.randn(b, n, heads * d), dtype=torch.float32, device="cuda")
    return qkv.to(dtype), g.to(dtype)


def _rel_elementwise(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (1.0 + ref.abs())).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["s3hd", "h3d"])
@pytest.mark.parametrize("b,n,heads,d", ATTN_SHAPES)
def test_attention_qkv_kernel_matches_plain(b, n, heads, d, layout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import attention as TA

    qkv, _ = _attn_inputs(b, n, heads, d, dtype)
    before = TA.fused_attention_qkv.launches
    with torch.inference_mode():
        out = TA.fused_attention_qkv(qkv, heads, layout)
        ref = TA.attention_qkv_plain(qkv, heads, layout)
        again = TA.attention_qkv_cuda(qkv, heads, layout)
    assert TA.fused_attention_qkv.launches == before + 2
    assert out.shape == ref.shape == (b, n, heads * d) and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    assert _rel_elementwise(out, ref) <= ATTN_TOL[dtype]
    assert torch.equal(out, again)
    if dtype == torch.bfloat16:
        math = TA.attention_qkv_plain(qkv.float(), heads, layout)
        assert _rel_elementwise(out, math) <= ATTN_BF16_MATH


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["s3hd", "h3d"])
@pytest.mark.parametrize("b,n,heads,d", ATTN_SHAPES)
def test_attention_qkv_bwd_kernel_matches_plain(b, n, heads, d, layout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import attention as TA

    qkv, g = _attn_inputs(b, n, heads, d, dtype, seed=1)
    before = TA.fused_attention_qkv_bwd.launches
    out = TA.fused_attention_qkv_bwd(qkv, g, heads, layout)
    again = TA.attention_qkv_bwd_cuda(qkv, g, heads, layout)
    ref = TA.attention_qkv_bwd_plain(qkv, g, heads, layout)
    assert TA.fused_attention_qkv_bwd.launches == before + 2
    assert out.shape == qkv.shape and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    assert _rel_err(out, ref) <= ATTN_BWD_TOL[dtype]
    assert torch.equal(out, again)  # no float atomics: repeats bit for bit


@pytest.mark.parametrize("layout", ["s3hd", "h3d"])
def test_fused_attention_qkv_grads_match_autograd_through_plain(layout):
    """f32: the autograd path (forward kernel, then backward kernel) against torch
    autograd through the plain version. (In bf16, autograd through the plain version
    rounds dP and dS to bf16 and is no yardstick.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import attention as TA

    base, g = _attn_inputs(4, 200, 6, 64, torch.float32, seed=2)
    outs, grads = [], []
    for fn in (TA.fused_attention_qkv, TA.attention_qkv_plain):
        leaf = base.clone().requires_grad_(True)
        out = fn(leaf, 6, layout)
        out.backward(g)
        outs.append(out.detach())
        grads.append(leaf.grad)
    assert _rel_elementwise(*outs) <= 1e-4
    assert _rel_err(*grads) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_qkv_kernels_take_misaligned_rows(dtype):
    """A packed qkv (and a cotangent) one element into its buffer cannot be read as
    16-byte chunks: the wrappers copy it first, with the same results as on aligned
    tensors, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import attention as TA

    qkv, g = _attn_inputs(2, 70, 2, 32, dtype, seed=4)
    shifted = torch.zeros(qkv.numel() + g.numel() + 2, dtype=dtype, device="cuda")
    qkv_off = shifted[1:1 + qkv.numel()].view(qkv.shape)
    g_off = shifted[2 + qkv.numel():].view(g.shape)
    qkv_off.copy_(qkv)
    g_off.copy_(g)
    assert qkv_off.is_contiguous() and not TA._rows_aligned(qkv_off)
    assert not TA._rows_aligned(g_off)
    with torch.inference_mode():
        assert torch.equal(TA.attention_qkv_cuda(qkv_off, 2), TA.attention_qkv_cuda(qkv, 2))
        assert torch.equal(TA.attention_qkv_bwd_cuda(qkv_off, g_off, 2),
                           TA.attention_qkv_bwd_cuda(qkv, g, 2))


def test_attention_qkv_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import attention as TA

    for heads, d in ((2, 12), (1, 136)):
        qkv, _ = _attn_inputs(2, 16, heads, d, torch.float32)
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            TA.fused_attention_qkv(qkv, heads)
    qkv, g = _attn_inputs(2, 16, 2, 16, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TA.fused_attention_qkv(qkv, 2)
    with pytest.raises(ValueError, match="does not fit"):
        TA.attention_qkv_bwd_cuda(qkv.float(), g[..., :8].float(), 2)


# Flash attention (b, heads, n_q, n_kv, d): DiT-S/2's shape at a small batch, the UNet's
# flash shape (16 x 16 queries, 4 memory keys more), a ragged n and a long n.
FLASH_SHAPES = [(4, 6, 256, 256, 64), (2, 4, 256, 260, 32), (2, 2, 300, 300, 64),
                (1, 2, 1024, 1024, 32)]


def _bhnd_inputs(b, heads, n_q, n_kv, d, dtype, seed=0):
    rs = np.random.RandomState(seed)
    shapes = [(b, heads, n_q, d), (b, heads, n_kv, d), (b, heads, n_kv, d), (b, heads, n_q, d)]
    return [torch.tensor(rs.randn(*s), dtype=torch.float32, device="cuda").to(dtype)
            for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,n_q,n_kv,d", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(b, heads, n_q, n_kv, d, dtype):
    """As the packed-qkv kernel: f32 within 1e-4, bf16 loosely against the plain version
    (which rounds the logits and the softmax to bf16) and within one output rounding of
    the plain math in f32; repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import attention as TA

    q, k, v, _ = _bhnd_inputs(b, heads, n_q, n_kv, d, dtype)
    before = TA.flash_attention.launches, TA.fused_attention_qkv.launches
    with torch.inference_mode():
        out = TA.scaled_dot_product_attention(q, k, v, use_pallas=True)
        again = TA.flash_attention_cuda(q, k, v)
        ref = TA.flash_attention_plain(q, k, v)
    assert (TA.flash_attention.launches, TA.fused_attention_qkv.launches) == \
        (before[0] + 2, before[1])
    assert out.shape == ref.shape == (b, heads, n_q, d) and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    assert _rel_elementwise(out, ref) <= ATTN_TOL[dtype]
    assert torch.equal(out, again)
    if dtype == torch.bfloat16:
        math = TA.flash_attention_plain(q.float(), k.float(), v.float())
        assert _rel_elementwise(out, math) <= ATTN_BF16_MATH


# The bf16 kernel's edges (b, heads, n_q, n_kv, d): head widths whose k steps are
# zero-filled past d (8, 24, 48) and the two 64-column slabs of d 128; one ragged key tile
# (n_kv < 64); a single query; more queries than keys, and fewer.
FLASH_BF16_EDGES = [(2, 3, 200, 200, 8), (2, 3, 200, 200, 24), (2, 3, 200, 200, 48),
                    (2, 2, 260, 260, 128), (2, 2, 100, 37, 64), (2, 2, 1, 300, 64),
                    (2, 3, 300, 70, 48), (2, 3, 70, 300, 48)]


@pytest.mark.parametrize("b,heads,n_q,n_kv,d", FLASH_BF16_EDGES)
def test_flash_attention_bf16_kernel_at_its_edges(b, heads, n_q, n_kv, d):
    """The bf16 kernel (TMA tiles, wgmma) at the edges of its tiles: loosely against the
    plain version, within one output rounding of the plain math in f32, repeats bit for
    bit, counted as flash launches only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import attention as TA

    q, k, v, _ = _bhnd_inputs(b, heads, n_q, n_kv, d, torch.bfloat16, seed=3)
    before = TA.flash_attention.launches, TA.fused_attention_qkv.launches
    with torch.inference_mode():
        out = TA.flash_attention_cuda(q, k, v)
        again = TA.flash_attention_cuda(q, k, v)
        ref = TA.flash_attention_plain(q, k, v)
        math = TA.flash_attention_plain(q.float(), k.float(), v.float())
    assert (TA.flash_attention.launches, TA.fused_attention_qkv.launches) == \
        (before[0] + 2, before[1])
    assert out.shape == (b, heads, n_q, d) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    assert _rel_elementwise(out, ref) <= ATTN_TOL[torch.bfloat16]
    assert _rel_elementwise(out, math) <= ATTN_BF16_MATH


def test_flash_attention_f32_route_is_counted_as_flash():
    """In f32 the flash entry launches kernel #3's forward on the same strides: the plain
    version's result within 1e-4, counted in flash_attention.launches and not in
    fused_attention_qkv.launches, so that the flash paths' counts stay exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import attention as TA

    q, k, v, _ = _bhnd_inputs(2, 3, 130, 70, 48, torch.float32, seed=4)
    before = TA.flash_attention.launches, TA.fused_attention_qkv.launches
    with torch.inference_mode():
        out = TA.flash_attention_cuda(q, k, v)
        again = TA.flash_attention_cuda(q, k, v)
    assert (TA.flash_attention.launches, TA.fused_attention_qkv.launches) == \
        (before[0] + 2, before[1])
    assert torch.equal(out, again)
    assert _rel_elementwise(out, TA.flash_attention_plain(q, k, v)) <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("layout", ["s3hd", "h3d"])
def test_flash_attention_kernel_reads_the_dits_packed_views(layout):
    """The DiT's flash branch: q, k, v as [b, h, n, d] views of the packed qkv, read in
    place, and the backward route's cotangent as the view of a [b, n, h, d] tensor, with
    the gradients written at the views' strides; the same results as on contiguous
    copies, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import attention as TA

    qkv, g = _attn_inputs(4, 256, 6, 64, torch.bfloat16)
    shape = (4, 256, 6, 3, 64) if layout == "h3d" else (4, 256, 3, 6, 64)
    x = qkv.view(*shape)
    views = [(x[..., i, :] if layout == "h3d" else x[:, :, i]).transpose(1, 2)
             for i in range(3)]
    g = g.view(4, 256, 6, 64).transpose(1, 2)
    copies = [t.contiguous() for t in views]
    with torch.inference_mode():
        out = TA.flash_attention_cuda(*views)
        ref = TA.flash_attention_cuda(*copies)
        grads = TA.flash_attention_bwd_cuda(*views, g)
        grads_ref = TA.flash_attention_bwd_cuda(*copies, g.contiguous())
    assert out.transpose(1, 2).is_contiguous()  # the caller's transpose back is free
    assert torch.equal(out, ref)
    for grad, view, grad_ref in zip(grads, views, grads_ref):
        assert grad.stride() == view.stride() and torch.equal(grad, grad_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_misaligned_rows(dtype):
    """Rows the kernel cannot read as 16-byte chunks (a view one element into its buffer,
    a token stride of d + 1 elements) are copied first: the same result as on
    contiguous copies, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import attention as TA

    q, k, v, _ = _bhnd_inputs(2, 2, 256, 256, 32, dtype)
    shifted = torch.zeros(q.numel() + 1, dtype=dtype, device="cuda")
    shifted[1:] = q.reshape(-1)
    q_off = shifted[1:].view(q.shape)
    wide = torch.zeros(2, 2, 256, 33, dtype=dtype, device="cuda")
    wide[..., :32] = k
    k_wide = wide[..., :32]
    assert not TA._rows_aligned(q_off) and not TA._rows_aligned(k_wide)
    with torch.inference_mode():
        out = TA.flash_attention_cuda(q_off, k_wide, v)
        ref = TA.flash_attention_cuda(q, k, v)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("b,heads,n_q,n_kv,d", FLASH_SHAPES)
def test_flash_attention_grads_match_autograd_through_plain(b, heads, n_q, n_kv, d):
    """f32: the flash path's autograd (the flash kernel, then the packed-qkv backward
    kernel on [b, h, n, d] strides) against torch autograd through the plain version;
    the backward's launches counted apart from the packed path's. bf16: the backward
    kernel against the plain gradient in f32 on the same inputs, one rounding apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import attention as TA

    *qkv, g = _bhnd_inputs(b, heads, n_q, n_kv, d, torch.float32, seed=1)
    before = TA.flash_attention_bwd_cuda.launches, TA.fused_attention_qkv_bwd.launches
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    TA.flash_attention(*leaves).backward(g)
    assert (TA.flash_attention_bwd_cuda.launches, TA.fused_attention_qkv_bwd.launches) == \
        (before[0] + 1, before[1])
    ref = TA.flash_attention_bwd_plain(*qkv, g)
    for leaf, r in zip(leaves, ref):
        assert _rel_err(leaf.grad, r) <= ATTN_BWD_TOL[torch.float32]
    low = [t.to(torch.bfloat16) for t in (*qkv, g)]
    out = TA.flash_attention_bwd_cuda(*low)
    again = TA.flash_attention_bwd_cuda(*low)
    ref = TA.flash_attention_bwd_plain(*(t.float() for t in low))
    for o, a, r in zip(out, again, ref):
        assert o.dtype == torch.bfloat16 and torch.equal(o, a)
        assert _rel_err(o, r) <= ATTN_BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,n_q,n_kv,d", [(2, 3, 130, 70, 48), (1, 2, 64, 193, 8)])
def test_flash_attention_bwd_route_at_unequal_lengths(b, heads, n_q, n_kv, d, dtype):
    """The backward kernel through the flash route with more queries than keys and fewer,
    both ragged against the 64-row tiles: against the plain gradient in f32 on the same
    inputs, each gradient at its input's shape, repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lightning_generative_models_tpu_torch.ops import attention as TA

    *qkv, g = _bhnd_inputs(b, heads, n_q, n_kv, d, dtype, seed=5)
    with torch.inference_mode():
        out = TA.flash_attention_bwd_cuda(*qkv, g)
        again = TA.flash_attention_bwd_cuda(*qkv, g)
    ref = TA.flash_attention_bwd_plain(*(t.float() for t in (*qkv, g)))
    for o, a, r, t in zip(out, again, ref, qkv):
        assert o.shape == t.shape and o.dtype == dtype and torch.equal(o, a)
        assert _rel_err(o, r) <= ATTN_BWD_TOL[dtype]


def test_flash_attention_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import attention as TA

    q, k, v, _ = _bhnd_inputs(1, 2, 256, 256, 136, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        TA.flash_attention(q, k, v)
    q, k, v, _ = _bhnd_inputs(1, 2, 256, 256, 12, torch.float32)
    out = TA.scaled_dot_product_attention(q, k, v, use_pallas=True)  # d % 8: not the gate
    assert torch.equal(out, TA.flash_attention_plain(q, k, v))
    q, k, v, _ = _bhnd_inputs(1, 2, 256, 256, 32, torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        TA.flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="do not fit"):
        TA.flash_attention_cuda(q, k[:, :1], v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 32, 32, 3), (64, 64, 64, 3), (3, 5, 7, 1),
                                   (3, 5, 7, 2), (2, 3, 6000, 3), (4, 33, 130, 3)])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_normalize_flip_kernel_matches_plain(shape, dtype, offset):
    """Bit for bit in f32 (the same f32 product); in bf16 within one bf16 step (both
    round the same f32 value once). prepare_batch(backend="pallas") launches it. The
    shapes take the kernel's paths: C = 1, 3 and one read at run time (2), a row wider
    than its shared tile (6000 x 3), bands of rows (33 x 130 x 3); ``offset`` 1 passes a
    batch that starts one image into its storage, so that its bytes start unaligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lightning_generative_models_tpu_torch.ops import preprocess as TP

    rs = np.random.RandomState(3)
    images = torch.tensor(rs.randint(0, 256, (offset + shape[0], *shape[1:])).astype(np.uint8),
                          device="cuda")[offset:]
    flip = torch.tensor(rs.rand(shape[0]) < 0.5, device="cuda")
    before = TP.fused_normalize_flip.launches
    out = TP.fused_normalize_flip(images, flip, dtype)
    batch = TP.prepare_batch({"image": images}, train=True, flip=flip, dtype=dtype,
                             backend="pallas")
    assert TP.fused_normalize_flip.launches == before + 2
    ref = TP.fused_normalize_flip_plain(images, flip, dtype)
    assert out.dtype == dtype and out.shape == shape and torch.equal(batch["image"], out)
    if dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=0, rtol=2.0**-7)
