"""Cases of the port's packed-qkv attention against the JAX package's, on the CPU, imported
by ``test_torch_attention_qkv.py`` (forward), ``test_torch_attention_qkv_bwd.py``
(backward) and ``test_torch_attention_qkv_checks.py`` (bf16, offsets, dispatch, errors).

``attention_qkv_plain`` (the port's path on a CPU tensor, and the forward kernel's
yardstick) and ``attention_qkv_bwd_plain`` (the backward kernel's yardstick) take the same
numpy qkv and cotangent as three JAX references: the Pallas kernels
``_vmem_attention_fwd_impl`` / ``_vmem_attention_bwd_impl`` in interpret mode, which run
``_vmem_attn_fwd_kernel`` / ``_vmem_attn_bwd_kernel`` themselves, and
``_einsum_attention_qkv`` (with ``jax.vjp`` for the gradient), the JAX package's own path
off a TPU. Both layouts, several (n, heads, d), one n that is no multiple of 8. In f32
the four differ only in the order of f32 sums: the forward within 1e-5, the gradient
within 1e-4 of its largest magnitude (a sum over n keys of products of magnitude ~1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightning_generative_models_tpu.ops.attention as JA
from lightning_generative_models_tpu_torch.ops import attention as TA

torch.set_num_threads(1)

FWD_TOL = 1e-5
BWD_TOL = 1e-4
# (n, heads, d): d 8 and 16 small; 48 as at heads 8 of the tp/MoE DiT configs; n 40 ragged.
SHAPES = [(16, 2, 8), (40, 3, 16), (64, 2, 48)]
B = 2


def _inputs(n, heads, d, seed=0):
    rs = np.random.RandomState(seed)
    qkv = (rs.randn(B, n, 3 * heads * d) * 1.5).astype(np.float32)
    g = rs.randn(B, n, heads * d).astype(np.float32)
    return qkv, g


def _rel_to_max(out, ref) -> float:
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(ref).max())


@pytest.mark.parametrize("layout", JA.LAYOUTS)
@pytest.mark.parametrize("n,heads,d", SHAPES)
def test_forward_plain_matches_jax_pallas_and_einsum(monkeypatch, n, heads, d, layout):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    qkv, _ = _inputs(n, heads, d)
    out = TA.attention_qkv_plain(torch.from_numpy(qkv), heads, layout).numpy()
    pallas = np.asarray(JA._vmem_attention_fwd_impl(jnp.asarray(qkv), heads, layout))
    einsum = np.asarray(JA._einsum_attention_qkv(jnp.asarray(qkv), heads, layout))
    assert out.shape == pallas.shape == (B, n, heads * d)
    np.testing.assert_allclose(out, pallas, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(out, einsum, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("layout", JA.LAYOUTS)
@pytest.mark.parametrize("n,heads,d", SHAPES)
def test_backward_plain_and_autograd_match_jax_pallas_and_vjp(monkeypatch, n, heads, d,
                                                              layout):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    qkv, g = _inputs(n, heads, d, seed=1)
    pallas = np.asarray(JA._vmem_attention_bwd_impl(jnp.asarray(qkv), jnp.asarray(g),
                                                    heads, layout))
    _, vjp = jax.vjp(lambda x: JA._einsum_attention_qkv(x, heads, layout), jnp.asarray(qkv))
    (einsum,) = vjp(jnp.asarray(g))

    plain = TA.attention_qkv_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(g), heads,
                                       layout).numpy()
    leaf = torch.from_numpy(qkv).requires_grad_(True)
    TA.fused_attention_qkv(leaf, heads, layout).backward(torch.from_numpy(g))
    autograd = leaf.grad.numpy()
    for port in (plain, autograd):
        assert port.shape == pallas.shape == qkv.shape
        assert _rel_to_max(port, pallas) <= BWD_TOL
        assert _rel_to_max(port, einsum) <= BWD_TOL


@pytest.mark.parametrize("layout", JA.LAYOUTS)
def test_forward_plain_bf16_matches_jax_einsum_bf16(layout):
    """Both sides in bf16, cast for cast: the logits, softmax and output are rounded to
    bf16 at the same points, but the two frameworks sum inside the bf16 products in other
    orders and round the softmax's sum differently, so a few bf16 ulps (2^-8 relative)
    on outputs of magnitude ~1: 3e-2."""
    qkv, _ = _inputs(40, 3, 16, seed=2)
    out = TA.attention_qkv_plain(torch.from_numpy(qkv).bfloat16(), 3, layout)
    ref = JA._einsum_attention_qkv(jnp.asarray(qkv, jnp.bfloat16), 3, layout)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=0)


def test_qkv_offsets_equal_jax():
    for layout in JA.LAYOUTS:
        for hh in range(4):
            assert TA.qkv_offsets(layout, 4 * 16, 16, hh) == JA._qkv_offsets(
                layout, 4 * 16, 16, hh)
    assert TA.LAYOUTS == JA.LAYOUTS


def test_cpu_dispatch_takes_the_plain_version_and_launches_nothing():
    qkv, g = _inputs(16, 2, 8)
    x, gt = torch.from_numpy(qkv), torch.from_numpy(g)
    before = (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches)
    torch.testing.assert_close(TA.fused_attention_qkv(x, 2, "h3d"),
                               TA.attention_qkv_plain(x, 2, "h3d"), rtol=0, atol=0)
    torch.testing.assert_close(TA.fused_attention_qkv_bwd(x, gt, 2, "h3d"),
                               TA.attention_qkv_bwd_plain(x, gt, 2, "h3d"), rtol=0, atol=0)
    assert (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches) == before


def test_argument_errors():
    x = torch.zeros(1, 4, 3 * 2 * 8)
    with pytest.raises(ValueError, match="unknown qkv layout"):
        TA.fused_attention_qkv(x, 2, "hd3")
    with pytest.raises(ValueError, match="not 3\\*heads\\*d"):
        TA.fused_attention_qkv(torch.zeros(1, 4, 50), 2)
    with pytest.raises(ValueError, match="\\[b, n, 3\\*heads\\*d\\]"):
        TA.attention_qkv_plain(torch.zeros(4, 48), 2)
    with pytest.raises(ValueError, match="does not fit"):
        TA.attention_qkv_bwd_plain(x, torch.zeros(1, 4, 8), 2)
    # The kernels take CUDA tensors only, and say so before anything is built.
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA.attention_qkv_cuda(x, 2)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA.attention_qkv_bwd_cuda(x, torch.zeros(1, 4, 16), 2)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        TA.fused_attention_qkv(x.to("meta"), 2)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        TA.fused_attention_qkv_bwd(x.to("meta"), torch.zeros(1, 4, 16), 2)
