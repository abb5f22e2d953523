"""The port's linear-attention block against the JAX package's.

The same numpy inputs go through the port's ``linear_attention`` (the plain version,
on CPU tensors) and through JAX's ``linear_attention_xla`` and the Pallas
``fused_linear_attention`` in interpret mode. Both sides compute in f32, so they
differ only in the order of f32 sums: ATOL/RTOL 1e-5 on outputs of magnitude ~1-5.
The CUDA kernel is held to the plain version on the card by test_torch_kernels_gpu.py
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightning_generative_models_tpu.ops.linear_attention as FLA
from lightning_generative_models_tpu_torch.ops import linear_attention as TLA

torch.set_num_threads(1)

ATOL = RTOL = 1e-5  # f32 on both sides; only the summation order differs


def _args(n, c, b=2, heads=4, dim_head=32, m=4, seed=0):
    rs = np.random.RandomState(seed)
    hd = heads * dim_head
    args = (
        rs.randn(b, n, c),                      # x
        rs.randn(c) * 0.1 + 1.0,                # g0
        rs.randn(c, 3 * hd) * c**-0.5,          # qkv_kernel
        rs.randn(2, heads, dim_head, m),        # mem_kv
        rs.randn(hd, c) * hd**-0.5,             # out_kernel
        rs.randn(c) * 0.1,                      # out_bias
        rs.randn(c) * 0.1 + 1.0,                # g1
    )
    return [a.astype(np.float32) for a in args]


def _port(args, residual):
    before = TLA.linear_attention.launches
    out = TLA.linear_attention(*map(torch.from_numpy, args), heads=4, dim_head=32,
                               dtype=torch.float32, residual=residual)
    assert TLA.linear_attention.launches == before  # CPU tensors never launch the kernel
    return out.numpy()


def _jax_refs(args, residual, monkeypatch):
    jargs = list(map(jnp.asarray, args))
    xla = FLA.linear_attention_xla(*jargs, heads=4, dim_head=32, dtype=jnp.float32,
                                   residual=residual)
    monkeypatch.setattr(FLA, "_INTERPRET", True)
    pallas = FLA.fused_linear_attention(*jargs, 4, 32, jnp.float32, residual)
    return np.asarray(xla), np.asarray(pallas)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("c", [16, 64])
def test_plain_matches_jax_xla_and_pallas(monkeypatch, c, n, residual):
    args = _args(n, c)
    out = _port(args, residual)
    xla, pallas = _jax_refs(args, residual, monkeypatch)
    np.testing.assert_allclose(out, xla, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


def test_plain_head_scale_disparity(monkeypatch):
    """One head's q logits ~300x the others': a row-wide softmax stabiliser would
    underflow the small heads to 0/0. The per-head softmax stays finite and matches."""
    args = _args(64, 64)
    args[2][:, :32] *= 300.0
    out = _port(args, residual=True)
    xla, pallas = _jax_refs(args, True, monkeypatch)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, xla, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


def test_dispatch_rejects_other_devices():
    args = [torch.from_numpy(a).to("meta") for a in _args(64, 64)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        TLA.linear_attention(*args, heads=4, dim_head=32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TLA.linear_attention_cuda(*args, heads=4, dim_head=32, dtype=torch.float32)
