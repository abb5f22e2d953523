"""Cases of the port's linear-attention gradient against the JAX package's, imported by
``test_torch_linear_attention_bwd.py`` (c 16) and ``test_torch_linear_attention_bwd_c64.py``
(c 64), each of which defines the fixture ``c``.

``linear_attention_bwd_plain`` (the yardstick of the CUDA backward kernel) takes the
same numpy inputs and cotangent ``dout`` as two JAX references: ``jax.vjp`` of the
Pallas ``fused_linear_attention`` in interpret mode, which reaches ``_bwd_kernel``
itself, and ``jax.vjp`` of ``linear_attention_xla``. In f32 the three differ only in
the order of f32 sums; the weight grads are sums over b * n tokens, so the bound is
``test_ops.py``'s own for the Pallas backward: 5e-4 absolute and relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightning_generative_models_tpu.ops.linear_attention as FLA
from lightning_generative_models_tpu_torch.ops import linear_attention as TLA

torch.set_num_threads(1)

TOL = 5e-4
NAMES = ("dx", "dg0", "dqkv_kernel", "dmem_kv", "dout_kernel", "dout_bias", "dg1")


def _args(n, c, b=2, heads=4, dim_head=32, m=4, seed=0, disparity=False):
    rs = np.random.RandomState(seed)
    hd = heads * dim_head
    args = [
        rs.randn(b, n, c),                      # x
        rs.randn(c) * 0.1 + 1.0,                # g0
        rs.randn(c, 3 * hd) * c**-0.5,          # qkv_kernel
        rs.randn(2, heads, dim_head, m),        # mem_kv
        rs.randn(hd, c) * hd**-0.5,             # out_kernel
        rs.randn(c) * 0.1,                      # out_bias
        rs.randn(c) * 0.1 + 1.0,                # g1
    ]
    if disparity:  # head 0's q logits ~300x the others'
        args[2][:, :32] *= 300.0
    dout = rs.randn(b, n, c)
    return [a.astype(np.float32) for a in args], dout.astype(np.float32)


def _port(args, dout, residual, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].to(dtype)
    grads = TLA.linear_attention_bwd_plain(*t, torch.from_numpy(dout).to(dtype),
                                           4, 32, dtype, residual)
    return [g.float().numpy() for g in grads]


def _jax_vjp(fn, args, dout, dtype=jnp.float32):
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(dtype)
    _, vjp = jax.vjp(fn, *jargs)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dout).astype(dtype))]


def _pallas_grads(args, dout, residual, monkeypatch, dtype=jnp.float32):
    monkeypatch.setattr(FLA, "_INTERPRET", True)
    return _jax_vjp(lambda *a: FLA.fused_linear_attention(*a, 4, 32, dtype, residual),
                    args, dout, dtype)


def _xla_grads(args, dout, residual):
    return _jax_vjp(lambda *a: FLA.linear_attention_xla(
        *a, heads=4, dim_head=32, dtype=jnp.float32, residual=residual), args, dout)


def _assert_grads_close(port, ref, tol):
    for name, p, r in zip(NAMES, port, ref):
        assert p.shape == r.shape, name
        np.testing.assert_allclose(p, r, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [32, 64])
def test_bwd_plain_matches_jax_pallas_and_xla(monkeypatch, c, n, residual):
    """``c``: the channel count, a fixture of the test file (16 or 64)."""
    args, dout = _args(n, c)
    port = _port(args, dout, residual)
    _assert_grads_close(port, _xla_grads(args, dout, residual), TOL)
    _assert_grads_close(port, _pallas_grads(args, dout, residual, monkeypatch), TOL)


def test_bwd_plain_head_scale_disparity(monkeypatch):
    """Head 0's q logits ~300x the others': its softmax is one-hot, and the per-head
    softmax gradient stays finite and matches."""
    args, dout = _args(64, 64, disparity=True)
    port = _port(args, dout, True)
    assert all(np.isfinite(g).all() for g in port)
    _assert_grads_close(port, _xla_grads(args, dout, True), TOL)
    _assert_grads_close(port, _pallas_grads(args, dout, True, monkeypatch), TOL)


def test_bwd_plain_bf16_matches_jax_pallas(monkeypatch):
    """bf16 compute on both sides, rounded at the same points. What differs is the
    order of the f32 sums ahead of each rounding, which can move a value across a
    bf16 rounding boundary (one ulp, 2^-8 relative) and carry that through the later
    products: the bound is 3e-2 of the tensor's largest magnitude."""
    args, dout = _args(64, 64)
    port = _port(args, dout, True, torch.bfloat16)
    ref = _pallas_grads(args, dout, True, monkeypatch, jnp.bfloat16)
    for name, p, r in zip(NAMES, port, ref):
        assert np.isfinite(p).all(), name
        err = np.abs(p - r).max() / (1.0 + np.abs(r).max())
        assert err <= 3e-2, f"{name}: {err:.3e}"


@pytest.mark.parametrize("residual", [False, True])
def test_autograd_through_plain_matches_bwd_plain(residual):
    """Torch autograd through ``linear_attention_plain`` (the CPU training path)
    against the hand-derived gradient, both f32."""
    args, dout = _args(64, 64, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = TLA.linear_attention(*leaves, heads=4, dim_head=32, dtype=torch.float32,
                               residual=residual)
    out.backward(torch.from_numpy(dout))
    auto = [t.grad.numpy() for t in leaves]  # in the order of NAMES
    _assert_grads_close(_port(args, dout, residual), auto, TOL)
