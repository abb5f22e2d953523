"""The port's flash-attention path and fused preprocess pass against the JAX package's,
on the CPU.

``flash_attention_plain`` (the port's path on a CPU tensor and the flash kernel's
yardstick) takes the same numpy q, k and v as ``_xla_attention`` and as the Pallas
``_flash_attention`` in interpret mode, which runs ``_flash_kernel`` itself; its autograd
gradient is held to ``jax.grad`` through ``_flash_attention``'s custom VJP. The DiT with
``flash_attn`` and the UNet's ``Attention(flash=True)`` at n_kv = 260 run against the flax
modules (off a TPU the JAX dispatcher takes ``_xla_attention``, the port's CPU path the
plain version), with weights drawn by the port (``torch_flax_params``) and moved off
adaLN-Zero's zeros. ``fused_normalize_flip_plain`` is held to the Pallas preprocess kernel
in interpret mode. f32 differs by the order of f32 sums: attention 1e-5, gradients 1e-4
of their largest magnitude, the modules 1e-4 of max(1, |ref|); the preprocess is exact in
f32 and within one bf16 step in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightning_generative_models_tpu.ops.attention as JA
from lightning_generative_models_tpu.models.diffusion import dit as JD
from lightning_generative_models_tpu.models.modules import attention as JM
from lightning_generative_models_tpu.ops.preprocess import fused_normalize_flip_pallas
from lightning_generative_models_tpu_torch.models.diffusion import dit as TD
from lightning_generative_models_tpu_torch.models.modules.attention import Attention
from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.ops import attention as TA
from lightning_generative_models_tpu_torch.ops import preprocess as TP
from lightning_generative_models_tpu_torch.weights import load_flax_params
from torch_flax_params import flax_tree, init_shapes

torch.set_num_threads(1)

FWD_TOL = 1e-5
BWD_TOL = 1e-4
MODULE_TOL = 1e-4
NET = dict(hidden=32, depth=2, heads=2, patch_size=2, channels=3, num_classes=3)


def _bhnd(n_q, n_kv, d, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(1, 2, n_q, d).astype(np.float32)
    k, v = (rs.randn(1, 2, n_kv, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("n,d", [(256, 64), (300, 64)])
def test_plain_matches_xla_and_interpret_pallas(monkeypatch, n, d):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    q, k, v = _bhnd(n, n, d)
    xla = np.asarray(JA._xla_attention(q, k, v))
    pallas = np.asarray(JA._flash_attention(q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = TA.flash_attention_plain(tq, tk, tv)
    assert out.shape == (1, 2, n, d)
    np.testing.assert_allclose(out.numpy(), xla, atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), pallas, atol=FWD_TOL, rtol=0)
    # Past the gate (n_kv >= 256, d % 8 == 0) a CPU tensor takes the plain version.
    assert torch.equal(TA.scaled_dot_product_attention(tq, tk, tv, use_pallas=True), out)


def test_autograd_through_plain_matches_jax_custom_vjp(monkeypatch):
    """n_q 256 and n_kv 260: the UNet's flash shape at 16 x 16 with 4 memory keys."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    q, k, v = _bhnd(256, 260, 32, seed=1)
    g = np.random.RandomState(2).randn(1, 2, 256, 32).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(JA._flash_attention(*a) * g), argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    TA.flash_attention(*leaves).backward(torch.from_numpy(g))
    plain = TA.flash_attention_bwd_plain(*(t.detach() for t in leaves), torch.from_numpy(g))
    for leaf, p, r in zip(leaves, plain, ref):
        r = np.asarray(r)
        for got in (leaf.grad, p):
            assert float(np.abs(got.numpy() - r).max() / np.abs(r).max()) <= BWD_TOL


def _opened(module, seed):
    """Port weights from a seed, every one moved by N(0, 0.1^2) so that adaLN-Zero's
    zero-initialised gates and head open."""
    gen = torch.Generator().manual_seed(seed)
    init_params(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return module


@pytest.mark.parametrize("layout", ["s3hd", "h3d"])
def test_flash_dit_forward_matches_jax(layout):
    """DiT(flash_attn=True) at 16 px (n = 64), f32, both packed layouts."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    time, labels = np.array([5, 900], np.int32), np.array([1, 3], np.int32)
    jnet = JD.DiT(**NET, flash_attn=True, qkv_layout=layout)
    net = _opened(TD.DiT(**NET, flash_attn=True, qkv_layout=layout), seed=4)
    params = flax_tree(net, init_shapes(jnet, x, time, labels=labels))
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, x, time, labels=labels))
    net = load_flax_params(TD.DiT(**NET, flash_attn=True, qkv_layout=layout), params)
    with torch.inference_mode():
        out = net(*(torch.from_numpy(a) for a in (x, time)), labels=torch.from_numpy(labels))
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=MODULE_TOL * max(1.0, np.abs(ref).max()),
                               rtol=0)


def test_flash_attention_module_matches_flax():
    """Attention(flash=True) at 16 x 16: 256 queries and 260 keys, the flash path."""
    x = np.random.RandomState(5).randn(2, 16, 16, 32).astype(np.float32)
    jmod = JM.Attention(32, flash=True, residual=True)
    mod = init_params(Attention(32, flash=True, residual=True), torch.Generator().manual_seed(6))
    params = flax_tree(mod, init_shapes(jmod, x))
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, x))
    with torch.inference_mode():
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=MODULE_TOL * max(1.0, np.abs(ref).max()), rtol=0)


def test_fused_normalize_flip_matches_interpret_pallas():
    rs = np.random.RandomState(7)
    images = rs.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    flip = np.array([True, False, True])
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(fused_normalize_flip_pallas(
            jnp.asarray(images), jnp.asarray(flip), jdtype, interpret=True)).astype(np.float32)
        out = TP.fused_normalize_flip(torch.from_numpy(images), torch.from_numpy(flip), dtype)
        assert out.dtype == dtype and out.shape == (3, 8, 8, 3)
        out = out.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_array_equal(out, ref)
        else:  # both round the same f32 value once; one bf16 step (2^-7 relative) at most
            np.testing.assert_allclose(out, ref, rtol=2.0**-7, atol=0)
