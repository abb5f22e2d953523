"""Cases of the port's UNet forward against the JAX UNet, with the same flax weights,
imported by ``test_torch_unet.py`` (the class-conditional variant) and
``test_torch_unet_variants.py`` (unconditional, self-conditioned), each of which builds
the fixture ``case`` once per variant (``build_case``).

A small UNet (dim 16, dim_mults (1, 2), 16 px) keeps the JAX apply cheap; it still has
every block kind: ResnetBlocks with and without the 1x1 skip conv, linear attention,
full attention with memory KV, down- and upsampling. The weights are drawn by the port
and handed to flax as its own tree (``torch_flax_params``: checked against the tree of
``jax.eval_shape`` of the flax init, so no init compiles). f32 on both sides: the
outputs (magnitude ~5) differ by the order of f32 sums through ~20 layers, so ATOL 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion.unet import UNet as JaxUNet
from lightning_generative_models_tpu_torch.models.diffusion.unet import UNet
from lightning_generative_models_tpu_torch.models.modules.attention import Attention
from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.weights import flatten_tree, load_flax_params
from torch_flax_params import flax_tree, init_shapes

torch.set_num_threads(1)

ATOL = 1e-4
VARIANTS = {
    "uncond": {},
    "class_cond": {"num_classes": 3},
    "self_cond": {"self_condition": True},
}


def build_case(variant):
    """(variant kwargs, numpy inputs, flax params, JAX output)."""
    kw = VARIANTS[variant]
    rs = np.random.RandomState(0)
    inputs = {
        "x": rs.randn(2, 16, 16, 3).astype(np.float32),
        "time": np.array([3, 700], np.int32),
        "x_self_cond": rs.randn(2, 16, 16, 3).astype(np.float32)
        if kw.get("self_condition") else None,
        "labels": np.array([0, 3], np.int32) if "num_classes" in kw else None,
    }
    jnet = JaxUNet(dim=16, dim_mults=(1, 2), **kw)
    jin = {k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}
    net = init_params(UNet(dim=16, dim_mults=(1, 2), **kw), torch.Generator().manual_seed(1))
    params = flax_tree(net, init_shapes(jnet, jin["x"], jin["time"], labels=jin["labels"]))
    out = jax.jit(jnet.apply)({"params": params}, jin["x"], jin["time"], jin["x_self_cond"],
                              labels=jin["labels"])
    return kw, inputs, params, np.asarray(out)


def test_unet_matches_jax(case):
    kw, inputs, params, ref = case
    net = load_flax_params(UNet(dim=16, dim_mults=(1, 2), **kw), params)
    tin = {k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()}
    with torch.inference_mode():
        out = net(tin["x"], tin["time"], tin["x_self_cond"], labels=tin["labels"])
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_unet_bf16_matches_jax_bf16(case):
    """Both sides in bf16 as on the main path: the casts follow flax's dtype= (convs in
    bf16; GroupNorm, time MLP, FiLM and the final conv in f32), but the two frameworks
    round inside the bf16 convs differently, so only a loose bound holds: 0.15 on
    outputs of magnitude ~5 (a few bf16 ulps)."""
    kw, inputs, params, _ = case
    jnet = JaxUNet(dim=16, dim_mults=(1, 2), dtype=jnp.bfloat16, **kw)
    jin = {k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jin["x"], jin["time"],
                                         jin["x_self_cond"], labels=jin["labels"]))
    net = load_flax_params(UNet(dim=16, dim_mults=(1, 2), dtype=torch.bfloat16, **kw), params)
    tin = {k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()}
    with torch.inference_mode():
        out = net(tin["x"], tin["time"], tin["x_self_cond"], labels=tin["labels"]).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=0.15, rtol=0)


def test_flax_names_cover_tree_exactly(case):
    kw, _, params, _ = case
    net = UNet(dim=16, dim_mults=(1, 2), **kw)
    flat = flatten_tree(params)
    del flat[next(iter(flat))]
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(net, flat)
    with pytest.raises(KeyError, match="left over"):
        load_flax_params(net, {**flatten_tree(params), "Conv_9/kernel": np.zeros(1)})


def test_conditional_unet_requires_labels():
    net = UNet(dim=16, dim_mults=(1, 2), num_classes=3)
    with pytest.raises(ValueError, match="requires labels"):
        net(torch.zeros(1, 16, 16, 3), torch.zeros(1, dtype=torch.long))


def test_flash_attention_path_matches_einsum_path_on_cpu(monkeypatch):
    """At 16 x 16 (256 + 4 keys) ``Attention(flash=True)`` goes through the flash
    dispatcher with [b, h, n, d] views, and on the CPU matches the f32 einsum path of
    ``flash=False`` with the same weights (the two round q * scale at other points:
    within 1e-5). At 8 x 8 it keeps the einsum path."""
    from lightning_generative_models_tpu_torch.models.modules import attention as attn_mod

    calls = []
    sdpa = attn_mod.scaled_dot_product_attention
    monkeypatch.setattr(attn_mod, "scaled_dot_product_attention",
                        lambda q, k, v, **kw: calls.append((q.shape, k.shape, kw)) or
                        sdpa(q, k, v, **kw))
    flash = init_params(Attention(32, flash=True, residual=True),
                        torch.Generator().manual_seed(0))
    plain = Attention(32, flash=False, residual=True)
    plain.load_state_dict(flash.state_dict())
    x = torch.randn(2, 16, 16, 32, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out, ref = flash(x), plain(x)
        flash(x[:, :8, :8])
    assert calls == [((2, 4, 256, 32), (2, 4, 260, 32), {"use_pallas": True})]
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
