"""Cases of the port's DiT, and DDPM(network="dit"), against the JAX package's, on the CPU,
imported by ``test_torch_dit.py`` (the network) and ``test_torch_dit_steps.py`` (the
guided chain and the train steps).

A tiny class-conditional DiT (hidden 32, depth 2, heads 2, patch 2, 8x8 images, 3
classes) with the same flax weights on both sides (drawn by the port,
``torch_flax_params``), loaded into the port with ``load_flax_params`` /
``load_flax_train_state``. adaLN-Zero starts every residual branch
and the head at exactly 0, so the parity tests move every weight by N(0, 0.1^2) first;
the branches are then open and the attention (the plain version here, the JAX package's
einsum path off a TPU) carries the output. In f32 the two sides differ only in the order
of f32 sums: forward and chains within 1e-4 of max(1, |ref|); train steps as
``test_torch_train.py`` compares them. Random draws (x_T, flips, label drops, t, noise)
are JAX's own, handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion import dit as JD
from lightning_generative_models_tpu.models.diffusion.ddpm import DDPM as JaxDDPM
from lightning_generative_models_tpu_torch.models.diffusion import dit as TD
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.weights import load_flax_params, load_flax_train_state
from torch_flax_params import as_port, state_from_port, k_bias_mask

torch.set_num_threads(1)

NET = dict(hidden=32, depth=2, heads=2, patch_size=2, channels=3, num_classes=3)
DDPM_ARGS = dict(img_size=8, dim=32, depth=2, num_heads=2, patch_size=2, network="dit",
                 num_classes=3, use_bf16=False, lr=1e-3, diffusion_timesteps=100,
                 sampling_timesteps=3, guidance_scale=2.0, cond_drop_prob=0.5)
B = 3
TOL = 1e-4


def _perturbed(params, seed=0):
    """Every leaf moved by N(0, 0.1^2), so that the zero-initialised branches open."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.randn(*p.shape).astype(np.float32) * 0.1), params)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(B, 8, 8, 3).astype(np.float32),
            "time": np.array([0, 37, 99], np.int32),
            "labels": np.array([0, 2, 3], np.int32)}  # 3 is the null (unconditional) token


@pytest.fixture(scope="module")
def jax_ddpm():
    """The JAX DDPM and a TrainState whose weights and EMA weights are perturbed."""
    model = JaxDDPM(**DDPM_ARGS)
    state = state_from_port(model, DDPM(**DDPM_ARGS, device="cpu"))
    params = _perturbed(state.params["model"], seed=1)
    return model, state.replace(params={"model": params},
                                ema_params=_perturbed(params, seed=2))


@pytest.fixture(scope="module")
def flax_params(jax_ddpm):
    """Perturbed weights of the tiny DiT (the DDPM's network is ``DiT(**NET)``); one tree
    serves both layouts, whose parameter shapes are the same."""
    return jax_ddpm[1].params["model"]


def _jax_forward(params, layout, dtype=jnp.float32):
    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    net = JD.DiT(**NET, qkv_layout=layout, dtype=dtype)
    return np.asarray(jax.jit(net.apply)({"params": params}, inp["x"], inp["time"],
                                         labels=inp["labels"]))


def _port_forward(params, layout, dtype=torch.float32, einsum_attn=False):
    net = load_flax_params(TD.DiT(**NET, qkv_layout=layout, dtype=dtype,
                                  einsum_attn=einsum_attn), params)
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.inference_mode():
        return net(inp["x"], inp["time"], labels=inp["labels"]).numpy()


def test_output_is_exactly_zero_at_init():
    """adaLN-Zero: the gates, the final modulation and the head start at 0."""
    net = init_params(TD.DiT(**NET), torch.Generator().manual_seed(0))
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.inference_mode():
        out = net(inp["x"], inp["time"], labels=inp["labels"])
    assert out.shape == (B, 8, 8, 3) and out.dtype == torch.float32
    assert torch.equal(out, torch.zeros_like(out))


def test_posemb_equals_jax():
    np.testing.assert_array_equal(TD.posemb_sincos_2d(4, 6, 32), JD.posemb_sincos_2d(4, 6, 32))


@pytest.mark.parametrize("layout", ["s3hd", "h3d"])
def test_f32_forward_matches_jax(flax_params, layout):
    ref = _jax_forward(flax_params, layout)
    scale = max(1.0, np.abs(ref).max())
    for einsum_attn in (False, True):
        out = _port_forward(flax_params, layout, einsum_attn=einsum_attn)
        assert out.shape == ref.shape == (B, 8, 8, 3)
        np.testing.assert_allclose(out, ref, atol=TOL * scale, rtol=0)


def test_bf16_forward_matches_jax_bf16(flax_params):
    """Both sides in bf16 as on the main path: the same casts (bf16 residual stream,
    qkv, attention, proj and MLP; f32 norms, modulation, conditioning and head), but the
    frameworks round inside the bf16 products, the softmax and the tanh GELU at other
    points, and the residual stream carries that through two blocks: a few bf16 ulps
    (2^-8) of outputs of magnitude ~1, 5e-2."""
    ref = _jax_forward(flax_params, "s3hd", jnp.bfloat16)
    out = _port_forward(flax_params, "s3hd", torch.bfloat16)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=5e-2 * max(1.0, np.abs(ref).max()), rtol=0)


def test_cfg_ddim3_chain_matches_jax(jax_ddpm):
    """DDIM-3 with classifier-free guidance (labels cycling 0..2, w = 2) from JAX's own
    x_T, with the EMA weights."""
    model, state = jax_ddpm
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(model.sample(state, rng, B, steps=3))
    x_T = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], (B, 8, 8, 3))))
    ddpm = DDPM(**DDPM_ARGS, device="cpu")
    load_flax_train_state(ddpm, jax.device_get(state), optimizers=False)
    out = ddpm.sample(None, B, steps=3, x_T=x_T).numpy()
    assert out.shape == ref.shape and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def _draws(rng, step, shape, model):
    """A JAX step's random draws, made as ``grad_step`` and ``p_losses`` make them."""
    rng = jax.random.fold_in(rng, step)
    aug_rng, loss_rng, drop_rng = jax.random.split(rng, 3)
    flip = jax.random.bernoulli(aug_rng, 0.5, (shape[0], 1, 1, 1))
    drop = jax.random.bernoulli(drop_rng, model.cond_drop_prob, (shape[0],))
    t_rng, noise_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jax.random.randint(t_rng, (shape[0],), 0, model.diffusion.num_timesteps)
    noise = jax.random.normal(noise_rng, shape)
    return {"flip": torch.tensor(np.asarray(flip).reshape(-1)),
            "drop": torch.tensor(np.asarray(drop)),
            "t": torch.tensor(np.asarray(t).astype(np.int64)),
            "noise": torch.tensor(np.asarray(noise))}


def test_three_train_steps_match_jax(jax_ddpm):
    """Three steps from the same state and draws (labels dropped to the null token by
    JAX's own draws). The loss within rtol 1e-4; each step's update as a whole,
    ||d_port - d_jax|| / ||d_jax|| <= 1e-3 (Adam's first steps move a weight by about
    lr * sign(g), so an element-wise bound would test the sign of near-zero gradients),
    over every weight but the k part of the qkv biases, whose gradient is exactly 0 in
    exact arithmetic (``k_bias_mask``): there the port's gradient must be noise, and both
    sides' moves at most lr."""
    model, state = jax_ddpm
    rs = np.random.RandomState(3)
    batch = {"image": rs.randint(0, 256, (4, 8, 8, 3)).astype(np.uint8),
             "label": np.array([0, 1, 2, 1], np.int32)}
    rng = jax.random.PRNGKey(11)
    ddpm = DDPM(**DDPM_ARGS, device="cpu")
    load_flax_train_state(ddpm, jax.device_get(state))
    k_bias = k_bias_mask(ddpm.unet)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    train_step = jax.jit(model.train_step)
    draws = _draws(rng, int(state.step), (4, 8, 8, 3), model)
    grads = torch.cat([g.reshape(-1) for g in ddpm.grad_step(batch, **draws)[0]])
    assert float(grads[k_bias].abs().max()) <= 1e-6 * float(grads.abs().max())
    dropped = 0
    for _ in range(3):
        before = [p.detach().clone() for p in ddpm.unet.parameters()]
        jbefore = as_port(ddpm.unet, state.params["model"])
        draws = _draws(rng, int(state.step), (4, 8, 8, 3), model)
        dropped += int(draws["drop"].sum())
        state, jmetrics = train_step(state, jbatch, rng)
        metrics = ddpm.train_step(batch, **draws)
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(jmetrics["train_loss"]), rtol=1e-4)
        d_port = torch.cat([(p.detach() - b).reshape(-1)
                            for p, b in zip(ddpm.unet.parameters(), before)])
        d_jax = torch.cat([(a - b).reshape(-1) for a, b in
                           zip(as_port(ddpm.unet, state.params["model"]), jbefore)])
        rest = ~k_bias
        assert float((d_port - d_jax)[rest].norm() / d_jax[rest].norm()) <= 1e-3
        assert float(torch.cat([d_port, d_jax])[torch.cat([k_bias, k_bias])].abs().max()) \
            <= 1.001 * DDPM_ARGS["lr"]
    assert ddpm.step == int(state.step) == 3
    assert 0 < dropped < 12  # the null token and true labels both trained


def test_raised_options(flax_params):
    """Pipeline stages still raise (MoE builds: ``test_torch_moe.py``); ``flash_attn``
    builds the flash branch, which on the CPU (8 px: 16 tokens, below the flash gate)
    matches the packed path with the same weights within the order of f32 sums."""
    for kw in ({"pipeline_stages": 2}, {"pipeline_stages": 2, "num_experts": 8}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TD.DiT(**NET, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DDPM(**{**DDPM_ARGS, **kw}, device="cpu")
    assert DDPM(**DDPM_ARGS, num_experts=8, device="cpu").unet.blocks[-1].moe is not None
    assert DDPM(**DDPM_ARGS, flash_attn=True, device="cpu").unet.blocks[0].flash
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    for layout in ("s3hd", "h3d"):
        flash = load_flax_params(TD.DiT(**NET, flash_attn=True, qkv_layout=layout), flax_params)
        with torch.inference_mode():
            out = flash(inp["x"], inp["time"], labels=inp["labels"]).numpy()
        np.testing.assert_allclose(out, _port_forward(flax_params, layout), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="self_condition"):
        DDPM(**DDPM_ARGS, self_condition=True, device="cpu")
    with pytest.raises(ValueError, match="not divisible by heads"):
        TD.DiT(hidden=30, heads=4)
    net = TD.DiT(**NET)
    x, t = torch.zeros(1, 8, 8, 3), torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="self-conditioning"):
        net(x, t, x_self_cond=x, labels=torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match="requires labels"):
        net(x, t)
    with pytest.raises(ValueError, match="not divisible by patch"):
        net(torch.zeros(1, 7, 8, 3), t, labels=torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match="unknown qkv layout"):
        TD.DiT(**NET, qkv_layout="hd3")(x, t, labels=torch.zeros(1, dtype=torch.long))
