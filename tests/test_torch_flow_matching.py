"""The port's FlowMatching (rectified flow on the DDPM machinery) against the JAX
package's, on the CPU.

A tiny FlowMatching DiT (hidden 32, depth 2, heads 2, patch 2, 8 px, f32, ``flash_attn``
as in ``fm_dit_cifar10.json`` with the flash variant; off a TPU and at 16 tokens both
sides take the plain attention) with the same weights on both sides, drawn by the port
and moved off adaLN-Zero's zeros (``torch_flax_params``). Random draws are JAX's own,
rebuilt from its key schedule and handed to the port: ``p_losses``' t (logit-normal:
``sigmoid(normal(split(rng)[0]))``) and noise, the solvers' x_1 (``normal(split(rng)[0])``),
a train step's flips. f32 differs by the order of f32 sums: the loss within 1e-5, the
chains within 1e-4, train steps as ``test_torch_train.py`` judges the DDPM's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion import flow_matching as JFM
from lightning_generative_models_tpu.models.diffusion import gaussian_diffusion as JGD
from lightning_generative_models_tpu_torch import generate, registry
from lightning_generative_models_tpu_torch.models.diffusion import flow_matching as TFM
from lightning_generative_models_tpu_torch.models.diffusion import gaussian_diffusion as TGD
from lightning_generative_models_tpu_torch.weights import load_flax_train_state
from torch_flax_params import as_port, state_from_port, k_bias_mask

torch.set_num_threads(1)

FM_ARGS = dict(img_size=8, dim=32, depth=2, num_heads=2, patch_size=2, network="dit",
               flash_attn=True, use_bf16=False, lr=1e-3, sampling_steps=3)
B = 3
SHAPE = (B, 8, 8, 3)
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """(JAX FlowMatching, its TrainState, the port's FlowMatching on the CPU), with the
    same opened weights as raw and EMA weights."""
    port = TFM.FlowMatching(**FM_ARGS, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in port.unet.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    port.copy_params_to_ema()
    jmodel = JFM.FlowMatching(**FM_ARGS)
    return jmodel, state_from_port(jmodel, port), port


def test_p_losses_matches_jax_with_its_draws(models):
    jmodel, state, port = models
    x01 = np.random.RandomState(2).rand(*SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, x, r: jmodel.diffusion.p_losses(jmodel._apply_fn(p), x, r))(
        state.params["model"], x01, rng)
    t_rng, noise_rng = jax.random.split(rng)
    t = jax.nn.sigmoid(0.0 + 1.0 * jax.random.normal(t_rng, (B,)))
    noise = jax.random.normal(noise_rng, SHAPE)
    with torch.no_grad():
        loss = port.diffusion.p_losses(port._apply_fn(port.unet), torch.from_numpy(x01),
                                       t=torch.tensor(np.asarray(t)),
                                       noise=torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)


@pytest.mark.parametrize("method", TFM.SOLVERS)
def test_solver_chains_match_jax(models, method):
    """Three steps of each solver from JAX's own x_1, with the EMA weights."""
    jmodel, state, port = models
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jmodel.sample(state, rng, B, method=method, steps=3))
    x_T = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], SHAPE)))
    out = port.sample(None, B, method=method, steps=3, x_T=x_T).numpy()
    assert out.shape == ref.shape == SHAPE and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def _draws(rng, step):
    """A JAX FlowMatching step's random draws, made as ``grad_step`` and the flow's
    ``p_losses`` make them."""
    rng = jax.random.fold_in(rng, step)
    aug_rng, loss_rng, _ = jax.random.split(rng, 3)
    flip = jax.random.bernoulli(aug_rng, 0.5, (B, 1, 1, 1))
    t_rng, noise_rng = jax.random.split(loss_rng)
    t = jax.nn.sigmoid(jax.random.normal(t_rng, (B,)))
    noise = jax.random.normal(noise_rng, SHAPE)
    return {"flip": torch.tensor(np.asarray(flip).reshape(-1)),
            "t": torch.tensor(np.asarray(t)), "noise": torch.tensor(np.asarray(noise))}


def test_three_train_steps_match_jax(models):
    """Three steps from the same state and draws, judged as the DDPM's
    (``test_torch_dit.py``): the loss within rtol 1e-4, each step's update by its norm
    within 1e-3 without the k part of the qkv biases, whose exact gradient is 0 and
    whose moves must stay within lr."""
    jmodel, state, _ = models
    ddpm = TFM.FlowMatching(**FM_ARGS, device="cpu")
    load_flax_train_state(ddpm, jax.device_get(state))
    k_bias = k_bias_mask(ddpm.unet)
    batch = {"image": np.random.RandomState(3).randint(0, 256, SHAPE).astype(np.uint8),
             "label": np.zeros(B, np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    train_step = jax.jit(jmodel.train_step)
    for _ in range(3):
        before = [p.detach().clone() for p in ddpm.unet.parameters()]
        jbefore = as_port(ddpm.unet, state.params["model"])
        draws = _draws(rng, int(state.step))
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
            <= 1.001 * FM_ARGS["lr"]
    assert ddpm.step == int(state.step) == 3


def test_generate_heun_on_cpu(tmp_path):
    config = tmp_path / "fm_tiny.json"
    config.write_text(json.dumps({
        "model": {"name": "FlowMatching", "args": {**FM_ARGS, "img_channels": 3}},
        "dataset": {"name": "CIFAR10", "img_size": 8, "img_channels": 3},
    }))
    argv = ["--config_path", str(config), "--num_samples", "4", "--device", "cpu",
            "--sampler", "heun", "--sampling_steps", "2", "--out", str(tmp_path / "out")]
    images = generate.main(argv)
    assert images.shape == (4, 8, 8, 3)
    assert np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0
    assert (tmp_path / "out" / "grid.png").read_bytes().startswith(b"\x89PNG")
    np.testing.assert_array_equal(generate.main(argv), images)
    with pytest.raises(ValueError, match="unknown flow sampling method 'ddim'"):
        generate.main(argv[:-4] + ["--sampler", "ddim", "--out", str(tmp_path / "out")])


def test_solver_name_errors_are_jax_messages():
    """The flow refuses unknown settings and the diffusion samplers' names with JAX's
    messages, and the DDPM family refuses the flow solvers' names with JAX's."""
    for kw in ({"solver": "rk4"}, {"time_sampling": "beta"}):
        with pytest.raises(ValueError) as jax_err:
            JFM.RectifiedFlow(8, **kw)
        with pytest.raises(ValueError) as port_err:
            TFM.RectifiedFlow(8, device="cpu", **kw)
        assert str(port_err.value) == str(jax_err.value)
    families = [(JFM.RectifiedFlow(8), TFM.RectifiedFlow(8, device="cpu"), ("ddim", "dpmpp")),
                (JGD.GaussianDiffusion(8, timesteps=10),
                 TGD.GaussianDiffusion(8, timesteps=10, device="cpu"), TFM.SOLVERS)]
    for jax_process, port_process, methods in families:
        for method in methods:
            with pytest.raises(ValueError) as jax_err:
                jax_process.sample(None, 1, jax.random.PRNGKey(0), method=method)
            with pytest.raises(ValueError) as port_err:
                port_process.sample(None, 1, method=method)
            assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TFM.RectifiedFlow(8, device="cpu").interpolate(None, None, None, None)
    assert registry.resolve_model_class("flowmatching") is TFM.FlowMatching
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.resolve_model_class("LatentFlowMatching")
