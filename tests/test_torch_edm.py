"""The port's EDM (Karras preconditioning, Heun/Euler with churn) against the JAX
package's, on the CPU.

A tiny EDM (UNet dim 16, dim_mults (1, 2), 16 px, f32) with the same weights on both
sides, drawn by the port (``torch_flax_params``). Random draws are JAX's own, rebuilt
from its key schedule and handed to the port: a step's normal behind the log-normal
sigma and its noise (``split`` of the loss key), the sampler's start (``normal(split(rng)[0])``)
and the churn noise of every step (``split`` of ``split(rng)[1]`` step by step), a train
step's flips. f32 differs by the order of f32 sums: train steps (the loss within rtol
1e-4) as ``test_torch_train.py`` judges the DDPM's, the chains within 1e-3. A chain starts at
x = 80 z, where an f32 ulp of x is up to 3e-5, and its first step subtracts two such
numbers (x - (sigma_next - sigma) (x - D) / sigma): one Euler step from 80 to 0 already
differs by 1.7e-5 between the two, and the network's Jacobian at the next node scales
that error by about 20.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion import edm as JEDM
from lightning_generative_models_tpu_torch import generate, registry
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.models.diffusion import edm as TEDM
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.weights import load_flax_train_state
from torch_flax_params import as_port, state_from_port

torch.set_num_threads(1)

ARGS = dict(img_size=16, dim=16, dim_mults=(1, 2), use_bf16=False, lr=1e-3,
            sampling_steps=3)
B = 3
SHAPE = (B, 16, 16, 3)


@pytest.fixture(scope="module")
def models():
    """(JAX EDM, its TrainState, the port's EDM on the CPU), the same weights raw and
    EMA."""
    port = TEDM.EDM(**ARGS, device="cpu")
    jmodel = JEDM.EDM(**ARGS)
    return jmodel, state_from_port(jmodel, port), port


def _churn_noise_fn(rng):
    """JAX's per-step churn draws: (key, sub) = split(key) each step, normal(sub)."""
    draws, key = [], rng

    def noise_fn(i, shape):
        nonlocal key
        while len(draws) <= i:
            key, sub = jax.random.split(key)
            draws.append(torch.from_numpy(np.array(jax.random.normal(sub, shape))))
        return draws[i]

    return noise_fn


def test_coeffs_and_sigma_grid_match_jax(models):
    jmodel, _, port = models
    sigma = np.array([0.002, 0.01, 0.5, 3.0, 80.0], np.float32)
    for a, b in zip(port.diffusion.coeffs(torch.from_numpy(sigma)),
                    jmodel.diffusion.coeffs(jnp.asarray(sigma))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for steps in (1, 2, 18):
        np.testing.assert_array_equal(port.diffusion.sigma_grid(steps),
                                      jmodel.diffusion.sigma_grid(steps))
    np.testing.assert_array_equal(port.diffusion.sigma_grid(5, 3.0),
                                  jmodel.diffusion.sigma_grid(5, 3.0))


@pytest.mark.parametrize("method,churn", [("euler", 30.0)])
def test_sampler_chains_match_jax(models, method, churn):
    """Three Euler steps from JAX's own start and churn draws, EMA weights; churn 30
    lifts every node by gamma = sqrt(2) - 1. Heun's corrector, without churn (where the
    churn adds exactly 0), is ``test_torch_latent_diffusion.py``'s LatentEDM chain."""
    jmodel, state, port = models
    kw = dict(img_size=16, sampling_steps=3, s_churn=churn)
    jproc, tproc = JEDM.EDMProcess(**kw), TEDM.EDMProcess(**kw, device="cpu")
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jproc.sample(jmodel._apply_fn(state.ema_params), B, rng, method=method))
    init_rng, churn_rng = jax.random.split(rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(init_rng, SHAPE)))
    with torch.inference_mode():
        out = tproc.sample(port._apply_fn(port.ema_unet), B, method=method, x_T=x_T,
                           noise_fn=_churn_noise_fn(churn_rng)).numpy()
    assert out.shape == ref.shape == SHAPE and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def _draws(rng, step):
    """A JAX EDM step's random draws, made as ``grad_step`` and ``p_losses`` make them."""
    rng = jax.random.fold_in(rng, step)
    aug_rng, loss_rng, _ = jax.random.split(rng, 3)
    flip = jax.random.bernoulli(aug_rng, 0.5, (B, 1, 1, 1))
    sig_rng, noise_rng = jax.random.split(loss_rng)
    return {"flip": torch.tensor(np.asarray(flip).reshape(-1)),
            "sigma_normal": torch.tensor(np.asarray(jax.random.normal(sig_rng, (B,)))),
            "noise": torch.tensor(np.asarray(jax.random.normal(noise_rng, SHAPE)))}


def test_three_train_steps_match_jax(models):
    """Three steps from the same state and draws: the loss within rtol 1e-4, each
    step's update by its norm within 1e-3 (see ``test_torch_train.py``)."""
    jmodel, state, _ = models
    edm = TEDM.EDM(**ARGS, device="cpu")
    load_flax_train_state(edm, jax.device_get(state))
    batch = {"image": np.random.RandomState(3).randint(0, 256, SHAPE).astype(np.uint8),
             "label": np.zeros(B, np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    train_step = jax.jit(jmodel.train_step)
    for _ in range(3):
        before = [p.detach().clone() for p in edm.unet.parameters()]
        jbefore = as_port(edm.unet, state.params["model"])
        draws = _draws(rng, int(state.step))
        state, jmetrics = train_step(state, jbatch, rng)
        metrics = edm.train_step(batch, **draws)
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(jmetrics["train_loss"]), rtol=1e-4)
        d_port = torch.cat([(p.detach() - b).reshape(-1)
                            for p, b in zip(edm.unet.parameters(), before)])
        d_jax = torch.cat([(a - b).reshape(-1) for a, b in
                           zip(as_port(edm.unet, state.params["model"]), jbefore)])
        assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-3
    assert edm.step == int(state.step) == 3


def _config(tmp_path):
    path = tmp_path / "edm_tiny.json"
    path.write_text(json.dumps({
        "model": {"name": "EDM", "args": {**ARGS, "img_channels": 3}},
        "dataset": {"name": "CIFAR10", "img_size": 16, "img_channels": 3, "batch_size": 4,
                    "synthetic_size": 20, "data_dir": str(tmp_path)},
    }))
    return path


def test_cpu_train_resume_then_generate(tmp_path, monkeypatch):
    """The trainer runs EDM (validation, last/best, resume); generate samples Heun and
    refuses the diffusion and consistency samplers with JAX's message."""
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = _config(tmp_path)
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1"]
    assert port_train.main(argv + ["--max_steps", "2"]).step == 2
    run = tmp_path / "experiments" / "EDM" / "run"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert any("val_loss" in r for r in records)
    assert (run / "checkpoints" / "best").exists()
    assert port_train.main(argv + ["--max_steps", "3", "--resume"]).step == 3

    gen = ["--config_path", str(config), "--num_samples", "2", "--device", "cpu",
           "--out", str(tmp_path / "out")]
    images = generate.main(gen + ["--sampler", "heun", "--sampling_steps", "2"])
    assert images.shape == (2, 16, 16, 3) and np.isfinite(images).all()
    np.testing.assert_array_equal(
        generate.main(gen + ["--sampler", "heun", "--sampling_steps", "2"]), images)
    for method in ("ddim", "onestep"):
        with pytest.raises(ValueError, match=f"unknown EDM sampling method '{method}'"):
            generate.main(gen + ["--sampler", method])


def test_errors_are_jax_messages():
    for kw in ({"solver": "dpm"}, {"sigma_min": 0.0}):
        with pytest.raises(ValueError) as jax_err:
            JEDM.EDMProcess(8, **kw)
        with pytest.raises(ValueError) as port_err:
            TEDM.EDMProcess(8, device="cpu", **kw)
        assert str(port_err.value) == str(jax_err.value)
    assert registry.resolve_model_class("edm") is TEDM.EDM
    assert registry.resolve_model_class("LatentEDM") is TEDM.LatentEDM
