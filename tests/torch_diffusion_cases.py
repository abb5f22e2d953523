"""Cases of the port's diffusion schedules and samplers against the JAX package's.

The test files ``test_torch_diffusion*.py`` import these tests; each variant's file
defines the ``models`` fixture over its variant (``build_models``), so that a file holds
few tests and xdist's file queue runs it after the long few-test JAX files.

Each chain starts from the x_T that JAX draws itself (``normal(split(rng)[0])``, as
``ddim_sample`` does) and, for ancestral sampling, takes JAX's per-step noise
(``normal(fold_in(loop_rng, t))``) through ``noise_fn``; with eta 0, DDIM and DPM++
have no other randomness. Both sides run the small f32 UNet with the same flax
weights (drawn by the port, ``torch_flax_params``). Images are in [0, 1]; per-eval
differences of ~1e-6 pass through the x0 clip and the chain, so ATOL 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion import gaussian_diffusion as JGD
from lightning_generative_models_tpu.models.diffusion.ddpm import DDPM as JaxDDPM
from lightning_generative_models_tpu_torch.models.diffusion import gaussian_diffusion as TGD
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.weights import load_flax_params
from torch_flax_params import state_from_port

torch.set_num_threads(1)

ATOL = 1e-4
MODEL = dict(img_size=16, dim=16, dim_mults=(1, 2), diffusion_timesteps=100,
             sampling_timesteps=5, use_bf16=False)
VARIANTS = {
    "uncond": {},
    "class_cond": {"num_classes": 3, "guidance_scale": 2.0},
    "self_cond": {"self_condition": True},
}
BATCH = 3


def build_models(variant):
    """(JAX DDPM, its state, the port's DDPM on the CPU with the same EMA weights)."""
    kw = {**MODEL, **VARIANTS[variant]}
    jmodel = JaxDDPM(**kw)
    model = DDPM(**kw, device="cpu")
    model.init_params(torch.Generator().manual_seed(2))
    state = state_from_port(jmodel, model)
    load_flax_params(model.unet, jax.device_get(state.ema_params))
    model.copy_params_to_ema()
    return jmodel, state, model


def _x_T(rng, shape):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], shape)))


@pytest.mark.parametrize("schedule", sorted(JGD.BETA_SCHEDULES))
def test_schedule_buffers_equal_jax(schedule):
    jd = JGD.GaussianDiffusion(img_size=8, timesteps=1000, beta_schedule=schedule)
    td = TGD.GaussianDiffusion(img_size=8, timesteps=1000, beta_schedule=schedule,
                               device="cpu")
    names = [k for k, v in vars(td).items() if isinstance(v, torch.Tensor)]
    assert len(names) == 13  # the schedule's 12 buffers and the loss weight
    for name in names:  # same float64 math, same f32 rounding: bit for bit
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))


@pytest.mark.parametrize("method", ["ddim", "dpmpp"])
def test_strided_samplers_match_jax(models, method):
    jmodel, state, model = models
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jmodel.sample(state, rng, BATCH, method=method, steps=5))
    out = model.sample(None, BATCH, method=method, steps=5,
                       x_T=_x_T(rng, (BATCH, 16, 16, 3))).numpy()
    assert out.shape == ref.shape and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_ancestral_sampling_matches_jax(models):
    """p_sample_loop over T=10 steps with JAX's own noise, on the same UNet (the
    conditional variant with its null labels)."""
    jmodel, state, model = models
    jlabels = jmodel.null_labels(BATCH) if model.num_classes else None
    labels = model.null_labels(BATCH) if model.num_classes else None
    shape = (BATCH, 16, 16, 3)
    rng = jax.random.PRNGKey(11)
    jd = JGD.GaussianDiffusion(img_size=16, timesteps=10,
                               self_condition=jmodel.diffusion.self_condition)
    ref = np.asarray(jd.p_sample_loop(jmodel._apply_fn(state.ema_params, jlabels), BATCH, rng))

    init_rng, loop_rng = jax.random.split(rng)
    td = TGD.GaussianDiffusion(img_size=16, timesteps=10,
                               self_condition=model.diffusion.self_condition, device="cpu")

    def noise_fn(t, shape_):
        return torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(loop_rng, t), shape_)))

    x_T = torch.from_numpy(np.array(jax.random.normal(init_rng, shape)))
    with torch.inference_mode():
        out = td.p_sample_loop(model._apply_fn(model.ema_unet, labels), BATCH, x_T=x_T,
                               noise_fn=noise_fn).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_sample_dispatch_and_guidance_checks(models):
    _, _, model = models
    with pytest.raises(ValueError, match="unknown sampling method"):
        model.sample(None, 1, method="euler")
    if not model.num_classes:
        with pytest.raises(ValueError, match="num_classes"):
            model.sample_classes(None, torch.zeros(1))


def test_ddpm_rejects_unported_and_dit_only_options():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DDPM(network="dit", pipeline_stages=2, device="cpu")
    with pytest.raises(ValueError, match="DiT backbone only"):
        DDPM(img_size=16, dim=16, dim_mults=(1, 2), num_experts=4, device="cpu")
