"""Cases of the port's consistency model against the JAX package's, imported by
``test_torch_consistency.py`` and ``test_torch_consistency_schedule.py``.

A tiny consistency model (UNet dim 16, dim_mults (1, 2), 16 px, f32, s1 = 1280) with the
same weights on both sides, drawn by the port (``torch_flax_params``). The grid index is
JAX's own categorical draw (``jax.random.categorical`` over the masked table, which no
torch seed replays) handed to the port as ``index``; the noise, the sampler's start and
re-noising draws and a train step's flips are JAX's too. Tolerances: the curriculum and
the boundary exactly; the index distribution's probabilities within 2e-6 (an erf
difference of two f32 values: where it underflows, one side may clamp to 1e-20 while the
other keeps an ulp); losses within rtol 1e-4 (train steps, N = 10, 20, 40) and 1e-5
(the eval loss, N = 1280); the chains within 1e-3 (they start at 80 z:
see ``test_torch_edm.py``); train steps as ``test_torch_train.py`` judges the DDPM's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion import consistency as JCT
from lightning_generative_models_tpu_torch import registry
from lightning_generative_models_tpu_torch.models.diffusion import consistency as TCT
from lightning_generative_models_tpu_torch.weights import load_flax_train_state
from torch_flax_params import as_port, state_from_port

torch.set_num_threads(1)

# curriculum_steps 8: K' = 1, so the grid doubles every step (N = 10, 20, 40, ...).
ARGS = dict(img_size=16, dim=16, dim_mults=(1, 2), use_bf16=False, lr=1e-3,
            sampling_steps=3, curriculum_steps=8)
B = 3
SHAPE = (B, 16, 16, 3)


@pytest.fixture(scope="module")
def models():
    port = TCT.ConsistencyModel(**ARGS, device="cpu")
    jmodel = JCT.ConsistencyModel(**ARGS)
    return jmodel, state_from_port(jmodel, port), port


def _index(jproc, rng, step, b=B):
    """JAX's grid-index draw of ``p_losses`` at ``step`` from its ``rng``."""
    idx_rng, noise_rng = jax.random.split(rng)
    n = jproc.n_intervals(step) if step is not None else jnp.asarray(jproc.s1, jnp.int32)
    i = jax.random.categorical(idx_rng, jnp.broadcast_to(jproc._index_logits(n), (b, jproc.s1)))
    return torch.tensor(np.asarray(i)), noise_rng


@pytest.mark.parametrize("curriculum", [100_000, 8])
def test_curriculum_and_index_logits_match_jax_at_every_stage(curriculum):
    """N(k) at the first step of every stage (N = 10, 20, ..., 1280) and past the last,
    and the index distribution over the 1280-entry table at each N."""
    jproc = JCT.ConsistencyProcess(16, curriculum_steps=curriculum)
    tproc = TCT.ConsistencyProcess(16, curriculum_steps=curriculum, device="cpu")
    k_prime = max(int(curriculum / (math.log2(1280 / 10) + 1.0)), 1)
    seen = []
    for stage in range(9):
        step = stage * k_prime
        n = tproc.n_intervals(step)
        assert n == int(jproc.n_intervals(step)) == min(10 * 2**stage, 1280)
        assert tproc.n_intervals(step + k_prime - 1) == n
        seen.append(n)
        logits = tproc._index_logits(n, torch.device("cpu")).numpy()
        ref = np.asarray(jproc._index_logits(jnp.asarray(n, jnp.int32)))
        np.testing.assert_array_equal(np.isinf(logits), np.isinf(ref))
        assert np.isinf(logits).sum() == 1280 - n
        p, q = (np.exp(v - v.max()) / np.exp(v - v.max()).sum() for v in (logits, ref))
        np.testing.assert_allclose(p, q, atol=2e-6, rtol=0)
    assert seen == [10, 20, 40, 80, 160, 320, 640, 1280, 1280]
    assert tproc.n_intervals(None) == 1280


def test_boundary_and_coeffs_match_jax(models):
    """f(x, sigma_min) = x exactly (c_skip = 1, c_out = 0), and the coefficients."""
    jmodel, _, port = models
    x = torch.from_numpy(np.random.RandomState(1).randn(*SHAPE).astype(np.float32) * 3)
    sig_min = torch.full((B,), 0.002)
    with torch.no_grad():
        f = port.diffusion.denoise(port._apply_fn(port.unet), x, sig_min)
    assert torch.equal(f, x)
    sigma = np.array([0.002, 0.01, 0.5, 3.0, 80.0], np.float32)
    for a, b in zip(port.diffusion.coeffs(torch.from_numpy(sigma)),
                    jmodel.diffusion.coeffs(jnp.asarray(sigma))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for steps in (1, 2, 5):
        np.testing.assert_array_equal(port.diffusion.tau_grid(steps),
                                      jmodel.diffusion.tau_grid(steps))


@pytest.mark.parametrize("method,steps", [("onestep", None), ("multistep", 3)])
def test_sampler_chains_match_jax(models, method, steps):
    jmodel, state, port = models
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jax.jit(lambda st, r: jmodel.sample(st, r, B, method=method,
                                                          steps=steps))(state, rng))
    init_rng, walk_rng = jax.random.split(rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(init_rng, SHAPE)))
    draws, key = [], walk_rng
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(sub, SHAPE))))
    out = port.sample(None, B, method=method, steps=steps, x_T=x_T).numpy() \
        if method == "onestep" else port.diffusion.sample(
            port._apply_fn(port.ema_unet), B, method=method, steps=steps, x_T=x_T,
            noise_fn=lambda j, shape: draws[j]).numpy()
    assert out.shape == ref.shape == SHAPE and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def _draws(jproc, rng, step):
    """A JAX CT step's random draws, made as ``grad_step`` and ``p_losses`` make them."""
    rng = jax.random.fold_in(rng, step)
    aug_rng, loss_rng, _ = jax.random.split(rng, 3)
    flip = jax.random.bernoulli(aug_rng, 0.5, (B, 1, 1, 1))
    index, noise_rng = _index(jproc, loss_rng, step)
    return {"flip": torch.tensor(np.asarray(flip).reshape(-1)), "index": index,
            "noise": torch.tensor(np.asarray(jax.random.normal(noise_rng, SHAPE)))}


def test_three_train_steps_match_jax(models):
    """Three steps (N = 10, 20, 40) from the same state and draws: the loss within rtol
    1e-4, ``ct_intervals`` exactly, each step's update by its norm within 1e-3."""
    jmodel, state, _ = models
    ct = TCT.ConsistencyModel(**ARGS, device="cpu")
    load_flax_train_state(ct, jax.device_get(state))
    batch = {"image": np.random.RandomState(3).randint(0, 256, SHAPE).astype(np.uint8),
             "label": np.zeros(B, np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    train_step = jax.jit(jmodel.train_step)
    for n in (10, 20, 40):
        before = [p.detach().clone() for p in ct.unet.parameters()]
        jbefore = as_port(ct.unet, state.params["model"])
        draws = _draws(jmodel.diffusion, rng, int(state.step))
        state, jmetrics = train_step(state, jbatch, rng)
        metrics = ct.train_step(batch, **draws)
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(jmetrics["train_loss"]), rtol=1e-4)
        assert float(metrics["train_ct_intervals"]) == int(jmetrics["train_ct_intervals"]) == n
        d_port = torch.cat([(p.detach() - b).reshape(-1)
                            for p, b in zip(ct.unet.parameters(), before)])
        d_jax = torch.cat([(a - b).reshape(-1) for a, b in
                           zip(as_port(ct.unet, state.params["model"]), jbefore)])
        assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-3
    assert ct.step == int(state.step) == 3


def test_conditional_eval_step_doubles_the_labels():
    """A class-conditional model's validation loss (EMA weights, true labels on both
    halves, N = s1) against JAX's ``eval_step``."""
    args = {**ARGS, "dim_mults": (1,), "num_classes": 4}
    port = TCT.ConsistencyModel(**args, device="cpu")
    jmodel = JCT.ConsistencyModel(**args)
    state = state_from_port(jmodel, port)
    batch = {"image": np.random.RandomState(4).randint(0, 256, SHAPE).astype(np.uint8),
             "label": np.array([0, 3, 1], np.int32)}
    rng = jax.random.PRNGKey(2)
    ref = jax.jit(jmodel.eval_step)(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index, noise_rng = _index(jmodel.diffusion, jax.random.fold_in(rng, 1), None)
    out = port.eval_step(batch, index=index,
                         noise=torch.from_numpy(np.array(jax.random.normal(noise_rng, SHAPE))))
    np.testing.assert_allclose(float(out["val_loss"]), float(ref["val_loss"]), rtol=1e-5)


def test_errors_are_jax_messages():
    for kw in ({"s0": 1}, {"sigma_min": 0.0}):
        with pytest.raises(ValueError) as jax_err:
            JCT.ConsistencyProcess(8, **kw)
        with pytest.raises(ValueError) as port_err:
            TCT.ConsistencyProcess(8, device="cpu", **kw)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as jax_err:
        JCT.ConsistencyModel(img_size=8, num_experts=4)
    with pytest.raises(ValueError) as port_err:
        TCT.ConsistencyModel(img_size=8, num_experts=4, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert registry.resolve_model_class("consistencymodel") is TCT.ConsistencyModel
