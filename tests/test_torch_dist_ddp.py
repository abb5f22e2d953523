"""Data parallelism of the port over 2 gloo ranks on the CPU (``ddp``, ``fsdp``): a step
on the ranks equals the one-process port step on the global batch, and JAX's
single-device step (the JAX package's own tests hold its sharded steps to that one).
Cases and the rank harness in ``torch_dist_cases.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as case
from lightning_generative_models_tpu.models.diffusion.ddpm import DDPM as JaxDDPM
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.weights import flatten_tree, load_flax_train_state
from torch_flax_params import state_from_port

torch.set_num_threads(1)


def _jax_draws(model, rng, step, shape):
    """JAX's draws of an unconditional DDPM step, as its ``train_step`` makes them."""
    rng = jax.random.fold_in(rng, step)
    aug_rng, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, noise_rng, _, _, _ = jax.random.split(loss_rng, 5)
    return {"flip": np.asarray(jax.random.bernoulli(aug_rng, 0.5, (shape[0], 1, 1, 1))
                               ).reshape(-1),
            "t": np.asarray(jax.random.randint(t_rng, (shape[0],), 0,
                                               model.diffusion.num_timesteps)).astype(np.int64),
            "noise": np.asarray(jax.random.normal(noise_rng, shape))}


def test_ddp_ddpm_steps_equal_one_process_and_jax(tmp_path):
    """2 ranks x 2 rows against one process on 4 rows (the port's own draws: the global
    batch's, each rank's rows) and against JAX's step (JAX's draws, sliced): the loss
    within 1e-5 relative, the update and the EMA's move by their norms within 1e-3."""
    jmodel, port = JaxDDPM(**case.DDPM_UNET), DDPM(**case.DDPM_UNET, device="cpu")
    state = state_from_port(jmodel, port)
    batch = case.batch_for(case.DDPM_UNET)
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws(jmodel, rng, 0, batch["image"].shape)
    jstate, jmetrics = jax.jit(jmodel.train_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    flat = flatten_tree(jax.device_get(state))
    one = case.ddpm_from_state(flat, batch, draws)[0]
    ranks = case.run_ranks(case.ddpm_from_state, 2, tmp_path, flat, batch, draws)
    for got_port, got_jax in ranks:
        np.testing.assert_allclose(got_port["metrics"]["train_loss"],
                                   one["metrics"]["train_loss"], rtol=1e-5)
        assert case.adam_gap(one, got_port) <= 1e-3
        assert case.ema_gap(one, got_port) <= 1e-3
        np.testing.assert_allclose(got_jax["metrics"]["train_loss"],
                                   float(jmetrics["train_loss"]), rtol=1e-5)
        jax_after = DDPM(**case.DDPM_UNET, device="cpu")
        load_flax_train_state(jax_after, flatten_tree(jax.device_get(jstate)))
        ref = {"before": got_jax["before"], "after": case._flat_state(jax_after)}
        assert case.adam_gap(ref, got_jax) <= 1e-3
        assert case.ema_gap(ref, got_jax) <= 1e-3


COUPLED = [("DCGAN", case.DCGAN, False), ("VQVAE", case.VQVAE_EMA, False),
           ("DDPM", case.DIT_MOE, True), ("CGAN", case.MNIST_COND, False),
           ("SGAN", case.MNIST_COND, False)]


def test_batch_coupled_models_equal_one_process(tmp_path):
    """The ops that couple examples across the batch, over 2 ranks: DCGAN's BatchNorm
    (statistics and running buffers), the VQ-VAE's EMA codebook (counts, sums,
    perplexity), the DiT-MoE's load-balancing loss, CGAN's dropout keep-masks (drawn
    example-major) and SGAN's supervised mean over the global batch's labeled rows; each
    equals one process. Samples drawn sharded over the ranks (InfoGAN's grid, one row a
    rank among them; the DiT-MoE) equal one process's within 1e-5."""
    one = case.coupled_steps(COUPLED)
    for got in case.run_ranks(case.coupled_steps, 2, tmp_path, COUPLED):
        for key, want in one["samples"].items():
            np.testing.assert_allclose(got["samples"][key].numpy(), want.numpy(),
                                       atol=1e-5, err_msg=key)
        for (name, _, _), ref, rec in zip(COUPLED, one["steps"], got["steps"]):
            for k, v in ref["metrics"].items():
                np.testing.assert_allclose(rec["metrics"][k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {k}")
            assert case.adam_gap(ref, rec) <= 1e-3, name
            if any(k.startswith("buffer/") for k in ref["after"]):
                assert case.buffer_gap(ref, rec) <= 1e-5, name


def test_fsdp_equals_replicated_and_resumes_on_one_process(tmp_path):
    """fsdp on 2 ranks (leaves of 1,024 elements and more sharded on dim 0: the weights,
    the EMA weights and Adam's moments each hold their rank's half of them) equals the
    replicated one-process step (loss within 1e-6 relative, as JAX's fsdp test holds its
    own); its checkpoint, whole tensors written by rank 0, resumes on one process to the
    one-process second step."""
    batch = case.batch_for(case.DDPM_UNET)
    one = case.step_record("DDPM", case.DDPM_UNET, batch)
    ranks = case.run_ranks(case.fsdp_step_and_save, 2, tmp_path, batch, str(tmp_path / "ckpt"))
    for rec in ranks:
        assert rec["sharded"] > 0 and rec["held"] == rec["expected_held"] < rec["whole"]
        assert rec["held_ema"] == rec["held_moments"] == rec["held"]
        np.testing.assert_allclose(rec["metrics"]["train_loss"], one["metrics"]["train_loss"],
                                   rtol=1e-6)
        assert case.adam_gap(one, rec) <= 1e-3
    two = case.step_record("DDPM", case.DDPM_UNET, batch, steps=2)
    resumed = DDPM(**case.DDPM_UNET, device="cpu")
    assert CheckpointManager(tmp_path / "ckpt").restore(resumed) == (1, 0)
    rec = case.step_record("DDPM", case.DDPM_UNET, batch, seed=6, model=resumed)
    np.testing.assert_allclose(rec["metrics"]["train_loss"], two["metrics"]["train_loss"],
                               rtol=1e-5)
    for k, v in two["after"].items():
        assert float((rec["after"][k] - v).norm()) <= 1e-3 * max(float(v.norm()), 1e-3), k


def test_batch_placement_and_its_errors_are_jax_texts():
    """``process_local_slice`` keeps rank p's rows [p B/n, (p+1) B/n) on the batch axis
    (axis 1 for a stack of unrolled steps) and ``local_batch_size`` divides by the data
    ranks, with the JAX package's errors for a batch they do not divide."""
    from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib

    x = np.arange(24).reshape(2, 12)
    np.testing.assert_array_equal(mesh_lib.process_local_slice(x, 1, 2, 3), x[:, 8:12])
    np.testing.assert_array_equal(mesh_lib.process_local_slice(x.T, 0, 1, 4), x.T[3:6])
    with pytest.raises(ValueError, match="global batch 12 not divisible by 5 processes"):
        mesh_lib.process_local_slice(x, 1, 0, 5)
    assert mesh_lib.local_batch_size(128) == 128  # one process: no ambient mesh
    mesh = type("M", (), {"size": lambda self, axis: 3})()
    with pytest.raises(ValueError, match="global batch size 128 not divisible by 3 devices"):
        mesh_lib.local_batch_size(128, mesh)
