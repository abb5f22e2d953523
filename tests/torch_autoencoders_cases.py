"""Cases of the port's DAE and UNet autoencoder against the JAX package's, on the CPU,
imported by ``test_torch_autoencoders.py`` (DAE) and ``test_torch_unet_ae.py``.

Both sides hold the port's weights (``torch_flax_params``); each model's JAX reference is
one compiled program (``torch_adam_model_check``). The DAE (8 x 8 x 1, gaussian noise 0.1)
takes JAX's flip and noise of ``split(fold_in(rng, step))``; eval and denoise JAX's noise of
``fold_in(rng, 1)`` and of ``rng``; ``sample`` decodes JAX's gaussian images; its
salt-and-pepper noise is JAX's on JAX's two masks. The UNet
autoencoder (8 x 8 x 1, base features 4, depth 2) takes JAX's flip of ``fold_in(rng, step)``.
Tolerances: metrics rtol 1e-5, gradients 1e-4 and updates 1e-3 of their norms, images
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.autoencoder import dae as JDAE
from lightning_generative_models_tpu.models.autoencoder import unet as JUNET
from lightning_generative_models_tpu_torch.models.autoencoder import dae as TDAE
from lightning_generative_models_tpu_torch.models.autoencoder import unet as TUNET
from lightning_generative_models_tpu_torch.registry import resolve_model_class
from torch_adam_model_check import (
    as_torch,
    check_npz_loads,
    check_two_steps,
    off_zero,
    reference,
)

torch.set_num_threads(1)

B = 4
SHAPE = (8, 8, 1)
DAE_ARGS = dict(img_channels=1, img_size=8, noise_type="gaussian", noise_level=0.1, lr=1e-3)
SP_ARGS = {**DAE_ARGS, "noise_type": "salt_and_pepper", "noise_level": 0.3}
UNET_ARGS = dict(img_channels=1, img_size=8, base_features=4, depth=2, lr=1e-3)
RNG = jax.random.PRNGKey(7)


def _batch(seed):
    return {"image": np.random.RandomState(seed).randint(0, 256, (B, *SHAPE)).astype(np.uint8),
            "label": np.arange(B, dtype=np.int32)}


def _flip(key):
    return jax.random.bernoulli(key, 0.5, (B, 1, 1, 1)).reshape(-1)


def _noise(key, jmodel):
    """JAX DAE.add_noise's draws from ``key``, by the port's keyword names."""
    if jmodel.noise_type == "gaussian":
        return {"noise": jax.random.normal(key, (B, *SHAPE))}
    salt, pepper = jax.random.split(key)
    p = jmodel.noise_level / 2
    return {"salt": jax.random.bernoulli(salt, p, (B, *SHAPE)),
            "pepper": jax.random.bernoulli(pepper, p, (B, *SHAPE))}


def _dae_draws(jmodel):
    def draws(rng, step):
        aug_rng, noise_rng = jax.random.split(jax.random.fold_in(rng, step))
        return {"flip": _flip(aug_rng), **_noise(noise_rng, jmodel)}
    return draws


def _dae_refs(jmodel):
    sp_model = JDAE.DAE(**SP_ARGS)

    def refs(state, batch, rng):
        x = batch["image"].astype(jnp.float32) / 127.5 - 1.0
        return {"eval": jmodel.eval_step(state, batch, rng),
                "sp_x": x, "sp_noisy": sp_model.add_noise(x, rng),
                "sp_masks": _noise(rng, sp_model),
                "eval_noise": _noise(jax.random.fold_in(rng, 1), jmodel),
                "denoise": jmodel.denoise(state, batch, rng), "denoise_noise": _noise(rng, jmodel),
                "sample": jmodel.sample(state, rng, 3),
                "sample_noise": jax.random.normal(rng, (3, *SHAPE))}
    return refs


def _dae_case(args, seed):
    port = TDAE.DAE(**args, device="cpu")
    off_zero(port.net, seed)
    jmodel = JDAE.DAE(**{k: v for k, v in args.items()})
    batch = _batch(seed)
    out = reference(jmodel, port, batch, RNG, _dae_draws(jmodel), _dae_refs(jmodel))
    return jmodel, port, batch, as_torch(out), out


@pytest.fixture(scope="module")
def dae():
    return _dae_case(DAE_ARGS, 1)


def test_dae_train_steps_match_jax(dae):
    """Two steps with JAX's flip and noise: metrics, gradients and updates."""
    _, port, batch, out, _ = dae
    check_two_steps(port, batch, out, lambda o, step: o["draws"][step])


def test_dae_eval_denoise_sample_match_jax(dae):
    _, port, batch, out, raw = dae
    model = TDAE.DAE(**DAE_ARGS, device="cpu")
    model.load_flax_weights(jax.device_get(raw["state"]))
    refs = out["refs"]
    metrics = model.eval_step(batch, **refs["eval_noise"])
    for key, value in refs["eval"].items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5)
    np.testing.assert_allclose(model.denoise(batch, **refs["denoise_noise"]).numpy(),
                               refs["denoise"].numpy(), atol=1e-5)
    np.testing.assert_allclose(model.sample(None, 3, noise=refs["sample_noise"]).numpy(),
                               refs["sample"].numpy(), atol=1e-5)


def test_dae_loads_a_jax_train_state(dae, tmp_path):
    _, _, _, _, raw = dae
    check_npz_loads(lambda: TDAE.DAE(**DAE_ARGS, device="cpu"), raw["state"], tmp_path)


def test_dae_salt_and_pepper_matches_jax(dae):
    """Salt-and-pepper noise (level 0.3): on JAX's two masks of ``split(rng)`` the port's
    add_noise is JAX's add_noise (computed in the gaussian DAE's program), and its
    grad_step takes them (the rest of its step is the gaussian case's)."""
    refs = dae[3]["refs"]
    masks = {k: refs["sp_masks"][k] for k in ("salt", "pepper")}
    assert 0 < masks["salt"].sum() and 0 < masks["pepper"].sum()
    model = TDAE.DAE(**SP_ARGS, device="cpu")
    out = model.add_noise(refs["sp_x"], **masks)
    np.testing.assert_array_equal(out.numpy(), refs["sp_noisy"].numpy())
    grads, metrics = model.grad_step(_batch(2), flip=torch.zeros(B, dtype=torch.bool),
                                     **as_torch(masks))
    assert len(grads) == 8 and np.isfinite(float(metrics["loss"]))


def test_dae_noise_and_errors_as_jax():
    """Salt is applied first and pepper over it; an unknown noise type raises JAX's
    ValueError; the registry resolves the name."""
    model = TDAE.DAE(**SP_ARGS, device="cpu")
    x = torch.zeros(1, 2, 2, 1)
    salt = torch.tensor([True, True, False, False]).reshape(1, 2, 2, 1)
    pepper = torch.tensor([True, False, True, False]).reshape(1, 2, 2, 1)
    out = model.add_noise(x, salt=salt, pepper=pepper).reshape(-1).tolist()
    assert out == [-1.0, 1.0, -1.0, 0.0]
    for cls in (TDAE.DAE, JDAE.DAE):
        with pytest.raises(ValueError, match="Invalid noise type specified"):
            cls(noise_type="poisson", **({"device": "cpu"} if cls is TDAE.DAE else {}))
    assert resolve_model_class("dae") is TDAE.DAE


def _unet_refs(jmodel):
    def refs(state, batch, rng):
        return {"eval": jmodel.eval_step(state, batch, rng),
                "reconstruct": jmodel.reconstruct(state, batch)}
    return refs


@pytest.fixture(scope="module")
def unet():
    port = TUNET.UNetAE(**UNET_ARGS, device="cpu")
    off_zero(port.net, 3)
    jmodel = JUNET.UNetAE(**UNET_ARGS)
    batch = _batch(3)
    out = reference(jmodel, port, batch, RNG,
                           lambda rng, step: {"flip": _flip(jax.random.fold_in(rng, step))},
                           _unet_refs(jmodel))
    return jmodel, port, batch, as_torch(out), out


def test_unet_ae_train_steps_match_jax(unet):
    _, port, batch, out, _ = unet
    check_two_steps(port, batch, out, lambda o, step: o["draws"][step])


def test_unet_ae_eval_and_reconstruct_match_jax(unet, tmp_path):
    """eval and reconstruct on the JAX state after one step, carried in by an .npz."""
    _, _, batch, out, raw = unet
    model = check_npz_loads(lambda: TUNET.UNetAE(**UNET_ARGS, device="cpu"), raw["state"],
                            tmp_path)
    metrics = model.eval_step(batch)
    np.testing.assert_allclose(float(metrics["val_loss"]), float(out["refs"]["eval"]["val_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(model.reconstruct(batch).numpy(),
                               out["refs"]["reconstruct"].numpy(), atol=1e-5)


def test_unet_ae_refusals_as_jax():
    """The divisibility ValueError and sample's NotImplementedError carry JAX's texts."""
    for cls, kw in ((TUNET.UNetAE, {"device": "cpu"}), (JUNET.UNetAE, {})):
        with pytest.raises(ValueError, match="img_size 28 not divisible by 8"):
            cls(img_size=28, depth=3, **kw)
    model = TUNET.UNetAE(**UNET_ARGS, device="cpu")
    with pytest.raises(NotImplementedError, match="UNet autoencoder has no generative prior"):
        model.sample(None, 2)
    assert resolve_model_class("UNet") is TUNET.UNetAE
