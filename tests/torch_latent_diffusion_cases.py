"""Cases of the port's latent models against the JAX package's, on the CPU, imported by
``test_torch_latent_diffusion.py`` and ``test_torch_latent_chains.py``.
JAX package's, on the CPU.

Each model diffuses in the latent space of a tiny VQ-VAE (32 px, hidden 16, embedding 8,
16 codes) whose config the tests write: latents 4 x 4 x 8, the latent configs' 4 x 4 (at
2 x 2 the UNet's middle runs at 1 x 1, where a GroupNorm group holds 4 values and f32
noise in their variance moves some gradients by 0.5%). The UNet is dim 16, dim_mults
(1, 2), f32. Both sides hold the same weights, UNet and autoencoder, drawn by
the port (``torch_flax_params`` fills JAX's ``mutable["autoencoder"]`` from the port's
``flax_layout``). Random draws are JAX's own, handed to the port: a step's flips and its
process's draws (t and noise, sigma's normal and noise, logit-normal t and noise), the
samplers' starts. Tolerances: the hooks within 1e-5 and the same codes; losses within
rtol 1e-4 and each step's update by its norm within 1e-3 (``test_torch_train.py``); the
chains within 1e-4 (Euler) and 1e-3 (Heun from 80 z, see ``test_torch_edm.py``), decoded
to images.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.config import ConfigError as JaxConfigError
from lightning_generative_models_tpu.models.diffusion import edm as JEDM
from lightning_generative_models_tpu.models.diffusion import flow_matching as JFM
from lightning_generative_models_tpu.models.diffusion import latent_diffusion as JLD
from lightning_generative_models_tpu.models.vae import vqvae as JVQVAE
from lightning_generative_models_tpu.ops.preprocess import prepare_batch as jax_prepare
from lightning_generative_models_tpu_torch import registry
from lightning_generative_models_tpu_torch.config import ConfigError
from lightning_generative_models_tpu_torch.models.diffusion import edm as TEDM
from lightning_generative_models_tpu_torch.models.diffusion import flow_matching as TFM
from lightning_generative_models_tpu_torch.models.diffusion import latent_diffusion as TLD
from lightning_generative_models_tpu_torch.models.vae.vqvae import VQVAE
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.weights import load_flax_train_state
from torch_flax_params import as_port, state_from_port

torch.set_num_threads(1)

_JAX_VQVAE_INIT = JVQVAE.VQVAE.init_state

B = 3
IMG = (B, 32, 32, 3)
LATENT = (B, 4, 4, 8)
AE_ARGS = {"img_channels": 3, "img_size": 32, "embedding_dim": 8, "num_embeddings": 16,
           "hidden_dim": 16, "num_residual_layers": 1, "num_residual_hiddens": 8,
           "use_ema": False, "lr": 1e-3}
UNET = dict(img_size=32, img_channels=3, dim=16, dim_mults=(1, 2), use_bf16=False, lr=1e-3,
            latent_scale=2.0)
FAMILIES = {
    "ldm": (JLD.LatentDiffusion, TLD.LatentDiffusion,
            dict(diffusion_timesteps=20, sampling_timesteps=3)),
    "ledm": (JEDM.LatentEDM, TEDM.LatentEDM, dict(sampling_steps=2)),
    "lfm": (JFM.LatentFlowMatching, TFM.LatentFlowMatching, dict(sampling_steps=3)),
}


def _write_ae_config(path, **overrides):
    path.write_text(json.dumps({
        "model": {"name": "VQVAE", "args": {**AE_ARGS, **overrides}},
        "dataset": {"name": "CIFAR10", "img_size": AE_ARGS["img_size"], "img_channels": 3},
    }))
    return str(path)


@pytest.fixture(scope="module")
def ae_config(tmp_path_factory):
    return _write_ae_config(tmp_path_factory.mktemp("ae") / "vqvae_tiny.json")


def _args(name, ae_config, **extra):
    return {**UNET, **FAMILIES[name][2], "autoencoder": {"config_path": ae_config}, **extra}


def _zeros_init_state(self, rng):
    """A JAX VQ-VAE's ``init_state`` as zeros of its shapes: the JAX latent model draws
    its autoencoder eagerly (op by op, ~20 s on the CPU), and ``state_from_port``
    replaces every value with the port's anyway."""
    shapes = jax.eval_shape(lambda r: _JAX_VQVAE_INIT(self, r), rng)
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


class _Models(dict):
    """name -> (JAX model, its TrainState, the port's model on the CPU), each built once,
    when a test first asks for it (a file builds only the families it tests)."""

    def __init__(self, ae_config):
        super().__init__()
        self.ae_config = ae_config

    def __missing__(self, name):
        jcls, tcls, _ = FAMILIES[name]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JVQVAE.VQVAE, "init_state", _zeros_init_state)
            port = tcls(**_args(name, self.ae_config), device="cpu")
            jmodel = jcls(**_args(name, self.ae_config))
            self[name] = (jmodel, state_from_port(jmodel, port), port)
        return self[name]


@pytest.fixture(scope="module")
def models(ae_config):
    return _Models(ae_config)


@pytest.fixture(scope="module")
def batch():
    return {"image": np.random.RandomState(3).randint(0, 256, IMG).astype(np.uint8),
            "label": np.zeros(B, np.int32)}


def test_hooks_and_val_latent_std_match_jax(models, batch):
    """Into the latent space (encoder, times latent_scale) and out of it (quantizer and
    decoder: the same codes, then the same images), and the logged latent std."""
    jmodel, state, port = models["ldm"]
    x01 = np.array(jax_prepare({"image": jnp.asarray(batch["image"])})["image"])
    z = port._to_diffusion_space(torch.from_numpy(x01))
    jz = np.array(jax.jit(jmodel._to_diffusion_space)(state, x01))
    assert z.shape == LATENT
    np.testing.assert_allclose(z.numpy(), jz, atol=1e-5, rtol=0)
    jimg = np.asarray(jax.jit(jmodel._from_diffusion_space)(state, jz))
    np.testing.assert_allclose(port._from_diffusion_space(torch.from_numpy(jz)).numpy(), jimg,
                               atol=1e-5, rtol=0)
    assert jimg.shape == IMG
    # eval_step's val_latent_std is JAX's jnp.std of the batch's latents, unscaled.
    metrics = port.eval_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(metrics["val_latent_std"]),
                               float(jnp.std(jz)) / UNET["latent_scale"], rtol=1e-5)
    assert np.isfinite(float(metrics["val_loss"]))


def _draws(name, rng, step):
    """A JAX step's flips and its process's draws, as ``grad_step`` and the family's
    ``p_losses`` make them."""
    rng = jax.random.fold_in(rng, step)
    aug_rng, loss_rng, _ = jax.random.split(rng, 3)
    flip = jax.random.bernoulli(aug_rng, 0.5, (B, 1, 1, 1))
    draws = {"flip": torch.tensor(np.asarray(flip).reshape(-1))}
    if name == "ldm":
        a_rng, b_rng = jax.random.split(loss_rng, 5)[:2]
        draws["t"] = torch.tensor(np.asarray(jax.random.randint(a_rng, (B,), 0, 20)).astype(np.int64))
    else:
        a_rng, b_rng = jax.random.split(loss_rng)
        normal = np.asarray(jax.random.normal(a_rng, (B,)))
        if name == "ledm":
            draws["sigma_normal"] = torch.tensor(normal)
        else:
            draws["t"] = torch.sigmoid(torch.tensor(normal))
    draws["noise"] = torch.tensor(np.asarray(jax.random.normal(b_rng, LATENT)))
    return draws


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_step_matches_jax(models, batch, ae_config, name):
    """One step from the same state and draws; the autoencoder does not move."""
    jmodel, state, _ = models[name]
    model = FAMILIES[name][1](**_args(name, ae_config), device="cpu")
    load_flax_train_state(model, jax.device_get(state))
    ae_before = [p.detach().clone() for p in model.ae.net.parameters()]
    before = [p.detach().clone() for p in model.unet.parameters()]
    jbefore = as_port(model.unet, state.params["model"])
    rng = jax.random.PRNGKey(11)
    draws = _draws(name, rng, 0)
    new_state, jmetrics = jax.jit(jmodel.train_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    metrics = model.train_step(batch, **draws)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(jmetrics["train_loss"]),
                               rtol=1e-4)
    d_port = torch.cat([(p.detach() - b).reshape(-1)
                        for p, b in zip(model.unet.parameters(), before)])
    d_jax = torch.cat([(a - b).reshape(-1) for a, b in
                       zip(as_port(model.unet, new_state.params["model"]), jbefore)])
    assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(model.ae.net.parameters(), ae_before))


@pytest.mark.parametrize("name,tol", [("ledm", 1e-3), ("lfm", 1e-4)])
def test_sampler_chain_matches_jax(models, name, tol):
    """The family's default sampler (Heun-2, Euler-3) from JAX's start, with the EMA
    weights, decoded to images (the DDIM chain is ``test_torch_diffusion.py``'s, its
    decode the hooks test's)."""
    jmodel, state, port = models[name]
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jmodel.sample(state, rng, B))
    x_T = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], LATENT)))
    out = port.sample(None, B, x_T=x_T).numpy()
    assert out.shape == ref.shape == IMG
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)


def test_checkpoint_holds_the_autoencoder(tmp_path, ae_config, monkeypatch):
    """The autoencoder rides in the model's checkpoint: restoring it replaces the one the
    model was built with. With an experiment_name the autoencoder comes, strictly, from
    the port's checkpoint of that run."""
    trained = VQVAE(**AE_ARGS, device="cpu")
    trained.init_params(torch.Generator().manual_seed(9))
    CheckpointManager(tmp_path / "VQVAE" / "ae_run" / "checkpoints").save_last(trained, 7, 1)
    monkeypatch.setattr(TLD, "EXPERIMENT_DIR", tmp_path)
    spec = {"config_path": ae_config, "experiment_name": "ae_run", "which": "last"}
    ldm = TLD.LatentDiffusion(**{**_args("ldm", ae_config), "autoencoder": spec}, device="cpu")
    for a, b in zip(ldm.ae.net.parameters(), trained.net.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        TLD.LatentDiffusion(**{**_args("ldm", ae_config),
                               "autoencoder": {**spec, "experiment_name": "missing"}},
                            device="cpu")

    mgr = CheckpointManager(tmp_path / "ldm" / "checkpoints")
    mgr.save_last(ldm, 1, 0)
    fresh = TLD.LatentDiffusion(**_args("ldm", ae_config), device="cpu")  # a random AE
    assert not torch.equal(next(fresh.ae.net.parameters()), next(trained.net.parameters()))
    assert mgr.restore(fresh) == (1, 0)
    for a, b in zip(fresh.ae.net.parameters(), trained.net.parameters()):
        assert torch.equal(a, b)
    assert fresh.param_counts()["autoencoder"] == sum(p.numel() for p in trained.net.parameters())


def test_autoencoder_spec_errors_are_jax_messages(tmp_path):
    """An autoencoder of another image size and one without a quantizer (a VAE)."""
    wrong_size = _write_ae_config(tmp_path / "vq16.json", img_size=16)
    vae = tmp_path / "vae.json"
    vae.write_text(json.dumps({
        "model": {"name": "VAE", "args": {"img_channels": 3, "img_size": 32}},
        "dataset": {"name": "CIFAR10", "img_size": 32, "img_channels": 3}}))
    for path, jax_exc, port_exc in ((wrong_size, JaxConfigError, ConfigError),
                                    (str(vae), ValueError, ValueError)):
        spec = {"config_path": path}
        with pytest.raises(jax_exc) as jax_err:
            JLD.LatentDiffusion._build_autoencoder(spec, 3, 32)
        with pytest.raises(port_exc) as port_err:
            TLD.LatentDiffusion._build_autoencoder(spec, 3, 32, torch.device("cpu"))
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="requires autoencoder"):
        TLD.LatentDiffusion(img_size=32, device="cpu")
    for name in ("LatentDiffusion", "LatentEDM", "LatentFlowMatching"):
        assert registry.resolve_model_class(name) is {
            "LatentDiffusion": TLD.LatentDiffusion, "LatentEDM": TEDM.LatentEDM,
            "LatentFlowMatching": TFM.LatentFlowMatching}[name]
