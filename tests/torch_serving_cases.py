"""Cases of the port's serving export (``serving.py``, ``export.py``) on the CPU, against
the live port sampler and against the JAX package's own artifacts.

The test files ``test_torch_serving.py``, ``test_torch_serving_families.py`` and
``test_torch_export_cli.py`` import these tests (at most 6 a file, ``torch_split.py``).
Every case of ``tests/test_serving.py`` runs here against the port, with the same models
and arguments:

- the artifact equals the live port sampler from the same seed (``artifact(s)`` against
  ``model.sample(torch.Generator().manual_seed(s), B)``), within 1e-6 (the program runs
  the live sampler's step functions, as scan bodies: equal in practice);
- for DDPM/DDIM, DPM++ and CGAN the port's program, fed the draws JAX makes itself (x_T
  as ``normal(split(key)[0])``, as ``tests/torch_diffusion_cases.py`` makes it; CGAN's z
  as ``normal(key)``) with JAX's weights carried by ``weights.py`` (drawn by the port,
  ``torch_flax_params``), matches JAX's ``load_artifact(...)(key)`` within the sampling
  parity tests' ATOL 1e-4 (per-evaluation differences of ~1e-6 pass through the x0 clip
  and the chain) for the diffusion cases and 1e-5 for CGAN's single generator call.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.registry import load_model as jax_load_model
from lightning_generative_models_tpu.serving import export_sampler as jax_export_sampler
from lightning_generative_models_tpu.serving import load_artifact as jax_load_artifact
from lightning_generative_models_tpu.serving import save_artifact as jax_save_artifact
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.serving import (
    export_sampler,
    load_artifact,
    save_artifact,
)
from lightning_generative_models_tpu_torch.weights import load_flax_params
from torch_flax_params import state_from_port

torch.set_num_threads(1)

LIVE_TOL = 1e-6
JAX_ATOL = 1e-4  # the diffusion sampling parity tests' (torch_diffusion_cases.ATOL)
GAN_ATOL = 1e-5

TINY_DDPM = {"img_channels": 1, "img_size": 8, "dim": 8, "diffusion_timesteps": 8,
             "sampling_timesteps": 4, "use_bf16": False}
FAMILIES = {
    "fm": ("FlowMatching", {"img_channels": 1, "img_size": 8, "dim": 8,
                            "sampling_steps": 3, "use_bf16": False}),
    "edm": ("EDM", {"img_channels": 1, "img_size": 8, "dim": 8,
                    "sampling_steps": 3, "use_bf16": False}),
    "dit": ("DDPM", {"img_channels": 1, "img_size": 8, "network": "dit", "dim": 16,
                     "depth": 2, "num_heads": 2, "patch_size": 4,
                     "diffusion_timesteps": 8, "sampling_timesteps": 4,
                     "use_bf16": False}),
    "ct": ("ConsistencyModel", {"img_channels": 1, "img_size": 8, "dim": 8,
                                "sampling_steps": 2, "s0": 4, "s1": 8,
                                "curriculum_steps": 0, "use_bf16": False}),
}
CGAN = {"img_channels": 1, "img_size": 28, "latent_dim": 8, "num_classes": 10,
        "summary": False}


def _port(name, args, seed=2):
    model = load_model({"name": name, "args": args}, device="cpu")
    model.init_params(torch.Generator().manual_seed(seed))
    return model


def _roundtrip(model, path, batch, meta=None, **kwargs):
    """export -> save -> load: (sidecar, artifact)."""
    sidecar = save_artifact(export_sampler(model, batch, **kwargs), path, meta=meta)
    return sidecar, load_artifact(path)


def _live(model, seed, batch, labels=None, **kwargs):
    generator = torch.Generator().manual_seed(seed)
    if labels is not None:
        return model.sample_classes(generator, torch.tensor(labels))
    return model.sample(generator, batch, **kwargs)


def _assert_live(artifact, model, seed, batch, **kwargs):
    frozen = artifact(seed)
    live = _live(model, seed, batch, **kwargs)
    assert frozen.shape == live.shape
    np.testing.assert_allclose(frozen.numpy(), live.numpy(), rtol=0, atol=LIVE_TOL)
    return frozen


def _jax_artifact(jmodel, state, tmp_path, batch, **kwargs):
    path = tmp_path / "jax.jaxexport"
    jax_save_artifact(jax_export_sampler(jmodel, state, batch, **kwargs), path)
    return jax_load_artifact(path)


def _ddpm_pair(args):
    """(JAX DDPM, its state, the port's DDPM) with the same EMA weights."""
    model = _port("DDPM", args)
    jmodel = jax_load_model({"name": "DDPM", "args": args})
    state = state_from_port(jmodel, model)
    load_flax_params(model.ema_unet, jax.device_get(state.ema_params))
    return jmodel, state, model


def _x_T_of(key, shape):
    """The x_T that JAX's strided samplers draw from ``key``."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0], shape)))


def _assert_jax(jax_art, artifact, draws, key, atol):
    ref = np.asarray(jax.device_get(jax_art(key)))
    out = artifact.run(*draws).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def ddpm_pair():
    """(JAX DDPM, its state, the port's DDPM) of ``TINY_DDPM``, built once a file."""
    return _ddpm_pair(TINY_DDPM)


@pytest.fixture(scope="module")
def ddpm_artifact(ddpm_pair, tmp_path_factory):
    """The port DDPM's default sampler (DDIM-4), exported and saved once a file:
    (sidecar, its path)."""
    path = tmp_path_factory.mktemp("serving") / "ddpm.pt2"
    sidecar = save_artifact(export_sampler(ddpm_pair[2], 2), path,
                            meta={"model": "DDPM", "step": 0})
    return sidecar, path


# -- tests/test_serving.py's cases ------------------------------------------------------


def test_roundtrip_matches_live_sample(ddpm_pair, ddpm_artifact, tmp_path):
    jmodel, state, model = ddpm_pair
    sidecar, path = ddpm_artifact
    artifact = load_artifact(path)
    _assert_live(artifact, model, 7, 2)
    assert sidecar["output_shape"] == [2, 8, 8, 1] and sidecar["output_dtype"] == "float32"
    assert sidecar["sha256"] == artifact.meta["sha256"] and sidecar["device"] == "cpu"
    assert artifact.meta["model"] == "DDPM" and path.with_name("ddpm.pt2.json").exists()
    assert [d["name"] for d in sidecar["draw_plan"]] == ["x_T"]  # DDIM, eta 0

    key = jax.random.PRNGKey(7)
    jax_art = _jax_artifact(jmodel, state, tmp_path, 2)
    _assert_jax(jax_art, artifact, [_x_T_of(key, (2, 8, 8, 1))], key, JAX_ATOL)


def test_dpmpp_sampler_bakes_into_artifact(ddpm_pair, tmp_path):
    jmodel, state, model = ddpm_pair
    _, artifact = _roundtrip(model, tmp_path / "a.pt2", 2, method="dpmpp", steps=2)
    _assert_live(artifact, model, 3, 2, method="dpmpp", steps=2)

    key = jax.random.PRNGKey(3)
    jax_art = _jax_artifact(jmodel, state, tmp_path, 2, method="dpmpp", steps=2)
    _assert_jax(jax_art, artifact, [_x_T_of(key, (2, 8, 8, 1))], key, JAX_ATOL)


def test_ancestral_chain_scans_over_every_step(tmp_path):
    """The ancestral default (no sampling_timesteps: DDPM over T = 8 steps) as one scan:
    x_T and a draw on every step but t = 0, in the live sampler's order."""
    args = {k: v for k, v in TINY_DDPM.items() if k != "sampling_timesteps"}
    model = _port("DDPM", args)
    sidecar, artifact = _roundtrip(model, tmp_path / "anc.pt2", 2)
    noise = sidecar["draw_plan"][1]
    assert noise["shape"] == [8, 2, 8, 8, 1] and noise["draw_steps"] == list(range(7))
    scans = [n for n in artifact.program.graph.nodes
             if n.op == "call_function" and "scan" in str(n.target)]
    assert len(scans) == 1
    _assert_live(artifact, model, 5, 2)


def test_labels_rejected_without_sample_classes(ddpm_pair):
    with pytest.raises(ValueError, match="sample_classes"):
        export_sampler(ddpm_pair[2], 2, labels=[0, 1])


def test_sha256_mismatch_detected(ddpm_artifact, tmp_path):
    shutil.copy(ddpm_artifact[1], tmp_path / "b.pt2")
    shutil.copy(ddpm_artifact[1].with_name("ddpm.pt2.json"), tmp_path / "b.pt2.json")
    sidecar_path = tmp_path / "b.pt2.json"
    meta = json.loads(sidecar_path.read_text())
    meta["sha256"] = "0" * 64
    sidecar_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_artifact(tmp_path / "b.pt2")


def test_artifact_refused_on_another_device(tmp_path):
    """A CPU-exported program holds the plain versions of the kernels: refused on the
    card, whether or not this machine has one."""
    model = _port("GAN", {"img_channels": 1, "img_size": 8, "latent_dim": 4})
    save_artifact(export_sampler(model, 2), tmp_path / "g.pt2")
    with pytest.raises(ValueError, match="exported for cpu"):
        load_artifact(tmp_path / "g.pt2", device="cuda")
    assert load_artifact(tmp_path / "g.pt2", device="cpu")(1).shape == (2, 8, 8, 1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_new_family_export_roundtrip(tmp_path, family):
    """FlowMatching, EDM, the DiT backbone and ConsistencyModel through the same surface:
    the artifact reproduces the live sample (EDM's Heun-3 as a scan of 2 Heun steps and
    one of its final Euler step)."""
    name, args = FAMILIES[family]
    model = _port(name, args)
    sidecar, artifact = _roundtrip(model, tmp_path / "m.pt2", 2,
                                   meta={"model": name, "step": 0})
    assert sidecar["output_shape"] == [2, 8, 8, 1]
    _assert_live(artifact, model, 7, 2)


def test_latent_diffusion_export_bakes_frozen_ae(tmp_path):
    """LatentDiffusion's sampler decodes through the frozen autoencoder (its quantizer
    and decoder): the artifact serves images, not latents."""
    model = _port("LatentDiffusion", {
        "img_size": 32, "img_channels": 3,
        "autoencoder": {"config_path": "configs/vae/vqvae_cifar10.json"},
        "dim": 8, "dim_mults": [1, 2], "diffusion_timesteps": 8, "sampling_timesteps": 4,
        "use_bf16": False})
    sidecar, artifact = _roundtrip(model, tmp_path / "ldm.pt2", 2)
    assert sidecar["output_shape"] == [2, 32, 32, 3]  # image space, not 4x4x64 latents
    assert sidecar["draw_plan"][0]["shape"] == [2, 4, 4, 64]
    _assert_live(artifact, model, 3, 2)


def test_conditional_labels_baked(tmp_path):
    model = _port("CGAN", CGAN)
    jmodel = jax_load_model({"name": "CGAN", "args": CGAN})
    state = state_from_port(jmodel, model)
    sidecar, artifact = _roundtrip(model, tmp_path / "cgan.pt2", 3, labels=[0, 3, 7])
    assert sidecar["output_shape"] == [3, 28, 28, 1]
    assert sidecar["draw_plan"] == [{"name": "z", "shape": [3, 8], "distribution": "normal",
                                     "order": 0}]
    _assert_live(artifact, model, 5, 3, labels=[0, 3, 7])

    key = jax.random.PRNGKey(5)
    jax_art = _jax_artifact(jmodel, state, tmp_path, 3, labels=[0, 3, 7])
    z = torch.from_numpy(np.array(jax.random.normal(key, (3, 8))))
    _assert_jax(jax_art, artifact, [z], key, GAN_ATOL)
