"""Cases of the port's serving export of the samplers with draws other than one normal
start (VAE, DAE, NICE, Glow, VQ-VAE, VQGAN, InfoGAN, PixelCNN), the export of every
registry name, an artifact of the first draw-plan format, and the export CLI on one of
them, on the CPU.

The test files ``test_torch_serving_autoencoders.py``, ``test_torch_serving_flows.py`` and
``test_torch_serving_registry.py`` import these tests (at most 6 a file, ``torch_split.py``).
For each family, at tiny widths in f32:

- the artifact equals the live port sampler from the same seed within ``LIVE_TOL`` 1e-6
  (the program runs the live sampler's math, PixelCNN's its very step functions);
- the port's program, fed the draws that JAX's ``sample`` makes itself from one key
  (VAE, DAE, NICE, Glow: ``normal(key)``; VQ: ``randint(key)``; InfoGAN: ``split(key, 4)``,
  z from the first key, the code ends from the third and fourth; PixelCNN:
  ``gumbel(fold_in(key, idx))`` at each raster step) with JAX's weights carried by
  ``weights.py`` (drawn by the port, ``torch_flax_params``; every zero leaf of the flows and
  PixelCNN drawn off zero), matches JAX's ``load_artifact(...)(key)`` within the tolerance
  of the family's sample-parity test: 1e-5 (VAE ``test_torch_vae_lpips``, DAE
  ``torch_autoencoders_cases``, NICE and Glow ``torch_flows_cases``), 5e-5 (VQ-VAE and
  VQGAN decodes, ``torch_vqvae_cases``), 1e-5 of 1 + |ref| (InfoGAN with its generator in
  f32 on both sides, ``torch_gan_cond_cases``), and PixelCNN's levels equal
  (``test_torch_pixelcnn``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gan_check as gc
from lightning_generative_models_tpu.registry import load_model as jax_load_model
from lightning_generative_models_tpu_torch import export
from lightning_generative_models_tpu_torch.registry import available_models, load_model
from lightning_generative_models_tpu_torch.serving import (
    export_sampler,
    load_artifact,
    save_artifact,
)
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from torch_adam_model_check import off_zero
from torch_flax_params import state_from_port
from torch_serving_cases import CGAN, _assert_jax, _assert_live, _jax_artifact

torch.set_num_threads(1)

LIVE_TOL = 1e-6
B = 3
VQ_ARGS = {"img_channels": 3, "img_size": 16, "embedding_dim": 4, "num_embeddings": 16,
           "hidden_dim": 8, "num_residual_layers": 1, "num_residual_hiddens": 4}
GLOW = {"img_channels": 3, "img_size": 8, "levels": 2, "depth": 2, "width": 8,
        "sample_temperature": 0.7}
INFOGAN = gc.config("infogan.json", img_size=28, img_channels=1)


def _normal(shape):
    return lambda key: [jax.random.normal(key, shape)]


def _vq_codes(key):
    return [jax.random.randint(key, (B, 2, 2), 0, VQ_ARGS["num_embeddings"])]


def _infogan_codes(key):
    args = INFOGAN["args"]
    keys = jax.random.split(key, 4)
    cont = (1, args["continuous_code_dim"])
    return [jax.random.normal(keys[0], (B, args["latent_dim"])),
            jax.random.uniform(keys[2], cont), jax.random.uniform(keys[3], cont)]


def _pixelcnn_draws(key):
    c, levels, s = 3, 4, 8
    gumbel = jax.vmap(lambda i: jax.random.gumbel(jax.random.fold_in(key, i), (B, c, levels)))(
        jnp.arange(s * s))
    return [np.zeros((B, s, s, c), np.float32), gumbel]


# family -> (registry name, args, off-zero seed or None, JAX's draws from a key, atol)
SAMPLERS = {
    "vae": ("VAE", {"img_channels": 1, "img_size": 8, "latent_dim": 4}, None,
            _normal((B, 4)), 1e-5),
    "dae": ("DAE", {"img_channels": 1, "img_size": 8}, None, _normal((B, 8, 8, 1)), 1e-5),
    "nice": ("NICE", {"img_channels": 3, "img_size": 4, "hidden_dim": 16,
                      "num_coupling_layers": 4, "num_hidden_layers": 2}, 1,
             _normal((B, 48)), 1e-5),
    "glow": ("Glow", GLOW, 2, _normal((B, 192)), 1e-5),
    "vqvae": ("VQVAE", {**VQ_ARGS, "use_ema": False}, None, _vq_codes, 5e-5),
    "vqgan": ("VQGAN", {**VQ_ARGS, "use_ema": True}, None, _vq_codes, 5e-5),
    "infogan": ("InfoGAN", INFOGAN["args"], None, _infogan_codes, None),
    "pixelcnn": ("PixelCNN", {"img_channels": 3, "img_size": 8, "hidden_dim": 8,
                              "num_layers": 2, "num_levels": 4}, 4, _pixelcnn_draws, 0.0),
}


def _pair(family):
    """(the port model, the JAX model, its state with the port's weights)."""
    name, args, seed, _, _ = SAMPLERS[family]
    if family == "infogan":
        jmodel, state = gc.build(INFOGAN, f32_g=True)
        return gc.port_model(INFOGAN, state, f32_g=True), jmodel, state
    model = load_model({"name": name, "args": args}, device="cpu")
    model.init_params(torch.Generator().manual_seed(3))
    if seed is not None:
        off_zero(model.net, seed)
    jmodel = jax_load_model({"name": name, "args": args})
    return model, jmodel, state_from_port(jmodel, model)


def test_sampler_artifact_matches_live_and_jax(family, tmp_path):
    """Export, save and load: the artifact equals the live sampler from two seeds, and its
    program on JAX's own draws matches JAX's artifact (module doc)."""
    model, jmodel, state = _pair(family)
    path = tmp_path / f"{family}.pt2"
    sidecar = save_artifact(export_sampler(model, B), path)
    artifact = load_artifact(path)
    for seed in (0, 7):
        frozen = _assert_live(artifact, model, seed, B)
        assert list(frozen.shape) == sidecar["output_shape"]

    key = jax.random.PRNGKey(11)
    jax_art = _jax_artifact(jmodel, state, tmp_path, B)
    draws = [torch.from_numpy(np.array(d)) for d in SAMPLERS[family][3](key)]
    if family == "infogan":
        ref = jax.device_get(jax_art(key))
        gc.check_close(artifact.run(*draws), ref, 1e-5)
    else:
        _assert_jax(jax_art, artifact, draws, key, SAMPLERS[family][4])


def test_sampler_draw_plans(tmp_path):
    """Each family's draw plan: its inputs in the live sampler's draw order, with their
    distributions (VQ's randint with its bound, InfoGAN's three, PixelCNN's zero start and
    one Gumbel draw at each of its 64 raster steps, scanned as one segment)."""
    plans = {}
    for family in ("vqvae", "infogan", "pixelcnn"):
        name, args, _, _, _ = SAMPLERS[family]
        model = load_model({"name": name, "args": args}, device="cpu")
        exported = export_sampler(model, B)
        plans[family] = [{k: v for k, v in e.items() if k != "draw_steps"}
                         for e in exported.draw_plan]
        if family == "pixelcnn":
            assert exported.draw_plan[1]["draw_steps"] == list(range(64))
            scans = [n for n in exported.program.graph.nodes
                     if n.op == "call_function" and "scan" in str(n.target)]
            assert len(scans) == 1
    assert plans["vqvae"] == [{"name": "codes", "shape": [B, 2, 2], "distribution": "randint",
                               "order": 0, "high": 16}]
    assert [(e["name"], e["distribution"], e["shape"]) for e in plans["infogan"]] == [
        ("z", "normal", [B, INFOGAN["args"]["latent_dim"]]), ("start", "uniform", [1, 2]),
        ("end", "uniform", [1, 2])]
    assert plans["pixelcnn"] == [
        {"name": "images", "shape": [B, 8, 8, 3], "distribution": "zeros", "order": 0},
        {"name": "gumbel", "shape": [64, B, 3, 4], "distribution": "gumbel", "order": 1}]


# -- every registry name ------------------------------------------------------------------

# One sampling step each: the trace of a UNet evaluation is most of an export's time.
UNET = {"img_channels": 1, "img_size": 8, "dim": 8, "dim_mults": [1], "use_bf16": False}
LATENT_AE = {**UNET, "autoencoder": {"config_path": "configs/vae/vqvae_cifar10.json"},
             "img_size": 32, "img_channels": 3}
GAN_28 = {"img_channels": 1, "img_size": 28, "latent_dim": 8}
TINY_ARGS = {
    "DDPM": {**UNET, "diffusion_timesteps": 4, "sampling_timesteps": 1},
    "FlowMatching": {**UNET, "sampling_steps": 1},
    "EDM": {**UNET, "sampling_steps": 1},
    "ConsistencyModel": {**UNET, "sampling_steps": 1},
    "LatentDiffusion": {**LATENT_AE, "diffusion_timesteps": 4, "sampling_timesteps": 1},
    "LatentFlowMatching": {**LATENT_AE, "sampling_steps": 1},
    "LatentEDM": {**LATENT_AE, "sampling_steps": 1},
    **{name: SAMPLERS[key][1] for key, name in (
        ("vae", "VAE"), ("dae", "DAE"), ("nice", "NICE"), ("glow", "Glow"),
        ("vqvae", "VQVAE"), ("vqgan", "VQGAN"), ("infogan", "InfoGAN"),
        ("pixelcnn", "PixelCNN"))},
    "GAN": {"img_channels": 1, "img_size": 8, "latent_dim": 4},
    "DCGAN": {"img_channels": 3, "img_size": 32, "latent_dim": 8},
    **{name: GAN_28 for name in ("LSGAN", "WGAN", "R1GAN", "ACGAN", "SGAN")},
    "CGAN": CGAN,
    "BEGAN": {"img_channels": 1, "img_size": 32, "latent_dim": 8},
}
NO_SAMPLER = {
    "UNet": ({"img_channels": 1, "img_size": 16}, "UNet autoencoder has no generative prior"),
    "CycleGAN": ({"img_channels": 3, "img_size": 32},
                 "CycleGAN translates images; use translate()"),
}


def test_every_registry_name_exports(names):
    """``export_sampler`` freezes the sampler of every registry name that has one, at tiny
    widths on the CPU (the program's output is the sampler's image batch); the UNet
    autoencoder and CycleGAN raise JAX's own texts, and no export names the ROADMAP."""
    assert set(TINY_ARGS) | set(NO_SAMPLER) == set(available_models())
    for name in names:
        if name in NO_SAMPLER:
            args, text = NO_SAMPLER[name]
            model = load_model({"name": name, "args": args}, device="cpu")
            with pytest.raises(NotImplementedError, match=text.replace("(", r"\(")
                               .replace(")", r"\)")) as err:
                export_sampler(model, 2)
            assert "ROADMAP" not in str(err.value)
            continue
        args = TINY_ARGS[name]
        exported = export_sampler(load_model({"name": name, "args": args}, device="cpu"), 2)
        size, channels = args["img_size"], args["img_channels"]
        assert exported.output_shape == [2, size, size, channels], name


def test_normal_plan_artifact_loads_and_runs():
    """An artifact and sidecar saved before the draw plan took other distributions (one
    normal start, a normal per-step stack with ``draw_steps``: a tiny DiT DDPM's ancestral
    chain, ``tests/data/serving_normal_plan_dit.pt2``) load and run unchanged: equal to the
    live sampler of the same weights from the same seed."""
    path = Path(__file__).parent / "data" / "serving_normal_plan_dit.pt2"
    artifact = load_artifact(path)
    assert artifact.meta["draw_plan"] == [
        {"name": "x_T", "shape": [2, 4, 4, 1], "distribution": "normal", "order": 0},
        {"name": "noise", "shape": [3, 2, 4, 4, 1], "distribution": "normal", "order": 1,
         "draw_steps": [0, 1]}]
    model = load_model({"name": "DDPM", "args": {
        "img_channels": 1, "img_size": 4, "network": "dit", "dim": 8, "depth": 1,
        "num_heads": 1, "patch_size": 2, "diffusion_timesteps": 3, "use_bf16": False}},
        device="cpu")
    model.init_params(torch.Generator().manual_seed(2))
    for seed in (0, 5):
        _assert_live(artifact, model, seed, 2)


def test_export_cli_glow_round_trip(tmp_path, monkeypatch):
    """The export CLI on a Glow checkpoint with --smoke: the artifact and its sidecar land
    under <exp_dir>/exported/ and equal the restored model's sampler; --sampler and
    --sampling_steps are refused with JAX's message."""
    config = tmp_path / "glow.json"
    config.write_text(json.dumps({"model": {"name": "Glow", "args": GLOW},
                                  "dataset": {"name": "CIFAR10", "img_size": 8,
                                              "img_channels": 3}}))
    monkeypatch.setattr(export, "EXPERIMENT_DIR", tmp_path)
    model = load_model({"name": "Glow", "args": GLOW}, device="cpu")
    off_zero(model.net, 5)
    CheckpointManager(tmp_path / "Glow" / "g" / "checkpoints").save_last(model, 3, 0)
    out_path = export.main(["--config_path", str(config), "--experiment_name", "g",
                            "--batch", "2", "--device", "cpu", "--smoke"])
    assert out_path == tmp_path / "Glow" / "g" / "exported" / "glow_sample_bs2.pt2"
    sidecar = json.loads(out_path.with_name("glow_sample_bs2.pt2.json").read_text())
    assert sidecar["model"] == "Glow" and sidecar["step"] == 3
    assert sidecar["draw_plan"] == [{"name": "z", "shape": [2, 192], "distribution": "normal",
                                     "order": 0}]
    _assert_live(load_artifact(out_path), model, 4, 2)
    for flags in (["--sampler", "ddim"], ["--sampling_steps", "3"]):
        with pytest.raises(SystemExit, match="does not support --sampler/--sampling_steps"):
            export.main(["--config_path", str(config), "--experiment_name", "g",
                         "--batch", "2", "--device", "cpu", *flags])
