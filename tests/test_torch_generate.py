"""The port's generate entry point, registry and PNG writer, on the CPU."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion.unet import UNet as JaxUNet
from lightning_generative_models_tpu_torch import generate, registry
from lightning_generative_models_tpu_torch.experiment.logger import _write_png
from lightning_generative_models_tpu_torch.models.diffusion.unet import UNet
from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.weights import flatten_tree
from torch_flax_params import flax_tree, init_shapes

torch.set_num_threads(1)

ARGS = {"img_size": 16, "img_channels": 3, "dim": 16, "dim_mults": [1, 2],
        "diffusion_timesteps": 20, "sampling_timesteps": 3, "use_bf16": False}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny DDPM config and an .npz of UNet weights in the flax tree's keys (drawn by
    the port, ``torch_flax_params``)."""
    root = tmp_path_factory.mktemp("generate")
    config = root / "ddim_tiny.json"
    config.write_text(json.dumps({
        "model": {"name": "DDPM", "args": ARGS},
        "dataset": {"name": "CIFAR10", "img_size": 16, "img_channels": 3},
    }))
    net = init_params(UNet(dim=16, dim_mults=(1, 2)), torch.Generator().manual_seed(3))
    params = flax_tree(net, init_shapes(JaxUNet(dim=16, dim_mults=(1, 2)),
                                        jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32)))
    weights = root / "ema.npz"
    np.savez(weights, **flatten_tree(params))
    return root, config, weights


def test_generate_main_on_cpu(tiny_run):
    root, config, weights = tiny_run
    out = root / "out"
    argv = ["--config_path", str(config), "--num_samples", "4", "--seed", "1",
            "--weights", str(weights), "--device", "cpu", "--out", str(out)]
    images = generate.main(argv)
    assert images.shape == (4, 16, 16, 3)
    assert np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0
    png = (out / "grid.png").read_bytes()
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    np.testing.assert_array_equal(generate.main(argv), images)  # same seed, same weights

    dpmpp = generate.main(argv + ["--sampler", "dpmpp", "--sampling_steps", "2"])
    assert dpmpp.shape == images.shape and not np.array_equal(dpmpp, images)


def test_generate_rejects_unported_flags():
    pp = str(Path(__file__).resolve().parents[1] / "configs" / "diffusion" / "dit_cifar10_pp.json")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate.main(["--config_path", pp, "--device", "cpu"])


def test_generate_cuda_without_gpu_raises(tiny_run):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, config, _ = tiny_run
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        generate.main(["--config_path", str(config), "--device", "cuda"])


def test_registry_resolves_ported_and_rejects_the_rest():
    """All 26 names of the JAX package's registry resolve, case-insensitively, to classes
    of the port; an unknown name raises ValueError."""
    from lightning_generative_models_tpu.registry import available_models as jax_models

    assert registry.resolve_model_class("ddpm").__name__ == "DDPM"
    assert registry.resolve_model_class("gan").__name__ == "GAN"
    assert registry.resolve_model_class("DCGAN").__name__ == "DCGAN"
    for name in ("LSGAN", "WGAN", "R1GAN", "CGAN", "InfoGAN", "ACGAN", "SGAN", "BEGAN",
                 "CycleGAN", "DAE", "PixelCNN", "NICE", "Glow"):
        assert registry.resolve_model_class(name.lower()).__name__ == name
    assert registry.resolve_model_class("unet").__name__ == "UNetAE"
    assert registry.available_models() == sorted(jax_models())
    assert len(registry.available_models()) == 26
    for name in registry.available_models():
        cls = registry.resolve_model_class(name)
        assert cls.__module__.startswith("lightning_generative_models_tpu_torch."), name
    with pytest.raises(ValueError, match="Unknown model"):
        registry.resolve_model_class("NoSuchModel")


def test_write_png_round_trip(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(0)
    for shape in [(5, 7, 3), (5, 7, 1)]:
        img = rs.randint(0, 256, size=shape).astype(np.uint8)
        _write_png(tmp_path / "x.png", img)
        back = np.asarray(pil.open(tmp_path / "x.png"))
        np.testing.assert_array_equal(back, img.reshape(back.shape))
