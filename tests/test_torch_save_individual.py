"""``generate --save_individual`` of the port against the root ``generate.py``'s, on the CPU:
the same file names and count for the same arguments, and each PNG the truncating uint8
conversion ``(np.clip(img, 0, 1) * 255).astype(np.uint8)`` of the returned images."""

import json

import numpy as np
import torch
from PIL import Image

from lightning_generative_models_tpu_torch import generate as port_generate

torch.set_num_threads(1)

CONFIG = {
    "model": {"name": "VAE", "args": {"img_channels": 1, "img_size": 8, "latent_dim": 4}},
    "dataset": {"name": "MNIST", "img_size": 8, "img_channels": 1, "batch_size": 8,
                "synthetic_size": 80},
}


def _samples(directory):
    return sorted(p.name for p in directory.glob("sample_*.png"))


def test_save_individual_matches_the_root_cli(tmp_path, monkeypatch):
    import generate as jax_generate
    import train as jax_train

    config = tmp_path / "vae_tiny.json"
    config.write_text(json.dumps({**CONFIG, "dataset": {**CONFIG["dataset"],
                                                        "data_dir": str(tmp_path)}}))
    monkeypatch.setattr(jax_train, "EXPERIMENT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jax_generate, "EXPERIMENT_DIR", str(tmp_path / "jax"))
    jax_train.main(["--config_path", str(config), "--experiment_name", "j", "--max_steps",
                    "1", "--check_val_every_n_epoch", "99", "--sample_every_n_steps", "0"])
    common = ["--config_path", str(config), "--num_samples", "8", "--save_individual"]
    jax_generate.main([*common, "--experiment_name", "j", "--out", str(tmp_path / "jax_out")])
    images = port_generate.main([*common, "--device", "cpu", "--out", str(tmp_path / "out")])

    names = _samples(tmp_path / "out")
    assert names == _samples(tmp_path / "jax_out")
    assert names == [f"sample_{i:04d}.png" for i in range(8)]
    for name, img in zip(names, images):
        decoded = np.asarray(Image.open(tmp_path / "out" / name))
        np.testing.assert_array_equal(decoded,
                                      (np.clip(img, 0, 1) * 255).astype(np.uint8)[..., 0])
    # The truncation shows: some pixel's rounded value would differ.
    assert np.any(np.round(np.clip(images, 0, 1) * 255) !=
                  (np.clip(images, 0, 1) * 255).astype(np.uint8))
