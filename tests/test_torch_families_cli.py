"""The port's train and generate entry points on the CPU for DAE, the UNet autoencoder,
PixelCNN, NICE and Glow: each shipped config with tiny widths (8 px, 40 synthetic
images, batch 4) trains two steps with a validation and checkpoints, resumes to step
three, and generates 4 images in [0, 1]; the UNet autoencoder's generate raises
NotImplementedError with JAX's text, and its run logs no sample grid."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.train import cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CASES = {
    "DAE": ("autoencoder/dae.json", {}),
    "UNet": ("autoencoder/unet.json", {"base_features": 4}),
    "PixelCNN": ("autoregressive/pixelcnn.json",
                 {"hidden_dim": 8, "num_layers": 1, "num_levels": 4}),
    "NICE": ("flow/nice.json", {"hidden_dim": 16, "num_hidden_layers": 1}),
    "Glow": ("flow/glow_cifar10.json", {"levels": 2, "depth": 1, "width": 8}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_train_resume_generate_on_the_cpu(name, tmp_path, monkeypatch):
    path, args = CASES[name]
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = json.loads((ROOT / "configs" / path).read_text())
    assert config["model"]["name"] == name
    config["model"]["args"].update(img_size=8, **args)
    config["dataset"].update(img_size=8, batch_size=4, synthetic_size=40,
                             data_dir=str(tmp_path))
    config_path = tmp_path / "tiny.json"
    config_path.write_text(json.dumps(config))
    argv = ["--config_path", str(config_path), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1", "--sample_every_n_steps", "0"]
    assert port_train.main(argv + ["--max_steps", "2"]).step == 2
    assert port_train.main(argv + ["--max_steps", "3", "--resume"]).step == 3
    run = tmp_path / "experiments" / name / "run"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train_loss" in r] == [0, 1, 2]
    assert all(np.isfinite(r["val_loss"]) for r in records if "val_loss" in r)
    assert len([r for r in records if "val_loss" in r]) == 2
    for which in ("last", "best"):
        assert (run / "checkpoints" / f"checkpoint_meta_{which}.json").exists()
    grids = list((run / "samples").glob("random_generation_*.png"))
    assert len(grids) == (0 if name == "UNet" else 2)

    gen_argv = ["--config_path", str(config_path), "--num_samples", "4", "--device", "cpu",
                "--out", str(tmp_path / "generated")]
    if name == "UNet":
        with pytest.raises(NotImplementedError, match="UNet autoencoder has no generative prior"):
            generate.main(gen_argv)
        return
    images = generate.main(gen_argv)
    channels = config["model"]["args"]["img_channels"]
    assert images.shape == (4, 8, 8, channels) and 0.0 <= images.min() <= images.max() <= 1.0
    assert (tmp_path / "generated" / "grid.png").exists()
