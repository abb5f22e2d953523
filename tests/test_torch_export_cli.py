"""The port's export CLI (``python -m lightning_generative_models_tpu_torch.export``) end to
end on the CPU, its refusals, and the families that have no sampler to export."""

import json

import pytest
import torch

from lightning_generative_models_tpu_torch import export
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.serving import export_sampler, load_artifact
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

CONFIG = {
    "model": {"name": "DDPM", "args": {"img_channels": 1, "img_size": 8, "dim": 8,
                                       "diffusion_timesteps": 8, "sampling_timesteps": 4,
                                       "use_bf16": False}},
    "dataset": {"name": "MNIST", "img_size": 8, "img_channels": 1, "batch_size": 8,
                "synthetic_size": 32},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A DDPM trained 1 step by the port's train CLI: (config path, experiments root)."""
    root = tmp_path_factory.mktemp("export_cli")
    config = root / "ddpm_tiny.json"
    config.write_text(json.dumps({**CONFIG, "dataset": {**CONFIG["dataset"],
                                                        "data_dir": str(root)}}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "EXPERIMENT_DIR", root / "experiments")
        port_train.main(["--config_path", str(config), "--device", "cpu", "--experiment_name",
                         "run1", "--max_steps", "1", "--check_val_every_n_epoch", "99"])
    return config, root / "experiments"


def test_export_cli_e2e(run, monkeypatch):
    """Export via the CLI with --smoke: the artifact and its sidecar's provenance land
    under <exp_dir>/exported/, and the artifact equals the restored model's sampler."""
    config, experiments = run
    monkeypatch.setattr(export, "EXPERIMENT_DIR", experiments)
    out_path = export.main(["--config_path", str(config), "--experiment_name", "run1",
                            "--batch", "2", "--sampler", "dpmpp", "--sampling_steps", "2",
                            "--device", "cpu", "--smoke"])
    assert out_path == experiments / "DDPM" / "run1" / "exported" / "ddpm_sample_bs2_dpmpp2.pt2"
    sidecar = json.loads((out_path.parent / f"{out_path.name}.json").read_text())
    assert sidecar["model"] == "DDPM" and sidecar["step"] == 1
    assert sidecar["sampler"] == "dpmpp" and sidecar["sampling_steps"] == 2
    assert sidecar["output_shape"] == [2, 8, 8, 1] and sidecar["device"] == "cpu"

    model = load_model(CONFIG["model"], device="cpu")
    CheckpointManager(experiments / "DDPM" / "run1" / "checkpoints").restore(model, "last")
    live = model.sample(torch.Generator().manual_seed(4), 2, method="dpmpp", steps=2)
    torch.testing.assert_close(load_artifact(out_path)(4), live, rtol=0, atol=1e-6)


def test_export_cli_refuses_sampler_flags_for_non_diffusion(tmp_path, monkeypatch):
    """A GAN takes no --sampler/--sampling_steps: JAX's message."""
    config = tmp_path / "gan.json"
    config.write_text(json.dumps({"model": {"name": "GAN", "args": {
        "img_channels": 1, "img_size": 8, "latent_dim": 4}},
        "dataset": {"name": "MNIST", "img_size": 8, "img_channels": 1}}))
    monkeypatch.setattr(export, "EXPERIMENT_DIR", tmp_path)
    model = load_model({"name": "GAN", "args": {"img_channels": 1, "img_size": 8,
                                                "latent_dim": 4}}, device="cpu")
    CheckpointManager(tmp_path / "GAN" / "g" / "checkpoints").save_last(model, 0, 0)
    with pytest.raises(SystemExit, match="does not support --sampler/--sampling_steps"):
        export.main(["--config_path", str(config), "--experiment_name", "g", "--batch", "2",
                     "--sampler", "ddim", "--device", "cpu"])


@pytest.mark.parametrize("name, args, text", [
    ("UNet", {"img_channels": 1, "img_size": 16}, "UNet autoencoder has no generative prior"),
    ("CycleGAN", {"img_channels": 3, "img_size": 32},
     r"CycleGAN translates images; use translate\(\)"),
])
def test_unexported_families_raise_naming_the_roadmap(name, args, text):
    """The two families with no sampler in either package raise JAX's own texts, which
    name no ROADMAP: every other family exports."""
    model = load_model({"name": name, "args": args}, device="cpu")
    with pytest.raises(NotImplementedError, match=text) as err:
        export_sampler(model, 2)
    assert "ROADMAP" not in str(err.value)
