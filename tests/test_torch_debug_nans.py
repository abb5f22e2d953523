"""``--debug_nans`` of the port's train CLI against the root ``train.py``'s, on the CPU.

JAX's flag sets ``jax_debug_nans``: any jitted computation whose output holds a NaN raises
``FloatingPointError``, the forward passes that no gradient reaches included. Both CLIs
train a tiny VAE with a NaN injected the same way in each package, by a patched method
whose output becomes NaN inside the computation (inside the jitted function in JAX): a
validation metric (``eval_step``) and the sample grid (``sample``). Autograd's anomaly
mode, which checks backward outputs only, lets both through; the port's flag raises
where JAX's does, naming the phase and the step. ``jax_debug_nans`` is global to the
process, so each JAX run restores it in a ``finally``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.vae import vae as JVAE
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.models.vae import vae as TVAE
from lightning_generative_models_tpu_torch.train import cli

torch.set_num_threads(1)

CONFIG = {
    "model": {"name": "VAE", "args": {"img_channels": 1, "img_size": 8, "latent_dim": 4}},
    "dataset": {"name": "MNIST", "img_size": 8, "img_channels": 1, "batch_size": 8,
                "synthetic_size": 80},
}
FLAGS = ["--max_steps", "2", "--check_val_every_n_epoch", "99", "--sample_every_n_steps", "0"]


def _config(tmp_path):
    path = tmp_path / "vae_tiny.json"
    path.write_text(json.dumps({**CONFIG, "dataset": {**CONFIG["dataset"],
                                                      "data_dir": str(tmp_path)}}))
    return str(path)


def _nan_eval_step(orig, times_nan):
    def eval_step(self, *args, **kwargs):
        metrics = orig(self, *args, **kwargs)
        return {**metrics, "val_loss": times_nan(metrics["val_loss"])}
    return eval_step


def _nan_sample(orig, times_nan):
    def sample(self, *args, **kwargs):
        return times_nan(orig(self, *args, **kwargs))
    return sample


def _jax_run(tmp_path, monkeypatch, *flags):
    import train as jax_train

    monkeypatch.setattr(jax_train, "EXPERIMENT_DIR", str(tmp_path / "jax"))
    try:
        jax_train.main(["--config_path", _config(tmp_path), "--experiment_name", "j",
                        *FLAGS, *flags])
    finally:
        jax.config.update("jax_debug_nans", False)


def _port_run(tmp_path, monkeypatch, name, *flags):
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "port")
    return port_train.main(["--config_path", _config(tmp_path), "--device", "cpu",
                            "--experiment_name", name, *FLAGS, *flags])


def _injected_nan_raises_in_both(tmp_path, monkeypatch, method, patch, phase):
    """JAX's CLI raises; the port's old flag (anomaly mode) lets the NaN through; the
    port's ``--debug_nans`` raises naming ``phase``."""
    monkeypatch.setattr(JVAE.VAE, method, patch(getattr(JVAE.VAE, method),
                                                lambda x: x * jnp.nan))
    # JAX names the NaN's op, or the jitted function when its de-optimized rerun is clean.
    with pytest.raises(FloatingPointError, match="nan"):
        _jax_run(tmp_path, monkeypatch, "--debug_nans")

    monkeypatch.setattr(TVAE.VAE, method, patch(getattr(TVAE.VAE, method),
                                                lambda x: x * float("nan")))
    with torch.autograd.set_detect_anomaly(True):
        _port_run(tmp_path, monkeypatch, "anomaly")  # the fault: no error
    with pytest.raises(FloatingPointError, match=f"NaN in the {phase} at step 2"):
        _port_run(tmp_path, monkeypatch, "nans", "--debug_nans")


def test_nan_in_validation_metric_raises_in_both_clis(tmp_path, monkeypatch):
    _injected_nan_raises_in_both(tmp_path, monkeypatch, "eval_step", _nan_eval_step,
                                 "validation batch 0")
    logged = [json.loads(line) for line in (tmp_path / "port" / "VAE" / "anomaly" /
                                            "metrics.jsonl").read_text().splitlines()]
    assert any(np.isnan(rec.get("val_loss", 0.0)) for rec in logged)


def test_nan_in_sample_grid_raises_in_both_clis(tmp_path, monkeypatch):
    _injected_nan_raises_in_both(tmp_path, monkeypatch, "sample", _nan_sample, "sample grid")
    assert list((tmp_path / "port" / "VAE" / "anomaly" / "samples").glob("*.png"))


def test_clean_run_raises_nothing_and_unrolled_steps_are_checked(tmp_path, monkeypatch):
    """A clean run with the flag raises nothing and trains as without it (same weights);
    under ``--unroll_steps 2`` a NaN in a train step's metrics raises after the dispatch."""
    with_flag = _port_run(tmp_path, monkeypatch, "clean", "--debug_nans")
    without = _port_run(tmp_path, monkeypatch, "plain")
    for (name, a), b in zip(with_flag.net.state_dict().items(),
                            without.net.state_dict().values()):
        assert torch.equal(a, b), name

    orig = TVAE.VAE.apply_grad_step

    def apply_grad_step(self, grads, metrics):
        out = orig(self, grads, metrics)
        return {**out, "train_loss": out["train_loss"] * float("nan")}

    monkeypatch.setattr(TVAE.VAE, "apply_grad_step", apply_grad_step)
    _port_run(tmp_path, monkeypatch, "unrolled", "--unroll_steps", "2")
    with pytest.raises(FloatingPointError, match="NaN in the train step at step 2"):
        _port_run(tmp_path, monkeypatch, "unrolled_nans", "--unroll_steps", "2",
                  "--debug_nans")
