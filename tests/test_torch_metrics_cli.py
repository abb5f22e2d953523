"""The port's metrics plumbing through its entry points, on the CPU: ``generate --fid``,
a GAN's ``calculate_metrics`` in validation and ``train --eval test``.

InceptionV3 at 299 px is too slow for a CPU test, so a stand-in extractor (the first 48
pixel values of each image as features, ten of them as logits, as
``tests/test_metrics.py``'s ``TinyExtractor`` stands in for the JAX package's) is
monkeypatched in where the port builds its extractor. It records what it is given: the
artifact's keys are the JAX package's, the real set is sized as JAX sizes it, every
evaluation batch gets its own fakes, quantised by truncation, and the test split's keys
are prefixed ``test_``.
"""

import json
import logging

import numpy as np
import pytest
import torch

from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.metrics import inception
from lightning_generative_models_tpu_torch.train import cli

torch.set_num_threads(1)

# The artifact's keys as the JAX package's generate.py:_compute_fid writes them.
JAX_FID_KEYS = {"fid", "n_fake", "n_real", "pretrained_inception", "comparable_to_published",
                "checkpoint", "step", "dataset", "synthetic_data", "seed", "sampler",
                "sampling_steps"}
GEN_KEYS = {"fid_score", "mean_kid_score", "std_kid_score", "mean_inception_score",
            "std_inception_score"}


class Recorder:
    """Stand-in extractor; every call's uint8 images are kept in ``calls``."""

    calls: list = []

    def __init__(self, net=None, seed=0, device="cpu"):
        self.pretrained = False

    def __call__(self, images_u8):
        x = np.array(torch.as_tensor(images_u8).cpu() if torch.is_tensor(images_u8)
                     else images_u8)
        assert x.dtype == np.uint8
        Recorder.calls.append(x)
        feats = x.reshape(len(x), -1)[:, :48].astype(np.float32) / 255.0
        return feats, feats[:, :10] * 10.0


@pytest.fixture
def recorder(monkeypatch, tmp_path):
    Recorder.calls = []
    monkeypatch.setattr(inception, "InceptionFeatureExtractor", Recorder)
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    monkeypatch.setattr(generate, "EXPERIMENT_DIR", tmp_path / "experiments")
    return Recorder


def _gan_config(tmp_path, metrics=True, synthetic=160):
    config = {
        "model": {"name": "GAN", "args": {
            "img_channels": 1, "img_size": 8, "latent_dim": 8, "lr": 1e-3,
            "calculate_metrics": metrics, "metrics": ["fid", "kid", "is"]}},
        "dataset": {"name": "MNIST", "img_size": 8, "img_channels": 1, "batch_size": 8,
                    "synthetic_size": synthetic, "data_dir": str(tmp_path)},
    }
    path = tmp_path / "gan.json"
    path.write_text(json.dumps(config))
    return path


def test_generate_fid_writes_the_jax_artifact(recorder, tmp_path):
    """From a run's checkpoint (``--experiment_name``): the real set is the synthetic
    train split regenerated at N images (JAX's protocol), or ``--fid_real`` of them;
    the fakes come in ``--fid_batch`` chunks, each from its own generator; the artifact
    holds JAX's keys under JAX's name."""
    config = _gan_config(tmp_path, metrics=False)
    port_train.main(["--config_path", str(config), "--device", "cpu", "--experiment_name",
                     "f", "--max_steps", "2", "--check_val_every_n_epoch", "99",
                     "--sample_every_n_steps", "0"])
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "f",
            "--fid", "24", "--fid_batch", "10"]
    art = generate.main(argv)
    assert set(art) == JAX_FID_KEYS
    assert (art["n_fake"], art["n_real"], art["step"], art["checkpoint"]) == (24, 24, 2, "last")
    assert art["synthetic_data"] and not art["pretrained_inception"]
    assert np.isfinite(art["fid"]) and art["fid"] > 0
    path = tmp_path / "experiments" / "GAN" / "f" / "fid_24_last_step2.json"
    assert json.loads(path.read_text()) == art
    sizes = [len(c) for c in recorder.calls]
    assert sizes == [10, 10, 4, 10, 10, 4]  # 24 reals, then 24 fakes in chunks of 10
    fakes = recorder.calls[3:]
    assert not np.array_equal(fakes[0], fakes[1])  # a generator per chunk

    recorder.calls = []
    art = generate.main(argv + ["--fid_real", "40"])
    assert (art["n_fake"], art["n_real"]) == (24, 40)
    assert sum(len(c) for c in recorder.calls) == 64
    assert generate.main(argv + ["--fid_real", "40"]) == art  # same seed, same value


def test_validation_computes_fid_kid_is_on_per_batch_fakes(recorder, tmp_path):
    """A GAN with ``calculate_metrics``: each validation batch's reals go to FID and
    KID, its fakes (sampled from the batch's own generator, quantised by truncation) to
    FID, KID and IS; the five keys are logged; the metrics are reset after each
    validation."""
    config = _gan_config(tmp_path)
    sampled = []
    model = port_train.main(["--config_path", str(config), "--device", "cpu",
                             "--experiment_name", "v", "--max_steps", "2",
                             "--check_val_every_n_epoch", "99", "--sample_every_n_steps", "0"])
    records = [json.loads(line) for line in
               (tmp_path / "experiments" / "GAN" / "v" / "metrics.jsonl").read_text()
               .splitlines()]
    val = [r for r in records if "val_g_loss" in r or "val_d_loss" in r]
    assert len(val) == 1 and GEN_KEYS <= set(val[0])
    assert all(np.isfinite(val[0][k]) for k in GEN_KEYS)
    # The validation split: 160 * 0.2 = 32 images, four batches of 8, each batch's
    # reals twice (FID, KID) and its fakes three times (FID, KID, IS).
    calls = recorder.calls
    assert [len(c) for c in calls] == [8] * 20
    for i in range(0, 20, 5):
        assert np.array_equal(calls[i], calls[i + 2])
        assert np.array_equal(calls[i + 1], calls[i + 3])
        assert np.array_equal(calls[i + 1], calls[i + 4])
        assert not np.array_equal(calls[i], calls[i + 1])
    assert not np.array_equal(calls[1], calls[6])  # each batch its own fakes

    # Quantisation and per-batch generators, on the trainer itself with two batches.
    from lightning_generative_models_tpu_torch.train.trainer import Trainer

    class TwoBatches:
        batch_size = 6

        def val_batches(self):
            rs = np.random.RandomState(0)
            return iter([{"image": rs.randint(0, 256, (6, 8, 8, 1)).astype(np.uint8),
                          "label": np.zeros(6, np.int64)} for _ in range(2)])

    sample = model.sample

    def recording_sample(generator, n):
        out = sample(generator, n)
        sampled.append(out.clone())
        return out

    model.sample = recording_sample
    trainer = Trainer(model, TwoBatches(), tmp_path / "t")
    recorder.calls = []
    means = trainer._eval_over(trainer.datamodule.val_batches())
    trainer.logger.finish()
    assert GEN_KEYS <= set(means) and len(sampled) == 2
    assert not torch.equal(sampled[0], sampled[1])
    for i, fake01 in enumerate(sampled):
        want = np.clip(fake01.numpy() * 255.0, 0, 255).astype(np.uint8)
        assert np.array_equal(recorder.calls[5 * i + 1], want)
    assert trainer._gen_metric_objs["fid"]._real == []  # reset after compute


def test_eval_test_logs_test_prefixed_metrics(recorder, tmp_path, caplog):
    """``--eval test`` restores ``--eval_which`` (fresh weights, with a warning, when
    the run has none) and evaluates the test split: JAX's ``test_`` keys."""
    config = _gan_config(tmp_path)
    common = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "e"]
    with caplog.at_level(logging.WARNING):
        fresh = port_train.main(common + ["--eval", "test"])
    assert "testing freshly initialized weights" in caplog.text
    port_train.main(common + ["--max_steps", "2", "--check_val_every_n_epoch", "1",
                              "--sample_every_n_steps", "0"])
    recorder.calls = []
    for which in ("last", "best"):
        metrics = port_train.main(common + ["--eval", "test", "--eval_which", which])
        assert {"test_g_loss", "test_d_loss"} <= set(metrics)
        assert {f"test_{k}" for k in GEN_KEYS} <= set(metrics)
        assert not any(k.startswith("val_") for k in metrics)
        assert metrics["test_g_loss"] != fresh["test_g_loss"]
    # The test split of the 160-image stand-in: 40 images, five batches of 8.
    assert [len(c) for c in recorder.calls] == [8] * 50
    records = [json.loads(line) for line in
               (tmp_path / "experiments" / "GAN" / "e" / "metrics.jsonl").read_text()
               .splitlines()]
    assert sum("test_fid_score" in r for r in records) == 3
